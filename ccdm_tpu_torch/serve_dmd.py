"""Serve a distilled DMD2-M one-step student over HTTP (ccdm_tpu/serve_dmd.py).

    python -m ccdm_tpu_torch.serve_dmd --root_path <run root> \
        --data_name SteeringAngle --serve_milestone 50000 --gan_arch sngan \
        --gene_ch 64 --dim_z 256 --serve_port 8601

The flags are dmd_main.py's: the same argv finds the milestone that
dmd_main.py wrote (<setting folder>/dmd_results/model-dmd-<N>) and the
teacher's label embedding. One netG forward per batch of a request; the
API is serve.py's, and `cond_scale` in a request is answered 400. It runs
on the card unless --device cpu is given.
"""

from __future__ import annotations


def main(argv=None):
    from ccdm_tpu_torch.dmd_main import parse_opts_dmd
    from ccdm_tpu_torch.serve import GeneratorService, serve

    args = parse_opts_dmd(argv)
    service = GeneratorService(args, max_batch=args.samp_batch_size,
                               max_labels=args.serve_max_labels, device=args.device)
    # binds loopback by default; --serve_host 0.0.0.0 is an explicit opt-in
    serve(service, args.serve_port, host=args.serve_host)


if __name__ == "__main__":
    main()
