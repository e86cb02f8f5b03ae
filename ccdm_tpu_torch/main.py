"""The training entry point (ccdm_tpu/main.py:87-260), and the model
construction it shares with serve.py.

    python -m ccdm_tpu_torch.main --data_name synthetic --image_size 64 \
        --model_channels 64 --channel_mult 1_2_2_4_8 --train_amp \
        --pred_objective pred_x0 --vicinity_type hv --train_batch_size 128 \
        --niters 30 --save_every 30

Flow: parse flags -> the setting folder <root_path>/output/<data>_<size>/
<setting_name> and setting_info.txt -> dataset -> label embedding -> the
denoiser on the card (--device cpu for the CPU) -> GaussianDiffusion ->
Trainer (+ resume from --resume_niter) -> train -> a milestone at --niters.
The JAX entry then samples every eval label into h5 dumps and PNG grids;
that, the visual grid and --lambda_aux come in later slices (ROADMAP.md).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ccdm_tpu_torch.opts import parse_channel_mult


def resolve_label_embed(args) -> None:
    """--label_embed picks the embedding family: random -> Gaussian-Fourier
    y2h; --use_Hy needs ccdm2. Mutates args in place."""
    if args.label_embed == "random":
        args.y2h_embed_type = "gaussian"
    if args.use_Hy and args.label_embed != "ccdm2":
        raise SystemExit(f"--use_Hy needs the y2cov pipeline: --label_embed ccdm2 "
                         f"(got {args.label_embed})")


def build_model(args, image_size: int, channels: int):
    """The denoiser of --architecture, weights drawn from --seed."""
    from ccdm_tpu_torch.models.unet import Unet

    if args.architecture != "unet":
        raise NotImplementedError(f"--architecture {args.architecture} comes in a "
                                  "later slice (ROADMAP.md)")
    return Unet(dim=args.model_channels, dim_mults=parse_channel_mult(args.channel_mult),
                in_channels=channels, attn_heads=args.num_heads,
                attn_dim_head=args.attn_dim_head,
                dtype=torch.bfloat16 if args.train_amp else torch.float32,
                seed=args.seed)


def results_folder(args) -> str:
    """<root_path>/output/<data_name>_<image_size>/<setting_name>/results."""
    return os.path.join(args.root_path, "output", f"{args.data_name}_{args.image_size}",
                        args.setting_name, "results")


def dataset_kwargs(args) -> dict:
    """The loader arguments of --data_name (ccdm_tpu/main.py:115-152)."""
    kw = dict(image_size=args.image_size)
    if args.data_name == "RC-49":
        kw.update(min_label=args.min_label, max_label=args.max_label,
                  max_num_img_per_label=args.max_num_img_per_label, data_split=args.data_split)
    elif args.data_name == "UTKFace":
        kw.update(min_label=args.min_label, max_label=args.max_label,
                  max_num_img_per_label=args.max_num_img_per_label,
                  num_img_per_label_after_replica=args.num_img_per_label_after_replica)
    elif args.data_name == "SteeringAngle":
        kw.update(min_label=args.min_label, max_label=args.max_label,
                  max_num_img_per_label=args.max_num_img_per_label)
    elif args.data_name == "Cell200":
        kw.update(min_label=args.min_label, max_label=args.max_label, stepsize=args.stepsize,
                  num_imgs_per_label=args.num_imgs_per_label)
    elif args.data_name == "synthetic":
        kw.update(channels=args.num_channels)
        if args.synthetic_n > 0:
            kw["n"] = args.synthetic_n
    return kw


def main(argv=None):
    from ccdm_tpu_torch.data.datasets import load_dataset
    from ccdm_tpu_torch.diffusion.gaussian import DiffusionConfig, GaussianDiffusion
    from ccdm_tpu_torch.embedding.resolve import build_label_embedding
    from ccdm_tpu_torch.opts import parse_opts
    from ccdm_tpu_torch.training.trainer import Trainer, TrainerConfig
    from ccdm_tpu_torch.utils.ckpt import checkpoint_exists
    from ccdm_tpu_torch.utils.device import resolve_device

    args = parse_opts(argv)
    for flag, on in (("--dump_fake_data", args.dump_fake_data),
                     ("--lambda_aux", args.lambda_aux > 0)):
        if on:
            raise NotImplementedError(f"{flag} comes in a later slice (ROADMAP.md)")
    device = resolve_device(args.device)
    np.random.seed(args.seed)
    torch.manual_seed(args.seed)

    results = results_folder(args)
    setting_folder = os.path.dirname(results)
    os.makedirs(results, exist_ok=True)
    with open(os.path.join(setting_folder, "setting_info.txt"), "a") as f:
        f.write("\n" + "=" * 99 + "\n")
        print(args, file=f)

    bundle = load_dataset(args.data_name, args.data_path, **dataset_kwargs(args))
    print(f"\n {args.data_name}: {len(bundle.images)} train images, "
          f"{bundle.image_size}^2 x{bundle.channels}, label_dim={bundle.label_dim}", flush=True)
    if args.vicinity_type in ("shv", "ssv") and args.num_projections <= 0:
        d = bundle.label_dim
        args.num_projections = 10 if d > 20 else 5 if d > 10 else 3 if d > 5 else 1

    resolve_label_embed(args)
    fn_y2h = build_label_embedding(args)
    model = build_model(args, bundle.image_size, bundle.channels).to(
        device, memory_format=torch.channels_last)
    n_params = sum(p.numel() for p in model.parameters())
    print(f" model params: {n_params / 1e6:.2f}M", flush=True)
    dcfg = DiffusionConfig(
        image_size=bundle.image_size, channels=bundle.channels,
        timesteps=args.train_timesteps, sampling_timesteps=args.sample_timesteps,
        objective=args.pred_objective, beta_schedule=args.beta_schedule,
        cond_drop_prob=args.cond_drop_prob, use_Hy=args.use_Hy,
        vicinity_type=args.vicinity_type, distance=args.distance,
        vector_type=args.vector_type, num_projections=args.num_projections)
    diffusion = GaussianDiffusion(model, dcfg, device=device)
    tcfg = TrainerConfig(
        data_name=bundle.name, train_batch_size=args.train_batch_size,
        gradient_accumulate_every=args.gradient_accumulate_every, train_lr=args.train_lr,
        train_num_steps=args.niters, save_every=args.save_every, results_folder=results,
        vicinity_type=args.vicinity_type, kappa=args.kappa, kernel_sigma=args.kernel_sigma,
        nonzero_soft_weight_threshold=args.nonzero_soft_weight_threshold,
        vector_type=args.vector_type, num_projections=args.num_projections,
        distance=args.distance, hyperparameter=args.hyperparameter,
        percentile=args.percentile, adaptive_slicing=args.adaptive_slicing,
        log_every=args.log_every, seed=args.seed)
    trainer = Trainer(diffusion, bundle.images, bundle.labels_norm, tcfg)
    print(f" sigma_delta={trainer.sigma_delta}, kappa={trainer.kappa}", flush=True)

    if args.resume_niter > 0 and checkpoint_exists(results, args.resume_niter):
        trainer.load(args.resume_niter)
        print(f" resumed from milestone {args.resume_niter}", flush=True)
    trainer.train(fn_y2h)
    trainer.save(args.niters)
    return trainer


if __name__ == "__main__":
    main()
