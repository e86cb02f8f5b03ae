#!/usr/bin/env python3
"""What chip_smoke.py phase 26 (b) and (c) hold, read rather than asserted,
and how far three faults in the data-parallel step move it.

    python3 scripts/dp_grad_gap.py [--faults]            # on the card
    python3 scripts/dp_grad_gap.py --device cpu --small [--y2h sinusoidal]
    python3 scripts/dp_grad_gap.py --device cpu --ccgan-widths

Runs phase 26's two gloo ranks and its one process: main.py's Trainer at
DP_ARGV, 3 steps at 64 rows a rank, and one CcGAN iteration at
DP_CCGAN_ARGV (2 D steps, one G step). For each it prints what the phase
holds: the losses' relative gaps, each recorded step's summed gradients
against the one process (the worst leaf's max |error| over max(its largest
|g|, DP_GRAD_FLOOR of the step's largest), with its index), the Adam rule's
two ratios (the worst element over DP_ADAM_CEILING lr a step; the worst
leaf's mean error over its mean movement) and whether the ranks agree bit
for bit. --faults runs the ranks again under each of three faults, put
into the rank processes at run time (no file changes):
  mean: the summed gradients halved (averaged where they are summed);
  rows: the gather's backward takes the other rank's rows;
  bn:   the BatchNorm sums' backward is not all-reduced.
--small takes the CPU rehearsal's widths (UNet dim 8, 1_2, batch 8; SNGAN
4/4/16, batch 8), --ccgan-widths phase 26's CcGAN with that small UNet,
--y2h the label embedding of the UNet run. On the card, about 5 minutes
with --faults; on 4 CPU threads, under 2 minutes.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402

SMALL_UNET = ["--model_channels", "8", "--channel_mult", "1_2", "--train_batch_size", "8",
              "--synthetic_n", "32"]
SMALL_GAN = ["--gene_ch", "4", "--disc_ch", "4", "--dim_gan", "16", "--batch_size_disc", "8",
             "--batch_size_gene", "8"]


def put_fault(which: str) -> None:
    import torch.distributed as dist

    from ccdm_tpu_torch.models import layers, resnet_embed
    from ccdm_tpu_torch.parallel import mesh as pm
    from ccdm_tpu_torch.training import ccgan, trainer

    if which == "mean":
        real = pm.all_reduce_grads

        def halved(mesh, grads):
            out = real(mesh, grads)
            return [g / mesh.size for g in out] if mesh.size > 1 else out

        trainer.all_reduce_grads = ccgan.all_reduce_grads = halved
    elif which == "rows":
        def other_rows(ctx, grad):
            n = ctx.rows.stop - ctx.rows.start
            return grad[n - ctx.rows.start:2 * n - ctx.rows.start], None

        pm._GatherRows.backward = staticmethod(other_rows)
    elif which == "bn":
        real = pm.global_moments

        def local_backward(x, dims, mesh):
            if mesh is None or mesh.size == 1:
                return real(x, dims, mesh)
            count = mesh.size
            for d in dims:
                count *= x.shape[d]
            local = torch.stack([x.sum(dims), (x * x).sum(dims)])
            total = local.detach().clone()
            dist.all_reduce(total, group=mesh.group)
            sums = local + (total - local.detach())
            mean = sums[0] / count
            return mean, torch.clamp(sums[1] / count - mean * mean, min=0.0)

        layers.global_moments = resnet_embed.global_moments = local_backward
    else:
        raise ValueError(which)


def faulty_rank(rank: int, *args) -> None:
    put_fault(os.environ["DP_FAULT"])
    cs._dp_rank(rank, *args)


def read(tag: str, ranks: list, one: dict, lr: float) -> None:
    a, b = ranks
    equal = (all(torch.equal(x, y) for key in ("params", "stats")
                 for x, y in zip(a[key], b[key])) and a["losses"] == b["losses"])
    rel = [abs(x - y) / max(abs(y), 1e-12) for x, y in zip(a["losses"], one["losses"])]
    grads = []
    for ga, g1 in zip(a["grads"], one["grads"]):
        errs = cs._grad_errors(ga, g1)
        i = max(range(len(errs)), key=errs.__getitem__)
        grads.append(f"{errs[i]:.3e} (leaf {i})")
    adam = cs._adam_rule(a, one, lr)
    print(f"{tag}: losses rel {[f'{v:.2e}' for v in rel]}; summed gradients {grads}; Adam "
          f"worst element {adam['ceiling']:.3f}, worst leaf's mean error {adam['mean_ratio']:.3e} "
          f"of its movement ({adam['checked']} of {adam['leaves']} leaves); ranks bit-equal "
          f"{equal}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--ccgan-widths", action="store_true")
    ap.add_argument("--y2h", default="gaussian", choices=["gaussian", "sinusoidal"])
    args = ap.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda":
        cs._cuda_env()
        print(cs.card_line(), flush=True)
        libraries = ("attn_block", "attn_block_large", "resnet_block", "linear_attention",
                     "style_ops")
        with ThreadPoolExecutor(len(libraries)) as pool:  # once, before the ranks load them
            list(pool.map(cs._build.build, libraries))
    else:
        torch.set_num_threads(4)
    if args.small or args.ccgan_widths:
        cs.DP_ARGV = cs.DP_ARGV + SMALL_UNET
    if args.small:
        cs.DP_CCGAN_ARGV = cs.DP_CCGAN_ARGV + SMALL_GAN
    cs.DP_ARGV = [*cs.DP_ARGV, "--y2h_embed_type", args.y2h]  # the last one counts
    from ccdm_tpu_torch.parallel.mesh import Mesh

    cs.DP_RUN.mkdir(parents=True, exist_ok=True)
    one_mesh = Mesh(device=device)
    try:
        ranks = cs._two_ranks(cs.DP_RUN / "ranks", device)
        one_unet = cs.dp_unet_steps(device, one_mesh, cs.DP_RUN / "unet_one", cs.DP_ARGV)
        one_gan = cs.dp_ccgan_iteration(device, one_mesh, cs.DP_RUN / "ccgan_one",
                                        cs.DP_CCGAN_ARGV)
        read("(b) train steps", [r["unet"] for r in ranks], one_unet, cs.DP_LR)
        read("(c) CcGAN iteration", [r["ccgan"] for r in ranks], one_gan, cs.DP_CCGAN_LR)
        if args.faults:
            real = cs._dp_rank
            cs._dp_rank = faulty_rank
            try:
                for fault in ("mean", "rows", "bn"):
                    os.environ["DP_FAULT"] = fault
                    got = cs._two_ranks(cs.DP_RUN / f"fault_{fault}", device)
                    read(f"(b) fault {fault}", [r["unet"] for r in got], one_unet, cs.DP_LR)
                    read(f"(c) fault {fault}", [r["ccgan"] for r in got], one_gan,
                         cs.DP_CCGAN_LR)
            finally:
                cs._dp_rank = real
    finally:
        shutil.rmtree(cs.DP_RUN, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
