"""Model construction shared by the port's entry points
(ccdm_tpu/main.py:54-84). The training entry point comes with the training
slice (ROADMAP.md)."""

from __future__ import annotations

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
