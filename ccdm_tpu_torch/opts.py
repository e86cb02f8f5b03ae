"""CLI flags of the serving path, with ccdm_tpu/opts.py's names, defaults and
choices, plus --device. Flags that nothing in the port reads yet (data,
training, eval, the run's output folders) come with their slices."""

from __future__ import annotations

import argparse


def parse_opts(argv=None):
    parser = argparse.ArgumentParser()

    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the default; raises without a card) or cpu")

    # Overall
    parser.add_argument("--seed", type=int, default=111)
    parser.add_argument("--architecture", type=str, default="unet",
                        choices=["unet", "vit", "adm"])
    parser.add_argument("--label_embed", type=str, default="ccdm2",
                        choices=["ccdm1", "ccdm2", "random"])
    parser.add_argument("--label_dim", type=int, default=1)

    # Dataset and model
    parser.add_argument("--num_channels", type=int, default=3)
    parser.add_argument("--image_size", type=int, default=64)
    parser.add_argument("--model_channels", type=int, default=64)
    parser.add_argument("--num_heads", type=int, default=4)
    parser.add_argument("--channel_mult", type=str, default="1_2_4_8")
    parser.add_argument("--attn_dim_head", type=int, default=32)

    # Diffusion
    parser.add_argument("--pred_objective", type=str, default="pred_noise",
                        choices=["pred_noise", "pred_x0", "pred_v"])
    parser.add_argument("--train_timesteps", type=int, default=1000)
    parser.add_argument("--train_amp", action="store_true", default=False,
                        help="bf16 activations")
    parser.add_argument("--beta_schedule", type=str, default="cosine",
                        choices=["cosine", "linear"])

    # Label embedding
    parser.add_argument("--y2h_embed_type", type=str, default="sinusoidal",
                        choices=["resnet", "sinusoidal", "gaussian"])
    parser.add_argument("--use_Hy", action="store_true", default=False)
    parser.add_argument("--dim_embed", type=int, default=128)

    # Sampling
    parser.add_argument("--sampler", type=str, default="ddim", choices=["ddim", "ddpm"])
    parser.add_argument("--sample_timesteps", type=int, default=250)
    parser.add_argument("--sample_cond_scale", type=float, default=1.5)
    parser.add_argument("--samp_batch_size", type=int, default=100)
    parser.add_argument("--samp_precast_bf16", action="store_true", default=False,
                        help="cast the f32 weight tensors to bf16 once before "
                             "sampling (training/state.precast_sampling_params)")

    # Serving
    parser.add_argument("--serve_port", type=int, default=8600)
    parser.add_argument("--serve_host", type=str, default="127.0.0.1",
                        help="bind address; 0.0.0.0 exposes the card to the "
                             "network and is an explicit opt-in")
    parser.add_argument("--serve_max_labels", type=int, default=1024)
    parser.add_argument("--serve_milestone", type=int, default=0,
                        help="milestone to load (0 = weights from --seed)")
    return parser.parse_args(argv)


def parse_channel_mult(s: str) -> tuple:
    """'1_2_4_8' -> (1, 2, 4, 8)."""
    return tuple(int(x) for x in s.split("_"))
