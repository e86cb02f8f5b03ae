#!/usr/bin/env python3
"""Whether the resnet y2cov ILI embedding stays finite at 64^2, 128^2 and 192^2.

    python3 scripts/y2cov_ili.py            # on the card: the port's ILI
    python3 scripts/y2cov_ili.py --seeds    # on the CPU: the y2cov CNN, JAX and the port

Default mode (the card; `--device cpu` runs it on the CPU, slowly): the
port's LabelEmbed (embedding/ili.py) on make_synthetic's 512 images at
each size, y2h at 1 CNN and 2 MLP epochs, the y2cov at the CNN and MLP
epochs of each of --cuts (the recipe's defaults are 10 and 500; phases 18
and 27 of chip_smoke.py cut them to 1 and 20), batch 256, seed 0. Prints
one line per (size, cut): whether fn_y2cov is finite on nine labels in
[0.1, 0.9], its mean and largest value, its label variation
|h(0.1) - h(0.9)| / |h(0.1)|, the seconds of the whole LabelEmbed and of
each stage's epoch (ili.STAGE_SECONDS), the peak of device memory and the
bytes of embed_models/ (ModelY2Cov's weights: 3 x size^2 x 4096 of its
last Dense), beside the card's name and power limit.

--seeds (the CPU, needs the JAX package): stage 1 of the y2cov ILI alone,
train_resnet_embed at dim_embed 3 x size^2 (default size 192), ResNet34,
one epoch of two steps at batch 16 on 32 images of make_synthetic, in
JAX (ccdm_tpu.embedding.ili) and in the port, each from its own
initialisation and draws at seeds 0 to 7; prints the largest |feature| of
8 images in eval mode, whose growth past ~1e2 is the divergence.
"""

from __future__ import annotations

import argparse
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from ccdm_tpu_torch.data.datasets import make_synthetic  # noqa: E402
from ccdm_tpu_torch.embedding import ili  # noqa: E402


def folder_bytes(path: Path) -> int:
    return sum(p.stat().st_size for p in path.rglob("*") if p.is_file())


def card_mode(device: str, sizes: list, cuts: list) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = device == "cuda"
    if cuda:
        import chip_smoke

        print(chip_smoke.card_line(), flush=True)
    for size in sizes:
        bundle = make_synthetic(n=512, image_size=size, channels=3, seed=0)
        for ecnn, emlp in cuts:
            root = Path(tempfile.mkdtemp(prefix=f"y2cov_ili_{size}_", dir="build"))
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            embed = ili.LabelEmbed(bundle, str(root), dim_embed=128, y2cov_type="resnet",
                                   cov_dim=3 * size * size, epochs_cnn=1, epochs_mlp=2,
                                   epochs_cnn_y2cov=ecnn, epochs_mlp_y2cov=emlp,
                                   batch_size=256, seed=0, device=device)
            seconds = time.perf_counter() - t0
            h = embed.fn_y2cov(torch.linspace(0.1, 0.9, 9, device=device)).float()
            finite = bool(torch.isfinite(h).all())
            variation = (float(torch.linalg.norm(h[0] - h[-1]) / torch.linalg.norm(h[0]))
                         if finite else float("nan"))
            peak = torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else float("nan")
            embed_mb = folder_bytes(root / "embed_models") / 1e6
            print(f"size {size}, y2cov CNN {ecnn} and MLP {emlp} epochs: finite {finite}, h "
                  f"mean {float(h.mean()):.4g}, max {float(h.max()):.4g}, label variation "
                  f"{variation:.4f}; {seconds:.1f} s, epochs "
                  f"{ {k: round(v, 4) for k, v in ili.STAGE_SECONDS.items()} } s; peak "
                  f"{peak:.2f} GiB; embed_models/ {embed_mb:.1f} MB",
                  flush=True)
            del embed, h
            shutil.rmtree(root, ignore_errors=True)
            if cuda:
                torch.cuda.empty_cache()


def seeds_mode(size: int, seeds: range) -> None:
    import jax.numpy as jnp

    from ccdm_tpu.embedding import ili as jax_ili
    from ccdm_tpu.models.resnet_embed import ResNetEmbed as JaxResNetEmbed

    torch.set_num_threads(4)
    dim = 3 * size * size
    bundle = make_synthetic(n=32, image_size=size, channels=3, seed=0)
    images, labels = bundle.images, np.asarray(bundle.labels_norm, np.float32)
    x = images[:8].astype(np.float32) / 127.5 - 1
    for seed in seeds:
        v = jax_ili.train_resnet_embed(images, labels, dim, epochs=1, batch_size=16, seed=seed,
                                       log_every=0)
        _, h = JaxResNetEmbed(dim_embed=dim).apply(
            {"params": v["params"], "batch_stats": v["batch_stats"]}, jnp.asarray(x), train=False)
        net = ili.train_resnet_embed(images, labels, dim, epochs=1, batch_size=16, seed=seed,
                                     log_every=0)
        with torch.no_grad():
            _, hp = net(torch.from_numpy(x), train=False)
        print(f"size {size}, seed {seed}: largest |feature| in eval mode, JAX "
              f"{float(jnp.abs(h).max()):.3e}, the port {float(hp.abs().max()):.3e}", flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seeds", action="store_true")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--sizes", default="64,128,192")
    parser.add_argument("--cuts", default="1:20,10:20,1:500,10:500",
                        help="y2cov CNN:MLP epochs, comma-separated")
    parser.add_argument("--size", type=int, default=192, help="--seeds' image size")
    args = parser.parse_args()
    if args.seeds:
        seeds_mode(args.size, range(8))
        return
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("no CUDA device: run on the card, or pass --device cpu")
    Path("build").mkdir(exist_ok=True)
    cuts = [tuple(int(e) for e in c.split(":")) for c in args.cuts.split(",")]
    card_mode(args.device, [int(s) for s in args.sizes.split(",")], cuts)


if __name__ == "__main__":
    main()
