#!/usr/bin/env python3
"""How often the multi-dim ILI label MLP comes out constant in y, in both
packages, at the same cut.

Offline, on the CPU, where both packages are installed:

    python scripts/ili_multidim_spread.py --seeds 0-11

For each seed, LabelEmbed of ccdm_tpu and of ccdm_tpu_torch trains on
make_synthetic_power (64 rows of 8 dims, 64x64, 1 channel, data seed 0)
at chip_smoke.py phase 19's cut (y2h resnet: 2 CNN epochs, 20 MLP
epochs, batch 256, dim 128, cross_attention), then prints the label MLP's
spread: the std over 21 labels in [0, 1] of fn_y2h, averaged over its 128
outputs. The two packages draw from different generators (JAX keys,
torch.Generator), so their runs differ seed by seed; what is compared is
the distribution over seeds. The runs go to a temporary folder.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
os.environ.setdefault("JAX_PLATFORMS", "cpu")


def spreads(package: str, seeds, rows: int, size: int) -> list[float]:
    import numpy as np

    if package == "jax":
        from ccdm_tpu.data.power import make_synthetic_power
        from ccdm_tpu.embedding.ili import LabelEmbed
        to_input = lambda y: y
    else:
        import torch

        from ccdm_tpu_torch.data.power import make_synthetic_power
        from ccdm_tpu_torch.embedding.ili import LabelEmbed
        to_input = torch.from_numpy
    bundle = make_synthetic_power(n=rows, image_size=size, label_dim=8, seed=0)
    probe = np.linspace(0, 1, 21).astype(np.float32)
    out = []
    for seed in seeds:
        with tempfile.TemporaryDirectory() as path:
            embed = LabelEmbed(bundle, path, dim_embed=128, epochs_cnn=2, epochs_mlp=20,
                               batch_size=256, seed=seed, dim_combination="cross_attention")
            h = np.asarray(embed.fn_y2h(to_input(probe)), np.float64)
        out.append(float(h.std(0).mean()))
        print(f"{package} seed {seed}: fn_y2h std over y {out[-1]:.3e}", flush=True)
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seeds", default="0-11", help="a range a-b or a comma list")
    parser.add_argument("--rows", type=int, default=64)
    parser.add_argument("--image_size", type=int, default=64)
    args = parser.parse_args(argv)
    if "-" in args.seeds:
        lo, hi = map(int, args.seeds.split("-"))
        seeds = list(range(lo, hi + 1))
    else:
        seeds = [int(s) for s in args.seeds.split(",")]
    import numpy as np

    for package in ("port", "jax"):
        vals = np.array(spreads(package, seeds, args.rows, args.image_size))
        print(f"{package}: median {np.median(vals):.4f}, constant (< 1e-5) in "
              f"{int((vals < 1e-5).sum())} of {len(vals)} seeds", flush=True)


if __name__ == "__main__":
    main()
