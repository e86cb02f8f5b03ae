#!/usr/bin/env python3
"""Time variants of kernels #10 and #11 against each other on one card.

    python3 scripts/resnet_variants.py

Each variant is ccdm_tpu_torch/csrc/resnet_block.cu with its tunables
substituted: the K slice (kBK), the depth of the cp.async ring (kStages) and
the waves of blocks the split route's K splits aim at (kSplitWaves). The
variants build in parallel with the port's nvcc flags into
build/resnet_variants/, then run in turns (the committed values first and
last) through the port's wrappers at the 11 shapes of the RC-49 64x64
UNet's 23 resnet blocks at B 64 in bf16: each call held to its plain
version at chip_smoke.py's bound (4e-2), then timed with CUDA events
(chip_smoke.time_ms). Prints per variant the sums over the 23 launches of
each half, the per-level sums and each shape's route. Needs the card.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from ccdm_tpu_torch.ops import _build  # noqa: E402
from ccdm_tpu_torch.ops import resnet_block as rb  # noqa: E402

SOURCE = (_build.CSRC_DIR / "resnet_block.cu").read_text()
OUT = ROOT / "build" / "resnet_variants"
TUNABLES = {"kBK": "constexpr int kBK = {};", "kStages": "constexpr int kStages = {};",
            "kSplitWaves": "constexpr int kSplitWaves = {};"}
COMMITTED = {"kBK": 64, "kStages": 3, "kSplitWaves": 1}
VARIANTS = [COMMITTED, {**COMMITTED, "kBK": 32}, {**COMMITTED, "kStages": 4},
            {**COMMITTED, "kSplitWaves": 2}, {**COMMITTED, "kBK": 32, "kSplitWaves": 2}]


def name_of(v: dict) -> str:
    return "_".join(f"{k}{v[k]}" for k in TUNABLES)


def source_of(v: dict) -> str:
    src = SOURCE
    for key, decl in TUNABLES.items():
        committed = decl.format(COMMITTED[key])
        if committed not in src:
            raise RuntimeError(f"csrc/resnet_block.cu no longer declares `{committed}`")
        src = src.replace(committed, decl.format(v[key]), 1)
    return src


def build(v: dict) -> Path:
    OUT.mkdir(parents=True, exist_ok=True)
    src, lib = OUT / f"{name_of(v)}.cu", OUT / f"lib{name_of(v)}.so"
    src.write_text(source_of(v))
    for header in _build.CSRC_DIR.glob("*.cuh"):  # the headers the source includes
        shutil.copy(header, OUT)
    proc = subprocess.run(_build.nvcc_command(_build.find_nvcc(), src, lib),
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stdout}{proc.stderr}")
    return lib


@torch.no_grad()
def run(lib: ctypes.CDLL, name: str, inputs: dict) -> None:
    rb._library = lambda: lib
    rb.plan.cache_clear()
    halves, levels, shapes = {"a": 0.0, "b": 0.0}, {}, []
    for (hh, cin, cout), k in cs.RESNET_SHAPES.items():
        x, scale, shift, w1, b1, g1, w2, b2, g2, wres, bres = inputs[hh, cin, cout]
        a_args = (x, scale, shift, w1, b1, g1, hh, hh)
        h1 = rb.resnet_half_a(*a_args)
        b_args = (h1, x, w2, b2, g2, wres, bres, hh, hh)
        tag = f"{name} H={hh} Cin={cin} Cout={cout}"
        cs.check_close(h1, rb.half_a_reference(*a_args), 4e-2, 4e-2, f"#10 {tag}")
        cs.check_close(rb.resnet_half_b(*b_args), rb.half_b_reference(*b_args), 4e-2, 4e-2,
                       f"#11 {tag}")
        ta = cs.time_ms(lambda: rb.resnet_half_a(*a_args))
        tb = cs.time_ms(lambda: rb.resnet_half_b(*b_args))
        pl = rb.plan("a", cs.BATCH, hh, hh, cin, cout, False, torch.bfloat16)
        halves["a"] += k * ta
        halves["b"] += k * tb
        levels[hh] = levels.get(hh, 0.0) + k * (ta + tb)
        shapes.append(f"H{hh} {cin}->{cout} {ta:.4f}/{tb:.4f} {pl.route} x{pl.splits}")
    print(f"{name}: #10 {halves['a']:.4f} ms, #11 {halves['b']:.4f} ms, sum "
          f"{halves['a'] + halves['b']:.4f} ms; per level "
          + ", ".join(f"H{h} {v:.4f}" for h, v in levels.items()), flush=True)
    print("    " + "; ".join(shapes), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("resnet_variants: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = {name_of(v): rb.declare(ctypes.CDLL(str(lib)))
                for v, lib in zip(VARIANTS, pool.map(build, VARIANTS))}
    print(f"{len(libs)} variants built in {time.perf_counter() - t0:.1f} s; {cs.card_line()}",
          flush=True)
    device = torch.device("cuda")
    inputs = {}
    for i, shape in enumerate(cs.RESNET_SHAPES):
        t = cs.resnet_inputs(*shape, cs.BATCH, device, seed=80 + i)
        bf = lambda key: None if t[key] is None else t[key].to(torch.bfloat16)
        inputs[shape] = (bf("x"), t["scale"], t["shift"], bf("w1"), t["b1"], t["g1"], bf("w2"),
                         t["b2"], t["g2"], bf("wres"), t["bres"])
    names = list(libs) + [name_of(COMMITTED)]
    for name in names:
        run(libs[name], name, inputs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
