#!/usr/bin/env python3
"""How near phase 3's bf16 bound the bf16 rounding points of kernel #1 sit.

    python3 scripts/attn_bf16_margin.py [--device cpu|cuda]

For each shape of chip_smoke.CHECK_SHAPES at C >= 256 and N <= 1024, at
each batch the main paths give #1 (chip_smoke.RESNET_BATCHES), on phase 3's
inputs (chip_smoke.block_inputs, seeded as phase 3 seeds them), compares
with the plain version in f32 (attn_block_reference) two plain PyTorch
models, in f32 apart from their bf16 rounding points:
- "tpu": the TPU kernel's points (ccdm_tpu/ops/attn_block.py:_kernel): xn,
  k' = exp(k - m) / s, v, ctx, q' and the attention output;
- "port": csrc/attn_block.cu's (exp(k - m) in place of k'; the division by
  s after the product), chip_smoke.attn_rounded_reference.
Prints one JSON line per (shape, batch): for each model the largest ratio of
|y - y_f32| to phase 3's bound (3e-2 + 3e-2 max(|y_f32|, |y_f32 - x|)) and
the count of elements beyond it (ratio > 1). Needs no card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from ccdm_tpu_torch.ops import attn_block  # noqa: E402


def tpu_rounded(x, g_pre, wqkv, wout, bout, g_out):
    """#1 at the TPU kernel's bf16 rounding points, the rest in f32."""
    bf = lambda t: t.bfloat16().float()
    b, n, _ = x.shape
    f, xf = cs.F, x.float()
    xn = bf(xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + 1e-12) * g_pre.float())
    qkv = xn @ wqkv.float()
    heads = lambda t: t.reshape(b, n, cs.HEADS, cs.DIM_HEAD)
    q, k, v = qkv[..., :f], qkv[..., f:2 * f], qkv[..., 2 * f:]
    ek = torch.exp(k - k.amax(1, keepdim=True))
    ks = bf(ek / ek.sum(1, keepdim=True))
    ctx = bf(torch.einsum("bnhd,bnhe->bhde", heads(ks), heads(bf(v))))
    qs = bf(torch.softmax(heads(q), -1) * cs.DIM_HEAD ** -0.5)
    out = bf(torch.einsum("bnhd,bhde->bnhe", qs, ctx).reshape(b, n, f))
    o = out @ wout.float() + bout.float()
    return bf(xf + o * torch.rsqrt(o.square().mean(-1, keepdim=True) + 1e-12) * g_out.float())


def margin(got, want, x) -> dict:
    ratio = (got.float() - want).abs() / (3e-2 + 3e-2 * torch.maximum(want.abs(),
                                                                    (want - x).abs()))
    return {"max_ratio": round(ratio.max().item(), 4), "beyond": int((ratio > 1).sum())}


@torch.no_grad()
def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cpu")
    device = torch.device(ap.parse_args().device)
    for i, (n, c) in enumerate(cs.CHECK_SHAPES):
        if c < 256 or n > 1024:
            continue
        for batch in cs.RESNET_BATCHES:
            seed = i if batch == cs.BATCH else 100 + i
            x, w = cs.block_inputs(n, c, batch, device, seed=seed, x_std=1.0)
            xb, wb = x.bfloat16(), [t.bfloat16() for t in w]
            xf = xb.float()
            want = attn_block.attn_block_reference(xf, *(t.float() for t in wb),
                                                   cs.HEADS, cs.DIM_HEAD)
            print(json.dumps({"N": n, "C": c, "B": batch, "seed": seed,
                              "tpu": margin(tpu_rounded(xb, *wb), want, xf),
                              "port": margin(cs.attn_rounded_reference(xb, *wb), want, xf)}),
                  flush=True)


if __name__ == "__main__":
    main()
