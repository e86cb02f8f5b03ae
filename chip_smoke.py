#!/usr/bin/env python3
"""Smoke check of the PyTorch/CUDA port (ccdm_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each announced on a flushed line before it starts:
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
  2. build: the five kernel libraries, one nvcc each, in parallel
     (seconds, ptxas report);
  3. kernel #1 (the single-pass attention block) against its plain PyTorch
     version at every shape of the attention blocks of the RC-49 64x64, the
     128x128 and the 192x192 UNet (N 9 to 36864, C 64 to 512), B 64:
     bf16 against the plain version in f32 on the same bf16-rounded inputs
     (rtol = atol = 3e-2, rtol relative to max(|y|, |y - x|), x ~ N(0, 1);
     at C <= 256 and at the 64x64 UNet's shapes) and against the plain
     version at the kernel's bf16 rounding points (same bound, every
     shape), and f32 with TF32 off (rtol 2e-3, atol 2e-4, x ~ N(0, 2)), the
     bounds and inputs of the JAX kernel's tests; each shape timed in bf16
     with CUDA events, with the route the plan took (asserted: fused at
     N <= 128, else split with its splits), the wrapper's host time,
     TFLOP/s and the share of the bound; then the same per attention level
     of one B-64 forward of the 64x64 UNet; then bf16 at every shape again
     at the other batches the main paths give #1 (128, 72, 8), the same
     checks (the f32 one at C <= 256) and route assertion, untimed;
  4. the full-width UNet in f32 (TF32 off) with the kernel and with the
     plain attention: one forward (max abs diff <= 1e-3) and a 5-step CFG
     DDIM run from the same noise ([0,1] images, max abs diff <= 1e-3);
  5. the serving main path: the port's SamplerService at full width in bf16
     (batch 32, 250 DDIM steps, cond_scale 1.5) behind its own HTTP server on
     127.0.0.1 in a daemon thread, GET /healthz and two POST /generate
     (uint8 [n, 64, 64, 3], not constant; the service refuses a sample that
     is not finite before quantising it); kernel #1's launch count over
     this phase must be 10 x 250 x batches; then one CFG forward of the
     service's model (B 64) timed with CUDA events;
  6. kernels #2-#5 (two-pass forward, fused backward) against their plain
     versions at every two-pass shape of the three UNets, B 128: (N, C)
     (4096, 64), (2048, 64), (16384, 64), (4096, 128) and (36864, 64) at
     B 32, in bf16 and in f32: forward bounds as phase 3 (a and s relative
     to their largest value), kmax within 1e-5 of its largest value (in
     bf16 against the plain version at the tensor route's rounding points,
     ctx_large_tensor_reference, and against ctx_large_reference by
     kmax_check, at every shape), backward bounds of
     tests/test_attn_block.py:301-308 (f32 rtol = atol = 2e-3; bf16 rtol
     1e-1, atol 0.02 max(|g|, 1)); in f32 also #4 + #5 through the autograd
     Function against autograd through the plain block; in bf16 #5 nearer
     its plain version than one with d_a rounded to bf16 (check_rounding),
     and #2-#5 on their tensor-core route (asserted, with tile and
     splits); each timed in bf16 (event and host time, TFLOP/s, share of
     the bound); then #2 + #3 against #1 at sampling time (B 64, bf16, N
     4096 and 16384); then the block at dim_head 64 (2 heads; B 8, N 4096,
     C 64; bf16 and f32) through its kernels' CUDA-core routes (asserted,
     one launch each of #1-#5 counted) against the plain block and autograd
     through it (dim_head_vs_plain);
  7. one loss + backward of the full-width f32 UNet (TF32 off) with the
     kernels and with plain attention on the same batch and draws: every
     gradient leaf within 1e-3 of its largest |g| (the two biases feeding a
     train-mode BatchNorm, whose exact gradient is zero, within 1e-3 of the
     model's largest |g|), the loss to 1e-5;
  8. the training main path: `python -m ccdm_tpu_torch.main` at full width,
     batch 128, bf16, 30 steps, a milestone at the end (run folder
     build/smoke_run, deleted after), then 2 eval labels x 4 images, 10
     DDIM steps, as main.py samples after training: losses finite,
     parameters moved, ema_step 30, launches exactly 8 of #1 and 2 each of
     #2-#5 per step, 10 of #1 per sampling forward and none of #10 and
     #11; warm train images/s; then SamplerService --serve_milestone serves
     4 labels x 25 DDIM steps from that milestone (uint8, not constant);
  9. kernels #10 and #11 (the fused resnet block's halves) against their
     plain versions at the 11 shapes of the UNet's 23 resnet blocks, at
     every batch the main paths give them (64 served, 128 trained, 72 for
     the EMA grid, 8 for the eval sampling and the ddpm request): f32 with
     TF32 off (rtol 2e-3, atol 2e-4) and bf16 (rtol = atol = 4e-2), the
     bounds of tests/test_resnet_block.py; at B 64 (and B 128 at 64x64)
     each shape timed in bf16 beside its plain versions, each half's
     composition in resnet_block_reference (library_ms), its bare cuDNN
     convs (cudnn_conv_ms) and the cuDNN composition of the whole block (the
     route of the switch off), with the route the kernels took (fused or
     split, tile, K splits), the wrappers' host time, TFLOP/s and the share
     of the bound; then the same per level (H = W) over one B-64 forward;
  10. the full-width f32 UNet (TF32 off) with CCDM_TPU_FUSED_RESBLOCK on
     against off: one forward and a 5-step CFG DDIM run from the same noise,
     each within 1e-3 (phase 4's check); 23 launches of each kernel per
     switch-on forward;
  11. serving with the switch on: SamplerService at full width in bf16,
     batch 32, 25 DDIM steps, over HTTP; launches exactly 23 x 25 x batches
     of #10 and #11 (and 10 x 25 x batches of #1); phase 5's CFG forward
     timed with the switch on, then with the switch off and on in turns
     (event and host time); then one request to a --sampler ddpm service
     with 10 ancestral steps (uint8, not constant);
  12. training with the switch on: `python -m ccdm_tpu_torch.main` at full
     width, batch 128, bf16, 5 steps, --sample_every 5 (one EMA grid of 36
     images, 10 DDIM steps), a milestone, then 2 eval labels x 4 images,
     10 DDIM steps: losses finite, the PNG grids decode to images that are
     not constant, launches exactly 23 of #10 and #11 per UNet forward
     (and #1-#5 as in phase 8, plus 10 of #1 per EMA-grid forward);
  13. kernels #6 and #9 (standalone linear attention) against their plain
     versions at the UNet's attention levels (N 4096 to 16, H 4, D 32) at
     B 64 and B 128, and at (H, D) (2, 64), (8, 16), (1, 128), N 1024: f32
     with TF32 off (rtol 2e-3, atol 1e-4) and bf16 (rtol 3e-2, atol 3e-2 of
     the largest |y|), the bounds of tests/test_linear_attention.py; in
     bf16 each kernel's mean distance to its plain version at most a quarter
     of that to the other's, which rounds at other points; #6's route
     (la_plan: tensor cores in bf16, CUDA cores in f32; asserted) and #9's
     (per_head_plan: whole rows in f32 in bf16, CUDA cores in f32;
     asserted) with their splits, and #6 timed in bf16 at every shape (#9
     at B 64), with the wrapper's host time, TFLOP/s and the share of the
     bound (#9's products at the f32 rate); each the same bits on two
     calls at B 64, N 4096;
  14. kernels #7 + #8 (its two-pass form) against their plain versions at
     (B 64, N 16384), (B 128, N 4096), (B 16, N 36864), (B 16, N 6144) and
     (B 16, N 4096, chunks of 1024), same bounds (a and s relative to their
     largest value) and the same test of rounding points (a from the
     unrounded exp(k - m), s from the rounded one, q' of #8 in f32); #7's
     route (twopass_plan: tensor cores in bf16) and #8's asserted, each
     timed at every shape (TFLOP/s, share of the bound) and the same bits
     on two calls at B 64, N 16384, where the dispatcher's two-pass route,
     the plain reference and #9 are timed on the same q, k, v;
  15. kernel #12 (bias_act) against its plain version: all 9 activations,
     bias or not, clamp none or 1.5, default gain or 0.5, f32 (rtol 1e-5,
     atol 1e-6) and bf16 (8e-3, one unit), at GAN feature maps of batch 64
     and 1003 rows; lrelu timed per shape, and beside F.leaky_relu where
     the case is that one call, each by events, host time and the card's
     own time (kernel durations from torch.profiler);
  16. this slice's path (module docstring of la_main_path): the
     PreNormResidual(LinearAttention) module at the UNet's ten attention
     levels (#6: its bf16 calls on the tensor route, its f32 calls on the
     CUDA cores, asserted), the module on the two-pass route (#7 + #8),
     linear_attention_per_head (#9), bias_act(impl="auto") (#12); exact
     launch counts; in f32 the module within 1e-4 of kernel #1's
     FusedLinearAttentionBlock on the same weights;
  17. one f32 loss + backward through the module at B 128, N 4096 (#6
     forward, plain backward) against the all-plain route: every gradient
     within 1e-3 of its largest |g|;
  18. the share of the timed CFG forwards that the 23 blocks take (the
     cuDNN composition with the switch off, #10 + #11 with it on, each
     timed alone in phase 9), #10 + #11 against that composition and per
     level, then one JSON line {"kernels": [...]} with errors, times and
     bounds of all 12 kernels (#1 with its route per shape, #12 with the
     card's own time beside F.leaky_relu's);
  19. the card's name and power limit, then the last line
     {"ok": true, "device": {...}}.
The five kernel libraries build in parallel, one nvcc each (phase 2). Each
main path (phases 5, 8, 11, 12, 16) starts from launch counts set to 0 and
reads them just after; the paths of phases 5, 8, 11 and 12 launch none of
#6-#9 and #12. TF32 is off for the whole run (it only touches the f32
checks and the f32 convolutions). Any failed phase raises and the script
exits non-zero; a hang becomes a stack dump and a non-zero exit after
1100 s. It writes nothing outside build/.
"""

from __future__ import annotations

import base64
import contextlib
import faulthandler
import io
import json
import math
import shutil
import struct
import subprocess
import sys
import threading
import time
import urllib.request
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ccdm_tpu_torch.diffusion.gaussian import DiffusionConfig, GaussianDiffusion
from ccdm_tpu_torch.embedding.analytic import make_fn_y2h
from ccdm_tpu_torch.models.layers import FusedLinearAttentionBlock, LinearAttention, PreNormResidual
from ccdm_tpu_torch.models.unet import Unet
from ccdm_tpu_torch.ops import _build, attn_block, resnet_block
from ccdm_tpu_torch.ops import linear_attention as la
from ccdm_tpu_torch.ops import style_ops as so
from ccdm_tpu_torch.opts import parse_opts
from ccdm_tpu_torch.serve import SamplerService, serve
from ccdm_tpu_torch.utils.convert import prenorm_linear_attention_from_fused

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOPS = 989e12        # dense bf16 tensor-core peak, same source
HEADS, DIM_HEAD = 4, 32
F = HEADS * DIM_HEAD
SERVE_BATCH = 32
BATCH = 2 * SERVE_BATCH    # the cond and null rows of one CFG forward
STEPS = 250
# (N, C) of the ten attention blocks of one RC-49 64x64 UNet forward
# (dim 64, mults 1_2_2_4_8): down levels 0-4, then up levels 0-4
FORWARD_SHAPES = [(4096, 64), (1024, 64), (256, 128), (64, 128), (16, 256),
                  (16, 512), (64, 256), (256, 128), (1024, 128), (4096, 64)]
UNET = dict(dim=64, dim_mults=(1, 2, 2, 4, 8), in_channels=3)


def unet_attn_shapes(size: int, mults: tuple, dim: int = 64) -> list:
    """(N, C) of a UNet's attention blocks (models/unet.py): each down level
    at its input width, then each up level at its output width."""
    dims = [dim] + [dim * m for m in mults]
    pairs = list(zip(dims[:-1], dims[1:]))
    down = [((size >> i) ** 2, c_in) for i, (c_in, _) in enumerate(pairs)]
    up = [((size >> (len(pairs) - 1 - i)) ** 2, c_out)
          for i, (_, c_out) in enumerate(reversed(pairs))]
    return down + up


assert unet_attn_shapes(64, UNET["dim_mults"]) == FORWARD_SHAPES
# the 64x64 UNet's shapes and the top levels of the 128x128 (uk128, mults
# 1_2_4_4_8_8) and 192x192 (uk192, mults 1_2_2_4_4_8_8) UNets, then the other
# shapes of those two: every shape #1 meets on the three models. A shape's
# index seeds its inputs.
CHECK_SHAPES = sorted(set(FORWARD_SHAPES), reverse=True) + [(16384, 64), (36864, 64)]
CHECK_SHAPES += sorted(set(unet_attn_shapes(128, (1, 2, 4, 4, 8, 8)) +
                           unet_attn_shapes(192, (1, 2, 2, 4, 4, 8, 8))) - set(CHECK_SHAPES),
                       reverse=True)
# blocks of the split route's passes: two an SM on the H100's 132 SMs
ATTN_SPLIT_BLOCKS = 2 * 132
SERVE_ARGV = ["--image_size", "64", "--model_channels", "64",
              "--channel_mult", "1_2_2_4_8", "--train_amp", "--pred_objective", "pred_x0",
              "--sample_timesteps", str(STEPS), "--sample_cond_scale", "1.5",
              "--seed", "0"]


def phase(text: str) -> None:
    print(f"== {text}", flush=True)


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """The host's time per call (Python, checks, allocation, the launch),
    with no synchronisation inside the loop: where time_ms is no larger,
    the card waited on the host between back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(reps):
        fn()
    elapsed = time.perf_counter() - start
    torch.cuda.synchronize()
    return elapsed / reps * 1e3


def device_ms(fn, reps: int = 20, warmup: int = 3) -> dict:
    """The card's own time per call, by kernel name: the durations that
    torch.profiler's trace gives the kernels (and copies) that `reps`
    calls launched, summed per name and divided by reps (ms). Unlike
    time_ms, the gaps in which the card waited on the host do not count."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / reps / 1e3 for e in prof.key_averages()
            if e.self_device_time_total > 0}


def bound_parts(n: int, c: int, batch: int = BATCH, itemsize: int = 2) -> tuple[float, float]:
    """Least times (ms) of one call: the bytes it must move (x read, y
    written, the weights read once) over HBM bandwidth, and its operations
    over the bf16 peak. The bound is the larger."""
    nbytes = (2 * batch * n * c + c * 3 * F + F * c + 3 * c) * itemsize
    flops = 2 * batch * n * (3 * c * F + 2 * F * DIM_HEAD + F * c)
    return nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3


def block_inputs(n: int, c: int, batch: int, device, seed: int, x_std: float):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(batch, n, c, generator=g) * x_std
    weights = (1 + 0.5 * torch.randn(c, generator=g), 0.1 * torch.randn(c, 3 * F, generator=g),
               0.1 * torch.randn(F, c, generator=g), 0.1 * torch.randn(c, generator=g),
               1 + 0.5 * torch.randn(c, generator=g))
    return x.to(device), [w.to(device) for w in weights]


def check_close(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float,
                what: str, scale: torch.Tensor | None = None) -> float:
    """|got - want| <= atol + rtol * scale elementwise (scale |want| by
    default); returns the max abs error."""
    diff = (got.float() - want.float()).abs()
    if not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"{what}: non-finite output")
    bad = diff > atol + rtol * (want.float().abs() if scale is None else scale)
    if bool(bad.any()):
        raise AssertionError(f"{what}: {int(bad.sum())} elements beyond rtol {rtol}, "
                             f"atol {atol}; max abs err {diff.max().item():.3e}")
    return diff.max().item()


def attn_route_of(batch: int, n: int, c: int) -> tuple[str, int]:
    """The route and splits that #1's plan must give a UNet shape in bf16:
    fused where a block holds the row (N <= 128), else split, with as many
    blocks a row as fill ATTN_SPLIT_BLOCKS in one wave, at most one a tile
    of 64 tokens."""
    pl = attn_block.plan(batch, n, c, HEADS, torch.bfloat16)
    want = ("fused", 1) if n <= 128 else \
        ("split", min(-(-n // 64), max(1, ATTN_SPLIT_BLOCKS // batch)))
    if (pl.route, pl.splits) != want:
        raise AssertionError(f"#1's plan at B {batch}, N {n}, C {c}: {pl.route} x{pl.splits}, "
                             f"expected {want[0]} x{want[1]}")
    return want


def attn_rounded_reference(x, g_pre, wqkv, wout, bout, g_out):
    """The plain version of #1 in bf16 at its rounding points, the rest in
    f32: the plain #2 (xn, exp(k - m) and v as bf16 operands, s unrounded)
    and the plain #3 (q' and the attention output as bf16 operands) with
    ctx = a / s rounded to bf16 between them, as csrc/attn_block.cu does."""
    a, s, _ = attn_block.ctx_large_reference(x, g_pre, wqkv, HEADS)
    ctx = (a / s.clamp_min(1e-30).view(*a.shape[:3], 1)).to(x.dtype)
    return attn_block.out_large_reference(x, g_pre, wqkv, ctx, wout, bout, g_out, HEADS)


def holds_f32_plain(n: int, c: int, batch: int) -> bool:
    """Whether phase 3 holds #1 in bf16 to its plain version in f32 at this
    shape: at C <= 256, and at the 64x64 UNet's shapes at B 64, as before.
    At C 512 the bf16 rounding points themselves, the TPU kernel's
    included, reach that bound (scripts/attn_bf16_margin.py, PERF.md):
    there the kernel is held to its plain version at those points only."""
    return c <= 256 or (batch == BATCH and (n, c) in FORWARD_SHAPES)


def attn_bf16_check(n: int, c: int, batch: int, device, seed: int) -> tuple:
    """#1 in bf16 (x ~ N(0, 1), the JAX kernel's tests) against its plain
    version at its rounding points (attn_rounded_reference) and, where
    holds_f32_plain, against its plain version in f32 on the same
    bf16-rounded inputs; each at rtol = atol = 3e-2, rtol relative to the
    larger of |y| and the block's own term |y - x| (where x cancels that
    term, the bf16 operand roundings, about 1% of it at C 512, stand beside
    a small |y|). Returns the two max abs errors (the second None where not
    held) and the bf16 inputs."""
    x, w = block_inputs(n, c, batch, device, seed=seed, x_std=1.0)
    xb, wb = x.bfloat16(), [t.bfloat16() for t in w]
    del x, w
    got, xf = attn_block.fused_attn_block(xb, *wb, HEADS, DIM_HEAD), xb.float()

    def err(want, what: str) -> float:
        return check_close(got, want, 3e-2, 3e-2, f"bf16 B={batch} N={n} C={c} ({what})",
                           scale=torch.maximum(want.abs(), (want - xf).abs()))

    rounded = err(attn_rounded_reference(xb, *wb).float(), "plain at its rounding points")
    plain = err(attn_block.attn_block_reference(xf, *(t.float() for t in wb), HEADS, DIM_HEAD),
                "plain in f32") if holds_f32_plain(n, c, batch) else None
    return rounded, plain, xb, wb


@torch.no_grad()
def kernel_vs_plain(device) -> tuple[dict, dict]:
    """Phase 3: per shape, errors in bf16 and f32 and times in bf16 at B 64;
    then bf16 errors at the other batches the main paths give #1. Returns
    the rows by shape and the errors by batch."""
    rows = {}
    for i, (n, c) in enumerate(CHECK_SHAPES):
        # x ~ N(0, 1) in bf16 and N(0, 2) in f32, the inputs of the JAX
        # kernel's own tests (tests/test_attn_block.py:61-101)
        route, splits = attn_route_of(BATCH, n, c)
        err_r, err_b, xb, wb = attn_bf16_check(n, c, BATCH, device, seed=i)
        kernel_b = lambda: attn_block.fused_attn_block(xb, *wb, HEADS, DIM_HEAD)
        plain_b = lambda: attn_block.attn_block_reference(xb, *wb, HEADS, DIM_HEAD)
        x, w = block_inputs(n, c, BATCH, device, seed=i, x_std=2.0)
        err_f = check_close(attn_block.fused_attn_block(x, *w, HEADS, DIM_HEAD),
                            attn_block.attn_block_reference(x, *w, HEADS, DIM_HEAD),
                            2e-3, 2e-4, f"f32 N={n} C={c}")
        del x, w
        t_bytes, t_ops = bound_parts(n, c)
        row = {"max_err_bf16": err_b, "max_err_bf16_rounded": err_r, "max_err_f32": err_f,
               **timing(kernel_b, plain_b, (t_bytes, t_ops)), "route": route, "splits": splits}
        row["tflops"] = t_ops * BF16_FLOPS / row["ms"] / 1e12
        row["bound_share"] = row["bound_ms"] / row["ms"]
        rows[f"N{n}_C{c}"] = row
        print(f"   N={n:5d} C={c:3d} B={BATCH}: {json.dumps(row)}", flush=True)
        del xb, wb
        torch.cuda.empty_cache()
    print_attn_levels(rows)
    # the other batches of the main paths (RESNET_BATCHES): bf16 only, untimed
    by_batch = {}
    for batch in RESNET_BATCHES[1:]:
        errs = {}
        for i, (n, c) in enumerate(CHECK_SHAPES):
            route, splits = attn_route_of(batch, n, c)
            errs[f"N{n}_C{c} {route} x{splits}"] = attn_bf16_check(n, c, batch, device,
                                                                   seed=100 + i)[:2]
            torch.cuda.empty_cache()
        by_batch[f"B{batch}"] = errs
        print(f"   B={batch} bf16: {len(errs)} shapes within the bound, max abs err "
              f"{max(e for pair in errs.values() for e in pair if e is not None):.3e} "
              f"(against the rounded plain version, then the f32 one); {json.dumps(errs)}",
              flush=True)
    return rows, by_batch


def print_attn_levels(rows: dict) -> None:
    """Kernel #1 per attention level of one B-64 forward (down 0-4, then up
    0-4), and the sum of the ten launches."""
    total = {"ms": 0.0, "host_ms": 0.0, "bound_ms": 0.0, "plain_ms": 0.0}
    for i, (n, c) in enumerate(FORWARD_SHAPES):
        r = rows[f"N{n}_C{c}"]
        for key in total:
            total[key] += r[key]
        print(f"   {'down' if i < 5 else 'up'} {i % 5} N={n:5d} C={c:3d}: {r['ms']:.4f} ms "
              f"({r['tflops']:.1f} TFLOP/s, {100 * r['bound_share']:.1f}% of the bound "
              f"{r['bound_ms']:.4f}), host {r['host_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms; "
              f"{r['route']} route, {r['splits']} split(s)", flush=True)
    print(f"   the ten: {total['ms']:.4f} ms ({100 * total['bound_ms'] / total['ms']:.1f}% of the "
          f"bound {total['bound_ms']:.4f}), host {total['host_ms']:.4f} ms, plain "
          f"{total['plain_ms']:.4f} ms", flush=True)


@contextlib.contextmanager
def plain_attention():
    """Route the model's attention blocks through the plain version."""
    kernel = attn_block.fused_attn_block
    attn_block.fused_attn_block = attn_block.attn_block_reference
    try:
        yield
    finally:
        attn_block.fused_attn_block = kernel


@torch.no_grad()
def model_parity(device, kernels=contextlib.nullcontext, plain=plain_attention,
                 what: str = "kernel and plain attention") -> dict:
    """Phases 4 and 10: the full-width f32 UNet, one forward and a 5-step CFG
    DDIM run from the same weights and noise, under `kernels()` and under
    `plain()`; each within 1e-3."""
    model = Unet(**UNET, dtype=torch.float32, seed=0).to(
        device, memory_format=torch.channels_last).eval()
    g = torch.Generator().manual_seed(1)
    b = 4
    x = torch.randn(b, 64, 64, 3, generator=g).to(device)
    t = torch.tensor([0, 250, 500, 999], device=device)
    emb = make_fn_y2h(128)(torch.linspace(0.1, 0.9, b, device=device))
    keep = torch.tensor([True, False, True, False], device=device)
    with kernels():
        out_k = model(x, t, emb, keep)
    with plain():
        out_p = model(x, t, emb, keep)
    fwd = (out_k - out_p).abs().max().item()

    diffusion = GaussianDiffusion(model, DiffusionConfig(
        image_size=64, channels=3, timesteps=1000, sampling_timesteps=5,
        objective="pred_x0"), device=device)
    noise = torch.randn(2, 64, 64, 3, generator=g).to(device)
    with kernels():
        img_k = diffusion.ddim_sample(emb[:2], cond_scale=1.5, noise=noise)
    with plain():
        img_p = diffusion.ddim_sample(emb[:2], cond_scale=1.5, noise=noise)
    ddim = (img_k - img_p).abs().max().item()
    print(f"   forward max abs diff {fwd:.3e}; 5-step DDIM max abs diff {ddim:.3e}",
          flush=True)
    if not (fwd <= 1e-3 and ddim <= 1e-3):
        raise AssertionError(f"{what} disagree in the model: "
                             f"forward {fwd:.3e}, DDIM {ddim:.3e} (bound 1e-3)")
    return {"forward_max_abs_diff": fwd, "ddim5_max_abs_diff": ddim}


def _request(url: str, body: dict | None = None) -> dict:
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        return json.loads(resp.read())


def _serve_requests(service: SamplerService, requests, image_size: int) -> tuple[int, int, float]:
    """POST each (n labels, seed) of `requests` to /generate of `service`
    behind its HTTP server on 127.0.0.1; checks /healthz and every reply
    (uint8 [n, size, size, 3], not constant) and stops the server. Returns
    (batches sampled, images, seconds spent in the requests)."""
    httpd = serve(service, 0, host="127.0.0.1", block=False)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    batches, n_images, req_s = 0, 0, 0.0
    try:
        health = _request(url + "/healthz")
        if health.get("status") != "ok" or health.get("warm") != service.warm:
            raise AssertionError(f"/healthz answered {health}")
        for n, seed in requests:
            labels = np.linspace(0.05, 0.95, n).round(4).tolist()
            t0 = time.perf_counter()
            reply = _request(url + "/generate", {"labels": labels, "seed": seed})
            req_s += time.perf_counter() - t0
            images = np.load(io.BytesIO(base64.b64decode(reply["images_b64"])))["images"]
            if images.dtype != np.uint8 or images.shape != (n, image_size, image_size, 3):
                raise AssertionError(f"/generate gave {images.dtype} {images.shape}")
            if images.std() == 0:
                raise AssertionError("/generate gave constant images")
            n_images += n
            batches += -(-n // service.max_batch)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
    if thread.is_alive():
        raise AssertionError("the HTTP server thread did not stop")
    return batches, n_images, req_s


@torch.no_grad()
def cfg_forward_ms(service: SamplerService) -> float:
    """One sampling step's CFG forward of `service`'s model: SERVE_BATCH
    labels, so B = BATCH rows, timed with CUDA events."""
    device, c = service.diffusion.device, service.diffusion.config
    g = torch.Generator().manual_seed(5)
    x = torch.randn(SERVE_BATCH, c.image_size, c.image_size, c.channels, generator=g).to(device)
    t = torch.full((SERVE_BATCH,), 500, device=device)
    emb = service.fn_y2h(torch.linspace(0.05, 0.95, SERVE_BATCH, device=device)[:, None])
    return time_ms(lambda: service.diffusion.model_predictions(x, t, emb, cond_scale=1.5),
                   reps=10)


def cfg_forward_turns(service: SamplerService) -> dict:
    """The same CFG forward with the resnet switch off and on in turns (off,
    on, on, off): per switch, the mean event time and the mean host time
    (the Python and the enqueue of 10 forwards, no synchronisation inside).
    Where the two are equal, the forward waits on the host."""
    device, c = service.diffusion.device, service.diffusion.config
    g = torch.Generator().manual_seed(5)
    x = torch.randn(SERVE_BATCH, c.image_size, c.image_size, c.channels, generator=g).to(device)
    t = torch.full((SERVE_BATCH,), 500, device=device)
    emb = service.fn_y2h(torch.linspace(0.05, 0.95, SERVE_BATCH, device=device)[:, None])
    fwd = lambda: service.diffusion.model_predictions(x, t, emb, cond_scale=1.5)
    out = {"off": {"ms": [], "host_ms": []}, "on": {"ms": [], "host_ms": []}}
    for on in (False, True, True, False):
        with fused_resnet(on):
            r = out["on" if on else "off"]
            r["ms"].append(time_ms(fwd, reps=10))
            r["host_ms"].append(host_ms(fwd, reps=10))
    return {k: {m: sum(v) / len(v) for m, v in r.items()} for k, r in out.items()}


def serve_main_path(device, card: str) -> dict:
    """Phase 5: requests through the port's HTTP server; returns the
    kernel's launch count over the phase and the throughput."""
    args = parse_opts(SERVE_ARGV)
    _reset_counts()
    t0 = time.perf_counter()
    service = SamplerService(args, max_batch=SERVE_BATCH, warm=True, device=str(device))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    batches, n_images, req_s = _serve_requests(service, ((5, 0), (40, 1)), args.image_size)
    batches += 1  # the warm-up batch
    counts = _counts()
    launches = counts["attn_block"]
    expected = 10 * STEPS * batches
    ips = n_images / req_s
    print(f"   {batches} batches of {SERVE_BATCH} (warm-up {warm_s:.1f} s), "
          f"{n_images} images in {req_s:.2f} s: {ips:.2f} images/s on {card}; "
          f"attention kernel launches {launches} (expected {expected}); resnet kernel "
          f"launches {counts['resnet_half_a']}, {counts['resnet_half_b']} (expected 0)",
          flush=True)
    if launches != expected:
        raise AssertionError(f"the serving path launched the attention kernel "
                             f"{launches} times, expected {expected}")
    if any(counts[name] for name in (*RESNET, *NEW_KERNELS)):
        raise AssertionError(f"the serving path ran a kernel not on it: {counts}")
    forward_ms = cfg_forward_ms(service)
    print(f"   one CFG forward (B {BATCH}, bf16): {forward_ms:.4f} ms", flush=True)
    return {"launches": launches, "batches": batches, "images_per_s": ips,
            "requested_images": n_images, "request_s": req_s, "cfg_forward_ms": forward_ms}


# ------------------------------------------------- the training slice

TRAIN_BATCH = 128
TRAIN_STEPS = 30
# (N, C) of kernels #2-#5: the two N 4096 blocks of the 64x64 training step
# first (the main path's shape), then N 2048, the 128x128 UNet's 128^2 and
# 64^2 up levels (N 16384 C 64, N 4096 C 128) and the 192x192 UNet's 192^2
# level: every two-pass shape of the three UNets. A shape's index seeds its
# inputs.
LARGE_SHAPES = [(4096, 64), (2048, 64), (16384, 64), (4096, 128), (36864, 64)]
# the batch of each shape: TRAIN_BATCH, but B 32 at N 36864, where the plain
# versions' f32 intermediates ([B, N, 3F] and more) at B 128 would take tens of GB
LARGE_BATCH = {(36864, 64): 32}
LARGE = ("attn_ctx_large", "attn_out_large", "attn_bwd_a", "attn_bwd_b")
LARGE_OUTPUTS = {"attn_ctx_large": ("kmax", "a", "s"), "attn_out_large": ("y",),
                 "attn_bwd_a": ("do", "d_ctx", "d_wout", "d_bout", "d_gout"),
                 "attn_bwd_b": ("dx", "d_wqkv", "d_gpre")}
LARGE_REPLACES = {"attn_ctx_large": "ccdm_tpu/ops/attn_block.py:146",
                  "attn_out_large": "ccdm_tpu/ops/attn_block.py:198",
                  "attn_bwd_a": "ccdm_tpu/ops/attn_block.py:360",
                  "attn_bwd_b": "ccdm_tpu/ops/attn_block.py:413"}
TRAIN_ARGV = ["--data_name", "synthetic", "--image_size", "64", "--model_channels", "64",
              "--channel_mult", "1_2_2_4_8", "--train_amp", "--pred_objective", "pred_x0",
              "--vicinity_type", "hv", "--train_batch_size", str(TRAIN_BATCH),
              "--train_lr", "1e-4", "--niters", str(TRAIN_STEPS),
              "--save_every", str(TRAIN_STEPS), "--log_every", "5", "--seed", "0",
              # the sampling main.py runs after training: 2 eval labels x 4
              # images in one batch each, 10 DDIM steps
              "--eval_mode", "4", "--FID_num_centers", "2", "--nfake_per_label", "4",
              "--sample_timesteps", "10"]
EVAL_FORWARDS = 2 * 10  # UNet forwards of that sampling


def large_bound_parts(name: str, n: int, c: int, batch: int = TRAIN_BATCH,
                      itemsize: int = 2) -> tuple[float, float]:
    """Least times (ms) of one call of kernel `name`: each input read and
    each output written once (activations, matrices and ctx in the
    activation type; do, the residuals, vectors and weight grads in f32),
    over HBM bandwidth; its products' operations over the bf16 peak."""
    f, d = F, DIM_HEAD
    act, act32 = batch * n * c * itemsize, batch * n * c * 4
    cxd, cx32, sf = batch * f * d * itemsize, batch * f * d * 4, batch * f * 4
    wq, wkv, wout, vec = c * f * itemsize, 2 * c * f * itemsize, f * c * itemsize, c * 4
    nbytes = {"attn_ctx_large": act + wkv + vec + cx32 + 2 * sf,
              "attn_out_large": 2 * act + cxd + wq + wout + 3 * vec,
              "attn_bwd_a": 2 * act + cxd + wq + wout + 3 * vec + act32 + cx32 + f * c * 4
              + 2 * vec,
              "attn_bwd_b": 3 * act + act32 + cxd + wq + wkv + wout + vec + cx32 + 2 * sf
              + 3 * c * f * 4 + vec}[name]
    return nbytes / HBM_BYTES_PER_S * 1e3, large_flops(name, n, c, batch) / BF16_FLOPS * 1e3


def large_flops(name: str, n: int, c: int, batch: int = TRAIN_BATCH) -> float:
    """Operations of the products of one call of kernel `name` (2 per
    multiply-add)."""
    f, d = F, DIM_HEAD
    per_token = {"attn_ctx_large": 2 * c * f + f * d, "attn_out_large": 2 * c * f + f * d,
                 "attn_bwd_a": 4 * c * f + 2 * f * d,
                 "attn_bwd_b": 10 * c * f + 3 * f * d}[name]
    return 2 * batch * n * per_token


def kmax_check(kmax, rkmax, x, g_pre, wqkv, what: str) -> tuple[float, int]:
    """#2's kmax in bf16 against ctx_large_reference's (rkmax), at every
    shape: within 1e-5 of the largest |kmax|, except where the two round one
    element of xn = bf16(x / rms(x) g_pre) to different neighbours: their
    f32 sums of squares differ in order, so 1 / rms can differ in its last
    bit, and a token at the column's max then moves k by up to one bf16 step
    of that element times its weight. Such a column must lie within that
    step (the largest over the batch row's tokens and channels) and be at
    most one in a thousand. (The kernel's own rounding points are held to
    1e-5 everywhere by ctx_large_tensor_reference.) Returns the max abs
    error and the count of those columns."""
    atol = 1e-5 * float(rkmax.abs().max())
    diff = (kmax.float() - rkmax.float()).abs()
    if not bool(torch.isfinite(kmax).all()):
        raise AssertionError(f"{what}: non-finite output")
    bad = diff > atol + 1e-5 * rkmax.abs()
    if bool(bad.any()):
        _, _, xn = attn_block._prenorm(x, g_pre)
        xn = xn.bfloat16().float().abs()
        step = torch.where(xn > 0, torch.exp2(torch.floor(torch.log2(xn)) - 7),
                           torch.zeros_like(xn)).amax(1)  # [B, C]: the largest bf16 step
        wk = wqkv[:, F:2 * F].float().abs()
        flip = (step[:, :, None] * wk[None]).amax(1)  # [B, F]: one element's step times its weight
        beyond = bad & (diff > atol + flip)
        if bool(beyond.any()) or int(bad.sum()) > max(1, bad.numel() // 1000):
            raise AssertionError(f"{what}: {int(bad.sum())} of {bad.numel()} beyond 1e-5 "
                                 f"({int(beyond.sum())} beyond one bf16 step of xn); max abs "
                                 f"err {diff.max().item():.3e}")
    return diff.max().item(), int(bad.sum())


def _check_grad(got, want, dtype, what) -> float:
    """The backward bounds of tests/test_attn_block.py:301-308: f32 rtol =
    atol = 2e-3; bf16 rtol 1e-1, atol 0.02 max(|g|, 1)."""
    if dtype == torch.float32:
        return check_close(got, want, 2e-3, 2e-3, what)
    return check_close(got, want, 1e-1, 0.02 * max(float(want.float().abs().max()), 1.0), what)


def large_vs_plain(device) -> dict:
    """Kernels #2-#5 against their plain versions at LARGE_SHAPES, bf16 and
    f32 (TF32 off), timed in bf16 (event and host time, TFLOP/s and share of
    the bound; each kernel's route, asserted the tensor cores, tile and
    splits from its plan); #2's bf16 kmax against the plain version at the
    route's rounding points and against ctx_large_reference (kmax_check);
    #4 + #5 in f32 also
    against autograd through attn_block_reference; #5 in bf16 nearer its
    plain version than one with d_a rounded to bf16 (check_rounding)."""
    rows = {}
    for i, (n, c) in enumerate(LARGE_SHAPES):
        batch = LARGE_BATCH.get((n, c), TRAIN_BATCH)
        for dt in (torch.bfloat16, torch.float32):
            x, w = block_inputs(n, c, batch, device, seed=20 + i, x_std=1.0)
            g = torch.Generator().manual_seed(40 + i)
            x = x.to(dt)
            dy = torch.randn(batch, n, c, generator=g).to(device).to(dt)
            g_pre, wqkv, wout, bout, g_out = w
            tag = f"N={n} C={c} {str(dt)[6:]}"
            err = {}
            a, s, kmax = attn_block.attn_ctx_large(x, g_pre, wqkv, HEADS)
            ra, rs, rkmax = attn_block.ctx_large_reference(x, g_pre, wqkv, HEADS)
            fwd = (2e-3, 2e-4) if dt == torch.float32 else (3e-2, 3e-2)
            if dt == torch.bfloat16:
                # the plain version at the tensor route's rounding points (its
                # xn as warp_norm16 forms it), then ctx_large_reference
                own = attn_block.ctx_large_tensor_reference(x, g_pre, wqkv, HEADS)[2]
                err["kmax"] = check_close(kmax, own, 1e-5, 1e-5 * float(own.abs().max()),
                                          f"#2 kmax {tag}")
                del own
                err["kmax_plain"], row_flips = kmax_check(kmax, rkmax, x, g_pre, wqkv,
                                                          f"#2 kmax against the plain #2 {tag}")
            else:
                err["kmax"] = check_close(kmax, rkmax, 1e-5, 1e-5 * float(rkmax.abs().max()),
                                          f"#2 kmax {tag}")
            err["a"] = check_close(a, ra, fwd[0], fwd[1] * float(ra.abs().max()), f"#2 a {tag}")
            err["s"] = check_close(s, rs, fwd[0], fwd[1] * float(rs.abs().max()), f"#2 s {tag}")
            ctx = attn_block.finalize_ctx(ra, rs, dt)
            out_args = (x, g_pre, wqkv, ctx, wout, bout, g_out, HEADS)
            want = attn_block.out_large_reference(*out_args)
            scale = None if dt == torch.float32 else torch.maximum(
                want.float().abs(), (want.float() - x.float()).abs())
            err["y"] = check_close(attn_block.attn_out_large(*out_args), want, *fwd,
                                   f"#3 y {tag}", scale=scale)
            bwd_a_args = (x, dy, g_pre, wqkv, ctx, wout, bout, g_out, HEADS)
            want_a = attn_block.bwd_a_reference(*bwd_a_args)
            for name, gv, wv in zip(("do", "d_ctx", "d_wout", "d_bout", "d_gout"),
                                    attn_block.attn_bwd_a(*bwd_a_args), want_a):
                err[name] = _check_grad(gv, wv, dt, f"#4 {name} {tag}")
            d_a, d_s = attn_block.finalize_ctx_backward(want_a[1], ra, rs)
            bwd_b_args = (x, dy, want_a[0], g_pre, wqkv, ctx, wout, rkmax, d_a, d_s, HEADS)
            got_b = attn_block.attn_bwd_b(*bwd_b_args)
            want_b = attn_block.bwd_b_reference(*bwd_b_args)
            for name, gv, wv in zip(("dx", "d_wqkv", "d_gpre"), got_b, want_b):
                err[name] = _check_grad(gv, wv, dt, f"#5 {name} {tag}")
            row = {"batch": batch, "max_err": err}
            if dt == torch.bfloat16:
                row["kmax_rounding_flips"] = row_flips
            if dt == torch.float32:
                row["autograd_max_err"] = autograd_vs_reference(x, dy, w)
            else:
                # d_a stays f32 in d_e and d_v: rounded to bf16 it moves every output
                other = attn_block.bwd_b_reference(*bwd_b_args[:8], d_a.bfloat16().float(),
                                                   *bwd_b_args[9:])
                row["d_a_rounding_ratio"] = {
                    name: check_rounding(gv, wv, ov, f"#5 {name} {tag}: d_a's precision")
                    for name, gv, wv, ov in zip(("dx", "d_wqkv", "d_gpre"), got_b, want_b, other)}
                del other
                reps = 5 if n * batch > 4096 * TRAIN_BATCH else 20
                calls = {"attn_ctx_large": ((lambda: attn_block.attn_ctx_large(x, g_pre, wqkv, HEADS)),
                                            (lambda: attn_block.ctx_large_reference(x, g_pre, wqkv, HEADS))),
                         "attn_out_large": ((lambda: attn_block.attn_out_large(*out_args)),
                                            (lambda: attn_block.out_large_reference(*out_args))),
                         "attn_bwd_a": ((lambda: attn_block.attn_bwd_a(*bwd_a_args)),
                                        (lambda: attn_block.bwd_a_reference(*bwd_a_args))),
                         "attn_bwd_b": ((lambda: attn_block.attn_bwd_b(*bwd_b_args)),
                                        (lambda: attn_block.bwd_b_reference(*bwd_b_args)))}
                for name, (kernel, plain) in calls.items():
                    parts = large_bound_parts(name, n, c, batch)
                    t = timing(kernel, plain, parts, reps=reps)
                    t["tflops"] = large_flops(name, n, c, batch) / t["ms"] / 1e9
                    t["share_of_bound"] = t["bound_ms"] / t["ms"]
                    pl = attn_block.large_plan(2 + LARGE.index(name), batch, n, c, HEADS, dt)
                    if pl.route != "tensor":
                        raise AssertionError(f"{name} {tag} took the {pl.route} route")
                    t.update(route=pl.route, tile=pl.tile, splits=pl.splits)
                    if name == "attn_bwd_b":
                        t["wgrad_splits"] = pl.wgrad_splits
                    row[name] = t
            rows[tag] = row
            print(f"   {tag} B={batch}: {json.dumps(row)}", flush=True)
            del x, w, dy, a, s, kmax, ra, rs, rkmax, ctx, want, want_a, d_a, d_s, got_b, want_b
            torch.cuda.empty_cache()
    return rows


def autograd_vs_reference(x, dy, w) -> float:
    """#4 + #5 through the autograd Function against autograd through the
    plain composition, all six gradients, f32 (bound 2e-3)."""
    fused = [t.detach().clone().requires_grad_() for t in (x, *w)]
    plain = [t.detach().clone().requires_grad_() for t in (x, *w)]
    y = attn_block.fused_attn_block(*fused, HEADS, DIM_HEAD)
    if type(y.grad_fn).__name__ != "_TwoPassBlockBackward":
        raise AssertionError(f"the training route took {type(y.grad_fn).__name__}")
    y.backward(dy)
    attn_block.attn_block_reference(*plain, HEADS, DIM_HEAD).backward(dy)
    return max(_check_grad(t.grad, r.grad, torch.float32, f"autograd {name}")
               for name, t, r in zip(("dx", "d_gpre", "d_wqkv", "d_wout", "d_bout", "d_gout"),
                                     fused, plain))


@torch.no_grad()
def two_pass_vs_single_pass(device) -> dict:
    """Sampling-time forward (B 64, bf16): #2 + #3 against #1."""
    out = {}
    for n in (4096, 16384):
        x, w = block_inputs(n, 64, BATCH, device, seed=60, x_std=1.0)
        xb, (g_pre, wqkv, wout, bout, g_out) = x.bfloat16(), w

        def two_pass():
            a, s, _ = attn_block.attn_ctx_large(xb, g_pre, wqkv, HEADS)
            return attn_block.attn_out_large(xb, g_pre, wqkv, attn_block.finalize_ctx(
                a, s, xb.dtype), wout, bout, g_out, HEADS)

        err = check_close(two_pass(), attn_block._launch(xb, *w, HEADS, DIM_HEAD), 3e-2, 3e-2,
                          f"#2+#3 against #1 N={n}")
        out[f"N{n}"] = {"two_pass_ms": time_ms(two_pass),
                        "single_pass_ms": time_ms(lambda: attn_block._launch(xb, *w, HEADS,
                                                                            DIM_HEAD)),
                        "max_abs_diff": err}
        print(f"   N={n} B={BATCH} bf16: {json.dumps(out[f'N{n}'])}", flush=True)
    return out


# --attn_dim_head 64: heads and dim_head (F 128, as at 4 x 32) and (B, N, C)
# of its check, N % 2048 == 0 so that training takes the two-pass kernels
OTHER_DIM_HEAD = (2, 64)
OTHER_DIM_HEAD_SHAPE = (8, 4096, 64)


def dim_head_vs_plain(device) -> dict:
    """The block at dim_head 64 through its kernels, bf16 and f32 (TF32
    off): every kernel's plan takes the CUDA cores (asserted); without a
    gradient one launch of #1, with one #2 + #3 and then #4 + #5, one launch
    each (counted); y against the plain block in f32 at phase 3's bounds,
    the six gradients against autograd through it at phase 6's. In bf16
    timed: the forward without a gradient (#1's CUDA-core route) and one
    forward + backward (#2-#5's), each against the plain block."""
    heads, dim_head = OTHER_DIM_HEAD
    b, n, c = OTHER_DIM_HEAD_SHAPE
    f = heads * dim_head
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        tag = f"B={b} N={n} C={c} heads={heads} dim_head={dim_head} {str(dt)[6:]}"
        routes = [attn_block.plan(b, n, c, heads, dt, dim_head).route] + [
            attn_block.large_plan(k, b, n, c, heads, dt, dim_head).route for k in (2, 3, 4, 5)]
        if routes != ["cores"] * 5:
            raise AssertionError(f"{tag}: routes {routes}")
        x, w = block_inputs(n, c, b, device, seed=70, x_std=1.0)
        if w[1].shape[1] != 3 * f:
            raise AssertionError("OTHER_DIM_HEAD must keep F at HEADS x DIM_HEAD")
        x = x.to(dt)
        dy = torch.randn(b, n, c, generator=torch.Generator().manual_seed(71)).to(device)
        counters = (attn_block.fused_attn_block, *(getattr(attn_block, k) for k in LARGE))
        before = [fn.launches for fn in counters]
        with torch.no_grad():
            y0 = attn_block.fused_attn_block(x, *w, heads, dim_head)
        leaves = [t.clone().requires_grad_() for t in (x, *w)]
        y = attn_block.fused_attn_block(*leaves, heads, dim_head)
        y.backward(dy.to(dt))
        torch.cuda.synchronize()
        launches = [fn.launches - n0 for fn, n0 in zip(counters, before)]
        if launches != [1, 1, 1, 1, 1]:
            raise AssertionError(f"{tag}: launches of #1-#5 {launches}, not one each")
        plain = [t.detach().float().requires_grad_() for t in (x, *w)]
        want = attn_block.attn_block_reference(*plain, heads, dim_head)
        want.backward(dy)
        fwd = (2e-3, 2e-4) if dt == torch.float32 else (3e-2, 3e-2)
        scale = None if dt == torch.float32 else torch.maximum(
            want.detach().abs(), (want.detach() - x.float()).abs())
        err = {"y_no_grad": check_close(y0, want.detach(), *fwd, f"#1 y {tag}", scale=scale),
               "y": check_close(y.detach(), want.detach(), *fwd, f"#2 + #3 y {tag}",
                                scale=scale)}
        for name, got, ref in zip(("dx", "d_gpre", "d_wqkv", "d_wout", "d_bout", "d_gout"),
                                  leaves, plain):
            err[name] = _check_grad(got.grad, ref.grad, dt, f"#4 + #5 {name} {tag}")
        out[tag] = {"routes": routes, "launches": launches, "max_err": err}
        if dt == torch.bfloat16:
            def step(block):
                y = block(*leaves, heads, dim_head)
                y.backward(dy.to(dt))
            with torch.no_grad():
                out[tag]["forward_ms"] = time_ms(lambda: attn_block.fused_attn_block(
                    x, *w, heads, dim_head))
                out[tag]["forward_plain_ms"] = time_ms(lambda: attn_block.attn_block_reference(
                    x, *w, heads, dim_head))
            out[tag]["train_ms"] = time_ms(lambda: step(attn_block.fused_attn_block))
            out[tag]["train_plain_ms"] = time_ms(lambda: step(attn_block.attn_block_reference))
        print(f"   {tag}: {json.dumps(out[tag])}", flush=True)
        del x, w, dy, y0, y, leaves, plain, want
        torch.cuda.empty_cache()
    return out


BN_FED_BIASES = ("cond_dense_1.bias", "cond_dense_2.bias")


def grad_parity(device) -> dict:
    """One loss + backward of the full-width f32 UNet (TF32 off), with the
    kernels and with plain attention, on the same batch and draws. Every
    gradient leaf within 1e-3 of its largest |g|; the two biases that feed
    a train-mode BatchNorm have zero gradient in exact arithmetic (rounding
    noise on both sides) and are held to 1e-3 of the model's largest |g|."""
    model = Unet(**UNET, dtype=torch.float32, seed=0).to(device, memory_format=torch.channels_last)
    diffusion = GaussianDiffusion(model, DiffusionConfig(
        image_size=64, channels=3, timesteps=1000, objective="pred_x0", vicinity_type="hv"),
        device=device)
    g = torch.Generator().manual_seed(3)
    b = 8
    images01 = torch.rand(b, 64, 64, 3, generator=g).to(device)
    labels = torch.rand(b, 1, generator=g).to(device)
    draws = {"t": torch.randint(0, 1000, (b,), generator=g), "keep_mask": torch.rand(b, generator=g) < 0.9,
             "noise": torch.randn(b, 64, 64, 3, generator=g)}
    emb = make_fn_y2h(128)(labels)

    def loss_and_grads():
        model.zero_grad(set_to_none=True)
        loss = diffusion.loss(images01, labels, emb, vicinal_weights=torch.ones(b, device=device),
                              kappa=0.05, draws=draws)
        loss.backward()
        return float(loss.detach()), {n: p.grad.detach().clone() for n, p in model.named_parameters()}

    launches = attn_block.attn_ctx_large.launches
    loss_k, grads_k = loss_and_grads()
    if attn_block.attn_ctx_large.launches - launches != 2:
        raise AssertionError("the f32 training step did not take the two-pass kernels")
    with plain_attention():
        loss_p, grads_p = loss_and_grads()
    largest = max(float(v.abs().max()) for v in grads_p.values())
    worst = 0.0
    for name, want in grads_p.items():
        scale = largest if name in BN_FED_BIASES else float(want.abs().max())
        diff = float((grads_k[name] - want).abs().max())
        if not diff <= 1e-3 * scale:
            raise AssertionError(f"grad {name}: max abs diff {diff:.3e} beyond 1e-3 x {scale:.3e}")
        worst = max(worst, diff / max(scale, 1e-30))
    print(f"   loss {loss_k:.6f} (plain {loss_p:.6f}); worst gradient leaf {worst:.3e} of its "
          f"largest |g|", flush=True)
    if abs(loss_k - loss_p) > 1e-5 * abs(loss_p):
        raise AssertionError(f"loss {loss_k} against plain {loss_p}")
    return {"loss": loss_k, "loss_plain": loss_p, "worst_leaf_rel_diff": worst}


RESNET = ("resnet_half_a", "resnet_half_b")


def _counters() -> dict:
    """Every kernel wrapper by its name in the kernels line."""
    return {"attn_block": attn_block.fused_attn_block,
            **{name: getattr(attn_block, name) for name in LARGE},
            **{name: getattr(resnet_block, name) for name in RESNET},
            **{name: getattr(la, name) for name in LA}, "bias_act_fused": so.bias_act_fused}


def _counts() -> dict:
    return {name: fn.launches for name, fn in _counters().items()}


def _reset_counts() -> None:
    for fn in _counters().values():
        fn.launches = 0


def train_main_path(device, card: str, argv_tail: list, steps: int, expected: dict,
                    fused: bool, checks) -> dict:
    """Phases 8 and 12: `python -m ccdm_tpu_torch.main` with `argv_tail` and
    the resnet switch `fused`, in build/smoke_run[_fused] (deleted after).
    The launch counts must be exactly `expected`, every loss finite and the
    last logged step `steps`; `checks(trainer, argv, log)` runs the phase's
    own checks and returns its entries of the result."""
    from ccdm_tpu_torch import main as port_main

    run = Path(__file__).resolve().parent / "build" / ("smoke_run_fused" if fused else "smoke_run")
    shutil.rmtree(run, ignore_errors=True)
    argv = ["--root_path", str(run), "--device", str(device), *argv_tail]
    try:
        with fused_resnet(fused):
            _reset_counts()
            trainer = port_main.main(argv)
            torch.cuda.synchronize()
            counts = _counts()
        log = [json.loads(line) for line in
               open(Path(port_main.results_folder(parse_opts(argv))) / "train_log.jsonl")]
        print(f"   {steps} steps of batch {TRAIN_BATCH}: losses "
              f"{[round(r['loss'], 4) for r in log]}; launches {counts} (expected {expected})",
              flush=True)
        if not all(np.isfinite(r["loss"]) for r in log) or log[-1]["step"] != steps:
            raise AssertionError(f"training log {log}")
        if counts != expected:
            raise AssertionError(f"kernel launches {counts}, expected {expected}")
        return {"launches": counts, "steps": steps, "losses": [r["loss"] for r in log],
                **checks(trainer, argv, log)}
    finally:
        shutil.rmtree(run, ignore_errors=True)


def train_checks(card: str):
    """Phase 8's own checks: the parameters moved, the EMA took every step,
    the warm images/s; then a short request served from the milestone."""
    initial = Unet(**UNET, dtype=torch.bfloat16, seed=0).state_dict()

    def checks(trainer, argv, log) -> dict:
        state = trainer.state
        moved = max(float((p.detach().cpu() - initial[name]).abs().max())
                    for name, p in state.model.named_parameters())
        warm = [r["imgs_per_sec"] for r in log if r["step"] > TRAIN_STEPS // 3]
        ips = sum(warm) / len(warm)
        print(f"   params moved by up to {moved:.3e}; ema_step {state.ema_step}; warm train "
              f"{ips:.2f} images/s (steps {TRAIN_STEPS // 3 + 1}-{TRAIN_STEPS}, batch "
              f"{TRAIN_BATCH}, bf16) on {card}", flush=True)
        if not moved > 0 or state.step != TRAIN_STEPS or state.ema_step != TRAIN_STEPS:
            raise AssertionError(f"params moved {moved}, step {state.step}, "
                                 f"ema_step {state.ema_step}")
        args = parse_opts([*argv, "--serve_milestone", str(TRAIN_STEPS),
                           "--sample_timesteps", "25", "--sample_cond_scale", "1.5"])
        service = SamplerService(args, max_batch=4, warm=False, device=args.device)
        images = service.generate(np.linspace(0.1, 0.9, 4).astype(np.float32))
        if images.dtype != np.uint8 or images.shape != (4, 64, 64, 3) or images.std() == 0:
            raise AssertionError(f"serving milestone {TRAIN_STEPS} gave {images.dtype} "
                                 f"{images.shape}, std {images.std()}")
        print(f"   served 4 labels x 25 DDIM steps from milestone {TRAIN_STEPS}: uint8 "
              f"{images.shape}, std {images.std():.2f}", flush=True)
        return {"train_images_per_s": ips}

    return checks


# ------------------------------------------- the fused resnet block slice

# (H = W, Cin, Cout) of the 23 resnet blocks of one RC-49 64x64 UNet forward
# (dim 64, mults 1_2_2_4_8), with the blocks that share each shape
RESNET_SHAPES = {(64, 64, 64): 2, (64, 128, 64): 3, (32, 64, 64): 2, (32, 192, 128): 2,
                 (16, 128, 128): 2, (16, 256, 128): 2, (8, 128, 128): 2, (8, 384, 256): 2,
                 (4, 256, 256): 2, (4, 512, 512): 2, (4, 768, 512): 2}
RESNET_BLOCKS = sum(RESNET_SHAPES.values())  # 23: launches of #10 and of #11 per forward
ATTN_BLOCKS = 10  # launches of #1 per sampling forward (FORWARD_SHAPES)
RESNET_REPLACES = {"resnet_half_a": "ccdm_tpu/ops/resnet_block.py:106",
                   "resnet_half_b": "ccdm_tpu/ops/resnet_block.py:130"}
# the batches the main paths give #1, #10 and #11: a CFG forward of 32 served
# labels; a training step; the EMA grid's CFG forward of 36 labels; the
# eval sampling's and the ddpm request's CFG forward of 4 labels
RESNET_BATCHES = (BATCH, TRAIN_BATCH, 2 * 36, 2 * 4)
FUSED_STEPS = 25   # DDIM steps of the switch-on serving phase
DDPM_STEPS = 10
FUSED_TRAIN_STEPS = 5
FUSED_TRAIN_ARGV = [*TRAIN_ARGV, "--niters", str(FUSED_TRAIN_STEPS), "--save_every",
                    str(FUSED_TRAIN_STEPS), "--sample_every", str(FUSED_TRAIN_STEPS),
                    "--log_every", "1"]
# UNet forwards of that run: one per step, the 10 DDIM steps of the EMA grid
# (36 images in one batch), then EVAL_FORWARDS
FUSED_TRAIN_FORWARDS = FUSED_TRAIN_STEPS + 10 + EVAL_FORWARDS


@contextlib.contextmanager
def fused_resnet(on: bool):
    """Set CCDM_TPU_FUSED_RESBLOCK's module switch for the block."""
    before = resnet_block.USE_FUSED
    resnet_block.USE_FUSED = on
    try:
        yield
    finally:
        resnet_block.USE_FUSED = before


def resnet_bound_parts(name: str, hw: int, cin: int, cout: int, batch: int,
                       itemsize: int = 2) -> tuple[float, float]:
    """Least times (ms) of one call of kernel `name`: each input read and each
    output written once (activations and matrices in the activation type,
    scale/shift and the vectors in f32), over HBM bandwidth; its products'
    operations over the bf16 peak."""
    act = lambda c: batch * hw * c * itemsize
    has_res = cin != cout
    if name == "resnet_half_a":
        nbytes = act(cin) + act(cout) + 9 * cin * cout * itemsize + 2 * batch * cout * 4 \
            + 2 * cout * 4
        flops = 2 * batch * hw * 9 * cin * cout
    else:
        nbytes = 2 * act(cout) + act(cin) + 9 * cout * cout * itemsize + 2 * cout * 4 \
            + (cin * cout * itemsize + cout * 4 if has_res else 0)
        flops = 2 * batch * hw * (9 * cout * cout + (cin * cout if has_res else 0))
    return nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3


def resnet_inputs(hh: int, cin: int, cout: int, batch: int, device, seed: int):
    """Kernel inputs in the JAX layout, f32: x ~ N(0, 1) [B, HW, Cin]; conv
    weights tap-major at 1/sqrt(fan-in); gains 1 + N(0, 0.5); FiLM N(0, 0.3)."""
    g = torch.Generator().manual_seed(seed)
    n = lambda *shape, s=1.0: torch.randn(*shape, generator=g) * s
    has_res = cin != cout
    t = {"x": n(batch, hh * hh, cin), "scale": n(batch, cout, s=0.3),
         "shift": n(batch, cout, s=0.3), "w1": n(9 * cin, cout, s=(9 * cin) ** -0.5),
         "b1": n(cout, s=0.1), "g1": 1 + n(cout, s=0.5),
         "w2": n(9 * cout, cout, s=(9 * cout) ** -0.5), "b2": n(cout, s=0.1),
         "g2": 1 + n(cout, s=0.5), "wres": n(cin, cout, s=cin ** -0.5) if has_res else None,
         "bres": n(cout, s=0.1) if has_res else None}
    return {k: None if v is None else v.to(device) for k, v in t.items()}


def _as_block(t: dict, hh: int, dt):
    """The same inputs as resnet_block_reference takes them: x NCHW
    (channels_last) in dt, OIHW kernels."""
    b, _, cin = t["x"].shape
    cout = t["b1"].shape[0]
    oihw = lambda w, ci: w.reshape(3, 3, ci, cout).permute(3, 2, 0, 1).contiguous()
    return (t["x"].to(dt).view(b, hh, hh, cin).permute(0, 3, 1, 2), t["scale"], t["shift"],
            oihw(t["w1"], cin), t["b1"], t["g1"], oihw(t["w2"], cout), t["b2"], t["g2"],
            None if t["wres"] is None else t["wres"].t().reshape(cout, cin, 1, 1), t["bres"])


def resnet_yardsticks(t: dict, hh: int, dt) -> dict:
    """Per half, (its composition in resnet_block_reference, its bare convs)
    as callables on the same inputs in NCHW channels_last: cuDNN convs plus
    the eager norm, FiLM, SiLU and residual; and the products alone."""
    x, scale, shift, w1, b1, g1, w2, b2, g2, wres, bres = _as_block(t, hh, dt)
    h = resnet_block.reference_half_a(x, scale, shift, w1, b1, g1)
    w1c, w2c = w1.to(dt), w2.to(dt)
    wresc = None if wres is None else wres.to(dt)
    conv = torch.nn.functional.conv2d
    return {"resnet_half_a": (
                lambda: resnet_block.reference_half_a(x, scale, shift, w1, b1, g1),
                lambda: conv(x, w1c, padding=1)),
            "resnet_half_b": (
                lambda: resnet_block.reference_half_b(h, x, w2, b2, g2, wres, bres),
                (lambda: conv(h, w2c, padding=1)) if wresc is None else
                (lambda: (conv(h, w2c, padding=1), conv(x, wresc))))}


@torch.no_grad()
def resnet_vs_plain(device) -> dict:
    """Phase 9: #10 and #11 against their plain versions per shape, f32 and
    bf16, at every batch the main paths give them (RESNET_BATCHES); bf16
    times at B 64 (and B 128 at 64x64) beside the plain versions, each
    half's composition (library_ms), its bare cuDNN convs (cudnn_conv_ms)
    and the cuDNN composition of the whole block, with the route taken, the
    wrapper's host time, TFLOP/s and the share of the bound."""
    rows = {}
    cases = [(shape, batch) for batch in RESNET_BATCHES for shape in RESNET_SHAPES]
    for i, ((hh, cin, cout), batch) in enumerate(cases):
        timed = batch == BATCH or (batch == TRAIN_BATCH and hh == 64)
        t = resnet_inputs(hh, cin, cout, batch, device, seed=80 + i)
        row = {"max_err": {}, "plan": {
            name: resnet_block.plan(name[-1], batch, hh, hh, cin, cout, cin != cout,
                                    torch.bfloat16)._asdict() for name in RESNET}}
        for dt in (torch.float32, torch.bfloat16):
            tol = (2e-3, 2e-4) if dt == torch.float32 else (4e-2, 4e-2)
            tag = f"H={hh} Cin={cin} Cout={cout} B={batch} {str(dt)[6:]}"
            x = t["x"].to(dt)
            w1, w2 = t["w1"].to(dt), t["w2"].to(dt)
            wres = None if t["wres"] is None else t["wres"].to(dt)
            a_args = (x, t["scale"], t["shift"], w1, t["b1"], t["g1"], hh, hh)
            h1 = resnet_block.resnet_half_a(*a_args)
            b_args = (h1, x, w2, t["b2"], t["g2"], wres, t["bres"], hh, hh)
            key = str(dt)[6:]
            row["max_err"][f"h1_{key}"] = check_close(
                h1, resnet_block.half_a_reference(*a_args), *tol, f"#10 {tag}")
            row["max_err"][f"y_{key}"] = check_close(
                resnet_block.resnet_half_b(*b_args), resnet_block.half_b_reference(*b_args),
                *tol, f"#11 {tag}")
            if dt == torch.bfloat16 and timed:
                yard = resnet_yardsticks(t, hh, dt)
                calls = {"resnet_half_a": (lambda: resnet_block.resnet_half_a(*a_args),
                                           lambda: resnet_block.half_a_reference(*a_args)),
                         "resnet_half_b": (lambda: resnet_block.resnet_half_b(*b_args),
                                           lambda: resnet_block.half_b_reference(*b_args))}
                for name, (kernel, plain) in calls.items():
                    parts = resnet_bound_parts(name, hh * hh, cin, cout, batch)
                    r = timing(kernel, plain, parts, library=yard[name][0])
                    r["cudnn_conv_ms"] = time_ms(yard[name][1])
                    r["tflops"] = parts[1] * BF16_FLOPS / r["ms"] / 1e12
                    r["bound_share"] = r["bound_ms"] / r["ms"]
                    row[name] = r
                block = _as_block(t, hh, dt)
                row["cudnn_block_ms"] = time_ms(
                    lambda: resnet_block.resnet_block_reference(*block))
        rows[f"H{hh}_Cin{cin}_Cout{cout}_B{batch}"] = row
        print(f"   H={hh:2d} Cin={cin:3d} Cout={cout:3d} B={batch}: {json.dumps(row)}",
              flush=True)
        del t, x, h1, a_args, b_args
        torch.cuda.empty_cache()
    print_resnet_levels(resnet_levels(rows))
    return rows


def resnet_levels(rows: dict) -> dict:
    """Per level (H = W) and half, over the blocks of one B-64 forward: the
    summed times, bound, TFLOP/s, share of the bound, host time and routes."""
    levels = {}
    for (hh, cin, cout), k in RESNET_SHAPES.items():
        r = rows[f"H{hh}_Cin{cin}_Cout{cout}_B{BATCH}"]
        for name in RESNET:
            lv = levels.setdefault(f"H{hh}", {}).setdefault(name, {
                "ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0, "cudnn_conv_ms": 0.0,
                "host_ms": 0.0, "tflop": 0.0, "routes": []})
            for key in ("ms", "bound_ms", "library_ms", "cudnn_conv_ms", "host_ms"):
                lv[key] += k * r[name][key]
            lv["tflop"] += k * r[name]["tflops"] * r[name]["ms"] * 1e-3
            pl = r["plan"][name]
            lv["routes"].append(f"{k}x Cin {cin} Cout {cout}: {pl['route']} "
                                f"{pl['tile'][0]}x{pl['tile'][1]} splits {pl['splits']}")
    for lv in levels.values():
        for r in lv.values():
            r["tflops"] = r["tflop"] / (r["ms"] * 1e-3)
            r["bound_share"] = r["bound_ms"] / r["ms"]
    return levels


def print_resnet_levels(levels: dict) -> None:
    for level, halves in levels.items():
        for name, r in halves.items():
            print(f"   {level} {name}: {r['ms']:.4f} ms ({r['tflops']:.1f} TFLOP/s, "
                  f"{100 * r['bound_share']:.1f}% of the bound {r['bound_ms']:.4f}); composition "
                  f"{r['library_ms']:.4f}, bare cuDNN convs {r['cudnn_conv_ms']:.4f}, host "
                  f"{r['host_ms']:.4f} ms; {'; '.join(r['routes'])}", flush=True)


def fused_model_parity(device) -> dict:
    """Phase 10: model_parity with the switch on against off; the six
    switch-on forwards launch each kernel 23 times."""
    _reset_counts()
    out = model_parity(device, lambda: fused_resnet(True), lambda: fused_resnet(False),
                       "switch on and off")
    counts = {k: _counts()[k] for k in RESNET}
    if counts != {k: 6 * RESNET_BLOCKS for k in RESNET}:
        raise AssertionError(f"six switch-on forwards launched {counts}, expected "
                             f"{RESNET_BLOCKS} of each kernel per forward")
    return out


def fused_serve_main_path(device, card: str) -> dict:
    """Phase 11: the serving main path with the switch on, then one request
    to an ancestral (--sampler ddpm) service."""
    argv = [*SERVE_ARGV, "--sample_timesteps", str(FUSED_STEPS)]
    with fused_resnet(True):
        _reset_counts()
        service = SamplerService(parse_opts(argv), max_batch=SERVE_BATCH, warm=True,
                                 device=str(device))
        batches, n_images, req_s = _serve_requests(service, ((40, 2),), 64)
        batches += 1  # the warm-up batch
        counts = _counts()
        expected = {"attn_block": ATTN_BLOCKS * FUSED_STEPS * batches,
                    "resnet_half_a": RESNET_BLOCKS * FUSED_STEPS * batches,
                    "resnet_half_b": RESNET_BLOCKS * FUSED_STEPS * batches,
                    **{k: 0 for k in NEW_KERNELS}}
        got = {k: counts[k] for k in expected}
        ips = n_images / req_s
        print(f"   {batches} batches of {SERVE_BATCH} x {FUSED_STEPS} DDIM steps, {n_images} "
              f"images in {req_s:.2f} s: {ips:.2f} images/s on {card}; launches {got} "
              f"(expected {expected})", flush=True)
        if got != expected:
            raise AssertionError(f"switch-on serving launched {got}, expected {expected}")
        forward_ms = cfg_forward_ms(service)
        print(f"   one CFG forward (B {BATCH}, bf16): {forward_ms:.4f} ms", flush=True)
        turns = cfg_forward_turns(service)
        print(f"   the same forward in turns: switch off {turns['off']['ms']:.4f} ms (host "
              f"{turns['off']['host_ms']:.4f}), on {turns['on']['ms']:.4f} ms (host "
              f"{turns['on']['host_ms']:.4f})", flush=True)

        ddpm = SamplerService(parse_opts([*argv, "--sampler", "ddpm", "--sample_timesteps",
                                          str(DDPM_STEPS)]),
                              max_batch=4, warm=False, device=str(device))
        ddpm_batches, _, ddpm_s = _serve_requests(ddpm, ((4, 3),), 64)
        print(f"   --sampler ddpm: 4 labels x {DDPM_STEPS} ancestral steps over HTTP in "
              f"{ddpm_s:.2f} s: uint8, not constant", flush=True)
    return {"launches": got, "batches": batches, "images_per_s": ips,
            "requested_images": n_images, "request_s": req_s, "ddpm_request_s": ddpm_s,
            "cfg_forward_ms": forward_ms, "cfg_forward_turns": turns}


def read_png(path: Path) -> np.ndarray:
    """The pixels of an 8-bit RGB PNG with one IDAT chunk and no filters, as
    utils/viz.py writes it (the card's machine has no PIL)."""
    data = path.read_bytes()
    w, h, depth, color = struct.unpack(">IIBB", data[16:26])
    if data[12:16] != b"IHDR" or depth != 8 or color != 2 or data[37:41] != b"IDAT":
        raise AssertionError(f"{path.name} is not the RGB PNG the port writes")
    size = struct.unpack(">I", data[33:37])[0]
    rows = np.frombuffer(zlib.decompress(data[41:41 + size]), np.uint8).reshape(h, 1 + 3 * w)
    return rows[:, 1:].reshape(h, w, 3)


def fused_train_checks(card: str):
    """Phase 12's own checks: the EMA grid and the eval labels' grids decode
    to images that are not constant."""
    from ccdm_tpu_torch import main as port_main

    def checks(trainer, argv, log) -> dict:
        args = parse_opts(argv)
        results = Path(port_main.results_folder(args))
        grids = [results / f"sample_{FUSED_TRAIN_STEPS}.png",
                 *sorted(Path(port_main.fake_data_folder(args, 2)).glob("sample_*.png"))]
        stds = [float(read_png(p).std()) for p in grids]
        print(f"   {log[-1]['imgs_per_sec']:.2f} train images/s at step {FUSED_TRAIN_STEPS} "
              f"on {card}; grids {[p.name for p in grids]} (pixel std "
              f"{[round(v, 2) for v in stds]})", flush=True)
        if len(log) != FUSED_TRAIN_STEPS or len(grids) != 3 or not all(v > 0 for v in stds):
            raise AssertionError(f"{len(log)} log lines, grids {grids}, pixel std {stds}")
        return {"forwards": FUSED_TRAIN_FORWARDS, "grid_std": stds,
                "train_images_per_s_last_step": log[-1]["imgs_per_sec"]}

    return checks


def resnet_kernel_rows(rows: dict, served: dict, trained: dict, parity: dict, card: str,
                       forward_off_ms: float):
    """The kernels-line entries of #10 and #11: times summed over the 23
    launches of one B-64 forward, and their share of that forward, timed
    whole with the switch off (phase 5) and on (phase 11)."""
    out = []
    fwd = [(rows[f"H{h}_Cin{ci}_Cout{co}_B{BATCH}"], k)
           for (h, ci, co), k in RESNET_SHAPES.items()]
    for name in RESNET:
        total = lambda key: sum(r[name][key] * k for r, k in fwd)
        by_bytes = sum(r[name]["bound_ms"] * k for r, k in fwd if r[name]["bound_by"] == "bytes")
        out.append({
            "name": name, "route": "cuda", "source": "ccdm_tpu_torch/csrc/resnet_block.cu",
            "replaces": RESNET_REPLACES[name], "launches": served["launches"][name],
            "max_abs_err": max(r["max_err"]["h1_bfloat16" if name == "resnet_half_a"
                                            else "y_bfloat16"] for r in rows.values()),
            "ms": total("ms"), "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
            "bound_by": "bytes" if 2 * by_bytes >= total("bound_ms") else "operations",
            "library_ms": total("library_ms"),
            "library_ms_is": "the half's composition in resnet_block_reference (cuDNN conv, "
                             "eager norm, FiLM or residual, SiLU), bf16, summed over the 23",
            "cudnn_conv_ms": total("cudnn_conv_ms"),
            "cudnn_conv_ms_is": "the half's bare F.conv2d (and #11's 1x1 projection), "
                                "channels_last, bf16, summed over the 23",
            "host_ms": total("host_ms"),
            "cudnn_block_ms": sum(r["cudnn_block_ms"] * k for r, k in fwd),
            "cudnn_block_ms_is": "the whole block (both halves) as resnet_block_reference "
                                 "in bf16 (cuDNN convs), summed over the 23 blocks",
            "ms_is": f"sum over the 23 launches of one UNet forward, B {BATCH}, bf16",
            "launches_in_training": trained["launches"][name],
            "max_err_f32": max(r["max_err"]["h1_float32" if name == "resnet_half_a"
                                            else "y_float32"] for r in rows.values()),
            "by_shape": {tag: {**r.get(name, {}), "max_err": r["max_err"]}
                         for tag, r in rows.items()},
            "card": card})
    cudnn = out[0]["cudnn_block_ms"]
    kernels = out[0]["ms"] + out[1]["ms"]
    turns = served["cfg_forward_turns"]
    out[0]["cfg_forward"] = {
        "switch_off_ms": forward_off_ms, "switch_on_ms": served["cfg_forward_ms"],
        "cudnn_blocks_share_of_switch_off": cudnn / forward_off_ms,
        "kernels_share_of_switch_on": kernels / served["cfg_forward_ms"],
        "in_turns_phase_11": turns}
    print(f"   one CFG forward (B {BATCH}, bf16): {forward_off_ms:.4f} ms with the switch off, "
          f"of which the 23 blocks' cuDNN composition (timed alone) {cudnn:.4f} ms "
          f"({100 * cudnn / forward_off_ms:.1f}%); {served['cfg_forward_ms']:.4f} ms with "
          f"the switch on, of which #10 + #11 (timed alone) {kernels:.4f} ms "
          f"({100 * kernels / served['cfg_forward_ms']:.1f}%); in turns in phase 11: off "
          f"{turns['off']['ms']:.4f} ms (host {turns['off']['host_ms']:.4f}), on "
          f"{turns['on']['ms']:.4f} ms (host {turns['on']['host_ms']:.4f})", flush=True)
    print(f"   #10 + #11 over the 23 blocks: {kernels:.4f} ms against the cuDNN composition "
          f"of the same blocks {cudnn:.4f} ms ({kernels / cudnn:.2f}x); per half: #10 "
          f"{out[0]['ms']:.4f} (composition {out[0]['library_ms']:.4f}, bare convs "
          f"{out[0]['cudnn_conv_ms']:.4f}), #11 {out[1]['ms']:.4f} (composition "
          f"{out[1]['library_ms']:.4f}, bare convs {out[1]['cudnn_conv_ms']:.4f})", flush=True)
    levels = resnet_levels(rows)
    print_resnet_levels(levels)
    out[0]["levels"] = levels
    out[0]["model_parity"] = parity
    out[0]["serve"] = served
    out[1]["train"] = trained
    out[0]["by_shape_cudnn_block_ms"] = {tag: r["cudnn_block_ms"] for tag, r in rows.items()
                                         if "cudnn_block_ms" in r}
    return out


# ------------------ standalone linear attention (#6-#9) and bias_act (#12)

LA = ("linear_attention_fulllane", "linear_attention_ctx_twopass",
      "linear_attention_out_twopass", "linear_attention_per_head")
LA_REPLACES = {"linear_attention_fulllane": "ccdm_tpu/ops/linear_attention.py:106",
               "linear_attention_ctx_twopass": "ccdm_tpu/ops/linear_attention.py:180",
               "linear_attention_out_twopass": "ccdm_tpu/ops/linear_attention.py:222",
               "linear_attention_per_head": "ccdm_tpu/ops/linear_attention.py:56"}
NEW_KERNELS = (*LA, "bias_act_fused")
F32_FLOPS = 67e12  # f32 outside the tensor cores, same data sheet
# (B, N, H, D) of #6 and #9: the UNet's attention levels, served (B 64) and
# trained (B 128), then the other head widths JAX's route takes, at N 1024
LA_SHAPES = ([(b, n, HEADS, DIM_HEAD) for b in (BATCH, TRAIN_BATCH)
              for n in sorted({n for n, _ in FORWARD_SHAPES}, reverse=True)]
             + [(BATCH, 1024, h, d) for h, d in ((2, 64), (8, 16), (1, 128))])
LA_MAIN = (BATCH, 4096, HEADS, DIM_HEAD)  # the shape of the kernels line
# (B, N, chunk) of #7 + #8: the 128x128 top level when sampling (the
# kernels line), the 64x64 level when training, the 192x192 top level, three
# chunks, chunks of 1024
TWOPASS_SHAPES = [(BATCH, 16384, 2048), (TRAIN_BATCH, 4096, 2048), (16, 36864, 2048),
                  (16, 6144, 2048), (16, 4096, 1024)]
# [rows, C] of #12: GAN feature maps at batch 64 (64x64x128, 32x32x256 for the
# kernels line, 8x8x512), then a row count off the kernel's 256-thread tile
BIAS_ACT_SHAPES = [(64 * 64 * 64, 128), (64 * 32 * 32, 256), (64 * 8 * 8, 512), (1003, 128)]
BIAS_ACT_MAIN = (64 * 32 * 32, 256)


def la_bound_parts(name: str, b: int, n: int, h: int, d: int,
                   itemsize: int = 2) -> tuple[float, float]:
    """Least times (ms) of one call of kernel `name`: each input read and each
    output written once over HBM bandwidth (q, k, v, out and ctx in the
    operand type; m, a and s in f32), and its per-head products (the H
    blocks of D x D, not the TPU kernels' F x F, la_flops) over the bf16
    peak, #9's over the f32 peak: it computes in f32."""
    act, f = b * n * h * d * itemsize, h * d
    nbytes = {"linear_attention_fulllane": 4 * act, "linear_attention_per_head": 4 * act,
              "linear_attention_ctx_twopass": 2 * act + 2 * b * f * 4 + b * f * d * 4,
              "linear_attention_out_twopass": 2 * act + b * f * d * itemsize}[name]
    rate = F32_FLOPS if name == "linear_attention_per_head" else BF16_FLOPS
    return nbytes / HBM_BYTES_PER_S * 1e3, la_flops(name, b, n, h, d) / rate * 1e3


def bias_act_bound_parts(rows: int, c: int, bias: bool, gain: bool,
                         itemsize: int = 2) -> tuple[float, float]:
    """Least times (ms) of one lrelu call of #12: x read and y written once
    (and the bias), over HBM bandwidth; its f32 operations (compare and
    multiply of lrelu, the bias add, the gain) over the f32 peak."""
    nbytes = (2 * rows * c + (c if bias else 0)) * itemsize
    return nbytes / HBM_BYTES_PER_S * 1e3, rows * c * (2 + bias + gain) / F32_FLOPS * 1e3


def la_flops(name: str, b: int, n: int, h: int, d: int) -> float:
    """The per-head products of one call of kernel `name` (la_bound_parts)."""
    products = 2 if name in ("linear_attention_fulllane", "linear_attention_per_head") else 1
    return 2 * products * b * n * h * d * d


def checked_plan(what: str, plan, shape, dt, fast: str) -> dict:
    """`plan` (of kernels `what` at q `shape` of `dt`) as a dict, its route
    asserted to be `fast` in bf16 at D % 16 == 0 and the CUDA cores
    otherwise."""
    want = fast if dt == torch.bfloat16 and shape[3] % 16 == 0 else "cores"
    if plan.route != want:
        raise AssertionError(f"{what} at {shape} {dt}: route {plan.route}, expected {want}")
    return plan._asdict()


def la_route(shape, dt) -> dict:
    """la_plan of #6 and #8: the tensor route in bf16 at D % 16 == 0."""
    return checked_plan("#6/#8", la.la_plan(*shape, dt), shape, dt, "tensor")


def per_head_route(shape, dt) -> dict:
    """per_head_plan of #9: the whole-row f32 route in bf16 at D % 16 == 0."""
    return checked_plan("#9", la.per_head_plan(*shape, dt), shape, dt, "rows")


def twopass_route(shape, chunk: int, dt) -> dict:
    """twopass_plan of #7: the tensor route in bf16 at D % 16 == 0."""
    return checked_plan("#7", la.twopass_plan(*shape, chunk, dt), shape, dt, "tensor")


def with_rates(row: dict, flops: float) -> dict:
    """timing()'s row with TFLOP/s and the share of the bound."""
    return {**row, "tflops": flops / (row["ms"] * 1e-3) / 1e12,
            "share_of_bound": row["bound_ms"] / row["ms"]}


def timing(kernel, plain, parts: tuple[float, float], reps: int = 20, library=None) -> dict:
    """The kernel's and its plain version's times (and a library call's),
    with the bound of `parts` (bytes, operations) and the wrapper's host time."""
    t_bytes, t_ops = parts
    row = {"ms": time_ms(kernel, reps=reps), "host_ms": host_ms(kernel, reps=reps),
           "plain_ms": time_ms(plain, reps=reps),
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    if library is not None:
        row["library_ms"] = time_ms(library, reps=reps)
    return row


def la_inputs(shape, dt, device, seed: int) -> list:
    """q, k, v ~ N(0, 2) in f32 and N(0, 1) in bf16 (the inputs of
    tests/test_linear_attention.py), drawn on the card."""
    g = torch.Generator(device).manual_seed(seed)
    std = 2.0 if dt == torch.float32 else 1.0
    return [(torch.randn(*shape, generator=g, device=device) * std).to(dt) for _ in range(3)]


def la_check(got: torch.Tensor, want: torch.Tensor, what: str, scale_atol: bool = True) -> float:
    """The bounds of tests/test_linear_attention.py: f32 (TF32 off) rtol
    2e-3, atol 1e-4; bf16 rtol 3e-2 and atol 3e-2 of max |want|. Outputs of
    N(0, 1) inputs lie near 1e-2, so a fixed bf16 atol of 3e-2 would pass a
    kernel that wrote zeros. With scale_atol (a and s of #7) the f32 atol
    is taken of max |want| too. Returns the max abs error."""
    rtol, atol = (2e-3, 1e-4) if want.dtype == torch.float32 else (3e-2, 3e-2)
    if want.dtype != torch.float32 or scale_atol:
        atol *= float(want.float().abs().max())
    return check_close(got, want, rtol, atol, what)


def check_rounding(got: torch.Tensor, own: torch.Tensor, other: torch.Tensor,
                   what: str) -> float:
    """In bf16 a kernel keeps its own rounding points: its mean abs difference
    to `own` (its plain version) is at most a quarter of that to `other`, the
    same function on the same inputs rounded at other points. The outputs'
    own rounding hides such a change from an elementwise bound. Returns the
    ratio of the two means."""
    near = float((got.float() - own.float()).abs().mean())
    far = float((got.float() - other.float()).abs().mean())
    if not near <= 0.25 * far:
        raise AssertionError(f"{what}: mean abs diff {near:.3e} to its plain version, "
                             f"{far:.3e} to the other rounding points; beyond a quarter")
    return near / far if far > 0 else 0.0


@torch.no_grad()
def la_vs_plain(device) -> dict:
    """Phase 13: #6 and #9 against their plain versions at LA_SHAPES, f32
    with TF32 off and bf16 (la_check), and in bf16 each nearer its own plain
    version than the other's, which rounds elsewhere (check_rounding); #6's
    and #9's routes asserted (la_route, per_head_route) and #6 timed in
    bf16 at every shape, #9 at B 64; each the same bits on two calls at
    LA_MAIN."""
    rows = {}
    for i, shape in enumerate(LA_SHAPES):
        b, n, h, d = shape
        row = {"max_err": {}, "plan": {}, "plan9": {}}
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = la_inputs(shape, dt, device, seed=100 + i)
            key, tag = str(dt)[6:], f"B={b} N={n} H={h} D={d} {str(dt)[6:]}"
            row["plan"][key] = la_route(shape, dt)
            row["plan9"][key] = per_head_route(shape, dt)
            calls = {"linear_attention_fulllane": (
                         lambda: la.linear_attention_fulllane(q, k, v),
                         lambda: la.fulllane_reference(q, k, v)),
                     "linear_attention_per_head": (
                         lambda: la.linear_attention_per_head(q, k, v),
                         lambda: la.linear_attention_reference(q, k, v))}
            # #6 rounds k', v, ctx and q'; #9 only its output: each is the
            # other's plain version rounded elsewhere
            others = {"linear_attention_fulllane": la.linear_attention_reference,
                      "linear_attention_per_head": la.fulllane_reference}
            for name, (kernel, plain) in calls.items():
                got, want = kernel(), plain()
                row["max_err"][f"{name}_{key}"] = la_check(got, want, f"{name} {tag}")
                if dt == torch.bfloat16:
                    row.setdefault("rounding", {})[name] = check_rounding(
                        got, want, others[name](q, k, v), f"{name} {tag}")
                if dt == torch.bfloat16 and (b == BATCH or name == "linear_attention_fulllane"):
                    row[name] = with_rates(timing(kernel, plain, la_bound_parts(name, *shape)),
                                           la_flops(name, *shape))
                if dt == torch.bfloat16 and shape == LA_MAIN:
                    if not torch.equal(kernel(), got):
                        raise AssertionError(f"{name} {tag}: two calls on the same inputs differ")
                    row.setdefault("same_bits_twice", {})[name] = True
        rows[f"B{b}_N{n}_H{h}_D{d}"] = row
        print(f"   B={b} N={n:5d} H={h} D={d:3d}: {json.dumps(row)}", flush=True)
    return rows


@torch.no_grad()
def twopass_vs_plain(device) -> dict:
    """Phase 14: #7 and #8 against their plain versions at TWOPASS_SHAPES, f32
    (TF32 off) and bf16 (la_check; a and s relative to their largest value),
    and in bf16 each nearer its plain version than a version rounded
    elsewhere (check_rounding); #7's and #8's routes asserted (twopass_route,
    la_route), each timed in bf16 at every shape and the same bits on two
    calls at the first, where the dispatcher's two-pass route is timed
    against the plain reference (and #9) on the same q, k, v."""
    rows = {}
    for i, (b, n, chunk) in enumerate(TWOPASS_SHAPES):
        shape = (b, n, HEADS, DIM_HEAD)
        row = {"max_err": {}, "plan": {}, "plan7": {}}
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = la_inputs(shape, dt, device, seed=150 + i)
            key, tag = str(dt)[6:], f"B={b} N={n} chunk={chunk} {str(dt)[6:]}"
            row["plan"][key] = la_route(shape, dt)
            row["plan7"][key] = twopass_route(shape, chunk, dt)
            m = k.amax(1).float().reshape(b, F)
            a, s = la.linear_attention_ctx_twopass(k, v, m, chunk)
            ra, rs = la.ctx_twopass_reference(k, v, m)
            row["max_err"][f"a_{key}"] = la_check(a, ra, f"#7 a {tag}")
            row["max_err"][f"s_{key}"] = la_check(s, rs, f"#7 s {tag}")
            ctx = la.finalize_ctx(ra, rs, dt)
            out, want = la.linear_attention_out_twopass(q, ctx), la.out_twopass_reference(q, ctx)
            row["max_err"][f"out_{key}"] = la_check(out, want, f"#8 {tag}", scale_atol=False)
            if dt == torch.bfloat16:
                # the other rounding points: #7's a from the unrounded exp(k - m)
                # and s from the rounded one; #8's q' in f32
                e = torch.exp(k.float() - m.view(b, 1, HEADS, DIM_HEAD))
                row["rounding"] = {
                    "a": check_rounding(a, ra, torch.einsum("bnhd,bnhe->bhde", e, v.float()),
                                        f"#7 a {tag}"),
                    "s": check_rounding(s, rs, e.bfloat16().float().sum(1).reshape(b, F),
                                        f"#7 s {tag}"),
                    "out": check_rounding(out, want, torch.einsum(
                        "bnhd,bhde->bnhe", la._q_prime(q, torch.float32), ctx.float()).to(dt),
                        f"#8 {tag}")}
                del e
            if dt == torch.bfloat16:
                name = "linear_attention_out_twopass"
                row[name] = with_rates(timing(
                    lambda: la.linear_attention_out_twopass(q, ctx),
                    lambda: la.out_twopass_reference(q, ctx),
                    la_bound_parts(name, *shape), reps=10), la_flops(name, *shape))
                name = "linear_attention_ctx_twopass"
                row[name] = with_rates(timing(
                    lambda: la.linear_attention_ctx_twopass(k, v, m, chunk),
                    lambda: la.ctx_twopass_reference(k, v, m),
                    la_bound_parts(name, *shape), reps=10), la_flops(name, *shape))
            if dt == torch.bfloat16 and i == 0:
                if not torch.equal(la.linear_attention_out_twopass(q, ctx), out):
                    raise AssertionError(f"#8 {tag}: two calls on the same inputs differ")
                a2, s2 = la.linear_attention_ctx_twopass(k, v, m, chunk)
                if not (torch.equal(a2, a) and torch.equal(s2, s)):
                    raise AssertionError(f"#7 {tag}: two calls on the same inputs differ")
                row["same_bits_twice"] = {"linear_attention_ctx_twopass": True,
                                          "linear_attention_out_twopass": True}
                del a2, s2
                row["route_ms"] = {
                    "twopass": time_ms(lambda: la.linear_attention_twopass(q, k, v, chunk), 10),
                    "reference": time_ms(lambda: la.linear_attention_reference(q, k, v), 10),
                    "per_head": time_ms(lambda: la.linear_attention_per_head(q, k, v), 10)}
            del q, k, v, m, a, s, ra, rs, ctx, out, want
            torch.cuda.empty_cache()
        rows[f"B{b}_N{n}_chunk{chunk}"] = row
        print(f"   B={b} N={n:5d} chunk={chunk}: {json.dumps(row)}", flush=True)
    return rows


@torch.no_grad()
def bias_act_vs_plain(device) -> dict:
    """Phase 15: #12 against its plain version at BIAS_ACT_SHAPES, f32 (rtol
    1e-5, atol 1e-6) and bf16 (rtol = atol = 8e-3: both compute in f32 and
    round once, so a rounding may flip one unit): all 9 activations, with
    and without bias, clamp none and 1.5, default gain and 0.5. lrelu timed
    in bf16 per shape: the StyleGAN default (bias, gain sqrt 2) beside its
    plain version, and no bias, gain 1, no clamp beside F.leaky_relu, the one
    PyTorch call of that function, each by events, host time and the card's
    own time (device_ms)."""
    rows = {}
    for i, (r, c) in enumerate(BIAS_ACT_SHAPES):
        g = torch.Generator(device).manual_seed(200 + i)
        x32 = 2 * torch.randn(r, c, generator=g, device=device)
        b = torch.randn(c, generator=g, device=device)
        row = {"max_err": {}}
        for dt in (torch.float32, torch.bfloat16):
            x = x32.to(dt)
            tol = (1e-5, 1e-6) if dt == torch.float32 else (8e-3, 8e-3)
            worst = 0.0
            for act in so.activation_funcs:
                for bias in (None, b):
                    for clamp in (None, 1.5):
                        for gain in (None, 0.5):
                            _, alpha, gn, cl = so._resolve(act, None, gain, clamp)
                            worst = max(worst, check_close(
                                so.bias_act_fused(x, bias, act, alpha, gn, cl),
                                so.bias_act_fused_reference(x, bias, act, alpha, gn, cl), *tol,
                                f"#12 {act} bias={bias is not None} clamp={clamp} gain={gain} "
                                f"[{r}, {c}] {str(dt)[6:]}"))
            row["max_err"][str(dt)[6:]] = worst
        xb, gain = x32.bfloat16(), math.sqrt(2)
        row["lrelu_default"] = timing(
            lambda: so.bias_act_fused(xb, b, "lrelu", 0.2, gain, -1.0),
            lambda: so.bias_act_fused_reference(xb, b, "lrelu", 0.2, gain, -1.0),
            bias_act_bound_parts(r, c, True, True))
        kernel = lambda: so.bias_act_fused(xb, None, "lrelu", 0.2, 1.0, -1.0)
        library = lambda: torch.nn.functional.leaky_relu(xb, 0.2)
        row["bias_act_fused"] = timing(
            kernel, lambda: so.bias_act_fused_reference(xb, None, "lrelu", 0.2, 1.0, -1.0),
            bias_act_bound_parts(r, c, False, False), library=library)
        # the card's own time of each (kernel durations from torch.profiler),
        # and the host's time to issue the library call: device against
        # device, host against host
        row["bias_act_fused"].update(
            device_ms=sum(device_ms(kernel).values()),
            library_device_ms=sum(device_ms(library).values()),
            library_host_ms=host_ms(library))
        rows[f"{r}x{c}"] = row
        print(f"   [{r}, {c}]: {json.dumps(row)}", flush=True)
    return rows


@contextlib.contextmanager
def la_switches(kernels: bool = True, twopass: bool = False):
    """Set CCDM_TPU_FUSED_ATTN's and CCDM_TPU_TWOPASS_ATTN's module switches
    for the block."""
    before = la.USE_KERNELS, la.USE_TWOPASS
    la.USE_KERNELS, la.USE_TWOPASS = kernels, twopass
    try:
        yield
    finally:
        la.USE_KERNELS, la.USE_TWOPASS = before


def la_modules(c: int, seed: int, device):
    """FusedLinearAttentionBlock(c) with phase 3's weights (f32), and
    PreNormResidual(c, LinearAttention(c, 4, 32)) holding the same function
    (utils/convert.prenorm_linear_attention_from_fused)."""
    g = torch.Generator().manual_seed(seed)
    block = FusedLinearAttentionBlock(c, HEADS, DIM_HEAD)
    block.load_state_dict({"norm_g": 1 + 0.5 * torch.randn(c, generator=g),
                           "qkv_kernel": 0.1 * torch.randn(c, 3 * F, generator=g),
                           "out_kernel": 0.1 * torch.randn(F, c, generator=g),
                           "out_bias": 0.1 * torch.randn(c, generator=g),
                           "out_norm_g": 1 + 0.5 * torch.randn(c, generator=g)})
    module = PreNormResidual(c, LinearAttention(c, HEADS, DIM_HEAD))
    module.load_state_dict(prenorm_linear_attention_from_fused(block.state_dict()))
    return block.to(device), module.to(device)


def _image(batch: int, n: int, c: int, device, seed: int) -> torch.Tensor:
    """x ~ N(0, 1) [B, C, H, W] in channels_last memory, H = W = sqrt(N)."""
    side = math.isqrt(n)
    g = torch.Generator(device).manual_seed(seed)
    return torch.randn(batch, side, side, c, generator=g, device=device).permute(0, 3, 1, 2)


TWOPASS_MODULE = (16, 16384, 64)  # B, N, C of the module on the two-pass route


@torch.no_grad()
def la_main_path(device) -> dict:
    """Phase 16: this slice's path through its public entry points, launch
    counts set to 0 just before and read just after:
    - PreNormResidual(LinearAttention) (the UNet's attention before its fused
      block) at the ten attention levels of the UNet, B 64, f32 and bf16:
      the dispatcher's default route, #6;
    - the module at N 16384 (B 16, C 64) with CCDM_TPU_TWOPASS_ATTN's switch
      on: #7 + #8;
    - linear_attention_per_head on q, k, v at B 64, N 4096, bf16: #9;
    - bias_act(impl="auto") (lrelu, bias, default gain) at the three GAN
      maps, bf16: #12.
    Exactly one launch per call, none of #1-#5, #10, #11. Then the checks:
    per level, the module in f32 (TF32 off) against FusedLinearAttentionBlock
    on the same weights and x (kernel #6 against kernel #1), max abs diff
    <= 1e-4; in bf16 the module against itself on the plain route
    (CCDM_TPU_FUSED_ATTN=0) at phase 3's bound (rtol = atol = 3e-2, relative
    to max(|y|, |y - x|)), and its distance to #1's block recorded (the
    module's own bf16 layers round where #1 does not); the two-pass module
    against the plain route at the same bound; #9 and #12 against their
    plain versions as in phases 13 and 15."""
    levels = [(la_modules(c, 300 + i, device), _image(BATCH, n, c, device, 320 + i))
              for i, (n, c) in enumerate(FORWARD_SHAPES)]
    tb, tn, tc = TWOPASS_MODULE
    (_, tp_module), tp_x = la_modules(tc, 340, device), _image(tb, tn, tc, device, 341).bfloat16()
    q, k, v = la_inputs(LA_MAIN, torch.bfloat16, device, seed=342)
    g = torch.Generator(device).manual_seed(343)
    gan = [(torch.randn(64, math.isqrt(r // 64), math.isqrt(r // 64), c, generator=g,
                        device=device).bfloat16(), torch.randn(c, generator=g, device=device))
           for r, c in BIAS_ACT_SHAPES[:3]]

    routes = {f"N{n}_C{c}": {str(dt)[6:]: la_route((BATCH, n, HEADS, DIM_HEAD), dt)["route"]
                             for dt in (torch.float32, torch.bfloat16)}
              for n, c in FORWARD_SHAPES}
    _reset_counts()
    outs = [(module(x), module(x.bfloat16())) for (_, module), x in levels]
    with la_switches(twopass=True):
        tp_y = tp_module(tp_x)
    y9 = la.linear_attention_per_head(q, k, v)
    y12 = [so.bias_act(x, b, act="lrelu") for x, b in gan]
    torch.cuda.synchronize()
    counts = _counts()

    expected = {**{name: 0 for name in counts}, "linear_attention_fulllane": 2 * len(levels),
                "linear_attention_ctx_twopass": 1, "linear_attention_out_twopass": 1,
                "linear_attention_per_head": 1, "bias_act_fused": len(gan)}
    print(f"   launches {counts}", flush=True)
    if counts != expected:
        raise AssertionError(f"this slice's path launched {counts}, expected {expected}")

    result = {"launches": counts, "routes_of_6": routes, "levels": {}}
    for i, (((block, module), x), (y32, y16), (n, c)) in enumerate(zip(levels, outs,
                                                                      FORWARD_SHAPES)):
        xb = x.bfloat16()
        f32 = float((y32 - block(x)).abs().max())
        if not f32 <= 1e-4:
            raise AssertionError(f"module through #6 against #1's block, N={n} C={c}: f32 max "
                                 f"abs diff {f32:.3e} beyond 1e-4")
        with la_switches(kernels=False):
            want = module(xb)
        scale = torch.maximum(want.float().abs(), (want.float() - xb.float()).abs())
        bf16 = check_close(y16, want, 3e-2, 3e-2, f"module bf16 N={n} C={c}", scale=scale)
        result["levels"][f"{i}_N{n}_C{c}"] = {
            "f32_vs_block": f32, "bf16_vs_plain_route": bf16,
            "bf16_vs_block": float((y16.float() - block(xb).float()).abs().max())}
    with la_switches(kernels=False):
        want = tp_module(tp_x)
    scale = torch.maximum(want.float().abs(), (want.float() - tp_x.float()).abs())
    result["twopass_module_bf16_vs_plain_route"] = check_close(
        tp_y, want, 3e-2, 3e-2, "module on the two-pass route", scale=scale)
    want = la.linear_attention_reference(q, k, v)
    result["per_head_max_err"] = la_check(y9, want, "#9 on the path")
    result["per_head_rounding"] = check_rounding(y9, want, la.fulllane_reference(q, k, v),
                                                 "#9 on the path")
    result["bias_act_max_err"] = max(
        check_close(y, so.bias_act_fused_reference(x, b, "lrelu", 0.2, math.sqrt(2), -1.0),
                    8e-3, 8e-3, "#12 on the path") for y, (x, b) in zip(y12, gan))
    print(f"   {json.dumps(result)}", flush=True)
    return result


def la_grad_parity(device) -> dict:
    """Phase 17: one loss (mean squared error to a drawn target) + backward
    of PreNormResidual(LinearAttention(64)) at B 128 on the 64x64 map (N
    4096), f32 with TF32 off: kernel #6 forward with the plain backward
    against the all-plain route (CCDM_TPU_FUSED_ATTN=0) on the same x and
    target; every gradient (x and the five parameters) within 1e-3 of its
    largest |g|, the loss to 1e-5; one launch of #6, none on the plain route."""
    _, module = la_modules(64, 400, device)
    x = _image(TRAIN_BATCH, 4096, 64, device, 401)
    target = _image(TRAIN_BATCH, 4096, 64, device, 402)

    def loss_and_grads():
        module.zero_grad(set_to_none=True)
        xx = x.detach().clone().requires_grad_()
        loss = (module(xx) - target).square().mean()
        loss.backward()
        return loss.item(), {"x": xx.grad, **{name: p.grad.clone()
                                              for name, p in module.named_parameters()}}

    before = la.linear_attention_fulllane.launches
    loss_k, grads_k = loss_and_grads()
    with la_switches(kernels=False):
        loss_p, grads_p = loss_and_grads()
    if la.linear_attention_fulllane.launches - before != 1:
        raise AssertionError("the training step did not launch #6 exactly once")
    worst = 0.0
    for name, want in grads_p.items():
        scale = float(want.abs().max())
        diff = float((grads_k[name] - want).abs().max())
        if not diff <= 1e-3 * scale:
            raise AssertionError(f"grad {name}: max abs diff {diff:.3e} beyond 1e-3 x {scale:.3e}")
        worst = max(worst, diff / max(scale, 1e-30))
    print(f"   loss {loss_k:.6f} (plain {loss_p:.6f}); worst gradient {worst:.3e} of its "
          f"largest |g|", flush=True)
    if abs(loss_k - loss_p) > 1e-5 * abs(loss_p):
        raise AssertionError(f"loss {loss_k} against plain {loss_p}")
    return {"loss": loss_k, "loss_plain": loss_p, "worst_grad_rel_diff": worst}


PLAN_KEY = {"linear_attention_ctx_twopass": "plan7", "linear_attention_per_head": "plan9"}


def route_text(plan: dict) -> str:
    """A plan of #7 or #9 as its route and splits (#9: statistics/context/out)."""
    if "splits" in plan:
        return f"{plan['route']} x{plan['splits']}"
    return f"{plan['route']} {plan['stat_splits']}/{plan['ctx_splits']}/{plan['out_splits']}"


def slice4_kernel_rows(la_rows: dict, tp_rows: dict, ba_rows: dict, path: dict, grads: dict,
                       card: str) -> list:
    """The kernels-line entries of #6-#9 and #12."""
    b, n, h, d = LA_MAIN
    main = la_rows[f"B{b}_N{n}_H{h}_D{d}"]
    tp_main = tp_rows["B{}_N{}_chunk{}".format(*TWOPASS_SHAPES[0])]
    worst = lambda rows, keys: max(v for r in rows.values() for k, v in r["max_err"].items()
                                   if any(k.startswith(p) for p in keys) and k.endswith("bfloat16"))
    out = []
    for name in LA:
        timed = tp_main[name] if "twopass" in name else main[name]
        rows = tp_rows if "twopass" in name else la_rows
        keys = {"linear_attention_ctx_twopass": ("a_", "s_"),
                "linear_attention_out_twopass": ("out_",)}.get(name, (name,))
        out.append({
            "name": name, "route": "cuda", "source": "ccdm_tpu_torch/csrc/linear_attention.cu",
            "replaces": LA_REPLACES[name], "launches": path["launches"][name],
            "max_abs_err": worst(rows, keys), **timed, "library_ms": None,
            "ms_is": ("one call at B {}, N {}, H 4, D 32, chunk {}, bf16".format(
                *TWOPASS_SHAPES[0]) if "twopass" in name
                else f"one call at B {b}, N {n}, H {h}, D {d}, bf16"),
            **({"routes": {tag: route_text(r[PLAN_KEY[name]]["bfloat16"])
                           for tag, r in rows.items()}} if name in PLAN_KEY else {}),
            "by_shape": {tag: {**r.get(name, {}), "max_err": r["max_err"]}
                         for tag, r in rows.items()},
            "card": card})
    out[0]["module_path"] = path
    out[0]["module_grad_parity"] = grads
    out[1]["route_ms"] = tp_main["route_ms"]
    ba = ba_rows["{}x{}".format(*BIAS_ACT_MAIN)]
    out.append({
        "name": "bias_act_fused", "route": "cuda", "source": "ccdm_tpu_torch/csrc/style_ops.cu",
        "replaces": "ccdm_tpu/ops/style_ops.py:92", "launches": path["launches"]["bias_act_fused"],
        "max_abs_err": max(r["max_err"]["bfloat16"] for r in ba_rows.values()),
        **ba["bias_act_fused"],
        "ms_is": "one lrelu call, no bias, gain 1, no clamp (F.leaky_relu's function), "
                 "[{}, {}] bf16".format(*BIAS_ACT_MAIN),
        "by_shape": ba_rows, "card": card})
    return out


def main() -> int:
    faulthandler.dump_traceback_later(1100, exit=True)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the card",
              file=sys.stderr)
        return 1
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("1/19 device")
    card = card_line()
    print(f"   {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)

    phase("2/19 build")
    libraries = ("attn_block", "attn_block_large", "resnet_block", "linear_attention",
                 "style_ops")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libraries)) as pool:  # one nvcc per source, all at once
        list(pool.map(_build.build, libraries))
    for name in libraries:
        _build.load(name)
    print(f"   {', '.join(libraries)} built and loaded in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name in libraries:
        for line in _build.BUILD_LOGS.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print("   " + line.strip(), flush=True)

    phase("3/19 attn_block kernel against its plain version")
    rows, rows_by_batch = kernel_vs_plain(device)

    phase("4/19 full-width UNet and sampler, kernel against plain attention (f32)")
    parity = model_parity(device)

    phase("5/19 main path: SamplerService over HTTP, bf16, batch 32, 250 DDIM steps")
    served = serve_main_path(device, card)

    phase("6/19 kernels #2-#5 against their plain versions at the UNets' two-pass shapes, "
          "bf16 and f32")
    large_rows = large_vs_plain(device)
    two_vs_one = two_pass_vs_single_pass(device)
    other_dim_head = dim_head_vs_plain(device)

    phase("7/19 full-width f32 UNet, one loss + backward, kernels against plain attention")
    grads = grad_parity(device)

    phase(f"8/19 main path: training, batch {TRAIN_BATCH}, bf16, {TRAIN_STEPS} steps, then "
          "serving from its milestone")
    trained = train_main_path(
        device, card, TRAIN_ARGV, TRAIN_STEPS,
        {"attn_block": 8 * TRAIN_STEPS + ATTN_BLOCKS * EVAL_FORWARDS,
         **{k: 2 * TRAIN_STEPS for k in LARGE}, **{k: 0 for k in (*RESNET, *NEW_KERNELS)}},
        False, train_checks(card))

    phase("9/19 kernels #10 and #11 (the fused resnet block) against their plain versions, "
          "f32 and bf16")
    resnet_rows = resnet_vs_plain(device)

    phase("10/19 full-width f32 UNet and sampler, CCDM_TPU_FUSED_RESBLOCK on against off")
    fused_parity = fused_model_parity(device)

    phase(f"11/19 main path with the switch on: SamplerService over HTTP, bf16, batch "
          f"{SERVE_BATCH}, {FUSED_STEPS} DDIM steps; then --sampler ddpm")
    fused_served = fused_serve_main_path(device, card)

    phase(f"12/19 main path with the switch on: training, batch {TRAIN_BATCH}, bf16, "
          f"{FUSED_TRAIN_STEPS} steps, its EMA grid and the sampling after training")
    fused_trained = train_main_path(
        device, card, FUSED_TRAIN_ARGV, FUSED_TRAIN_STEPS,
        {"attn_block": 8 * FUSED_TRAIN_STEPS
         + ATTN_BLOCKS * (FUSED_TRAIN_FORWARDS - FUSED_TRAIN_STEPS),
         **{k: 2 * FUSED_TRAIN_STEPS for k in LARGE},
         **{k: RESNET_BLOCKS * FUSED_TRAIN_FORWARDS for k in RESNET},
         **{k: 0 for k in NEW_KERNELS}},
        True, fused_train_checks(card))

    phase("13/19 kernels #6 and #9 (standalone linear attention) against their plain versions")
    la_rows = la_vs_plain(device)

    phase("14/19 kernels #7 + #8 (its two-pass form) against their plain versions")
    tp_rows = twopass_vs_plain(device)

    phase("15/19 kernel #12 (bias_act) against its plain version")
    ba_rows = bias_act_vs_plain(device)

    phase("16/19 this slice's path: PreNormResidual(LinearAttention) at the UNet's ten levels, "
          "the two-pass route, linear_attention_per_head, bias_act")
    la_path = la_main_path(device)

    phase("17/19 PreNormResidual(LinearAttention), one f32 loss + backward, B 128, N 4096, "
          "kernel forward against the plain route")
    la_grads = la_grad_parity(device)

    phase("18/19 kernels")
    fwd = [rows[f"N{n}_C{c}"] for n, c in FORWARD_SHAPES]
    # the ten launches run one after another: their least time is the sum
    # of theirs, bound by whichever of bytes or operations gives more of it
    by_bytes = sum(r["bound_ms"] for r in fwd if r["bound_by"] == "bytes")
    kernels = [{
        "name": "attn_block", "route": "cuda",
        "source": "ccdm_tpu_torch/csrc/attn_block.cu",
        "replaces": "ccdm_tpu/ops/attn_block.py:65",
        "launches": served["launches"],
        "max_abs_err": max([e for r in rows.values()
                            for e in (r["max_err_bf16"], r["max_err_bf16_rounded"])
                            if e is not None] +
                           [e for errs in rows_by_batch.values() for pair in errs.values()
                            for e in pair if e is not None]),
        "ms": sum(r["ms"] for r in fwd),
        "plain_ms": sum(r["plain_ms"] for r in fwd),
        "bound_ms": sum(r["bound_ms"] for r in fwd),
        "bound_by": "bytes" if 2 * by_bytes >= sum(r["bound_ms"] for r in fwd) else "operations",
        "library_ms": None,
        "host_ms": sum(r["host_ms"] for r in fwd),
        "routes": [f"N{n} C{c}: {rows[f'N{n}_C{c}']['route']} x{rows[f'N{n}_C{c}']['splits']}"
                   for n, c in FORWARD_SHAPES],
        "ms_is": f"sum over the 10 launches of one UNet forward, B {BATCH}, bf16",
        "launches_in_training": trained["launches"]["attn_block"],
        "max_err_bf16": max(r["max_err_bf16"] for r in rows.values()
                            if r["max_err_bf16"] is not None),
        "max_err_f32": max(r["max_err_f32"] for r in rows.values()),
        "by_shape": rows,
        "bf16_by_batch": rows_by_batch,
        "model_parity": parity,
        "serve": served,
        "card": card,
    }]
    main_tag = "N={} C={} bfloat16".format(*LARGE_SHAPES[0])
    for name in LARGE:
        timing = large_rows[main_tag][name]
        kernels.append({
            "name": name, "route": "cuda", "source": "ccdm_tpu_torch/csrc/attn_block_large.cu",
            "replaces": LARGE_REPLACES[name], "launches": trained["launches"][name],
            "max_abs_err": max(r["max_err"][out] for tag, r in large_rows.items()
                               if tag.endswith("bfloat16") for out in LARGE_OUTPUTS[name]),
            "ms": timing["ms"], "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
            "bound_by": timing["bound_by"], "library_ms": None,
            "ms_is": f"one call at B {TRAIN_BATCH}, N {LARGE_SHAPES[0][0]}, "
                     f"C {LARGE_SHAPES[0][1]}, bf16",
            "routes": {tag: f"{r[name]['route']} x{r[name]['splits']}"
                       for tag, r in large_rows.items() if name in r},
            "by_shape": {tag: r.get(name, {}) for tag, r in large_rows.items()},
            "card": card})
    kernels[1]["two_pass_vs_single_pass"] = two_vs_one
    kernels[1]["dim_head_64"] = other_dim_head
    kernels[3]["grad_parity"] = grads
    kernels[3]["max_err_by_shape"] = {tag: r["max_err"] for tag, r in large_rows.items()}
    kernels[4]["train"] = trained
    kernels += resnet_kernel_rows(resnet_rows, fused_served, fused_trained, fused_parity, card,
                                  served["cfg_forward_ms"])
    kernels += slice4_kernel_rows(la_rows, tp_rows, ba_rows, la_path, la_grads, card)
    print(json.dumps({"kernels": kernels}), flush=True)

    phase("19/19 done")
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
