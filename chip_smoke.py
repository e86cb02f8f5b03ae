#!/usr/bin/env python3
"""Smoke check of the PyTorch/CUDA port (ccdm_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each announced on a flushed line before it starts:
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
  2. build: both kernel libraries, one nvcc each, in parallel (seconds,
     ptxas report);
  3. kernel #1 (the single-pass attention block) against its plain PyTorch
     version at the shapes of the RC-49 64x64 UNet's ten attention blocks
     (B 64) and at N 16384: bf16 against the plain version in f32 on the same
     bf16-rounded inputs (rtol = atol = 3e-2, rtol relative to
     max(|y|, |y - x|), x ~ N(0, 1)), and f32 with TF32 off (rtol 2e-3,
     atol 2e-4, x ~ N(0, 2)), the bounds and inputs of the JAX kernel's
     tests; each shape timed in bf16 with CUDA events;
  4. the full-width UNet in f32 (TF32 off) with the kernel and with the
     plain attention: one forward (max abs diff <= 1e-3) and a 5-step CFG
     DDIM run from the same noise ([0,1] images, max abs diff <= 1e-3);
  5. the serving main path: the port's SamplerService at full width in bf16
     (batch 32, 250 DDIM steps, cond_scale 1.5) behind its own HTTP server on
     127.0.0.1 in a daemon thread, GET /healthz and two POST /generate
     (uint8 [n, 64, 64, 3], not constant; the service refuses a sample that
     is not finite before quantising it); kernel #1's launch count over
     this phase must be 10 x 250 x batches;
  6. kernels #2-#5 (two-pass forward, fused backward) against their plain
     versions at B 128, C 64, N 4096, 2048 and 16384, in bf16 and in f32:
     forward bounds as phase 3 (a and s relative to their largest value),
     backward bounds of tests/test_attn_block.py:301-308 (f32 rtol = atol =
     2e-3; bf16 rtol 1e-1, atol 0.02 max(|g|, 1)); in f32 also #4 + #5
     through the autograd Function against autograd through the plain
     block; each timed in bf16; then #2 + #3 against #1 at sampling time
     (B 64, bf16, N 4096 and 16384);
  7. one loss + backward of the full-width f32 UNet (TF32 off) with the
     kernels and with plain attention on the same batch and draws: every
     gradient leaf within 1e-3 of its largest |g| (the two biases feeding a
     train-mode BatchNorm, whose exact gradient is zero, within 1e-3 of the
     model's largest |g|), the loss to 1e-5;
  8. the training main path: `python -m ccdm_tpu_torch.main` at full width,
     batch 128, bf16, 30 steps, a milestone at the end (run folder
     build/smoke_run, deleted after): losses finite, parameters moved,
     ema_step 30, launches exactly 8 of #1 and 2 each of #2-#5 per step;
     warm train images/s; then SamplerService --serve_milestone serves 4
     labels x 25 DDIM steps from that milestone (uint8, not constant);
  9. one JSON line {"kernels": [...]} with errors, times and bounds;
  10. the card's name and power limit, then the last line
     {"ok": true, "device": {...}}.
TF32 is off for the whole run (it only touches the f32 checks and the f32
convolutions). Any failed phase raises and the script exits non-zero; a
hang becomes a stack dump and a non-zero exit after 900 s. It writes
nothing outside build/.
"""

from __future__ import annotations

import base64
import contextlib
import faulthandler
import io
import json
import shutil
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ccdm_tpu_torch.diffusion.gaussian import DiffusionConfig, GaussianDiffusion
from ccdm_tpu_torch.embedding.analytic import make_fn_y2h
from ccdm_tpu_torch.models.unet import Unet
from ccdm_tpu_torch.ops import _build, attn_block
from ccdm_tpu_torch.opts import parse_opts
from ccdm_tpu_torch.serve import SamplerService, serve

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
CHECK_SHAPES = sorted(set(FORWARD_SHAPES), reverse=True) + [(16384, 64)]
UNET = dict(dim=64, dim_mults=(1, 2, 2, 4, 8), in_channels=3)
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


@torch.no_grad()
def kernel_vs_plain(device) -> dict:
    """Phase 3: per shape, errors in bf16 and f32 and times in bf16."""
    rows = {}
    for i, (n, c) in enumerate(CHECK_SHAPES):
        # x ~ N(0, 1) in bf16 and N(0, 2) in f32, the inputs of the JAX
        # kernel's own tests (tests/test_attn_block.py:61-101)
        x, w = block_inputs(n, c, BATCH, device, seed=i, x_std=2.0)
        xb, wb = (x / 2).bfloat16(), [t.bfloat16() for t in w]
        kernel_b = lambda: attn_block.fused_attn_block(xb, *wb, HEADS, DIM_HEAD)
        plain_b = lambda: attn_block.attn_block_reference(xb, *wb, HEADS, DIM_HEAD)
        # bf16: relative to the larger of |y| and the block's own term
        # |y - x|. Where x cancels that term, the bf16 operand roundings
        # (about 1% of it at C 512) stand beside a small |y|.
        want_b = attn_block.attn_block_reference(xb.float(), *(t.float() for t in wb),
                                                 HEADS, DIM_HEAD)
        err_b = check_close(kernel_b(), want_b, 3e-2, 3e-2, f"bf16 N={n} C={c}",
                            scale=torch.maximum(want_b.abs(), (want_b - xb.float()).abs()))
        err_f = check_close(attn_block.fused_attn_block(x, *w, HEADS, DIM_HEAD),
                            attn_block.attn_block_reference(x, *w, HEADS, DIM_HEAD),
                            2e-3, 2e-4, f"f32 N={n} C={c}")
        t_bytes, t_ops = bound_parts(n, c)
        rows[f"N{n}_C{c}"] = {"max_err_bf16": err_b, "max_err_f32": err_f,
                              "ms": time_ms(kernel_b), "plain_ms": time_ms(plain_b),
                              "bound_ms": max(t_bytes, t_ops),
                              "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        print(f"   N={n:5d} C={c:3d} B={BATCH}: {json.dumps(rows[f'N{n}_C{c}'])}", flush=True)
        del x, w, xb, wb
        torch.cuda.empty_cache()
    return rows


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
def model_parity(device) -> dict:
    """Phase 4: the kernel inside the full-width f32 UNet and sampler."""
    model = Unet(**UNET, dtype=torch.float32, seed=0).to(
        device, memory_format=torch.channels_last).eval()
    g = torch.Generator().manual_seed(1)
    b = 4
    x = torch.randn(b, 64, 64, 3, generator=g).to(device)
    t = torch.tensor([0, 250, 500, 999], device=device)
    emb = make_fn_y2h(128)(torch.linspace(0.1, 0.9, b, device=device))
    keep = torch.tensor([True, False, True, False], device=device)
    out_k = model(x, t, emb, keep)
    with plain_attention():
        out_p = model(x, t, emb, keep)
    fwd = (out_k - out_p).abs().max().item()

    diffusion = GaussianDiffusion(model, DiffusionConfig(
        image_size=64, channels=3, timesteps=1000, sampling_timesteps=5,
        objective="pred_x0"), device=device)
    noise = torch.randn(2, 64, 64, 3, generator=g).to(device)
    img_k = diffusion.ddim_sample(emb[:2], cond_scale=1.5, noise=noise)
    with plain_attention():
        img_p = diffusion.ddim_sample(emb[:2], cond_scale=1.5, noise=noise)
    ddim = (img_k - img_p).abs().max().item()
    print(f"   forward max abs diff {fwd:.3e}; 5-step DDIM max abs diff {ddim:.3e}",
          flush=True)
    if not (fwd <= 1e-3 and ddim <= 1e-3):
        raise AssertionError(f"kernel and plain attention disagree in the model: "
                             f"forward {fwd:.3e}, DDIM {ddim:.3e} (bound 1e-3)")
    return {"forward_max_abs_diff": fwd, "ddim5_max_abs_diff": ddim}


def _request(url: str, body: dict | None = None) -> dict:
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        return json.loads(resp.read())


def serve_main_path(device, card: str) -> dict:
    """Phase 5: requests through the port's HTTP server; returns the
    kernel's launch count over the phase and the throughput."""
    args = parse_opts(SERVE_ARGV)
    attn_block.fused_attn_block.launches = 0
    t0 = time.perf_counter()
    service = SamplerService(args, max_batch=SERVE_BATCH, warm=True, device=str(device))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    batches = 1
    httpd = serve(service, 0, host="127.0.0.1", block=False)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        health = _request(url + "/healthz")
        if health.get("status") != "ok" or not health.get("warm"):
            raise AssertionError(f"/healthz answered {health}")
        n_images, req_s = 0, 0.0
        for n, seed in ((5, 0), (40, 1)):
            labels = np.linspace(0.05, 0.95, n).round(4).tolist()
            t0 = time.perf_counter()
            reply = _request(url + "/generate", {"labels": labels, "seed": seed})
            req_s += time.perf_counter() - t0
            images = np.load(io.BytesIO(base64.b64decode(reply["images_b64"])))["images"]
            if images.dtype != np.uint8 or images.shape != (n, args.image_size, args.image_size, 3):
                raise AssertionError(f"/generate gave {images.dtype} {images.shape}")
            if images.std() == 0:
                raise AssertionError("/generate gave constant images")
            n_images += n
            batches += -(-n // SERVE_BATCH)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
    if thread.is_alive():
        raise AssertionError("the HTTP server thread did not stop")
    launches = attn_block.fused_attn_block.launches
    expected = 10 * STEPS * batches
    ips = n_images / req_s
    print(f"   {batches} batches of {SERVE_BATCH} (warm-up {warm_s:.1f} s), "
          f"{n_images} images in {req_s:.2f} s: {ips:.2f} images/s on {card}; "
          f"attention kernel launches {launches} (expected {expected})", flush=True)
    if launches != expected:
        raise AssertionError(f"the serving path launched the attention kernel "
                             f"{launches} times, expected {expected}")
    return {"launches": launches, "batches": batches, "images_per_s": ips,
            "requested_images": n_images, "request_s": req_s}


# ------------------------------------------------- the training slice

TRAIN_BATCH = 128
TRAIN_STEPS = 30
# (N, C) of kernels #2-#5: the two N 4096 blocks of the 64x64 training step
# first (the main path's shape), then N 2048 and N 16384
LARGE_SHAPES = [(4096, 64), (2048, 64), (16384, 64)]
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
              "--save_every", str(TRAIN_STEPS), "--log_every", "5", "--seed", "0"]


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
    per_token = {"attn_ctx_large": 2 * c * f + f * d, "attn_out_large": 2 * c * f + f * d,
                 "attn_bwd_a": 4 * c * f + 2 * f * d,
                 "attn_bwd_b": 10 * c * f + 3 * f * d}[name]
    return nbytes / HBM_BYTES_PER_S * 1e3, 2 * batch * n * per_token / BF16_FLOPS * 1e3


def _check_grad(got, want, dtype, what) -> float:
    """The backward bounds of tests/test_attn_block.py:301-308: f32 rtol =
    atol = 2e-3; bf16 rtol 1e-1, atol 0.02 max(|g|, 1)."""
    if dtype == torch.float32:
        return check_close(got, want, 2e-3, 2e-3, what)
    return check_close(got, want, 1e-1, 0.02 * max(float(want.float().abs().max()), 1.0), what)


def large_vs_plain(device) -> dict:
    """Kernels #2-#5 against their plain versions at B 128, bf16 and f32
    (TF32 off), timed in bf16; #4 + #5 in f32 also against autograd through
    attn_block_reference."""
    rows = {}
    for i, (n, c) in enumerate(LARGE_SHAPES):
        for dt in (torch.bfloat16, torch.float32):
            x, w = block_inputs(n, c, TRAIN_BATCH, device, seed=20 + i, x_std=1.0)
            g = torch.Generator().manual_seed(40 + i)
            x = x.to(dt)
            dy = torch.randn(TRAIN_BATCH, n, c, generator=g).to(device).to(dt)
            g_pre, wqkv, wout, bout, g_out = w
            tag = f"N={n} C={c} {str(dt)[6:]}"
            err = {}
            a, s, kmax = attn_block.attn_ctx_large(x, g_pre, wqkv, HEADS)
            ra, rs, rkmax = attn_block.ctx_large_reference(x, g_pre, wqkv, HEADS)
            fwd = (2e-3, 2e-4) if dt == torch.float32 else (3e-2, 3e-2)
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
            for name, gv, wv in zip(("dx", "d_wqkv", "d_gpre"),
                                    attn_block.attn_bwd_b(*bwd_b_args),
                                    attn_block.bwd_b_reference(*bwd_b_args)):
                err[name] = _check_grad(gv, wv, dt, f"#5 {name} {tag}")
            row = {"max_err": err}
            if dt == torch.float32:
                row["autograd_max_err"] = autograd_vs_reference(x, dy, w)
            else:
                reps = 5 if n > 4096 else 20
                calls = {"attn_ctx_large": ((lambda: attn_block.attn_ctx_large(x, g_pre, wqkv, HEADS)),
                                            (lambda: attn_block.ctx_large_reference(x, g_pre, wqkv, HEADS))),
                         "attn_out_large": ((lambda: attn_block.attn_out_large(*out_args)),
                                            (lambda: attn_block.out_large_reference(*out_args))),
                         "attn_bwd_a": ((lambda: attn_block.attn_bwd_a(*bwd_a_args)),
                                        (lambda: attn_block.bwd_a_reference(*bwd_a_args))),
                         "attn_bwd_b": ((lambda: attn_block.attn_bwd_b(*bwd_b_args)),
                                        (lambda: attn_block.bwd_b_reference(*bwd_b_args)))}
                for name, (kernel, plain) in calls.items():
                    t_bytes, t_ops = large_bound_parts(name, n, c)
                    row[name] = {"ms": time_ms(kernel, reps=reps),
                                 "plain_ms": time_ms(plain, reps=reps),
                                 "bound_ms": max(t_bytes, t_ops),
                                 "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
            rows[tag] = row
            print(f"   {tag} B={TRAIN_BATCH}: {json.dumps(row)}", flush=True)
            del x, w, dy, a, s, kmax, ra, rs, rkmax, ctx, want, want_a, d_a, d_s
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


def _counts() -> dict:
    return {"attn_block": attn_block.fused_attn_block.launches,
            **{name: getattr(attn_block, name).launches for name in LARGE}}


def _reset_counts() -> None:
    attn_block.fused_attn_block.launches = 0
    for name in LARGE:
        getattr(attn_block, name).launches = 0


def train_main_path(device, card: str) -> dict:
    """The port's training entry at full width (batch 128, bf16), then a
    short request served from the milestone it wrote."""
    from ccdm_tpu_torch import main as port_main

    run = Path(__file__).resolve().parent / "build" / "smoke_run"
    shutil.rmtree(run, ignore_errors=True)
    argv = ["--root_path", str(run), "--device", str(device), *TRAIN_ARGV]
    initial = Unet(**UNET, dtype=torch.bfloat16, seed=0).state_dict()
    try:
        _reset_counts()
        trainer = port_main.main(argv)
        torch.cuda.synchronize()
        counts = _counts()
        expected = {"attn_block": 8 * TRAIN_STEPS, **{k: 2 * TRAIN_STEPS for k in LARGE}}
        results = port_main.results_folder(parse_opts(argv))
        log = [json.loads(line) for line in open(Path(results) / "train_log.jsonl")]
        state = trainer.state
        moved = max(float((p.detach().cpu() - initial[name]).abs().max())
                    for name, p in state.model.named_parameters())
        warm = [r["imgs_per_sec"] for r in log if r["step"] > TRAIN_STEPS // 3]
        ips = sum(warm) / len(warm)
        print(f"   {TRAIN_STEPS} steps of batch {TRAIN_BATCH}: losses "
              f"{[round(r['loss'], 4) for r in log]}; params moved by up to {moved:.3e}; "
              f"ema_step {state.ema_step}; launches {counts} (expected {expected})", flush=True)
        print(f"   warm train {ips:.2f} images/s (steps {TRAIN_STEPS // 3 + 1}-{TRAIN_STEPS}, batch {TRAIN_BATCH}, "
              f"bf16) on {card}", flush=True)
        if not all(np.isfinite(r["loss"]) for r in log):
            raise AssertionError("a training loss is not finite")
        if not moved > 0 or state.step != TRAIN_STEPS or state.ema_step != TRAIN_STEPS:
            raise AssertionError(f"params moved {moved}, step {state.step}, "
                                 f"ema_step {state.ema_step}")
        if counts != expected:
            raise AssertionError(f"kernel launches {counts}, expected {expected}")

        args = parse_opts(["--root_path", str(run), *TRAIN_ARGV,
                           "--serve_milestone", str(TRAIN_STEPS), "--sample_timesteps", "25",
                           "--sample_cond_scale", "1.5"])
        service = SamplerService(args, max_batch=4, warm=False, device=str(device))
        images = service.generate(np.linspace(0.1, 0.9, 4).astype(np.float32))
        if images.dtype != np.uint8 or images.shape != (4, 64, 64, 3) or images.std() == 0:
            raise AssertionError(f"serving milestone {TRAIN_STEPS} gave {images.dtype} "
                                 f"{images.shape}, std {images.std()}")
        print(f"   served 4 labels x 25 DDIM steps from milestone {TRAIN_STEPS}: uint8 "
              f"{images.shape}, std {images.std():.2f}", flush=True)
        return {"launches": counts, "train_images_per_s": ips, "steps": TRAIN_STEPS,
                "losses": [r["loss"] for r in log]}
    finally:
        shutil.rmtree(run, ignore_errors=True)


def main() -> int:
    faulthandler.dump_traceback_later(900, exit=True)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the card",
              file=sys.stderr)
        return 1
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("1/10 device")
    card = card_line()
    print(f"   {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)

    phase("2/10 build")
    libraries = ("attn_block", "attn_block_large")
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

    phase("3/10 attn_block kernel against its plain version")
    rows = kernel_vs_plain(device)

    phase("4/10 full-width UNet and sampler, kernel against plain attention (f32)")
    parity = model_parity(device)

    phase("5/10 main path: SamplerService over HTTP, bf16, batch 32, 250 DDIM steps")
    served = serve_main_path(device, card)

    phase("6/10 kernels #2-#5 against their plain versions, B 128, bf16 and f32")
    large_rows = large_vs_plain(device)
    two_vs_one = two_pass_vs_single_pass(device)

    phase("7/10 full-width f32 UNet, one loss + backward, kernels against plain attention")
    grads = grad_parity(device)

    phase(f"8/10 main path: training, batch {TRAIN_BATCH}, bf16, {TRAIN_STEPS} steps, then "
          "serving from its milestone")
    trained = train_main_path(device, card)

    phase("9/10 kernels")
    fwd = [rows[f"N{n}_C{c}"] for n, c in FORWARD_SHAPES]
    # the ten launches run one after another: their least time is the sum
    # of theirs, bound by whichever of bytes or operations gives more of it
    by_bytes = sum(r["bound_ms"] for r in fwd if r["bound_by"] == "bytes")
    kernels = [{
        "name": "attn_block", "route": "cuda",
        "source": "ccdm_tpu_torch/csrc/attn_block.cu",
        "replaces": "ccdm_tpu/ops/attn_block.py:65",
        "launches": served["launches"],
        "max_abs_err": max(r["max_err_bf16"] for r in rows.values()),
        "ms": sum(r["ms"] for r in fwd),
        "plain_ms": sum(r["plain_ms"] for r in fwd),
        "bound_ms": sum(r["bound_ms"] for r in fwd),
        "bound_by": "bytes" if 2 * by_bytes >= sum(r["bound_ms"] for r in fwd) else "operations",
        "library_ms": None,
        "ms_is": f"sum over the 10 launches of one UNet forward, B {BATCH}, bf16",
        "launches_in_training": trained["launches"]["attn_block"],
        "max_err_bf16": max(r["max_err_bf16"] for r in rows.values()),
        "max_err_f32": max(r["max_err_f32"] for r in rows.values()),
        "by_shape": rows,
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
            "by_shape": {tag: r.get(name, {}) for tag, r in large_rows.items()},
            "card": card})
    kernels[1]["two_pass_vs_single_pass"] = two_vs_one
    kernels[3]["grad_parity"] = grads
    kernels[3]["max_err_by_shape"] = {tag: r["max_err"] for tag, r in large_rows.items()}
    kernels[4]["train"] = trained
    print(json.dumps({"kernels": kernels}), flush=True)

    phase("10/10 done")
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
