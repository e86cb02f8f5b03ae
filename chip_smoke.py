#!/usr/bin/env python3
"""Smoke check of the PyTorch/CUDA port (ccdm_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each announced on a flushed line before it starts:
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
  2. build: the attention-block kernel with nvcc (seconds, ptxas report);
  3. the kernel against its plain PyTorch version at the shapes of the
     RC-49 64x64 UNet's ten attention blocks (B 64) and at N 16384: bf16
     against the plain version in f32 on the same bf16-rounded inputs
     (rtol = atol = 3e-2, rtol relative to max(|y|, |y - x|), x ~ N(0, 1)),
     and f32 with TF32 off (rtol 2e-3, atol 2e-4, x ~ N(0, 2)), the bounds
     and inputs of the JAX kernel's tests; each shape timed in bf16 with
     CUDA events;
  4. the full-width UNet in f32 (TF32 off) with the kernel and with the
     plain attention: one forward (max abs diff <= 1e-3) and a 5-step CFG
     DDIM run from the same noise ([0,1] images, max abs diff <= 1e-3);
  5. the main path: the port's SamplerService at full width in bf16 (batch
     32, 250 DDIM steps, cond_scale 1.5) behind its own HTTP server on
     127.0.0.1 in a daemon thread, GET /healthz and two POST /generate
     (uint8 [n, 64, 64, 3], not constant; the service refuses a sample that
     is not finite before quantising it); the kernel's launch count over
     this phase must be 10 x 250 x batches;
  6. one JSON line {"kernels": [...]} with errors, times and bounds;
  7. the card's name and power limit, then the last line
     {"ok": true, "device": {...}}.
TF32 is off for the whole run (it only touches the f32 checks). Any failed
phase raises and the script exits non-zero; a hang becomes a stack dump and
a non-zero exit after 900 s. It writes nothing but the kernel build under
build/.
"""

from __future__ import annotations

import base64
import contextlib
import faulthandler
import io
import json
import subprocess
import sys
import threading
import time
import urllib.request

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


def main() -> int:
    faulthandler.dump_traceback_later(900, exit=True)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the card",
              file=sys.stderr)
        return 1
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("1/7 device")
    card = card_line()
    print(f"   {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)

    phase("2/7 build")
    t0 = time.perf_counter()
    _build.load("attn_block")
    print(f"   attn_block built and loaded in {time.perf_counter() - t0:.1f} s", flush=True)
    for line in _build.BUILD_LOGS.get("attn_block", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("   " + line.strip(), flush=True)

    phase("3/7 attn_block kernel against its plain version")
    rows = kernel_vs_plain(device)

    phase("4/7 full-width UNet and sampler, kernel against plain attention (f32)")
    parity = model_parity(device)

    phase("5/7 main path: SamplerService over HTTP, bf16, batch 32, 250 DDIM steps")
    served = serve_main_path(device, card)

    phase("6/7 kernels")
    fwd = [rows[f"N{n}_C{c}"] for n, c in FORWARD_SHAPES]
    # the ten launches run one after another: their least time is the sum
    # of theirs, bound by whichever of bytes or operations gives more of it
    by_bytes = sum(r["bound_ms"] for r in fwd if r["bound_by"] == "bytes")
    kernel = {
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
        "max_err_bf16": max(r["max_err_bf16"] for r in rows.values()),
        "max_err_f32": max(r["max_err_f32"] for r in rows.values()),
        "by_shape": rows,
        "model_parity": parity,
        "serve": served,
        "card": card,
    }
    print(json.dumps({"kernels": [kernel]}), flush=True)

    phase("7/7 done")
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
