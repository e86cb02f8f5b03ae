#!/usr/bin/env python3
"""Kernels #1 (the attention block), #6-#9 (standalone linear attention)
and #12 (bias_act) on one card: each call's time split between the host and
the card, and variants of #1.

    python3 scripts/attn_variants.py [--root DIR]
        [--variants | --forward | --la | --la-turns PARENT | --la-variants]

Times the wrappers of the ccdm_tpu_torch package under DIR (default: this
checkout; another commit unpacked with `git archive` under build/ times
that commit's wrappers with this checkout's helpers):
- #1 at the ten (N, C) of one RC-49 64x64 UNet forward
  (chip_smoke.FORWARD_SHAPES), B 64, bf16, phase 3's inputs;
- #12 at phase 15's maps (chip_smoke.BIAS_ACT_SHAPES), bf16 lrelu with no
  bias, gain 1 and no clamp, beside F.leaky_relu, the one PyTorch call of
  that function.
Per call: the event time of 20 back-to-back calls (chip_smoke.time_ms), the
host's time to issue one (host_ms) and the card's own time by kernel name
from torch.profiler (device_ms), as JSON lines.

--forward: instead, one B-64 CFG forward of the served RC-49 64x64 model
(chip_smoke.cfg_forward_turns: the resnet switch off and on in turns, event
and host time of each), to compare two commits' forwards in one call.

--la: instead, #6-#9 in bf16, each at the shapes phases 13 and 14 of
chip_smoke.py time: #6 and #9 at LA_SHAPES of B 64, #7 and #8 at
TWOPASS_SHAPES, on phase 13's and 14's inputs; the event and host time of
each call, as JSON lines. --la-turns PARENT: --la for PARENT, DIR, DIR,
PARENT, each its own process (PARENT a commit unpacked with `git archive`
under build/), so that two designs are compared in one call.

--la-variants: builds csrc/linear_attention.cu with its tunables
substituted (LA_TUNABLES: the tiles of the statistics and context
launches' rings, the statistics blocks an SM, and the tiles and tokens a
tile of #9's context ring) as --variants does, then times #6 and #9 at the B-64
LA_SHAPES and #7 at the first TWOPASS_SHAPES for each in turns (the
committed values first and last), each held to its plain version at
phase 13's or 14's bf16 bound first, with the card's time by kernel at N
4096 (#6, #9) and N 16384 (#7).

--variants: builds csrc/attn_block.cu with its tunables substituted (the
split route's blocks per SM it aims at, kSplitOcc; the minimum blocks per
SM of its launch bounds, kSplitMinBlocks; the longest row of the fused
route, kFusedMaxN) in parallel into build/attn_variants/, then times
the ten B-64 launches of each in turns (the committed values first and
last), each call held to its plain version at phase 3's bf16 bound first.
Needs the card.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
TUNABLES = {"kSplitOcc": "constexpr int kSplitOcc = {};",
            "kSplitMinBlocks": "constexpr int kSplitMinBlocks = {};",
            "kFusedMaxN": "constexpr int kFusedMaxN = {};"}
COMMITTED = {"kSplitOcc": 2, "kSplitMinBlocks": 2, "kFusedMaxN": 128}
VARIANTS = [COMMITTED, {**COMMITTED, "kSplitOcc": 1}, {**COMMITTED, "kSplitOcc": 4},
            {**COMMITTED, "kSplitMinBlocks": 1}, {**COMMITTED, "kFusedMaxN": 64},
            {**COMMITTED, "kFusedMaxN": 256}]
LA_TUNABLES = {"kStages": "constexpr int kStages = {};",
               "kStatBlocks": "constexpr int kStatBlocks = {};",
               "kFStages": "constexpr int kFStages = {};",
               "kFT": "constexpr int kFT = {};"}
LA_COMMITTED = {"kStages": 3, "kStatBlocks": 3, "kFStages": 3, "kFT": 32}
LA_VARIANTS = [LA_COMMITTED, {**LA_COMMITTED, "kStages": 2, "kStatBlocks": 4},
               {**LA_COMMITTED, "kStages": 2, "kStatBlocks": 2},
               {**LA_COMMITTED, "kStatBlocks": 2}, {**LA_COMMITTED, "kFStages": 4},
               {**LA_COMMITTED, "kFStages": 2, "kFT": 64}]


def load_smoke(root: Path):
    """This checkout's chip_smoke.py, importing the ccdm_tpu_torch under root."""
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    return cs


def split(cs, fn) -> dict:
    """Event, host and device time of one call of fn (ms)."""
    dev = cs.device_ms(fn)
    return {"ms": cs.time_ms(fn), "host_ms": cs.host_ms(fn),
            "device_ms": sum(dev.values()), "device_ms_by_kernel": dev}


@torch.no_grad()
def host_and_device(cs, root: Path) -> None:
    device = torch.device("cuda")
    ab, so = cs.attn_block, cs.so
    total = {"ms": 0.0, "host_ms": 0.0, "device_ms": 0.0}
    for i, (n, c) in enumerate(cs.FORWARD_SHAPES):
        x, w = cs.block_inputs(n, c, cs.BATCH, device, seed=i, x_std=1.0)
        xb, wb = x.bfloat16(), [t.bfloat16() for t in w]
        row = split(cs, lambda: ab.fused_attn_block(xb, *wb, cs.HEADS, cs.DIM_HEAD))
        for key in total:
            total[key] += row[key]
        print(json.dumps({"root": str(root), "kernel": "attn_block", "N": n, "C": c,
                          "B": cs.BATCH, **row}), flush=True)
    print(json.dumps({"root": str(root), "kernel": "attn_block", "sum_of_ten": total}),
          flush=True)
    for i, (r, c) in enumerate(cs.BIAS_ACT_SHAPES):
        g = torch.Generator(device).manual_seed(200 + i)
        xb = (2 * torch.randn(r, c, generator=g, device=device)).bfloat16()
        print(json.dumps({
            "root": str(root), "kernel": "bias_act_fused", "rows": r, "C": c,
            **split(cs, lambda: so.bias_act_fused(xb, None, "lrelu", 0.2, 1.0, -1.0)),
            "leaky_relu": split(cs, lambda: torch.nn.functional.leaky_relu(xb, 0.2))}),
            flush=True)


@torch.no_grad()
def la_times(cs, root: Path) -> None:
    device, la = torch.device("cuda"), cs.la
    rows = []
    for i, shape in enumerate(cs.LA_SHAPES):
        if shape[0] != cs.BATCH:
            continue
        q, k, v = cs.la_inputs(shape, torch.bfloat16, device, seed=100 + i)
        for name in ("linear_attention_fulllane", "linear_attention_per_head"):
            call = lambda fn=getattr(la, name): fn(q, k, v)
            rows.append({"kernel": name, "shape": list(shape), "ms": cs.time_ms(call),
                         "host_ms": cs.host_ms(call)})
    for i, (b, n, chunk) in enumerate(cs.TWOPASS_SHAPES):
        shape = (b, n, cs.HEADS, cs.DIM_HEAD)
        q, k, v = cs.la_inputs(shape, torch.bfloat16, device, seed=150 + i)
        m = k.amax(1).float().reshape(b, cs.F)
        ctx = la.finalize_ctx(*la.ctx_twopass_reference(k, v, m), torch.bfloat16)
        for name, call in (("linear_attention_ctx_twopass",
                            lambda: la.linear_attention_ctx_twopass(k, v, m, chunk)),
                           ("linear_attention_out_twopass",
                            lambda: la.linear_attention_out_twopass(q, ctx))):
            rows.append({"kernel": name, "shape": list(shape), "chunk": chunk,
                         "ms": cs.time_ms(call, reps=10), "host_ms": cs.host_ms(call, reps=10)})
        del q, k, v, m, ctx
        torch.cuda.empty_cache()
    for row in rows:
        print(json.dumps({"root": str(root), **row}), flush=True)


def la_turns(parent: Path, root: Path) -> None:
    """--la-turns: --la for PARENT, DIR, DIR, PARENT, each its own process."""
    for r in (parent, root, root, parent):
        proc = subprocess.run([sys.executable, str(HERE / "scripts" / "attn_variants.py"),
                               "--root", str(r), "--la"], capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"--la for {r} failed:\n{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
        print(proc.stdout, end="", flush=True)


def forward(cs, root: Path) -> None:
    service = cs.SamplerService(cs.parse_opts(cs.SERVE_ARGV), max_batch=cs.SERVE_BATCH,
                                warm=False, device="cuda")
    print(json.dumps({"root": str(root), "cfg_forward_turns": cs.cfg_forward_turns(service)}),
          flush=True)


def name_of(v: dict) -> str:
    return "_".join(f"{k}{x}" for k, x in v.items())


def build_variant(cs, v: dict, source: str = "attn_block", tunables=TUNABLES,
                  committed_values=COMMITTED) -> Path:
    src = (cs._build.CSRC_DIR / f"{source}.cu").read_text()
    for key, decl in tunables.items():
        committed = decl.format(committed_values[key])
        if committed not in src:
            raise RuntimeError(f"csrc/{source}.cu no longer declares `{committed}`")
        src = src.replace(committed, decl.format(v[key]), 1)
    out = HERE / "build" / "attn_variants"
    out.mkdir(parents=True, exist_ok=True)
    path, lib = out / f"{name_of(v)}.cu", out / f"lib{name_of(v)}.so"
    path.write_text(src)
    for header in cs._build.CSRC_DIR.glob("*.cuh"):  # the headers the source includes
        shutil.copy(header, out)
    proc = subprocess.run(cs._build.nvcc_command(cs._build.find_nvcc(), path, lib),
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {path.name}:\n{proc.stdout}{proc.stderr}")
    return lib


@torch.no_grad()
def variants(cs) -> None:
    ab = cs.attn_block
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = {name_of(v): ab.declare(ctypes.CDLL(str(lib)))
                for v, lib in zip(VARIANTS, pool.map(lambda v: build_variant(cs, v), VARIANTS))}
    print(f"{len(libs)} variants built in {time.perf_counter() - t0:.1f} s", flush=True)
    device = torch.device("cuda")
    inputs = []
    for i, (n, c) in enumerate(cs.FORWARD_SHAPES):
        x, w = cs.block_inputs(n, c, cs.BATCH, device, seed=i, x_std=1.0)
        inputs.append((n, c, x.bfloat16(), [t.bfloat16() for t in w]))
    for name in [*libs, name_of(COMMITTED)]:
        ab._library = lambda lib=libs[name]: lib
        ab.plan.cache_clear()
        total, shapes = 0.0, []
        for n, c, xb, wb in inputs:
            call = lambda: ab.fused_attn_block(xb, *wb, cs.HEADS, cs.DIM_HEAD)
            want = ab.attn_block_reference(xb.float(), *(t.float() for t in wb), cs.HEADS,
                                            cs.DIM_HEAD)
            cs.check_close(call(), want, 3e-2, 3e-2, f"{name} N={n} C={c}",
                           scale=torch.maximum(want.abs(), (want - xb.float()).abs()))
            ms = cs.time_ms(call)
            pl = ab.plan(cs.BATCH, n, c, cs.HEADS, torch.bfloat16)
            total += ms
            shapes.append(f"N{n} C{c} {ms:.4f} {pl.route} x{pl.splits}")
        print(f"{name}: {total:.4f} ms over the ten; " + "; ".join(shapes), flush=True)


@torch.no_grad()
def la_variants(cs) -> None:
    la = cs.la
    t0 = time.perf_counter()
    build = lambda v: build_variant(cs, v, "linear_attention", LA_TUNABLES, LA_COMMITTED)
    with ThreadPoolExecutor(len(LA_VARIANTS)) as pool:
        libs = {name_of(v): la.declare(ctypes.CDLL(str(lib)))
                for v, lib in zip(LA_VARIANTS, pool.map(build, LA_VARIANTS))}
    print(f"{len(libs)} variants built in {time.perf_counter() - t0:.1f} s", flush=True)
    device = torch.device("cuda")
    shapes = [s for s in cs.LA_SHAPES if s[0] == cs.BATCH]
    inputs = [cs.la_inputs(shape, torch.bfloat16, device, seed=100 + i)
              for i, shape in enumerate(shapes)]
    b, n, chunk = cs.TWOPASS_SHAPES[0]
    _, k7, v7 = cs.la_inputs((b, n, cs.HEADS, cs.DIM_HEAD), torch.bfloat16, device, seed=150)
    m7 = k7.amax(1).float().reshape(b, cs.F)
    call7 = lambda: la.linear_attention_ctx_twopass(k7, v7, m7, chunk)
    by_kernel = lambda dev: json.dumps({key.replace("void (anonymous namespace)::", "")[:60]: ms
                                        for key, ms in dev.items()})
    for name in [*libs, name_of(LA_COMMITTED)]:
        la._library = lambda lib=libs[name]: lib
        for plan in (la.la_plan, la.per_head_plan, la.twopass_plan):
            plan.cache_clear()
        for kernel, fn, plain in (("#6", la.linear_attention_fulllane, la.fulllane_reference),
                                  ("#9", la.linear_attention_per_head,
                                   la.linear_attention_reference)):
            times = []
            for shape, (q, k, v) in zip(shapes, inputs):
                cs.la_check(fn(q, k, v), plain(q, k, v), f"{name} {kernel} {shape}")
                ms = cs.time_ms(lambda: fn(q, k, v))
                times.append(f"{shape[1]}x{shape[2]}x{shape[3]} {ms:.4f}")
            q, k, v = inputs[0]
            print(f"{name} {kernel}: " + "; ".join(times) + " | by kernel at " + str(shapes[0])
                  + ": " + by_kernel(cs.device_ms(lambda: fn(q, k, v))), flush=True)
        (a, s), (ra, rs) = call7(), la.ctx_twopass_reference(k7, v7, m7)
        cs.la_check(a, ra, f"{name} #7 a")
        cs.la_check(s, rs, f"{name} #7 s")
        print(f"{name} #7: {n}x{cs.HEADS}x{cs.DIM_HEAD} {cs.time_ms(call7, reps=10):.4f} | by "
              f"kernel at {(b, n, cs.HEADS, cs.DIM_HEAD)}: " + by_kernel(cs.device_ms(call7)),
              flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", type=Path, default=HERE)
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--variants", action="store_true")
    mode.add_argument("--forward", action="store_true")
    mode.add_argument("--la", action="store_true")
    mode.add_argument("--la-turns", type=Path, metavar="PARENT")
    mode.add_argument("--la-variants", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("attn_variants: no CUDA device", file=sys.stderr)
        return 1
    if args.la_turns:
        la_turns(args.la_turns.resolve(), args.root.resolve())
        return 0
    cs = load_smoke(args.root.resolve())
    print(cs.card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.variants:
        variants(cs)
    elif args.forward:
        forward(cs, args.root)
    elif args.la:
        la_times(cs, args.root)
    elif args.la_variants:
        la_variants(cs)
    else:
        host_and_device(cs, args.root)
    return 0


if __name__ == "__main__":
    sys.exit(main())
