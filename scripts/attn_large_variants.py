#!/usr/bin/env python3
"""Kernels #2-#5 (the two-pass block's forward and fused backward) on one
card, and the training step around them.

    python3 scripts/attn_large_variants.py [--root DIR]
        [--variants | --train [--recipe] | --train-turns PARENT | --recipe-turns]

Times the wrappers of the ccdm_tpu_torch package under DIR (default: this
checkout; another commit unpacked with `git archive` under build/ times
that commit's wrappers with this checkout's helpers):
- default: #2, #3, #4 and #5 in bf16 at chip_smoke.LARGE_SHAPES (B 128, B
  32 at N 36864; phase 6's inputs): the event time of 20 back-to-back calls
  (chip_smoke.time_ms), the host's time to issue one (host_ms) and the
  card's own time by kernel name from torch.profiler (device_ms), as JSON
  lines, with the plan each call took;
- --variants: builds csrc/attn_block_large.cu with its tunable substituted
  (kWgradBlocks, the blocks of #5's dWqkv launch) in parallel into
  build/attn_large_variants/, then times #4 and #5 at B 128, N 4096, C 64
  and C 128 for each in turns (the committed values first and last), each
  held to its plain version at phase 6's bf16 bound first;
- --train: the training main path of chip_smoke's phase 8 (`python -m
  ccdm_tpu_torch.main`, batch 128, bf16), 35 steps: the warm images/s of
  the logged windows after step 10 up to step 30 (phase 8's), then one
  warm step (33) under torch.profiler (the card's activity only): the
  card's time by kernel, split into #2-#5 (the kernels of
  csrc/attn_block_large.cu) and the rest, and the card's idle share of
  the warm step's time (batch / warm images/s);
- --train-turns PARENT: --train in four processes, PARENT, DIR, DIR,
  PARENT, to compare two commits' training on one card;
- --train --recipe: the same with the CCDM recipe's flags
  (chip_smoke.RECIPE_FLAGS: resnet ILI, trained first in the process, and
  --use_Hy), so the profiled step includes fn_y2cov and H(y);
- --recipe-turns: --train without, with, with and without --recipe, each
  its own process, to put the recipe's warm rate beside phase 8's in turns.
Needs the card.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
TUNABLES = {"kWgradBlocks": "constexpr int kWgradBlocks = {};"}
COMMITTED = {"kWgradBlocks": 264}
VARIANTS = [COMMITTED, {"kWgradBlocks": 132}, {"kWgradBlocks": 528}]
VARIANT_SHAPES = [(4096, 64), (4096, 128)]
# the kernels of csrc/attn_block_large.cu, by the TPU kernel they serve
GROUPS = {"#2": ("ctx_partial_kernel", "ctx_reduce_kernel", "ctx_tc_kernel", "ctx_merge_kernel"),
          "#3": ("out_large_kernel", "out_tc_kernel"),
          "#4": ("bwd_a_kernel", "bwd_a_tc_kernel"),
          "#5": ("bwd_b_kernel", "bwd_b_tc_kernel", "wgrad_kernel", "wgrad_tc_kernel"),
          "#4/#5 sums": ("sum_parts_kernel",)}
PROFILE_STEP, TRAIN_STEPS = 33, 35
LARGE = ("attn_ctx_large", "attn_out_large", "attn_bwd_a", "attn_bwd_b")


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


def large_calls(cs, n: int, c: int, batch: int, seed: int):
    """Phase 6's bf16 inputs at (n, c, batch): the calls of #2-#5 and their
    plain versions."""
    ab, device = cs.attn_block, torch.device("cuda")
    x, w = cs.block_inputs(n, c, batch, device, seed=20 + seed, x_std=1.0)
    g = torch.Generator().manual_seed(40 + seed)
    x = x.bfloat16()
    dy = torch.randn(batch, n, c, generator=g).to(device).bfloat16()
    g_pre, wqkv, wout, bout, g_out = w
    ra, rs, rkmax = ab.ctx_large_reference(x, g_pre, wqkv, cs.HEADS)
    ctx = ab.finalize_ctx(ra, rs, x.dtype)
    args_a = (x, dy, g_pre, wqkv, ctx, wout, bout, g_out, cs.HEADS)
    do, d_ctx, *_ = ab.bwd_a_reference(*args_a)
    d_a, d_s = ab.finalize_ctx_backward(d_ctx, ra, rs)
    args_b = (x, dy, do, g_pre, wqkv, ctx, wout, rkmax, d_a, d_s, cs.HEADS)
    args_out = (x, g_pre, wqkv, ctx, wout, bout, g_out, cs.HEADS)
    return {"attn_ctx_large": (lambda: ab.attn_ctx_large(x, g_pre, wqkv, cs.HEADS),
                               lambda: ab.ctx_large_reference(x, g_pre, wqkv, cs.HEADS)),
            "attn_out_large": (lambda: ab.attn_out_large(*args_out),
                               lambda: ab.out_large_reference(*args_out)),
            "attn_bwd_a": (lambda: ab.attn_bwd_a(*args_a), lambda: ab.bwd_a_reference(*args_a)),
            "attn_bwd_b": (lambda: ab.attn_bwd_b(*args_b), lambda: ab.bwd_b_reference(*args_b))}


@torch.no_grad()
def host_and_device(cs, root: Path) -> None:
    for i, (n, c) in enumerate(cs.LARGE_SHAPES):
        batch = cs.LARGE_BATCH.get((n, c), cs.TRAIN_BATCH)
        for name, (kernel, _) in large_calls(cs, n, c, batch, i).items():
            kernel_no = 2 + LARGE.index(name)
            plan = None  # the plan, where the tree has one
            if hasattr(cs.attn_block, "large_plan"):
                plan = cs.attn_block.large_plan(kernel_no, batch, n, c, cs.HEADS, torch.bfloat16)
            row = split(cs, kernel)
            bound = max(cs.large_bound_parts(name, n, c, batch))
            print(json.dumps({"root": str(root), "kernel": name, "N": n, "C": c, "B": batch,
                              "plan": plan and plan._asdict(), "bound_ms": bound,
                              "share_of_bound": bound / row["ms"], **row}), flush=True)
        torch.cuda.empty_cache()


def name_of(v: dict) -> str:
    return "_".join(f"{k}{v[k]}" for k in TUNABLES)


def build_variant(cs, v: dict) -> Path:
    src = (cs._build.CSRC_DIR / "attn_block_large.cu").read_text()
    for key, decl in TUNABLES.items():
        committed = decl.format(COMMITTED[key])
        if committed not in src:
            raise RuntimeError(f"csrc/attn_block_large.cu no longer declares `{committed}`")
        src = src.replace(committed, decl.format(v[key]), 1)
    out = HERE / "build" / "attn_large_variants"
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
        libs = {name_of(v): ab.declare_large(ctypes.CDLL(str(lib)))
                for v, lib in zip(VARIANTS, pool.map(lambda v: build_variant(cs, v), VARIANTS))}
    print(f"{len(libs)} variants built in {time.perf_counter() - t0:.1f} s", flush=True)
    calls = {(n, c): {k: v for k, v in large_calls(cs, n, c, cs.TRAIN_BATCH, i).items()
                      if k in ("attn_bwd_a", "attn_bwd_b")}
             for i, (n, c) in enumerate(VARIANT_SHAPES)}
    for name in [*libs, name_of(COMMITTED)]:
        ab._large_library = lambda lib=libs[name]: lib
        ab.large_plan.cache_clear()
        times = []
        for (n, c), by_kernel in calls.items():
            for kernel_name, (kernel, plain) in by_kernel.items():
                for i, (gv, wv) in enumerate(zip(kernel(), plain())):
                    cs._check_grad(gv, wv, torch.bfloat16, f"{name} {kernel_name} N={n} C={c} #{i}")
                times.append(f"{kernel_name} C{c} {cs.time_ms(kernel):.4f}")
        print(f"{name}: " + "; ".join(times), flush=True)


def train(cs, root: Path, recipe: bool = False) -> None:
    """--train: phase 8's training path (with `recipe`, phase 18's flags)
    with one profiled warm step."""
    from ccdm_tpu_torch import main as port_main
    from ccdm_tpu_torch.training import trainer as tr

    run = HERE / "build" / "attn_large_variants_run"
    shutil.rmtree(run, ignore_errors=True)
    argv = ["--root_path", str(run), "--device", "cuda", *cs.TRAIN_ARGV,
            *(cs.RECIPE_FLAGS if recipe else []),
            "--niters", str(TRAIN_STEPS), "--save_every", str(TRAIN_STEPS)]
    step_of, profiled = tr.Trainer.train_step, {}

    def train_step(self, *args, **kwargs):
        if self.state.step + 1 != PROFILE_STEP:
            return step_of(self, *args, **kwargs)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = step_of(self, *args, **kwargs)
            torch.cuda.synchronize()
            profiled["step_ms"] = (time.perf_counter() - t0) * 1e3
        profiled["by_kernel"] = {e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()
                                 if e.self_device_time_total > 0}
        return out

    tr.Trainer.train_step = train_step
    try:
        port_main.main(argv)
        torch.cuda.synchronize()
        log = [json.loads(line) for line in
               open(Path(port_main.results_folder(cs.parse_opts(argv))) / "train_log.jsonl")]
    finally:
        tr.Trainer.train_step = step_of
        shutil.rmtree(run, ignore_errors=True)
    windows = [r["imgs_per_sec"] for r in log if cs.TRAIN_STEPS // 3 < r["step"] <= cs.TRAIN_STEPS]
    by_kernel = profiled["by_kernel"]
    groups = {g: 0.0 for g in GROUPS}
    for key, ms in by_kernel.items():
        for g, names in GROUPS.items():
            if any(re.search(rf"::{k}[<(]", key) for k in names):
                groups[g] += ms
    device = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    warm = sum(windows) / len(windows)
    warm_step_ms = cs.TRAIN_BATCH / warm * 1e3
    print(json.dumps({
        "root": str(root), "recipe": recipe, "card": cs.card_line(),
        "warm_images_per_s": warm, "windows_images_per_s": windows, "warm_step_ms": warm_step_ms,
        "profiled_step": PROFILE_STEP, "profiled_step_ms": profiled["step_ms"],
        "device_ms": device, "device_idle_share_of_warm_step": 1 - device / warm_step_ms,
        "device_ms_by_group": groups,
        "rest_device_ms": device - sum(groups.values()),
        "top_kernels": [[k[:120], ms] for k, ms in top]}), flush=True)


def train_turns(runs: list) -> None:
    """--train in turns, each (root, extra flags) of `runs` its own process."""
    rows = []
    for r, extra in runs:
        proc = subprocess.run([sys.executable, str(HERE / "scripts" / "attn_large_variants.py"),
                               "--root", str(r), "--train", *extra],
                              capture_output=True, text=True)
        line = [s for s in proc.stdout.splitlines() if s.startswith("{")]
        if proc.returncode or not line:
            raise RuntimeError(f"--train for {r} {extra} failed:\n{proc.stdout[-4000:]}"
                               f"{proc.stderr[-4000:]}")
        rows.append(json.loads(line[-1]))
        print(line[-1], flush=True)
    print(json.dumps({"turns": [[row["root"], row["recipe"], row["warm_images_per_s"],
                                 row["device_ms_by_group"], row["device_ms"],
                                 row["device_idle_share_of_warm_step"]] for row in rows]}),
          flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", type=Path, default=HERE)
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--variants", action="store_true")
    mode.add_argument("--train", action="store_true")
    mode.add_argument("--train-turns", type=Path, metavar="PARENT")
    mode.add_argument("--recipe-turns", action="store_true")
    parser.add_argument("--recipe", action="store_true", help="with --train: phase 18's flags")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("attn_large_variants: no CUDA device", file=sys.stderr)
        return 1
    if args.train_turns:
        parent, root = args.train_turns.resolve(), args.root.resolve()
        train_turns([(parent, []), (root, []), (root, []), (parent, [])])
        return 0
    if args.recipe_turns:
        root = args.root.resolve()
        train_turns([(root, []), (root, ["--recipe"]), (root, ["--recipe"]), (root, [])])
        return 0
    cs = load_smoke(args.root.resolve())
    print(cs.card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.variants:
        variants(cs)
    elif args.train:
        train(cs, args.root, args.recipe)
    else:
        host_and_device(cs, args.root)
    return 0


if __name__ == "__main__":
    sys.exit(main())
