"""The port stands alone: no JAX, no ccdm_tpu, no quiet fallback to the CPU.

The import check runs in a subprocess, because tests/conftest.py imports JAX
into the test process.
"""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ccdm_tpu_torch import ccgan_main, classgan_main, dmd_main, main, serve, serve_dmd
from ccdm_tpu_torch.opts import parse_opts
from ccdm_tpu_torch.utils.device import resolve_device

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SMALL_ARGV = ["--image_size", "16", "--model_channels", "8", "--channel_mult", "1_2",
              "--train_timesteps", "20", "--sample_timesteps", "2", "--device", "cpu"]

_IMPORT_CHECK = """
import ast, importlib, json, pkgutil, sys
sys.path.insert(0, {root!r})
before = set(sys.modules)
import ccdm_tpu_torch
names = [m.name for m in pkgutil.walk_packages(ccdm_tpu_torch.__path__, "ccdm_tpu_torch.")]
for name in names:
    importlib.import_module(name)
tree = ast.parse(open({smoke!r}).read())
for node in tree.body:
    if isinstance(node, (ast.Import, ast.ImportFrom)):
        exec(compile(ast.Module([node], []), "chip_smoke.py", "exec"), {{}})
print(json.dumps({{"modules": names, "new": sorted(set(sys.modules) - before)}}))
"""


def _is_jax(name):
    return name.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "ccdm_tpu")


def test_port_and_smoke_script_import_no_jax():
    code = _IMPORT_CHECK.format(root=str(ROOT), smoke=str(ROOT / "chip_smoke.py"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT, check=True)
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(report["modules"]) >= 20, report["modules"]
    for name in ("serve", "main", "ops.vicinal", "training.vicinity", "training.hyperparams",
                 "training.trainer", "training.state", "utils.ckpt", "utils.logging",
                 "data.datasets", "ops.attn_block", "ops.linear_attention", "ops.style_ops",
                 "embedding.ili", "embedding.resolve", "embedding.analytic",
                 "models.resnet_embed", "data.power", "embedding.combine", "models.aux_net",
                 "training.train_aux", "training.optim", "eval.metrics", "eval.sfid",
                 "eval.niqe", "eval.backbones", "eval.train_backbones", "eval.protocol",
                 "eval.analysis", "dmd_main", "serve_dmd", "models.sngan", "models.sagan",
                 "training.diffaugment", "training.dmd", "models.unet_adm", "models.vit",
                 "diffusion.respace", "diffusion.guided", "training.resample",
                 "training.classgan", "training.ccgan", "training.gan_config",
                 "utils.kvlogger", "ccgan_main", "classgan_main", "parallel",
                 "parallel.mesh", "data.native_loader", "ops.upsample_fold",
                 "utils.profiling"):
        assert f"ccdm_tpu_torch.{name}" in report["new"], name
    assert [m for m in report["new"] if _is_jax(m)] == []


def test_no_source_names_jax_or_the_jax_package():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|orbax|ccdm_tpu)(\.|\s|$)",
                         re.M)
    files = [*sorted((ROOT / "ccdm_tpu_torch").rglob("*.py")), ROOT / "chip_smoke.py"]
    assert len(files) >= 20
    for path in files:
        assert not pattern.search(path.read_text()), path


def test_parser_takes_every_flag_of_the_jax_parser():
    """Every flag of ccdm_tpu.opts.parse_opts, with the same default; the
    port adds --device only, and parses JAX's inert flags too."""
    from ccdm_tpu.opts import INERT_FLAGS as JAX_INERT
    from ccdm_tpu.opts import parse_opts as jax_parse_opts

    want, got = vars(jax_parse_opts([])), vars(parse_opts([]))
    assert set(got) - set(want) == {"device"}
    assert {k: got[k] for k in want} == want
    assert set(JAX_INERT) <= set(got)
    flags = ["--num_res_blocks", "3", "--num_groups", "16", "--attention_resolutions", "4_8",
             "--num_workers", "4", "--tb_log"]
    assert vars(jax_parse_opts(flags)) == {k: v for k, v in vars(parse_opts(flags)).items()
                                           if k != "device"}


@pytest.mark.parametrize("entry", ["ccgan_main", "classgan_main"])
def test_baseline_parsers_take_every_flag_of_the_jax_parsers(entry):
    """Every flag of ccdm_tpu's ccgan_main and classgan_main parsers, with
    the same defaults and choices; the port adds --device only."""
    import importlib

    jax_entry = importlib.import_module(f"ccdm_tpu.{entry}")
    port_entry = {"ccgan_main": ccgan_main, "classgan_main": classgan_main}[entry]
    name = f"parse_opts_{entry.removesuffix('_main')}"
    jax_parse, parse = getattr(jax_entry, name), getattr(port_entry, name)
    want, got = vars(jax_parse([])), vars(parse([]))
    assert set(got) - set(want) == {"device"}
    assert {k: got[k] for k in want} == want
    flags = (["--gan_arch", "sagan", "--threshold_type", "soft", "--loss_type", "vanilla",
              "--nda_b", "0.2", "--gan_DiffAugment", "--dump_fake_data", "--comp_FID"]
             if entry == "ccgan_main" else
             ["--method", "admg", "--cond_loss", "adc", "--gan_DiffAugment",
              "--dump_fake_data", "--comp_FID", "--classifier_scale", "2.0"])
    assert vars(jax_parse(flags)) == {k: v for k, v in vars(parse(flags)).items()
                                      if k != "device"}
    bad = ["--gan_arch", "biggan"] if entry == "ccgan_main" else ["--method", "gan"]
    for p in (jax_parse, parse):
        with pytest.raises(SystemExit):
            p(bad)


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.SamplerService(parse_opts(SMALL_ARGV[:-2]), warm=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(SMALL_ARGV[:-2])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dmd_main.main(["--niters", "0"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_dmd.main(["--serve_milestone", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ccgan_main.main(["--niters", "0"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        classgan_main.main(["--niters", "0"])
    assert resolve_device("cpu") == torch.device("cpu")
    # the env triplet of a multi-process run: without a card and without
    # --device cpu every entry point raises before it starts gloo on the CPU
    monkeypatch.setenv("CCDM_COORD_ADDR", "localhost:1")
    monkeypatch.setenv("CCDM_NUM_PROCS", "2")
    monkeypatch.setenv("CCDM_PROC_ID", "0")
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda *a, **k: pytest.fail("a process group was started on the CPU"))
    for entry in (main.main, dmd_main.main, ccgan_main.main, classgan_main.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry(["--niters", "0"])


@pytest.mark.parametrize("flags", [["--architecture", "vit"], ["--architecture", "adm"],
                                   ["--label_dim", "2"]])
def test_options_of_later_slices_raise(flags, tmp_path):
    """All three options are ported (the ADM and ViT denoisers since their
    slice; they raised before it): each builds the service and generates;
    --label_dim 2 builds the multi-dim embedding and serves 1-D labels
    through dim 0's."""
    argv = SMALL_ARGV + ["--root_path", str(tmp_path)] + flags
    service = serve.SamplerService(parse_opts(argv), max_batch=2, warm=False, device="cpu")
    if flags[0] == "--architecture":
        assert type(service.diffusion.model).__name__ == {"vit": "ViT", "adm": "ADMUnet"}[flags[1]]
    else:
        assert service.fn_y2h(torch.tensor([[0.3, 0.6]])).shape == (1, 128)
    images = service.generate(np.array([0.3, 0.6], np.float32))
    assert images.dtype == np.uint8 and images.shape == (2, 16, 16, 3)


@pytest.mark.parametrize("flags", [["--use_Hy", "--y2cov_embed_type", "sinusoidal"],
                                   ["--y2h_embed_type", "gaussian"]])
def test_options_of_this_slice_build_the_service(flags, tmp_path):
    service = serve.SamplerService(parse_opts(SMALL_ARGV + ["--root_path", str(tmp_path)] + flags),
                                   max_batch=2, warm=False, device="cpu")
    images = service.generate(np.array([0.3, 0.6], np.float32))
    assert images.dtype == np.uint8 and images.shape == (2, 16, 16, 3)
    assert service.diffusion.config.use_Hy == ("--use_Hy" in flags)


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True, text=True,
                          timeout=300, cwd=cwd)


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the smoke script would run")
    out = _run_smoke(ROOT)
    assert out.returncode != 0 and '"ok"' not in out.stdout


def test_chip_smoke_fails_without_the_repo(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    assert out.returncode != 0 and '"ok"' not in out.stdout
