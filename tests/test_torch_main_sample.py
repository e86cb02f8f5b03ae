"""The port's post-training sampling end to end on the CPU, at a tiny size,
held against the JAX entry run with the same flags.

`python -m ccdm_tpu_torch.main` and `python -m ccdm_tpu.main` each train 2
steps with an EMA grid at step 2, then sample 3 images for each of 2 eval
labels (--eval_mode 4) in batches of 2 (the padded path) into <label>.h5
dumps and sample_<label>.png grids (ccdm_tpu/main.py:309-360). The two runs
must leave the same files: the same dump folder, h5 keys, dtypes,
compression, labels and image shapes, and PNG grids of the same size. A
rerun of each skips every label whose h5 exists and prints its cached
sample_time_i. The serving path answers with the ancestral sampler.
"""

import builtins
import os
import re

import numpy as np
import pytest
import torch

from ccdm_tpu_torch import main as port_main
from ccdm_tpu_torch.opts import parse_opts
from ccdm_tpu_torch.serve import SamplerService
from ccdm_tpu_torch.training import trainer as trainer_module

h5py = pytest.importorskip("h5py")
Image = pytest.importorskip("PIL.Image")
torch.set_num_threads(2)

# the flags both entries take; the port adds --device cpu
ARGV = ["--image_size", "16", "--model_channels", "8", "--channel_mult", "1_2",
        "--train_timesteps", "20", "--sample_timesteps", "2", "--pred_objective", "pred_x0",
        "--data_name", "synthetic", "--synthetic_n", "64",
        "--train_batch_size", "8", "--vicinity_type", "hv", "--log_every", "1",
        "--niters", "2", "--save_every", "2", "--sample_every", "2", "--eval_mode", "4",
        "--FID_num_centers", "2", "--nfake_per_label", "3", "--samp_batch_size", "2",
        "--dump_fake_data"]
PORT_ARGV = [*ARGV, "--device", "cpu"]
LABEL_LINE = re.compile(r"\] label ([0-9.e+-]+): ([0-9.]+)s")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    argv = ["--root_path", str(tmp_path_factory.mktemp("port")), *PORT_ARGV]
    port_main.main(argv)
    args = parse_opts(argv)
    return argv, port_main.results_folder(args), port_main.fake_data_folder(args, 2)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    from ccdm_tpu import main as jax_main

    root = str(tmp_path_factory.mktemp("jax"))
    argv = ["--root_path", root, *ARGV]
    jax_main.main(argv)
    return argv, os.path.join(root, "output", "synthetic_16", "Setup1", "results")


def _outputs(results: str) -> list[str]:
    """The PNG and h5 files under a results folder, relative to it."""
    return sorted(os.path.relpath(os.path.join(d, f), results)
                  for d, _, files in os.walk(results) for f in files
                  if f.endswith((".png", ".h5")))


def _h5(path: str) -> dict:
    with h5py.File(path, "r") as f:
        return {k: (f[k][:], f[k].compression, f[k].compression_opts) for k in f}


def test_dumps_grids_and_the_visual_grid(run, jax_run):
    _, results, dump = run
    _, jax_results = jax_run
    files = _outputs(results)
    assert files == _outputs(jax_results)
    assert os.path.relpath(dump, results) in {os.path.dirname(f) for f in files}
    assert sum(f.endswith(".h5") for f in files) == 2
    for name in files:
        ours, theirs = os.path.join(results, name), os.path.join(jax_results, name)
        if name.endswith(".png"):
            assert Image.open(ours).size == Image.open(theirs).size, name
            assert Image.open(ours).mode == Image.open(theirs).mode, name
            continue
        got, want = _h5(ours), _h5(theirs)
        assert set(got) == set(want) == {"fake_images_i", "fake_labels_i", "sample_time_i"}
        for key in want:
            (a, a_comp, a_opts), (b, b_comp, b_opts) = got[key], want[key]
            assert (a.dtype, a.shape, a_comp, a_opts) == (b.dtype, b.shape, b_comp, b_opts), \
                (name, key)
        np.testing.assert_array_equal(got["fake_labels_i"][0], want["fake_labels_i"][0])
        assert got["sample_time_i"][0][0] > 0


def _skipped(out: str, dump: str) -> dict:
    """label -> printed time of each label of a rerun, checked against the
    sample_time_i cached in its h5."""
    printed = {float(label): float(t) for label, t in LABEL_LINE.findall(out)}
    for label, t in printed.items():
        with h5py.File(os.path.join(dump, f"{label}.h5"), "r") as f:
            assert t == pytest.approx(float(f["sample_time_i"][0]), abs=5e-3), (label, out)
    return printed


def test_rerun_skips_the_existing_dumps(run, jax_run, monkeypatch, capsys):
    from ccdm_tpu.training.trainer import Trainer

    argv, _, dump = run
    jax_argv, jax_results = jax_run

    def refuse(*a, **kw):
        raise AssertionError("a label with an h5 dump was sampled again")

    monkeypatch.setattr(trainer_module, "sample_given_labels", refuse)
    monkeypatch.setattr(Trainer, "sample_given_labels", refuse)
    from ccdm_tpu import main as jax_main

    capsys.readouterr()
    port_main.main([*argv, "--resume_niter", "2"])
    out = capsys.readouterr().out
    jax_main.main([*jax_argv, "--resume_niter", "2"])
    jax_out = capsys.readouterr().out
    assert "resumed from milestone 2" in out and "resumed from milestone 2" in jax_out
    jax_dump = os.path.join(jax_results, os.path.basename(dump))
    ours, theirs = _skipped(out, dump), _skipped(jax_out, jax_dump)
    assert sorted(ours) == sorted(theirs) and len(ours) == 2, (out, jax_out)


def test_h5_writer_without_h5py_says_so(tmp_path, monkeypatch):
    real_import = builtins.__import__

    def no_h5py(name, *a, **kw):
        if name == "h5py":
            raise ImportError("no h5py")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_h5py)
    with pytest.raises(ImportError, match="--dump_fake_data needs the h5py package"):
        port_main.write_fake_h5(str(tmp_path / "x.h5"), np.zeros((1, 4, 4, 3), np.uint8),
                                np.zeros(1), 0.0)


def test_service_answers_with_the_ancestral_sampler():
    argv = ARGV[:10] + ["--device", "cpu", "--seed", "3"]
    ddpm = SamplerService(parse_opts(argv + ["--sampler", "ddpm"]), max_batch=2, warm=False,
                          device="cpu")
    ddim = SamplerService(parse_opts(argv), max_batch=2, warm=False, device="cpu")
    labels = np.array([0.2, 0.7], np.float32)
    a, b = ddpm.generate(labels, seed=1), ddim.generate(labels, seed=1)
    assert a.dtype == np.uint8 and a.shape == (2, 16, 16, 3)
    np.testing.assert_array_equal(a, ddpm.generate(labels, seed=1))
    assert not np.array_equal(a, b)
