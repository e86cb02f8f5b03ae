"""The port's eval entry end to end on the CPU, and the dataset bundles
built from arrays (ccdm_tpu_torch/main.py --comp_FID, --dump_fake_for_NIQE;
data/datasets.py *_from_arrays).

- Each h5 loader's constructor from arrays, on the arrays of an h5 file
  the test writes in the real dataset's keys, equals ccdm_tpu's loader of
  that file: images, raw labels and the eval set exactly, the normalised
  labels and the closures to 1e-6 (as tests/test_torch_datasets.py).
- `python -m ccdm_tpu_torch.main` at 16x16 on a SteeringAngle bundle
  built from rendered arrays (only the h5 read is replaced; signed labels)
  trains 2 steps, samples every eval label, and scores the fakes with
  every metric and analysis flag, the eval ResNets cut to one block a
  stage: every metric line finite, the analysis files written; a rerun
  from the milestone reads the fakes back from the h5 dumps, loads the
  pinned backbones and NIQE model, and writes the same metric lines.
- --dump_fake_for_NIQE writes JAX's file names ({i}_{label}.png over the
  concatenated labels, ccdm_tpu/main.py:371-384), and PIL decodes each to
  the fake's pixels: RGB as 3-D, grayscale (Cell-200) as 2-D.
"""

import importlib.util
import os
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from ccdm_tpu.data import datasets as jax_datasets
from ccdm_tpu_torch import main as port_main
from ccdm_tpu_torch.data import datasets
from ccdm_tpu_torch.eval import train_backbones as tb
from ccdm_tpu_torch.opts import parse_opts

h5py = pytest.importorskip("h5py")
Image = pytest.importorskip("PIL.Image")

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SIZE = 32
ANGLES = np.repeat(np.linspace(-70.0, 70.0, 8), 3)
COUNTS = np.repeat(np.arange(1, 13), 3)


def _example(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _roads(angles, size, seed):
    road = _example("make_fixture_sa64").render_road
    rng = np.random.default_rng(seed)
    return np.stack([road(float(a), size, rng) for a in angles])


def _cells(counts, size, seed):
    cells = _example("make_fixture_cell200").render_cells
    rng = np.random.default_rng(seed)
    return np.stack([cells(int(c), size, rng) for c in counts])[:, None]


# -------------------------------------------------------- bundles from arrays


def _same(got, want):
    for name in ("images", "labels_raw", "eval_images", "eval_labels_raw"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    assert got.name == want.name and got.images.dtype == np.uint8
    np.testing.assert_allclose(got.labels_norm, want.labels_norm, rtol=1e-6, atol=1e-6)
    probe = np.linspace(want.labels_raw.min(), want.labels_raw.max(), 7)
    np.testing.assert_allclose(got.fn_normalize(probe), want.fn_normalize(probe), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(got.fn_denormalize(got.labels_norm),
                               want.fn_denormalize(want.labels_norm), rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def h5_arrays(tmp_path_factory):
    """{name: (data_path, arrays)}: each dataset's h5 file and the arrays in it."""
    path = tmp_path_factory.mktemp("h5")
    rng = np.random.default_rng(5)
    out = {}
    sa = (_roads(ANGLES, SIZE, 1), ANGLES)
    cell = (_cells(COUNTS, SIZE, 2), COUNTS.astype(np.int64))
    ages = np.repeat(np.arange(1, 9), 3)
    utk = (rng.integers(0, 256, (len(ages), 3, SIZE, SIZE), dtype=np.uint8), ages)
    rc_labels = np.repeat(np.linspace(0.5, 89.5, 10), 3)
    rc = (rng.integers(0, 256, (len(rc_labels), 3, SIZE, SIZE), dtype=np.uint8), rc_labels,
          np.sort(rng.choice(len(rc_labels), 20, replace=False)))
    files = {"SteeringAngle": (sa, ("images", "labels")), "Cell200": (cell, ("IMGs_grey",
                                                                            "CellCounts")),
             "UTKFace": (utk, ("images", "labels")),
             "RC-49": (rc, ("images", "labels", "indx_train"))}
    for name, (arrays, keys) in files.items():
        with h5py.File(path / f"{name}_{SIZE}x{SIZE}.h5", "w") as f:
            for key, a in zip(keys, arrays):
                f.create_dataset(key, data=a)
        out[name] = arrays
    return str(path), out


@pytest.mark.parametrize("name,kw", [
    ("SteeringAngle", dict()),
    ("SteeringAngle", dict(min_label=-60.0, max_label=65.0, max_num_img_per_label=2)),
    ("Cell200", dict(max_label=12)),
    ("Cell200", dict(min_label=2, max_label=11, stepsize=3, num_imgs_per_label=2)),
    ("UTKFace", dict(min_label=2, max_label=7, max_num_img_per_label=2,
                     num_img_per_label_after_replica=3)),
    ("RC-49", dict(max_num_img_per_label=2)),
    ("RC-49", dict(min_label=10.0, max_label=80.0, data_split="all")),
])
def test_bundle_from_arrays_is_jaxs_loader(h5_arrays, name, kw):
    path, arrays = h5_arrays
    build = {"SteeringAngle": datasets.steeringangle_from_arrays,
             "Cell200": datasets.cell200_from_arrays, "UTKFace": datasets.utkface_from_arrays,
             "RC-49": datasets.rc49_from_arrays}[name]
    want = jax_datasets.load_dataset(name, path, image_size=SIZE, **kw)
    _same(build(*arrays[name], **kw), want)
    _same(datasets.load_dataset(name, path, image_size=SIZE, **kw), want)


# ------------------------------------------------------------ main.py, eval

MODEL = ["--image_size", "16", "--model_channels", "8", "--channel_mult", "1_2",
         "--train_timesteps", "20", "--pred_objective", "pred_x0", "--device", "cpu",
         "--train_batch_size", "16", "--vicinity_type", "hv", "--log_every", "1",
         "--sample_timesteps", "2", "--nfake_per_label", "2", "--samp_batch_size", "2",
         "--niters", "2", "--save_every", "2", "--dump_fake_data"]
SA = ["--data_name", "SteeringAngle", "--min_label", "-80", "--max_label", "80"]
EVAL = ["--comp_FID", "--FID_radius", "25", "--FID_num_centers", "3", "--comp_prdc",
        "--prdc_nearest_k", "2", "--comp_niqe", "--comp_intra_fid", "--knn_analysis",
        "--frequency_analysis", "--tsne_analysis", "--GAN_train", "--GAN_test",
        "--epochs_eval_ae", "1", "--epochs_eval_cnn", "1"]


@pytest.fixture
def in_memory(monkeypatch):
    """The h5 reads replaced by rendered arrays at 16x16 (render at 32,
    2x2 means): the bundles are built by the port's constructors."""
    def shrink(images):
        n, c = images.shape[:2]
        return images.reshape(n, c, 16, 2, 16, 2).mean((3, 5)).round().astype(np.uint8)

    monkeypatch.setattr(datasets, "read_steeringangle",
                        lambda path, size: (shrink(_roads(ANGLES, 32, 3)), ANGLES.copy()))
    monkeypatch.setattr(datasets, "read_cell200",
                        lambda path, size: (shrink(_cells(COUNTS, 32, 4)), COUNTS.astype(float)))
    monkeypatch.setattr(tb, "EVAL_RESNET_BLOCKS", (1, 1, 1, 1))


def _metric_lines(path):
    return [line for line in Path(path).read_text().splitlines()
            if line.strip() and not line.startswith("Namespace(")]


def test_comp_fid_end_to_end_on_signed_labels(in_memory, tmp_path, capsys):
    argv = ["--root_path", str(tmp_path), "--eval_ckpt_path", str(tmp_path), *MODEL, *SA, *EVAL]
    trainer = port_main.main(argv)
    out = capsys.readouterr().out
    setting = Path(port_main.results_folder(parse_opts(argv))).parent
    lines = _metric_lines(setting / "eval_results_niters2.txt")
    names = [line.split(":")[0].strip() for line in lines[1:]]
    assert names == ["Eval backbones", "Radius", "Sampling Steps", "Sampling Time", "SFID",
                     "LS", "Diversity", "FID", "PRDC (k=2, equal-N)",
                     "PRDC real-vs-real control (split-half)",
                     "NIQE (native, dataset-calibrated)", "NIQE real-vs-real control (held-out)",
                     "Intra-class FID"]
    numbers = [float(v) for line in lines[5:] for v in re.findall(r"-?\d+\.\d+", line)]
    assert len(numbers) >= 20 and np.isfinite(numbers).all()
    assert lines[1].startswith(" Eval backbones: evalnets_SteeringAngle_16_seed111:")
    result = trainer.eval_results
    assert result["fingerprint"] in lines[1] and np.isfinite(result["sfid"][0])
    for name in ("knn_grid.png", "frequency_spectrum.npz", "frequency_spectrum.png", "tsne.npz"):
        assert (setting / "analysis" / name).is_file(), name
    cas = [float(v) for v in re.findall(r"CAS GAN_t(?:rain|est) \(.*?\): ([\d.]+)", out)]
    assert len(cas) == 2 and all(0.0 <= v <= 1.0 for v in cas)
    assert (setting / "fid_ls_entropy_over_centers_sampstep2.npz").is_file()

    again = port_main.main([*argv, "--resume_niter", "2"])
    out = capsys.readouterr().out
    assert "resumed from milestone 2" in out and "LOADED pinned checkpoint" in out
    lines2 = _metric_lines(setting / "eval_results_niters2.txt")
    assert len(lines2) == 2 * len(lines)
    assert lines2[len(lines):][:1] == lines[:1]
    for a, b in zip(lines[1:], lines2[len(lines) + 1:]):
        if not a.startswith(" Sampling Time"):  # the rerun reads the sample times back
            assert a == b
    assert again.eval_results["fid"] == result["fid"]


@pytest.mark.parametrize("data", ["SteeringAngle", "Cell200"])
def test_dump_fake_for_niqe_writes_jaxs_names(in_memory, tmp_path, data):
    flags = SA if data == "SteeringAngle" else [
        "--data_name", "Cell200", "--min_label", "1", "--max_label", "12", "--stepsize", "1",
        "--num_imgs_per_label", "2", "--num_channels", "1"]
    argv = ["--root_path", str(tmp_path), *MODEL, *flags, "--dump_fake_for_NIQE"]
    port_main.main(argv)
    args = parse_opts(argv)
    bundle = datasets.load_dataset(args.data_name, args.data_path,
                                   **port_main.dataset_kwargs(args))
    labels = port_main.get_eval_labels(bundle, args)
    folder = port_main.fake_data_folder(args, len(labels))
    fakes, flabels = [], []
    for label in labels:  # the h5 dumps, in the eval labels' order
        with h5py.File(os.path.join(folder, f"{label}.h5"), "r") as f:
            fakes.append(f["fake_images_i"][:])
            flabels.append(f["fake_labels_i"][:])
    fakes, flabels = np.concatenate(fakes), np.concatenate(flabels)
    niqe_dir = Path(port_main.results_folder(args)) / "saved_images" / "fake_images"
    want = sorted(f"{i}_{lab}.png" for i, lab in enumerate(flabels))  # ccdm_tpu/main.py:383
    assert sorted(os.listdir(niqe_dir)) == want and len(want) == 2 * len(labels)
    for i, lab in enumerate(flabels):
        decoded = np.asarray(Image.open(niqe_dir / f"{i}_{lab}.png"))
        expect = fakes[i][..., 0] if fakes.shape[-1] == 1 else fakes[i]
        assert decoded.shape == expect.shape
        np.testing.assert_array_equal(decoded, expect)
    # the run stops after the dump: no eval
    assert not list(Path(port_main.results_folder(args)).parent.glob("eval_results_*"))
