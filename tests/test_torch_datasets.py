"""Port parity of the h5 dataset loaders (ccdm_tpu_torch/data/datasets.py).

Small SteeringAngle and Cell-200 files are written here with the render
functions of examples/make_fixture_sa64.py and examples/make_fixture_cell200.py
in the real datasets' keys and layouts, and both packages load them with the
same arguments: images, raw labels and the eval set exactly, the normalised
labels and the normalise/denormalise closures to 1e-6.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

from ccdm_tpu.data import datasets as jax_datasets
from ccdm_tpu_torch.data import datasets

h5py = pytest.importorskip("h5py")

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
SIZE = 32


def _example(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def data_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("h5_fixtures")
    rng = np.random.default_rng(2026)
    road = _example("make_fixture_sa64").render_road
    angles = np.repeat(np.linspace(-79.6, 79.6, 9), 3)
    with h5py.File(path / f"SteeringAngle_{SIZE}x{SIZE}.h5", "w") as f:
        f.create_dataset("labels", data=angles.astype(np.float64))
        f.create_dataset("images", data=np.stack([road(float(a), SIZE, rng) for a in angles]),
                         dtype="uint8", compression="gzip", compression_opts=4)
    cells = _example("make_fixture_cell200").render_cells
    counts = np.repeat(np.arange(1, 13), 3)
    with h5py.File(path / f"Cell200_{SIZE}x{SIZE}.h5", "w") as f:
        f.create_dataset("CellCounts", data=counts.astype(np.int64))
        f.create_dataset("IMGs_grey", data=np.stack([cells(int(c), SIZE, rng)
                                                     for c in counts])[:, None],
                         dtype="uint8", compression="gzip", compression_opts=4)
    return str(path)


def _same(got, want):
    for name in ("images", "labels_raw", "eval_images", "eval_labels_raw"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    assert got.images.dtype == want.images.dtype == np.uint8
    assert got.name == want.name and got.label_dim == want.label_dim
    np.testing.assert_allclose(got.labels_norm, want.labels_norm, rtol=1e-6, atol=1e-6)
    probe = np.linspace(want.labels_raw.min(), want.labels_raw.max(), 7)
    np.testing.assert_allclose(got.fn_normalize(probe), want.fn_normalize(probe),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.fn_denormalize(got.labels_norm),
                               want.fn_denormalize(want.labels_norm), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kw", [dict(), dict(min_label=-60.0, max_label=70.0,
                                             max_num_img_per_label=2)])
def test_steering_angle_matches_jax(data_path, kw):
    got = datasets.load_dataset("SteeringAngle", data_path, image_size=SIZE, **kw)
    want = jax_datasets.load_dataset("SteeringAngle", data_path, image_size=SIZE, **kw)
    _same(got, want)
    assert got.images.shape[1:] == (SIZE, SIZE, 3)


@pytest.mark.parametrize("kw", [dict(max_label=12), dict(min_label=2, max_label=11, stepsize=3,
                                                         num_imgs_per_label=2)])
def test_cell200_matches_jax(data_path, kw):
    got = datasets.load_dataset("Cell200", data_path, image_size=SIZE, **kw)
    want = jax_datasets.load_dataset("Cell200", data_path, image_size=SIZE, **kw)
    _same(got, want)
    assert got.images.shape[1:] == (SIZE, SIZE, 1)
