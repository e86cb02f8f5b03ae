"""The port's ctypes bridge to the native dataset cache
(ccdm_tpu_torch/data/native_loader.py) against the JAX package's
(ccdm_tpu/data/native_loader.py), on the same file.

The port builds native/dataset_cache.cpp with g++ into
build/ccdm_tpu_torch/<hash>/ and never writes into native/. Checks, all
exact (the cache stores and gathers bytes):
- a cache written by either bridge reads the same header and gathers the
  same images and labels through both, with the per-image flip drawn from
  the same seed on the same number of threads;
- the port's gather fills caller-owned pinned uint8 / f32 tensors;
- native/ holds the same files, unchanged, after the port's build.
"""

import hashlib
import os

import numpy as np
import pytest
import torch

from ccdm_tpu.data.native_loader import NativeDatasetCache as JaxCache
from ccdm_tpu_torch.data import native_loader
from ccdm_tpu_torch.data.native_loader import NativeDatasetCache

NATIVE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")


def _native_state():
    return {name: hashlib.sha256(open(os.path.join(NATIVE, name), "rb").read()).hexdigest()
            for name in sorted(os.listdir(NATIVE))}


@pytest.fixture(scope="module")
def native_before():
    return _native_state()


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return (rng.integers(0, 256, (40, 8, 6, 3), dtype=np.uint8),
            rng.uniform(0, 1, (40, 2)).astype(np.float32))


def test_port_builds_into_its_own_build_dir(native_before):
    assert NativeDatasetCache.available()
    lib = native_loader.library_path()
    assert lib.exists() and "build" in lib.parts and "ccdm_tpu_torch" in lib.parts
    assert _native_state() == native_before  # nothing written into native/


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_gather_is_jaxs_bit_for_bit(tmp_path, data, writer, native_before):
    images, labels = data
    path = str(tmp_path / "ds.ccdmcache")
    (JaxCache if writer == "jax" else NativeDatasetCache).write(path, images, labels)
    if not JaxCache.available():
        pytest.skip("the JAX package's library cannot be built here")
    port, jx = NativeDatasetCache(path), JaxCache(path)
    assert port.info() == (jx.n, jx.h, jx.w, jx.c, jx.ldim) == (40, 8, 6, 3, 2)
    idx = np.random.default_rng(1).integers(0, 40, 23)
    for hflip, seed in ((False, 0), (True, 5), (True, 6)):
        got = port.gather(idx, hflip=hflip, seed=seed, num_threads=3)
        want = jx.gather(idx, hflip=hflip, seed=seed, num_threads=3)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(port.gather(idx)[0], images[idx])
    flipped = port.gather(np.zeros(32, np.int64), hflip=True, seed=3)[0]
    assert any(np.array_equal(f, images[0][:, ::-1]) for f in flipped)
    assert _native_state() == native_before


def test_gather_fills_pinned_tensors(tmp_path, data):
    images, labels = data
    path = str(tmp_path / "ds.ccdmcache")
    NativeDatasetCache.write(path, images, labels[:, 0])
    cache = NativeDatasetCache(path)
    idx = np.arange(39, 20, -3)
    pin = torch.cuda.is_available()
    imgs = torch.empty((len(idx), 8, 6, 3), dtype=torch.uint8, pin_memory=pin)
    labs = torch.empty((len(idx), 1), dtype=torch.float32, pin_memory=pin)
    out = cache.gather(idx, out=(imgs, labs), num_threads=2)
    assert out[0] is imgs and out[1] is labs
    assert torch.equal(imgs, torch.from_numpy(images[idx]))
    assert torch.equal(labs[:, 0], torch.from_numpy(labels[idx, 0]))
    with pytest.raises(ValueError, match="uint8"):
        cache.gather(idx, out=(imgs.float(), labs))
