"""Port parity: the fused attention block (ccdm_tpu_torch/ops/attn_block.py).

The port's plain version is held against the JAX kernel `_forward_pallas`,
run in interpret mode as tests/test_attn_block.py runs it: f32 to rtol 2e-3
/ atol 2e-4 and bf16 to 3e-2 (the bounds of that file, as the kernel keeps
its intermediates in f32 where the plain version rounds them to the
activation dtype), and against JAX's plain `attn_block_reference` to 1e-5
in f32 (the same composition in another framework). The CUDA kernel itself
runs only on the card: the test marked `cuda` holds it against the plain
version there and is skipped elsewhere. JAX is imported only inside the
tests that compare with it, so that on the card, which has no JAX, the file
runs as `python -m pytest --noconftest tests/test_torch_attn_block.py -m cuda`.
"""

import numpy as np
import pytest
import torch

from ccdm_tpu_torch.ops import _build, attn_block

torch.set_num_threads(2)

HEADS, DIM_HEAD = 4, 32
F = HEADS * DIM_HEAD


def _inputs(rng, b, n, c, x_std=2.0):
    x = rng.normal(0, x_std, (b, n, c)).astype(np.float32)
    w = (rng.normal(0, 1, (c,)).astype(np.float32) * 0.5 + 1.0,
         rng.normal(0, 0.1, (c, 3 * F)).astype(np.float32),
         rng.normal(0, 0.1, (F, c)).astype(np.float32),
         rng.normal(0, 0.1, (c,)).astype(np.float32),
         rng.normal(0, 1, (c,)).astype(np.float32) * 0.5 + 1.0)
    return x, w


@pytest.fixture
def jab(monkeypatch):
    """The JAX module, with Pallas calls in interpret mode."""
    import jax.experimental.pallas as pl

    from ccdm_tpu.ops import attn_block as jax_attn_block

    orig_call = pl.pallas_call

    def interp_call(*args, **kw):
        kw["interpret"] = True
        return orig_call(*args, **kw)

    monkeypatch.setattr(pl, "pallas_call", interp_call)
    return jax_attn_block


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,c", [(64, 32), (256, 128)])
def test_plain_version_matches_pallas_kernel(jab, n, c, dtype):
    import jax.numpy as jnp

    # x ~ N(0, 2) in f32 and N(0, 1) in bf16, as tests/test_attn_block.py:
    # the bf16 plain version rounds x + out_norm(o) at the operands' scale
    x, w = _inputs(np.random.default_rng(0), 2, n, c, 2.0 if dtype == "float32" else 1.0)
    jx = jnp.asarray(x).astype(dtype)
    want = np.asarray(jab._forward_pallas(jx, *map(jnp.asarray, w), HEADS, DIM_HEAD),
                      np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = attn_block.attn_block_reference(tx, *map(torch.from_numpy, w),
                                          HEADS, DIM_HEAD).float().numpy()
    tol = dict(rtol=2e-3, atol=2e-4) if dtype == "float32" else dict(rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(got, want, **tol)


@pytest.mark.parametrize("n,c", [(64, 32), (256, 128)])
def test_plain_version_matches_jax_reference(n, c):
    import jax.numpy as jnp

    from ccdm_tpu.ops import attn_block as jab
    x, w = _inputs(np.random.default_rng(1), 2, n, c)
    want = np.asarray(jab.attn_block_reference(jnp.asarray(x), *map(jnp.asarray, w),
                                               HEADS, DIM_HEAD))
    got = attn_block.attn_block_reference(torch.from_numpy(x), *map(torch.from_numpy, w),
                                          HEADS, DIM_HEAD).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_wrapper_on_cpu_takes_the_plain_path():
    x, w = _inputs(np.random.default_rng(2), 2, 64, 32)
    args = [torch.from_numpy(x), *map(torch.from_numpy, w)]
    before = attn_block.fused_attn_block.launches
    got = attn_block.fused_attn_block(*args, HEADS, DIM_HEAD)
    assert attn_block.fused_attn_block.launches == before == 0
    torch.testing.assert_close(got, attn_block.attn_block_reference(*args, HEADS, DIM_HEAD),
                               rtol=0, atol=0)


def test_wrapper_refuses_other_devices():
    x = torch.zeros(1, 4, 32, device="meta")
    w = [torch.zeros(s, device="meta") for s in ((32,), (32, 3 * F), (F, 32), (32,), (32,))]
    with pytest.raises(ValueError, match="cuda or cpu"):
        attn_block.fused_attn_block(x, *w, HEADS, DIM_HEAD)


def test_kernel_source_and_nvcc_command(tmp_path):
    src = _build.CSRC_DIR / "attn_block.cu"
    text = src.read_text()
    assert 'extern "C" int ccdm_attn_block_forward' in text
    assert "ccdm_cuda_error_string" in text and "torch/extension.h" not in text
    cmd = _build.nvcc_command("cuda/bin/nvcc", src, tmp_path / "lib.so")
    assert cmd[0] == "cuda/bin/nvcc" and cmd[-3:] == ["-o", str(tmp_path / "lib.so"), str(src)]
    flags = cmd[1:-3]
    for want in (["-gencode", "arch=compute_90a,code=sm_90a"], ["-std=c++17"], ["-O3"],
                 ["-shared"], ["-Xcompiler", "-fPIC"]):
        i = flags.index(want[0])
        assert flags[i:i + len(want)] == want
    assert not any("cudart" in f or "torch" in f for f in flags)


def test_library_path_is_under_build_and_keyed_by_source():
    lib = _build.library_path("attn_block")
    repo = _build.PACKAGE_DIR.parent
    assert lib.parent.parent == repo / "build" / "ccdm_tpu_torch"
    assert lib.name == "libattn_block.so" and len(lib.parent.name) == 16


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os, "access", lambda path, mode: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,c", [(4096, 64), (1024, 128), (16, 512), (100, 64)])
def test_cuda_kernel_matches_plain_version(n, c, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # an f32 plain version in full f32
    x, w = _inputs(np.random.default_rng(3), 4, n, c)
    dt = getattr(torch, dtype)
    args = [torch.from_numpy(x).cuda().to(dt), *(torch.from_numpy(a).cuda().to(dt) for a in w)]
    before = attn_block.fused_attn_block.launches
    got = attn_block.fused_attn_block(*args, HEADS, DIM_HEAD).float()
    torch.cuda.synchronize()
    assert attn_block.fused_attn_block.launches == before + 1
    want = attn_block.attn_block_reference(*(a.float() for a in args), HEADS, DIM_HEAD)
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-4)
    else:  # relative to max(|y|, |y - x|), as chip_smoke.py states it
        scale = torch.maximum(want.abs(), (want - args[0].float()).abs())
        assert bool(((got - want).abs() <= 3e-2 + 3e-2 * scale).all())
