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

import shutil

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


def test_library_path_covers_the_headers(tmp_path, monkeypatch):
    """The tensor-core sources include csrc/ptx.cuh: an edit to a header of
    csrc/ changes every library's path, so no build reuses a library made
    from the old header, while an unchanged tree keeps its paths."""
    for name in ("attn_block", "resnet_block"):
        assert '#include "ptx.cuh"' in (_build.CSRC_DIR / f"{name}.cu").read_text()
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    names = ("attn_block", "resnet_block", "style_ops")
    real = {name: _build.library_path(name) for name in names}
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    assert {name: _build.library_path(name) for name in names} == real
    (csrc / "ptx.cuh").write_text((csrc / "ptx.cuh").read_text() + "\n// edited\n")
    edited = {name: _build.library_path(name) for name in names}
    assert all(edited[name] != real[name] for name in names)


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


def _cuda_bf16_args(b, n, c, seed):
    x, w = _inputs(np.random.default_rng(seed), b, n, c, x_std=1.0)
    return [torch.from_numpy(x).cuda().bfloat16(),
            *(torch.from_numpy(a).cuda().bfloat16() for a in w)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,c,route", [(8, 16, 512, "fused"), (72, 64, 256, "fused"),
                                         (8, 1024, 128, "split"), (72, 4096, 64, "split"),
                                         (8, 64, 512, "fused")])
def test_cuda_bf16_routes_at_the_main_paths_small_batches(b, n, c, route):
    """Kernel #1 in bf16 at the batches of the eval sampling and the ddpm
    request (B 8) and of the EMA grid (B 72), on the route the plan gives
    each, against the plain version at chip_smoke.py's bound; (64, 512), the
    128x128 UNet's 8x8 level, takes the fused route's narrow ring."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    args = _cuda_bf16_args(b, n, c, seed=b + n)
    assert attn_block.plan(b, n, c, HEADS, torch.bfloat16).route == route
    got = attn_block.fused_attn_block(*args, HEADS, DIM_HEAD).float()
    want = attn_block.attn_block_reference(*(a.float() for a in args), HEADS, DIM_HEAD)
    scale = torch.maximum(want.abs(), (want - args[0].float()).abs())
    assert bool(((got - want).abs() <= 3e-2 + 3e-2 * scale).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n,c", [(64, 128), (1024, 64)])
def test_cuda_unaligned_input_takes_the_element_loads(n, c):
    """x2d one element past an aligned base: the kernel loads it element by
    element into the same layout, so y is bit-equal to the aligned run's
    (the fused route at N 64, the split route at N 1024)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    args = _cuda_bf16_args(4, n, c, seed=7)
    x = args[0]
    shifted = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.data_ptr() % 16 != 0
    aligned = attn_block.fused_attn_block(x, *args[1:], HEADS, DIM_HEAD)
    unaligned = attn_block.fused_attn_block(shifted, *args[1:], HEADS, DIM_HEAD)
    assert torch.equal(aligned, unaligned)


@pytest.mark.cuda
@pytest.mark.parametrize("heads,c", [(2, 64), (4, 640), (4, 512)])
def test_cuda_bf16_other_shapes_take_the_cuda_cores(heads, c):
    """bf16 with heads other than 4, C above 512, or C 512 at N 100 (where
    neither tensor-core route's shared memory fits) takes the CUDA-core
    route, against the plain version at chip_smoke.py's bound."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    rng = np.random.default_rng(heads + c)
    f = heads * DIM_HEAD
    arrays = (rng.normal(0, 1, (4, 100, c)), 1 + 0.5 * rng.normal(size=c),
              0.1 * rng.normal(size=(c, 3 * f)), 0.1 * rng.normal(size=(f, c)),
              0.1 * rng.normal(size=c), 1 + 0.5 * rng.normal(size=c))
    args = [torch.from_numpy(a.astype(np.float32)).cuda().bfloat16() for a in arrays]
    assert attn_block.plan(4, 100, c, heads, torch.bfloat16).route == "cores"
    got = attn_block.fused_attn_block(*args, heads, DIM_HEAD).float()
    want = attn_block.attn_block_reference(*(a.float() for a in args), heads, DIM_HEAD)
    scale = torch.maximum(want.abs(), (want - args[0].float()).abs())
    assert bool(((got - want).abs() <= 3e-2 + 3e-2 * scale).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n,c", [(36864, 64), (2304, 128), (9, 512)])
def test_cuda_bf16_at_the_sampling_batch_of_200_images(n, c):
    """Kernel #1 in bf16 at B 400, the CFG forward of UK128's and UK192's
    sampling (--samp_batch_size 200), on the route the plan gives it: the
    split route with one block a row at N 36864 (B N C 9.4e8), the fused
    route at the 3x3 level. The kernel computes each batch row on its own,
    so the plain version runs on rows 0, 1, 199 and 399 alone (at N 36864 its
    f32 [B, N, 3F] intermediates for all 400 rows would take 22.6 GB), at
    chip_smoke.py's bound."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    b, rows = 400, [0, 1, 199, 399]
    g = torch.Generator(device="cuda").manual_seed(n + c)
    x = torch.randn(b, n, c, generator=g, device="cuda").bfloat16()
    _, w = _inputs(np.random.default_rng(n), 1, 1, c)
    args = [x, *(torch.from_numpy(a).cuda().bfloat16() for a in w)]
    plan = attn_block.plan(b, n, c, HEADS, torch.bfloat16)
    assert (plan.route, plan.splits) == ("fused" if n <= 128 else "split", 1)
    got = attn_block.fused_attn_block(*args, HEADS, DIM_HEAD)[rows].float()
    want = attn_block.attn_block_reference(*(a.float() for a in (x[rows], *args[1:])), HEADS,
                                           DIM_HEAD)
    scale = torch.maximum(want.abs(), (want - x[rows].float()).abs())
    assert bool(torch.isfinite(got).all())
    assert bool(((got - want).abs() <= 3e-2 + 3e-2 * scale).all())
