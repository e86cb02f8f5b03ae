"""Kernel #12 (csrc/style_ops.cu, bias_act) compiled for the CPU behind the
emulation of tests/torch_emulation.py and held against its plain version,
every activation, in f32 and bf16.
"""

import ctypes
import shutil

import numpy as np
import pytest
import torch

from tests.torch_emulation import compile_emulated

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def emulated_style(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the emulated kernel")
    lib = compile_emulated(tmp_path_factory.mktemp("cuda_emu_style"), "style_ops")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ccdm_bias_act.argtypes = [p, p, p, ctypes.c_longlong, i, i, ctypes.c_float,
                                  ctypes.c_float, ctypes.c_float, i, i, p]
    lib.ccdm_bias_act.restype = ctypes.c_int
    return lib


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,c,vec", [(37, 128, 0), (5, 24, 0), (3, 13, 1), (300, 40, 0)])
def test_emulated_bias_act_matches_plain(emulated_style, rows, c, vec, dtype):
    """Kernel #12, every activation (one instantiation each), with and
    without bias, clamp and an explicit gain; a row count off the block's
    tile of 256 threads x 4 packs; 16-byte packs (vec 0) and one value a
    pack (vec 1); at C 40 several blocks whose packs' columns wrap the row
    as they step. Both compute in f32 and round once: f32 to 1e-5, bf16 to
    one unit where a rounding flips (8e-3)."""
    from ccdm_tpu_torch.ops import style_ops as so

    rng = np.random.default_rng(rows * c)
    dt = getattr(torch, dtype)
    x = torch.from_numpy(rng.normal(0, 2, (rows, c)).astype(np.float32)).to(dt)
    b = torch.from_numpy(rng.normal(0, 1, c).astype(np.float32)).to(dt)
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == "float32" else dict(rtol=8e-3, atol=8e-3)
    for act in so.activation_funcs:
        for bias, gain, clamp in ((None, None, None), (b, 0.5, 1.5)):
            _, alpha, gain, clamp = so._resolve(act, None, gain, clamp)
            y = torch.empty_like(x)
            err = emulated_style.ccdm_bias_act(
                x.data_ptr(), None if bias is None else bias.data_ptr(), y.data_ptr(),
                x.numel(), c, so._ACT_INDEX[act], alpha, gain, clamp, vec,
                int(dt == torch.bfloat16), None)
            assert err == 0, act
            want = so.bias_act_fused_reference(x, bias, act, alpha, gain, clamp)
            torch.testing.assert_close(y.float(), want.float(), **tol, msg=act)
