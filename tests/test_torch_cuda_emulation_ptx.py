"""The emulation's PTX instructions (csrc/ptx.cuh: ldmatrix .x4 and .trans,
mma.sync m16n8k16, cp.async with its zero-fill) held to the fragment
layouts of the PTX ISA, on a small harness compiled behind the emulation of
tests/torch_emulation.py.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from tests.torch_emulation import CUDA_RUNTIME_H

torch.set_num_threads(2)


PTX_HARNESS = r"""
#include <cstdint>
extern "C" void emu_ldmatrix(const uint16_t* m, uint32_t* out, int trans) {
  emu::launch(dim3(1), dim3(32), 0, nullptr, [=]() {
    const int l = threadIdx.x;
    uint32_t r[4];
    const uint16_t* row = m + 64 * (l / 8) + 8 * (l % 8);  // row l % 8 of matrix l / 8
    if (trans) ldmatrix_x4_trans(r, row); else ldmatrix_x4(r, row);
    for (int i = 0; i < 4; ++i) out[4 * l + i] = r[i];
  });
}
extern "C" void emu_mma(const uint32_t* a, const uint32_t* b, float* d) {
  emu::launch(dim3(1), dim3(32), 0, nullptr, [=]() {
    const int l = threadIdx.x;
    const uint32_t ar[4] = {a[4 * l], a[4 * l + 1], a[4 * l + 2], a[4 * l + 3]};
    const uint32_t br[2] = {b[2 * l], b[2 * l + 1]};
    float dr[4] = {d[4 * l], d[4 * l + 1], d[4 * l + 2], d[4 * l + 3]};
    mma_16816(dr, ar, br);
    for (int i = 0; i < 4; ++i) d[4 * l + i] = dr[i];
  });
}
extern "C" void emu_cp_async(void* dst, const void* src, int src_bytes) {
  cp_async_16(dst, src, src_bytes);
  cp_async_commit();
  cp_async_wait<0>();
}
"""


@pytest.fixture(scope="module")
def ptx_harness(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the emulation")
    d = tmp_path_factory.mktemp("cuda_emu_ptx")
    (d / "cuda_runtime.h").write_text(CUDA_RUNTIME_H)
    (d / "harness.cpp").write_text(PTX_HARNESS)
    subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", f"-I{d}",
                    "-include", "cuda_runtime.h", "-o", str(d / "libharness.so"),
                    str(d / "harness.cpp")], check=True, timeout=300)
    lib = ctypes.CDLL(str(d / "libharness.so"))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.emu_ldmatrix.argtypes = [p, p, i]
    lib.emu_mma.argtypes = [p, p, p]
    lib.emu_cp_async.argtypes = [p, p, i]
    return lib


def _bf16_bits(a):
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().view(torch.int16).numpy() \
        .astype(np.uint32) & 0xFFFF


def _pack(lo, hi):
    return (lo | (hi << 16)).astype(np.uint32)


@pytest.mark.parametrize("trans", [0, 1])
def test_emulated_ldmatrix_follows_the_isa(ptx_harness, trans):
    """ldmatrix .x4: lane l gives row l % 8 of matrix l / 8; register i of
    lane l holds row l / 4, elements 2 (l % 4) and 2 (l % 4) + 1 of matrix i
    (.trans: of its transpose), the lower element in the low half."""
    m = np.arange(256, dtype=np.uint16)
    out = np.zeros(128, np.uint32)
    ptx_harness.emu_ldmatrix(m.ctypes.data, out.ctypes.data, trans)
    mats = m.reshape(4, 8, 8).astype(np.uint32)
    if trans:
        mats = mats.transpose(0, 2, 1)
    lane = np.arange(32)
    row, col = lane // 4, 2 * (lane % 4)
    want = np.stack([_pack(mats[i, row, col], mats[i, row, col + 1]) for i in range(4)], axis=1)
    np.testing.assert_array_equal(out.reshape(32, 4), want)


def test_emulated_mma_follows_the_isa(ptx_harness):
    """mma.m16n8k16 .row.col, bf16 in, f32 accumulate, with the fragments of
    the ISA built here from A [16, 16], B [16, 8] and C [16, 8]: D = A B + C
    exactly (values on a grid of 1/8, sums exact in f32)."""
    rng = np.random.default_rng(0)
    a = rng.integers(-16, 16, (16, 16)) / 8
    b = rng.integers(-16, 16, (16, 8)) / 8
    c = rng.integers(-64, 64, (16, 8)) / 8
    ab, bb = _bf16_bits(a), _bf16_bits(b)
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    a_regs = np.stack([_pack(ab[g + 8 * (i % 2), 2 * t + 8 * (i // 2)],
                             ab[g + 8 * (i % 2), 2 * t + 8 * (i // 2) + 1])
                       for i in range(4)], 1)
    b_regs = np.stack([_pack(bb[2 * t + 8 * i, g], bb[2 * t + 8 * i + 1, g])
                       for i in range(2)], 1)
    at = lambda m: np.stack([m[g + 8 * (i // 2), 2 * t + i % 2] for i in range(4)], 1)
    d = np.ascontiguousarray(at(c), np.float32)
    ptx_harness.emu_mma(np.ascontiguousarray(a_regs).ctypes.data,
                        np.ascontiguousarray(b_regs).ctypes.data, d.ctypes.data)
    np.testing.assert_array_equal(d, at(a @ b + c).astype(np.float32))


@pytest.mark.parametrize("src_bytes", [16, 8, 0])
def test_emulated_cp_async_zero_fills(ptx_harness, src_bytes):
    """cp.async 16 bytes with src-size n: n bytes copied, the rest zero."""
    src = np.arange(1, 17, dtype=np.uint8)
    dst = np.full(16, 0xAA, np.uint8)
    ptx_harness.emu_cp_async(dst.ctypes.data, src.ctypes.data, src_bytes)
    np.testing.assert_array_equal(dst, np.concatenate([src[:src_bytes],
                                                       np.zeros(16 - src_bytes, np.uint8)]))
