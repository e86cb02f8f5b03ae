"""Resnet block: conv3x3 + RMSNorm + FiLM + SiLU, then conv3x3 + RMSNorm +
SiLU, plus the residual.

Counterpart of ccdm_tpu/ops/resnet_block.py. `fused_resnet_block` is the
entry the model calls, with the port's layouts (x NCHW in channels_last
memory, conv weights OIHW). It honours the JAX package's switch,
CCDM_TPU_FUSED_RESBLOCK=1, read once at import into `USE_FUSED`:
- off (the default): `resnet_block_reference`, the composition the JAX main
  path runs as XLA convs; here cuDNN convs;
- on: `_FusedBlock`, kernel #10 (`resnet_half_a`, the port of the TPU kernel
  `_kernel_a`) then kernel #11 (`resnet_half_b`, `_kernel_b`), both in
  csrc/resnet_block.cu. Every resnet block takes them: JAX's gate on cell
  size and VMEM (`_dispatch`) is a limit of the TPU's scoped VMEM that the
  card does not have. The backward recomputes `resnet_block_reference`
  under autograd, as JAX's custom_vjp does with jax.vjp (the TPU kernels
  have no backward kernel).
Each kernel wrapper launches its kernel on a CUDA tensor and runs its plain
PyTorch version (beside it here) on a CPU tensor; nothing falls back from
one to the other. On the card the kernels choose their route by dtype and
shape (`plan`): f32 on the CUDA cores; bf16 on the tensor cores, fused (one
launch, a block owning whole pixel rows) where Cout <= 128 fills the card,
else split (K split over blocks into an f32 workspace the wrapper
allocates, then an epilogue launch).

The kernels take the JAX layout: x [B, H*W, C] token-major (the port's
channels_last memory read as [B, H, W, C]), conv weights tap-major
[9*Cin, Cout] in the activation dtype, scale/shift [B, Cout] and the vectors
in f32. The plain versions repeat their numerics: operands rounded to the
activation dtype, f32 accumulation, norm and epilogue, h1 rounded to the
activation dtype between the halves. They are not `resnet_block_reference`,
which runs the convs in the activation dtype.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ccdm_tpu_torch.ops import _build
from ccdm_tpu_torch.ops.attn_block import _operand, _rms_norm
from ccdm_tpu_torch.ops.linear_attention import _op

USE_FUSED = os.environ.get("CCDM_TPU_FUSED_RESBLOCK", "0") == "1"


def reference_half_a(x, scale, shift, w1, b1, g1) -> torch.Tensor:
    """The first half of `resnet_block_reference`, the function of #10:
    SiLU(FiLM(RMSNorm_g1(conv3x3(x) + b1))), NCHW."""
    dt = x.dtype
    film = lambda v: v.to(dt)[:, :, None, None]
    h = F.conv2d(x, w1.to(dt), b1.to(dt), padding=1)
    h = _rms_norm(h, g1, dim=1)
    return F.silu(h * (film(scale) + 1.0) + film(shift))


def reference_half_b(h, x, w2, b2, g2, wres, bres) -> torch.Tensor:
    """The second half, the function of #11: SiLU(RMSNorm_g2(conv3x3(h) +
    b2)) + x, or + conv1x1(x) with wres [Cout, Cin, 1, 1]."""
    dt = x.dtype
    h = F.conv2d(h, w2.to(dt), b2.to(dt), padding=1)
    h = F.silu(_rms_norm(h, g2, dim=1))
    res = x if wres is None else F.conv2d(x, wres.to(dt), bres.to(dt))
    return h + res


def resnet_block_reference(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                           w1: torch.Tensor, b1: torch.Tensor, g1: torch.Tensor,
                           w2: torch.Tensor, b2: torch.Tensor, g2: torch.Tensor,
                           wres: Optional[torch.Tensor],
                           bres: Optional[torch.Tensor]) -> torch.Tensor:
    """x [B, Cin, H, W]; scale/shift [B, Cout]; w1 [Cout, Cin, 3, 3];
    w2 [Cout, Cout, 3, 3]; wres [Cout, Cin, 1, 1] or None (identity
    residual). Conv compute dtype follows x (ccdm_tpu/ops/resnet_block.py:33-64)."""
    return reference_half_b(reference_half_a(x, scale, shift, w1, b1, g1), x, w2, b2, g2,
                            wres, bres)


# ------------------------------------------------------ plain kernels


def conv_taps(w: torch.Tensor) -> torch.Tensor:
    """OIHW [Cout, Cin, 3, 3] -> tap-major [9*Cin, Cout] (the HWIO kernel
    flattened, ccdm_tpu/ops/resnet_block.py:192)."""
    return w.permute(2, 3, 1, 0).reshape(9 * w.shape[1], w.shape[0])


def _conv3x3(x2d, w_taps, hh, ww):
    """SAME 3x3 conv of f32 [B, HW, Cin] by f32 [9*Cin, Cout] -> [B, HW, Cout]."""
    b, n, cin = x2d.shape
    cout = w_taps.shape[1]
    img = x2d.reshape(b, hh, ww, cin).permute(0, 3, 1, 2)
    w = w_taps.reshape(3, 3, cin, cout).permute(3, 2, 0, 1)
    return F.conv2d(img, w, padding=1).permute(0, 2, 3, 1).reshape(b, n, cout)


def _rms_f32(h, g):
    return h * torch.rsqrt(h.square().mean(-1, keepdim=True) + 1e-12) * g.float()


def half_a_reference(x2d, scale, shift, w1, b1, g1, hh: int, ww: int) -> torch.Tensor:
    """Plain kernel #10: h1 [B, HW, Cout] in x's dtype."""
    dt = x2d.dtype
    h = _conv3x3(_op(x2d, dt), _op(w1, dt), hh, ww) + b1.float()
    h = _rms_f32(h, g1)
    h = h * (scale.float()[:, None, :] + 1.0) + shift.float()[:, None, :]
    return F.silu(h).to(dt)


def half_b_reference(h1, x2d, w2, b2, g2, wres, bres, hh: int, ww: int) -> torch.Tensor:
    """Plain kernel #11: y [B, HW, Cout] in x's dtype; wres [Cin, Cout] or
    None (identity residual)."""
    dt = x2d.dtype
    h = F.silu(_rms_f32(_conv3x3(_op(h1, dt), _op(w2, dt), hh, ww) + b2.float(), g2))
    if wres is None:
        res = x2d.float()
    else:
        res = torch.matmul(_op(x2d, dt), _op(wres, dt)) + bres.float()
    return (h + res).to(dt)


# ------------------------------------------------------------ launches


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Sets the ctypes signatures of csrc/resnet_block.cu's entry points on a
    library built from it (here, in the g++ emulation or as a variant)."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ccdm_resnet_half_a.argtypes = [p] * 8 + [i] * 6 + [ll, p]
    lib.ccdm_resnet_half_b.argtypes = [p] * 9 + [i] * 7 + [ll, p]
    lib.ccdm_resnet_half_a.restype = lib.ccdm_resnet_half_b.restype = ctypes.c_int
    lib.ccdm_resnet_plan.argtypes = [i] * 8 + [ctypes.POINTER(ctypes.c_int)]
    lib.ccdm_resnet_plan.restype = ll
    lib.ccdm_resnet_set_wave.argtypes = [i]
    lib.ccdm_cuda_error_string.argtypes = [i]
    lib.ccdm_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    """The library, declared once."""
    return declare(_build.load("resnet_block"))


class Plan(NamedTuple):
    """How csrc/resnet_block.cu runs one call: route "f32" (CUDA cores),
    "fused" (tensor cores, one launch) or "split" (tensor cores, K split
    over blocks, then an epilogue launch); the tile's pixels and channels,
    the K splits, and the f32 workspace bytes the split route needs."""
    route: str
    tile: tuple
    splits: int
    workspace_bytes: int


@functools.lru_cache(maxsize=None)
def plan(half: str, batch: int, hh: int, ww: int, cin: int, cout: int, has_res: bool,
         dtype: torch.dtype) -> Plan:
    """The kernel's plan for half "a" (#10) or "b" (#11) at this shape, as
    the C code computes it (a function of the shape alone)."""
    out = (ctypes.c_int * 4)()
    nbytes = _library().ccdm_resnet_plan(int(half == "b"), batch, hh, ww, cin, cout,
                                         int(has_res), int(dtype == torch.bfloat16), out)
    return Plan(("f32", "fused", "split")[out[0]], (out[1], out[2]), out[3], nbytes)


def _workspace(pl: Plan, dev) -> Optional[torch.Tensor]:
    if not pl.workspace_bytes:
        return None
    return torch.empty(pl.workspace_bytes // 4, dtype=torch.float32, device=dev)


def _check_activation(x2d, hh, ww):
    if x2d.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the resnet kernels take f32 or bf16, got {x2d.dtype}")
    if x2d.ndim != 3 or x2d.shape[1] != hh * ww:
        raise ValueError(f"x2d must be [B, {hh}*{ww}, C], got {tuple(x2d.shape)}")
    if not x2d.is_contiguous():
        raise ValueError("x2d must be contiguous")


def _route(x2d) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU)."""
    if x2d.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the resnet kernels run on cuda or cpu, not {x2d.device}")
    return x2d.device.type == "cuda"


def resnet_half_a(x2d, scale, shift, w1, b1, g1, hh: int, ww: int) -> torch.Tensor:
    """Kernel #10: h1 = SiLU(FiLM(RMSNorm_g1(conv3x3(x) + b1))), [B, HW, Cout]
    in x's dtype; w1 tap-major [9*Cin, Cout]."""
    if not _route(x2d):
        return half_a_reference(x2d, scale, shift, w1, b1, g1, hh, ww)
    _check_activation(x2d, hh, ww)
    b, _, cin = x2d.shape
    cout = w1.shape[1]
    dt, dev = x2d.dtype, x2d.device
    ins = [_operand("scale", scale, (b, cout), dev, torch.float32),
           _operand("shift", shift, (b, cout), dev, torch.float32),
           _operand("w1", w1, (9 * cin, cout), dev, dt),
           _operand("b1", b1, (cout,), dev, torch.float32),
           _operand("g1", g1, (cout,), dev, torch.float32)]
    h1 = torch.empty((b, hh * ww, cout), dtype=dt, device=dev)
    pl = plan("a", b, hh, ww, cin, cout, False, dt)
    _build.run(_library(), "ccdm_resnet_half_a", "resnet_half_a kernel launch", dev,
               x2d, *ins, h1, _workspace(pl, dev), b, hh, ww, cin, cout,
               int(dt == torch.bfloat16), pl.workspace_bytes)
    resnet_half_a.launches += 1
    return h1


def resnet_half_b(h1, x2d, w2, b2, g2, wres, bres, hh: int, ww: int) -> torch.Tensor:
    """Kernel #11: y = SiLU(RMSNorm_g2(conv3x3(h1) + b2)) + res, [B, HW, Cout]
    in x's dtype; w2 tap-major [9*Cout, Cout]; res = x (wres None) or
    x . wres + bres, wres [Cin, Cout]."""
    if not _route(x2d):
        return half_b_reference(h1, x2d, w2, b2, g2, wres, bres, hh, ww)
    _check_activation(x2d, hh, ww)
    b, n, cin = x2d.shape
    cout = w2.shape[1]
    dt, dev = x2d.dtype, x2d.device
    has_res = wres is not None
    if not has_res and cin != cout:
        raise ValueError(f"an identity residual needs Cin == Cout, got {cin} and {cout}")
    ins = [_operand("h1", h1, (b, n, cout), dev, dt),
           _operand("w2", w2, (9 * cout, cout), dev, dt),
           _operand("b2", b2, (cout,), dev, torch.float32),
           _operand("g2", g2, (cout,), dev, torch.float32)]
    res = ([_operand("wres", wres, (cin, cout), dev, dt),
            _operand("bres", bres, (cout,), dev, torch.float32)] if has_res else [None, None])
    y = torch.empty((b, n, cout), dtype=dt, device=dev)
    pl = plan("b", b, hh, ww, cin, cout, has_res, dt)
    _build.run(_library(), "ccdm_resnet_half_b", "resnet_half_b kernel launch", dev,
               ins[0], x2d, *ins[1:], *res, y, _workspace(pl, dev), b, hh, ww, cin, cout,
               int(has_res), int(dt == torch.bfloat16), pl.workspace_bytes)
    resnet_half_b.launches += 1
    return y


# ------------------------------------------------- the block and its route


def _forward(x, scale, shift, w1, b1, g1, w2, b2, g2, wres, bres):
    """#10 then #11 on the NCHW block; returns NCHW in channels_last memory."""
    b, cin, hh, ww = x.shape
    cout = w1.shape[0]
    dt = x.dtype
    x2d = x.permute(0, 2, 3, 1).reshape(b, hh * ww, cin).contiguous()
    h1 = resnet_half_a(x2d, scale, shift, conv_taps(w1).to(dt), b1, g1, hh, ww)
    y = resnet_half_b(h1, x2d, conv_taps(w2).to(dt), b2, g2,
                      None if wres is None else wres.reshape(cout, cin).t().to(dt), bres,
                      hh, ww)
    return y.view(b, hh, ww, cout).permute(0, 3, 1, 2)


class _FusedBlock(torch.autograd.Function):
    """Kernels #10 + #11 forward; the backward recomputes
    `resnet_block_reference` under autograd (jax.vjp of the reference,
    ccdm_tpu/ops/resnet_block.py:267-279). wres/bres may be None."""

    @staticmethod
    def forward(ctx, x, scale, shift, w1, b1, g1, w2, b2, g2, wres, bres):
        ctx.has_res = wres is not None
        ctx.save_for_backward(x, scale, shift, w1, b1, g1, w2, b2, g2,
                              *((wres, bres) if ctx.has_res else ()))
        return _forward(x, scale, shift, w1, b1, g1, w2, b2, g2, wres, bres)

    @staticmethod
    def backward(ctx, dy):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        args = inputs if ctx.has_res else inputs + [None, None]
        with torch.enable_grad():
            y = resnet_block_reference(*args)
            grads = torch.autograd.grad(y, inputs, dy)
        return (*grads, *(() if ctx.has_res else (None, None)))


def fused_resnet_block(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                       w1: torch.Tensor, b1: torch.Tensor, g1: torch.Tensor,
                       w2: torch.Tensor, b2: torch.Tensor, g2: torch.Tensor,
                       wres: Optional[torch.Tensor],
                       bres: Optional[torch.Tensor]) -> torch.Tensor:
    """The block, routed by `USE_FUSED` as the module docstring says; the
    arguments of `resnet_block_reference`."""
    if not USE_FUSED:
        return resnet_block_reference(x, scale, shift, w1, b1, g1, w2, b2, g2, wres, bres)
    return _FusedBlock.apply(x, scale, shift, w1, b1, g1, w2, b2, g2, wres, bres)


resnet_half_a.launches = 0  # kernel #10 launches since the last reset
resnet_half_b.launches = 0  # kernel #11
