"""Fused attention block: pre-norm + qkv + linear attention + out + out-norm.

Counterpart of ccdm_tpu/ops/attn_block.py. For x [B, N, C]:

    y = x + RMSNorm_gout(Wout . LA(Wqkv . RMSNorm_gpre(x)) + bout)

`fused_attn_block` is the entry the model calls. On a CUDA tensor it
launches the hand-written kernel of csrc/attn_block.cu (the port of the TPU
kernel `_kernel`) at every N; on a CPU tensor it runs `attn_block_reference`,
the plain PyTorch version with the same numerics contract. There is no
fallback from one to the other.

Numerics: norms and softmaxes in f32; products take operands in the
activation dtype (bf16 or f32) with f32 accumulation. Weights are passed in
the layout of the JAX module: wqkv [C, 3F], wout [F, C].
"""

from __future__ import annotations

import ctypes

import torch

from ccdm_tpu_torch.ops import _build
from ccdm_tpu_torch.ops.linear_attention import linear_attention_reference

DIM_HEAD = 32  # the kernel maps one warp lane to each channel of a head


def _rms_norm(x: torch.Tensor, g: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """RMSNorm over `dim` with f32 statistics and the output in x's dtype
    (ccdm_tpu/models/layers.py:RMSNorm)."""
    inv = torch.rsqrt(x.float().square().mean(dim, keepdim=True) + 1e-12)
    shape = [1] * x.ndim
    shape[dim] = -1
    return x * inv.to(x.dtype) * g.to(x.dtype).view(shape)


def attn_block_reference(x2d: torch.Tensor, g_pre: torch.Tensor, wqkv: torch.Tensor,
                         wout: torch.Tensor, bout: torch.Tensor, g_out: torch.Tensor,
                         heads: int, dim_head: int) -> torch.Tensor:
    """Plain PyTorch version: x2d [B, N, C]; wqkv [C, 3F]; wout [F, C]."""
    b, n, _ = x2d.shape
    f = heads * dim_head
    dt = x2d.dtype
    xn = _rms_norm(x2d, g_pre)
    qkv = torch.matmul(xn, wqkv.to(dt))
    q, k, v = (qkv[..., i * f:(i + 1) * f].reshape(b, n, heads, dim_head)
               for i in range(3))
    out = linear_attention_reference(q, k, v).reshape(b, n, f)
    o = torch.matmul(out, wout.to(dt)) + bout.to(dt)
    return x2d + _rms_norm(o, g_out)


def _library() -> ctypes.CDLL:
    lib = _build.load("attn_block")
    fn = lib.ccdm_attn_block_forward
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _launch(x2d, g_pre, wqkv, wout, bout, g_out, heads, dim_head):
    if x2d.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_attn_block takes f32 or bf16, got {x2d.dtype}")
    if x2d.ndim != 3:
        raise ValueError(f"x2d must be [B, N, C], got shape {tuple(x2d.shape)}")
    if dim_head != DIM_HEAD:
        raise ValueError(f"the CUDA kernel takes dim_head {DIM_HEAD}, got {dim_head}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x2d, g_pre, wqkv, wout, bout, g_out)):
        raise NotImplementedError(
            "the attention block's backward kernel comes with the training "
            "slice (ROADMAP.md); call it under torch.no_grad()")
    b, n, c = x2d.shape
    f = heads * dim_head
    if not x2d.is_contiguous():
        raise ValueError("x2d must be contiguous")
    dt, dev = x2d.dtype, x2d.device
    weights = []
    for name, w, shape in (("g_pre", g_pre, (c,)), ("wqkv", wqkv, (c, 3 * f)),
                           ("wout", wout, (f, c)), ("bout", bout, (c,)),
                           ("g_out", g_out, (c,))):
        if tuple(w.shape) != shape or w.device != dev:
            raise ValueError(f"{name} must be {shape} on {dev}, got "
                             f"{tuple(w.shape)} on {w.device}")
        weights.append(w.to(dt).contiguous())  # the kernel's operand dtype
    y = torch.empty_like(x2d)
    qkv = torch.empty((b, n, 3 * f), dtype=torch.float32, device=dev)
    ctx = torch.empty((b, heads, dim_head, dim_head), dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ccdm_attn_block_forward(
            x2d.data_ptr(), *(w.data_ptr() for w in weights), y.data_ptr(),
            qkv.data_ptr(), ctx.data_ptr(), b, n, c, heads,
            int(dt == torch.bfloat16), stream)
    _build.check(lib, err, "attn_block kernel launch")
    fused_attn_block.launches += 1
    return y


def fused_attn_block(x2d: torch.Tensor, g_pre: torch.Tensor, wqkv: torch.Tensor,
                     wout: torch.Tensor, bout: torch.Tensor, g_out: torch.Tensor,
                     heads: int, dim_head: int) -> torch.Tensor:
    """The CUDA kernel for a CUDA tensor, the plain version for a CPU one."""
    if x2d.device.type == "cpu":
        return attn_block_reference(x2d, g_pre, wqkv, wout, bout, g_out, heads, dim_head)
    if x2d.device.type != "cuda":
        raise ValueError(f"fused_attn_block runs on cuda or cpu, not {x2d.device}")
    return _launch(x2d, g_pre, wqkv, wout, bout, g_out, heads, dim_head)


fused_attn_block.launches = 0  # kernel launches since the last reset
