"""Linear attention: the plain version, the four kernels and the dispatcher.

Counterpart of ccdm_tpu/ops/linear_attention.py. For q, k, v [B, N, H, D]
and each head:

    out = softmax_D(q) D^-1/2 . (softmax_N(k)^T v)

The kernels are in csrc/linear_attention.cu, each the port of a TPU kernel:
- `linear_attention_fulllane`: kernel #6 (`_kernel_fulllane`);
- `linear_attention_ctx_twopass`: #7 (`_kernel_ctx_twopass`), the context
  a = exp(k - m)^T v and s = sum exp(k - m) over splits of N, given the
  column max m;
- `linear_attention_out_twopass`: #8 (`_kernel_out_twopass`), q's softmax
  times a finalised context;
- `linear_attention_per_head`: #9 (`_kernel`), #6's function with one cell
  per (batch, head), all in f32. As in JAX, no dispatcher reaches it.
Each wrapper launches its kernel on a CUDA tensor and runs its plain PyTorch
version (beside it here, with the kernel's rounding points) on a CPU tensor;
nothing falls back from one to the other. The kernels take D up to 128.
`la_plan` (computed in C from the shape alone) gives #6's and #8's route on
the card: "tensor" (bf16 at D % 16 == 0: whole token rows, the products on
the tensor cores, sums across blocks merged in a fixed order) or "cores"
(f32, and bf16 at other D: a head a block, f32 FMAs), with each launch's
tile and splits and #6's workspace. `twopass_plan` gives #7's ("tensor" or
"cores", at the same shapes) and `per_head_plan` #9's ("rows" in bf16 at
D % 16 == 0: #6's launches over whole rows with the products as f32 FMAs,
as #9 computes in f32; else "cores"), each with its splits and workspace.

`linear_attention` is the entry the `LinearAttention` module calls. Its
routes are JAX's (`route`), with a CUDA tensor in place of the TPU backend:
#6 when (H D) % 128 == 0 and N H D <= 4096 * 128; else #7 + #8 when
CCDM_TPU_TWOPASS_ATTN=1 and N % 2048 == 0; else the plain reference.
CCDM_TPU_FUSED_ATTN=0 sends everything to the reference. Both switches are
read once at import into `USE_KERNELS` and `USE_TWOPASS`. Its gradient is
autograd through `linear_attention_reference` on the saved q, k, v, as JAX's
custom_vjp takes jax.vjp of the reference: there is no backward kernel.

The q softmax of the kernels and their plain versions subtracts each head's
own max (JAX's #6 and #8 subtract the row's max over all heads, the same
function unless a head lies ~87 below that max and underflows to 0 there).
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import NamedTuple

import torch

from ccdm_tpu_torch.ops import _build

USE_KERNELS = os.environ.get("CCDM_TPU_FUSED_ATTN", "1") == "1"
USE_TWOPASS = os.environ.get("CCDM_TPU_TWOPASS_ATTN", "0") == "1"
MAX_CELL_ELEMS = 4096 * 128  # N H D of the largest #6 cell (JAX's VMEM guard)
TWOPASS_CHUNK = 2048
MAX_DIM_HEAD = 128  # the widest head the kernels take


def _op(t: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """Round to the products' operand dtype; compute on in f32."""
    return t.to(dt).float()


def finalize_ctx(a: torch.Tensor, s: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """ctx = a / s per k channel, in the operand dtype; a [B, H, D, D], s
    [B, H D] (ccdm_tpu/ops/linear_attention.py:36-43, diagonal blocks only).
    One definition for this module's two-pass path and the attention block's."""
    return (a / s.clamp_min(1e-30).view(*a.shape[:3], 1)).to(dtype)


def linear_attention_reference(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor) -> torch.Tensor:
    """q, k, v [B, N, H, D] -> out [B, N, H, D]; softmaxes and products in
    f32, the output in q's dtype. Also the plain version of kernel #9."""
    d = q.shape[-1]
    qf = torch.softmax(q.float(), dim=-1) * (d ** -0.5)
    kf = torch.softmax(k.float(), dim=1)
    ctx = torch.einsum("bnhd,bnhe->bhde", kf, v.float())
    out = torch.einsum("bhde,bnhd->bnhe", ctx, qf)
    return out.to(q.dtype)


# ------------------------------------------------------ plain kernels


def _q_prime(q: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """softmax_D(q) D^-1/2 (the head's own max; the sum guarded by 1e-30),
    rounded to dt."""
    qf = q.float()
    e = torch.exp(qf - qf.amax(-1, keepdim=True))
    return _op(e / e.sum(-1, keepdim=True).clamp_min(1e-30) * q.shape[-1] ** -0.5, dt)


def fulllane_reference(q, k, v):
    """Plain kernel #6: k' = softmax_N(k), v, ctx and q' rounded to q's dtype
    for the products, which accumulate in f32."""
    dt = q.dtype
    kf = k.float()
    e = torch.exp(kf - kf.amax(1, keepdim=True))
    kp = _op(e / e.sum(1, keepdim=True), dt)
    ctx = _op(torch.einsum("bnhd,bnhe->bhde", kp, _op(v, dt)), dt)
    return torch.einsum("bnhd,bhde->bnhe", _q_prime(q, dt), ctx).to(dt)


def ctx_twopass_reference(k, v, m):
    """Plain kernel #7: m [B, H D] f32 -> (a [B, H, D, D], s [B, H D]), f32;
    exp(k - m) and v rounded to k's dtype for the product, s summing the
    unrounded exp(k - m)."""
    b, n, h, d = k.shape
    e = torch.exp(k.float() - m.view(b, 1, h, d))
    a = torch.einsum("bnhd,bnhe->bhde", _op(e, k.dtype), _op(v, k.dtype))
    return a, e.sum(1).reshape(b, h * d)


def out_twopass_reference(q, ctx):
    """Plain kernel #8: ctx [B, H, D, D] in the operand dtype; q' rounded to
    it; the output in q's dtype."""
    return torch.einsum("bnhd,bhde->bnhe", _q_prime(q, ctx.dtype), ctx.float()).to(q.dtype)


# ------------------------------------------------------------ launches


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument and result types of the library's entry points (the
    card's library, or the g++ emulation's in the tests)."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, args in (("ccdm_la_fulllane", [p] * 5 + [i] * 5 + [ll]),
                       ("ccdm_la_per_head", [p] * 5 + [i] * 5 + [ll]),
                       ("ccdm_la_ctx_twopass", [p] * 6 + [i] * 6 + [ll]),
                       ("ccdm_la_out_twopass", [p] * 3 + [i] * 5)):
        fn = getattr(lib, name)
        fn.argtypes = args + [p]
        fn.restype = ctypes.c_int
    for name, ints in (("ccdm_la_plan", 5), ("ccdm_la_twopass_plan", 6),
                       ("ccdm_la_per_head_plan", 5)):
        fn = getattr(lib, name)
        fn.argtypes = [i] * ints + [ctypes.POINTER(i)]
        fn.restype = ll
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    return declare(_build.load("linear_attention"))


class LaPlan(NamedTuple):
    """The route of #6 and #8 ("cores" or "tensor"), the tile (tokens) and
    splits of #6's context launch and of the out pass (#6's last launch and
    #8), the splits of #6's statistics launch (tensor route; 0 on the CUDA
    cores), and #6's workspace in bytes."""
    route: str
    ctx_tile: int
    ctx_splits: int
    out_tile: int
    out_splits: int
    stat_splits: int
    ws_bytes: int


LA_ROUTES = ("cores", "tensor")


def plan_of(lib: ctypes.CDLL, b: int, n: int, h: int, d: int, bf16: bool) -> LaPlan:
    """ccdm_la_plan of `lib` for q [b, n, h, d]."""
    out = (ctypes.c_int * 6)()
    nbytes = lib.ccdm_la_plan(b, n, h, d, int(bf16), out)
    if nbytes < 0:
        raise ValueError(f"no linear-attention kernel takes B={b} N={n} H={h} D={d}")
    return LaPlan(LA_ROUTES[out[0]], *out[1:6], nbytes)


@functools.cache
def la_plan(b: int, n: int, h: int, d: int, dtype: torch.dtype) -> LaPlan:
    """The card's plan of #6 and #8 for q [b, n, h, d] of `dtype` (needs the
    built library)."""
    return plan_of(_library(), b, n, h, d, dtype == torch.bfloat16)


class TwopassPlan(NamedTuple):
    """#7's route ("cores" or "tensor"), its splits of N (chunks of `chunk`
    tokens on the CUDA cores, one wave of blocks on the tensor route) and
    its workspace in bytes."""
    route: str
    splits: int
    ws_bytes: int


class PerHeadPlan(NamedTuple):
    """#9's route ("cores" or "rows"), the splits of its statistics,
    context and out launches (0, 1, 1 on the CUDA cores: a block per
    (batch, head)) and its workspace in bytes."""
    route: str
    stat_splits: int
    ctx_splits: int
    out_splits: int
    ws_bytes: int


def twopass_plan_of(lib: ctypes.CDLL, b: int, n: int, h: int, d: int, chunk: int,
                    bf16: bool) -> TwopassPlan:
    """ccdm_la_twopass_plan of `lib` for k [b, n, h, d] and `chunk`."""
    out = (ctypes.c_int * 2)()
    nbytes = lib.ccdm_la_twopass_plan(b, n, h, d, chunk, int(bf16), out)
    if nbytes < 0:
        raise ValueError(f"#7 takes no B={b} N={n} H={h} D={d} chunk={chunk}")
    return TwopassPlan(LA_ROUTES[out[0]], out[1], nbytes)


def per_head_plan_of(lib: ctypes.CDLL, b: int, n: int, h: int, d: int,
                     bf16: bool) -> PerHeadPlan:
    """ccdm_la_per_head_plan of `lib` for q [b, n, h, d]."""
    out = (ctypes.c_int * 4)()
    nbytes = lib.ccdm_la_per_head_plan(b, n, h, d, int(bf16), out)
    if nbytes < 0:
        raise ValueError(f"#9 takes no B={b} N={n} H={h} D={d}")
    return PerHeadPlan(("cores", "rows")[out[0]], *out[1:4], nbytes)


@functools.cache
def twopass_plan(b: int, n: int, h: int, d: int, chunk: int, dtype: torch.dtype) -> TwopassPlan:
    """The card's plan of #7 (needs the built library)."""
    return twopass_plan_of(_library(), b, n, h, d, chunk, dtype == torch.bfloat16)


@functools.cache
def per_head_plan(b: int, n: int, h: int, d: int, dtype: torch.dtype) -> PerHeadPlan:
    """The card's plan of #9 (needs the built library)."""
    return per_head_plan_of(_library(), b, n, h, d, dtype == torch.bfloat16)


def _on_card(t: torch.Tensor) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU)."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the linear-attention kernels run on cuda or cpu, not {t.device}")
    return t.device.type == "cuda"


def _operands(q: torch.Tensor, *others: torch.Tensor) -> list[torch.Tensor]:
    """q and `others` checked as the kernels take them ([B, N, H, D], one
    dtype of f32 or bf16, one device, D <= 128), made contiguous."""
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the linear-attention kernels take f32 or bf16, got {q.dtype}")
    if q.ndim != 4 or not 1 <= q.shape[-1] <= MAX_DIM_HEAD:
        raise ValueError(f"q must be [B, N, H, D] with D <= {MAX_DIM_HEAD}, got "
                         f"{tuple(q.shape)}")
    for t in others:
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"k and v must match q {tuple(q.shape)} {q.dtype} on {q.device}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    return [t.detach().contiguous() for t in (q, *others)]


def linear_attention_fulllane(q, k, v):
    """Kernel #6: out [B, N, H, D] in q's dtype, on la_plan's route."""
    if not _on_card(q):
        return fulllane_reference(q, k, v)
    q, k, v = _operands(q, k, v)
    b, n, h, d = q.shape
    nbytes = la_plan(b, n, h, d, q.dtype).ws_bytes
    out = torch.empty_like(q)
    ws = torch.empty(nbytes, dtype=torch.uint8, device=q.device)
    _build.run(_library(), "ccdm_la_fulllane", "linear_attention_fulllane kernel launch",
               q.device, q, k, v, out, ws, b, n, h, d, int(q.dtype == torch.bfloat16), nbytes)
    linear_attention_fulllane.launches += 1
    return out


def linear_attention_per_head(q, k, v):
    """Kernel #9: out [B, N, H, D] in q's dtype, computed in f32, on
    per_head_plan's route."""
    if not _on_card(q):
        return linear_attention_reference(q, k, v)
    q, k, v = _operands(q, k, v)
    b, n, h, d = q.shape
    nbytes = per_head_plan(b, n, h, d, q.dtype).ws_bytes
    out = torch.empty_like(q)
    ws = torch.empty(nbytes, dtype=torch.uint8, device=q.device)
    _build.run(_library(), "ccdm_la_per_head", "linear_attention_per_head kernel launch",
               q.device, q, k, v, out, ws, b, n, h, d, int(q.dtype == torch.bfloat16), nbytes)
    linear_attention_per_head.launches += 1
    return out


def linear_attention_ctx_twopass(k, v, m, chunk: int = TWOPASS_CHUNK):
    """Kernel #7: m [B, H D] f32, the column max of k over N -> (a
    [B, H, D, D], s [B, H D]), f32, on twopass_plan's route. The CUDA cores
    sum per chunk of `chunk` tokens (the last may be short), then the chunks
    in order; the tensor route takes its splits of N from the plan whatever
    the chunk (JAX's chunk is a VMEM block size: it does not change the
    function)."""
    if not _on_card(k):
        return ctx_twopass_reference(k, v, m)
    k, v = _operands(k, v)
    b, n, h, d = k.shape
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    m = m.detach().float().contiguous()
    if tuple(m.shape) != (b, h * d) or m.device != k.device:
        raise ValueError(f"m must be {(b, h * d)} on {k.device}, got {tuple(m.shape)} "
                         f"on {m.device}")
    nbytes = twopass_plan(b, n, h, d, chunk, k.dtype).ws_bytes
    a = torch.empty(b, h, d, d, dtype=torch.float32, device=k.device)
    s = torch.empty(b, h * d, dtype=torch.float32, device=k.device)
    ws = torch.empty(nbytes, dtype=torch.uint8, device=k.device)
    _build.run(_library(), "ccdm_la_ctx_twopass", "linear_attention_ctx_twopass kernel launch",
               k.device, k, v, m, a, s, ws, b, n, h, d, chunk, int(k.dtype == torch.bfloat16),
               nbytes)
    linear_attention_ctx_twopass.launches += 1
    return a, s


def linear_attention_out_twopass(q, ctx):
    """Kernel #8: ctx [B, H, D, D], finalised, in q's dtype -> out
    [B, N, H, D] in q's dtype; #6's out pass, on la_plan's route."""
    if not _on_card(q):
        return out_twopass_reference(q, ctx)
    (q,) = _operands(q)
    b, n, h, d = q.shape
    if tuple(ctx.shape) != (b, h, d, d) or ctx.dtype != q.dtype or ctx.device != q.device:
        raise ValueError(f"ctx must be {(b, h, d, d)} {q.dtype} on {q.device}, got "
                         f"{tuple(ctx.shape)} {ctx.dtype} on {ctx.device}")
    out = torch.empty_like(q)
    _build.run(_library(), "ccdm_la_out_twopass", "linear_attention_out_twopass kernel launch",
               q.device, q, ctx.detach().contiguous(), out, b, n, h, d,
               int(q.dtype == torch.bfloat16))
    linear_attention_out_twopass.launches += 1
    return out


def linear_attention_twopass(q, k, v, chunk: int = TWOPASS_CHUNK):
    """Kernels #7 + #8 (JAX `_forward_pallas_twopass`): the column max and
    the finalised context are plain torch between them, as XLA computes
    them between the TPU kernels."""
    b, n, h, d = k.shape
    m = k.amax(dim=1).float().reshape(b, h * d)
    a, s = linear_attention_ctx_twopass(k, v, m, chunk)
    return linear_attention_out_twopass(q, finalize_ctx(a, s, q.dtype))


# ------------------------------------------------------- the dispatcher


def route(shape, on_card: bool) -> str:
    """"fulllane" (#6), "twopass" (#7 + #8) or "reference" for q of `shape`
    [B, N, H, D] (ccdm_tpu/ops/linear_attention.py:350-356)."""
    _, n, h, d = shape
    if USE_KERNELS and on_card and (h * d) % 128 == 0:
        if n * h * d <= MAX_CELL_ELEMS:
            return "fulllane"
        if USE_TWOPASS and n % TWOPASS_CHUNK == 0:
            return "twopass"
    return "reference"


_ROUTES = {"fulllane": linear_attention_fulllane, "twopass": linear_attention_twopass,
           "reference": linear_attention_reference}


class _LinearAttention(torch.autograd.Function):
    """The routed forward; the backward recomputes the reference under
    autograd (ccdm_tpu/ops/linear_attention.py:359-369)."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _ROUTES[route(q.shape, _on_card(q))](q, k, v)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = linear_attention_reference(*inputs)
            return torch.autograd.grad(out, inputs, g)


def linear_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Linear attention, q, k, v [B, N, H, D] -> [B, N, H, D], routed as
    the module docstring says."""
    return _LinearAttention.apply(q, k, v)


linear_attention_fulllane.launches = 0     # kernel #6 launches since the last reset
linear_attention_ctx_twopass.launches = 0  # kernel #7
linear_attention_out_twopass.launches = 0  # kernel #8
linear_attention_per_head.launches = 0     # kernel #9
