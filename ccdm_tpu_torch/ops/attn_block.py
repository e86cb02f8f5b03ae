"""Fused attention block: pre-norm + qkv + linear attention + out + out-norm.

Counterpart of ccdm_tpu/ops/attn_block.py. For x [B, N, C]:

    y = x + RMSNorm_gout(Wout . LA(Wqkv . RMSNorm_gpre(x)) + bout)

`fused_attn_block` is the entry the model calls. It mirrors the JAX
module's `_dispatch`, `_can_fuse_bwd` and `_fwd` (attn_block.py:557-611):
- without a gradient: the single-pass kernel #1 (csrc/attn_block.cu, the
  port of the TPU kernel `_kernel`) at every N;
- with a gradient, N % 2048 == 0 and F % 128 == 0: `_TwoPassBlock`. Its
  forward is the two-pass kernels #2 + #3 (`attn_ctx_large`,
  `attn_out_large`), saving the residuals (a, s, kmax); its backward is the
  fused kernels #4 + #5 (`attn_bwd_a`, `attn_bwd_b`); all four are in
  csrc/attn_block_large.cu, in bf16 on the tensor cores at the UNets' shapes
  at dim 64 and at UK64's C 72 (`large_plan`);
- with a gradient otherwise: `_SinglePassBlock`, kernel #1 forward and the
  backward by autograd through `attn_block_reference`, as `jax.vjp` does.
Every kernel takes any dim_head: the tensor-core routes take heads of
DIM_HEAD (32) channels, and the plans send every other dim_head to the
kernels' CUDA-core routes, as they do f32.
Each kernel wrapper launches its kernel on a CUDA tensor and runs its plain
PyTorch version (beside it here) on a CPU tensor, so the CPU tests drive the
same autograd Functions. Nothing falls back from one to the other.

Numerics: norms and softmaxes in f32; products take operands in the
activation dtype (bf16 or f32) with f32 accumulation. Weights are passed in
the layout of the JAX module: wqkv [C, 3F], wout [F, C]. The two-pass
residuals are kept per head: a and ctx [B, H, D, D] (the diagonal blocks of
the TPU kernels' [B, F, F]), s and kmax [B, F].
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ccdm_tpu_torch.ops import _build
from ccdm_tpu_torch.ops.linear_attention import _op, finalize_ctx, linear_attention_reference

DIM_HEAD = 32  # the dim_head of the tensor-core routes: a warp column of 32 a head
TWO_PASS_CHUNK = 2048  # N % 2048 == 0 takes the two-pass training path (as JAX)


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


# ------------------------------------------------- plain kernels #2 - #5


def _heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    return t.reshape(*t.shape[:-1], heads, -1)


def _prenorm(x2d, g_pre):
    """(x in f32, 1 / rms(x), RMSNorm_gpre(x) in f32)."""
    xf = x2d.float()
    inv = torch.rsqrt(xf.square().mean(-1, keepdim=True) + 1e-12)
    return xf, inv, xf * inv * g_pre.float()


def _q_prime(xn, wqkv, heads, dt):
    """(p, the per-head softmax of q [B, N, H, D] f32; q' = p D^-1/2 as
    an operand)."""
    f = wqkv.shape[1] // 3
    q = torch.matmul(_op(xn, dt), _op(wqkv[:, :f], dt))
    p = torch.softmax(_heads(q, heads), dim=-1)
    return p, _op(p * p.shape[-1] ** -0.5, dt)


def _ctx_of(xn, wqkv, heads, dt):
    """(a, s, kmax) of kernel #2 from xn in f32, products on `dt` operands."""
    f = wqkv.shape[1] // 3
    kv = torch.matmul(_op(xn, dt), _op(wqkv[:, f:], dt))
    k, v = kv[..., :f], kv[..., f:]
    kmax = k.amax(dim=1)
    e = torch.exp(k - kmax[:, None])
    a = torch.einsum("bnhd,bnhe->bhde", _heads(_op(e, dt), heads), _heads(_op(v, dt), heads))
    return a, e.sum(dim=1), kmax


def ctx_large_reference(x2d, g_pre, wqkv, heads):
    """Plain kernel #2: (a [B, H, D, D], s [B, F], kmax [B, F]), f32."""
    return _ctx_of(_prenorm(x2d, g_pre)[2], wqkv, heads, x2d.dtype)


def tensor_route_prenorm(x2d, g_pre):
    """xn in f32, before its bf16 rounding, as the tensor-core route of
    kernels #2-#5 forms it (csrc/attn_block_large.cu, warp_norm16): the row
    padded with zeros to whole 32-column blocks (pad32: C 72 -> 96), the
    squares of each half of the padded row summed in order, the two halves
    added, divided by the true C, plus 1e-12, then 1 / sqrt correctly
    rounded to f32, and x inv g_pre. For bf16 x each square is exact in
    f32, so the kernel's fmaf adds it as + does here; the padding adds exact
    zeros."""
    xf = x2d.float()
    c = x2d.shape[-1]
    sq = torch.nn.functional.pad(xf * xf, (0, -(-c // 32) * 32 - c))
    half = sq.shape[-1] // 2
    lo, hi = torch.zeros_like(sq[..., 0]), torch.zeros_like(sq[..., 0])
    for j in range(half):
        lo, hi = lo + sq[..., j], hi + sq[..., half + j]
    v = (lo + hi) / c + 1e-12
    inv = (1 / torch.sqrt(v.double())).float()
    return xf * inv[..., None] * g_pre.float()


def ctx_large_tensor_reference(x2d, g_pre, wqkv, heads):
    """Plain kernel #2 at the rounding points of its bf16 tensor-core route:
    ctx_large_reference with xn formed as tensor_route_prenorm forms it, so
    that its kmax is the kernel's up to the order of the products' sums."""
    return _ctx_of(tensor_route_prenorm(x2d, g_pre), wqkv, heads, x2d.dtype)


def finalize_ctx_backward(d_ctx, a, s):
    """(d_a [B, H, D, D], d_s [B, F]) from d_ctx (attn_block.py:522-530)."""
    s_t = s.clamp_min(1e-30).view(*a.shape[:3], 1)
    d_s = -(d_ctx * (a / s_t)).sum(-1, keepdim=True) / s_t
    return d_ctx / s_t, d_s.reshape(s.shape)


def out_large_reference(x2d, g_pre, wqkv, ctx, wout, bout, g_out, heads):
    """Plain kernel #3: y [B, N, C] in x's dtype; ctx [B, H, D, D]."""
    dt = x2d.dtype
    xf, _, xn = _prenorm(x2d, g_pre)
    _, qs = _q_prime(xn, wqkv, heads, dt)
    out = torch.einsum("bnhd,bhde->bnhe", qs, ctx.float()).flatten(2)
    o = torch.matmul(_op(out, dt), _op(wout, dt)) + bout.float()
    r2 = torch.rsqrt(o.square().mean(-1, keepdim=True) + 1e-12)
    return (xf + o * r2 * g_out.float()).to(dt)


def bwd_a_reference(x2d, dy, g_pre, wqkv, ctx, wout, bout, g_out, heads):
    """Plain kernel #4: (do [B, N, C] f32, d_ctx [B, H, D, D], d_wout [F, C],
    d_bout [C], d_gout [C]), f32."""
    dt = x2d.dtype
    _, _, xn = _prenorm(x2d, g_pre)
    _, qs = _q_prime(xn, wqkv, heads, dt)
    out = _op(torch.einsum("bnhd,bhde->bnhe", qs, ctx.float()).flatten(2), dt)
    o = torch.matmul(out, _op(wout, dt)) + bout.float()
    r2 = torch.rsqrt(o.square().mean(-1, keepdim=True) + 1e-12)
    dyf = dy.float()
    d_on = dyf * g_out.float()
    do = r2 * d_on - o * r2 ** 3 * (o * d_on).mean(-1, keepdim=True)
    d_out = torch.matmul(_op(do, dt), _op(wout, dt).T)
    d_ctx = torch.einsum("bnhd,bnhe->bhde", qs, _heads(_op(d_out, dt), heads))
    d_wout = torch.einsum("bnf,bnc->fc", out, _op(do, dt))
    return do, d_ctx, d_wout, do.sum((0, 1)), (dyf * o * r2).sum((0, 1))


def bwd_b_reference(x2d, dy, do, g_pre, wqkv, ctx, wout, kmax, d_a, d_s, heads):
    """Plain kernel #5: (dx in x's dtype, d_wqkv [C, 3F] f32, d_gpre [C])."""
    dt, f = x2d.dtype, wqkv.shape[1] // 3
    xf, inv, xn = _prenorm(x2d, g_pre)
    qkv = torch.matmul(_op(xn, dt), _op(wqkv, dt))
    k, v = qkv[..., f:2 * f], qkv[..., 2 * f:]
    d_out = _op(torch.matmul(_op(do, dt), _op(wout, dt).T), dt)
    p, _ = _q_prime(xn, wqkv, heads, dt)
    d_p = torch.einsum("bnhe,bhde->bnhd", _heads(d_out, heads), ctx.float()) * ctx.shape[-1] ** -0.5
    d_q = p * (d_p - (d_p * p).sum(-1, keepdim=True))
    e = torch.exp(k - kmax[:, None])
    d_e = torch.einsum("bnhe,bhde->bnhd", _heads(_op(v, dt), heads), d_a).flatten(2)
    d_k = e * (d_e + d_s[:, None])
    d_v = torch.einsum("bnhd,bhde->bnhe", _heads(_op(e, dt), heads), d_a).flatten(2)
    d_qkv = _op(torch.cat([d_q.flatten(2), d_k, d_v], dim=-1), dt)
    d_wqkv = torch.einsum("bnc,bnj->cj", _op(xn, dt), d_qkv)
    d_xn = torch.matmul(d_qkv, _op(wqkv, dt).T)
    d_gpre = (d_xn * xf * inv).sum((0, 1))
    du = d_xn * g_pre.float()
    dx = inv * du - xf * inv ** 3 * (xf * du).mean(-1, keepdim=True)
    return (dy.float() + dx).to(dt), d_wqkv, d_gpre


# ------------------------------------------------------------- launches


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Sets the ctypes signatures of csrc/attn_block.cu's entry points on a
    library built from it (here, in the g++ emulation or as a variant)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ccdm_attn_block_forward.argtypes = [p] * 8 + [i] * 6 + [ctypes.c_longlong, p]
    lib.ccdm_attn_block_forward.restype = i
    lib.ccdm_attn_block_plan.argtypes = [i] * 6 + [ctypes.POINTER(i)]
    lib.ccdm_attn_block_plan.restype = ctypes.c_longlong
    lib.ccdm_cuda_error_string.argtypes = [i]
    lib.ccdm_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    """Kernel #1's library, declared once."""
    return declare(_build.load("attn_block"))


def declare_large(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Sets the ctypes signatures of csrc/attn_block_large.cu's entry points
    on a library built from it (here, in the g++ emulation or as a variant)."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ccdm_attn_ctx_large.argtypes = [p] * 7 + [i] * 6 + [ll, p]
    lib.ccdm_attn_out_large.argtypes = [p] * 8 + [i] * 6 + [p]
    for name in ("ccdm_attn_bwd_a", "ccdm_attn_bwd_b"):
        getattr(lib, name).argtypes = [p] * 14 + [i] * 6 + [ll, p]
    for name in ("ccdm_attn_ctx_large", "ccdm_attn_out_large", "ccdm_attn_bwd_a",
                 "ccdm_attn_bwd_b"):
        getattr(lib, name).restype = i
    lib.ccdm_attn_large_plan.argtypes = [i] * 7 + [ctypes.POINTER(i)]
    lib.ccdm_attn_large_plan.restype = ll
    lib.ccdm_cuda_error_string.argtypes = [i]
    lib.ccdm_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _large_library() -> ctypes.CDLL:
    """Kernels #2-#5's library, declared once."""
    return declare_large(_build.load("attn_block_large"))


class Plan(NamedTuple):
    """How csrc/attn_block.cu runs one call of kernel #1: route "cores" (CUDA
    cores, three launches through an f32 qkv workspace: f32, or bf16 with
    heads != 4, dim_head != 32, C > 512 or no fit in shared memory), "fused" (bf16 on the
    tensor cores, one launch, a block per batch row) or "split" (bf16 on the
    tensor cores: pass 1 over `splits` blocks per batch row, the reduce,
    pass 2); the tokens of a tile and the workspace bytes the call needs."""
    route: str
    tile: int
    splits: int
    workspace_bytes: int


@functools.lru_cache(maxsize=None)
def plan(batch: int, n_tok: int, c: int, heads: int, dtype: torch.dtype,
         dim_head: int = DIM_HEAD) -> Plan:
    """Kernel #1's plan at this shape, as the C code computes it (a function
    of the shape alone)."""
    out = (ctypes.c_int * 3)()
    nbytes = _library().ccdm_attn_block_plan(batch, n_tok, c, heads, dim_head,
                                             int(dtype == torch.bfloat16), out)
    if out[0] < 0:
        raise ValueError(f"kernel #1 takes no empty shape, got B {batch}, N {n_tok}, C {c}")
    return Plan(("cores", "fused", "split")[out[0]], out[1], out[2], nbytes)


class LargePlan(NamedTuple):
    """How csrc/attn_block_large.cu runs one call of kernel #2, #3, #4 or #5:
    route "cores" (CUDA cores: f32, or bf16 at heads != 4, dim_head != 32, C
    above 128, or C not a multiple of 8) or "tensor" (bf16 on the tensor
    cores; all four pad C to whole 32-column blocks in shared memory, UK64's
    C 72 to 96); the
    tokens of a tile, the blocks per batch row, the token splits of the
    weight-gradient launch (#5 only, and #4 on the CUDA cores) and the
    workspace bytes (#3 needs none)."""
    route: str
    tile: int
    splits: int
    wgrad_splits: int
    workspace_bytes: int


@functools.lru_cache(maxsize=None)
def large_plan(kernel: int, batch: int, n_tok: int, c: int, heads: int,
               dtype: torch.dtype, dim_head: int = DIM_HEAD) -> LargePlan:
    """The plan of kernel #`kernel` (2 to 5) at this shape, as the C code
    computes it (a function of the shape alone)."""
    out = (ctypes.c_int * 4)()
    nbytes = _large_library().ccdm_attn_large_plan(kernel, batch, n_tok, c, heads, dim_head,
                                                   int(dtype == torch.bfloat16), out)
    if out[0] < 0:
        raise ValueError(f"kernel #{kernel} takes no empty shape, got B {batch}, N {n_tok}, C {c}")
    return LargePlan(("cores", "tensor")[out[0]], out[1], out[2], out[3], nbytes)


def _check_activation(x2d):
    if x2d.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the attention kernels take f32 or bf16, got {x2d.dtype}")
    if x2d.ndim != 3:
        raise ValueError(f"x2d must be [B, N, C], got shape {tuple(x2d.shape)}")
    if not x2d.is_contiguous():
        raise ValueError("x2d must be contiguous")


def _operand(name, t, shape, dev, dtype):
    """`t` checked against shape and device, as a contiguous `dtype` tensor."""
    if tuple(t.shape) != tuple(shape) or t.device != dev:
        raise ValueError(f"{name} must be {tuple(shape)} on {dev}, got "
                         f"{tuple(t.shape)} on {t.device}")
    return t.detach().to(dtype).contiguous()


def _launch(x2d, g_pre, wqkv, wout, bout, g_out, heads, dim_head):
    """Kernel #1 on the card."""
    _check_activation(x2d)
    b, n, c = x2d.shape
    f = heads * dim_head
    dt, dev = x2d.dtype, x2d.device
    weights = [_operand(name, w, shape, dev, dt)  # the kernel's operand dtype
               for name, w, shape in (("g_pre", g_pre, (c,)), ("wqkv", wqkv, (c, 3 * f)),
                                      ("wout", wout, (f, c)), ("bout", bout, (c,)),
                                      ("g_out", g_out, (c,)))]
    pl = plan(b, n, c, heads, dt, dim_head)
    y = torch.empty_like(x2d)
    ws = (torch.empty(pl.workspace_bytes // 4, dtype=torch.float32, device=dev)
          if pl.workspace_bytes else None)
    _build.run(_library(), "ccdm_attn_block_forward", "attn_block kernel launch", dev,
               x2d, *weights, y, ws, b, n, c, heads, dim_head, int(dt == torch.bfloat16),
               pl.workspace_bytes)
    fused_attn_block.launches += 1
    return y


def _dim_head(wqkv, heads):
    """The dim_head of kernels #2-#5's call: wqkv is [C, 3 heads dim_head]."""
    return wqkv.shape[-1] // (3 * heads)


def _large_inputs(x2d, heads, dim_head, named):
    """Check the activation and cast the named weights as kernels #2-#5
    read them: matrices in the activation dtype, vectors in f32."""
    _check_activation(x2d)
    c, f, d = x2d.shape[2], heads * dim_head, dim_head
    shapes = {"g_pre": (c,), "wqkv": (c, 3 * f), "wout": (f, c), "bout": (c,),
              "g_out": (c,), "ctx": (x2d.shape[0], heads, d, d),
              "dy": x2d.shape, "do": x2d.shape, "kmax": (x2d.shape[0], f),
              "d_s": (x2d.shape[0], f), "d_a": (x2d.shape[0], heads, d, d)}
    matrices = ("wqkv", "wout", "ctx", "dy")
    return [_operand(name, t, shapes[name], x2d.device,
                     x2d.dtype if name in matrices else torch.float32)
            for name, t in named]


def attn_ctx_large(x2d, g_pre, wqkv, heads):
    """Kernel #2 (pass A): (a [B, H, D, D], s [B, F], kmax [B, F]), f32."""
    if x2d.device.type == "cpu":
        return ctx_large_reference(x2d, g_pre, wqkv, heads)
    d = _dim_head(wqkv, heads)
    g_pre, wqkv = _large_inputs(x2d, heads, d, (("g_pre", g_pre), ("wqkv", wqkv)))
    b, n, c = x2d.shape
    pl, ws = _workspace(2, x2d, heads, d)
    new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=x2d.device)
    kmax, s, a = new(b, heads * d), new(b, heads * d), new(b, heads, d, d)
    _build.run(_large_library(), "ccdm_attn_ctx_large", "attn_ctx_large kernel launch", x2d.device,
               x2d, g_pre, wqkv, kmax, s, a, ws, b, n, c, heads, d,
               int(x2d.dtype == torch.bfloat16), pl.workspace_bytes)
    attn_ctx_large.launches += 1
    return a, s, kmax


def attn_out_large(x2d, g_pre, wqkv, ctx, wout, bout, g_out, heads):
    """Kernel #3 (pass B): y [B, N, C] in x's dtype."""
    if x2d.device.type == "cpu":
        return out_large_reference(x2d, g_pre, wqkv, ctx, wout, bout, g_out, heads)
    d = _dim_head(wqkv, heads)
    ins = _large_inputs(x2d, heads, d, (("g_pre", g_pre), ("wqkv", wqkv), ("ctx", ctx),
                                        ("wout", wout), ("bout", bout), ("g_out", g_out)))
    b, n, c = x2d.shape
    y = torch.empty_like(x2d)
    _build.run(_large_library(), "ccdm_attn_out_large", "attn_out_large kernel launch", x2d.device,
               x2d, *ins, y, b, n, c, heads, d, int(x2d.dtype == torch.bfloat16))
    attn_out_large.launches += 1
    return y


def _workspace(kernel, x2d, heads, dim_head):
    """(the plan of #2, #4 or #5 for x2d, its workspace: bytes as f32 on x's device)."""
    b, n, c = x2d.shape
    pl = large_plan(kernel, b, n, c, heads, x2d.dtype, dim_head)
    return pl, torch.empty(-(-pl.workspace_bytes // 4), dtype=torch.float32, device=x2d.device)


def attn_bwd_a(x2d, dy, g_pre, wqkv, ctx, wout, bout, g_out, heads):
    """Kernel #4: (do [B, N, C] f32, d_ctx [B, H, D, D], d_wout [F, C],
    d_bout [C], d_gout [C]), f32."""
    if x2d.device.type == "cpu":
        return bwd_a_reference(x2d, dy, g_pre, wqkv, ctx, wout, bout, g_out, heads)
    d = _dim_head(wqkv, heads)
    ins = _large_inputs(x2d, heads, d, (("dy", dy), ("g_pre", g_pre), ("wqkv", wqkv),
                                        ("ctx", ctx), ("wout", wout), ("bout", bout),
                                        ("g_out", g_out)))
    b, n, c = x2d.shape
    pl, ws = _workspace(4, x2d, heads, d)
    new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=x2d.device)
    do, d_ctx, d_wout, d_bout, d_gout = (new(b, n, c), new(b, heads, d, d),
                                         new(heads * d, c), new(c), new(c))
    _build.run(_large_library(), "ccdm_attn_bwd_a", "attn_bwd_a kernel launch", x2d.device,
               x2d, *ins, do, d_ctx, d_wout, d_bout, d_gout, ws, b, n, c, heads, d,
               int(x2d.dtype == torch.bfloat16), pl.workspace_bytes)
    attn_bwd_a.launches += 1
    return do, d_ctx, d_wout, d_bout, d_gout


def attn_bwd_b(x2d, dy, do, g_pre, wqkv, ctx, wout, kmax, d_a, d_s, heads):
    """Kernel #5: (dx in x's dtype, d_wqkv [C, 3F] f32, d_gpre [C] f32)."""
    if x2d.device.type == "cpu":
        return bwd_b_reference(x2d, dy, do, g_pre, wqkv, ctx, wout, kmax, d_a, d_s, heads)
    d = _dim_head(wqkv, heads)
    ins = _large_inputs(x2d, heads, d, (("dy", dy), ("do", do), ("g_pre", g_pre),
                                        ("wqkv", wqkv), ("ctx", ctx), ("wout", wout),
                                        ("kmax", kmax), ("d_a", d_a), ("d_s", d_s)))
    b, n, c = x2d.shape
    pl, ws = _workspace(5, x2d, heads, d)
    dx = torch.empty_like(x2d)
    d_wqkv, d_gpre = (torch.empty(shape, dtype=torch.float32, device=x2d.device)
                      for shape in ((c, 3 * heads * d), (c,)))
    _build.run(_large_library(), "ccdm_attn_bwd_b", "attn_bwd_b kernel launch", x2d.device,
               x2d, *ins, dx, d_wqkv, d_gpre, ws, b, n, c, heads, d,
               int(x2d.dtype == torch.bfloat16), pl.workspace_bytes)
    attn_bwd_b.launches += 1
    return dx, d_wqkv, d_gpre


# ---------------------------------------------------- autograd Functions


class _TwoPassBlock(torch.autograd.Function):
    """Kernels #2 + #3 forward, saving (a, s, kmax); #4 + #5 backward."""

    @staticmethod
    def forward(ctx, x2d, g_pre, wqkv, wout, bout, g_out, heads):
        a, s, kmax = attn_ctx_large(x2d, g_pre, wqkv, heads)
        y = attn_out_large(x2d, g_pre, wqkv, finalize_ctx(a, s, x2d.dtype), wout, bout,
                           g_out, heads)
        ctx.save_for_backward(x2d, g_pre, wqkv, wout, bout, g_out, a, s, kmax)
        ctx.heads = heads
        return y

    @staticmethod
    def backward(ctx, dy):
        x2d, g_pre, wqkv, wout, bout, g_out, a, s, kmax = ctx.saved_tensors
        dy = dy.to(x2d.dtype).contiguous()
        cx = finalize_ctx(a, s, x2d.dtype)
        do, d_ctx, d_wout, d_bout, d_gout = attn_bwd_a(x2d, dy, g_pre, wqkv, cx, wout, bout,
                                                       g_out, ctx.heads)
        d_a, d_s = finalize_ctx_backward(d_ctx, a, s)
        dx, d_wqkv, d_gpre = attn_bwd_b(x2d, dy, do, g_pre, wqkv, cx, wout, kmax, d_a, d_s,
                                        ctx.heads)
        return (dx, d_gpre.to(g_pre.dtype), d_wqkv.to(wqkv.dtype), d_wout.to(wout.dtype),
                d_bout.to(bout.dtype), d_gout.to(g_out.dtype), None)


def _single_pass_forward(x2d, g_pre, wqkv, wout, bout, g_out, heads, dim_head):
    """Kernel #1 on a CUDA tensor; its plain version on a CPU tensor."""
    if x2d.device.type == "cpu":
        return attn_block_reference(x2d, g_pre, wqkv, wout, bout, g_out, heads, dim_head)
    return _launch(x2d, g_pre, wqkv, wout, bout, g_out, heads, dim_head)


class _SinglePassBlock(torch.autograd.Function):
    """Kernel #1 forward; the backward recomputes `attn_block_reference`
    under autograd (jax.vjp of the reference, attn_block.py:605-609)."""

    @staticmethod
    def forward(ctx, x2d, g_pre, wqkv, wout, bout, g_out, heads, dim_head):
        ctx.save_for_backward(x2d, g_pre, wqkv, wout, bout, g_out)
        ctx.heads, ctx.dim_head = heads, dim_head
        return _single_pass_forward(x2d, g_pre, wqkv, wout, bout, g_out, heads, dim_head)

    @staticmethod
    def backward(ctx, dy):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            y = attn_block_reference(*inputs, ctx.heads, ctx.dim_head)
            grads = torch.autograd.grad(y, inputs, dy)
        return (*grads, None, None)


def takes_two_pass(n_tok: int, f: int) -> bool:
    """The training route's test (JAX `_can_fuse_bwd`): N % 2048 == 0 and
    F % 128 == 0."""
    return n_tok % TWO_PASS_CHUNK == 0 and f % 128 == 0


def fused_attn_block(x2d: torch.Tensor, g_pre: torch.Tensor, wqkv: torch.Tensor,
                     wout: torch.Tensor, bout: torch.Tensor, g_out: torch.Tensor,
                     heads: int, dim_head: int) -> torch.Tensor:
    """The block, routed as the module docstring says."""
    if x2d.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_attn_block runs on cuda or cpu, not {x2d.device}")
    args = (x2d, g_pre, wqkv, wout, bout, g_out)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        if takes_two_pass(x2d.shape[1], heads * dim_head):
            return _TwoPassBlock.apply(x2d.contiguous(), *args[1:], heads)
        return _SinglePassBlock.apply(*args, heads, dim_head)
    return _single_pass_forward(*args, heads, dim_head)


fused_attn_block.launches = 0  # kernel #1 launches since the last reset
attn_ctx_large.launches = 0    # kernel #2
attn_out_large.launches = 0    # kernel #3
attn_bwd_a.launches = 0        # kernel #4
attn_bwd_b.launches = 0        # kernel #5
