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
  csrc/attn_block_large.cu;
- with a gradient otherwise: `_SinglePassBlock`, kernel #1 forward and the
  backward by autograd through `attn_block_reference`, as `jax.vjp` does.
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
import math

import torch

from ccdm_tpu_torch.ops import _build
from ccdm_tpu_torch.ops.linear_attention import _op, finalize_ctx, linear_attention_reference

DIM_HEAD = 32  # the kernels map one warp lane to each channel of a head
TWO_PASS_CHUNK = 2048  # N % 2048 == 0 takes the two-pass training path (as JAX)
_BLOCKS = 512  # blocks a backward or pass-A launch aims at (132 SMs, ~4 waves)


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
    return p, _op(p * DIM_HEAD ** -0.5, dt)


def ctx_large_reference(x2d, g_pre, wqkv, heads):
    """Plain kernel #2: (a [B, H, D, D], s [B, F], kmax [B, F]), f32."""
    dt, f = x2d.dtype, wqkv.shape[1] // 3
    _, _, xn = _prenorm(x2d, g_pre)
    kv = torch.matmul(_op(xn, dt), _op(wqkv[:, f:], dt))
    k, v = kv[..., :f], kv[..., f:]
    kmax = k.amax(dim=1)
    e = torch.exp(k - kmax[:, None])
    a = torch.einsum("bnhd,bnhe->bhde", _heads(_op(e, dt), heads), _heads(_op(v, dt), heads))
    return a, e.sum(dim=1), kmax


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
    d_p = torch.einsum("bnhe,bhde->bnhd", _heads(d_out, heads), ctx.float()) * DIM_HEAD ** -0.5
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


def _library() -> ctypes.CDLL:
    lib = _build.load("attn_block")
    fn = lib.ccdm_attn_block_forward
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _large_library() -> ctypes.CDLL:
    lib = _build.load("attn_block_large")
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, n_ptr, n_int in (("ccdm_attn_ctx_large", 9, 6), ("ccdm_attn_out_large", 8, 5),
                               ("ccdm_attn_bwd_a", 18, 7), ("ccdm_attn_bwd_b", 17, 7)):
        fn = getattr(lib, name)
        fn.argtypes = [p] * n_ptr + [i] * n_int + [p]
        fn.restype = ctypes.c_int
    return lib


def _check_activation(x2d, dim_head):
    if x2d.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the attention kernels take f32 or bf16, got {x2d.dtype}")
    if x2d.ndim != 3:
        raise ValueError(f"x2d must be [B, N, C], got shape {tuple(x2d.shape)}")
    if dim_head != DIM_HEAD:
        raise ValueError(f"the CUDA kernels take dim_head {DIM_HEAD}, got {dim_head}")
    if not x2d.is_contiguous():
        raise ValueError("x2d must be contiguous")


def _operand(name, t, shape, dev, dtype):
    """`t` checked against shape and device, as a contiguous `dtype` tensor."""
    if tuple(t.shape) != tuple(shape) or t.device != dev:
        raise ValueError(f"{name} must be {tuple(shape)} on {dev}, got "
                         f"{tuple(t.shape)} on {t.device}")
    return t.detach().to(dtype).contiguous()


def _splits(batch: int, n_tok: int) -> int:
    """Blocks per batch row of the per-token kernels of #2, #4 and #5."""
    return max(1, min(math.ceil(_BLOCKS / batch), math.ceil(n_tok / 32)))


def _wgrad_splits(m: int, rows: int, cols: int) -> int:
    """Token splits of a weight-gradient product of [rows, cols]."""
    tiles = math.ceil(rows / 64) * math.ceil(cols / 64)
    return max(1, min(math.ceil(_BLOCKS / tiles), math.ceil(m / 32)))


def _launch(x2d, g_pre, wqkv, wout, bout, g_out, heads, dim_head):
    """Kernel #1 on the card."""
    _check_activation(x2d, dim_head)
    b, n, c = x2d.shape
    f = heads * dim_head
    dt, dev = x2d.dtype, x2d.device
    weights = [_operand(name, w, shape, dev, dt)  # the kernel's operand dtype
               for name, w, shape in (("g_pre", g_pre, (c,)), ("wqkv", wqkv, (c, 3 * f)),
                                      ("wout", wout, (f, c)), ("bout", bout, (c,)),
                                      ("g_out", g_out, (c,)))]
    y = torch.empty_like(x2d)
    qkv = torch.empty((b, n, 3 * f), dtype=torch.float32, device=dev)
    ctx = torch.empty((b, heads, dim_head, dim_head), dtype=torch.float32, device=dev)
    _build.run(_library(), "ccdm_attn_block_forward", "attn_block kernel launch", dev,
               x2d, *weights, y, qkv, ctx, b, n, c, heads, int(dt == torch.bfloat16))
    fused_attn_block.launches += 1
    return y


def _large_inputs(x2d, heads, named):
    """Check the activation and cast the named weights as kernels #2-#5
    read them: matrices in the activation dtype, vectors in f32."""
    _check_activation(x2d, DIM_HEAD)
    c, f = x2d.shape[2], heads * DIM_HEAD
    shapes = {"g_pre": (c,), "wqkv": (c, 3 * f), "wout": (f, c), "bout": (c,),
              "g_out": (c,), "ctx": (x2d.shape[0], heads, DIM_HEAD, DIM_HEAD),
              "dy": x2d.shape, "do": x2d.shape, "kmax": (x2d.shape[0], f),
              "d_s": (x2d.shape[0], f), "d_a": (x2d.shape[0], heads, DIM_HEAD, DIM_HEAD)}
    matrices = ("wqkv", "wout", "ctx", "dy")
    return [_operand(name, t, shapes[name], x2d.device,
                     x2d.dtype if name in matrices else torch.float32)
            for name, t in named]


def attn_ctx_large(x2d, g_pre, wqkv, heads):
    """Kernel #2 (pass A): (a [B, H, D, D], s [B, F], kmax [B, F]), f32."""
    if x2d.device.type == "cpu":
        return ctx_large_reference(x2d, g_pre, wqkv, heads)
    g_pre, wqkv = _large_inputs(x2d, heads, (("g_pre", g_pre), ("wqkv", wqkv)))
    b, n, c = x2d.shape
    f = heads * DIM_HEAD
    nsplit = _splits(b, n)
    new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=x2d.device)
    m_part, s_part, a_part = new(b * nsplit, f), new(b * nsplit, f), new(b * nsplit, f, DIM_HEAD)
    kmax, s, a = new(b, f), new(b, f), new(b, heads, DIM_HEAD, DIM_HEAD)
    _build.run(_large_library(), "ccdm_attn_ctx_large", "attn_ctx_large kernel launch", x2d.device,
               x2d, g_pre, wqkv, m_part, s_part, a_part, kmax, s, a, b, n, c, heads, nsplit,
               int(x2d.dtype == torch.bfloat16))
    attn_ctx_large.launches += 1
    return a, s, kmax


def attn_out_large(x2d, g_pre, wqkv, ctx, wout, bout, g_out, heads):
    """Kernel #3 (pass B): y [B, N, C] in x's dtype."""
    if x2d.device.type == "cpu":
        return out_large_reference(x2d, g_pre, wqkv, ctx, wout, bout, g_out, heads)
    ins = _large_inputs(x2d, heads, (("g_pre", g_pre), ("wqkv", wqkv), ("ctx", ctx),
                                     ("wout", wout), ("bout", bout), ("g_out", g_out)))
    b, n, c = x2d.shape
    y = torch.empty_like(x2d)
    _build.run(_large_library(), "ccdm_attn_out_large", "attn_out_large kernel launch", x2d.device,
               x2d, *ins, y, b, n, c, heads, int(x2d.dtype == torch.bfloat16))
    attn_out_large.launches += 1
    return y


def attn_bwd_a(x2d, dy, g_pre, wqkv, ctx, wout, bout, g_out, heads):
    """Kernel #4: (do [B, N, C] f32, d_ctx [B, H, D, D], d_wout [F, C],
    d_bout [C], d_gout [C]), f32."""
    if x2d.device.type == "cpu":
        return bwd_a_reference(x2d, dy, g_pre, wqkv, ctx, wout, bout, g_out, heads)
    ins = _large_inputs(x2d, heads, (("dy", dy), ("g_pre", g_pre), ("wqkv", wqkv),
                                     ("ctx", ctx), ("wout", wout), ("bout", bout),
                                     ("g_out", g_out)))
    b, n, c = x2d.shape
    f = heads * DIM_HEAD
    nsplit, nsplit_w = _splits(b, n), _wgrad_splits(b * n, f, c)
    dev = x2d.device
    new = lambda *shape, dtype=torch.float32: torch.empty(shape, dtype=dtype, device=dev)
    do, out_g = new(b, n, c), new(b, n, f, dtype=x2d.dtype)
    dctx_part, db_part, dg_part = new(b * nsplit, f, DIM_HEAD), new(b * nsplit, c), new(b * nsplit, c)
    wg_part = new(nsplit_w, f, c)
    d_ctx, d_wout, d_bout, d_gout = new(b, heads, DIM_HEAD, DIM_HEAD), new(f, c), new(c), new(c)
    _build.run(_large_library(), "ccdm_attn_bwd_a", "attn_bwd_a kernel launch", dev,
               x2d, *ins, do, out_g, dctx_part, db_part, dg_part, wg_part, d_ctx, d_wout, d_bout,
               d_gout, b, n, c, heads, nsplit, nsplit_w, int(x2d.dtype == torch.bfloat16))
    attn_bwd_a.launches += 1
    return do, d_ctx, d_wout, d_bout, d_gout


def attn_bwd_b(x2d, dy, do, g_pre, wqkv, ctx, wout, kmax, d_a, d_s, heads):
    """Kernel #5: (dx in x's dtype, d_wqkv [C, 3F] f32, d_gpre [C] f32)."""
    if x2d.device.type == "cpu":
        return bwd_b_reference(x2d, dy, do, g_pre, wqkv, ctx, wout, kmax, d_a, d_s, heads)
    ins = _large_inputs(x2d, heads, (("dy", dy), ("do", do), ("g_pre", g_pre),
                                     ("wqkv", wqkv), ("ctx", ctx), ("wout", wout),
                                     ("kmax", kmax), ("d_a", d_a), ("d_s", d_s)))
    b, n, c = x2d.shape
    f = heads * DIM_HEAD
    nsplit, nsplit_w = _splits(b, n), _wgrad_splits(b * n, c, 3 * f)
    dev = x2d.device
    new = lambda *shape, dtype=torch.float32: torch.empty(shape, dtype=dtype, device=dev)
    dx, xn_g, dqkv_g = torch.empty_like(x2d), new(b, n, c, dtype=x2d.dtype), new(
        b, n, 3 * f, dtype=x2d.dtype)
    dg_part, wg_part = new(b * nsplit, c), new(nsplit_w, c, 3 * f)
    d_wqkv, d_gpre = new(c, 3 * f), new(c)
    _build.run(_large_library(), "ccdm_attn_bwd_b", "attn_bwd_b kernel launch", dev,
               x2d, *ins, dx, xn_g, dqkv_g, dg_part, wg_part, d_wqkv, d_gpre, b, n, c, heads,
               nsplit, nsplit_w, int(x2d.dtype == torch.bfloat16))
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
    """Kernel #1 on a CUDA tensor, its plain version on a CPU one."""
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
            if dim_head != DIM_HEAD:
                raise ValueError(f"the two-pass kernels take dim_head {DIM_HEAD}, "
                                 f"got {dim_head}")
            return _TwoPassBlock.apply(x2d.contiguous(), *args[1:], heads)
        return _SinglePassBlock.apply(*args, heads, dim_head)
    return _single_pass_forward(*args, heads, dim_head)


fused_attn_block.launches = 0  # kernel #1 launches since the last reset
attn_ctx_large.launches = 0    # kernel #2
attn_out_large.launches = 0    # kernel #3
attn_bwd_a.launches = 0        # kernel #4
attn_bwd_b.launches = 0        # kernel #5
