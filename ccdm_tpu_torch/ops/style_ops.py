"""StyleGAN's style ops: fused bias + activation, upfirdn2d, filtered_lrelu.

Counterpart of ccdm_tpu/ops/style_ops.py, in its NHWC layout (channels
last):
- `bias_act`: bias, one of 9 activations with the reference's default alpha
  and gain, gain and clamp. `impl="ref"` computes op by op in x's dtype, as
  JAX's jnp path does; `impl="cuda"` is kernel #12 (`bias_act_fused`, the
  port of the TPU kernel `_bias_act_pallas`, csrc/style_ops.cu), which
  computes in f32 and rounds once to x's dtype (in bf16 the two differ by up
  to two units in the last place); `impl="auto"` takes the kernel for a CUDA
  tensor under JAX's conditions (x.ndim >= 2, C % 128 == 0, the bias on the
  last dim), else the reference. `impl="cuda"` on a CPU tensor raises.
- `upfirdn2d`: zero-insert upsampling, padding (negative crops), the FIR
  filter as a grouped conv2d, and the stride as downsampling; a 1-D filter
  runs as two thin convs. Plain PyTorch, as JAX's is plain XLA.
- `filtered_lrelu`: upfirdn2d(up) -> bias + lrelu + clamp -> upfirdn2d(down).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from ccdm_tpu_torch.ops import _build


@dataclasses.dataclass(frozen=True)
class _ActSpec:
    fn: Callable
    def_alpha: float
    def_gain: float


activation_funcs = {
    "linear": _ActSpec(lambda x, a: x, 0.0, 1.0),
    "relu": _ActSpec(lambda x, a: F.relu(x), 0.0, math.sqrt(2)),
    "lrelu": _ActSpec(lambda x, a: F.leaky_relu(x, a), 0.2, math.sqrt(2)),
    "tanh": _ActSpec(lambda x, a: torch.tanh(x), 0.0, 1.0),
    "sigmoid": _ActSpec(lambda x, a: torch.sigmoid(x), 0.0, 1.0),
    "elu": _ActSpec(lambda x, a: F.elu(x), 0.0, 1.0),
    "selu": _ActSpec(lambda x, a: F.selu(x), 0.0, 1.0),
    "softplus": _ActSpec(lambda x, a: F.softplus(x), 0.0, 1.0),
    "swish": _ActSpec(lambda x, a: torch.sigmoid(x) * x, 0.0, math.sqrt(2)),
}
_ACT_INDEX = {name: i for i, name in enumerate(activation_funcs)}  # csrc/style_ops.cu


def _resolve(act: str, alpha, gain, clamp) -> Tuple[_ActSpec, float, float, float]:
    spec = activation_funcs[act]
    alpha = float(alpha if alpha is not None else spec.def_alpha)
    gain = float(gain if gain is not None else spec.def_gain)
    clamp = float(clamp if clamp is not None else -1.0)
    return spec, alpha, gain, clamp


def _gain_clamp(x: torch.Tensor, gain: float, clamp: float) -> torch.Tensor:
    if gain != 1.0:
        x = x * gain
    if clamp >= 0:
        x = x.clamp(-clamp, clamp)
    return x


def bias_act(x: torch.Tensor, b: Optional[torch.Tensor] = None, dim: int = -1,
             act: str = "linear", alpha: Optional[float] = None,
             gain: Optional[float] = None, clamp: Optional[float] = None,
             impl: str = "auto") -> torch.Tensor:
    """Fused bias + activation + gain + clamp (bias_act.py:89-117 semantics).

    dim: the axis the 1-D bias lives on (default -1, the channels in NHWC).
    impl: "ref", "cuda" (kernel #12) or "auto", as the module docstring says.
    """
    spec, alpha, gain, clamp = _resolve(act, alpha, gain, clamp)
    last = dim in (-1, x.ndim - 1)
    if impl == "auto":
        impl = "cuda" if (x.is_cuda and x.ndim >= 2 and x.shape[-1] % 128 == 0
                          and last) else "ref"
    if impl == "cuda":
        if not x.is_cuda:
            raise ValueError(f"bias_act(impl='cuda') needs a CUDA tensor, got {x.device}")
        if not last:
            raise ValueError(f"the bias_act kernel takes the bias on the last dim, got dim {dim}")
        return bias_act_fused(x, b, act, alpha, gain, clamp)
    if impl != "ref":
        raise ValueError(f"impl must be 'ref', 'cuda' or 'auto', got {impl!r}")
    if b is not None:
        shape = [1] * x.ndim
        shape[dim] = -1
        x = x + b.reshape(shape)  # promotes as jnp does: bf16 + f32 is f32
    return _gain_clamp(spec.fn(x, alpha), gain, clamp)


def bias_act_fused_reference(x, b, act: str, alpha: float, gain: float,
                             clamp: float) -> torch.Tensor:
    """Plain kernel #12: the bias in x's dtype (as JAX casts it), then
    everything in f32, rounded once to x's dtype; the bias on the last dim."""
    v = x.float()
    if b is not None:
        v = v + b.to(x.dtype).float()
    return _gain_clamp(activation_funcs[act].fn(v, alpha), gain, clamp).to(x.dtype)


def _library() -> ctypes.CDLL:
    lib = _build.load("style_ops")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ccdm_bias_act.argtypes = [p, p, p, ctypes.c_longlong, i, i, ctypes.c_float,
                                  ctypes.c_float, ctypes.c_float, i, i, p]
    lib.ccdm_bias_act.restype = ctypes.c_int
    return lib


def bias_act_fused(x, b, act: str, alpha: float, gain: float, clamp: float) -> torch.Tensor:
    """Kernel #12 over x [..., C] (f32 or bf16), b [C] or None; alpha, gain
    and clamp resolved (clamp < 0: none). Output in x's dtype."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the bias_act kernel runs on cuda or cpu, not {x.device}")
    if x.device.type == "cpu":
        return bias_act_fused_reference(x, b, act, alpha, gain, clamp)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the bias_act kernel takes f32 or bf16, got {x.dtype}")
    c = x.shape[-1]
    if b is not None and (tuple(b.shape) != (c,) or b.device != x.device):
        raise ValueError(f"b must be ({c},) on {x.device}, got {tuple(b.shape)} on {b.device}")
    x = x.detach().contiguous()
    b = None if b is None else b.detach().to(x.dtype).contiguous()
    y = torch.empty_like(x)
    width = 16 // x.element_size()  # values in one 16-byte vector
    vec = int(c % width != 0 or x.data_ptr() % 16 != 0)  # 1: one value a thread
    _build.run(_library(), "ccdm_bias_act", "bias_act kernel launch", x.device, x, b, y,
               x.numel(), c, _ACT_INDEX[act], alpha, gain, clamp, vec,
               int(x.dtype == torch.bfloat16))
    bias_act_fused.launches += 1
    return y


bias_act_fused.launches = 0  # kernel #12 launches since the last reset


# ---------------------------------------------------- upfirdn2d (plain)


def _parse_scaling(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _parse_padding(p):
    if isinstance(p, int):
        return p, p, p, p
    if len(p) == 2:
        return p[0], p[0], p[1], p[1]
    return tuple(p)  # (x0, x1, y0, y1)


def upfirdn2d(x: torch.Tensor, f: Optional[torch.Tensor], up=1, down=1, padding=0,
              flip_filter: bool = False, gain: float = 1.0) -> torch.Tensor:
    """Upsample (zero-insert), FIR filter, downsample (upfirdn2d.py:166-207,
    ref impl). x [B, H, W, C]; f [kh, kw] or [k] (separable) taps; returns
    [B, H', W', C]."""
    if f is None:
        f = torch.ones(1, 1)
    f = torch.as_tensor(f, dtype=torch.float32, device=x.device)
    upx, upy = _parse_scaling(up)
    downx, downy = _parse_scaling(down)
    padx0, padx1, pady0, pady1 = _parse_padding(padding)
    b, h, w, c = x.shape

    f = f * (gain ** (f.ndim / 2))
    if not flip_filter:
        f = f.flip(list(range(f.ndim)))  # conv2d correlates: flip for a convolution
    y = x.permute(0, 3, 1, 2)
    if upx > 1 or upy > 1:  # each sample followed by up - 1 zeros (upfirdn2d.py:186-188)
        z = y.new_zeros(b, c, h * upy, w * upx)
        z[:, :, ::upy, ::upx] = y
        y = z
    y = F.pad(y, (padx0, padx1, pady0, pady1))
    taps = lambda kern: kern.to(x.dtype).expand(c, 1, *kern.shape[2:]).contiguous()
    if f.ndim == 2:
        y = F.conv2d(y, taps(f[None, None]), stride=(downy, downx), groups=c)
    else:  # separable: vertical then horizontal thin convs (ref :204-206)
        y = F.conv2d(y, taps(f.view(1, 1, -1, 1)), stride=(downy, 1), groups=c)
        y = F.conv2d(y, taps(f.view(1, 1, 1, -1)), stride=(1, downx), groups=c)
    return y.permute(0, 2, 3, 1)


def filtered_lrelu(x: torch.Tensor, fu: Optional[torch.Tensor] = None,
                   fd: Optional[torch.Tensor] = None, b: Optional[torch.Tensor] = None,
                   up: int = 1, down: int = 1, padding=0, gain: float = math.sqrt(2),
                   slope: float = 0.2, clamp: Optional[float] = None) -> torch.Tensor:
    """StyleGAN3 fused filter + leaky ReLU: upfirdn(up) -> bias + lrelu
    (+ clamp) -> upfirdn(down), NHWC (filtered_lrelu.py, ref impl)."""
    px0, px1, py0, py1 = _parse_padding(padding)
    x = upfirdn2d(x, fu, up=up, padding=(px0, px1, py0, py1), gain=up ** 2)
    x = bias_act(x, b, act="lrelu", alpha=slope, gain=gain, clamp=clamp, impl="ref")
    return upfirdn2d(x, fd, down=down)
