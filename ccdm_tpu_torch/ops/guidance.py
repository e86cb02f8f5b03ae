"""Classifier-free guidance on the (cond, null) model outputs.

Counterpart of ccdm_tpu/ops/guidance.py:22-72; f32 throughout.
"""

from __future__ import annotations

import torch


def project_parallel(x: torch.Tensor, y: torch.Tensor):
    """Split x into its components parallel and orthogonal to y, per batch
    row (all non-batch dims flattened). Returns (parallel, orthogonal)."""
    b = x.shape[0]
    xf = x.reshape(b, -1).float()
    yf = y.reshape(b, -1).float()
    unit = yf * torch.rsqrt((yf * yf).sum(-1, keepdim=True) + 1e-12)
    parallel = (xf * unit).sum(-1, keepdim=True) * unit
    orthogonal = xf - parallel
    return (parallel.reshape(x.shape).to(x.dtype),
            orthogonal.reshape(x.shape).to(x.dtype))


def apply_cfg(logits: torch.Tensor, null_logits: torch.Tensor, cond_scale: float,
              rescaled_phi: float = 0.0, remove_parallel_component: bool = True,
              keep_parallel_frac: float = 0.0):
    """Guided output from cond/null outputs; returns (guided, null_logits).

    update = logits - null_logits, less its component parallel to logits;
    guided = logits + (cond_scale - 1) * update; then the rescaled-phi blend
    of std-matched and plain guidance (population std)."""
    if float(cond_scale) == 1.0:
        return logits, null_logits
    update = logits - null_logits
    if remove_parallel_component:
        parallel, orthog = project_parallel(update, logits)
        update = orthog + parallel * keep_parallel_frac
    scaled = logits + update * (cond_scale - 1.0)
    if rescaled_phi == 0.0:
        return scaled, null_logits
    dims = tuple(range(1, scaled.ndim))
    std_cond = logits.std(dim=dims, keepdim=True, unbiased=False)
    std_scaled = scaled.std(dim=dims, keepdim=True, unbiased=False)
    rescaled = scaled * (std_cond / (std_scaled + 1e-12))
    return rescaled * rescaled_phi + scaled * (1.0 - rescaled_phi), null_logits
