"""Sampling-side parameter handling (ccdm_tpu/training/state.py:102-123)."""

from __future__ import annotations

import torch
from torch import nn


@torch.no_grad()
def precast_sampling_params(model: nn.Module) -> nn.Module:
    """`--samp_precast_bf16`: cast the f32 weight tensors (ndim >= 2) of
    `model` to bf16 once, in place, so that each sampling step reads 2-byte
    weights; 1-D parameters (biases, norm gains) stay f32. Returns `model`."""
    for p in model.parameters():
        if p.dtype == torch.float32 and p.ndim >= 2:
            p.data = p.data.to(torch.bfloat16)
    return model
