"""Carry the JAX Unet's weights across to the port.

`unet_state_dict_from_jax` turns the flax variables of a ccdm_tpu Unet
({"params": ..., "batch_stats": ...}, nested dicts of numpy arrays) into a
state_dict of the port's Unet:
- conv kernels HWIO -> OIHW (init_conv, the down/up convs, final_conv, the
  resnet blocks' conv1_kernel/conv2_kernel -> conv1_weight/conv2_weight);
- dense kernels [in, out] -> Linear.weight [out, in];
- a resnet block's res_kernel [Cin, Cout] -> res_weight [Cout, Cin, 1, 1];
- the attention blocks' qkv_kernel [C, 3F] and out_kernel [F, C] keep
  their layout (the kernel's signature is JAX's);
- cond_bn_* scale/bias and batch_stats mean/var -> BatchNorm weight/bias
  and running statistics; null_cond_emb as it is.
It raises on a leaf it does not consume and on a tensor of the port it
leaves unset.
"""

from __future__ import annotations

from typing import Any, Iterator, Mapping

import numpy as np
import torch
from torch import nn

_RENAMES = {"kernel": "weight", "scale": "weight", "conv1_kernel": "conv1_weight",
            "conv2_kernel": "conv2_weight", "res_kernel": "res_weight",
            "mean": "running_mean", "var": "running_var"}


def _leaves(tree: Mapping[str, Any], prefix=()) -> Iterator[tuple[tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v, dtype=np.float32)


def _to_torch_layout(name: str, arr: np.ndarray) -> np.ndarray:
    if name == "res_weight":
        return arr.T[:, :, None, None]
    if name in ("weight", "conv1_weight", "conv2_weight") and arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    if name == "weight" and arr.ndim == 2:
        return arr.T  # Dense [in, out] -> Linear [out, in]
    return arr


def unet_state_dict_from_jax(variables: Mapping[str, Any], model: nn.Module) -> dict:
    """The state_dict for `model` (a port Unet of the same config) holding
    the JAX Unet's `variables`."""
    target = model.state_dict()
    out: dict[str, torch.Tensor] = {}
    trees = [variables["params"], variables.get("batch_stats", {})]
    for path, arr in (leaf for tree in trees for leaf in _leaves(tree)):
        names = list(path)
        if names[0] == "mid_attn_inner":  # flax registers it beside mid_attn
            names[:1] = ["mid_attn", "fn"]
        names[-1] = _RENAMES.get(names[-1], names[-1])
        key = ".".join(names)
        if key not in target or key in out:
            raise KeyError(f"JAX leaf {'/'.join(path)} has no place in the port "
                           f"(tried {key!r})")
        value = torch.from_numpy(np.ascontiguousarray(_to_torch_layout(names[-1], arr)))
        if value.shape != target[key].shape:
            raise ValueError(f"{'/'.join(path)}: shape {tuple(value.shape)} does not "
                             f"fit {key} {tuple(target[key].shape)}")
        out[key] = value
    for key, value in target.items():
        if key in out:
            continue
        if key.endswith("num_batches_tracked"):  # unused at inference
            out[key] = value
        else:
            raise KeyError(f"the JAX variables leave {key} unset")
    return out
