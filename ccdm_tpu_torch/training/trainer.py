"""Batched sampling for a list of labels (Trainer.sample_given_labels).

Counterpart of ccdm_tpu/training/trainer.py:444-514, as a function of the
model's diffusion rather than a method of the trainer (training comes in a
later slice). Each chunk of `batch_size` labels is sampled from its own
torch.Generator seeded from (key_base, done); the JAX version uses
fold_in(PRNGKey(key_base), done). The two streams differ: no torch
generator reproduces JAX's bits.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ccdm_tpu_torch.ops.image import to_uint8


def chunk_seed(key_base: int, done: int) -> int:
    """The seed of the chunk that starts at label `done`."""
    return (int(key_base) * 1_000_003 + int(done)) % (2 ** 63)


def sample_given_labels(diffusion, given_labels: np.ndarray, fn_y2h: Callable,
                        batch_size: int, denorm: bool = True, cond_scale: float = 6.0,
                        sample_timesteps: int = 1000, key_base: int = 1):
    """Labels in [0, 1] -> (images [n, H, W, C] numpy, given_labels).

    The last chunk is padded by repeating its last label. Images are uint8
    with `denorm`, else f32 in [0, 1]. Raises FloatingPointError if the
    sampler produced a non-finite value."""
    labels = np.asarray(given_labels, dtype=np.float32)
    labels2d = labels[:, None] if labels.ndim == 1 else labels
    if labels2d.min() < 0 or labels2d.max() > 1.0:
        raise ValueError("labels must be normalized to [0, 1]")
    nfake = len(labels2d)
    batch_size = min(batch_size, nfake)
    device = diffusion.device

    out = []
    done = 0
    while done < nfake:
        chunk = labels2d[done:done + batch_size]
        pad = batch_size - len(chunk)
        if pad:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, axis=0)])
        emb = fn_y2h(torch.from_numpy(chunk).to(device))
        gen = torch.Generator(device=device).manual_seed(chunk_seed(key_base, done))
        imgs = diffusion.ddim_sample(emb, cond_scale=cond_scale,
                                     sampling_timesteps=sample_timesteps, generator=gen)
        imgs = imgs[:len(chunk) - pad]
        if not bool(torch.isfinite(imgs).all()):
            raise FloatingPointError("the sampler produced non-finite values")
        if denorm:
            imgs = to_uint8(imgs)
        out.append(imgs.cpu().numpy())
        done += batch_size
    return np.concatenate(out, axis=0)[:nfake], given_labels
