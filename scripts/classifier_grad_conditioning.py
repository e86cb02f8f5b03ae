#!/usr/bin/env python3
"""How the guided sampler's classifier gradient reacts to the timestep
embedding's last bits, on the CPU.

    python3 scripts/classifier_grad_conditioning.py

Trains the NoisyClassifier as chip_smoke.py's phase 23 does (classgan_main
--method admg --classifier_epochs 1: the synthetic 64x64 set, 10 classes)
and computes diffusion/guided.classifier_grad_fn's gradient in f64 on
q_sample'd training images at t < 250, twice: with the sinusoidal timestep
embedding as the port computes it (t * freq, sin, cos in f32) and with that
embedding computed in f64. The two embeddings differ by f32 rounding alone,
yet the gradients differ well beyond 1e-4 of the largest |g|: a ReLU net's
input gradient is piecewise constant in which units are on, and an input
that moves a unit across 0 changes the gradient at every pixel behind it.
The card's and the CPU's f32 sin, cos and exp differ in their last bits in
the same way, which is why phase 23 holds the gradient, card against CPU,
with one embedding (the CPU's) handed to both. About a minute on 8 threads.
"""

from __future__ import annotations

import copy
import math
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from ccdm_tpu_torch.data.datasets import make_synthetic  # noqa: E402
from ccdm_tpu_torch.diffusion.guided import classifier_grad_fn  # noqa: E402
from ccdm_tpu_torch.eval import backbones  # noqa: E402
from ccdm_tpu_torch.eval.train_backbones import (  # noqa: E402
    bin_labels_to_classes,
    train_noisy_classifier,
)
from ccdm_tpu_torch.ops.image import normalize_images  # noqa: E402
from ccdm_tpu_torch.ops.schedule import make_schedule, q_sample  # noqa: E402


def embedding_f64(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float64) * (-math.log(10000.0) / (half - 1)))
    args = t.reshape(-1).double()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def main() -> None:
    torch.set_num_threads(8)
    bundle = make_synthetic(n=512, image_size=64, channels=3)
    classes = bin_labels_to_classes(bundle.labels_raw, 10)
    net = train_noisy_classifier(bundle.images, classes, 10, timesteps=1000, epochs=1,
                                 seed=0).requires_grad_(False)
    f64 = copy.deepcopy(net).double()
    g = torch.Generator().manual_seed(8)
    x0 = normalize_images(torch.from_numpy(make_synthetic(n=8, seed=8).images),
                          to_neg_one_to_one=True)
    t = torch.randint(0, 250, (8,), generator=g)
    y = torch.randint(0, 10, (8,), generator=g)
    x = q_sample(make_schedule(1000, "cosine", "pred_noise"), x0, t,
                 torch.randn(x0.shape, generator=g)).double()
    port = backbones.sinusoidal_pos_emb
    grads = {}
    for name, embed in (("f32", lambda tt, d: port(tt, d).double()), ("f64", embedding_f64)):
        backbones.sinusoidal_pos_emb = embed
        grads[name] = classifier_grad_fn(f64, takes_t=True)(x, t, y)
    backbones.sinusoidal_pos_emb = port
    emb_err = float((port(t, 128).double() - embedding_f64(t, 128)).abs().max())
    ref, got = grads["f64"], grads["f32"]
    diff = got - ref
    largest = float(ref.abs().max())
    print(f"timestep embedding, f32 against f64: max abs err {emb_err:.3e}", flush=True)
    print(f"the f64 gradient with each: largest |g| {largest:.4e}; max abs diff "
          f"{float(diff.abs().max()) / largest:.3e} of it, L2 {float(diff.norm() / ref.norm()):.3e} "
          f"relative, {float((diff.abs() > 1e-4 * largest).float().mean()):.3e} of the elements "
          f"beyond 1e-4 of it", flush=True)


if __name__ == "__main__":
    main()
