"""Training of the auxiliary label regressor of the elastic aux loss.

Counterpart of ccdm_tpu/training/train_aux.py: `train_aux_net` trains a
models/aux_net.py regressor x -> y on clean images normalised to [0, 1]
with MSE, SGD with momentum 0.9 and weight decay 1e-4 added to the gradient
(optax's add_decayed_weights before sgd, which is torch.optim.SGD's
weight_decay), lr 0.01 divided by 10 at epochs 50 and 120. Step s draws its
batch indices from a torch.Generator seeded from (seed, s), or takes them
from `draws[s]["idx"]` (the tests hand in JAX's). The trained net is then
applied, frozen, to the noisy x_t_hat of the elastic loss: that gap between
the training and the applied distribution is the JAX package's (and its
reference's) own.

`get_aux_net` trains or loads the net under
<setting folder>/aux_models/model-aux_<name>_e<epochs>_seed<seed>/state.pt
(utils/ckpt.py; the JAX package keeps an orbax entry of the same name,
which scripts/jax_milestone_to_torch.py carries across) and returns it
frozen in eval mode as apply(x_t_hat, t) -> [B, 1].
"""

from __future__ import annotations

import os
import time
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ccdm_tpu_torch.models.aux_net import make_aux_net
from ccdm_tpu_torch.ops.image import normalize_images
from ccdm_tpu_torch.training.optim import lr_schedule, set_lr, step_generator, sync
from ccdm_tpu_torch.utils.ckpt import checkpoint_exists, load_checkpoint, save_checkpoint


def aux_step(net: nn.Module, opt: torch.optim.Optimizer, images: torch.Tensor,
             labels: torch.Tensor, batch_size: int, lr: float,
             gen: Optional[torch.Generator] = None,
             idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One SGD step on images[idx] (uint8 NHWC on the device, idx drawn
    from `gen` unless given); returns the loss."""
    if idx is None:
        idx = torch.randint(0, images.shape[0], (batch_size,), generator=gen,
                            device=images.device)
    idx = idx.to(images.device)
    x = normalize_images(images[idx], to_neg_one_to_one=False)
    set_lr(opt, lr)
    opt.zero_grad(set_to_none=True)
    loss = ((net(x, None, train=True).reshape(-1) - labels[idx]) ** 2).mean()
    loss.backward()
    opt.step()
    return loss.detach()


def train_aux_net(
    images_u8: np.ndarray,
    labels_norm: np.ndarray,
    name: str = "ResNet34",
    epochs: int = 200,
    batch_size: int = 256,
    lr_base: float = 0.01,
    lr_decay_epochs=(50, 120),
    weight_decay: float = 1e-4,
    seed: int = 0,
    use_t_emb: bool = False,
    log_every: int = 20,
    device="cpu",
    net: Optional[nn.Module] = None,
    draws: Optional[Sequence[dict]] = None,
) -> nn.Module:
    """The trained regressor (weights from `seed`, or `net`). Sets
    `net.seconds_per_epoch`."""
    if images_u8.dtype != np.uint8 or images_u8.max() <= 1:
        raise ValueError("images must be raw uint8")
    labels = np.asarray(labels_norm, np.float32)
    if labels.ndim > 1 and labels.shape[1] > 1:
        raise ValueError("the aux regressor takes scalar labels: ccdm_tpu flattens [N, D] "
                         "labels against N images (ccdm_tpu/training/train_aux.py:46)")
    labels = labels.reshape(-1)
    if labels.min() < 0 or labels.max() > 1.0:
        raise ValueError("labels must be normalized to [0, 1]")
    n = len(images_u8)
    batch_size = min(batch_size, n)
    steps_per_epoch = max(n // batch_size, 1)
    if net is None:
        net = make_aux_net(name, use_t_emb, in_channels=images_u8.shape[-1],
                           image_size=images_u8.shape[1], seed=seed)
    net = net.to(device).train()
    sched = lr_schedule(lr_base, lr_decay_epochs, steps_per_epoch)
    opt = torch.optim.SGD(net.parameters(), lr=sched(0), momentum=0.9,
                          weight_decay=weight_decay)
    images_dev = torch.from_numpy(np.ascontiguousarray(images_u8)).to(device)
    labels_dev = torch.from_numpy(labels).to(device)
    t0 = time.perf_counter()
    for epoch in range(epochs):
        for s in range(steps_per_epoch):
            step = epoch * steps_per_epoch + s
            given = draws[step] if draws else {}
            gen = None if "idx" in given else step_generator(seed, step, device)
            loss = aux_step(net, opt, images_dev, labels_dev, batch_size, sched(step), gen,
                            given.get("idx"))
        if log_every and (epoch + 1) % log_every == 0:
            print(f"\r [aux {name}] epoch {epoch + 1}/{epochs} loss {float(loss):.5f}")
    sync(device)
    net.seconds_per_epoch = (time.perf_counter() - t0) / max(epochs, 1)
    return net


class FrozenAux:
    """apply(x_t_hat [B, H, W, C], t [B]) -> [B, 1]: the net in eval mode,
    its weights frozen (the gradient reaches x_t_hat), in f32."""

    def __init__(self, net: nn.Module, seconds_per_epoch: Optional[float] = None):
        self.net = net.float().eval().requires_grad_(False)
        self.seconds_per_epoch = seconds_per_epoch  # None when loaded from the cache

    def __call__(self, x_t_hat: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return self.net(x_t_hat.float(), t, train=False)


def get_aux_net(bundle, setting_folder: str, name: str = "ResNet34", epochs: int = 200,
                batch_size: int = 256, seed: int = 0, device="cpu") -> FrozenAux:
    """Train or load the aux net of `bundle` under <setting_folder>/aux_models."""
    aux_dir = os.path.join(setting_folder, "aux_models")
    tag = f"aux_{name}_e{epochs}_seed{seed}"
    net = make_aux_net(name, in_channels=bundle.channels, image_size=bundle.image_size,
                       seed=seed)
    seconds = None
    if checkpoint_exists(aux_dir, tag):
        net.load_state_dict(load_checkpoint(aux_dir, tag)["net"])
        print(f" aux net: loaded cached '{tag}'")
    else:
        net = train_aux_net(bundle.images, bundle.labels_norm, name=name, epochs=epochs,
                            batch_size=batch_size, seed=seed, device=device, net=net)
        seconds = net.seconds_per_epoch
        save_checkpoint(aux_dir, tag, {"net": {k: v.detach().cpu()
                                               for k, v in net.state_dict().items()}})
    return FrozenAux(net.to(device), seconds)
