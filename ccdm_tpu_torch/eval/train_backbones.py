"""Training of the eval backbones, train-or-load (counterpart of
ccdm_tpu/eval/train_backbones.py). The reference ships its eval nets as
downloads only; here they are retrained from their specs: an autoencoder
whose encoder is the SFID feature extractor (pixel MSE, Adam 1e-4), a
ResNet34 classifier over binned labels (Diversity entropy) and a ResNet34
regressor (Label Score), both with SGD: momentum 0.9, weight decay 1e-4
added to the gradient (optax's add_decayed_weights before sgd, which is
torch.optim.SGD's weight_decay), lr 0.01 times 0.1 from half of the
steps and again from three quarters (optax's piecewise-constant schedule:
at one or two steps the two boundaries meet and only one factor applies).
`train_noisy_classifier` trains the timestep-aware classifier of guided
sampling with AdamW (3e-4, weight decay 0.05) on q_sample'd images.

Step s draws its batch indices (and, for the noisy classifier, t and the
noise) from a torch.Generator seeded from (seed, s), or takes them from
`draws[s]` (the tests hand in JAX's). Images are normalised to [-1, 1].
The steps run in full f32 (utils/device.full_f32: no TF32), whatever the
caller's setting.

`get_eval_models` keeps the three nets under
<eval_ckpt_path>/model-evalnets_<name>_<size>_seed<seed>/state.pt
(utils/ckpt.py; {"ae": encoder, "cls": classifier, "reg": regressor}
state_dicts), the tag of JAX's orbax entry, which
scripts/jax_milestone_to_torch.py carries across. Its fingerprint hashes
the nets' weights mapped back to flax layout (utils/convert
.jax_variables_from_state_dict), leaf by leaf in the order of
jax.tree_util.tree_leaves, so one checkpoint reads the same
evalnets_...:<hash> in both packages.
"""

from __future__ import annotations

import hashlib
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ccdm_tpu_torch.eval.backbones import AEDecoder, AEEncoder, NoisyClassifier, ResNetEval
from ccdm_tpu_torch.ops.image import normalize_images
from ccdm_tpu_torch.ops.schedule import make_schedule, q_sample
from ccdm_tpu_torch.training.optim import lr_schedule, set_lr, step_generator, sync
from ccdm_tpu_torch.utils.ckpt import checkpoint_exists, load_checkpoint, save_checkpoint
from ccdm_tpu_torch.utils.convert import jax_variables_from_state_dict
from ccdm_tpu_torch.utils.device import full_f32

# the depth of ResNetEval in get_eval_models (ResNet34)
EVAL_RESNET_BLOCKS = (3, 4, 6, 3)
# seconds per epoch of each net of the last get_eval_models that trained
# ("ae", "cls", "reg")
STAGE_SECONDS: dict = {}


def _draw_idx(n: int, batch_size: int, gen, idx, device) -> torch.Tensor:
    if idx is None:
        idx = torch.randint(0, n, (batch_size,), generator=gen, device=device)
    return idx.to(device)


def _loop(step_fn, steps_per_epoch: int, epochs: int, seed: int, device, draws, tag: str,
          log_every: int = 200) -> float:
    """step_fn(given, gen) for every step, in full f32 (no TF32); returns
    seconds per epoch."""
    t0 = time.perf_counter()
    with full_f32():
        for step in range(steps_per_epoch * epochs):
            given = draws[step] if draws else {}
            gen = None if "idx" in given else step_generator(seed, step, device)
            loss = step_fn(step, given, gen)
            if log_every and (step + 1) % log_every == 0:
                print(f"\r [{tag}] step {step + 1}/{steps_per_epoch * epochs} "
                      f"loss {float(loss):.5f}")
        sync(device)
    return (time.perf_counter() - t0) / max(epochs, 1)


def ae_step(enc: AEEncoder, dec: AEDecoder, opt: torch.optim.Optimizer, images: torch.Tensor,
            batch_size: int, gen: Optional[torch.Generator] = None,
            idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One Adam step of the autoencoder on images[idx] (uint8 NHWC on the
    device); returns the pixel MSE."""
    idx = _draw_idx(images.shape[0], batch_size, gen, idx, images.device)
    x = normalize_images(images[idx], to_neg_one_to_one=True)
    opt.zero_grad(set_to_none=True)
    loss = ((dec(enc(x, train=True), train=True) - x) ** 2).mean()
    loss.backward()
    opt.step()
    return loss.detach()


def train_autoencoder(images_u8: np.ndarray, dim_bottleneck: int = 512, ch: int = 64,
                      epochs: int = 10, batch_size: int = 128, lr: float = 1e-4,
                      seed: int = 0, device="cpu", nets=None,
                      draws: Optional[Sequence[dict]] = None) -> AEEncoder:
    """The trained encoder (weights from `seed`, or `nets` = (encoder,
    decoder)). Sets `enc.seconds_per_epoch`."""
    n, size, _, channels = images_u8.shape
    batch_size = min(batch_size, n)
    if nets is None:
        nets = (AEEncoder(dim_bottleneck, ch, channels, size, seed=seed),
                AEDecoder(ch, nc=channels, init_size=size // 16, dim_bottleneck=dim_bottleneck,
                          seed=seed))
    enc, dec = (m.to(device).train() for m in nets)
    opt = torch.optim.Adam([*enc.parameters(), *dec.parameters()], lr=lr)
    imgs = torch.from_numpy(np.ascontiguousarray(images_u8)).to(device)
    enc.seconds_per_epoch = _loop(
        lambda step, given, gen: ae_step(enc, dec, opt, imgs, batch_size, gen, given.get("idx")),
        max(n // batch_size, 1), epochs, seed, device, draws, "ae")
    return enc.eval()


def eval_resnet_step(net: ResNetEval, opt: torch.optim.Optimizer, images: torch.Tensor,
                     targets: torch.Tensor, batch_size: int, lr: float,
                     gen: Optional[torch.Generator] = None,
                     idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One SGD step: cross-entropy on class targets, or MSE through the
    leaky head on [0, 1] targets; returns the loss."""
    idx = _draw_idx(images.shape[0], batch_size, gen, idx, images.device)
    x = normalize_images(images[idx], to_neg_one_to_one=True)
    y = targets[idx]
    set_lr(opt, lr)
    opt.zero_grad(set_to_none=True)
    out, _ = net(x, train=True, leaky_head=net.mode == "regre")
    loss = (F.cross_entropy(out, y) if net.mode == "class"
            else ((out.reshape(-1) - y.reshape(-1)) ** 2).mean())
    loss.backward()
    opt.step()
    return loss.detach()


def train_eval_resnet(images_u8: np.ndarray, targets: np.ndarray, mode: str,
                      num_outputs: int, epochs: int = 20, batch_size: int = 128,
                      lr: float = 0.01, seed: int = 0, device="cpu",
                      net: Optional[ResNetEval] = None,
                      draws: Optional[Sequence[dict]] = None) -> ResNetEval:
    """The trained ResNet eval net: mode "class" (int targets) or "regre"
    ([0, 1] targets). Built from `seed` (a regressor's head bias starts at
    the target mean, so its relu starts live), or `net` as given. Sets
    `net.seconds_per_epoch`."""
    n, _, _, channels = images_u8.shape
    batch_size = min(batch_size, n)
    steps = max(n // batch_size, 1) * epochs
    if net is None:
        net = ResNetEval(num_outputs, mode, EVAL_RESNET_BLOCKS, channels, seed)
        if mode == "regre":
            with torch.no_grad():
                net.head.bias += torch.tensor(np.mean(np.asarray(targets, np.float32)))
    net = net.to(device).train()
    sched = lr_schedule(lr, (0.5, 0.75), steps)  # boundaries int(0.5 steps), int(0.75 steps)
    opt = torch.optim.SGD(net.parameters(), lr=sched(0), momentum=0.9, weight_decay=1e-4)
    imgs = torch.from_numpy(np.ascontiguousarray(images_u8)).to(device)
    tgt = torch.from_numpy(np.asarray(targets, np.int64 if mode == "class" else np.float32)
                           ).to(device)
    net.seconds_per_epoch = _loop(
        lambda step, given, gen: eval_resnet_step(net, opt, imgs, tgt, batch_size, sched(step),
                                                  gen, given.get("idx")),
        max(n // batch_size, 1), epochs, seed, device, draws, f"eval_{mode}")
    return net.eval()


def noisy_classifier_step(net: NoisyClassifier, opt: torch.optim.Optimizer, sched,
                          images: torch.Tensor, targets: torch.Tensor, batch_size: int,
                          gen: Optional[torch.Generator] = None,
                          idx: Optional[torch.Tensor] = None, t: Optional[torch.Tensor] = None,
                          noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One AdamW step of cross-entropy on x_t = q_sample(x, t, noise)."""
    device = images.device
    idx = _draw_idx(images.shape[0], batch_size, gen, idx, device)
    x = normalize_images(images[idx], to_neg_one_to_one=True)
    if t is None:
        t = torch.randint(0, sched.num_timesteps, (batch_size,), generator=gen, device=device)
    if noise is None:
        noise = torch.randn(x.shape, generator=gen, device=device)
    t, noise = t.to(device), noise.to(device)
    opt.zero_grad(set_to_none=True)
    loss = F.cross_entropy(net(q_sample(sched, x, t, noise), t, train=True), targets[idx])
    loss.backward()
    opt.step()
    return loss.detach()


def train_noisy_classifier(images_u8: np.ndarray, class_targets: np.ndarray, num_classes: int,
                           timesteps: int = 1000, beta_schedule: str = "cosine",
                           epochs: int = 20, batch_size: int = 128, lr: float = 3e-4,
                           seed: int = 0, device="cpu", net: Optional[NoisyClassifier] = None,
                           draws: Optional[Sequence[dict]] = None) -> NoisyClassifier:
    """The timestep-aware classifier (ADM-G classifier_train.py): x_t at
    t ~ U[0, T), cross-entropy on the class label. Sets
    `net.seconds_per_epoch`."""
    n, _, _, channels = images_u8.shape
    batch_size = min(batch_size, n)
    sched = make_schedule(timesteps, beta_schedule, "pred_noise", device=device)
    if net is None:
        net = NoisyClassifier(num_classes, in_channels=channels, seed=seed)
    net = net.to(device).train()
    opt = torch.optim.AdamW(net.parameters(), lr=lr, weight_decay=0.05)
    imgs = torch.from_numpy(np.ascontiguousarray(images_u8)).to(device)
    tgt = torch.from_numpy(np.asarray(class_targets, np.int64)).to(device)
    net.seconds_per_epoch = _loop(
        lambda step, given, gen: noisy_classifier_step(
            net, opt, sched, imgs, tgt, batch_size, gen, given.get("idx"), given.get("t"),
            given.get("noise")),
        max(n // batch_size, 1), epochs, seed, device, draws, "noisy_cls")
    return net.eval()


def bin_labels_to_classes(raw: np.ndarray, num_classes: int,
                          ref: np.ndarray = None) -> np.ndarray:
    """Raw continuous labels binned into num_classes equal-frequency classes
    (the CCGM analog of StudioGAN's class ids). The boundaries come from
    `ref` (default: raw itself), so real and fake labels share one binning
    when the real labels are the ref."""
    uniq = np.sort(np.unique(raw if ref is None else ref))
    chunks = np.array_split(uniq, num_classes)
    uppers = np.array([c[-1] for c in chunks[:-1] if len(c)])  # upper edges included
    return np.searchsorted(uppers, np.asarray(raw), side="left").astype(np.int64)


def _cpu_state(net: nn.Module) -> dict:
    return {k: v.detach().cpu() for k, v in net.state_dict().items()}


def get_eval_models(bundle, eval_ckpt_path: str, num_classes: int, epochs_ae: int = 10,
                    epochs_cnn: int = 20, seed: int = 0, device="cpu") -> dict:
    """Train or load the three eval backbones of a dataset bundle: a dict of
    "fid" (the AE encoder), "ls" (the regressor), "div" (the classifier),
    each in eval mode on `device`, and "fingerprint"."""
    os.makedirs(eval_ckpt_path, exist_ok=True)
    img = bundle.eval_images if bundle.eval_images is not None else bundle.images
    raw = bundle.eval_labels_raw if bundle.eval_labels_raw is not None else bundle.labels_raw
    norm = bundle.fn_normalize(raw)
    size, channels = bundle.image_size, bundle.channels

    tag = f"evalnets_{bundle.name}_{size}_seed{seed}"
    entry = os.path.join(eval_ckpt_path, f"model-{tag}")
    if os.path.isdir(entry) and not checkpoint_exists(eval_ckpt_path, tag):
        raise FileExistsError(
            f"{entry} holds no state.pt (a JAX orbax entry?): carry it across with "
            "scripts/jax_milestone_to_torch.py --jax_eval_ckpt_path, or use another "
            "--eval_ckpt_path; training new nets there would break the pinned fingerprint")
    if checkpoint_exists(eval_ckpt_path, tag):
        stored = load_checkpoint(eval_ckpt_path, tag)
        nets = {"ae": AEEncoder(in_channels=channels, image_size=size),
                "cls": ResNetEval(num_classes, "class", EVAL_RESNET_BLOCKS, channels),
                "reg": ResNetEval(1, "regre", EVAL_RESNET_BLOCKS, channels)}
        for name, net in nets.items():
            net.load_state_dict(stored[name])
        nets = {name: net.to(device).eval() for name, net in nets.items()}
        print(f" eval backbones: LOADED pinned checkpoint '{tag}' from {eval_ckpt_path}")
    else:
        print(f" eval backbones: no pinned checkpoint '{tag}' in {eval_ckpt_path} — "
              "training now. SFID/LS/Diversity are only comparable across runs "
              "that share this checkpoint (it is persisted after training).")
        nets = {
            "ae": train_autoencoder(img, epochs=epochs_ae, seed=seed, device=device),
            "cls": train_eval_resnet(img, bin_labels_to_classes(raw, num_classes), "class",
                                     num_classes, epochs=epochs_cnn, seed=seed + 1,
                                     device=device),
            "reg": train_eval_resnet(img, norm, "regre", 1, epochs=epochs_cnn, seed=seed + 2,
                                     device=device),
        }
        STAGE_SECONDS.clear()
        STAGE_SECONDS.update({name: net.seconds_per_epoch for name, net in nets.items()})
        save_checkpoint(eval_ckpt_path, tag, {name: _cpu_state(net) for name, net in nets.items()})
    return {
        "fid": nets["ae"], "div": nets["cls"], "ls": nets["reg"],
        # any metric is comparable only to numbers of the same fingerprint
        "fingerprint": f"{tag}:{backbone_fingerprint(nets)}",
    }


def _tree_leaves(tree) -> list:
    """The leaves of a nested dict in jax.tree_util.tree_leaves' order
    (keys sorted at every level)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _tree_leaves(tree[k])]
    return [tree]


def backbone_fingerprint(nets: dict) -> str:
    """Short content hash of {"ae": ..., "cls": ..., "reg": ...}: every
    f32 leaf in flax layout, in tree_leaves order, as JAX hashes its
    stored tree."""
    h = hashlib.sha256()
    tree = {name: jax_variables_from_state_dict(net.state_dict(), net)
            for name, net in nets.items()}
    for leaf in _tree_leaves(tree):
        h.update(np.ascontiguousarray(leaf).tobytes())
    return h.hexdigest()[:12]
