"""The ILI (inverse label inference) embedding pipeline.

Counterpart of ccdm_tpu/embedding/ili.py:
1. `train_resnet_embed`: a ResNet regressor x -> (y_hat, h), MSE, SGD with
   momentum 0.9 and weight decay 1e-4 added to the gradient (optax's
   add_decayed_weights before sgd, which is torch.optim.SGD's
   weight_decay), lr 0.01 decayed 10x at epochs [80, 140], on images
   normalised to [-1, 1]; an in-train checkpoint every 50 epochs and
   resume from one (--resumeepoch_cnn_embed).
2. `train_label_mlp`: an MLP y -> h. Its first half of epochs regresses
   mlp(y + noise) onto the piecewise-linear interpolation of the
   per-label mean features h̄(y) with Adam 1e-3; the second half inverts
   the frozen h2y head, through its leaky_relu(0.01) surrogate, with SGD
   as above (lr decayed at [150, 250, 350] epochs of that phase). The
   output bias starts at the mean feature; the labels get N(0, sigma)
   noise, clipped to [0, 1].
3. `LabelEmbed`: train-or-load of both stages for y2h and, with --use_Hy,
   y2cov, cached under <setting>/embed_models/model-<tag>/state.pt
   (utils/ckpt.py, the layout of JAX's orbax entries, so the tags and the
   discovery carry over) beside datafp-<tag>.txt, the fingerprint of the
   data they were fit on. fn_y2h and fn_y2cov are the frozen MLPs in f32
   on the run's device, under torch.no_grad().

Multi-dim labels [N, D] (ccdm_tpu/embedding/ili.py:487, 527-537,
547-566): the regressor's h2y head has D outputs; the label MLP trains on
the unique label rows flattened to [U * D] scalars, with label noise 0.05
(0.2 for scalar labels) and no feature phase; fn_y2h embeds each of the D
dims and combines them by --dim_combination (embedding/combine.py, its
weights drawn from seed + 7 or read from embed_models/), while labels [B]
or [B, 1] take the MLP directly. The resnet fn_y2cov takes scalar labels
only: JAX's flattens [B, D] labels to [B * D] (ili.py:635), and its H(y)
reshape then fails, so the port raises a ValueError there.

Random draws come from a torch.Generator seeded from (seed, step), so a
resumed run draws what the uninterrupted one would; every step function
also takes its batch indices and label noise as arguments (the tests hand
in JAX's draws). Unlike ccdm_tpu, `mean_feature` and
`per_label_mean_features` run the trained net itself, so they work at
--net_embed ResNet18_embed, where the JAX functions rebuild a ResNet34 and
raise (ROADMAP.md, port choices).
"""

from __future__ import annotations

import glob
import hashlib
import os
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ccdm_tpu_torch.embedding.analytic import COMBINER_SEED_OFFSET
from ccdm_tpu_torch.embedding.combine import combine, combiner_weights
from ccdm_tpu_torch.models.resnet_embed import ModelY2Cov, ModelY2H, ResNetEmbed
from ccdm_tpu_torch.ops.image import normalize_images
from ccdm_tpu_torch.training.optim import lr_schedule, set_lr, step_generator, sync
from ccdm_tpu_torch.utils.ckpt import checkpoint_exists, load_checkpoint, save_checkpoint

# seconds per epoch of each stage of the last LabelEmbed that trained
# ("y2h_cnn", "y2h_mlp", "y2cov_cnn", "y2cov_mlp")
STAGE_SECONDS: dict = {}


# stage-1 CNN depths selectable with --net_embed
NET_EMBED_BLOCKS = {
    "ResNet18_embed": (2, 2, 2, 2),
    "ResNet34_embed": (3, 4, 6, 3),
}


def _embed_blocks(net_embed: str):
    base = net_embed.replace("_y2cov", "")
    if base not in NET_EMBED_BLOCKS:
        raise SystemExit(
            f"unknown --net_embed '{net_embed}'; choose from "
            f"{sorted(NET_EMBED_BLOCKS)} (optionally with an _y2cov suffix)")
    return NET_EMBED_BLOCKS[base]


def resnet_embed_step(net: ResNetEmbed, opt: torch.optim.Optimizer, images: torch.Tensor,
                      labels: torch.Tensor, batch_size: int, lr: float,
                      gen: Optional[torch.Generator] = None,
                      idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One SGD step of the regressor on images[idx] (uint8 NHWC on the
    device, idx drawn from `gen` unless given); returns the loss."""
    if idx is None:
        idx = torch.randint(0, images.shape[0], (batch_size,), generator=gen,
                            device=images.device)
    idx = idx.to(images.device)
    x = normalize_images(images[idx], to_neg_one_to_one=True)
    set_lr(opt, lr)
    opt.zero_grad(set_to_none=True)
    y_hat, _ = net(x, train=True)
    loss = ((y_hat - labels[idx]) ** 2).mean()
    loss.backward()
    opt.step()
    return loss.detach()


def train_resnet_embed(
    images_u8: np.ndarray,
    labels_norm: np.ndarray,
    dim_embed: int,
    epochs: int = 200,
    batch_size: int = 256,
    lr_base: float = 0.01,
    lr_decay_epochs=(80, 140),
    weight_decay: float = 1e-4,
    seed: int = 0,
    log_every: int = 20,
    num_blocks=(3, 4, 6, 3),
    ckpt_dir: Optional[str] = None,
    ckpt_tag: str = "cnn",
    resume_epoch: int = 0,
    ckpt_every: int = 50,
    device="cpu",
    net: Optional[ResNetEmbed] = None,
    draws: Optional[Sequence[dict]] = None,
) -> ResNetEmbed:
    """Stage 1: the trained regressor (weights from `seed`, or `net`).

    With `ckpt_dir`, saves {epoch, net, opt} as <ckpt_tag>_epoch<E> every
    `ckpt_every` epochs (before the last), and `resume_epoch` > 0 restores
    that checkpoint and continues. `draws[step]` may hold that step's
    batch indices ("idx"). Sets `net.seconds_per_epoch`."""
    labels2d = np.asarray(labels_norm, np.float32)
    if labels2d.ndim == 1:
        labels2d = labels2d[:, None]
    n = len(images_u8)
    batch_size = min(batch_size, n)
    steps_per_epoch = max(n // batch_size, 1)
    if net is None:
        net = ResNetEmbed(dim_embed, labels2d.shape[1], num_blocks,
                          in_channels=images_u8.shape[-1], seed=seed)
    net = net.to(device)
    sched = lr_schedule(lr_base, lr_decay_epochs, steps_per_epoch)
    opt = torch.optim.SGD(net.parameters(), lr=sched(0), momentum=0.9,
                          weight_decay=weight_decay)
    images_dev = torch.from_numpy(np.ascontiguousarray(images_u8)).to(device)
    labels_dev = torch.from_numpy(labels2d).to(device)

    start_epoch = 0
    if ckpt_dir and resume_epoch > 0:
        tag = f"{ckpt_tag}_epoch{resume_epoch}"
        if not checkpoint_exists(ckpt_dir, tag):
            raise FileNotFoundError(
                f"no in-train embed checkpoint '{tag}' under {ckpt_dir}; "
                f"available checkpoints are saved every {ckpt_every} epochs")
        stored = load_checkpoint(ckpt_dir, tag)
        net.load_state_dict(stored["net"])
        opt.load_state_dict(stored["opt"])
        start_epoch = int(stored["epoch"])
        print(f" [resnet_embed] resumed '{tag}' at epoch {start_epoch}")

    t0 = time.perf_counter()
    loss = None
    for epoch in range(start_epoch, epochs):
        for s in range(steps_per_epoch):
            step = epoch * steps_per_epoch + s
            given = draws[step] if draws else {}
            gen = None if "idx" in given else step_generator(seed, step, device)
            loss = resnet_embed_step(net, opt, images_dev, labels_dev, batch_size,
                                     sched(step), gen, given.get("idx"))
        if log_every and (epoch + 1) % log_every == 0:
            print(f"\r [resnet_embed] epoch {epoch + 1}/{epochs} loss {float(loss):.5f}")
        if ckpt_dir and (epoch + 1) % ckpt_every == 0 and (epoch + 1) < epochs:
            save_checkpoint(ckpt_dir, f"{ckpt_tag}_epoch{epoch + 1}",
                            {"epoch": epoch + 1,
                             "net": {k: v.detach().cpu() for k, v in net.state_dict().items()},
                             "opt": opt.state_dict()})
    sync(device)
    net.seconds_per_epoch = (time.perf_counter() - t0) / max(epochs - start_epoch, 1)
    return net


@torch.no_grad()
def _features(net: ResNetEmbed, images_u8: np.ndarray) -> torch.Tensor:
    device = next(net.parameters()).device
    x = normalize_images(torch.from_numpy(np.ascontiguousarray(images_u8)).to(device),
                         to_neg_one_to_one=True)
    return net(x, train=False)[1]


def mean_feature(net: ResNetEmbed, images_u8: np.ndarray, batch_size: int = 256,
                 max_n: int = 2048) -> np.ndarray:
    """Mean stage-1 feature h over up to `max_n` evenly spaced training
    images, eval-mode forward of `net` (f32 sums per batch, f64 total)."""
    n = min(len(images_u8), max_n)
    idx = np.linspace(0, len(images_u8) - 1, n).astype(np.int64)
    total = np.zeros((net.x2h_dense2.out_features,), np.float64)
    for s in range(0, n, batch_size):
        h = _features(net, images_u8[idx[s:s + batch_size]])
        total += h.sum(0).cpu().numpy().astype(np.float64)
    return (total / n).astype(np.float32)


def per_label_mean_features(net: ResNetEmbed, images_u8: np.ndarray,
                            labels_norm: np.ndarray, unique_labels_norm: np.ndarray,
                            batch_size: int = 256) -> np.ndarray:
    """Per-unique-label mean stage-1 feature h̄(y) [n_unique, dim_embed],
    eval-mode forward of `net`; a label that is not in the list counts for
    nothing, an absent one gets zeros."""
    labels = np.asarray(labels_norm, np.float32).reshape(len(labels_norm), -1)[:, 0]
    uniq = np.asarray(unique_labels_norm, np.float32).reshape(-1)
    order = np.argsort(uniq, kind="stable")
    total = np.zeros((len(uniq), net.x2h_dense2.out_features), np.float64)
    count = np.zeros((len(uniq),), np.float64)
    for s in range(0, len(images_u8), batch_size):
        h = _features(net, images_u8[s:s + batch_size]).cpu().numpy().astype(np.float64)
        lab = labels[s:s + batch_size]
        pos = np.minimum(np.searchsorted(uniq[order], lab), len(uniq) - 1)
        hit = uniq[order][pos] == lab
        rows = order[pos[hit]]
        np.add.at(total, rows, h[hit])
        np.add.at(count, rows, 1.0)
    count = np.maximum(count, 1.0)
    return (total / count[:, None]).astype(np.float32)


def _noised_labels(labels: torch.Tensor, batch_size: int, noise_sigma: float,
                   gen: Optional[torch.Generator], idx: Optional[torch.Tensor],
                   noise: Optional[torch.Tensor]) -> torch.Tensor:
    """clip(labels[idx] + sigma * noise, 0, 1); idx and the N(0, 1) noise
    drawn from `gen` unless given."""
    dev = labels.device
    if idx is None:
        idx = torch.randint(0, labels.shape[0], (batch_size,), generator=gen, device=dev)
    if noise is None:
        noise = torch.randn((batch_size,), generator=gen, device=dev)
    return torch.clamp(labels[idx.to(dev)] + noise.to(dev) * noise_sigma, 0.0, 1.0)


def label_mlp_feat_step(mlp: nn.Module, opt: torch.optim.Optimizer, labels: torch.Tensor,
                        grid: torch.Tensor, targets: torch.Tensor, batch_size: int,
                        noise_sigma: float, gen: Optional[torch.Generator] = None,
                        idx: Optional[torch.Tensor] = None,
                        noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One step of the feature phase: mlp(y_noised) onto the interpolation
    of `targets` over the sorted `grid` of unique labels."""
    y = _noised_labels(labels, batch_size, noise_sigma, gen, idx, noise)
    i = torch.clamp(torch.searchsorted(grid, y), 1, grid.shape[0] - 1)
    y0, y1 = grid[i - 1], grid[i]
    w = torch.clamp((y - y0) / torch.clamp(y1 - y0, min=1e-8), 0.0, 1.0)[:, None]
    t = targets[i - 1] * (1 - w) + targets[i] * w
    opt.zero_grad(set_to_none=True)
    loss = ((mlp(y) - t) ** 2).mean()
    loss.backward()
    opt.step()
    return loss.detach()


def label_mlp_inv_step(mlp: nn.Module, opt: torch.optim.Optimizer, labels: torch.Tensor,
                       h2y_weight: torch.Tensor, h2y_bias: torch.Tensor, batch_size: int,
                       noise_sigma: float, lr: float, gen: Optional[torch.Generator] = None,
                       idx: Optional[torch.Tensor] = None,
                       noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One step of the inversion phase through the leaky_relu(0.01)
    surrogate of the frozen h2y head."""
    y = _noised_labels(labels, batch_size, noise_sigma, gen, idx, noise)
    set_lr(opt, lr)
    opt.zero_grad(set_to_none=True)
    y_rec = F.leaky_relu(F.linear(mlp(y), h2y_weight, h2y_bias), 0.01)[:, 0]
    loss = ((y_rec - y) ** 2).mean()
    loss.backward()
    opt.step()
    return loss.detach()


def train_label_mlp(
    unique_labels_norm: np.ndarray,
    h2y: nn.Linear,
    mlp: nn.Module,
    epochs: int = 500,
    batch_size: int = 128,
    lr_base: float = 0.01,
    lr_decay_epochs=(150, 250, 350),
    weight_decay: float = 1e-4,
    noise_sigma: float = 0.2,
    seed: int = 1,
    log_every: int = 50,
    feat_mean: Optional[np.ndarray] = None,
    feat_targets: Optional[np.ndarray] = None,
    draws: Optional[Sequence[dict]] = None,
) -> nn.Module:
    """Stage 2: train `mlp` (moved to `h2y`'s device) to invert the frozen
    head `h2y` (a trained ResNetEmbed's); with `feat_targets` the first
    half of the epochs is the feature phase. `draws[step]` may hold that step's "idx"
    and "noise". Warns when the true ReLU head reconstructs 0 for every
    label. Sets `mlp.seconds_per_epoch`."""
    device = h2y.weight.device
    labels = np.asarray(unique_labels_norm, np.float32).reshape(-1)
    n = len(labels)
    batch_size = min(batch_size, n)
    steps_per_epoch = max(n // batch_size, 1)
    mlp = mlp.to(device)
    if feat_mean is not None:
        with torch.no_grad():
            mlp.dense_out.bias.copy_(torch.as_tensor(feat_mean, dtype=torch.float32))
    sched = lr_schedule(lr_base, lr_decay_epochs, steps_per_epoch)
    opt = torch.optim.SGD(mlp.parameters(), lr=sched(0), momentum=0.9,
                          weight_decay=weight_decay)
    opt_feat = torch.optim.Adam(mlp.parameters(), lr=1e-3)
    labels_dev = torch.from_numpy(labels).to(device)
    h2y_w, h2y_b = h2y.weight.detach(), h2y.bias.detach()
    order = np.argsort(labels)
    grid = torch.from_numpy(np.ascontiguousarray(labels[order])).to(device)
    targets = (torch.from_numpy(np.asarray(feat_targets, np.float32)[order]).to(device)
               if feat_targets is not None else None)

    feat_epochs = epochs // 2 if feat_targets is not None else 0
    inv_count = 0
    t0 = time.perf_counter()
    for epoch in range(epochs):
        do_feat = epoch < feat_epochs
        for s in range(steps_per_epoch):
            step = epoch * steps_per_epoch + s
            given = draws[step] if draws else {}
            gen = None if "idx" in given else step_generator(seed, step, device)
            if do_feat:
                loss = label_mlp_feat_step(mlp, opt_feat, labels_dev, grid, targets,
                                           batch_size, noise_sigma, gen, given.get("idx"),
                                           given.get("noise"))
            else:
                loss = label_mlp_inv_step(mlp, opt, labels_dev, h2y_w, h2y_b, batch_size,
                                          noise_sigma, sched(inv_count), gen,
                                          given.get("idx"), given.get("noise"))
                inv_count += 1
        if log_every and (epoch + 1) % log_every == 0:
            print(f"\r [label_mlp] epoch {epoch + 1}/{epochs} "
                  f"{'feat' if do_feat else 'inv'}_loss {float(loss):.6f}")
    sync(device)
    mlp.seconds_per_epoch = (time.perf_counter() - t0) / max(epochs, 1)

    with torch.no_grad():
        y_rec = F.relu(F.linear(mlp(labels_dev), h2y_w, h2y_b))
    if float(y_rec.max()) <= 1e-6:
        print(" WARNING [label_mlp]: frozen h2y head reconstructs 0 for all labels "
              "(dead ReLU) — the learned embedding carries no label information; "
              "pass feat_mean=mean_feature(...) to re-train")
    return mlp


def dataset_fingerprint(images_u8: np.ndarray, labels: np.ndarray) -> str:
    """Short content hash of the data an embedding was fit on (the shape,
    the labels, every (D // 64)-th value of each image)."""
    imgs = np.ascontiguousarray(np.asarray(images_u8))
    lab = np.ascontiguousarray(np.asarray(labels, np.float32))
    h = hashlib.sha1()
    h.update(np.asarray(imgs.shape, np.int64).tobytes())
    h.update(lab.tobytes())
    flat = imgs.reshape(len(imgs), -1)
    h.update(np.ascontiguousarray(flat[:, :: max(1, flat.shape[1] // 64)]).tobytes())
    return h.hexdigest()[:12]


def _check_embed_datafp(embed_dir: str, tag: str, fp: Optional[str]) -> None:
    """Raise SystemExit if a cached embedding was fit on other data; warn
    if it has no fingerprint; nothing to check without data (`fp` None)."""
    marker = os.path.join(embed_dir, f"datafp-{tag}.txt")
    if fp is None:
        return
    if not os.path.exists(marker):
        print(f" ILI WARNING: cached embedding '{tag}' has no data fingerprint; "
              f"cannot verify it was fit on this dataset")
        return
    with open(marker) as f:
        stored = f.read().strip()
    if stored != fp:
        raise SystemExit(
            f"cached embedding '{tag}' under {embed_dir} was fit on a DIFFERENT "
            f"dataset (fingerprint {stored} != current {fp}). Delete {embed_dir} or "
            f"use a fresh --root_path/--setting_name.")


def _write_embed_datafp(embed_dir: str, tag: str, fp: Optional[str]) -> None:
    if fp is not None:
        with open(os.path.join(embed_dir, f"datafp-{tag}.txt"), "w") as f:
            f.write(fp + "\n")


def find_cached_embedding(embed_dir: str, prefix: str, exact_tag: str,
                          exclude: Optional[set] = None) -> Optional[str]:
    """The exact tag if cached, else the newest entry model-<prefix>_* that
    holds a state.pt; in-train CNN checkpoints (_cnn_epoch) and the tags in
    `exclude` never count."""
    exclude = exclude or set()
    if exact_tag not in exclude and checkpoint_exists(embed_dir, exact_tag):
        return exact_tag
    tags = [os.path.basename(h)[len("model-"):]
            for h in glob.glob(os.path.join(embed_dir, f"model-{prefix}_*"))]
    tags = [t for t in tags if "_cnn_epoch" not in t and t not in exclude
            and checkpoint_exists(embed_dir, t)]
    if not tags:
        return None
    return max(tags, key=lambda t: os.path.getmtime(os.path.join(embed_dir, f"model-{t}")))


def _cached_mlp(embed_dir: str, prefix: str, tag: str, what: str):
    """(tag, MLP state_dict) of the newest complete cache entry, skipping
    entries without an "mlp"; (None, None) on a miss."""
    partial: set = set()
    while True:
        cached = find_cached_embedding(embed_dir, prefix, tag, exclude=partial)
        if cached is None:
            return None, None
        stored = load_checkpoint(embed_dir, cached)
        if "mlp" in stored:
            if cached != tag:
                print(f" ILI {what}: loaded cached '{cached}' (requested '{tag}' not found)")
            return cached, stored["mlp"]
        print(f" ILI {what}: ignoring incomplete cache '{cached}'")
        partial.add(cached)


def frozen_embedding(mlp: nn.Module, device, combiner: Optional[nn.Module] = None,
                     multi_dim: bool = True) -> Callable[[torch.Tensor], torch.Tensor]:
    """labels [B] or [B, 1] -> the frozen `mlp`'s output, f32 on `device`;
    labels [B, D] -> `mlp` on each dim, combined by `combiner` (the mean if
    None), or with `multi_dim` False a ValueError."""
    mlp = mlp.to(device).float().eval().requires_grad_(False)
    if combiner is not None:
        combiner = combiner.to(device)

    def fn(y) -> torch.Tensor:
        y = torch.as_tensor(y, dtype=torch.float32, device=device)
        with torch.no_grad():
            if y.ndim <= 1 or y.shape[-1] == 1:
                return mlp(y.reshape(-1))
            if not multi_dim:
                raise ValueError(
                    f"the resnet y2cov embedding takes scalar labels, not [B, {y.shape[-1]}]: "
                    "ccdm_tpu flattens multi-dim labels to [B*D] there "
                    "(ccdm_tpu/embedding/ili.py:635) and its H(y) reshape to [B, C, H, W] "
                    "fails, so multi-dim --use_Hy with --y2cov_embed_type resnet has no "
                    "reference result")
            return combine(torch.stack([mlp(y[:, d]) for d in range(y.shape[1])]), combiner)

    return fn


class LabelEmbed:
    """Train-or-load the ILI pipeline; exposes fn_y2h and fn_y2cov.

    With `dataset` None or `require_cached`, it only loads: a missing cache
    raises FileNotFoundError, and nothing is trained or written."""

    def __init__(
        self,
        dataset,  # DatasetBundle, or None for load-only mode
        path: str,
        dim_embed: int = 128,
        y2cov_type: Optional[str] = None,
        cov_dim: Optional[int] = None,
        epochs_cnn: int = 200,
        epochs_mlp: int = 500,
        epochs_cnn_y2cov: int = 10,
        epochs_mlp_y2cov: int = 500,
        batch_size: int = 256,
        seed: int = 0,
        dim_combination: str = "mean",
        require_cached: bool = False,
        label_dim: Optional[int] = None,
        net_embed: str = "ResNet34_embed",
        net_embed_y2cov: str = "ResNet34_embed_y2cov",
        batch_size_y2cov: Optional[int] = None,
        resume_epoch_cnn: int = 0,
        resume_epoch_cnn_y2cov: int = 0,
        device="cpu",
    ):
        self.dim_embed = dim_embed
        embed_dir = os.path.join(path, "embed_models")
        load_only = require_cached or dataset is None
        if dataset is not None:
            labels = np.asarray(dataset.labels_norm, np.float32)
            label_dim = 1 if labels.ndim == 1 else labels.shape[1]
            uniq = np.unique(labels.reshape(len(labels), -1), axis=0)
            # the MLP's training labels: scalars, or every dim of every unique row
            uniq1 = uniq[:, 0] if label_dim == 1 else uniq.reshape(-1)
            data_fp = dataset_fingerprint(dataset.images, labels)
        else:
            label_dim, uniq, data_fp = label_dim or 1, None, None
        noise_sigma = 0.2 if label_dim == 1 else 0.05
        if not load_only:
            os.makedirs(embed_dir, exist_ok=True)
        STAGE_SECONDS.clear()

        def train(kind: str, prefix_dim: int, tag: str, mlp: nn.Module, net_name: str,
                  epochs_cnn_, epochs_mlp_, batch, seed_cnn, resume):
            resnet = train_resnet_embed(
                dataset.images, labels, prefix_dim, epochs=epochs_cnn_, batch_size=batch,
                seed=seed_cnn, num_blocks=_embed_blocks(net_name), ckpt_dir=embed_dir,
                ckpt_tag=f"{tag}_cnn", resume_epoch=resume, device=device)
            mlp = train_label_mlp(
                uniq1, resnet.h2y, mlp, epochs=epochs_mlp_, noise_sigma=noise_sigma,
                seed=seed_cnn + 1, feat_mean=mean_feature(resnet, dataset.images),
                feat_targets=(per_label_mean_features(resnet, dataset.images, labels, uniq1)
                              if label_dim == 1 else None))
            STAGE_SECONDS[f"{kind}_cnn"] = resnet.seconds_per_epoch
            STAGE_SECONDS[f"{kind}_mlp"] = mlp.seconds_per_epoch
            save_checkpoint(embed_dir, tag, {"mlp": {k: v.detach().cpu()
                                                     for k, v in mlp.state_dict().items()}})
            _write_embed_datafp(embed_dir, tag, data_fp)
            return resnet, mlp

        # ---- y2h: a non-default stage-1 depth marks the tag
        net_mark = "" if net_embed == "ResNet34_embed" else f"_{net_embed.split('_')[0]}"
        tag = f"y2h_d{dim_embed}_e{epochs_cnn}_m{epochs_mlp}_seed{seed}{net_mark}"
        cached, state = _cached_mlp(embed_dir, f"y2h_d{dim_embed}", tag, "y2h")
        resnet = None
        mlp = ModelY2H(dim_embed, seed=seed + 1)
        if cached is not None:
            _check_embed_datafp(embed_dir, cached, data_fp)
            mlp.load_state_dict(state)
        elif load_only:
            raise FileNotFoundError(
                f"no trained ILI y2h embedding (y2h_d{dim_embed}_*) under {embed_dir}; "
                f"train the teacher first (main.py with --y2h_embed_type resnet) or point "
                f"at its setting folder")
        else:
            resnet, mlp = train("y2h", dim_embed, tag, mlp, net_embed, epochs_cnn, epochs_mlp,
                                batch_size, seed, resume_epoch_cnn)
        combiner = (combiner_weights(embed_dir, "y2h", dim_combination, dim_embed, label_dim,
                                     seed + COMBINER_SEED_OFFSET, write=not load_only)
                    if label_dim > 1 else None)
        self.fn_y2h = frozen_embedding(mlp, device, combiner)
        if resnet is not None:  # y -> h -> y_hat roundtrip, only right after training
            probe = torch.tensor(np.quantile(uniq[:, 0], [0.1, 0.5, 0.9]), dtype=torch.float32)
            with torch.no_grad():
                y_rec = resnet.h2y_head(self.fn_y2h(probe))[:, 0].cpu()
            print(" ILI sanity y->h->y_hat:",
                  [f"{float(a):.3f}->{float(b):.3f}" for a, b in zip(probe, y_rec)])

        # ---- y2cov (optional)
        self.fn_y2cov = None
        if y2cov_type is None:
            return
        assert cov_dim is not None
        if y2cov_type != "resnet":
            from ccdm_tpu_torch.embedding.analytic import (
                Y2COV_SEED, gaussian_projection, make_fn_y2cov, selected_dims)

            W = (gaussian_projection(embed_dir, "y2cov", cov_dim, Y2COV_SEED,
                                     write=not load_only,
                                     num_dims=len(selected_dims(label_dim)))
                 if y2cov_type == "gaussian" else None)
            self.fn_y2cov = make_fn_y2cov(cov_dim, y2cov_type, label_dim, W=W)
            return
        cov_mark = ("" if net_embed_y2cov == "ResNet34_embed_y2cov"
                    else f"_{net_embed_y2cov.split('_')[0]}")
        tag_cov = (f"y2cov_d{cov_dim}_e{epochs_cnn_y2cov}_m{epochs_mlp_y2cov}"
                   f"_seed{seed}{cov_mark}")
        cached, state = _cached_mlp(embed_dir, f"y2cov_d{cov_dim}", tag_cov, "y2cov")
        cov_mlp = ModelY2Cov(cov_dim, seed=seed + 3)
        if cached is not None:
            _check_embed_datafp(embed_dir, cached, data_fp)
            cov_mlp.load_state_dict(state)
        elif load_only:
            raise FileNotFoundError(
                f"no trained ILI y2cov embedding (y2cov_d{cov_dim}_*) under {embed_dir}; "
                f"train the teacher first")
        else:
            _, cov_mlp = train("y2cov", cov_dim, tag_cov, cov_mlp, net_embed_y2cov,
                               epochs_cnn_y2cov, epochs_mlp_y2cov, batch_size_y2cov or batch_size,
                               seed + 2, resume_epoch_cnn_y2cov)
        self.fn_y2cov = frozen_embedding(cov_mlp, device, multi_dim=False)
        # a cov embedding constant in y makes H(y) label-independent; a heavy
        # tail of h is what DiffusionConfig.hy_max_log caps
        probe_cov = self.fn_y2cov(torch.tensor([0.1, 0.9])).cpu()
        rel = (float(torch.linalg.norm(probe_cov[0] - probe_cov[1]))
               / max(float(torch.linalg.norm(probe_cov[0])), 1e-8))
        print(f" ILI y2cov label variation |c(0.1)-c(0.9)|/|c(0.1)| = {rel:.4f}"
              + ("  (WARNING: ~constant in y)" if rel < 1e-3 else ""))
        h_mean, h_max = float(probe_cov.mean()), float(probe_cov.max())
        print(f" ILI y2cov log-scale h: mean {h_mean:.4f} max {h_max:.2f}"
              f"  (1/Hy mean {float(torch.exp(probe_cov).mean()):.1f})"
              + ("  (WARNING: heavy tail; hy_max_log cap will engage)" if h_max > 4.0 else ""))
