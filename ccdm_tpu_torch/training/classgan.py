"""Class-conditional GANs with StudioGAN's conditional losses
(ccdm_tpu/training/classgan.py).

- D2D-CE (ReACGAN): a head maps D's features to a unit embedding and holds
  unit class proxies; the loss is the cross-entropy of the sample-proxy
  similarity (clamped at m_p) against the same-batch similarities to
  samples of other classes (clamped below at -m_n), over a temperature.
- ADC (ADCGAN): a 2K-way classifier over (class, real/fake); D classifies
  reals as 2c and fakes as 2c + 1, G pushes fakes toward 2c and away from
  2c + 1.

ClassGANTrainer trains a projection cGAN (models/sngan.py at one-hot
labels) with the hinge loss plus lambda_cond times the conditional loss,
one Adam(0.5, 0.999) over G and one over D and the head together. Which
net runs in which mode, as the JAX trainer runs them:
- D step: netG in train mode without a gradient (its BatchNorm statistics
  move), netD in train mode on the reals, then the fakes (its spectral
  norms' u move twice);
- G step: netG in train mode, netD in eval mode (its u not stored).

Each step is a function of its draws: `d_step(gen, draws)` takes "idx"
(the real batch), "cls_fake", "z", "aug_real" and "aug_fake" (DiffAugment's
draws, training/diffaugment.py); `g_step(gen, draws)` takes "cls_fake",
"z" and "aug"; what `draws` does not hold comes from `gen`. `train` gives
step s the generator training/optim.step_generator(seed, s).

With a data-parallel `mesh` (parallel/mesh.py; by default the process
group's) every rank draws a step at the global batch, runs G and D on its
own rows (`sharded_apply`), applies the head to the gathered features with
its gradient counted once (`replicated_apply`) and sums the gradients over
the ranks before Adam; milestones, logs and grids are written by rank 0.

A milestone <results_folder>/model-classgan-<N>/state.pt holds
`checkpoint_tree`: JAX's ClassGANTrainer.state layout with lists of
tensors (parameters in parameters() order, statistics in buffers()
order), which utils/convert.classgan_state_from_jax also writes.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ccdm_tpu_torch.models.layers import lecun_normal_
from ccdm_tpu_torch.ops.image import normalize_images
from ccdm_tpu_torch.training.diffaugment import diff_augment
from ccdm_tpu_torch.parallel.mesh import (
    all_reduce_grads,
    barrier,
    create_mesh,
    replicated,
    replicated_apply,
    sharded_apply,
)
from ccdm_tpu_torch.training.dmd import _grads, stats_of
from ccdm_tpu_torch.training.optim import step_generator
from ccdm_tpu_torch.training.state import AdamState, adam_init, adam_update
from ccdm_tpu_torch.training.trainer import chunk_seed, copy_tensors
from ccdm_tpu_torch.utils.ckpt import load_checkpoint, save_checkpoint
from ccdm_tpu_torch.utils.logging import TrainLogger
from ccdm_tpu_torch.utils.viz import save_image_grid

ADAM_BETAS = (0.5, 0.999)
HEAD_SEED_OFFSET = 5  # the head's init: PRNGKey(seed + 5) in JAX
SAMPLE_SEED_OFFSET = 999  # sample_given_classes' key base: PRNGKey(seed + 999)


def _dense(in_features: int, out_features: int, gen: torch.Generator) -> nn.Linear:
    """flax's Dense init: lecun-normal kernel, zero bias."""
    layer = nn.Linear(in_features, out_features)
    with torch.no_grad():
        lecun_normal_(layer.weight, in_features, gen)
        layer.bias.zero_()
    return layer


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)


class D2DCEHead(nn.Module):
    """ReACGAN's head: features -> (unit embedding [B, E], unit proxies [K, E])."""

    def __init__(self, in_features: int, embed_dim: int, num_classes: int, seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.embed = _dense(in_features, embed_dim, gen)
        self.proxies = nn.Parameter(torch.randn(num_classes, embed_dim, generator=gen) * 0.02)

    def forward(self, features: torch.Tensor):
        return _unit(self.embed(features)), _unit(self.proxies)


def d2d_ce_loss(emb: torch.Tensor, proxies: torch.Tensor, labels: torch.Tensor,
                temperature: float = 0.5, m_p: float = 0.98, m_n: float = 1.0) -> torch.Tensor:
    """Data-to-data cross-entropy: positives the sample-proxy similarities
    (at most m_p), negatives the same-batch similarities to samples of
    another class (at least -m_n)."""
    labels = labels.long()
    pos = torch.clamp(torch.sum(emb * proxies[labels], dim=-1), max=m_p) / temperature
    neg = torch.clamp(emb @ emb.T, min=-m_n) / temperature
    neg = torch.where(labels[:, None] != labels[None, :], neg,
                      torch.full_like(neg, float("-inf")))
    logz = torch.logsumexp(torch.cat([pos[:, None], neg], dim=1), dim=1)
    return torch.mean(logz - pos)


class ADCHead(nn.Module):
    """ADCGAN's auxiliary classifier: features -> 2 * num_classes logits."""

    def __init__(self, in_features: int, num_classes: int, seed: int = 0):
        super().__init__()
        self.adc = _dense(in_features, 2 * num_classes, torch.Generator().manual_seed(seed))

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        return self.adc(features)


def adc_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor,
               labels_real: torch.Tensor, labels_fake: torch.Tensor,
               num_classes: int) -> torch.Tensor:
    """D: reals as (c, real) = 2c, fakes as (c, fake) = 2c + 1."""
    return (F.cross_entropy(logits_real, 2 * labels_real.long())
            + F.cross_entropy(logits_fake, 2 * labels_fake.long() + 1))


def adc_g_loss(logits_fake: torch.Tensor, labels_fake: torch.Tensor,
               num_classes: int) -> torch.Tensor:
    """G: toward (c, real), away from (c, fake)."""
    return (F.cross_entropy(logits_fake, 2 * labels_fake.long())
            - F.cross_entropy(logits_fake, 2 * labels_fake.long() + 1))


@dataclasses.dataclass
class ClassGANConfig:
    num_classes: int = 10
    niters: int = 10000
    batch_size: int = 64
    num_D_steps: int = 1
    lr_g: float = 1e-4
    lr_d: float = 1e-4
    dim_z: int = 128
    cond_loss: str = "d2dce"  # d2dce | adc | none (a pure projection cGAN)
    lambda_cond: float = 1.0
    d2dce_embed_dim: int = 128
    use_DiffAugment: bool = False
    policy: str = "color,translation,cutout"
    save_niters_freq: int = 5000
    visualize_freq: int = 2000
    results_folder: str = "./classgan_results"
    log_every: int = 20
    seed: int = 2021


class ClassGANTrainer:
    def __init__(self, netG: nn.Module, netD: nn.Module, train_images: np.ndarray,
                 train_classes: np.ndarray, config: ClassGANConfig, device=None, mesh=None):
        """netG, netD: models/sngan.py nets with dim_embed num_classes, on
        `device`; train_images uint8 [N, H, W, C]; train_classes [N] ints."""
        cfg = self.cfg = config
        self.device = torch.device(device) if device is not None else \
            next(netG.parameters()).device
        self.netG, self.netD = netG, netD
        self.train_images = torch.from_numpy(np.asarray(train_images)).to(self.device)
        self.train_classes = torch.from_numpy(
            np.asarray(train_classes, np.int64)).to(self.device)
        self.n = len(train_images)

        # the conditional head on D's features (their width read off one
        # eval forward, as JAX reads it at the head's init)
        self.head = None
        if cfg.cond_loss in ("d2dce", "adc"):
            h, w, c = train_images.shape[1:]
            with torch.no_grad():
                _, phi = netD(torch.zeros(2, c, h, w, device=self.device),
                              torch.zeros(2, cfg.num_classes, device=self.device),
                              train=False, return_features=True)
            seed = cfg.seed + HEAD_SEED_OFFSET
            self.head = (D2DCEHead(phi.shape[1], cfg.d2dce_embed_dim, cfg.num_classes, seed)
                         if cfg.cond_loss == "d2dce"
                         else ADCHead(phi.shape[1], cfg.num_classes, seed)).to(self.device)

        self.mesh = mesh if mesh is not None else create_mesh()
        for net in (netG, netD, self.head):
            if net is not None:
                replicated(self.mesh, net)
        self._mesh = self.mesh.over(cfg.batch_size)  # the steps' mesh
        self.step = 0
        self.g_params = list(netG.parameters())
        self.d_params = list(netD.parameters()) + self.head_params()
        self.g_opt: AdamState = adam_init(self.g_params)
        self.d_opt: AdamState = adam_init(self.d_params)
        os.makedirs(cfg.results_folder, exist_ok=True)

    def head_params(self) -> list:
        return [] if self.head is None else list(self.head.parameters())

    # ----------------------------------------------------------- helpers

    def _onehot(self, classes: torch.Tensor) -> torch.Tensor:
        return F.one_hot(classes.long(), self.cfg.num_classes).float()

    def _aug(self, x: torch.Tensor, gen, draws) -> torch.Tensor:
        if not self.cfg.use_DiffAugment:
            return x
        return diff_augment(x, self.cfg.policy, gen, draws)

    def _int(self, value, hi: int, b: int, gen) -> torch.Tensor:
        """[b] integers in [0, hi): `value`, or a draw from gen."""
        if value is None:
            value = torch.randint(0, hi, (b,), generator=gen, device=self.device)
        return value.to(self.device, torch.long)

    def _z(self, gen, draws: dict) -> torch.Tensor:
        z = draws.get("z")
        if z is None:
            z = torch.randn(self.cfg.batch_size, self.cfg.dim_z, generator=gen,
                            device=self.device)
        return z.to(self.device)

    def _cond_d(self, phi_real, phi_fake, cls_real, cls_fake) -> torch.Tensor:
        cfg = self.cfg
        head = lambda phi: replicated_apply(self._mesh, self.head, phi)
        if cfg.cond_loss == "d2dce":
            emb_r, proxies = head(phi_real)
            return d2d_ce_loss(emb_r, proxies, cls_real)
        if cfg.cond_loss == "adc":
            return adc_d_loss(head(phi_real), head(phi_fake), cls_real, cls_fake,
                              cfg.num_classes)
        return torch.zeros((), device=self.device)

    def _cond_g(self, phi_fake, cls_fake) -> torch.Tensor:
        cfg = self.cfg
        head = lambda phi: replicated_apply(self._mesh, self.head, phi)
        if cfg.cond_loss == "d2dce":
            emb_f, proxies = head(phi_fake)
            return d2d_ce_loss(emb_f, proxies, cls_fake)
        if cfg.cond_loss == "adc":
            return adc_g_loss(head(phi_fake), cls_fake, cfg.num_classes)
        return torch.zeros((), device=self.device)

    # ------------------------------------------------------------- steps

    def d_step(self, gen: Optional[torch.Generator] = None,
               draws: Optional[dict] = None) -> torch.Tensor:
        """One D (and head) step; returns the loss on the device."""
        cfg, draws = self.cfg, draws or {}
        b = cfg.batch_size
        idx = self._int(draws.get("idx"), self.n, b, gen)
        real = normalize_images(self.train_images[idx], to_neg_one_to_one=True)
        real = real.permute(0, 3, 1, 2)
        cls_real = self.train_classes[idx]
        cls_fake = self._int(draws.get("cls_fake"), cfg.num_classes, b, gen)
        z = self._z(gen, draws)
        mesh = self._mesh
        with torch.no_grad():  # netG in train mode: its statistics move here too
            fake = sharded_apply(mesh, self.netG, z, self._onehot(cls_fake), train=True)
        out_r, phi_r = sharded_apply(mesh, self.netD, self._aug(real, gen, draws.get("aug_real")),
                                     self._onehot(cls_real), train=True, return_features=True)
        out_f, phi_f = sharded_apply(mesh, self.netD, self._aug(fake, gen, draws.get("aug_fake")),
                                     self._onehot(cls_fake), train=True, return_features=True)
        adv = torch.mean(F.relu(1.0 - out_r)) + torch.mean(F.relu(1.0 + out_f))
        loss = adv + cfg.lambda_cond * self._cond_d(phi_r, phi_f, cls_real, cls_fake)
        grads = all_reduce_grads(mesh, _grads(loss, self.d_params))
        adam_update(self.d_opt, grads, cfg.lr_d, *ADAM_BETAS,
                    params=[p.data for p in self.d_params])
        return loss.detach()

    def g_step(self, gen: Optional[torch.Generator] = None,
               draws: Optional[dict] = None) -> torch.Tensor:
        """One G step through the eval-mode D; returns the loss."""
        cfg, draws = self.cfg, draws or {}
        cls_fake = self._int(draws.get("cls_fake"), cfg.num_classes, cfg.batch_size, gen)
        z = self._z(gen, draws)
        mesh = self._mesh
        fake = sharded_apply(mesh, self.netG, z, self._onehot(cls_fake), train=True)
        out_f, phi_f = sharded_apply(mesh, self.netD, self._aug(fake, gen, draws.get("aug")),
                                     self._onehot(cls_fake), train=False, return_features=True)
        loss = -torch.mean(out_f) + cfg.lambda_cond * self._cond_g(phi_f, cls_fake)
        grads = all_reduce_grads(mesh, _grads(loss, self.g_params))
        adam_update(self.g_opt, grads, cfg.lr_g, *ADAM_BETAS,
                    params=[p.data for p in self.g_params])
        return loss.detach()

    # -------------------------------------------------------------- train

    def train(self, progress: bool = True) -> None:
        """Steps self.step + 1 .. niters: num_D_steps D steps and a G step
        each, a log line every log_every steps, a grid every
        visualize_freq, a milestone every save_niters_freq and at niters."""
        cfg = self.cfg
        main = self.mesh.is_main
        logger = TrainLogger(cfg.results_folder, cfg.niters) if main else None
        for step in range(self.step + 1, cfg.niters + 1):
            gen = step_generator(cfg.seed, step, self.device)
            d_losses = [self.d_step(gen) for _ in range(cfg.num_D_steps)]
            g_loss = self.g_step(gen)
            self.step = step
            if main and step % cfg.log_every == 0:
                d_loss = float(torch.stack(d_losses).mean())
                logger.log_scalars({"step": step, "d_loss": d_loss, "g_loss": float(g_loss)})
                if progress:
                    print(f"classgan step {step}/{cfg.niters} d={d_loss:.4f} "
                          f"g={float(g_loss):.4f}", flush=True)
            if main and step % cfg.visualize_freq == 0:
                self._dump_visual_grid(step)
            if step % cfg.save_niters_freq == 0:
                self.save(step)
        if cfg.niters % cfg.save_niters_freq != 0:
            self.save(cfg.niters)

    def _dump_visual_grid(self, step: int) -> None:
        """Six eval-mode images of each of the first min(K, 8) classes."""
        classes = np.repeat(np.arange(min(self.cfg.num_classes, 8)), 6)
        imgs = self.sample_given_classes(classes, batch_size=len(classes))
        save_image_grid(np.clip(imgs / 255.0, 0.0, 1.0),
                        os.path.join(self.cfg.results_folder, f"sample_{step}.png"), nrow=6)

    # ----------------------------------------------------------- sampling

    @torch.no_grad()
    def sample_given_classes(self, classes: np.ndarray, batch_size: int = 200) -> np.ndarray:
        """Eval-mode G images of integer classes, uint8 [n, H, W, C], in
        chunks of batch_size, the last padded with the first classes; chunk
        s draws z from a generator seeded from (seed + 999, s)."""
        cfg = self.cfg
        classes = np.asarray(classes)
        n = len(classes)
        batch_size = min(batch_size, n)
        pad = (-n) % batch_size
        cls_pad = np.concatenate([classes, classes[:pad]]) if pad else classes
        out = []
        for s in range(0, len(cls_pad), batch_size):
            gen = torch.Generator(device=self.device).manual_seed(
                chunk_seed(cfg.seed + SAMPLE_SEED_OFFSET, s))
            z = torch.randn(batch_size, cfg.dim_z, generator=gen, device=self.device)
            y = self._onehot(torch.from_numpy(cls_pad[s:s + batch_size]).to(self.device))
            fake = self.netG(z, y, train=False).permute(0, 2, 3, 1)
            out.append((torch.clamp(fake * 0.5 + 0.5, 0.0, 1.0) * 255.0).cpu().numpy())
        return np.concatenate(out)[:n].astype(np.uint8)

    # --------------------------------------------------------- checkpoints

    def checkpoint_tree(self) -> dict:
        """The trainer's state in JAX's ClassGANTrainer.state layout,
        tensors copied to the CPU."""
        cpu = lambda ts: [t.detach().cpu().clone() for t in ts]
        opt = lambda o: {"mu": cpu(o.mu), "nu": cpu(o.nu), "count": o.count}
        return {"step": self.step, "g_params": cpu(self.g_params),
                "g_stats": cpu(stats_of(self.netG)),
                "d_params": {"d": cpu(self.netD.parameters()), "head": cpu(self.head_params())},
                "d_stats": cpu(stats_of(self.netD)),
                "g_opt": opt(self.g_opt), "d_opt": opt(self.d_opt)}

    def save(self, milestone) -> str:
        """Rank 0 writes the milestone (JAX classgan.py:357), then the ranks meet."""
        path = save_checkpoint(self.cfg.results_folder, f"classgan-{milestone}",
                               self.checkpoint_tree()) if self.mesh.is_main else ""
        barrier(self.mesh)
        return path

    def load(self, milestone) -> None:
        self.load_tree(load_checkpoint(self.cfg.results_folder, f"classgan-{milestone}"))

    @torch.no_grad()
    def load_tree(self, tree: dict) -> None:
        """Copy a checkpoint tree into the trainer in place; raises on a tree
        that does not fit its nets."""
        for what, dst, src in (("G params", self.g_params, tree["g_params"]),
                               ("G stats", stats_of(self.netG), tree["g_stats"]),
                               ("D params", list(self.netD.parameters()), tree["d_params"]["d"]),
                               ("head params", self.head_params(), tree["d_params"]["head"]),
                               ("D stats", stats_of(self.netD), tree["d_stats"])):
            copy_tensors([t.data for t in dst], src, what)
        for opt, key in ((self.g_opt, "g_opt"), (self.d_opt, "d_opt")):
            copy_tensors(opt.mu, tree[key]["mu"], f"{key} mu")
            copy_tensors(opt.nu, tree[key]["nu"], f"{key} nu")
            opt.count = int(tree[key]["count"])
        self.step = int(tree["step"])
