"""CcGAN and Dual-NDA trainer (ccdm_tpu/training/ccgan.py).

- D loss = mean(w_real L_real) + nda_a mean(w_fake L_fake), plus, from
  iteration nda_start_iter on, nda_b times corrupted reals (a jigsaw, a
  stitch or a cutout, one picked per step), nda_c times reals whose labels
  lie outside the vicinity (Type II), and nda_d / nda_e times pre-generated
  bad fakes (Type I); hinge or vanilla.
- Fake labels ~ U[target +- radius] clipped to [0, 1], the radius kappa
  (hard) or sqrt(-ln tau) kappa (soft, kappa being the raw radius); soft
  weights exp(-d^2 / kappa^2) against the targets, hard weights 1.
- Adam(0.5, 0.999) for both nets.
Which net runs in which mode, as the JAX trainer runs them: in the D step
netG in train mode without a gradient (its BatchNorm statistics move) and
netD in train mode on every batch it scores (its spectral norms' u move at
each); in the G step netG in train mode and netD in eval mode.

Each step is a function of its draws, `d_step(use_nda, gen, draws)` and
`g_step(gen, draws)`; what `draws` does not hold comes from `gen`, each
draw on its own. The JAX trainer feeds one key to several consumers (the
pick, the jigsaw, the stitch, the cutout and the augmentation of the
corrupted batch share keys[4]; keys[5], [6] and [7] each feed a choice and
an augmentation); the tests hand in the values JAX drew for every
consumer. D step: "target_idx", "target_eps", "gumbel" [B, N] (the
vicinity choice), "data_aug" (the dataset's "hflip", "vflip", "rot90"),
"fake_u", "z", "aug_real", "aug_fake" (DiffAugment's draws), and for
Dual-NDA "nda_b" {"pick", "perm" [B, 4] (the jigsaw's), "stitch" [B],
"cutout" {"cy", "cx"}, "aug"}, "nda_c" {"gumbel" [B, N], "aug"}, "nda_d"
and "nda_e" {"idx", "aug"}. G step: "target_idx", "target_eps", "z",
"aug". `train` gives iteration s the generator
training/optim.step_generator(seed, s).

With a data-parallel `mesh` (parallel/mesh.py; by default the process
group's) every rank draws a step at the global batch, runs G and D on its
own rows (`sharded_apply`) and sums the gradients over the ranks before
Adam; milestones, logs and grids are written by rank 0.

A milestone <results_folder>/model-ccgan-<N>/state.pt holds
`checkpoint_tree`, JAX's CcGANTrainer.state layout with lists of tensors,
which utils/convert.ccgan_state_from_jax also writes.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ccdm_tpu_torch.ops.image import augment_for_dataset, normalize_images, to_uint8
from ccdm_tpu_torch.ops.vicinal import pairwise_distance, soft_weights_from_targets
from ccdm_tpu_torch.parallel.mesh import (
    all_reduce_grads,
    barrier,
    create_mesh,
    replicated,
    sharded_apply,
)
from ccdm_tpu_torch.training.diffaugment import diff_augment, rand_cutout
from ccdm_tpu_torch.training.dmd import _grads, stats_of
from ccdm_tpu_torch.training.hyperparams import compute_vicinal_hyperparams
from ccdm_tpu_torch.training.optim import step_generator
from ccdm_tpu_torch.training.state import AdamState, adam_init, adam_update
from ccdm_tpu_torch.training.trainer import chunk_seed, copy_tensors
from ccdm_tpu_torch.training.vicinity import (
    gumbel,
    masked_uniform_choice,
    sample_target_labels,
    select_vicinity_indices,
)
from ccdm_tpu_torch.utils.ckpt import load_checkpoint, save_checkpoint
from ccdm_tpu_torch.utils.logging import TrainLogger
from ccdm_tpu_torch.utils.viz import save_image_grid

ADAM_BETAS = (0.5, 0.999)
SAMPLE_KEY = 9  # sample_given_labels' key base (JAX: fold_in(PRNGKey(9), done))


def jigsaw_k(x: torch.Tensor, perm: torch.Tensor, k: int = 2) -> torch.Tensor:
    """Shuffle a k x k grid of patches of each image (NCHW): patch i of the
    output (row-major) is patch perm[b, i] of the input."""
    b, c, h, w = x.shape
    ph, pw = h // k, w // k
    patches = x.reshape(b, c, k, ph, k, pw).permute(0, 2, 4, 1, 3, 5).reshape(
        b, k * k, c, ph, pw)
    idx = perm.to(x.device).long()[:, :, None, None, None].expand(-1, -1, c, ph, pw)
    shuffled = torch.gather(patches, 1, idx)
    return shuffled.reshape(b, k, k, c, ph, pw).permute(0, 3, 1, 4, 2, 5).reshape(b, c, h, w)


def stitch(x: torch.Tensor, perm: torch.Tensor, k: int = 2) -> torch.Tensor:
    """The top h // k rows of each image over the rest of image perm[b]'s."""
    h = x.shape[2]
    other = x[perm.to(x.device).long()]
    return torch.cat([x[:, :, : h // k], other[:, :, h // k:]], dim=2)


@dataclasses.dataclass
class CcGANConfig:
    data_name: str = "synthetic"
    niters: int = 40000
    batch_size_disc: int = 64
    batch_size_gene: int = 64
    num_D_steps: int = 2
    lr_g: float = 1e-4
    lr_d: float = 1e-4
    dim_gan: int = 256
    threshold_type: str = "hard"  # hard | soft
    kappa: Optional[float] = None
    kernel_sigma: Optional[float] = None
    nonzero_soft_weight_threshold: float = 1e-3
    loss_type: str = "hinge"  # hinge | vanilla
    use_DiffAugment: bool = False
    policy: str = "color,translation,cutout"
    # Dual-NDA mixing weights
    nda_a: float = 1.0
    nda_b: float = 0.0
    nda_c: float = 0.0
    nda_d: float = 0.0
    nda_e: float = 0.0
    nda_start_iter: int = 0
    save_niters_freq: int = 2000
    visualize_freq: int = 2000
    results_folder: str = "./ccgan_results"
    log_every: int = 20
    seed: int = 31  # base of the per-iteration generators (--seed)


class CcGANTrainer:
    def __init__(self, netG: nn.Module, netD: nn.Module, train_images: np.ndarray,
                 train_labels: np.ndarray, fn_y2h: Callable, config: CcGANConfig,
                 badfake_niqe: Optional[tuple] = None, badfake_mae: Optional[tuple] = None,
                 device=None, mesh=None):
        """netG, netD: models/sngan.py or models/sagan.py nets on `device`;
        train_images uint8 [N, H, W, C]; train_labels [N] in [0, 1];
        badfake_*: (uint8 images [M, H, W, C], labels) for nda_d / nda_e."""
        cfg = self.cfg = config
        self.device = torch.device(device) if device is not None else \
            next(netG.parameters()).device
        self.netG, self.netD, self.fn_y2h = netG, netD, fn_y2h
        labels2d = np.asarray(train_labels, np.float32).reshape(len(train_labels), -1)
        self.vic_type = "hv" if cfg.threshold_type == "hard" else "sv"
        self.kernel_sigma, self.kappa = compute_vicinal_hyperparams(
            labels2d, self.vic_type, kernel_sigma=cfg.kernel_sigma, kappa=cfg.kappa)
        dev = self.device
        self.train_images = torch.from_numpy(np.asarray(train_images)).to(dev)
        self.train_labels = torch.from_numpy(labels2d).to(dev)
        self.unique_labels = torch.from_numpy(np.unique(labels2d, axis=0)).to(dev)
        bank = lambda bf: None if bf is None else torch.from_numpy(np.asarray(bf[0])).to(dev)
        self.badfake_niqe, self.badfake_mae = bank(badfake_niqe), bank(badfake_mae)

        self.mesh = mesh if mesh is not None else create_mesh()
        replicated(self.mesh, netG), replicated(self.mesh, netD)
        self.step = 0
        self.g_params, self.d_params = list(netG.parameters()), list(netD.parameters())
        self.g_opt: AdamState = adam_init(self.g_params)
        self.d_opt: AdamState = adam_init(self.d_params)
        os.makedirs(cfg.results_folder, exist_ok=True)

    # ------------------------------------------------------------ helpers

    def fake_label_radius(self) -> float:
        cfg = self.cfg
        if cfg.threshold_type == "hard":
            return float(self.kappa)
        return float(np.sqrt(-np.log(cfg.nonzero_soft_weight_threshold)) * self.kappa)

    def _weights(self, labels: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        if self.cfg.threshold_type == "hard":
            return torch.ones(labels.shape[0], device=self.device)
        return soft_weights_from_targets(labels, targets, self.kappa)

    def _neg_loss(self, d_out: torch.Tensor) -> torch.Tensor:
        if self.cfg.loss_type == "vanilla":
            return -torch.log(1.0 - torch.sigmoid(d_out) + 1e-20)
        return F.relu(1.0 + d_out)

    def _pos_loss(self, d_out: torch.Tensor) -> torch.Tensor:
        if self.cfg.loss_type == "vanilla":
            return -torch.log(torch.sigmoid(d_out) + 1e-20)
        return F.relu(1.0 - d_out)

    def _aug(self, x: torch.Tensor, gen, draws) -> torch.Tensor:
        if not self.cfg.use_DiffAugment:
            return x
        return diff_augment(x, self.cfg.policy, gen, draws)

    def _randint(self, value, hi: int, shape, gen) -> torch.Tensor:
        if value is None:
            value = torch.randint(0, hi, shape, generator=gen, device=self.device)
        return value.to(self.device, torch.long)

    def _z(self, b: int, gen, draws: dict) -> torch.Tensor:
        z = draws.get("z")
        if z is None:
            z = torch.randn(b, self.cfg.dim_gan, generator=gen, device=self.device)
        return z.to(self.device)

    def _nchw(self, images_u8: torch.Tensor) -> torch.Tensor:
        return normalize_images(images_u8, to_neg_one_to_one=True).permute(0, 3, 1, 2)

    def _gumbel(self, value, shape, gen) -> torch.Tensor:
        return gumbel(shape, gen, self.device) if value is None else value.to(self.device)

    # ------------------------------------------------------------- draws

    def draw_common(self, gen, draws: dict):
        """(targets [B, 1], real [B, C, H, W] in [-1, 1], real labels, fake
        labels [B, 1]) of one D step."""
        cfg = self.cfg
        b = cfg.batch_size_disc
        targets = sample_target_labels(self.unique_labels, b, self.kernel_sigma, gen,
                                       draws.get("target_idx"), draws.get("target_eps"))
        idx = select_vicinity_indices(
            targets, self.train_labels, self.kappa, self.vic_type,
            nonzero_soft_weight_threshold=cfg.nonzero_soft_weight_threshold, gen=gen,
            gumbel_noise=draws.get("gumbel"))
        real = augment_for_dataset(cfg.data_name, self.train_images[idx], gen,
                                   draws.get("data_aug"))
        radius = self.fake_label_radius()
        lb = torch.clamp(targets - radius, 0.0, 1.0)
        ub = torch.clamp(targets + radius, 0.0, 1.0)
        u = draws.get("fake_u")
        if u is None:
            u = torch.rand(targets.shape, generator=gen, device=self.device)
        return targets, self._nchw(real), self.train_labels[idx], lb + u.to(self.device) * (ub - lb)

    def _corrupted(self, real: torch.Tensor, gen, draws: dict) -> torch.Tensor:
        """Dual-NDA b: a jigsaw, a stitch or a cutout of the real batch."""
        b = real.shape[0]
        pick = int(self._randint(draws.get("pick"), 3, (), gen))
        if pick == 0:
            perm = draws.get("perm")
            if perm is None:
                perm = torch.argsort(torch.rand(b, 4, generator=gen, device=self.device), dim=1)
            return jigsaw_k(real, perm, 2)
        if pick == 1:
            perm = draws.get("stitch")
            if perm is None:
                perm = torch.randperm(b, generator=gen, device=self.device)
            return stitch(real, perm, 2)
        return rand_cutout(real, gen, draws.get("cutout"))

    # -------------------------------------------------------------- steps

    def d_step(self, use_nda: bool, gen: Optional[torch.Generator] = None,
               draws: Optional[dict] = None) -> torch.Tensor:
        """One D step (with the Dual-NDA terms when `use_nda`); returns the
        loss on the device."""
        cfg, draws = self.cfg, draws or {}
        b = cfg.batch_size_disc
        mesh = self.mesh.over(b)
        targets, real, real_labels, fake_labels = self.draw_common(gen, draws)
        target_emb = self.fn_y2h(targets)
        z = self._z(b, gen, draws)
        with torch.no_grad():  # netG in train mode: its statistics move here too
            fake = sharded_apply(mesh, self.netG, z, self.fn_y2h(fake_labels), train=True)
        w_real = self._weights(real_labels, targets)
        w_fake = self._weights(fake_labels, targets)

        def score(x, aug_draws) -> torch.Tensor:  # netD in train mode: its u moves
            return sharded_apply(mesh, self.netD, self._aug(x, gen, aug_draws), target_emb,
                                 train=True)

        loss = (torch.mean(w_real * self._pos_loss(score(real, draws.get("aug_real"))))
                + cfg.nda_a * torch.mean(
                    w_fake * self._neg_loss(score(fake, draws.get("aug_fake")))))
        if use_nda and cfg.nda_b > 0:
            nda = draws.get("nda_b", {})
            corrupted = self._corrupted(real, gen, nda)
            loss = loss + cfg.nda_b * torch.mean(self._neg_loss(score(corrupted,
                                                                      nda.get("aug"))))
        if use_nda and cfg.nda_c > 0:  # Type II: reals with labels OUTSIDE the vicinity
            nda = draws.get("nda_c", {})
            mask_out = pairwise_distance(targets, self.train_labels) > self.kappa
            idx_w = masked_uniform_choice(mask_out,
                                          self._gumbel(nda.get("gumbel"), mask_out.shape, gen))
            wrong = self._nchw(self.train_images[idx_w])
            loss = loss + cfg.nda_c * torch.mean(self._neg_loss(score(wrong, nda.get("aug"))))
        for what, weight, bank in (("nda_d", cfg.nda_d, self.badfake_niqe),
                                   ("nda_e", cfg.nda_e, self.badfake_mae)):
            if use_nda and weight > 0 and bank is not None:  # Type I: bad fakes
                nda = draws.get(what, {})
                idx_bf = self._randint(nda.get("idx"), bank.shape[0], (b,), gen)
                bf = self._nchw(bank[idx_bf])
                loss = loss + weight * torch.mean(self._neg_loss(score(bf, nda.get("aug"))))
        grads = all_reduce_grads(mesh, _grads(loss, self.d_params))
        adam_update(self.d_opt, grads, cfg.lr_d, *ADAM_BETAS,
                    params=[p.data for p in self.d_params])
        return loss.detach()

    def g_step(self, gen: Optional[torch.Generator] = None,
               draws: Optional[dict] = None) -> torch.Tensor:
        """One G step through the eval-mode D; returns the loss."""
        cfg, draws = self.cfg, draws or {}
        b = cfg.batch_size_gene
        mesh = self.mesh.over(b)
        targets = sample_target_labels(self.unique_labels, b, self.kernel_sigma, gen,
                                       draws.get("target_idx"), draws.get("target_eps"))
        emb = self.fn_y2h(targets)
        fake = sharded_apply(mesh, self.netG, self._z(b, gen, draws), emb, train=True)
        d_out = sharded_apply(mesh, self.netD, self._aug(fake, gen, draws.get("aug")), emb,
                              train=False)
        if cfg.loss_type == "vanilla":
            loss = -torch.mean(torch.log(torch.sigmoid(d_out) + 1e-20))
        else:
            loss = -torch.mean(d_out)
        grads = all_reduce_grads(mesh, _grads(loss, self.g_params))
        adam_update(self.g_opt, grads, cfg.lr_g, *ADAM_BETAS,
                    params=[p.data for p in self.g_params])
        return loss.detach()

    # -------------------------------------------------------------- train

    def uses_nda(self, step: int) -> bool:
        cfg = self.cfg
        return step >= cfg.nda_start_iter and (cfg.nda_b > 0 or cfg.nda_c > 0
                                               or cfg.nda_d > 0 or cfg.nda_e > 0)

    def train(self, progress: bool = True) -> None:
        """From self.step to niters: num_D_steps D steps and a G step an
        iteration, a log line at iteration 1 and every log_every, an
        eval-mode grid every visualize_freq, a milestone every
        save_niters_freq."""
        cfg = self.cfg
        main = self.mesh.is_main
        logger = TrainLogger(cfg.results_folder, cfg.niters) if main else None
        while self.step < cfg.niters:
            gen = step_generator(cfg.seed, self.step, self.device)
            use_nda = self.uses_nda(self.step)
            for _ in range(cfg.num_D_steps):
                d_loss = self.d_step(use_nda, gen)
            g_loss = self.g_step(gen)
            self.step += 1
            step = self.step
            if main and (step % cfg.log_every == 0 or step == 1):
                logger.log_scalars({"step": step, "d_loss": float(d_loss),
                                    "g_loss": float(g_loss)})
                if progress:
                    print(f"ccgan step {step}/{cfg.niters} d={float(d_loss):.4f} "
                          f"g={float(g_loss):.4f}", flush=True)
            if main and step % cfg.visualize_freq == 0:
                self._dump_visual_grid(step)
            if step % cfg.save_niters_freq == 0:
                self.save(step)

    def _dump_visual_grid(self, step: int) -> None:
        """The eval-mode grid of 6 quantile-spaced labels x 6 latents: it
        watches the path the per-label sampling takes."""
        uniq = np.unique(self.unique_labels.cpu().numpy().reshape(-1))
        y_visual = np.repeat(np.quantile(uniq, np.linspace(0.05, 0.95, 6)), 6).astype(np.float32)
        imgs, _ = self.sample_given_labels(y_visual, batch_size=len(y_visual), denorm=False)
        save_image_grid(np.clip(imgs * 0.5 + 0.5, 0.0, 1.0),
                        os.path.join(self.cfg.results_folder, f"sample_{step}.png"), nrow=6)

    # ----------------------------------------------------------- sampling

    @torch.no_grad()
    def sample_given_labels(self, given_labels: np.ndarray, batch_size: int = 500,
                            denorm: bool = True):
        """netG(z, y2h(y)) in eval mode for labels in [0, 1], in chunks of
        batch_size, the last padded with its last label; chunk `done` draws
        z from a generator seeded from (9, done). Returns (images [n, H, W,
        C] numpy, uint8 with denorm, else f32 in [-1, 1], given_labels)."""
        labels = np.asarray(given_labels, np.float32).reshape(-1)
        n = len(labels)
        batch_size = min(batch_size, n)
        out, done = [], 0
        while done < n:
            chunk = labels[done:done + batch_size]
            pad = batch_size - len(chunk)
            if pad:
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad)])
            gen = torch.Generator(device=self.device).manual_seed(chunk_seed(SAMPLE_KEY, done))
            z = torch.randn(batch_size, self.cfg.dim_gan, generator=gen, device=self.device)
            y = torch.from_numpy(chunk).to(self.device)[:, None]
            imgs = self.netG(z, self.fn_y2h(y), train=False).permute(0, 2, 3, 1)
            imgs = imgs[:batch_size - pad]
            if denorm:
                imgs = to_uint8(torch.clamp(imgs, -1.0, 1.0) * 0.5 + 0.5)
            out.append(imgs.cpu().numpy())
            done += batch_size
        return np.concatenate(out, axis=0)[:n], given_labels

    # --------------------------------------------------------- checkpoints

    def checkpoint_tree(self) -> dict:
        """The trainer's state in JAX's CcGANTrainer.state layout, tensors
        copied to the CPU."""
        cpu = lambda ts: [t.detach().cpu().clone() for t in ts]
        opt = lambda o: {"mu": cpu(o.mu), "nu": cpu(o.nu), "count": o.count}
        return {"step": self.step, "g_params": cpu(self.g_params),
                "g_stats": cpu(stats_of(self.netG)), "d_params": cpu(self.d_params),
                "d_stats": cpu(stats_of(self.netD)), "g_opt": opt(self.g_opt),
                "d_opt": opt(self.d_opt)}

    def save(self, milestone) -> str:
        """Rank 0 writes the milestone (JAX ccgan.py:421), then the ranks meet."""
        path = save_checkpoint(self.cfg.results_folder, f"ccgan-{milestone}",
                               self.checkpoint_tree()) if self.mesh.is_main else ""
        barrier(self.mesh)
        return path

    def load(self, milestone) -> None:
        self.load_tree(load_checkpoint(self.cfg.results_folder, f"ccgan-{milestone}"))

    @torch.no_grad()
    def load_tree(self, tree: dict) -> None:
        """Copy a checkpoint tree into the trainer in place; raises on a tree
        that does not fit its nets."""
        for what, dst, src in (("G params", self.g_params, tree["g_params"]),
                               ("G stats", stats_of(self.netG), tree["g_stats"]),
                               ("D params", self.d_params, tree["d_params"]),
                               ("D stats", stats_of(self.netD), tree["d_stats"])):
            copy_tensors([t.data for t in dst], src, what)
        for opt, key in ((self.g_opt, "g_opt"), (self.d_opt, "d_opt")):
            copy_tensors(opt.mu, tree[key]["mu"], f"{key} mu")
            copy_tensors(opt.nu, tree[key]["nu"], f"{key} nu")
            opt.count = int(tree[key]["count"])
        self.step = int(tree["step"])
