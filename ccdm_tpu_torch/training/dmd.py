"""DMD2-M one-step distillation trainer (ccdm_tpu/training/dmd.py).

Distils a trained CCDM teacher (a pred_x0 Unet) into a one-step GAN
generator with three losses:
- distribution matching (dmd.py:503-551): at t ~ U[0.02 T, min(0.98 T + 1,
  T)), the score difference (x - teacher(x_t)) - (x - fake_unet(x_t))
  divided by the per-sample mean |x - teacher(x_t)|, through nan_to_num,
  applied as 0.5 mse(x, stop_grad(x - grad));
- the generator's adversarial loss (dmd.py:591-629): netD on q_sample'd
  (with gan_DiffAugment, DiffAugment'ed) fakes; hinge or vanilla;
- the fake UNet's denoising loss (dmd.py:554-588): mse(fake_unet(x_t), x)
  times SNR[t] of the pred_x0 schedule, divided by H(y) with use_Hy.

Two optimizers, each optax's chain(clip_by_global_norm(max_grad_norm),
adamw(lr, 0.9, 0.999, weight decay 0.01 on every leaf)): the generator's
over netG, the guidance one over netD and the fake UNet together (one
global norm over both), stepped num_D_steps times per G step.

Which net runs in which mode, as the JAX trainer runs them:
- the teacher and the fake UNet always in eval mode (train=False: their
  conditioning BatchNorm on its running statistics, which never move),
  even while the fake UNet's parameters train; in the G step both run
  without a gradient (x_t comes from the detached fakes and the fake UNet
  is not differentiated there);
- netG in train mode in both steps: its BatchNorm statistics (and, for
  SAGAN, its spectral norms' u) move in the G step and again in each D
  step, where it draws the fakes without a gradient;
- netD in eval mode in the G step (its u not stored) and in train mode
  twice in each D step, on the real batch and then on the fakes.
Images are NCHW in [-1, 1]; the Unets take and return NHWC views.

Each step is a function of its draws. `g_step(gen, draws)` and
`d_step(gen, draws)` draw what `draws` does not hold from `gen`:
- g_step: "target_idx" (and "target_eps" with a vicinity), "z", "dm"
  {"t", "noise"}, "adv" {"t", "noise", "aug"};
- d_step: "target_idx", "target_eps", "fake_u" (the uniform of the fake
  labels), "real" {"idx" at kappa 0, else "gumbel" [B, N]; and the
  dataset's augmentation draws "hflip", "vflip", "rot90"}, "z",
  "adv_real" and "adv_fake" {"t", "noise", "aug"}, "dn" {"t", "noise"};
"aug" holds DiffAugment's draws (training/diffaugment.py). `train` gives
step s the generator training/optim.step_generator(seed, s).

With a data-parallel `mesh` (parallel/mesh.py; by default the process
group's) every rank draws a step at the global batch, runs each net on its
own rows (`sharded_apply`) and sums the gradients over the ranks before the
clip; milestones, logs and grids are written by rank 0.

The trainer's state is its modules (the netG, netD and fake UNet weights
and statistics), two AdamStates and `step`; a milestone
<results_folder>/model-dmd-<N>/state.pt holds `checkpoint_tree`, the
layout of JAX's DMD2Trainer.state with lists of tensors (parameters in
parameters() order, statistics in buffers() order), which
utils/convert.dmd_state_from_jax also writes.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ccdm_tpu_torch.diffusion.gaussian import hy_from_y2cov
from ccdm_tpu_torch.ops.image import augment_for_dataset, normalize_images, to_uint8
from ccdm_tpu_torch.ops.schedule import make_schedule, q_sample
from ccdm_tpu_torch.parallel.mesh import (
    all_reduce_grads,
    barrier,
    create_mesh,
    replicated,
    sharded_apply,
)
from ccdm_tpu_torch.training.diffaugment import diff_augment
from ccdm_tpu_torch.training.hyperparams import compute_vicinal_hyperparams
from ccdm_tpu_torch.training.optim import step_generator
from ccdm_tpu_torch.training.state import AdamState, adam_init, adam_update, clip_by_global_norm
from ccdm_tpu_torch.training.trainer import chunk_seed, copy_tensors
from ccdm_tpu_torch.training.vicinity import sample_target_labels, select_vicinity_indices
from ccdm_tpu_torch.utils.ckpt import load_checkpoint, save_checkpoint
from ccdm_tpu_torch.utils.logging import TrainLogger
from ccdm_tpu_torch.utils.viz import save_image_grid

ADAM_BETAS = (0.9, 0.999)
WEIGHT_DECAY = 0.01
SAMPLE_KEY = 7  # sample_given_labels' key base (JAX: fold_in(PRNGKey(7), done))


@dataclasses.dataclass
class DMDConfig:
    data_name: str = "synthetic"
    train_batch_size: int = 16
    niters: int = 50000
    train_lr_generator: float = 1e-4
    train_lr_guidance: float = 1e-4
    max_grad_norm: float = 1.0
    num_D_steps: int = 2
    weight_generator_adv: float = 1.0  # wG
    weight_guidance_adv: float = 10.0  # wD
    adv_loss_type: str = "hinge"  # hinge | vanilla
    gan_DiffAugment: bool = True
    gan_DiffAugment_policy: str = "color,translation,cutout"
    min_step_percent: float = 0.02
    max_step_percent: float = 0.98
    train_timesteps: int = 1000
    beta_schedule: str = "cosine"
    use_Hy: bool = False
    hy_max_log: float = 4.0  # cap on the y2cov log-scale; <= 0 disables
    kappa: Optional[float] = None  # the radius; None resolves it, 0 disables the vicinity
    kernel_sigma: Optional[float] = None
    z_dim: int = 256
    sample_every: int = 1000
    save_every: int = 5000
    results_folder: str = "./dmd_results"
    log_every: int = 250
    seed: int = 42  # base of the per-step generators (--seed)


def _grads(loss: torch.Tensor, params: list) -> list[torch.Tensor]:
    """d loss / d params, zero for a parameter the loss does not reach (the
    fake UNet's null embedding, the condition being always kept): JAX's
    gradient there, which the optimizer still decays."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]


def stats_of(model: nn.Module) -> list[torch.Tensor]:
    """A module's statistics: its floating-point buffers (BatchNorm running
    statistics, spectral-norm u and sigma), in buffers() order."""
    return [b for b in model.buffers() if b.is_floating_point()]


class DMD2Trainer:
    def __init__(self, teacher: nn.Module, fake_unet: nn.Module, netG: nn.Module,
                 netD: nn.Module, train_images: np.ndarray, train_labels: np.ndarray,
                 fn_y2h: Callable, config: DMDConfig, fn_y2cov: Optional[Callable] = None,
                 device=None, mesh=None):
        """teacher, fake_unet: Unets of one config on `device` (the fake UNet
        trainable, a copy of the teacher); netG, netD: models/sngan.py or
        models/sagan.py nets; train_images uint8 [N, H, W, C]; train_labels
        [N] or [N, 1] in [0, 1]."""
        cfg = self.cfg = config
        self.device = torch.device(device) if device is not None else \
            next(teacher.parameters()).device
        self.teacher = teacher.eval().requires_grad_(False)
        self.fake_unet, self.netG, self.netD = fake_unet.eval(), netG, netD
        self.fn_y2h, self.fn_y2cov = fn_y2h, fn_y2cov
        if cfg.use_Hy and fn_y2cov is None:
            raise ValueError("use_Hy needs fn_y2cov")

        self.image_shape = train_images.shape[1:]  # H, W, C
        labels2d = np.asarray(train_labels, np.float32).reshape(len(train_labels), -1)
        if cfg.kappa is None or (cfg.kappa <= 0 and cfg.kappa != 0):
            self.kernel_sigma, self.kappa = compute_vicinal_hyperparams(
                labels2d, "hv", kernel_sigma=cfg.kernel_sigma, kappa=cfg.kappa)
        else:
            self.kappa = float(cfg.kappa)
            self.kernel_sigma = (cfg.kernel_sigma if cfg.kernel_sigma and cfg.kernel_sigma > 0
                                 else compute_vicinal_hyperparams(labels2d, "hv", kappa=1.0)[0])
        dev = self.device
        self.train_images = torch.from_numpy(np.asarray(train_images)).to(dev)
        self.train_labels = torch.from_numpy(labels2d).to(dev)
        self.unique_labels = torch.from_numpy(np.unique(labels2d, axis=0)).to(dev)

        self.schedule = make_schedule(cfg.train_timesteps, cfg.beta_schedule, "pred_x0",
                                      device=dev)
        self.min_step = int(cfg.min_step_percent * cfg.train_timesteps)
        self.max_step = int(cfg.max_step_percent * cfg.train_timesteps)

        self.mesh = mesh if mesh is not None else create_mesh()
        for net in (teacher, fake_unet, netG, netD):
            replicated(self.mesh, net)
        self._mesh = self.mesh.over(cfg.train_batch_size)  # the steps' mesh
        self.step = 0
        self.gen_params = list(netG.parameters())
        self.gui_params = list(netD.parameters()) + list(fake_unet.parameters())
        self.gen_opt: AdamState = adam_init(self.gen_params)
        self.gui_opt: AdamState = adam_init(self.gui_params)
        os.makedirs(cfg.results_folder, exist_ok=True)

    # ----------------------------------------------------------- helpers

    def _hy(self, labels: torch.Tensor) -> torch.Tensor:
        """H(y) [B, C, H, W] of labels [B, 1]."""
        h, w, c = self.image_shape
        return hy_from_y2cov(self.fn_y2cov(labels), self.cfg.hy_max_log).reshape(-1, c, h, w)

    def _noise_like(self, labels, shape, noise, gen) -> torch.Tensor:
        if noise is None:
            noise = torch.randn(shape, generator=gen, device=self.device)
        noise = noise.to(self.device)
        if self.cfg.use_Hy:
            noise = noise * torch.sqrt(self._hy(labels))
        return noise

    def _t(self, t, lo: int, hi: int, b: int, gen) -> torch.Tensor:
        if t is None:
            t = torch.randint(lo, hi, (b,), generator=gen, device=self.device)
        return t.to(self.device, torch.long)

    def _unet(self, model: nn.Module, x: torch.Tensor, t: torch.Tensor,
              labels: torch.Tensor) -> torch.Tensor:
        """The denoiser in eval mode with the condition kept, NCHW in and out."""
        out = sharded_apply(self._mesh, model, x.permute(0, 2, 3, 1), t, self.fn_y2h(labels),
                            train=False)
        return out.permute(0, 3, 1, 2)

    def _d_out(self, images, labels, train: bool, gen, draws: dict) -> torch.Tensor:
        """netD on q_sample'd (DiffAugment'ed) images (dmd.py:591-612)."""
        cfg = self.cfg
        b = images.shape[0]
        t = self._t(draws.get("t"), 0, cfg.train_timesteps, b, gen)
        noise = self._noise_like(labels, images.shape, draws.get("noise"), gen)
        if cfg.gan_DiffAugment:
            images = diff_augment(images, cfg.gan_DiffAugment_policy, gen, draws.get("aug"))
        noisy = q_sample(self.schedule, images, t, noise)
        return sharded_apply(self._mesh, self.netD, noisy, self.fn_y2h(labels), train=train)

    # -------------------------------------------------------- loss pieces

    def _dm_loss(self, images, labels, gen, draws: dict) -> torch.Tensor:
        """Distribution matching (dmd.py:503-551): the gradient reaches only
        `images`, through the dreamfusion target."""
        cfg = self.cfg
        b = images.shape[0]
        t = self._t(draws.get("t"), self.min_step, min(self.max_step + 1, cfg.train_timesteps),
                    b, gen)
        with torch.no_grad():
            x = images.detach()
            noise = self._noise_like(labels, x.shape, draws.get("noise"), gen)
            noisy = q_sample(self.schedule, x, t, noise)
            p_real = x - self._unet(self.teacher, noisy, t, labels)
            p_fake = x - self._unet(self.fake_unet, noisy, t, labels)
            weight = p_real.abs().mean(dim=(1, 2, 3), keepdim=True)
            grad = torch.nan_to_num((p_real - p_fake) / (weight + 1e-8))
            target = x - grad
        return 0.5 * torch.mean((images - target) ** 2)

    def _denoising_loss(self, images, labels, gen, draws: dict) -> torch.Tensor:
        """The fake UNet's SNR-weighted denoising loss (dmd.py:554-588)."""
        cfg = self.cfg
        images = images.detach()
        b = images.shape[0]
        t = self._t(draws.get("t"), 0, cfg.train_timesteps, b, gen)
        noise = self._noise_like(labels, images.shape, draws.get("noise"), gen)
        noisy = q_sample(self.schedule, images, t, noise)
        sq = (self._unet(self.fake_unet, noisy, t, labels) - images) ** 2
        if cfg.use_Hy:
            sq = sq / self._hy(labels)
        return torch.mean(sq.reshape(b, -1).mean(dim=1) * self.schedule.snr[t])

    def _adv_g(self, d_out: torch.Tensor) -> torch.Tensor:
        if self.cfg.adv_loss_type == "vanilla":
            return -torch.mean(torch.log(torch.sigmoid(d_out) + 1e-20))
        return -torch.mean(d_out)  # hinge

    def _adv_d(self, d_real: torch.Tensor, d_fake: torch.Tensor) -> torch.Tensor:
        if self.cfg.adv_loss_type == "vanilla":
            return (-torch.mean(torch.log(torch.sigmoid(d_real) + 1e-20))
                    - torch.mean(torch.log(1 - torch.sigmoid(d_fake) + 1e-20)))
        return torch.mean(F.relu(1.0 - d_real)) + torch.mean(F.relu(1.0 + d_fake))

    # --------------------------------------------------------- batch draws

    def _draw_target_labels(self, gen, draws: dict) -> torch.Tensor:
        """[B, 1] targets: uniform train labels at kappa 0, else a unique
        label plus N(0, kernel_sigma)."""
        b = self.cfg.train_batch_size
        if self.kappa == 0:
            idx = self._t(draws.get("target_idx"), 0, self.train_labels.shape[0], b, gen)
            return self.train_labels[idx]
        return sample_target_labels(self.unique_labels, b, self.kernel_sigma, gen,
                                    draws.get("target_idx"), draws.get("target_eps"))

    def _draw_real_batch(self, targets, gen, draws: dict) -> torch.Tensor:
        """Real images [B, C, H, W] in [-1, 1] from the targets' vicinity."""
        cfg = self.cfg
        if self.kappa == 0:
            idx = self._t(draws.get("idx"), 0, self.train_labels.shape[0],
                          cfg.train_batch_size, gen)
        else:
            idx = select_vicinity_indices(targets, self.train_labels, self.kappa, "hv",
                                          gen=gen, gumbel_noise=draws.get("gumbel"))
        imgs = augment_for_dataset(cfg.data_name, self.train_images[idx], gen, draws)
        return normalize_images(imgs, to_neg_one_to_one=True).permute(0, 3, 1, 2)

    def _draw_fake_labels(self, targets, gen, draws: dict) -> torch.Tensor:
        """U[target - kappa, target + kappa] clipped to [0, 1] (dmd.py:806-813)."""
        if self.kappa == 0:
            return targets
        lb = torch.clamp(targets - self.kappa, 0.0, 1.0)
        ub = torch.clamp(targets + self.kappa, 0.0, 1.0)
        u = draws.get("fake_u")
        if u is None:
            u = torch.rand(targets.shape, generator=gen, device=self.device)
        return lb + u.to(self.device) * (ub - lb)

    def _z(self, gen, draws: dict) -> torch.Tensor:
        z = draws.get("z")
        if z is None:
            z = torch.randn(self.cfg.train_batch_size, self.cfg.z_dim, generator=gen,
                            device=self.device)
        return z.to(self.device)

    # ------------------------------------------------------------- steps

    def g_step(self, gen: Optional[torch.Generator] = None, draws: Optional[dict] = None):
        """One generator step; returns (loss, dm, adv) on the device."""
        cfg, draws = self.cfg, draws or {}
        targets = self._draw_target_labels(gen, draws)
        z = self._z(gen, draws)
        fake = sharded_apply(self._mesh, self.netG, z, self.fn_y2h(targets), train=True)
        dm = self._dm_loss(fake, targets, gen, draws.get("dm", {}))
        adv = self._adv_g(self._d_out(fake, targets, False, gen, draws.get("adv", {})))
        loss = dm + cfg.weight_generator_adv * adv
        grads = all_reduce_grads(self._mesh, _grads(loss, self.gen_params))
        adam_update(self.gen_opt, clip_by_global_norm(grads, cfg.max_grad_norm),
                    cfg.train_lr_generator, *ADAM_BETAS, weight_decay=WEIGHT_DECAY,
                    params=[p.data for p in self.gen_params])
        return loss.detach(), dm.detach(), adv.detach()

    def d_step(self, gen: Optional[torch.Generator] = None, draws: Optional[dict] = None):
        """One guidance step (netD and the fake UNet); returns (loss, dn, adv)."""
        cfg, draws = self.cfg, draws or {}
        targets = self._draw_target_labels(gen, draws)
        real = self._draw_real_batch(targets, gen, draws.get("real", {}))
        fake_labels = self._draw_fake_labels(targets, gen, draws)
        z = self._z(gen, draws)
        with torch.no_grad():  # netG in train mode: its statistics move here too
            fake = sharded_apply(self._mesh, self.netG, z, self.fn_y2h(fake_labels), train=True)
        d_real = self._d_out(real, targets, True, gen, draws.get("adv_real", {}))
        d_fake = self._d_out(fake, targets, True, gen, draws.get("adv_fake", {}))
        adv = self._adv_d(d_real, d_fake)
        dn = self._denoising_loss(fake, targets, gen, draws.get("dn", {}))
        loss = dn + cfg.weight_guidance_adv * adv
        grads = all_reduce_grads(self._mesh, _grads(loss, self.gui_params))
        adam_update(self.gui_opt, clip_by_global_norm(grads, cfg.max_grad_norm),
                    cfg.train_lr_guidance, *ADAM_BETAS, weight_decay=WEIGHT_DECAY,
                    params=[p.data for p in self.gui_params])
        return loss.detach(), dn.detach(), adv.detach()

    # -------------------------------------------------------------- train

    def train(self, progress: bool = True) -> None:
        """From self.step to niters: each step one G step and num_D_steps D
        steps, a log line every log_every steps (and at step 1), an
        eval-mode grid every sample_every, a milestone every save_every."""
        cfg = self.cfg
        main = self.mesh.is_main
        logger = TrainLogger(cfg.results_folder, cfg.niters) if main else None
        while self.step < cfg.niters:
            gen = step_generator(cfg.seed, self.step, self.device)
            g_loss, dm, g_adv = self.g_step(gen)
            d_losses = [self.d_step(gen)[0] for _ in range(cfg.num_D_steps)]
            self.step += 1
            step = self.step
            if main and (step % cfg.log_every == 0 or step == 1):
                d_loss = float(torch.stack(d_losses).mean()) if d_losses else float("nan")
                msg = {"step": step, "g_loss": float(g_loss), "dm_loss": float(dm),
                       "g_adv": float(g_adv), "d_loss": d_loss}
                logger.log_scalars(msg)
                logger.log_text(step, msg["g_loss"])
                if progress:
                    print(f"dmd step {step}/{cfg.niters} g={msg['g_loss']:.4f} d={d_loss:.4f}",
                          flush=True)
            if main and step % cfg.sample_every == 0:
                self._dump_visual_grid(step)
            if step % cfg.save_every == 0:
                self.save(step)

    def _dump_visual_grid(self, step: int) -> None:
        """The eval-mode grid of 6 quantile-spaced labels x 6 latents
        (dmd.py's y_visual PNG): it watches the path the per-label
        sampling takes."""
        uniq = np.unique(self.unique_labels.cpu().numpy().reshape(-1))
        y_visual = np.repeat(np.quantile(uniq, np.linspace(0.05, 0.95, 6)), 6).astype(np.float32)
        imgs, _ = self.sample_given_labels(y_visual, batch_size=len(y_visual), denorm=False)
        save_image_grid(np.clip(imgs, 0.0, 1.0),
                        os.path.join(self.cfg.results_folder, f"sample_{step}.png"), nrow=6)

    # ----------------------------------------------------------- sampling

    def generate(self, labels01: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """netG in eval mode: images [B, H, W, C] in [0, 1] (unclipped)."""
        return one_step(self.netG, self.fn_y2h, labels01, z.to(self.device))

    def sample_given_labels(self, given_labels: np.ndarray, batch_size: int,
                            denorm: bool = True):
        """One-step sampling of labels in [0, 1] (dmd.py:900-940) in chunks
        of batch_size, the last padded with its last label; chunk `done`
        draws z from a generator seeded from (7, done). Returns (images
        [n, H, W, C] numpy, uint8 with denorm, else f32 in [0, 1]
        unclipped, given_labels)."""
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
            z = torch.randn(batch_size, self.cfg.z_dim, generator=gen, device=self.device)
            imgs = self.generate(torch.from_numpy(chunk).to(self.device), z)
            imgs = imgs[:batch_size - pad]
            out.append((to_uint8(imgs) if denorm else imgs).cpu().numpy())
            done += batch_size
        return np.concatenate(out, axis=0)[:n], given_labels

    # --------------------------------------------------------- checkpoints

    def checkpoint_tree(self) -> dict:
        """The trainer's state in JAX's DMD2Trainer.state layout, tensors
        copied to the CPU."""
        cpu = lambda ts: [t.detach().cpu().clone() for t in ts]
        opt = lambda o: {"mu": cpu(o.mu), "nu": cpu(o.nu), "count": o.count}
        return {"step": self.step, "gen_params": cpu(self.netG.parameters()),
                "gen_stats": cpu(stats_of(self.netG)),
                "gui_params": {"netD": cpu(self.netD.parameters()),
                               "fake_unet": cpu(self.fake_unet.parameters())},
                "netD_stats": cpu(stats_of(self.netD)),
                "fake_unet_stats": cpu(stats_of(self.fake_unet)),
                "gen_opt": opt(self.gen_opt), "gui_opt": opt(self.gui_opt)}

    def save(self, milestone) -> str:
        """Rank 0 writes the milestone (JAX dmd.py:478), then the ranks meet."""
        path = save_checkpoint(self.cfg.results_folder, f"dmd-{milestone}",
                               self.checkpoint_tree()) if self.mesh.is_main else ""
        barrier(self.mesh)
        return path

    def load(self, milestone) -> None:
        self.load_tree(load_checkpoint(self.cfg.results_folder, f"dmd-{milestone}"))

    @torch.no_grad()
    def load_tree(self, tree: dict) -> None:
        """Copy a checkpoint tree into the trainer in place; raises on a tree
        that does not fit its nets."""
        load_generator(self.netG, tree)
        for what, dst, src in (
                ("netD params", list(self.netD.parameters()), tree["gui_params"]["netD"]),
                ("fake UNet params", list(self.fake_unet.parameters()),
                 tree["gui_params"]["fake_unet"]),
                ("netD stats", stats_of(self.netD), tree["netD_stats"]),
                ("fake UNet stats", stats_of(self.fake_unet), tree["fake_unet_stats"])):
            copy_tensors([t.data for t in dst], src, what)
        for opt, key in ((self.gen_opt, "gen_opt"), (self.gui_opt, "gui_opt")):
            copy_tensors(opt.mu, tree[key]["mu"], f"{key} mu")
            copy_tensors(opt.nu, tree[key]["nu"], f"{key} nu")
            opt.count = int(tree[key]["count"])
        self.step = int(tree["step"])


@torch.no_grad()
def one_step(netG: nn.Module, fn_y2h: Callable, labels01: torch.Tensor,
             z: torch.Tensor) -> torch.Tensor:
    """netG(z, y2h(labels)) in eval mode, (x + 1) / 2 as [B, H, W, C]
    (unclipped): the one-step sampling of dmd.py:900-940."""
    x = netG(z, fn_y2h(labels01.reshape(-1, 1)), train=False)
    return ((x + 1.0) * 0.5).permute(0, 2, 3, 1)


@torch.no_grad()
def load_generator(netG: nn.Module, tree: dict) -> nn.Module:
    """netG holding a DMD checkpoint tree's generator weights and statistics."""
    copy_tensors([p.data for p in netG.parameters()], tree["gen_params"], "generator params")
    copy_tensors(stats_of(netG), tree["gen_stats"], "generator stats")
    return netG
