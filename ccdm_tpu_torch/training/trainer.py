"""Diffusion trainer: vicinity batches, the vicinal loss, Adam and EMA.

Counterpart of ccdm_tpu/training/trainer.py. One train step
(trainer.py:253-340) runs `gradient_accumulate_every` micro-batches, each
drawing its vicinity batch (`_make_batch`, :172-251: target labels, vicinity
selection, image gather and augmentation, label embedding) and its loss
draws, averages their gradients and losses, clips the global norm, takes an
Adam step and updates the EMA. The training images stay on the device as
uint8. Step `s` of `train` draws from a torch.Generator seeded from
chunk_seed(seed, s), the counterpart of fold_in(PRNGKey(seed), s); the two streams
differ, so the tests hand the JAX draws in through `draws` (one dict per
micro-batch; keys of `_make_batch`: "target_idx", "target_eps", "gumbel",
"vecs", "tie", "idx", "hflip", "vflip", "rot90"; keys of the loss: "t",
"keep_mask", "noise", "proj").

With `aux_info` ({apply, lambda_aux, aux_start_step}, from main.py's
--lambda_aux) every loss adds the elastic aux term (trainer.py:111,
258-264): vicinity_radius defaults to kappa's first entry and current_step
is the step's own; the logged steps carry the term's mean as "aux".

With a data-parallel `mesh` (parallel/mesh.py; by default create_mesh(),
the process group's, as JAX's trainer builds its mesh over every device)
every rank draws the step at the global batch and runs the model on its
own rows (`GaussianDiffusion.loss(mesh=...)`); the gradients are summed over
the ranks before the clip, so Adam and the EMA move every rank's weights
alike. Milestones, logs and grids are written by rank 0, after which the
ranks meet at a barrier.

`sample_given_labels` (trainer.py:444-514) samples a list of labels with
the diffusion's model in chunks, by DDIM or the ancestral sampler, each
chunk's labels passed on for H(y) (trainer.py:433, 482, 487); each
chunk draws from its own generator seeded from (key_base, done), as the JAX
version uses fold_in(PRNGKey(key_base), done). With `y_visual` set, `train`
writes a grid sampled from the EMA weights by DDIM every `sample_every`
steps, as results_folder/sample_<step>.png (trainer.py:420-442).
"""

from __future__ import annotations

import copy
import dataclasses
import os
import time
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ccdm_tpu_torch.ops.image import augment_for_dataset, normalize_images, to_uint8
from ccdm_tpu_torch.ops.vicinal import (
    hard_weights_from_targets,
    pairwise_distance,
    soft_weights_from_targets,
)
from ccdm_tpu_torch.parallel.mesh import all_reduce_grads, barrier, create_mesh, replicated
from ccdm_tpu_torch.training.hyperparams import compute_vicinal_hyperparams
from ccdm_tpu_torch.training.state import (
    EmaConfig,
    TrainState,
    adam_update,
    clip_by_global_norm,
    create_train_state,
    ema_update,
    shadowed_tensors,
)
from ccdm_tpu_torch.training.vicinity import (
    sample_target_labels,
    select_vicinity_indices,
    select_vicinity_indices_sliced,
)
from ccdm_tpu_torch.utils.ckpt import load_checkpoint, save_checkpoint
from ccdm_tpu_torch.utils.logging import StepTimer, TrainLogger
from ccdm_tpu_torch.utils.viz import save_image_grid


@dataclasses.dataclass
class TrainerConfig:
    data_name: str = "synthetic"
    train_batch_size: int = 16
    gradient_accumulate_every: int = 1
    train_lr: float = 1e-4
    train_num_steps: int = 100000
    ema_update_after_step: int = 100
    ema_update_every: int = 10
    ema_decay: float = 0.995
    adam_betas: Tuple[float, float] = (0.9, 0.99)
    sample_every: int = 1000
    save_every: int = 1000
    results_folder: str = "./results"
    max_grad_norm: float = 1.0
    vicinity_type: str = "shv"  # shv | ssv | hv | sv | none
    kappa: Optional[float] = None
    kernel_sigma: Optional[float] = None
    nonzero_soft_weight_threshold: float = 1e-3
    vector_type: str = "gaussian"
    num_projections: int = 1
    distance: str = "l2"
    hyperparameter: str = "rule_of_thumb"
    percentile: float = 5.0
    condition_on_target: bool = False
    vicinal_mode: str = "batch"  # batch | target
    adaptive_slicing: bool = False
    y_visual: Optional[np.ndarray] = None  # labels in [0, 1] of the grid, 6 a row
    cond_scale_visual: float = 1.5
    sample_timesteps_visual: Optional[int] = None
    sample_precast_bf16: bool = False
    log_every: int = 500
    tb_log: bool = False  # --tb_log: TensorBoard event files under results/tb
    seed: int = 0


class Trainer:
    def __init__(self, diffusion, train_images: np.ndarray, train_labels: np.ndarray,
                 config: TrainerConfig, aux_info: Optional[dict] = None, mesh=None):
        """diffusion: a GaussianDiffusion whose model is on its device;
        train_images [N, H, W, C] uint8; train_labels [N] or [N, D] in [0, 1];
        mesh: a parallel.Mesh, by default the process group's."""
        cfg = config
        if train_images.dtype != np.uint8 or train_images.max() <= 1:
            raise ValueError("train_images must be raw uint8 (reference contract trainer.py:89)")
        labels2d = np.asarray(train_labels, dtype=np.float32)
        labels2d = labels2d[:, None] if labels2d.ndim == 1 else labels2d
        if labels2d.min() < 0 or labels2d.max() > 1.0:
            raise ValueError("labels must be normalized to [0,1] (reference contract "
                             "trainer.py:90)")
        if (cfg.train_batch_size * cfg.gradient_accumulate_every < 16
                and cfg.data_name != "synthetic"):
            raise ValueError("effective batch size must be >= 16 (reference contract "
                             "trainer.py:127-129)")
        self.diffusion = diffusion
        self.config = cfg
        self.device = diffusion.device
        self.label_dim = labels2d.shape[1]
        self.sigma_delta, self.kappa = compute_vicinal_hyperparams(
            labels2d, cfg.vicinity_type, cfg.hyperparameter, cfg.kernel_sigma, cfg.kappa,
            cfg.percentile, cfg.distance)
        self.train_images = torch.from_numpy(train_images).to(self.device)
        self.train_labels = torch.from_numpy(labels2d).to(self.device)
        self.unique_labels = torch.from_numpy(
            np.unique(labels2d, axis=0).astype(np.float32)).to(self.device)
        self.ema_cfg = EmaConfig(beta=cfg.ema_decay, update_after_step=cfg.ema_update_after_step,
                                 update_every=cfg.ema_update_every)
        self.mesh = mesh if mesh is not None else create_mesh()
        self.state: TrainState = create_train_state(replicated(self.mesh, diffusion.model))
        # the trainer's own copy; current_step is set at every step
        self.aux_info = None if aux_info is None else {
            "vicinity_radius": float(np.atleast_1d(np.asarray(self.kappa))[0]), **aux_info}
        self.last_aux = None  # the last step's mean aux term (a tensor, or 0.0 off pred_noise)

    # ------------------------------------------------------------ batching

    def _make_batch(self, fn_y2h: Callable, gen: Optional[torch.Generator] = None,
                    draws: Optional[dict] = None):
        """(images01, cond_labels, loss_labels, labels_emb, weights or None,
        kappa) for one micro-batch (trainer.py:172-251)."""
        cfg, dev = self.config, self.device
        draws = draws or {}
        b = cfg.train_batch_size
        labels_bank, uniq = self.train_labels, self.unique_labels
        if cfg.vicinity_type == "none":
            idx = draws.get("idx")
            if idx is None:
                idx = torch.randint(0, labels_bank.shape[0], (b,), generator=gen, device=dev)
            idx = idx.to(dev)
            targets, weights = labels_bank[idx], None
            kappa = self.kappa
        else:
            sigma, kappa = self.sigma_delta, self.kappa
            if cfg.adaptive_slicing:
                # per-batch rule of thumb (trainer.py:184-197): sigma from the
                # drawn base labels' std, kappa the least pairwise distance
                base_idx = draws.get("target_idx")
                if base_idx is None:
                    base_idx = torch.randint(0, uniq.shape[0], (b,), generator=gen, device=dev)
                base = uniq[base_idx.to(dev)]
                sigma = 1.06 * base.std(dim=0, unbiased=False) * (b ** (-1.0 / 5.0))
                d = pairwise_distance(base, base, cfg.distance) + torch.eye(b, device=dev) * 1e9
                kappa = torch.clamp(d.min(), min=1e-3)
                eps = draws.get("target_eps")
                if eps is None:
                    eps = torch.randn(base.shape, generator=gen, device=dev)
                targets = base + eps.to(dev) * sigma
            else:
                targets = sample_target_labels(uniq, b, sigma, gen, draws.get("target_idx"),
                                               draws.get("target_eps"))
            if cfg.vicinity_type in ("shv", "ssv"):
                idx = select_vicinity_indices_sliced(
                    targets, labels_bank, kappa, cfg.vector_type, cfg.num_projections,
                    gen=gen, vecs=draws.get("vecs"), tie=draws.get("tie"),
                    gumbel_noise=draws.get("gumbel"))
                weights = torch.ones(b, device=dev)
            else:
                idx = select_vicinity_indices(
                    targets, labels_bank, kappa, cfg.vicinity_type, cfg.distance,
                    cfg.nonzero_soft_weight_threshold, gen=gen, gumbel_noise=draws.get("gumbel"))
                if cfg.vicinal_mode == "target":
                    weigh = (hard_weights_from_targets if cfg.vicinity_type == "hv"
                             else soft_weights_from_targets)
                    weights = weigh(labels_bank[idx], targets, kappa, cfg.distance)
                else:
                    weights = torch.ones(b, device=dev)
        real_labels = labels_bank[idx]
        images = augment_for_dataset(cfg.data_name, self.train_images[idx], gen, draws)
        images01 = normalize_images(images)
        cond_labels = targets if cfg.condition_on_target else real_labels
        return images01, cond_labels, real_labels, fn_y2h(cond_labels), weights, kappa

    # ---------------------------------------------------------- train step

    def _micro_loss(self, fn_y2h: Callable, gen, draws, mesh):
        """The loss of one micro-batch, or (loss, aux term) with aux_info;
        the batch is drawn whole and the model runs on `mesh`'s rows."""
        cfg = self.config
        aux_info = self.aux_info
        images01, _, loss_labels, labels_emb, weights, kappa = self._make_batch(
            fn_y2h, gen, draws)
        if cfg.vicinal_mode == "target":
            return self.diffusion.weighted_loss(images01, loss_labels, labels_emb, weights,
                                                train=True, gen=gen, draws=draws,
                                                aux_info=aux_info, mesh=mesh)
        use_batch_weights = cfg.vicinity_type != "none"
        return self.diffusion.loss(images01, loss_labels, labels_emb,
                                   vicinal_weights=weights if use_batch_weights else None,
                                   kappa=kappa, train=True, gen=gen, draws=draws,
                                   aux_info=aux_info, mesh=mesh)

    def compute_grads(self, fn_y2h: Callable, gen: Optional[torch.Generator] = None,
                      draws: Optional[Sequence[dict]] = None):
        """(mean loss, gradients averaged over the micro-batches, in
        model.parameters() order). The BatchNorm running statistics move
        once per micro-batch, as the JAX step carries them. On a mesh the
        loss is the global batch's and the gradients are summed over the
        ranks (where the batch divides by the mesh size)."""
        acc = self.config.gradient_accumulate_every
        mesh = self.mesh.over(self.config.train_batch_size)
        model = self.state.model
        params = list(model.parameters())
        for p in params:
            p.grad = None
        total = torch.zeros((), device=self.device)
        aux_total = 0.0
        if self.aux_info is not None:
            self.aux_info["current_step"] = self.state.step
        for i in range(acc):
            loss = self._micro_loss(fn_y2h, gen, draws[i] if draws else None, mesh)
            if self.aux_info is not None:
                loss, aux = loss
                aux_total = aux_total + (aux.detach() if torch.is_tensor(aux) else aux)
            loss.backward()
            total = total + loss.detach()
        self.last_aux = aux_total / acc if self.aux_info is not None else None
        grads = [p.grad / acc if p.grad is not None else torch.zeros_like(p) for p in params]
        for p in params:
            p.grad = None
        return total / acc, all_reduce_grads(mesh, grads)

    def apply_gradients(self, grads: list) -> None:
        """Clip, Adam, step + 1, EMA (trainer.py:318-329)."""
        cfg = self.config
        grads = clip_by_global_norm(grads, cfg.max_grad_norm)
        adam_update(self.state, grads, cfg.train_lr, *cfg.adam_betas)
        self.state.step += 1
        ema_update(self.state, self.ema_cfg)

    def train_step(self, fn_y2h: Callable, gen: Optional[torch.Generator] = None,
                   draws: Optional[Sequence[dict]] = None) -> torch.Tensor:
        """One optimizer step; returns the mean loss (on the device)."""
        loss, grads = self.compute_grads(fn_y2h, gen, draws)
        self.apply_gradients(grads)
        return loss

    # ---------------------------------------------------------------- train

    def train(self, fn_y2h: Callable, progress: bool = True) -> None:
        """The training loop (trainer.py:342-420), from state.step to
        train_num_steps, logging every log_every steps and saving a
        milestone every save_every."""
        cfg = self.config
        main = self.mesh.is_main
        logger = TrainLogger(cfg.results_folder, cfg.train_num_steps, tb=cfg.tb_log) \
            if main else None
        timer = StepTimer()
        step = self.state.step
        window_t0, window_start = time.perf_counter(), step
        while step < cfg.train_num_steps:
            gen = torch.Generator(device=self.device).manual_seed(chunk_seed(cfg.seed, step))
            timer.start()
            loss = self.train_step(fn_y2h, gen)
            timer.stop()
            step += 1
            if main and (step % cfg.log_every == 0 or step == 1):
                loss_val = float(loss)  # waits for the device, once per window
                per_step = (time.perf_counter() - window_t0) / max(step - window_start, 1)
                eff_batch = cfg.train_batch_size * cfg.gradient_accumulate_every
                logger.log_text(step, loss_val)
                scalars = {"step": step, "loss": loss_val, "step_time_s": per_step,
                           "imgs_per_sec": eff_batch / per_step if per_step > 0 else 0.0}
                if self.last_aux is not None:
                    scalars["aux"] = float(self.last_aux)
                logger.log_scalars(scalars)
                if progress:
                    print(f"step {step}/{cfg.train_num_steps} loss {loss_val:.4f} "
                          f"({per_step * 1e3:.0f} ms)", flush=True)
                window_t0, window_start = time.perf_counter(), step
            if main and cfg.y_visual is not None and step % cfg.sample_every == 0:
                self._save_visual_grid(fn_y2h, step)
            if step % cfg.save_every == 0:
                self.save(step)

    def ema_diffusion(self):
        """The diffusion over the EMA weights; with sample_precast_bf16 over
        a copy of them with the weight tensors cast to bf16 (the EMA shadow
        itself stays f32)."""
        from ccdm_tpu_torch.diffusion.gaussian import GaussianDiffusion
        from ccdm_tpu_torch.training.state import precast_sampling_params

        model = self.state.ema_model
        if self.config.sample_precast_bf16:
            model = precast_sampling_params(copy.deepcopy(model))
        return GaussianDiffusion(model, self.diffusion.config, device=self.device,
                                 fn_y2cov=self.diffusion.fn_y2cov)

    def _save_visual_grid(self, fn_y2h: Callable, step: int) -> None:
        """DDIM from the EMA weights for the y_visual labels, drawn from a
        generator seeded with `step`, as results_folder/sample_<step>.png."""
        cfg = self.config
        y = torch.from_numpy(np.asarray(cfg.y_visual, np.float32).reshape(
            len(cfg.y_visual), -1)).to(self.device)
        imgs = self.ema_diffusion().ddim_sample(
            fn_y2h(y), cond_scale=cfg.cond_scale_visual,
            sampling_timesteps=cfg.sample_timesteps_visual,
            generator=torch.Generator(device=self.device).manual_seed(step), labels=y)
        save_image_grid(imgs.cpu().numpy(),
                        os.path.join(cfg.results_folder, f"sample_{step}.png"),
                        nrow=6)

    # --------------------------------------------------------- checkpoints

    def save(self, milestone) -> str:
        """Rank 0 writes the milestone (JAX trainer.py:519), then the ranks
        meet; the others return ""."""
        path = save_checkpoint(self.config.results_folder, milestone,
                               checkpoint_tree(self.state)) if self.mesh.is_main else ""
        barrier(self.mesh)
        return path

    def load(self, milestone) -> None:
        load_train_state(self.state, load_checkpoint(self.config.results_folder, milestone))


def checkpoint_tree(s: TrainState) -> dict:
    """The milestone tree of `s` (utils/ckpt.py), tensors copied to the CPU."""
    cpu = lambda ts: [t.detach().cpu().clone() for t in ts]
    n_params = len(list(s.model.parameters()))
    online, ema = shadowed_tensors(s.model), shadowed_tensors(s.ema_model)
    return {"step": s.step, "params": cpu(online[:n_params]),
            "batch_stats": cpu(online[n_params:]),
            "opt_state": {"mu": cpu(s.mu), "nu": cpu(s.nu), "count": s.count},
            "ema_step": s.ema_step, "ema_params": cpu(ema[:n_params]),
            "ema_batch_stats": cpu(ema[n_params:])}


@torch.no_grad()
def load_train_state(state: TrainState, tree: dict) -> None:
    """Copy a milestone's tree into `state` in place; raises on a tree that
    does not fit the model."""
    n_params = len(list(state.model.parameters()))
    for key, model, lo, hi in (("params", state.model, 0, n_params),
                               ("batch_stats", state.model, n_params, None),
                               ("ema_params", state.ema_model, 0, n_params),
                               ("ema_batch_stats", state.ema_model, n_params, None)):
        copy_tensors(shadowed_tensors(model)[lo:hi], tree[key], key)
    copy_tensors(state.mu, tree["opt_state"]["mu"], "mu")
    copy_tensors(state.nu, tree["opt_state"]["nu"], "nu")
    state.count = int(tree["opt_state"]["count"])
    state.step, state.ema_step = int(tree["step"]), int(tree["ema_step"])


@torch.no_grad()
def copy_tensors(dst: list, src: list, what: str) -> None:
    """Copy a milestone's tensors into `dst` in place; raises unless they fit."""
    if len(dst) != len(src) or any(d.shape != s.shape for d, s in zip(dst, src)):
        raise ValueError(f"the milestone's {what} do not fit the current model (it was "
                         "written by an incompatible model version)")
    for d, s in zip(dst, src):
        d.copy_(s)


def chunk_seed(key_base: int, done: int) -> int:
    """The seed of the chunk that starts at label `done`."""
    return (int(key_base) * 1_000_003 + int(done)) % (2 ** 63)


def sample_given_labels(diffusion, given_labels: np.ndarray, fn_y2h: Callable,
                        batch_size: int, denorm: bool = True, cond_scale: float = 6.0,
                        sample_timesteps: int = 1000, key_base: int = 1,
                        sampler: str = "ddim", ddim_eta: float = 0.0):
    """Labels in [0, 1] -> (images [n, H, W, C] numpy, given_labels), by
    `sampler` "ddim" (with `ddim_eta`) or "ddpm" (the ancestral loop over
    the first `sample_timesteps` steps of the schedule).

    The last chunk is padded by repeating its last label. Images are uint8
    with `denorm`, else f32 in [0, 1]. Raises FloatingPointError if the
    sampler produced a non-finite value."""
    if sampler not in ("ddim", "ddpm"):
        raise ValueError(f"sampler must be ddim or ddpm, got {sampler!r}")
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
        y = torch.from_numpy(chunk).to(device)
        emb = fn_y2h(y)
        gen = torch.Generator(device=device).manual_seed(chunk_seed(key_base, done))
        if sampler == "ddim":
            imgs = diffusion.ddim_sample(emb, cond_scale=cond_scale,
                                         sampling_timesteps=sample_timesteps,
                                         ddim_eta=ddim_eta, generator=gen, labels=y)
        else:
            imgs = diffusion.p_sample_loop(emb, cond_scale=cond_scale,
                                           sampling_timesteps=sample_timesteps, generator=gen,
                                           labels=y)
        imgs = imgs[:len(chunk) - pad]
        if not bool(torch.isfinite(imgs).all()):
            raise FloatingPointError("the sampler produced non-finite values")
        if denorm:
            imgs = to_uint8(imgs)
        out.append(imgs.cpu().numpy())
        done += batch_size
    return np.concatenate(out, axis=0)[:nfake], given_labels
