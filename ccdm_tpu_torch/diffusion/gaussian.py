"""Gaussian diffusion: the vicinal training loss and the guided samplers.

Counterpart of ccdm_tpu/diffusion/gaussian.py: DiffusionConfig, `loss`
(gaussian.py:139-256: q_sample, the per-objective target, SNR weighting and
the hard/soft, classic/sliced vicinal batch weights used as a gate),
`weighted_loss` (:258-312, per-sample weights applied directly),
`model_predictions` (:318-371: the cond and null passes batched as one 2B
forward, cond rows first, then `apply_cfg`, and CFG++), `ddim_sample`
(:384-448, with `save_intermediate` the [S, B, H, W, C] trajectory), the
ancestral `p_sample_loop` and `sample` (:450-503) and the latent blend
`interpolate` (:505-547). The JAX samplers are one lax.scan each; here each
is a Python loop over the same steps. The losses draw t, the CFG keep mask,
the noise and the projection directions from an explicit torch.Generator,
or take them from `draws` (keys "t", "keep_mask", "noise", "offset",
"proj"); the samplers draw their
initial noise and their per-step noise [S, B, H, W, C] from a generator, or
take them as `noise` and `step_noise` (so a test can hand in JAX's draws:
the initial one from split(key)[0], step i's from split(split(key)[1], S)[i];
`interpolate` takes `noise1`, `noise2` and `step_noise`, JAX's from
split(key, 3) and split(that[2], t)).

With use_Hy the label-conditioned diagonal covariance H(y) =
exp(-min(fn_y2cov(y), hy_max_log)) (gaussian.py:79-136) scales the noise
by sqrt(H(y)) and divides the per-pixel loss by H(y) on the rows that keep
their condition, and scales the samplers' initial noise by sqrt(H(y)) of
their `labels` (gaussian.py:378-382). `loss` adds the offset noise of
--offset_noise_strength; `weighted_loss` ignores it, as the JAX package
does. With `aux_info` both return (loss, the elastic aux term), the term
(`_elastic_aux`, gaussian.py:235-256) added into the loss with pred_noise
and 0 with the other objectives, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from ccdm_tpu_torch.ops.guidance import apply_cfg
from ccdm_tpu_torch.ops.image import normalize_to_neg_one_to_one, unnormalize_to_zero_to_one
from ccdm_tpu_torch.ops.schedule import (
    make_schedule,
    predict_noise_from_start,
    predict_start_from_noise,
    predict_start_from_v,
    predict_v,
    q_posterior,
    q_sample,
)
from ccdm_tpu_torch.ops.vicinal import (
    classic_batch_weights,
    random_projection_vectors,
    sliced_batch_weights,
)
from ccdm_tpu_torch.parallel.mesh import sharded_apply


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    image_size: int
    channels: int = 3
    timesteps: int = 1000
    sampling_timesteps: Optional[int] = None
    objective: str = "pred_noise"
    beta_schedule: str = "cosine"
    ddim_sampling_eta: float = 0.0
    cond_drop_prob: float = 0.5
    use_Hy: bool = False
    use_cfg_plus_plus: bool = False
    offset_noise_strength: float = 0.0
    min_snr_loss_weight: bool = False
    min_snr_gamma: float = 5.0
    vicinity_type: str = "shv"  # shv | ssv | hv | sv | none
    distance: str = "l2"
    vector_type: str = "gaussian"
    num_projections: int = 1
    # cap on the log-scale h of H(y) = exp(-h); <= 0 keeps h uncapped
    hy_max_log: float = 4.0

    @property
    def effective_sampling_timesteps(self) -> int:
        return self.sampling_timesteps or self.timesteps


def ddim_time_pairs(timesteps: int, sampling_timesteps: int) -> list[tuple[int, int]]:
    """(t, t_next) from np.linspace(-1, T-1, S+1) truncated, in descending
    order; t_next is -1 on the last step."""
    times = np.linspace(-1, timesteps - 1, sampling_timesteps + 1).astype(np.int64)
    times = list(reversed(times.tolist()))
    return list(zip(times[:-1], times[1:]))


def hy_from_y2cov(h: torch.Tensor, max_log: float = 4.0) -> torch.Tensor:
    """H(y) = exp(-h) with h capped at `max_log` when it is positive (a
    deliberate deviation of the JAX package from its reference, which
    leaves h unbounded: a runaway h multiplies a pixel's loss by exp(h))."""
    if max_log and max_log > 0:
        h = torch.clamp(h, max=max_log)
    return torch.exp(-h)


class GaussianDiffusion:
    """Holds the config, the schedule buffers on `device`, the denoiser (an
    nn.Module with the Unet's forward(x, t, labels_emb, keep_mask)) and,
    with use_Hy, fn_y2cov (labels -> [B, C*H*W] in CHW order)."""

    def __init__(self, model: nn.Module, config: DiffusionConfig, device="cpu",
                 fn_y2cov=None):
        if config.use_Hy and fn_y2cov is None:
            raise ValueError("use_Hy=True requires fn_y2cov")
        self.model = model
        self.config = config
        self.device = torch.device(device)
        self.fn_y2cov = fn_y2cov
        self.schedule = make_schedule(config.timesteps, config.beta_schedule,
                                      config.objective, config.min_snr_loss_weight,
                                      config.min_snr_gamma, device=self.device)

    # ---------------------------------------------------------------- Hy

    def convert_y_to_cov(self, labels: torch.Tensor) -> torch.Tensor:
        """H(y) [B, H, W, C]: fn_y2cov's flat CHW output, capped, exp(-h),
        reshaped to [B, C, H, W] and permuted to NHWC."""
        c = self.config
        b = labels.shape[0]
        cov = hy_from_y2cov(self.fn_y2cov(labels.to(self.device)), c.hy_max_log)
        return cov.reshape(b, c.channels, c.image_size, c.image_size).permute(0, 2, 3, 1)

    # ------------------------------------------------------------- loss

    def _per_sample_loss(self, images01, labels, labels_emb, train, gen, draws, offset,
                         aux_info=None, mesh=None):
        """(per-sample SNR-weighted MSE [B], keep_mask [B], the elastic aux
        term or 0) for one batch; `offset` adds the offset noise. With a
        data-parallel `mesh` the model (and the aux net) run on this rank's
        rows and every other tensor is the global batch's."""
        c = self.config
        sched, dev = self.schedule, self.device
        b = images01.shape[0]
        x_start = normalize_to_neg_one_to_one(images01.to(dev))
        t = draws.get("t")
        if t is None:
            t = torch.randint(0, c.timesteps, (b,), generator=gen, device=dev)
        keep_mask = draws.get("keep_mask")
        if keep_mask is None:
            keep_mask = torch.rand(b, generator=gen, device=dev) < (1.0 - c.cond_drop_prob)
        noise = draws.get("noise")
        if noise is None:
            noise = torch.randn(x_start.shape, generator=gen, device=dev)
        t, keep_mask, noise = t.to(dev), keep_mask.to(dev), noise.to(dev)
        keep4 = keep_mask[:, None, None, None]
        if c.use_Hy:
            hy = self.convert_y_to_cov(labels)
            noise = torch.where(keep4, noise * torch.sqrt(hy), noise)
        offset_noise = None
        if offset and c.offset_noise_strength > 0:
            offset_noise = draws.get("offset")
            if offset_noise is None:
                offset_noise = torch.randn((b, c.channels), generator=gen, device=dev)
            offset_noise = offset_noise.to(dev)
        x_t = q_sample(sched, x_start, t, noise, c.offset_noise_strength if offset else 0.0,
                       offset_noise)
        model_out = sharded_apply(mesh, self.model, x_t, t, labels_emb, keep_mask,
                                  train=train)
        if c.objective == "pred_noise":
            target = noise
        elif c.objective == "pred_x0":
            target = x_start
        else:
            target = predict_v(sched, x_start, t, noise)
        sq = (model_out - target) ** 2
        if c.use_Hy:
            sq = sq / torch.where(keep4, hy, torch.ones_like(hy))
        aux = 0.0
        if aux_info is not None and c.objective == "pred_noise":
            aux = self._elastic_aux(x_start, t, model_out, keep_mask, labels, aux_info, mesh)
        return sq.reshape(b, -1).mean(-1) * sched.loss_weight[t], keep_mask, aux

    def _elastic_aux(self, x_start, t, model_out, keep_mask, labels, aux_info,
                     mesh=None) -> torch.Tensor:
        """The elastic aux loss (gaussian.py:235-256): x_t rebuilt from the
        predicted noise, the frozen aux net's label prediction, |y_pred - y|
        of label dim 0 on the kept rows beyond the vicinity radius, summed
        and divided by their count (at least 1), times lambda_aux; 0 before
        step aux_start_step. aux_info: {apply(x_t_hat, t) -> [B, 1],
        lambda_aux, vicinity_radius, aux_start_step?, current_step?}."""
        x_t_hat = q_sample(self.schedule, x_start, t, model_out.float())
        y_pred = sharded_apply(mesh, aux_info["apply"], x_t_hat, t).reshape(-1)
        labels_gt = labels.float().to(self.device).reshape(x_start.shape[0], -1)
        err = (y_pred - labels_gt[:, 0]).abs()
        aux_w = keep_mask.float() * (err > aux_info["vicinity_radius"]).float()
        term = aux_info["lambda_aux"] * (aux_w * err).sum() / torch.clamp(aux_w.sum(), min=1.0)
        step = aux_info.get("current_step")
        if step is not None and step < aux_info.get("aux_start_step", 0):
            term = torch.zeros_like(term)
        return term

    def loss(self, images01: torch.Tensor, labels: torch.Tensor, labels_emb: torch.Tensor,
             vicinal_weights: Optional[torch.Tensor] = None, kappa=0.01, train: bool = True,
             gen: Optional[torch.Generator] = None, draws: Optional[dict] = None,
             aux_info: Optional[dict] = None, mesh=None):
        """Vicinal diffusion loss (gaussian.py:139-224). images01 NHWC in
        [0, 1]; vicinal_weights acts as a gate, as in the JAX package: with
        it, the batch is weighted by the intra-batch vicinal weights. With
        `aux_info`, returns (loss, its elastic aux term). Under a
        data-parallel `mesh` (parallel/mesh.py) every rank passes the global
        batch and gets the global loss, whose gradient reaches the model
        through this rank's rows only."""
        c = self.config
        draws = draws or {}
        per_sample, keep_mask, aux = self._per_sample_loss(
            images01, labels, labels_emb, train, gen, draws, offset=True, aux_info=aux_info,
            mesh=mesh)
        with_aux = (lambda v: (v + aux, aux)) if aux_info is not None else (lambda v: v)
        if vicinal_weights is None or c.vicinity_type == "none":
            return with_aux(per_sample.mean())
        b = per_sample.shape[0]
        labels2d = labels.float().to(self.device)
        labels2d = labels2d.reshape(b, -1) if labels2d.ndim < 2 else labels2d
        is_hard = c.vicinity_type in ("hv", "shv")
        if c.vicinity_type in ("shv", "ssv") and labels2d.shape[1] > 1:
            vecs = draws.get("proj")
            if vecs is None:
                vecs = random_projection_vectors(c.vector_type, labels2d.shape[1],
                                                 c.num_projections, gen, self.device)
            w = sliced_batch_weights(labels2d, vecs.to(self.device), kappa, is_hard, ~keep_mask)
        else:
            w = classic_batch_weights(labels2d, kappa, is_hard, c.distance, ~keep_mask)
        return with_aux((w * per_sample).sum() / b)

    def weighted_loss(self, images01: torch.Tensor, labels: torch.Tensor,
                      labels_emb: torch.Tensor, weights: torch.Tensor, train: bool = True,
                      gen: Optional[torch.Generator] = None, draws: Optional[dict] = None,
                      aux_info: Optional[dict] = None, mesh=None):
        """Vanilla-tree reduction (gaussian.py:258-312): per-sample weights
        applied directly, dropped-condition rows at weight 1; no offset
        noise. With `aux_info`, returns (loss, its elastic aux term); `mesh`
        as in `loss`."""
        per_sample, keep_mask, aux = self._per_sample_loss(
            images01, labels, labels_emb, train, gen, draws or {}, offset=False,
            aux_info=aux_info, mesh=mesh)
        w = torch.where(keep_mask, weights.to(self.device), torch.ones_like(per_sample))
        loss = (w * per_sample).sum() / per_sample.shape[0]
        return loss if aux_info is None else (loss + aux, aux)

    def model_predictions(self, x: torch.Tensor, t: torch.Tensor, labels_emb: torch.Tensor,
                          cond_scale: float = 6.0, rescaled_phi: float = 0.7,
                          clip_x_start: bool = False):
        """(pred_noise, x_start) with classifier-free guidance. Under CFG++
        (use_cfg_plus_plus) the noise comes from the null branch
        (gaussian.py:361-371): pred_noise takes null_out; pred_x0 derives it
        from clip(null_out); pred_v from clip(predict_start_from_v(null_out))."""
        c = self.config
        sched = self.schedule
        b = x.shape[0]
        if float(cond_scale) == 1.0:
            keep = torch.ones(b, dtype=torch.bool, device=x.device)
            guided = null_out = self.model(x, t, labels_emb, keep)
        else:
            keep2 = torch.cat([torch.ones(b, dtype=torch.bool, device=x.device),
                               torch.zeros(b, dtype=torch.bool, device=x.device)])
            out2 = self.model(torch.cat([x, x]), torch.cat([t, t]),
                              torch.cat([labels_emb, labels_emb]), keep2)
            guided, null_out = apply_cfg(out2[:b], out2[b:], cond_scale, rescaled_phi)

        clip = (lambda v: v.clamp(-1.0, 1.0)) if clip_x_start else (lambda v: v)
        pp = c.use_cfg_plus_plus
        if c.objective == "pred_noise":
            pred_noise = null_out if pp else guided
            x_start = clip(predict_start_from_noise(sched, x, t, guided))
            return pred_noise, x_start
        if c.objective == "pred_x0":
            x_start = clip(guided)
            x_for_noise = clip(null_out) if pp else x_start
        else:
            x_start = clip(predict_start_from_v(sched, x, t, guided))
            x_for_noise = clip(predict_start_from_v(sched, x, t, null_out)) if pp else x_start
        return predict_noise_from_start(sched, x, t, x_for_noise), x_start

    def _draw(self, shape, given: Optional[torch.Tensor], generator, what: str) -> torch.Tensor:
        """`given` (checked against `shape`) on the device in f32, else a draw
        from `generator`."""
        if given is None:
            return torch.randn(shape, generator=generator, device=self.device)
        if tuple(given.shape) != tuple(shape):
            raise ValueError(f"{what} must have shape {tuple(shape)}, got {tuple(given.shape)}")
        return given.to(self.device, torch.float32)

    def _init_noise(self, shape, noise, generator, labels) -> torch.Tensor:
        """The sampler's initial noise, times sqrt(H(labels)) with use_Hy."""
        img = self._draw(shape, noise, generator, "noise")
        if self.config.use_Hy and labels is not None:
            img = img * torch.sqrt(self.convert_y_to_cov(labels))
        return img

    def _shape(self, labels_emb: torch.Tensor) -> tuple:
        c = self.config
        return (labels_emb.shape[0], c.image_size, c.image_size, c.channels)

    @torch.no_grad()
    def ddim_sample(self, labels_emb: torch.Tensor, cond_scale: float = 6.0,
                    rescaled_phi: float = 0.7, clip_denoised: bool = True,
                    sampling_timesteps: Optional[int] = None,
                    ddim_eta: Optional[float] = None,
                    noise: Optional[torch.Tensor] = None,
                    step_noise: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None,
                    labels: Optional[torch.Tensor] = None,
                    save_intermediate: bool = False) -> torch.Tensor:
        """DDIM from `noise` (or a draw from `generator`; with use_Hy times
        sqrt(H(labels))) to images in [0, 1], NHWC f32, or with
        `save_intermediate` the state after each step, [S, B, H, W, C] in
        [0, 1]. With eta > 0 step i adds sigma * step_noise[i] ([S, B, H,
        W, C], or a draw from `generator`)."""
        c = self.config
        b = labels_emb.shape[0]
        shape = self._shape(labels_emb)
        steps = sampling_timesteps or c.effective_sampling_timesteps
        eta = c.ddim_sampling_eta if ddim_eta is None else ddim_eta
        ac = self.schedule.alphas_cumprod
        if step_noise is not None:
            step_noise = self._draw((steps, *shape), step_noise, None, "step_noise")

        img = self._init_noise(shape, noise, generator, labels)
        frames = []
        for i, (time, time_next) in enumerate(ddim_time_pairs(c.timesteps, steps)):
            t_cond = torch.full((b,), time, dtype=torch.long, device=self.device)
            pred_noise, x_start = self.model_predictions(
                img, t_cond, labels_emb, cond_scale, rescaled_phi, clip_x_start=clip_denoised)
            if time_next < 0:
                img = x_start
            elif eta == 0.0:
                alpha_next = ac[time_next]
                coef = torch.sqrt(torch.clamp(1 - alpha_next, min=0.0))
                img = x_start * torch.sqrt(alpha_next) + coef * pred_noise
            else:
                alpha, alpha_next = ac[time], ac[time_next]
                sigma = eta * torch.sqrt(torch.clamp(
                    (1 - alpha / alpha_next) * (1 - alpha_next) / (1 - alpha), min=0.0))
                coef = torch.sqrt(torch.clamp(1 - alpha_next - sigma ** 2, min=0.0))
                z = step_noise[i] if step_noise is not None else torch.randn(
                    shape, generator=generator, device=self.device)
                img = x_start * torch.sqrt(alpha_next) + coef * pred_noise + sigma * z
            if save_intermediate:
                frames.append(img)
        if save_intermediate:
            return unnormalize_to_zero_to_one(torch.stack(frames))
        return unnormalize_to_zero_to_one(img)

    @torch.no_grad()
    def p_sample_loop(self, labels_emb: torch.Tensor, cond_scale: float = 6.0,
                      rescaled_phi: float = 0.7, clip_denoised: bool = True,
                      sampling_timesteps: Optional[int] = None,
                      noise: Optional[torch.Tensor] = None,
                      step_noise: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      labels: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Ancestral DDPM (gaussian.py:450-494): t = S-1, ..., 0 against the
        full schedule buffers (S < T is not a respaced schedule, as in the
        JAX package and its reference), x_0 clipped after model_predictions,
        the posterior mean plus exp(log_var / 2) * step_noise[i], no noise at
        t = 0; the initial noise as ddim_sample's. Images in [0, 1], NHWC
        f32."""
        c = self.config
        b = labels_emb.shape[0]
        shape = self._shape(labels_emb)
        steps = sampling_timesteps or c.effective_sampling_timesteps
        if steps > c.timesteps:
            raise ValueError(f"the ancestral sampler runs at most the schedule's "
                             f"{c.timesteps} steps, not {steps}")
        if step_noise is not None:
            step_noise = self._draw((steps, *shape), step_noise, None, "step_noise")

        img = self._init_noise(shape, noise, generator, labels)
        for i, time in enumerate(range(steps - 1, -1, -1)):
            t_cond = torch.full((b,), time, dtype=torch.long, device=self.device)
            _, x_start = self.model_predictions(img, t_cond, labels_emb, cond_scale,
                                                rescaled_phi, clip_x_start=False)
            if clip_denoised:
                x_start = x_start.clamp(-1.0, 1.0)
            mean, _, log_var = q_posterior(self.schedule, x_start, img, t_cond)
            if time == 0:
                img = mean
                continue
            z = step_noise[i] if step_noise is not None else torch.randn(
                shape, generator=generator, device=self.device)
            img = mean + torch.exp(0.5 * log_var) * z
        return unnormalize_to_zero_to_one(img)

    def sample(self, labels_emb: torch.Tensor, cond_scale: float = 6.0,
               rescaled_phi: float = 0.7, **kwargs) -> torch.Tensor:
        """The reference's `sample()` (gaussian.py:496-503): always the
        ancestral loop."""
        return self.p_sample_loop(labels_emb, cond_scale, rescaled_phi, **kwargs)

    @torch.no_grad()
    def interpolate(self, x1: torch.Tensor, x2: torch.Tensor, labels_emb: torch.Tensor,
                    t: Optional[int] = None, lam: float = 0.5, cond_scale: float = 1.0,
                    noise1: Optional[torch.Tensor] = None,
                    noise2: Optional[torch.Tensor] = None,
                    step_noise: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Latent blending (gaussian.py:505-547): x1 and x2 ([-1, 1] NHWC)
        diffused to step t (T - 1 if None) by `noise1` and `noise2`,
        (1 - lam) xt1 + lam xt2, then the ancestral chain t - 1, ..., 0
        (x_0 clipped before q_posterior, step i's noise step_noise[i] of
        [t, B, H, W, C], none at step 0); the noise drawn from `generator`
        where not given. Returns [-1, 1]."""
        c = self.config
        b = x1.shape[0]
        t = c.timesteps - 1 if t is None else int(t)
        shape = tuple(x1.shape)
        if step_noise is not None:
            step_noise = self._draw((t, *shape), step_noise, None, "step_noise")
        tb = torch.full((b,), t, dtype=torch.long, device=self.device)
        xt1 = q_sample(self.schedule, x1.to(self.device).float(), tb,
                       self._draw(shape, noise1, generator, "noise1"))
        xt2 = q_sample(self.schedule, x2.to(self.device).float(), tb,
                       self._draw(shape, noise2, generator, "noise2"))
        img = (1.0 - lam) * xt1 + lam * xt2
        for i, time in enumerate(range(t - 1, -1, -1)):
            t_cond = torch.full((b,), time, dtype=torch.long, device=self.device)
            _, x_start = self.model_predictions(img, t_cond, labels_emb, cond_scale, 0.0)
            mean, _, log_var = q_posterior(self.schedule, x_start.clamp(-1.0, 1.0), img, t_cond)
            if time == 0:
                img = mean
                continue
            z = step_noise[i] if step_noise is not None else torch.randn(
                shape, generator=generator, device=self.device)
            img = mean + torch.exp(0.5 * log_var) * z
        return img
