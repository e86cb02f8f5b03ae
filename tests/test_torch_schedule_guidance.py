"""Port parity: schedules, DDIM time pairs, guidance and image quantisation.

Each ccdm_tpu_torch function is held against its ccdm_tpu counterpart on
the same numpy inputs. Schedules are computed in f64 and stored in f32 by
both, so they must be bitwise equal; the time pairs are integer logic and
must be exactly equal; guidance is f32 elementwise math and reductions in
another order, so 1e-6, times (cond_scale - 1) where the guidance update
amplifies the reductions' rounding.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ccdm_tpu.ops import guidance as jguid
from ccdm_tpu.ops import image as jimage
from ccdm_tpu.ops import schedule as jsched
from ccdm_tpu_torch.diffusion.gaussian import ddim_time_pairs
from ccdm_tpu_torch.ops import guidance, image, schedule

torch.set_num_threads(2)

BUFFERS = ("betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
           "sqrt_one_minus_alphas_cumprod", "log_one_minus_alphas_cumprod",
           "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod",
           "posterior_variance", "posterior_log_variance_clipped",
           "posterior_mean_coef1", "posterior_mean_coef2", "snr", "loss_weight")


@pytest.mark.parametrize("kind,timesteps", [("cosine", 1000), ("linear", 1000),
                                            ("cosine", 100)])
def test_betas_bitwise(kind, timesteps):
    fn = {"cosine": (jsched.cosine_betas, schedule.cosine_betas),
          "linear": (jsched.linear_betas, schedule.linear_betas)}[kind]
    np.testing.assert_array_equal(fn[1](timesteps), fn[0](timesteps))


@pytest.mark.parametrize("kind,objective", [("cosine", "pred_x0"),
                                            ("linear", "pred_noise"),
                                            ("cosine", "pred_v")])
def test_make_schedule_buffers_bitwise(kind, objective):
    want = jsched.make_schedule(1000, kind, objective)
    got = schedule.make_schedule(1000, kind, objective)
    for name in BUFFERS:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    assert got.num_timesteps == want.num_timesteps and got.objective == want.objective


@pytest.mark.parametrize("timesteps,steps", [(1000, 250), (100, 5), (50, 50)])
def test_ddim_time_pairs_exact(timesteps, steps):
    # ccdm_tpu/diffusion/gaussian.py:411-413
    times = np.linspace(-1, timesteps - 1, steps + 1).astype(np.int64)
    times = list(reversed(times.tolist()))
    assert ddim_time_pairs(timesteps, steps) == list(zip(times[:-1], times[1:]))


def test_sampling_conversions_match():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 8, 8, 3)).astype(np.float32)
    v = rng.normal(size=(3, 8, 8, 3)).astype(np.float32)
    t = np.array([0, 499, 999])
    js = jsched.make_schedule(1000, "cosine", "pred_x0")
    ts = schedule.make_schedule(1000, "cosine", "pred_x0")
    for jfn, tfn in ((jsched.predict_noise_from_start, schedule.predict_noise_from_start),
                     (jsched.predict_start_from_noise, schedule.predict_start_from_noise),
                     (jsched.predict_start_from_v, schedule.predict_start_from_v)):
        want = np.asarray(jfn(js, jnp.asarray(x), jnp.asarray(t), jnp.asarray(v)))
        got = tfn(ts, torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(v)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("cond_scale,rescaled_phi", [(1.5, 0.7), (1.5, 0.0),
                                                     (6.0, 0.7), (1.0, 0.7)])
def test_apply_cfg_matches(cond_scale, rescaled_phi):
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(4, 8, 8, 3)).astype(np.float32)
    null = rng.normal(size=(4, 8, 8, 3)).astype(np.float32)
    want = jguid.apply_cfg(jnp.asarray(logits), jnp.asarray(null), cond_scale, rescaled_phi)
    got = guidance.apply_cfg(torch.from_numpy(logits), torch.from_numpy(null),
                             cond_scale, rescaled_phi)
    tol = 1e-6 * max(1.0, cond_scale - 1.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=tol, atol=tol)


def test_project_parallel_matches():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 4, 4, 2)).astype(np.float32)
    y = rng.normal(size=(3, 4, 4, 2)).astype(np.float32)
    want = jguid.project_parallel(jnp.asarray(x), jnp.asarray(y))
    got = guidance.project_parallel(torch.from_numpy(x), torch.from_numpy(y))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


def test_to_uint8_exact():
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.uniform(-0.2, 1.2, 997), [0.0, 1.0, 0.5, 254.5 / 255]])
    x = x.astype(np.float32)
    want = np.asarray(jimage.to_uint8(jimage.unnormalize_to_zero_to_one(jnp.asarray(x))))
    got = image.to_uint8(image.unnormalize_to_zero_to_one(torch.from_numpy(x))).numpy()
    np.testing.assert_array_equal(got, want)
