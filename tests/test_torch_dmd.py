"""Port parity of the DMD2-M trainer (ccdm_tpu_torch/training/dmd.py) against
ccdm_tpu's DMD2Trainer.

One module-scoped JAX run: a DMD2Trainer with a Unet(dim 8, mults 1_2) as
teacher and, on other weights, as the fake UNet, SNGAN G and D at width 4
(dim_z 8) at 64x64, T 20, batch 4, the vanilla adversarial loss, the
vicinity, use_Hy (the sinusoidal y2cov) and DiffAugment; its jitted
g_step and then d_step (~35 s of XLA compiles). The port's trainer takes
the JAX trainer's state through utils/convert.dmd_state_from_jax and JAX's
draws, re-derived from the step keys with JAX's split order (the gumbel
noise of the vicinity choice, DiffAugment's, t, noise, z, the targets' and
the fake labels' uniforms). Tolerances, each with its reason:
- the losses (dm, adv and their total; dn, adv and their total) within
  1e-5 relative (f32 UNet forwards in another framework); the D step
  starts from JAX's state after its G step, carried across again;
- every statistic the steps move (netG's BatchNorm twice, netD's spectral
  norms u and sigma, twice in the D step) within 1e-5;
- the parameters after one AdamW step each by the rule of
  tests/test_torch_eval_train.py: every element within 2 lr (Adam's own
  ceiling: its first step is lr sign(g) up to the weight decay, so an
  element whose gradient lies within the frameworks' f32 difference of 0
  takes a whole step either way), and each leaf's mean error within 0.1 of
  its mean movement in JAX, but in a leaf whose JAX gradient is below 1e-4
  of its net's largest (read off JAX's first moment: the biases that feed
  a train-mode BatchNorm, the fake UNet's null embedding, zero up to
  rounding);
- the clip: one global norm over netD's and the fake UNet's gradients
  together (recorded in the port's D step: both scaled by max_norm over
  that norm, which is neither tree's own).
The hinge loss, kappa 0 (uniform indices, the targets as fake labels) and
use_Hy off are held piecewise: the hinge losses on given outputs, the
kappa-0 draws, and the DM and denoising losses of a kappa-0 trainer
without H(y), each against the JAX trainer's method on the same inputs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ccdm_tpu.data.datasets import make_synthetic
from ccdm_tpu.embedding import make_fn_y2cov as jax_make_fn_y2cov
from ccdm_tpu.embedding import make_fn_y2h as jax_make_fn_y2h
from ccdm_tpu.models import Unet as JaxUnet
from ccdm_tpu.models.sngan import SNGANDiscriminator as JaxD
from ccdm_tpu.models.sngan import SNGANGenerator as JaxG
from ccdm_tpu.training.dmd import DMD2Trainer as JaxDMD2Trainer
from ccdm_tpu.training.dmd import DMDConfig as JaxDMDConfig
from ccdm_tpu.training.vicinity import _gumbel
from ccdm_tpu_torch.embedding.analytic import make_fn_y2cov, make_fn_y2h
from ccdm_tpu_torch.models.sngan import SNGANDiscriminator, SNGANGenerator
from ccdm_tpu_torch.models.unet import Unet
from ccdm_tpu_torch.training import dmd
from ccdm_tpu_torch.training.dmd import DMD2Trainer, DMDConfig, stats_of
from ccdm_tpu_torch.utils.convert import (
    dmd_state_from_jax,
    gan_state_dict_from_jax,
    unet_state_dict_from_jax,
)
from tests.test_torch_gan import _jax_aug_draws, _nchw, _t

torch.set_num_threads(2)

B, SIZE, NC, DIM_Z, T = 4, 64, 3, 8, 20
LR = 1e-4
CFG = dict(data_name="synthetic", train_batch_size=B, niters=1, num_D_steps=1,
           train_timesteps=T, z_dim=DIM_Z, train_lr_generator=LR, train_lr_guidance=LR,
           gan_DiffAugment=True, kernel_sigma=0.05, log_every=10 ** 9, sample_every=10 ** 9,
           save_every=10 ** 9)


def _draw_tree(shapes, seed):
    """Variables of the shapes' tree drawn with numpy: kernels ~ N(0,
    1/fan-in), running variances in [0.5, 1.5], u ~ N(0, 1), sigma 1,
    gains near 1, the rest (biases, means, the null embedding) ~ N(0, 0.2)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = jax.tree_util.keystr(path), leaf.shape
        if name.endswith("['var']"):
            a = rng.uniform(0.5, 1.5, shape)
        elif name.endswith("/u']"):
            a = rng.normal(0, 1, shape)
        elif name.endswith("/sigma']"):
            a = np.ones(shape)
        elif len(shape) >= 2:
            a = rng.normal(0, 1 / np.sqrt(np.prod(shape[:-1])), shape)
        elif name.endswith("scale']") or name.endswith("_g']"):
            a = 1 + rng.normal(0, 0.1, shape)
        else:
            a = rng.normal(0, 0.2, shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _init_shapes(module, *args):
    return jax.eval_shape(lambda k: module.init(k, *args, train=False), jax.random.PRNGKey(0))


class _Setup:
    """The JAX trainer and the port's nets, on the same data and weights."""

    def __init__(self, tmp, **overrides):
        self.bundle = make_synthetic(n=64, image_size=SIZE, channels=NC)
        self.jcfg = JaxDMDConfig(**CFG, results_folder=str(tmp / "jax"), **overrides)
        self.pcfg = DMDConfig(**CFG, results_folder=str(tmp / "port"), **overrides)
        unet = JaxUnet(dim=8, dim_mults=(1, 2), in_channels=NC)
        ushapes = _init_shapes(unet, jnp.zeros((2, SIZE, SIZE, NC)), jnp.zeros((2,), jnp.int32),
                               jnp.zeros((2, 128)), None)
        self.teacher_vars, fake_vars = _draw_tree(ushapes, 0), _draw_tree(ushapes, 1)
        jG, jD = JaxG(dim_z=DIM_Z, nc=NC, img_size=SIZE, gene_ch=4), \
            JaxD(nc=NC, img_size=SIZE, disc_ch=4)
        gv = _draw_tree(_init_shapes(jG, jnp.zeros((2, DIM_Z)), jnp.zeros((2, 128))), 2)
        dv = _draw_tree(_init_shapes(jD, jnp.zeros((2, SIZE, SIZE, NC)), jnp.zeros((2, 128))), 3)
        cov_dim = NC * SIZE * SIZE
        hy = self.jcfg.use_Hy
        self.jax = JaxDMD2Trainer(unet.apply, self.teacher_vars, unet.apply, fake_vars, jG, jD,
                                  gv, dv, self.bundle.images, self.bundle.labels_norm,
                                  jax_make_fn_y2h(128), self.jcfg,
                                  fn_y2cov=jax_make_fn_y2cov(cov_dim) if hy else None)
        self.state0 = jax.device_get(self.jax.state)
        self.port = self.make_port(make_fn_y2cov(cov_dim) if hy else None)

    def make_port(self, fn_y2cov):
        teacher, fake = Unet(dim=8, dim_mults=(1, 2), in_channels=NC), \
            Unet(dim=8, dim_mults=(1, 2), in_channels=NC)
        teacher.load_state_dict(unet_state_dict_from_jax(self.teacher_vars, teacher))
        netG = SNGANGenerator(dim_z=DIM_Z, nc=NC, img_size=SIZE, gene_ch=4)
        netD = SNGANDiscriminator(nc=NC, img_size=SIZE, disc_ch=4)
        port = DMD2Trainer(teacher, fake, netG, netD, self.bundle.images,
                           self.bundle.labels_norm, make_fn_y2h(128), self.pcfg,
                           fn_y2cov=fn_y2cov, device="cpu")
        port.load_tree(dmd_state_from_jax(self.state0, netG, netD, fake))
        return port


def _noise(key, shape):
    return _nchw(jax.random.normal(key, shape))


def _targets(tr, key):
    """_draw_target_labels' draws (dmd.py:261-268)."""
    if tr.kappa == 0:
        return {"target_idx": _t(jax.random.randint(key, (B,), 0, tr.train_labels.shape[0]))}
    k_pick, k_noise = jax.random.split(key)
    return {"target_idx": _t(jax.random.randint(k_pick, (B,), 0, tr.unique_labels.shape[0])),
            "target_eps": _t(jax.random.normal(k_noise, (B, 1)))}


def _d_out_draws(tr, key):
    k_t, k_noise, k_aug = jax.random.split(key, 3)
    return {"t": _t(jax.random.randint(k_t, (B,), 0, T)),
            "noise": _noise(k_noise, (B, SIZE, SIZE, NC)),
            "aug": _jax_aug_draws(k_aug, B, SIZE, SIZE, tr.cfg.gan_DiffAugment_policy)}


def g_draws(tr, key):
    """The draws of JAX's g_step (dmd.py:308-332)."""
    k_lbl, k_z, k_dm, k_adv = jax.random.split(key, 4)
    k_t, k_noise = jax.random.split(k_dm)
    hi = min(tr.max_step + 1, T)
    return {**_targets(tr, k_lbl), "z": _t(jax.random.normal(k_z, (B, DIM_Z))),
            "dm": {"t": _t(jax.random.randint(k_t, (B,), tr.min_step, hi)),
                   "noise": _noise(k_noise, (B, SIZE, SIZE, NC))},
            "adv": _d_out_draws(tr, k_adv)}


def d_draws(tr, key):
    """The draws of JAX's d_step (dmd.py:336-368)."""
    k_lbl, k_fl, k_real, k_z, k_advr, k_advf, k_dn = jax.random.split(key, 7)
    k_sel, _ = jax.random.split(k_real)  # k_aug: no augmentation of the synthetic set
    n = tr.train_labels.shape[0]
    real = ({"idx": _t(jax.random.randint(k_sel, (B,), 0, n))} if tr.kappa == 0
            else {"gumbel": _t(_gumbel(k_sel, (B, n)))})
    k_t, k_noise = jax.random.split(k_dn)
    return {**_targets(tr, k_lbl), "fake_u": _t(jax.random.uniform(k_fl, (B, 1))),
            "real": real, "z": _t(jax.random.normal(k_z, (B, DIM_Z))),
            "adv_real": _d_out_draws(tr, k_advr), "adv_fake": _d_out_draws(tr, k_advf),
            "dn": {"t": _t(jax.random.randint(k_t, (B,), 0, T)),
                   "noise": _noise(k_noise, (B, SIZE, SIZE, NC))}}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both trainers after one g_step and one d_step; the port's clip
    calls recorded."""
    setup = _Setup(tmp_path_factory.mktemp("dmd"), adv_loss_type="vanilla", kappa=None,
                   use_Hy=True)
    jtr, port = setup.jax, setup.port
    g_step, d_step = jtr._build_steps()
    kg, kd = jax.random.PRNGKey(11), jax.random.PRNGKey(12)
    state_g, jg = g_step(jtr.state, kg)
    state_g = jax.device_get(state_g)
    pg = port.g_step(draws=g_draws(jtr, kg))
    after_g = {"gen_stats": [t.clone() for t in stats_of(port.netG)],
               "gen_params": [p.detach().clone() for p in port.netG.parameters()]}
    # the D step starts from JAX's state after its G step: Adam's sign
    # steps would otherwise carry the G step's f32 differences into the
    # fakes the D step draws
    port.load_tree(dmd_state_from_jax(state_g, port.netG, port.netD, port.fake_unet))
    clips, clip = [], dmd.clip_by_global_norm

    def recording(grads, max_norm):
        out = clip(grads, max_norm)
        clips.append(([g.clone() for g in grads], out))
        return out

    dmd.clip_by_global_norm = recording
    try:
        pd = port.d_step(draws=d_draws(jtr, kd))
    finally:
        dmd.clip_by_global_norm = clip
    state_d, jd = d_step(jax.tree_util.tree_map(jnp.asarray, state_g), kd)
    return dict(setup=setup, jg=[float(v) for v in jg], pg=[float(v) for v in pg],
                jd=[float(v) for v in jd], pd=[float(v) for v in pd], state_g=state_g,
                state_d=jax.device_get(state_d), after_g=after_g, clips=clips)


def test_losses_of_one_g_step_and_one_d_step(run):
    """(loss, dm, adv) of the G step, (loss, dn, adv) of the D step."""
    np.testing.assert_allclose(run["pg"], run["jg"], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(run["pd"], run["jd"], rtol=1e-5, atol=1e-7)
    assert run["jg"][1] != 0.0 and all(np.isfinite(run["jd"]))


def _assert_stats(got: list, model, params, stats):
    want = stats_of_tree(model, params, stats)
    assert len(got) == len(want)
    for (name, w), g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5, err_msg=name)


def stats_of_tree(model, params, stats):
    sd = gan_state_dict_from_jax({"params": params, "batch_stats": stats}, model)
    return [(n, sd[n].numpy()) for n, b in model.named_buffers() if b.is_floating_point()]


def test_statistics_after_the_steps(run):
    """netG's BatchNorm after the G step and again after the D step's fakes;
    netD's u and sigma after its two train forwards; the fake UNet's never
    move."""
    port, s0, sg, sd = run["setup"].port, run["setup"].state0, run["state_g"], run["state_d"]
    _assert_stats(run["after_g"]["gen_stats"], port.netG, sg["gen_params"], sg["gen_stats"])
    _assert_stats(stats_of(port.netG), port.netG, sd["gen_params"], sd["gen_stats"])
    _assert_stats(stats_of(port.netD), port.netD, sd["gui_params"]["netD"], sd["netD_stats"])
    moved = [np.abs(a - b).max() for (_, a), (_, b) in zip(
        stats_of_tree(port.netD, s0["gui_params"]["netD"], s0["netD_stats"]),
        stats_of_tree(port.netD, sd["gui_params"]["netD"], sd["netD_stats"]))]
    assert max(moved) > 1e-3
    fake = unet_state_dict_from_jax({"params": sd["gui_params"]["fake_unet"],
                                     "batch_stats": sd["fake_unet_stats"]}, port.fake_unet)
    for name, b in port.fake_unet.named_buffers():
        if b.is_floating_point():
            assert torch.equal(b, fake[name]), name


def _assert_adamw(got_params, model, init_sd, want_sd, moments_sd):
    """tests/test_torch_eval_train.py's Adam rule (module docstring)."""
    names = [n for n, _ in model.named_parameters()]
    largest = max(float(moments_sd[n].abs().max()) for n in names)
    checked = 0
    for name, got in zip(names, got_params):
        err = (got.detach() - want_sd[name]).abs()
        assert float(err.max()) <= 2 * LR * (1 + 1e-3), (name, float(err.max()))
        moved = float((want_sd[name] - init_sd[name]).abs().mean())
        if float(moments_sd[name].abs().max()) >= 1e-4 * largest:
            assert float(err.mean()) <= 0.1 * moved, (name, float(err.mean()), moved)
            checked += 1
    assert checked >= len(names) // 2


def _opt_moments(state, which):
    from ccdm_tpu_torch.utils.convert import _adam_state

    return _adam_state(state[which]).mu


def test_parameters_after_adamw(run):
    port, s0, sg, sd = run["setup"].port, run["setup"].state0, run["state_g"], run["state_d"]
    conv = lambda p, bs, m: gan_state_dict_from_jax({"params": p, "batch_stats": bs}, m)
    _assert_adamw(run["after_g"]["gen_params"], port.netG,
                  conv(s0["gen_params"], s0["gen_stats"], port.netG),
                  conv(sg["gen_params"], sg["gen_stats"], port.netG),
                  conv(_opt_moments(sg, "gen_opt"), sg["gen_stats"], port.netG))
    mu = _opt_moments(sd, "gui_opt")
    _assert_adamw(list(port.netD.parameters()), port.netD,
                  conv(s0["gui_params"]["netD"], s0["netD_stats"], port.netD),
                  conv(sd["gui_params"]["netD"], sd["netD_stats"], port.netD),
                  conv(mu["netD"], sd["netD_stats"], port.netD))
    uconv = lambda p: unet_state_dict_from_jax({"params": p,
                                                "batch_stats": sd["fake_unet_stats"]},
                                               port.fake_unet)
    _assert_adamw(list(port.fake_unet.parameters()), port.fake_unet,
                  uconv(s0["gui_params"]["fake_unet"]), uconv(sd["gui_params"]["fake_unet"]),
                  uconv(mu["fake_unet"]))
    assert port.gen_opt.count == 1 and port.gui_opt.count == 1 and port.step == 0
    assert int(np.asarray(sd["gui_opt"][1][0].count)) == 1


def test_clip_takes_one_norm_over_netD_and_the_fake_unet(run):
    port = run["setup"].port
    (grads, clipped), = run["clips"]
    n_d = len(list(port.netD.parameters()))
    assert len(grads) == n_d + len(list(port.fake_unet.parameters()))
    norm = lambda gs: float(torch.sqrt(sum(torch.sum(g * g) for g in gs)))
    total, own_d, own_u = norm(grads), norm(grads[:n_d]), norm(grads[n_d:])
    assert total > 1.0 and own_d != total and own_u != total
    for g, c in zip(grads, clipped):
        torch.testing.assert_close(c, g / total, rtol=1e-5, atol=1e-12)


# ---------------------------------------------- hinge, kappa 0, no H(y)


@pytest.fixture(scope="module")
def plain(tmp_path_factory):
    return _Setup(tmp_path_factory.mktemp("dmd0"), adv_loss_type="hinge", kappa=0.0,
                  use_Hy=False)


def test_hinge_losses(plain):
    rng = np.random.default_rng(0)
    d_real, d_fake = (rng.normal(0, 2, B).astype(np.float32) for _ in range(2))
    jtr, port = plain.jax, plain.port
    np.testing.assert_allclose(float(port._adv_g(_t(d_fake))), float(jtr._adv_g(d_fake)),
                               rtol=1e-6)
    np.testing.assert_allclose(float(port._adv_d(_t(d_real), _t(d_fake))),
                               float(jtr._adv_d(d_real, d_fake)), rtol=1e-6)


def test_kappa_zero_draws(plain):
    """Uniform target indices and real indices; the targets are the fake
    labels."""
    jtr, port = plain.jax, plain.port
    key = jax.random.PRNGKey(3)
    k_sel = jax.random.split(key)[0]
    want_t = np.asarray(jtr._draw_target_labels(key))
    got_t = port._draw_target_labels(None, _targets(jtr, key))
    np.testing.assert_array_equal(got_t.numpy(), want_t)
    want = np.asarray(jtr._draw_real_batch(key, want_t))
    got = port._draw_real_batch(got_t, None,
                                {"idx": _t(jax.random.randint(k_sel, (B,), 0, 64))})
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    assert port._draw_fake_labels(got_t, None, {}) is got_t
    np.testing.assert_array_equal(np.asarray(jtr._draw_fake_labels(key, want_t)), want_t)


def test_losses_without_hy(plain):
    """The DM loss and the denoising loss of a trainer without H(y)."""
    jtr, port = plain.jax, plain.port
    rng = np.random.default_rng(1)
    images = rng.uniform(-1, 1, (B, SIZE, SIZE, NC)).astype(np.float32)
    labels = rng.uniform(0.1, 0.9, (B, 1)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    k_t, k_noise = jax.random.split(key)
    s = plain.state0
    fake = s["gui_params"]["fake_unet"]
    want_dm = float(jax.jit(lambda *a: jtr._dm_loss(*a))(fake, s["fake_unet_stats"], key,
                                                          images, labels))
    want_dn = float(jax.jit(lambda *a: jtr._denoising_loss(*a))(fake, s["fake_unet_stats"],
                                                                key, images, labels))
    hi = min(jtr.max_step + 1, T)
    draws = lambda lo, top: {"t": _t(jax.random.randint(k_t, (B,), lo, top)),
                             "noise": _noise(k_noise, images.shape)}
    with torch.no_grad():
        got_dm = float(port._dm_loss(_nchw(images), _t(labels), None,
                                     draws(jtr.min_step, hi)))
        got_dn = float(port._denoising_loss(_nchw(images), _t(labels), None, draws(0, T)))
    np.testing.assert_allclose([got_dm, got_dn], [want_dm, want_dn], rtol=1e-5)
    assert want_dm > 0 and want_dn > 0
    assert not port.cfg.use_Hy
