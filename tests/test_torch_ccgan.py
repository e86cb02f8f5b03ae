"""Port parity of the CcGAN and Dual-NDA trainer
(ccdm_tpu_torch/training/ccgan.py) against ccdm_tpu's.

One module-scoped JAX run for each of two configurations, SNGAN G and D at
width 4 (dim_gan 16) at 64x64, batch 8, the sinusoidal label embedding:
(a) the hard vicinity, the hinge loss, DiffAugment and Dual-NDA b (a
corruption of the reals) and c (reals outside the vicinity); (b) the soft
vicinity, the vanilla loss and Dual-NDA d and e (two bad-fake banks). Each
takes one jitted d_step with the NDA terms and one g_step. The port's
trainer starts from the JAX trainer's state through
utils/convert.ccgan_state_from_jax and takes JAX's draws, re-derived from
the step keys with JAX's split order, for every consumer, also where JAX
feeds one key to several (keys[4] to the pick, the jigsaw, the stitch,
the cutout and the corrupted batch's augmentation; keys[5], [6] and [7] to
a choice and an augmentation each). Tolerances, each with its reason:
- jigsaw_k, stitch and the empty-row rule of the masked choice on given
  permutations and noise: exact (index logic);
- the step losses: 1e-5 relative (f32 convs in another framework); the G
  step starts from JAX's state after its D step, carried across again;
- the statistics the steps move (netG's BatchNorm in the D step's
  train-mode fakes and again in the G step; netD's u and sigma at each of
  its train forwards): 1e-5;
- the parameters after one Adam(0.5, 0.999) step each by the rule of
  tests/test_torch_dmd.py's _assert_adamw;
- train's cadence and sample_given_labels' padding: the same files and
  shapes as JAX's.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ccdm_tpu.data.datasets import make_synthetic
from ccdm_tpu.embedding import make_fn_y2h as jax_make_fn_y2h
from ccdm_tpu.models.sngan import SNGANDiscriminator as JaxD
from ccdm_tpu.models.sngan import SNGANGenerator as JaxG
from ccdm_tpu.training import ccgan as jccgan
from ccdm_tpu.training.vicinity import _gumbel, _masked_uniform_choice
from ccdm_tpu_torch.embedding.analytic import make_fn_y2h
from ccdm_tpu_torch.models.sngan import SNGANDiscriminator, SNGANGenerator
from ccdm_tpu_torch.training import ccgan
from ccdm_tpu_torch.training.dmd import stats_of
from ccdm_tpu_torch.training.vicinity import masked_uniform_choice
from ccdm_tpu_torch.utils.convert import ccgan_state_from_jax, gan_state_dict_from_jax
from tests.test_torch_dmd import LR, _assert_adamw, _draw_tree, _init_shapes
from tests.test_torch_gan import _jax_aug_draws, _nchw, _t

torch.set_num_threads(2)

B, SIZE, NC, DIM = 8, 64, 1, 16
POLICY = "color,translation,cutout"
CONFIGS = {
    "hard_hinge_nda_bc": dict(threshold_type="hard", loss_type="hinge", use_DiffAugment=True,
                              nda_a=0.8, nda_b=0.1, nda_c=0.1),
    "soft_vanilla_nda_de": dict(threshold_type="soft", loss_type="vanilla",
                                use_DiffAugment=False, nda_a=0.7, nda_d=0.2, nda_e=0.1),
}


def _bank(seed, m=10):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (m, SIZE, SIZE, NC)).astype(np.uint8),
            rng.uniform(0, 1, m).astype(np.float32))


class _Setup:
    def __init__(self, tmp, name):
        self.bundle = make_synthetic(n=48, image_size=SIZE, channels=NC)
        kw = dict(niters=1, batch_size_disc=B, batch_size_gene=B, num_D_steps=1, lr_g=LR,
                  lr_d=LR, dim_gan=DIM, log_every=10 ** 9, visualize_freq=10 ** 9,
                  save_niters_freq=10 ** 9, seed=5, **CONFIGS[name])
        self.jcfg = jccgan.CcGANConfig(**kw, results_folder=str(tmp / "jax"))
        self.pcfg = ccgan.CcGANConfig(**kw, results_folder=str(tmp / "port"))
        jG, jD = JaxG(dim_z=DIM, nc=NC, img_size=SIZE, gene_ch=4), \
            JaxD(nc=NC, img_size=SIZE, disc_ch=4)
        gv = _draw_tree(_init_shapes(jG, jnp.zeros((2, DIM)), jnp.zeros((2, 128))), 21)
        dv = _draw_tree(_init_shapes(jD, jnp.zeros((2, SIZE, SIZE, NC)), jnp.zeros((2, 128))), 22)
        banks = dict(badfake_niqe=_bank(1), badfake_mae=_bank(2))
        self.banks = banks
        self.jax = jccgan.CcGANTrainer(jG, jD, gv, dv, self.bundle.images,
                                       self.bundle.labels_norm, jax_make_fn_y2h(128), self.jcfg,
                                       **banks)
        self.state0 = jax.device_get(dict(self.jax.state))
        netG = SNGANGenerator(dim_z=DIM, nc=NC, img_size=SIZE, gene_ch=4)
        netD = SNGANDiscriminator(nc=NC, img_size=SIZE, disc_ch=4)
        self.port = ccgan.CcGANTrainer(netG, netD, self.bundle.images, self.bundle.labels_norm,
                                       make_fn_y2h(128), self.pcfg, device="cpu", **banks)
        self.port.load_tree(self.convert(self.state0))

    def convert(self, state):
        return ccgan_state_from_jax(state, self.port.netG, self.port.netD)


def _targets(tr, key):
    k_pick, k_noise = jax.random.split(key)
    return {"target_idx": _t(jax.random.randint(k_pick, (B,), 0, tr.unique_labels.shape[0])),
            "target_eps": _t(jax.random.normal(k_noise, (B, 1)))}


def d_draws(tr, key):
    """The draws of JAX's d_step (ccgan.py:201-280), for every consumer."""
    keys = jax.random.split(key, 8)
    k_t, k_sel, k_fl, _ = jax.random.split(keys[0], 4)  # no augmentation of the synthetic set
    n = tr.train_labels.shape[0]
    aug = lambda k: _jax_aug_draws(k, B, SIZE, SIZE, POLICY)
    kx, ky = jax.random.split(keys[4])
    cut = lambda k: _t(jax.random.randint(k, (B, 1, 1), 0, SIZE + 1)).reshape(B)
    return {**_targets(tr, k_t), "gumbel": _t(_gumbel(k_sel, (B, n))),
            "fake_u": _t(jax.random.uniform(k_fl, (B, 1))),
            "z": _t(jax.random.normal(keys[1], (B, DIM))),
            "aug_real": aug(keys[2]), "aug_fake": aug(keys[3]),
            "nda_b": {"pick": _t(jax.random.randint(keys[4], (), 0, 3)),
                      "perm": _t(jax.vmap(lambda k: jax.random.permutation(k, 4))(
                          jax.random.split(keys[4], B))),
                      "stitch": _t(jax.random.permutation(keys[4], B)),
                      "cutout": {"cy": cut(kx), "cx": cut(ky)}, "aug": aug(keys[4])},
            "nda_c": {"gumbel": _t(_gumbel(keys[5], (B, n))), "aug": aug(keys[5])},
            "nda_d": {"idx": _t(jax.random.randint(keys[6], (B,), 0, 10)), "aug": aug(keys[6])},
            "nda_e": {"idx": _t(jax.random.randint(keys[7], (B,), 0, 10)), "aug": aug(keys[7])}}


def g_draws(tr, key):
    k_t, k_z, k_aug = jax.random.split(key, 3)
    return {**_targets(tr, k_t), "z": _t(jax.random.normal(k_z, (B, DIM))),
            "aug": _jax_aug_draws(k_aug, B, SIZE, SIZE, POLICY)}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def run(request, tmp_path_factory):
    """Both trainers after one d_step with the NDA terms, then one g_step."""
    setup = _Setup(tmp_path_factory.mktemp(request.param), request.param)
    jtr, port = setup.jax, setup.port
    d_plain, d_nda, g_step = jtr._build_steps()
    kd, kg = jax.random.PRNGKey(31), jax.random.PRNGKey(32)
    state_d, jd = d_nda(jtr.state, kd)
    state_d = jax.device_get(dict(state_d))
    pd = port.d_step(True, draws=d_draws(jtr, kd))
    after_d = {"g_stats": [t.clone() for t in stats_of(port.netG)],
               "d_stats": [t.clone() for t in stats_of(port.netD)],
               "d_params": [p.detach().clone() for p in port.d_params]}
    port.load_tree(setup.convert(state_d))
    pg = port.g_step(draws=g_draws(jtr, kg))
    state_g, jg = g_step(jax.tree_util.tree_map(jnp.asarray, state_d), kg)
    jtr._steps = (d_plain, d_nda, g_step)
    jtr.state = jax.tree_util.tree_map(jnp.asarray, jax.device_get(dict(state_g)))
    return dict(name=request.param, setup=setup, jd=float(jd), pd=float(pd), jg=float(jg),
                pg=float(pg), state_d=state_d, state_g=jax.device_get(dict(jtr.state)),
                after_d=after_d)


def test_losses_of_one_d_step_and_one_g_step(run):
    np.testing.assert_allclose([run["pd"], run["pg"]], [run["jd"], run["jg"]], rtol=1e-5,
                               atol=1e-6)
    assert np.isfinite([run["jd"], run["jg"]]).all()


def test_the_nda_terms_enter_the_d_loss(run):
    """The D loss of the same draws without the NDA terms differs (the
    terms are in the compared loss), and the radius and weights follow the
    vicinity type."""
    port = run["setup"].port
    port.load_tree(run["setup"].convert(run["setup"].state0))
    draws = d_draws(run["setup"].jax, jax.random.PRNGKey(31))
    plain = float(port.d_step(False, draws=draws))
    assert abs(plain - run["pd"]) > 1e-4
    port.load_tree(run["setup"].convert(run["state_g"]))
    soft = port.cfg.threshold_type == "soft"
    want = np.sqrt(-np.log(1e-3)) * port.kappa if soft else port.kappa
    assert port.fake_label_radius() == pytest.approx(float(want))


def _stats_tree(model, params, stats):
    sd = gan_state_dict_from_jax({"params": params, "batch_stats": stats}, model)
    return [(n, sd[n].numpy()) for n, b in model.named_buffers() if b.is_floating_point()]


def _assert_stats(got, model, params, stats):
    want = _stats_tree(model, params, stats)
    assert len(got) == len(want)
    for (name, w), g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5, err_msg=name)


def test_statistics_after_the_d_step(run):
    """netG's BatchNorm moved by the D step's train-mode fakes (as JAX's
    test_dmd_ccgan asserts), netD's u and sigma after its train forwards."""
    port, s0, sd = run["setup"].port, run["setup"].state0, run["state_d"]
    _assert_stats(run["after_d"]["g_stats"], port.netG, sd["g_params"], sd["g_stats"])
    _assert_stats(run["after_d"]["d_stats"], port.netD, sd["d_params"], sd["d_stats"])
    moved = max(np.abs(x - y).max() for (_, x), (_, y) in zip(
        _stats_tree(port.netG, s0["g_params"], s0["g_stats"]),
        _stats_tree(port.netG, sd["g_params"], sd["g_stats"])))
    assert moved > 1e-3


def test_g_step_statistics(run):
    """netG's BatchNorm after the G step (the port's own step, from JAX's
    state after the D step)."""
    setup = run["setup"]
    port, sd, sg = setup.port, run["state_d"], run["state_g"]
    port.load_tree(setup.convert(sd))
    port.g_step(draws=g_draws(setup.jax, jax.random.PRNGKey(32)))
    _assert_stats(stats_of(port.netG), port.netG, sg["g_params"], sg["g_stats"])
    _assert_stats(stats_of(port.netD), port.netD, sg["d_params"], sg["d_stats"])
    conv = lambda p, bs, m: gan_state_dict_from_jax({"params": p, "batch_stats": bs}, m)
    from ccdm_tpu_torch.utils.convert import _adam_state

    _assert_adamw(list(port.netG.parameters()), port.netG,
                  conv(sd["g_params"], sd["g_stats"], port.netG),
                  conv(sg["g_params"], sg["g_stats"], port.netG),
                  conv(_adam_state(sg["g_opt"]).mu, sg["g_stats"], port.netG))


def test_d_parameters_after_adam(run):
    from ccdm_tpu_torch.utils.convert import _adam_state

    port, s0, sd = run["setup"].port, run["setup"].state0, run["state_d"]
    conv = lambda p, bs, m: gan_state_dict_from_jax({"params": p, "batch_stats": bs}, m)
    _assert_adamw(run["after_d"]["d_params"], port.netD,
                  conv(s0["d_params"], s0["d_stats"], port.netD),
                  conv(sd["d_params"], sd["d_stats"], port.netD),
                  conv(_adam_state(sd["d_opt"]).mu, sd["d_stats"], port.netD))


def test_train_cadence_and_sampling_are_jaxs(run, tmp_path):
    """3 iterations at log_every 2, visualize_freq 2, save_niters_freq 3:
    the same log steps (1 and 2), grid and milestone; sample_given_labels
    pads its last chunk and returns uint8 [n, H, W, C] or [-1, 1] floats."""
    if run["name"] != "soft_vanilla_nda_de":
        pytest.skip("the cadence is the trainer's, held once")
    setup = run["setup"]
    out = {}
    for name, tr in (("jax", setup.jax), ("port", setup.port)):
        folder = tmp_path / name
        os.makedirs(folder, exist_ok=True)
        tr.cfg.results_folder, tr.cfg.niters = str(folder), 3
        tr.cfg.log_every, tr.cfg.visualize_freq, tr.cfg.save_niters_freq = 2, 2, 3
        tr.train(progress=False)
        log = [json.loads(line)["step"] for line in open(folder / "train_log.jsonl")]
        out[name] = (log, sorted(p for p in os.listdir(folder) if p.endswith(".png")),
                     sorted(p for p in os.listdir(folder) if p.startswith("model-")))
    assert out["port"] == out["jax"] == ([1, 2], ["sample_2.png"], ["model-ccgan-3"])
    labels = np.linspace(0.1, 0.9, 5)
    for denorm in (True, False):
        want, _ = setup.jax.sample_given_labels(labels, batch_size=3, denorm=denorm)
        got, given = setup.port.sample_given_labels(labels, batch_size=3, denorm=denorm)
        assert got.shape == want.shape == (5, SIZE, SIZE, NC) and got.dtype == want.dtype
        assert given is labels
    assert np.abs(got).max() <= 1.0


def test_checkpoint_round_trip(run, tmp_path):
    port = run["setup"].port
    port.cfg.results_folder = str(tmp_path)
    port.save(4)
    tree = port.checkpoint_tree()
    with torch.no_grad():
        for p in port.d_params:
            p.add_(1.0)
    port.load(4)
    for a, b in zip(port.checkpoint_tree()["d_params"], tree["d_params"]):
        assert torch.equal(a, b)


# ------------------------------------------------ the Dual-NDA corruptions


def test_jigsaw_and_stitch_are_jaxs():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(5, 8, 8, 3)).astype(np.float32)
    key = jax.random.PRNGKey(6)
    for k in (2, 4):
        perm = jax.vmap(lambda kk: jax.random.permutation(kk, k * k))(jax.random.split(key, 5))
        want = np.asarray(jccgan.jigsaw_k(key, jnp.asarray(x), k))
        got = ccgan.jigsaw_k(_nchw(x), _t(perm), k).permute(0, 2, 3, 1)
        np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(jccgan.stitch(key, jnp.asarray(x), 2))
    got = ccgan.stitch(_nchw(x), _t(jax.random.permutation(key, 5)), 2).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_a_row_without_candidates_takes_index_0():
    """Dual-NDA c's choice among reals outside the vicinity: a row with no
    True entry gives index 0 in both (no nearest-label fallback there)."""
    mask = np.zeros((3, 7), bool)
    mask[1, [2, 5]] = True
    key = jax.random.PRNGKey(2)
    want = np.asarray(_masked_uniform_choice(key, jnp.asarray(mask)))
    got = masked_uniform_choice(_t(mask), _t(_gumbel(key, mask.shape)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[0] == want[2] == 0 and want[1] in (2, 5)
