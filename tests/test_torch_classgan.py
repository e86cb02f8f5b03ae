"""Port parity of the class-conditional GAN trainer
(ccdm_tpu_torch/training/classgan.py) against ccdm_tpu's.

One module-scoped JAX run for each conditional loss: a ClassGANTrainer
with SNGAN G and D at width 4 (dim_z 16) at 64x64, 3 classes, batch 8,
its jitted d_step and then g_step (D2D-CE with DiffAugment, ADC without).
The port's trainer starts from the JAX trainer's state (the head's
PRNGKey(seed + 5) init included) through
utils/convert.classgan_state_from_jax, and takes JAX's draws, re-derived
from the step keys with JAX's split order. Tolerances, each with its
reason:
- the D2D-CE and ADC losses and the heads' forwards on given inputs: 1e-6
  (f32 reductions in another order);
- the step losses: 1e-5 relative (f32 convs in another framework); the G
  step starts from JAX's state after its D step, carried across again;
- every statistic the steps move (netG's BatchNorm in the D step's
  train-mode fakes and again in the G step, netD's spectral norms' u and
  sigma at its two train forwards): 1e-5;
- the parameters after one Adam(0.5, 0.999) step each by the rule of
  tests/test_torch_eval_train.py (tests/test_torch_dmd.py's _assert_adamw:
  every element within 2 lr, each leaf's mean error within 0.1 of its mean
  movement where its gradient is not ~0);
- train's cadence (log, grid, milestone) and sample_given_classes'
  padding: the same files and shapes as JAX's.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ccdm_tpu.data.datasets import make_synthetic
from ccdm_tpu.models.sngan import SNGANDiscriminator as JaxD
from ccdm_tpu.models.sngan import SNGANGenerator as JaxG
from ccdm_tpu.training import classgan as jclassgan
from ccdm_tpu_torch.models.sngan import SNGANDiscriminator, SNGANGenerator
from ccdm_tpu_torch.training import classgan
from ccdm_tpu_torch.training.dmd import stats_of
from ccdm_tpu_torch.utils.convert import (
    classgan_state_from_jax,
    gan_state_dict_from_jax,
    state_dict_from_jax,
)
from tests.test_torch_dmd import LR, _assert_adamw, _draw_tree, _init_shapes
from tests.test_torch_gan import _jax_aug_draws, _t

torch.set_num_threads(2)

B, SIZE, NC, DIM_Z, C = 8, 64, 1, 16, 3
POLICY = "color,translation,cutout"


def _classes(labels):
    return np.searchsorted(np.sort(np.unique(labels))[[10, 20]], labels).astype(np.int64)


class _Setup:
    """The JAX trainer and the port's, on the same data, weights and head."""

    def __init__(self, tmp, cond_loss, diffaug):
        self.bundle = make_synthetic(n=48, image_size=SIZE, channels=NC)
        self.classes = _classes(self.bundle.labels_raw)
        kw = dict(num_classes=C, niters=1, batch_size=B, dim_z=DIM_Z, cond_loss=cond_loss,
                  lr_g=LR, lr_d=LR, use_DiffAugment=diffaug, log_every=10 ** 9,
                  visualize_freq=10 ** 9, save_niters_freq=10 ** 9, seed=3)
        self.jcfg = jclassgan.ClassGANConfig(**kw, results_folder=str(tmp / "jax"))
        self.pcfg = classgan.ClassGANConfig(**kw, results_folder=str(tmp / "port"))
        jG, jD = JaxG(dim_embed=C, dim_z=DIM_Z, nc=NC, img_size=SIZE, gene_ch=4), \
            JaxD(dim_embed=C, nc=NC, img_size=SIZE, disc_ch=4)
        gv = _draw_tree(_init_shapes(jG, jnp.zeros((2, DIM_Z)), jnp.zeros((2, C))), 12)
        dv = _draw_tree(_init_shapes(jD, jnp.zeros((2, SIZE, SIZE, NC)), jnp.zeros((2, C))), 13)
        self.jax = jclassgan.ClassGANTrainer(jG, jD, gv, dv, self.bundle.images, self.classes,
                                             self.jcfg)
        self.state0 = jax.device_get(self.jax.state)
        netG = SNGANGenerator(dim_embed=C, dim_z=DIM_Z, nc=NC, img_size=SIZE, gene_ch=4)
        netD = SNGANDiscriminator(dim_embed=C, nc=NC, img_size=SIZE, disc_ch=4)
        self.port = classgan.ClassGANTrainer(netG, netD, self.bundle.images, self.classes,
                                             self.pcfg, device="cpu")
        self.port.load_tree(self.convert(self.state0))

    def convert(self, state):
        p = self.port
        return classgan_state_from_jax(state, p.netG, p.netD, p.head)


def d_draws(tr, key):
    k_idx, k_cf, k_z, k_a1, k_a2 = jax.random.split(key, 5)
    return {"idx": _t(jax.random.randint(k_idx, (B,), 0, tr.n)),
            "cls_fake": _t(jax.random.randint(k_cf, (B,), 0, C)),
            "z": _t(jax.random.normal(k_z, (B, DIM_Z))),
            "aug_real": _jax_aug_draws(k_a1, B, SIZE, SIZE, POLICY),
            "aug_fake": _jax_aug_draws(k_a2, B, SIZE, SIZE, POLICY)}


def g_draws(key):
    k_cf, k_z, k_a = jax.random.split(key, 3)
    return {"cls_fake": _t(jax.random.randint(k_cf, (B,), 0, C)),
            "z": _t(jax.random.normal(k_z, (B, DIM_Z))),
            "aug": _jax_aug_draws(k_a, B, SIZE, SIZE, POLICY)}


@pytest.fixture(scope="module", params=[("d2dce", True), ("adc", False)],
                ids=["d2dce_diffaugment", "adc"])
def run(request, tmp_path_factory):
    """Both trainers after one d_step, then one g_step."""
    cond_loss, diffaug = request.param
    setup = _Setup(tmp_path_factory.mktemp(cond_loss), cond_loss, diffaug)
    jtr, port = setup.jax, setup.port
    d_step, g_step = jtr._build_steps()
    kd, kg = jax.random.PRNGKey(11), jax.random.PRNGKey(12)
    state_d, jd = d_step(jtr.state, kd)
    state_d = jax.device_get(state_d)
    pd = port.d_step(draws=d_draws(jtr, kd))
    after_d = {"g_stats": [t.clone() for t in stats_of(port.netG)],
               "d_stats": [t.clone() for t in stats_of(port.netD)],
               "d_params": [p.detach().clone() for p in port.d_params]}
    port.load_tree(setup.convert(state_d))
    pg = port.g_step(draws=g_draws(kg))
    state_g, jg = g_step(jax.tree_util.tree_map(jnp.asarray, state_d), kg)
    jtr._steps = (d_step, g_step)
    jtr.state = jax.tree_util.tree_map(jnp.asarray, jax.device_get(state_g))
    return dict(setup=setup, jd=float(jd), pd=float(pd), jg=float(jg), pg=float(pg),
                state_d=state_d, state_g=jax.device_get(jtr.state), after_d=after_d,
                cond_loss=cond_loss)


def test_losses_of_one_d_step_and_one_g_step(run):
    np.testing.assert_allclose([run["pd"], run["pg"]], [run["jd"], run["jg"]], rtol=1e-5,
                               atol=1e-6)
    assert np.isfinite([run["jd"], run["jg"]]).all()


def _stats_tree(model, params, stats):
    sd = gan_state_dict_from_jax({"params": params, "batch_stats": stats}, model)
    return [(n, sd[n].numpy()) for n, b in model.named_buffers() if b.is_floating_point()]


def _assert_stats(got, model, params, stats):
    want = _stats_tree(model, params, stats)
    assert len(got) == len(want)
    for (name, w), g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5, err_msg=name)


def test_statistics_after_the_steps(run):
    """The D step's train-mode fakes move netG's BatchNorm statistics (as
    JAX's test_dmd_ccgan asserts), netD's u and sigma move at its train
    forwards; the G step moves netG's again and leaves netD's."""
    port, s0 = run["setup"].port, run["setup"].state0
    sd, sg = run["state_d"], run["state_g"]
    _assert_stats(run["after_d"]["g_stats"], port.netG, sd["g_params"], sd["g_stats"])
    _assert_stats(run["after_d"]["d_stats"], port.netD, sd["d_params"]["d"], sd["d_stats"])
    _assert_stats(stats_of(port.netG), port.netG, sg["g_params"], sg["g_stats"])
    _assert_stats(stats_of(port.netD), port.netD, sg["d_params"]["d"], sg["d_stats"])
    moved = lambda a, b: max(np.abs(x - y).max() for (_, x), (_, y) in zip(a, b))
    assert moved(_stats_tree(port.netG, s0["g_params"], s0["g_stats"]),
                 _stats_tree(port.netG, sd["g_params"], sd["g_stats"])) > 1e-3
    assert moved(_stats_tree(port.netD, sd["d_params"]["d"], sd["d_stats"]),
                 _stats_tree(port.netD, sg["d_params"]["d"], sg["d_stats"])) == 0


def test_parameters_after_adam(run):
    """D and the head after the D step, G after the G step; the Adam
    counts."""
    from ccdm_tpu_torch.utils.convert import _adam_state

    port, s0, sd, sg = run["setup"].port, run["setup"].state0, run["state_d"], run["state_g"]
    conv = lambda p, bs, m: gan_state_dict_from_jax({"params": p, "batch_stats": bs}, m)
    n_d = len(list(port.netD.parameters()))
    mu_d = _adam_state(sd["d_opt"]).mu
    _assert_adamw(run["after_d"]["d_params"][:n_d], port.netD,
                  conv(s0["d_params"]["d"], s0["d_stats"], port.netD),
                  conv(sd["d_params"]["d"], sd["d_stats"], port.netD),
                  conv(mu_d["d"], sd["d_stats"], port.netD))
    hconv = lambda p: state_dict_from_jax({"params": p}, port.head)
    _assert_adamw(run["after_d"]["d_params"][n_d:], port.head, hconv(s0["d_params"]["head"]),
                  hconv(sd["d_params"]["head"]), hconv(mu_d["head"]))
    _assert_adamw(list(port.netG.parameters()), port.netG,
                  conv(sd["g_params"], sd["g_stats"], port.netG),
                  conv(sg["g_params"], sg["g_stats"], port.netG),
                  conv(_adam_state(sg["g_opt"]).mu, sg["g_stats"], port.netG))
    assert port.g_opt.count == 1 and port.d_opt.count == 1


def test_the_head_is_jaxs_init(run):
    """The head holds JAX's PRNGKey(seed + 5) draw after the conversion and
    computes its forward within 1e-6."""
    setup = run["setup"]
    head, jhead = setup.port.head, setup.jax.head
    phi = np.random.default_rng(2).normal(size=(5, head_in(head))).astype(np.float32)
    want = jhead.apply({"params": run["state_d"]["d_params"]["head"]}, phi)
    setup.port.load_tree(setup.convert(run["state_d"]))
    with torch.no_grad():
        got = head(_t(phi))
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


def head_in(head) -> int:
    layer = head.embed if isinstance(head, classgan.D2DCEHead) else head.adc
    return layer.in_features


def test_train_cadence_and_sampling_are_jaxs(run, tmp_path):
    """4 iterations at log_every 2, visualize_freq 2 and save_niters_freq 3:
    the same log steps, grids and milestones; sample_given_classes pads
    with the first classes and returns uint8 [n, H, W, C]."""
    setup = run["setup"]
    if run["cond_loss"] != "d2dce":
        pytest.skip("the cadence is the trainer's, held once")
    out = {}
    for name, tr in (("jax", setup.jax), ("port", setup.port)):
        folder = tmp_path / name
        tr.cfg.results_folder, tr.cfg.niters = str(folder), 4
        tr.cfg.log_every, tr.cfg.visualize_freq, tr.cfg.save_niters_freq = 2, 2, 3
        os.makedirs(folder, exist_ok=True)
        tr.train(progress=False)
        log = [json.loads(line)["step"] for line in open(folder / "train_log.jsonl")]
        grids = sorted(p for p in os.listdir(folder) if p.endswith(".png"))
        milestones = sorted(p for p in os.listdir(folder) if p.startswith("model-"))
        out[name] = log, grids, milestones
    assert out["port"] == out["jax"]
    assert out["port"][2] == ["model-classgan-3", "model-classgan-4"]
    classes = np.array([2, 0, 1, 1, 2])
    want = setup.jax.sample_given_classes(classes, batch_size=3)
    got = setup.port.sample_given_classes(classes, batch_size=3)
    assert got.shape == want.shape == (5, SIZE, SIZE, NC) and got.dtype == want.dtype == np.uint8
    again = setup.port.sample_given_classes(classes, batch_size=3)
    np.testing.assert_array_equal(got, again)


def test_checkpoint_round_trip(run, tmp_path):
    port = run["setup"].port
    port.cfg.results_folder = str(tmp_path)
    port.save(7)
    tree = port.checkpoint_tree()
    with torch.no_grad():
        for p in port.d_params + port.g_params:
            p.add_(1.0)
    port.step = 0
    port.load(7)
    for a, b in zip(port.checkpoint_tree()["d_params"]["head"], tree["d_params"]["head"]):
        assert torch.equal(a, b)
    assert port.step == tree["step"] and port.d_opt.count == tree["d_opt"]["count"]


# ------------------------------------------------------------ the losses


def test_d2d_ce_and_adc_losses_are_jaxs():
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(8, 16)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    proxies = rng.normal(size=(C, 16)).astype(np.float32)
    proxies /= np.linalg.norm(proxies, axis=1, keepdims=True)
    labels = np.array([0, 1, 2, 0, 0, 1, 2, 2])
    lr_, lf_ = (rng.normal(size=(8, 2 * C)).astype(np.float32) for _ in range(2))
    lf_labels = np.array([1, 1, 0, 2, 0, 2, 1, 0])
    for kw in ({}, {"temperature": 0.1, "m_p": 0.5, "m_n": 0.2}):
        np.testing.assert_allclose(
            float(classgan.d2d_ce_loss(_t(emb), _t(proxies), _t(labels), **kw)),
            float(jclassgan.d2d_ce_loss(emb, proxies, labels, **kw)), rtol=1e-6)
    np.testing.assert_allclose(
        float(classgan.adc_d_loss(_t(lr_), _t(lf_), _t(labels), _t(lf_labels), C)),
        float(jclassgan.adc_d_loss(lr_, lf_, labels, lf_labels, C)), rtol=1e-6)
    np.testing.assert_allclose(float(classgan.adc_g_loss(_t(lf_), _t(lf_labels), C)),
                               float(jclassgan.adc_g_loss(lf_, lf_labels, C)), rtol=1e-6)
    # a batch of one class has no negatives: the loss is logz - pos = 0
    same = np.zeros(8, np.int64)
    np.testing.assert_allclose(float(classgan.d2d_ce_loss(_t(emb), _t(proxies), _t(same))),
                               float(jclassgan.d2d_ce_loss(emb, proxies, same)), atol=1e-7)
