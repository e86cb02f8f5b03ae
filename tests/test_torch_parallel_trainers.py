"""One step of each of the port's four trainers on two gloo ranks against
JAX's step on its 8-device mesh (tests/conftest.py) and the port's
one-process step, on the same weights and draws.

The cases: the diffusion Trainer with the hv vicinity (pred_x0) and with
the elastic aux term (pred_noise, hv), UNet dim 8 mults (1, 2) at 16x16,
batch 8; DMD2-M's g_step and d_step, CcGAN's d_step with Dual-NDA b and c
and its g_step, StudioGAN's D2D-CE d_step and g_step, each at the
configuration and on the JAX draws of its one-process test
(tests/test_torch_{dmd,ccgan,classgan}.py). One module-scoped group of two
ranks (tests/torch_ranks.py) runs every case; the JAX steps run in this
process. Tolerances, each with its reason:
- the step losses (and the aux term) against JAX's: 1e-5 relative, the
  one-process tests' bound (f32 convs in another framework); against the
  port's one-process step 1e-5 too: a rank's convs on half the batch and
  the BatchNorm statistics summed over the ranks round differently;
- the diffusion gradients against JAX's: each leaf within 1e-3 of its
  largest |g| (tests/test_torch_train.py's bound), the two biases that
  feed a train-mode BatchNorm within 1e-3 of the model's largest;
- the statistics the steps move (BatchNorm running statistics, spectral
  norms' u and sigma) against JAX's and the one-process port's: 1e-5;
- the parameters after Adam or AdamW by tests/test_torch_dmd.py's
  _assert_adamw rule (every element within 2 lr, each leaf's mean error
  within 0.1 of its movement), against JAX's and the one-process port's;
- across the two ranks: parameters, statistics, optimizer moments and the
  EMA bit for bit (the gradients are summed in one all-reduce, the
  BatchNorm sums in another, so both ranks hold the same bits);
- the milestone rank 0 wrote loads into a one-process Trainer, exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ccdm_tpu.data.datasets import make_synthetic
from ccdm_tpu.diffusion import DiffusionConfig as JaxDiffusionConfig
from ccdm_tpu.diffusion import GaussianDiffusion as JaxGaussianDiffusion
from ccdm_tpu.models import Unet as JaxUnet
from ccdm_tpu.training import Trainer as JaxTrainer
from ccdm_tpu.training import TrainerConfig as JaxTrainerConfig
from ccdm_tpu.training.vicinity import _gumbel
from ccdm_tpu_torch.diffusion.gaussian import DiffusionConfig, GaussianDiffusion
from ccdm_tpu_torch.models.unet import Unet
from ccdm_tpu_torch.parallel.mesh import Mesh
from ccdm_tpu_torch.training.trainer import Trainer, TrainerConfig
from ccdm_tpu_torch.utils.convert import dmd_state_from_jax, unet_state_dict_from_jax
from tests import test_torch_ccgan as tccgan
from tests import test_torch_classgan as tclassgan
from tests import test_torch_dmd as tdmd
from tests import torch_ranks
from tests.test_torch_train import BN_FED_BIASES, _jax_variables, _loss_draws, _recording_tx

torch.set_num_threads(2)

UNET = dict(dim=8, dim_mults=(1, 2), in_channels=3)
B, SIZE, T = 8, 16, 100


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------ the cases


def _unet_case(tmp, name, aux):
    """The JAX Trainer's gradients and loss at PRNGKey(9), and the port's
    payload: the same weights and the step's JAX draws."""
    bundle = make_synthetic(n=32, image_size=SIZE, channels=3, seed=1)
    variables = _jax_variables(SIZE, seed=4)
    kw = dict(image_size=SIZE, channels=3, timesteps=T,
              objective="pred_noise" if aux else "pred_x0", vicinity_type="hv",
              cond_drop_prob=0.5)
    tkw = dict(data_name="synthetic", train_batch_size=B, vicinity_type="hv", kappa=0.05)
    # the label embedding: sin(y W), W ~ N(0, 30^2), so that a batch's
    # embeddings differ enough for the conditioning BatchNorm's
    # mean(x^2) - mean(x)^2 to keep its digits (the sinusoidal embedding of
    # labels in [0, 1] varies little across a batch, and any two reduction
    # orders of that cancellation, JAX's among them, then part at ~1e-4)
    w = np.random.default_rng(7).normal(0, 30, (1, 128)).astype(np.float32)
    jaux = {"apply": lambda x, t: jnp.mean(x, axis=(1, 2, 3))[:, None] * 3.0 + 0.5,
            "lambda_aux": 0.5, "aux_start_step": 0} if aux else None
    jtr = JaxTrainer(JaxGaussianDiffusion(JaxUnet(**UNET).apply, JaxDiffusionConfig(**kw)),
                     variables, bundle.images, bundle.labels_norm,
                     JaxTrainerConfig(results_folder=str(tmp / "jax"), **tkw), aux_info=jaux)
    jtr.tx = _recording_tx()
    jtr.state = jtr.state.replace(opt_state=jtr.tx.init(jtr.state.params))
    key = jax.random.PRNGKey(9)
    new_state, jloss = jtr._build_train_step(lambda y: jnp.sin(y @ w))(jtr.state, key)
    (k,) = jax.random.split(key, 1)
    k_batch, k_loss = jax.random.split(k)
    k_target, k_select, _ = jax.random.split(k_batch, 3)
    k_pick, k_noise = jax.random.split(k_target)
    draws = {"target_idx": _t(jax.random.randint(k_pick, (B,), 0, jtr.unique_labels.shape[0])),
             "target_eps": _t(jax.random.normal(k_noise, (B, 1))),
             "gumbel": _t(_gumbel(k_select, (B, len(bundle.images))))}
    draws.update(_loss_draws(k_loss, B, (B, SIZE, SIZE, 3), 0.5, T))
    model = Unet(**UNET)
    payload = {"unet": UNET, "state_dict": unet_state_dict_from_jax(variables, model),
               "diffusion": kw, "trainer": {**tkw, "results_folder": str(tmp / name)},
               "images": bundle.images, "labels": bundle.labels_norm, "draws": [draws],
               "aux": aux, "y2h": torch.from_numpy(w)}
    want = unet_state_dict_from_jax({"params": jax.device_get(new_state.opt_state),
                                     "batch_stats": jax.device_get(new_state.batch_stats)},
                                    model)
    return payload, {"loss": float(jloss), "grads": want}


def _dmd_case(tmp):
    setup = tdmd._Setup(tmp, adv_loss_type="vanilla", kappa=None, use_Hy=True)
    jtr, port = setup.jax, setup.port
    g_step, d_step = jtr._build_steps()
    kg, kd = jax.random.PRNGKey(11), jax.random.PRNGKey(12)
    state_g, jg = g_step(jtr.state, kg)
    state_g = jax.device_get(state_g)
    state_d, jd = d_step(jax.tree_util.tree_map(jnp.asarray, state_g), kd)
    conv = lambda s: dmd_state_from_jax(s, port.netG, port.netD, port.fake_unet)
    payload = {"nc": tdmd.NC, "size": tdmd.SIZE, "unet": dict(dim=8, dim_mults=(1, 2),
                                                              in_channels=tdmd.NC),
               "teacher": port.teacher.state_dict(),
               "netG": dict(dim_z=tdmd.DIM_Z, nc=tdmd.NC, img_size=tdmd.SIZE, gene_ch=4),
               "netD": dict(nc=tdmd.NC, img_size=tdmd.SIZE, disc_ch=4),
               "images": setup.bundle.images, "labels": setup.bundle.labels_norm,
               "cfg": {**tdmd.CFG, "adv_loss_type": "vanilla", "kappa": None, "use_Hy": True,
                       "results_folder": str(tmp / "port")},
               "state0": conv(setup.state0), "state_g": conv(state_g),
               "g_draws": tdmd.g_draws(jtr, kg), "d_draws": tdmd.d_draws(jtr, kd)}
    return payload, {"g": [float(v) for v in jg], "d": [float(v) for v in jd],
                     "state_g": state_g, "state_d": jax.device_get(state_d), "setup": setup}


def _gan_case(tmp, mod, name, setup_args, nets):
    """JAX's d_step then g_step of the one-process test's setup (`mod`), and
    the port's payload: the nets' kwargs, the data, the states the steps
    start from and the steps' JAX draws."""
    setup = mod._Setup(tmp, *setup_args)
    jtr = setup.jax
    steps = jtr._build_steps()
    d_step, g_step = (steps[1], steps[2]) if mod is tccgan else steps
    kd, kg = ((jax.random.PRNGKey(31), jax.random.PRNGKey(32)) if mod is tccgan
              else (jax.random.PRNGKey(11), jax.random.PRNGKey(12)))
    state_d, jd = d_step(jtr.state, kd)
    state_d = jax.device_get(dict(state_d))
    state_g, jg = g_step(jax.tree_util.tree_map(jnp.asarray, state_d), kg)
    payload = {**nets, "images": setup.bundle.images,
               "cfg": {**{k: getattr(setup.pcfg, k) for k in setup.pcfg.__dataclass_fields__},
                       "results_folder": str(tmp / name)},
               "state0": setup.convert(setup.state0), "state_d": setup.convert(state_d),
               "d_draws": mod.d_draws(jtr, kd),
               "g_draws": mod.g_draws(jtr, kg) if mod is tccgan else mod.g_draws(kg)}
    if mod is tccgan:
        payload.update(labels=setup.bundle.labels_norm, banks=setup.banks)
    else:
        payload["classes"] = setup.classes
    return payload, {"d": float(jd), "g": float(jg), "state_d": state_d,
                     "state_g": jax.device_get(dict(state_g)), "setup": setup}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{case: {"jax": JAX's result, "one": the port's one-process result,
    "ranks": the two ranks' results, "payload": the port's inputs}}."""
    tmp = tmp_path_factory.mktemp("parallel_trainers")
    jax_out, payload = {}, {}
    for name, aux in (("unet_hv", False), ("unet_aux", True)):
        p, jax_out[name] = _unet_case(tmp, name, aux)
        payload[name] = ("unet_case", p)
    p, jax_out["dmd"] = _dmd_case(tmp / "dmd")
    payload["dmd"] = ("dmd_case", p)
    sngan = lambda **kw: dict(nc=tccgan.NC, img_size=tccgan.SIZE, **kw)
    p, jax_out["ccgan"] = _gan_case(
        tmp / "ccgan", tccgan, "ccgan", ("hard_hinge_nda_bc",),
        {"netG": sngan(dim_z=tccgan.DIM, gene_ch=4), "netD": sngan(disc_ch=4)})
    payload["ccgan"] = ("ccgan_case", p)
    c = tclassgan.C
    p, jax_out["classgan"] = _gan_case(
        tmp / "classgan", tclassgan, "classgan", ("d2dce", True),
        {"netG": dict(dim_embed=c, dim_z=tclassgan.DIM_Z, nc=tclassgan.NC,
                      img_size=tclassgan.SIZE, gene_ch=4),
         "netD": dict(dim_embed=c, nc=tclassgan.NC, img_size=tclassgan.SIZE, disc_ch=4)})
    payload["classgan"] = ("classgan_case", p)

    ranks = torch_ranks.spawn(torch_ranks.run_cases, payload, tmp / "ranks")
    out = {}
    for name, (fn, p) in payload.items():
        q = dict(p)
        key = "trainer" if "trainer" in q else "cfg"
        q[key] = {**q[key], "results_folder": str(tmp / f"{name}_one")}
        out[name] = {"jax": jax_out[name], "one": getattr(torch_ranks, fn)(Mesh(), q),
                     "ranks": [r[name] for r in ranks], "payload": p}
    return out


# ------------------------------------------------------------ the checks


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flat(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _flat_params(tree):
    """A parameter tree's lists in the optimizer's order ({"d", "head"})."""
    if isinstance(tree, dict):
        return [t for k in ("d", "head") for t in tree[k]]
    return list(tree)


def _assert_ranks_equal(a, b):
    ta, tb = _flat(a), _flat(b)
    assert ta and len(ta) == len(tb)
    for x, y in zip(ta, tb):
        assert torch.equal(x, y)


def _assert_adam(got, init, want, moments, lr, what=""):
    """tests/test_torch_dmd.py's _assert_adamw on lists of tensors: every
    element within 2 lr, and each leaf's mean error within 0.1 of its mean
    movement where its first moment is at least 1e-4 of the list's largest
    (elsewhere the gradient is ~0 and its sign is rounding)."""
    assert len(got) == len(init) == len(want) == len(moments) > 0, what
    arr = lambda t: np.asarray(torch.as_tensor(t).detach(), np.float64)
    largest = max(np.abs(arr(m)).max() for m in moments)
    checked = 0
    for i, (g, p0, w, m) in enumerate(zip(got, init, want, moments)):
        g, p0, w = arr(g), arr(p0), arr(w)
        err = np.abs(g - w)
        assert err.max() <= 2 * lr * (1 + 1e-3), f"{what}[{i}] {err.max()}"
        if np.abs(arr(m)).max() >= 1e-4 * largest:
            assert err.mean() <= 0.1 * np.abs(w - p0).mean(), f"{what}[{i}]"
            checked += 1
    assert checked >= len(got) // 2, what


def _assert_close(got, want, what, tol=1e-5):
    assert len(got) == len(want) > 0, what
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(np.asarray(torch.as_tensor(g)), np.asarray(
            torch.as_tensor(w)), rtol=tol, atol=tol, err_msg=f"{what}[{i}]")


def _assert_tree(got: dict, want: dict, start: dict, lr: float, what: str):
    """Parameters by the Adam rule (moved from `start`, the first moments
    read off `want`'s optimizer state), statistics within 1e-5."""
    for key in want:
        if key.endswith("params"):
            opt = want[key.replace("params", "opt")]["mu"]
            g, w, s0 = got[key], want[key], start[key]
            if isinstance(w, dict):
                at = 0
                for sub in w:  # the optimizer's moments run over the sub-trees in order
                    n = len(w[sub])
                    _assert_adam(g[sub], s0[sub], w[sub], opt[at:at + n], lr,
                                 f"{what} {key}/{sub}")
                    at += n
            else:
                _assert_adam(g, s0, w, opt, lr, f"{what} {key}")
        elif key.endswith("stats"):
            _assert_close(got[key], want[key], f"{what} {key}")


@pytest.mark.parametrize("name", ["unet_hv", "unet_aux"])
def test_diffusion_step_on_two_ranks(runs, name):
    run = runs[name]
    jx, one, (r0, r1), p = run["jax"], run["one"], run["ranks"], run["payload"]
    _assert_ranks_equal(r0, r1)
    np.testing.assert_allclose(r0["loss"], jx["loss"], rtol=1e-5)
    np.testing.assert_allclose(r0["loss"], one["loss"], rtol=1e-5)
    if name == "unet_aux":  # the global denominator of the elastic term
        assert r0["aux"] > 0
        np.testing.assert_allclose(r0["aux"], one["aux"], rtol=1e-5)
    names = [n for n, _ in Unet(**UNET).named_parameters()]
    want = jx["grads"]
    largest = max(float(want[n].abs().max()) for n in names)
    for n, g, g1 in zip(names, r0["grads"], one["grads"]):
        scale = largest if n in BN_FED_BIASES else float(want[n].abs().max())
        for other in (want[n], g1):
            np.testing.assert_allclose(g.numpy(), other.numpy(), rtol=0, atol=1e-3 * scale,
                                       err_msg=n)
    _assert_adam(r0["params"], [p["state_dict"][n] for n in names], one["params"], one["mu"],
                 1e-4, "params")
    floats = lambda bs: [b for b in bs if b.is_floating_point()]
    _assert_close(floats(r0["buffers"]), floats(one["buffers"]), "BatchNorm statistics")


def test_two_rank_milestone_loads_in_one_process(runs):
    """Rank 0 wrote milestone 1; a one-process Trainer loads it exactly."""
    run = runs["unet_hv"]
    p, r0 = run["payload"], run["ranks"][0]
    model = Unet(**UNET)
    tr = Trainer(GaussianDiffusion(model, DiffusionConfig(**p["diffusion"])), p["images"],
                 p["labels"], TrainerConfig(**p["trainer"]), mesh=Mesh())
    tr.load(1)
    assert tr.state.step == 1
    for got, want in zip(list(tr.state.model.parameters()) + list(tr.state.model.buffers()),
                         r0["params"] + r0["buffers"]):
        assert torch.equal(got.detach(), want)


def test_dmd_steps_on_two_ranks(runs):
    run = runs["dmd"]
    jx, one, (r0, r1), p = run["jax"], run["one"], run["ranks"], run["payload"]
    _assert_ranks_equal(r0, r1)
    for got in (r0, one):
        np.testing.assert_allclose(r0["g"], got["g"], rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(r0["d"], got["d"], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(r0["g"], jx["g"], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(r0["d"], jx["d"], rtol=1e-5, atol=1e-7)
    _assert_close(r0["after_g"]["gen_stats"], one["after_g"]["gen_stats"], "G step stats")
    _assert_adam(r0["after_g"]["gen_params"], p["state0"]["gen_params"],
                 one["after_g"]["gen_params"], one["after_g"]["gen_mu"], tdmd.LR,
                 "G step params")
    s = jx["setup"]
    want = dmd_state_from_jax(jx["state_d"], s.port.netG, s.port.netD, s.port.fake_unet)
    _assert_tree(r0["tree"], want, p["state_g"], tdmd.LR, "D step vs JAX")
    _assert_tree(r0["tree"], one["tree"], p["state_g"], tdmd.LR, "D step vs one process")


@pytest.mark.parametrize("name", ["ccgan", "classgan"])
def test_gan_steps_on_two_ranks(runs, name):
    """CcGAN (ConditionalBatchNorm's global statistics, Dual-NDA b and c)
    and StudioGAN (the D2D-CE head on the gathered features)."""
    run = runs[name]
    jx, one, (r0, r1), p = run["jax"], run["one"], run["ranks"], run["payload"]
    _assert_ranks_equal(r0, r1)
    for other in (jx, one):
        np.testing.assert_allclose([r0["d"], r0["g"]], [other["d"], other["g"]], rtol=1e-5,
                                   atol=1e-6)
    for key in ("g_stats", "d_stats"):
        _assert_close(r0["after_d"][key], one["after_d"][key], f"D step {key}")
    _assert_adam(r0["after_d"]["d_params"], _flat_params(p["state0"]["d_params"]),
                 one["after_d"]["d_params"], one["after_d"]["d_mu"], tdmd.LR, "D step params")
    want = jx["setup"].convert(jx["state_g"])
    _assert_tree(r0["tree"], want, p["state_d"], tdmd.LR, "G step vs JAX")
    _assert_tree(r0["tree"], one["tree"], p["state_d"], tdmd.LR, "G step vs one process")
