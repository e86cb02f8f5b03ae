"""Port parity of respacing, the loss-aware timestep sampler, classifier
guidance, the class table and the KV logger against ccdm_tpu
(diffusion/respace.py, training/resample.py, diffusion/guided.py,
utils/kvlogger.py).

Tolerances, each with its reason:
- space_timesteps, bin_labels, update_with_losses (history and counts,
  duplicate t's in one batch included) and the sampled t: exact (index
  and integer logic; the losses are copied, not computed);
- the respaced schedule: 1e-6 (f64 numpy arithmetic on the same f32
  alphas_cumprod, stored as f32);
- loss_aware_weights and the importance weights: 1e-6 (f32 reductions in
  another order);
- classifier_grad_fn: 1e-5 of the largest |g| (a NoisyClassifier and a
  ResNetEval, cut to one block a stage, forward and backward in f32 in
  another framework);
- classifier_guided_sample from JAX's draws with a tiny f32 UNet and
  NoisyClassifier: 1e-4 ([0, 1] images after 5 guided ancestral steps; the
  gradient term enters each step's mean);
- the class table: JAX's draw carried as data, its rows exact;
- KVLogger: the same files with the same contents but the wall clock.
"""

import csv
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ccdm_tpu.diffusion import guided as jguided
from ccdm_tpu.diffusion import respace as jrespace
from ccdm_tpu.eval import backbones as jbackbones
from ccdm_tpu.training import resample as jresample
from ccdm_tpu.utils.kvlogger import KVLogger as JaxKVLogger
from ccdm_tpu_torch.diffusion import guided, respace
from ccdm_tpu_torch.eval.backbones import NoisyClassifier, ResNetEval
from ccdm_tpu_torch.training import resample
from ccdm_tpu_torch.utils.convert import save_class_table_from_jax, state_dict_from_jax
from ccdm_tpu_torch.utils.kvlogger import KVLogger
from tests.test_torch_eval_backbones import _draw_variables
from tests.test_torch_sampling import _jax_draws, _jax_variables, _pair

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel_close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), max(np.abs(want).max(), 1e-30)
    assert err <= rel * scale, f"max abs diff {err:.3e} beyond {rel} x {scale:.3e}"


# ------------------------------------------------------------- respacing


@pytest.mark.parametrize("n,counts", [(1000, "ddim50"), (1000, "ddim250"), (100, "10"),
                                      (100, "10,15,20"), (1000, [3, 7, 11]), (20, [20]),
                                      (7, "1,1,1"), (10, [1])])
def test_space_timesteps_is_jaxs(n, counts):
    assert respace.space_timesteps(n, counts) == jrespace.space_timesteps(n, counts)


@pytest.mark.parametrize("n,counts", [(100, "ddim40"), (10, "6,6"), (10, [4, 4, 4])])
def test_space_timesteps_raises_where_jax_does(n, counts):
    with pytest.raises(ValueError) as want:
        jrespace.space_timesteps(n, counts)
    with pytest.raises(ValueError) as got:
        respace.space_timesteps(n, counts)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("sched,objective,use", [("cosine", "pred_x0", "ddim25"),
                                                 ("linear", "pred_noise", "10,5"),
                                                 ("cosine", "pred_v", [3, 1, 4])])
def test_respaced_schedule_is_jaxs(sched, objective, use):
    steps = respace.space_timesteps(100, use) if isinstance(use, str) else [20, 0, 55, 99]
    got, got_map = respace.make_respaced_schedule(100, sched, objective, steps)
    want, want_map = jrespace.make_respaced_schedule(100, sched, objective, steps)
    np.testing.assert_array_equal(got_map, want_map)
    assert got_map.dtype == np.int32 and got.num_timesteps == want.num_timesteps
    assert got.objective == want.objective
    for name in ("betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
                 "sqrt_one_minus_alphas_cumprod", "log_one_minus_alphas_cumprod",
                 "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod",
                 "posterior_variance", "posterior_log_variance_clipped",
                 "posterior_mean_coef1", "posterior_mean_coef2", "snr", "loss_weight"):
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-6, err_msg=name)


# -------------------------------------------------- the loss-aware sampler


T, K = 6, 3


def _batches(seed):
    """Batches of t with duplicates (three equal t's in one), and losses."""
    rng = np.random.default_rng(seed)
    ts = [np.array([2, 2, 0, 5, 2, 1], np.int32), rng.integers(0, T, 8).astype(np.int32)]
    ts += [np.arange(T, dtype=np.int32)] * 3 + [np.array([4, 4, 4, 4], np.int32)]
    return [(t, rng.uniform(0.1, 2.0, len(t)).astype(np.float32)) for t in ts]


def test_update_with_losses_and_weights_are_jaxs():
    """History and counts after each batch (the ring's slot rule, the rank
    within a run of equal t, the counts' cap at 2K) exactly; the weights,
    uniform until every t has K losses, within 1e-6 after each batch."""
    jstate = jresample.create_loss_aware_state(T, K, uniform_prob=0.05)
    state = resample.create_loss_aware_state(T, K, uniform_prob=0.05)
    warmed = False
    for t, losses in _batches(0):
        jstate = jax.jit(jresample.update_with_losses)(jstate, jnp.asarray(t),
                                                       jnp.asarray(losses))
        state = resample.update_with_losses(state, _t(t), _t(losses))
        np.testing.assert_array_equal(state.history.numpy(), np.asarray(jstate.history))
        np.testing.assert_array_equal(state.counts.numpy(), np.asarray(jstate.counts))
        want = np.asarray(jresample.loss_aware_weights(jstate))
        np.testing.assert_allclose(resample.loss_aware_weights(state).numpy(), want,
                                   rtol=1e-6, atol=1e-7)
        warmed |= bool(np.ptp(want) > 0)
    assert warmed and int(state.counts.max()) == 2 * K
    assert state.counts.dtype == torch.int32


def test_sample_timesteps_on_jaxs_gumbel():
    """t exact and importance weights 1e-6 on JAX's categorical draw (the
    argmax of log p plus its Gumbel noise), before and after warming."""
    jstate = jresample.create_loss_aware_state(T, K)
    state = resample.create_loss_aware_state(T, K)
    for i, (t, losses) in enumerate([(None, None)] + _batches(1)):
        if t is not None:
            jstate = jresample.update_with_losses(jstate, jnp.asarray(t), jnp.asarray(losses))
            state = resample.update_with_losses(state, _t(t), _t(losses))
        key = jax.random.PRNGKey(i)
        want_t, want_w = jresample.sample_timesteps(key, jstate, 64)
        g = jax.random.gumbel(key, (64, T))
        got_t, got_w = resample.sample_timesteps(state, 64, gumbel_noise=_t(g))
        np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
        np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), rtol=1e-6)
    got_t, _ = resample.sample_timesteps(state, 16, gen=torch.Generator().manual_seed(0))
    assert got_t.shape == (16,) and 0 <= int(got_t.min()) and int(got_t.max()) < T


# ------------------------------------------------------------ guidance


def test_bin_labels_is_jaxs():
    rng = np.random.default_rng(3)
    labels = np.concatenate([rng.uniform(-5, 95, 200), [0.0, 90.0, 45.0, -1.0, 91.0]])
    for classes in (1, 7, 49):
        np.testing.assert_array_equal(guided.bin_labels(labels, classes, 0.0, 90.0),
                                      jguided.bin_labels(labels, classes, 0.0, 90.0))


def test_class_table_is_jaxs_carried_as_data(tmp_path):
    """JAX draws the table from PRNGKey(seed) at every start; the converter
    writes that draw where the port reads it, and the port's embedding
    gives its rows; without the file the port draws and writes its own."""
    jfn = jguided.make_fn_class_embed(5, 128, seed=11)
    table = np.asarray(jax.random.normal(jax.random.PRNGKey(11), (5, 128)))
    save_class_table_from_jax(table, str(tmp_path), 5, 11)
    fn = guided.make_fn_class_embed(guided.class_table(str(tmp_path), 5, 128, 11))
    classes = np.array([4, 0, 2, 2, 1])
    np.testing.assert_array_equal(fn(_t(classes)).numpy(), np.asarray(jfn(classes)))
    own = guided.class_table(str(tmp_path / "fresh"), 5, 128, 11)
    assert torch.equal(own, guided.class_table(str(tmp_path / "fresh"), 5, 128, 11))
    guided.save_class_table(guided.class_table_path(str(tmp_path / "bad"), 5, 128, 1),
                            torch.zeros(4, 128))
    with pytest.raises(ValueError):
        guided.class_table(str(tmp_path / "bad"), 5, 128, 1)


def _noisy_pair(num_classes=3, channels=3, size=16, seed=4):
    """JAX's NoisyClassifier (one block a stage) and the port's on the
    same drawn weights."""
    jnet = jbackbones.NoisyClassifier(num_classes, num_blocks=(1, 1, 1, 1))
    shapes = jax.eval_shape(lambda k: jnet.init(k, jnp.zeros((2, size, size, channels)),
                                                jnp.zeros((2,), jnp.int32)),
                            jax.random.PRNGKey(0))
    v = _draw_variables(shapes, seed)
    net = NoisyClassifier(num_classes, num_blocks=(1, 1, 1, 1), in_channels=channels)
    net.load_state_dict(state_dict_from_jax(v, net))
    return jnet, v, net.eval()


@pytest.mark.parametrize("takes_t", [True, False])
def test_classifier_grad_fn_is_jaxs(takes_t):
    """grad_x of the gathered log-softmax: the NoisyClassifier with t, the
    clean ResNetEval (its (logits, features) output) without."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(4, 16, 16, 3)).astype(np.float32)
    t = np.array([0, 3, 9, 19], np.int32)
    y = np.array([2, 0, 1, 2])
    if takes_t:
        jnet, v, net = _noisy_pair()
        apply = lambda vv, xx, tt, train: jnet.apply(vv, xx, tt, train=train)
    else:
        jnet = jbackbones.ResNetEval(3, "class", num_blocks=(1, 1, 1, 1))
        shapes = jax.eval_shape(lambda k: jnet.init(k, jnp.zeros((2, 16, 16, 3))),
                                jax.random.PRNGKey(0))
        v = _draw_variables(shapes, 6)
        net = ResNetEval(3, "class", (1, 1, 1, 1), 3)
        net.load_state_dict(state_dict_from_jax(v, net))
        net.eval()
        apply = lambda vv, xx, train: jnet.apply(vv, xx, train=train)
    jfn = jguided.classifier_grad_fn(apply, v, takes_t=takes_t)
    want = np.asarray(jax.jit(jfn)(jnp.asarray(x), jnp.asarray(t), jnp.asarray(y)))
    got = guided.classifier_grad_fn(net, takes_t=takes_t)(_t(x), _t(t), _t(y))
    _rel_close(got.numpy(), want, 1e-5)
    assert np.abs(want).max() > 0
    # eval mode: the running statistics did not move
    stats = {k: b.clone() for k, b in net.named_buffers()}
    guided.classifier_grad_fn(net, takes_t=takes_t)(_t(x), _t(t), _t(y))
    assert all(torch.equal(b, stats[k]) for k, b in net.named_buffers())


def test_classifier_guided_sample_is_jaxs():
    """5 guided ancestral steps over the first 5 of T 20 with a tiny f32
    UNet and NoisyClassifier, from JAX's initial and step noise."""
    cfg = dict(image_size=16, channels=3, timesteps=20, objective="pred_x0")
    variables = _jax_variables(7)
    jdiff, diff = _pair(variables, **cfg)
    jnet, cv, net = _noisy_pair()
    jcond = jguided.classifier_grad_fn(
        lambda vv, xx, tt, train: jnet.apply(vv, xx, tt, train=train), cv, takes_t=True)
    rng = np.random.default_rng(8)
    emb = rng.normal(size=(2, 128)).astype(np.float32)
    classes = np.array([1, 2])
    key = jax.random.PRNGKey(21)
    want = np.asarray(jax.jit(lambda k, e, c: jguided.classifier_guided_sample(
        jdiff, variables, k, e, c, jcond, guidance_scale=2.0, sampling_timesteps=5))(
        key, jnp.asarray(emb), jnp.asarray(classes)))
    noise, step_noise = _jax_draws(key, (2, 16, 16, 3), 5)
    got = guided.classifier_guided_sample(diff, _t(emb), _t(classes),
                                          guided.classifier_grad_fn(net, takes_t=True),
                                          guidance_scale=2.0, sampling_timesteps=5,
                                          noise=_t(noise), step_noise=_t(step_noise))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    unguided = guided.classifier_guided_sample(diff, _t(emb), _t(classes),
                                               lambda x, t, y: torch.zeros_like(x),
                                               sampling_timesteps=5, noise=_t(noise),
                                               step_noise=_t(step_noise))
    assert float((got - unguided).abs().max()) > 1e-3  # the gradient term moved the chain


def test_guided_sample_walks_the_full_schedule_at_s_below_t():
    """S < T is not a respaced chain: the first step is t = S - 1 of the
    full schedule (JAX's ADM-G at 250 of 1000 steps starts at t = 249), as
    the model's recorded timesteps show."""
    diff = _pair(_jax_variables(7), image_size=16, channels=3, timesteps=20)[1]
    seen, forward = [], diff.model.forward

    def spy(x, t, *args, **kwargs):
        seen.append(int(t[0]))
        return forward(x, t, *args, **kwargs)

    diff.model.forward = spy
    guided.classifier_guided_sample(diff, torch.zeros(1, 128), torch.zeros(1, dtype=torch.long),
                                    lambda x, t, y: torch.zeros_like(x), sampling_timesteps=5,
                                    generator=torch.Generator().manual_seed(0))
    assert seen == [4, 3, 2, 1, 0]


# ------------------------------------------------------------- KVLogger


def test_kvlogger_writes_jaxs_files(tmp_path, capsys):
    calls = [[("loss", 1.5), ("loss", 0.5), ("step", 1)], [("grad", 2.0), ("step", 2)],
             [("loss", 3.0), ("step", 3)]]
    out = {}
    for name, cls in (("jax", JaxKVLogger), ("port", KVLogger)):
        logger = cls(str(tmp_path / name))
        dumps = []
        for kvs in calls:
            for k, v in kvs:
                logger.logkv_mean(k, v)
            dumps.append(logger.dumpkvs())
        text = capsys.readouterr().out
        out[name] = dumps, text, (tmp_path / name)
    (jd, jtext, jdir), (pd, ptext, pdir) = out["jax"], out["port"]
    strip = lambda d: {k: v for k, v in d.items() if k != "_wall_s"}
    assert [strip(d) for d in pd] == [strip(d) for d in jd]
    assert [ln for ln in ptext.splitlines() if "_wall_s" not in ln] == \
        [ln for ln in jtext.splitlines() if "_wall_s" not in ln]
    rows = lambda d: [{k: v for k, v in json.loads(line).items() if k != "_wall_s"}
                      for line in open(d / "progress.jsonl")]
    assert rows(pdir) == rows(jdir)
    table = lambda d: [{k: v for k, v in r.items() if k != "_wall_s"}
                       for r in csv.DictReader(open(d / "progress.csv"))]
    assert table(pdir) == table(jdir)
    assert open(pdir / "progress.csv").readline() == open(jdir / "progress.csv").readline()
