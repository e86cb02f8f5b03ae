"""Port parity of the ILI label embeddings (embedding/ili.py, models/resnet_embed.py).

Weights are drawn (numpy, from a seed) in the flax trees or taken from
JAX's own init, converted with utils/convert.state_dict_from_jax; JAX's
batch indices and label noise are re-derived from its keys (fold_in(
PRNGKey(seed), step), then split into index and noise keys) and handed to
the port's steps. Tolerances, each with its reason:
- ResNetEmbed (one block a stage, 16x16, dim_embed 16, batch 32)
  in train mode (outputs and the running statistics moved 10% towards the
  biased batch statistics) and in eval mode: 1e-5 of the largest |value|
  (f32 convs and train-mode BatchNorm in another framework; against an
  f64 forward both frameworks are ~1e-5 of the largest |h| off);
- ModelY2H, ModelY2Cov, one train_resnet_embed step, one step of each
  phase of train_label_mlp, a JAX cache carried across: 1e-5;
- the lr schedule and dataset_fingerprint: exact.
"""

import argparse
import importlib.util
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ccdm_tpu.embedding import ili as jili
from ccdm_tpu.models.resnet_embed import ModelY2Cov as JaxY2Cov
from ccdm_tpu.models.resnet_embed import ModelY2H as JaxY2H
from ccdm_tpu.models.resnet_embed import ResNetEmbed as JaxResNetEmbed
from ccdm_tpu.utils.ckpt import save_checkpoint as jax_save_checkpoint
from ccdm_tpu_torch.embedding import ili
from ccdm_tpu_torch.embedding.resolve import build_label_embedding
from ccdm_tpu_torch.models.resnet_embed import ModelY2Cov, ModelY2H, ResNetEmbed
from ccdm_tpu_torch.training import optim
from ccdm_tpu_torch.utils.ckpt import save_checkpoint
from ccdm_tpu_torch.utils.convert import state_dict_from_jax

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SMALL = (1, 1, 1, 1)
DIM = 16
MLP_DIM = 64  # GroupNorm(8) over 8 channels a group


def _draw_variables(shapes, seed):
    """Random variables in a flax tree of `shapes`: kernels scaled by
    1/sqrt(fan-in), biases, scales and BatchNorm statistics off their
    initial values."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = jax.tree_util.keystr(path), leaf.shape
        if len(shape) >= 2:
            a = rng.normal(0, 1 / np.sqrt(np.prod(shape[:-1])), shape)
        elif "var" in name:
            a = rng.uniform(0.5, 1.5, shape)
        elif "bias" in name or "mean" in name:
            a = rng.normal(0, 0.2, shape)
        else:
            a = 1 + rng.normal(0, 0.2, shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _resnet_variables(num_blocks, seed):
    net = JaxResNetEmbed(dim_embed=DIM, num_blocks=num_blocks)
    shapes = jax.eval_shape(lambda k: net.init(k, jnp.zeros((2, 16, 16, 3)), train=False),
                            jax.random.PRNGKey(0))
    return net, _draw_variables(shapes, seed)


def _port(module, variables):
    module.load_state_dict(state_dict_from_jax(variables, module))
    return module


def _close(got, want, rel=1e-5):
    """|got - want| <= rel x the largest |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), max(np.abs(want).max(), 1e-30)
    assert err <= rel * scale, f"max abs diff {err:.3e} beyond {rel} x {scale:.3e}"


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _moved(before, after) -> float:
    """The largest change of any leaf between two flax trees."""
    after = dict(_leaves(after))
    return max(float(np.abs(a - after[k]).max()) for k, a in _leaves(before))


def _assert_tree_matches(port_module, jax_variables, atol=1e-5):
    """Every leaf of `jax_variables` against the port's state_dict."""
    sd = state_dict_from_jax(jax_variables, port_module)
    got = port_module.state_dict()
    for key, want in sd.items():
        if key.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[key].detach().numpy(), want.numpy(), rtol=0, atol=atol,
                                   err_msg=key)


def _jit_init(cls):
    """`cls` whose init runs under jax.jit: the same values as an eager
    init, without compiling each of its ops on its own."""
    class JitInit(cls):
        def init(self, rngs, *args, **kwargs):
            return jax.jit(lambda r, *a: cls.init(self, r, *a, **kwargs))(rngs, *args)

    return JitInit


def _images(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, 16, 16, 3), dtype=np.uint8)


# --------------------------------------------------------------- modules


def test_resnet_embed_train_and_eval_match_jax():
    net, variables = _resnet_variables(SMALL, seed=0)
    x = np.random.default_rng(1).uniform(-1, 1, (32, 16, 16, 3)).astype(np.float32)
    apply = jax.jit(lambda v, x, train: net.apply(v, x, train=train, mutable=["batch_stats"])
                    if train else net.apply(v, x, train=False), static_argnums=2)
    (y_j, h_j), upd = apply(variables, x, True)
    port = _port(ResNetEmbed(DIM, num_blocks=SMALL), variables)
    y_t, h_t = port(torch.from_numpy(x), train=True)
    _close(h_t.detach(), h_j)
    _close(y_t.detach(), y_j)
    moved = {"params": variables["params"], "batch_stats": upd["batch_stats"]}
    for key, want in state_dict_from_jax(moved, port).items():
        if "running" in key:
            _close(port.state_dict()[key], want)

    y_j, h_j = apply(variables, x, False)
    port = _port(ResNetEmbed(DIM, num_blocks=SMALL), variables)
    with torch.no_grad():
        y_t, h_t = port(torch.from_numpy(x), train=False)
    _close(h_t, h_j)
    _close(y_t, y_j)


@pytest.mark.parametrize("kind", ["y2h", "y2cov"])
def test_label_mlps_match_jax(kind):
    jmodule, tmodule = ((JaxY2H(MLP_DIM), ModelY2H(MLP_DIM)) if kind == "y2h"
                        else (JaxY2Cov(768), ModelY2Cov(768)))
    shapes = jax.eval_shape(lambda k: jmodule.init(k, jnp.zeros((2,))), jax.random.PRNGKey(0))
    variables = _draw_variables(shapes, seed=2)
    y = np.linspace(0.0, 1.0, 9).astype(np.float32)
    want = jax.jit(jmodule.apply)(variables, y)
    with torch.no_grad():
        got = _port(tmodule, variables)(torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- training


def test_lr_schedule_matches_optax():
    for lr, epochs, spe in ((0.01, (80, 140), 3), (0.01, (150, 250, 350), 1), (0.1, (2, 2.5), 4)):
        want = jili._lr_schedule(lr, epochs, spe)
        got = optim.lr_schedule(lr, epochs, spe)
        counts = range(0, int(max(epochs) * spe) + 3)
        assert [got(c) for c in counts] == [float(np.float32(want(c))) for c in counts]


def test_train_resnet_embed_step_matches_jax(monkeypatch):
    monkeypatch.setattr(jili, "ResNetEmbed", _jit_init(JaxResNetEmbed))
    n, seed = 16, 5
    images = _images(n, 3)
    labels = np.random.default_rng(4).uniform(0, 1, n).astype(np.float32)
    kw = dict(batch_size=n, seed=seed, num_blocks=SMALL, log_every=0)
    want = jili.train_resnet_embed(images, labels, DIM, epochs=1, **kw)
    init = jili.train_resnet_embed(images, labels, DIM, epochs=0, **kw)  # its initial weights
    idx = jax.random.randint(jax.random.fold_in(jax.random.PRNGKey(seed), 0), (n,), 0, n)
    port = _port(ResNetEmbed(DIM, num_blocks=SMALL), init)
    got = ili.train_resnet_embed(images, labels, DIM, epochs=1, net=port,
                                 draws=[{"idx": torch.from_numpy(np.asarray(idx))}], **kw)
    assert got is port and got.seconds_per_epoch > 0
    _assert_tree_matches(got, {"params": want["params"], "batch_stats": want["batch_stats"]})
    assert _moved(init["params"], want["params"]) > 1e-4  # well beyond the bound


def test_train_resnet_embed_resumes_where_it_stopped(tmp_path):
    """An in-train checkpoint every epoch; resuming from epoch 1 of 2 ends
    on the uninterrupted run's weights (draws seeded by step)."""
    images = _images(8, 14)
    labels = np.linspace(0, 1, 8).astype(np.float32)
    kw = dict(batch_size=4, seed=2, num_blocks=SMALL, log_every=0, ckpt_every=1,
              ckpt_dir=str(tmp_path), ckpt_tag="cnn")
    whole = ili.train_resnet_embed(images, labels, DIM, epochs=2, **kw)
    assert os.path.isfile(tmp_path / "model-cnn_epoch1" / "state.pt")
    assert not (tmp_path / "model-cnn_epoch2").exists()  # none after the last epoch
    resumed = ili.train_resnet_embed(images, labels, DIM, epochs=2, resume_epoch=1,
                                     net=ResNetEmbed(DIM, num_blocks=SMALL, seed=9), **kw)
    for key, value in whole.state_dict().items():
        torch.testing.assert_close(resumed.state_dict()[key], value, rtol=0, atol=0)
    with pytest.raises(FileNotFoundError, match="cnn_epoch3"):
        ili.train_resnet_embed(images, labels, DIM, epochs=4, resume_epoch=3, **kw)


def _mlp_draws(seed, n, steps):
    """JAX's idx and N(0, 1) label noise of train_label_mlp's steps."""
    out = []
    for step in range(steps):
        k_idx, k_noise = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), step))
        out.append({"idx": torch.from_numpy(np.asarray(jax.random.randint(k_idx, (n,), 0, n))),
                    "noise": torch.from_numpy(np.asarray(jax.random.normal(k_noise, (n,))))})
    return out


def _head(kernel, bias) -> torch.nn.Linear:
    """The port's h2y head holding a flax Dense kernel [in, 1] and bias."""
    h2y = torch.nn.Linear(kernel.shape[0], 1)
    with torch.no_grad():
        h2y.weight.copy_(torch.from_numpy(kernel.T))
        h2y.bias.copy_(torch.from_numpy(bias))
    return h2y


LABELS = np.random.default_rng(6).permutation(np.linspace(0.05, 0.95, 8)).astype(np.float32)
COV_DIM = 3 * 16 * 16


@pytest.fixture(scope="module")
def y2h_run():
    """JAX's train_label_mlp of ModelY2H(64), 2 epochs of one step: the
    feature phase (Adam), then the inversion phase (SGD)."""
    rng = np.random.default_rng(7)
    seed = 7
    head = {"kernel": rng.normal(0, 0.5, (MLP_DIM, 1)).astype(np.float32),
            "bias": np.array([0.3], np.float32)}
    kw = dict(epochs=2, seed=seed, log_every=0,
              feat_mean=rng.uniform(0, 1, MLP_DIM).astype(np.float32),
              feat_targets=rng.uniform(0, 2, (len(LABELS), MLP_DIM)).astype(np.float32))
    module = _jit_init(JaxY2H)(MLP_DIM)
    want = jili.train_label_mlp(LABELS, {"params": {"h2y": head}}, module, MLP_DIM, **kw)
    init = module.init(jax.random.PRNGKey(seed), jnp.zeros((2,)))
    return head, kw, init, want


@pytest.fixture(scope="module")
def y2cov_run():
    """JAX's train_label_mlp of ModelY2Cov(768), one epoch of one step and
    no feature targets: one inversion step."""
    seed = 11
    head = {"kernel": np.random.default_rng(8).normal(0, 0.05, (COV_DIM, 1)).astype(np.float32),
            "bias": np.array([0.2], np.float32)}
    kw = dict(epochs=1, seed=seed, log_every=0)
    module = _jit_init(JaxY2Cov)(COV_DIM)
    want = jili.train_label_mlp(LABELS, {"params": {"h2y": head}}, module, COV_DIM, **kw)
    init = module.init(jax.random.PRNGKey(seed), jnp.zeros((2,)))
    return head, kw, init, want


def test_train_label_mlp_inversion_step_matches_jax(y2cov_run):
    head, kw, init, want = y2cov_run
    got = ili.train_label_mlp(LABELS, _head(**head), _port(ModelY2Cov(COV_DIM), init),
                              draws=_mlp_draws(kw["seed"], len(LABELS), 1), **kw)
    _assert_tree_matches(got, want)
    assert _moved(init["params"], want["params"]) > 1e-4


def test_train_label_mlp_both_phases_match_jax(y2h_run):
    """Every parameter within 1e-5, except where the feature phase's
    gradient is below 1e-6: there Adam's first step, lr g / (|g| + 1e-8),
    turns the gradient's rounding (the two frameworks' gradients agree to
    ~1e-7 absolute) into up to a whole step of lr 1e-3, so those are held
    to 2e-3."""
    head, kw, init, want = y2h_run
    draws = _mlp_draws(kw["seed"], len(LABELS), 2)
    probe = _port(ModelY2H(MLP_DIM), init)
    with torch.no_grad():
        probe.dense_out.bias.copy_(torch.from_numpy(kw["feat_mean"]))
    order = np.argsort(LABELS)
    ili.label_mlp_feat_step(probe, torch.optim.SGD(probe.parameters(), lr=0.0),
                            torch.from_numpy(LABELS), torch.from_numpy(LABELS[order]),
                            torch.from_numpy(kw["feat_targets"][order]), len(LABELS), 0.2,
                            **draws[0])
    flat_grad = {name: p.grad.abs() < 1e-6 for name, p in probe.named_parameters()}

    got = ili.train_label_mlp(LABELS, _head(**head), _port(ModelY2H(MLP_DIM), init),
                              draws=draws, **kw)
    sd = got.state_dict()
    for key, value in state_dict_from_jax(want, got).items():
        err = (sd[key] - value).abs()
        assert float(torch.where(flat_grad[key], 0.0, err).max()) <= 1e-5, key
        assert float(err.max()) <= 2e-3, key
    assert sum(int(m.sum()) for m in flat_grad.values()) < 0.5 * sum(
        m.numel() for m in flat_grad.values())
    assert _moved(init["params"], want["params"]) > 1e-4


def test_dataset_fingerprint_matches():
    images = _images(24, 8)
    labels = np.random.default_rng(9).uniform(0, 1, 24).astype(np.float32)
    fp = ili.dataset_fingerprint(images, labels)
    assert fp == jili.dataset_fingerprint(images, labels) and len(fp) == 12
    assert ili.dataset_fingerprint(images[:, ::-1], labels) != fp


# ------------------------------------------------------------------- cache


def _script():
    spec = importlib.util.spec_from_file_location(
        "jax_milestone_to_torch", ROOT / "scripts" / "jax_milestone_to_torch.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    return script


def _args(**over):
    base = dict(dim_embed=MLP_DIM, y2h_embed_type="resnet", y2cov_embed_type="resnet",
                use_Hy=True, image_size=16, num_channels=3, seed=3, epoch_cnn_embed=1,
                epoch_net_y2h=2, epoch_cnn_embed_y2cov=1, epoch_net_y2cov=2, device="cpu")
    base.update(over)
    return argparse.Namespace(**base)


def test_label_embed_loads_a_jax_cache_carried_across(y2h_run, y2cov_run, tmp_path):
    """A cache of the label MLPs JAX trained above, in orbax, with their
    fingerprints, carried across by scripts/jax_milestone_to_torch.py: the
    port's load-only LabelEmbed gives JAX's fn_y2h and fn_y2cov."""
    y2h_vars, y2cov_vars, cov_dim = y2h_run[-1], y2cov_run[-1], COV_DIM
    jax_dir, port_dir = tmp_path / "jax" / "embed_models", tmp_path / "port" / "embed_models"
    jax_dir.mkdir(parents=True)
    for tag, tree in ((f"y2h_d{MLP_DIM}_e1_m2_seed3", y2h_vars),
                      (f"y2cov_d{cov_dim}_e1_m2_seed3", y2cov_vars)):
        jax_save_checkpoint(str(jax_dir), tag, {"mlp": jax.device_get(tree)})
        (jax_dir / f"datafp-{tag}.txt").write_text("0123456789ab\n")
    jax_save_checkpoint(str(jax_dir), f"y2h_d{MLP_DIM}_e1_m2_seed3_cnn_epoch1", {"epoch": 1})

    written = _script().convert_embed_models(str(jax_dir), str(port_dir), _args())
    assert sorted(written) == sorted([f"y2h_d{MLP_DIM}_e1_m2_seed3",
                                      f"y2cov_d{cov_dim}_e1_m2_seed3"])
    assert (port_dir / f"datafp-y2h_d{MLP_DIM}_e1_m2_seed3.txt").read_text() == "0123456789ab\n"
    fn_y2h, fn_y2cov = build_label_embedding(_args(), str(port_dir.parent), bundle=None,
                                             require_cached=True)
    probe = np.linspace(0.0, 1.0, 7).astype(np.float32)
    h, c = fn_y2h(torch.from_numpy(probe)), fn_y2cov(torch.from_numpy(probe))
    assert not h.requires_grad and h.dtype == torch.float32
    # JAX's fn_y2h and fn_y2cov: the MLPs' apply on the flat labels (ili.py:667-744)
    want_h = jax.jit(JaxY2H(MLP_DIM).apply)(y2h_vars, probe)
    want_c = jax.jit(JaxY2Cov(cov_dim).apply)(y2cov_vars, probe)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(c.numpy(), np.asarray(want_c), rtol=1e-5, atol=1e-5)


def test_load_only_without_a_cache_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="y2h"):
        build_label_embedding(_args(), str(tmp_path), bundle=None, require_cached=True)
    assert not (tmp_path / "embed_models").exists()  # load-only writes nothing


class _Bundle:
    def __init__(self, seed):
        self.images = _images(16, seed)
        self.labels_norm = np.linspace(0, 1, 16).astype(np.float32)
        self.label_dim, self.channels, self.image_size = 1, 3, 16


def test_cache_of_another_dataset_exits(tmp_path):
    embed_dir = tmp_path / "embed_models"
    tag = f"y2h_d{MLP_DIM}_e1_m2_seed3"
    save_checkpoint(str(embed_dir), tag, {"mlp": ModelY2H(MLP_DIM).state_dict()})
    other = _Bundle(1)
    (embed_dir / f"datafp-{tag}.txt").write_text(
        ili.dataset_fingerprint(other.images, other.labels_norm) + "\n")
    args = _args(use_Hy=False)
    build_label_embedding(args, str(tmp_path), bundle=other)  # its own data: loads
    with pytest.raises(SystemExit, match="DIFFERENT"):
        build_label_embedding(args, str(tmp_path), bundle=_Bundle(2))


def test_partial_cache_entries_are_skipped(tmp_path):
    """In-train CNN checkpoints and entries without an "mlp" read as a miss;
    a newer partial entry does not hide an older complete one."""
    embed_dir = str(tmp_path / "embed_models")
    save_checkpoint(embed_dir, f"y2h_d{MLP_DIM}_e2_m2_seed3_cnn_epoch1", {"epoch": 1})
    assert ili.find_cached_embedding(embed_dir, f"y2h_d{MLP_DIM}",
                                     f"y2h_d{MLP_DIM}_e2_m2_seed3") is None
    save_checkpoint(embed_dir, f"y2h_d{MLP_DIM}_e9_m9_seed3", {"epoch": 9})
    args = _args(use_Hy=False)
    with pytest.raises(FileNotFoundError):
        build_label_embedding(args, str(tmp_path), bundle=None, require_cached=True)
    mlp = ModelY2H(MLP_DIM, seed=4)
    save_checkpoint(embed_dir, f"y2h_d{MLP_DIM}_e5_m5_seed3", {"mlp": mlp.state_dict()})
    save_checkpoint(embed_dir, f"y2h_d{MLP_DIM}_e7_m7_seed3", {"epoch": 7})
    later = os.path.getmtime(os.path.join(embed_dir, f"model-y2h_d{MLP_DIM}_e5_m5_seed3")) + 5
    os.utime(os.path.join(embed_dir, f"model-y2h_d{MLP_DIM}_e7_m7_seed3"), (later, later))
    fn_y2h, _ = build_label_embedding(args, str(tmp_path), bundle=None, require_cached=True)
    probe = torch.tensor([0.2, 0.7])
    with torch.no_grad():
        torch.testing.assert_close(fn_y2h(probe), mlp(probe), rtol=0, atol=0)


def test_resnet18_mean_features_run_where_jax_raises():
    """ccdm_tpu's mean_feature and per_label_mean_features rebuild a ResNet34
    whatever net was trained, so a ResNet18's variables raise there; the
    port's run the net itself and agree with the ResNet18's own forward."""
    net, variables = _resnet_variables((2, 2, 2, 2), seed=12)
    images = _images(6, 13)
    labels = np.array([0.1, 0.1, 0.5, 0.5, 0.9, 0.9], np.float32)
    with pytest.raises(Exception, match="stage0_block2"):
        jili.mean_feature(variables, images, DIM)
    with pytest.raises(Exception, match="stage0_block2"):
        jili.per_label_mean_features(variables, images, labels, np.unique(labels), DIM)
    port = _port(ResNetEmbed(DIM, num_blocks=(2, 2, 2, 2)), variables)
    x = images.astype(np.float32) / 255.0 * 2 - 1
    _, h = jax.jit(lambda v, x: net.apply(v, x, train=False))(variables, x)
    h = np.asarray(h, np.float64)
    _close(ili.mean_feature(port, images, batch_size=4), h.mean(0))
    _close(ili.per_label_mean_features(port, images, labels, np.unique(labels), batch_size=4),
           h.reshape(3, 2, DIM).mean(1))
