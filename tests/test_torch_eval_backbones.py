"""Port parity of the eval backbones (ccdm_tpu_torch/eval/backbones.py) and
their layout conversion (utils/convert.py), against ccdm_tpu/eval/backbones.py.

Weights are drawn with numpy from a seed in the flax trees (BatchNorm
statistics off their initial values) and converted with
state_dict_from_jax; jax_variables_from_state_dict must give the tree back
bit for bit. Tolerances, each with its reason:
- every forward, eval and train mode (the running statistics moved
  towards the biased batch statistics, 1% for the stems' and the
  autoencoder's momentum 0.99, 10% for the BasicBlocks' 0.9): 1e-5 of the
  largest |value| (f32 convs in another framework); the ResNets at their
  eval depth in eval mode, at one block a stage in train mode;
- the round trip through the inverse converter: exact;
- the lr schedule of train_eval_resnet against optax's
  piecewise_constant_schedule: exact, at 1, 2, 4 and 8 steps (at 1 and 2
  its two boundaries meet and only one factor of 0.1 applies).
"""

import numpy as np
import optax
import pytest
import torch

import jax
from flax import linen as nn

from ccdm_tpu.eval import backbones as jbackbones
from ccdm_tpu_torch.eval.backbones import AEDecoder, AEEncoder, NoisyClassifier, ResNetEval
from ccdm_tpu_torch.training.optim import lr_schedule
from ccdm_tpu_torch.utils.convert import jax_variables_from_state_dict, state_dict_from_jax

torch.set_num_threads(2)


def _draw_variables(shapes, seed):
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


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), max(np.abs(want).max(), 1e-30)
    assert err <= rel * scale, f"max abs diff {err:.3e} beyond {rel} x {scale:.3e}"


def _tree_equal(got, want):
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, g), (_, w) in zip(flat_g, flat_w):
        assert g.dtype == np.float32 and g.flags.c_contiguous, path
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=str(path))


def _check(jmodule, port, args, seed, modes=(False, True), **kw):
    """JAX's and the port's forward on drawn variables in eval mode
    (False) and train mode (True); the running statistics after the
    train-mode pass."""
    shapes = jax.eval_shape(lambda k: jmodule.init(k, *args, train=False), jax.random.PRNGKey(0))
    variables = _draw_variables(shapes, seed)
    port.load_state_dict(state_dict_from_jax(variables, port))
    _tree_equal(jax_variables_from_state_dict(port.state_dict(), port), variables)
    targs = [torch.from_numpy(np.asarray(a)) for a in args]
    for train in modes:
        fn = jax.jit(lambda v, *a: jmodule.apply(v, *a, train=train, mutable=["batch_stats"],
                                                 **kw) if train
                     else jmodule.apply(v, *a, train=False, **kw))
        out = fn(variables, *args)
        want, upd = (out if train else (out, None))
        got = port(*targs, train=train, **kw)
        if isinstance(want, tuple):
            for g, w in zip(got, want):
                _close(g.detach(), w)
        else:
            _close(got.detach(), want)
        if train:
            moved = {"params": variables["params"], "batch_stats": upd["batch_stats"]}
            sd = port.state_dict()
            for key, value in state_dict_from_jax(moved, port).items():
                if "running" in key:
                    _close(sd[key], value)
            port.load_state_dict(state_dict_from_jax(variables, port))
    return variables


def _x(n, size, channels, seed):
    return np.random.default_rng(seed).uniform(-1, 1, (n, size, size, channels)).astype(
        np.float32)


@pytest.mark.parametrize("size,channels", [(16, 3), (32, 1)])
def test_autoencoder_matches_jax(size, channels):
    x = _x(4, size, channels, 1)
    _check(jbackbones.AEEncoder(), AEEncoder(in_channels=channels, image_size=size), (x,), 2)
    f = np.random.default_rng(3).normal(0, 1, (4, 512)).astype(np.float32)
    _check(jbackbones.AEDecoder(nc=channels, init_size=size // 16),
           AEDecoder(nc=channels, init_size=size // 16), (f,), 4)


def test_decoder_needs_the_flipped_kernel():
    """flax's ConvTranspose(4, 2, "SAME") with transpose_kernel False is
    torch's conv_transpose2d(stride 2, padding 1) of the kernel flipped in
    both spatial axes; the unflipped kernel is far off."""
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (2, 4, 4, 6)).astype(np.float32)
    module = nn.ConvTranspose(5, (4, 4), strides=(2, 2), padding="SAME")
    v = module.init(jax.random.PRNGKey(0), x)
    want = np.asarray(module.apply(v, x))
    k, b = np.asarray(v["params"]["kernel"]), torch.from_numpy(np.asarray(v["params"]["bias"]))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    run = lambda w: torch.nn.functional.conv_transpose2d(
        xt, torch.from_numpy(np.ascontiguousarray(w)), b, stride=2, padding=1
    ).permute(0, 2, 3, 1).numpy()
    _close(run(k[::-1, ::-1].transpose(2, 3, 0, 1)), want)
    assert np.abs(run(k.transpose(2, 3, 0, 1)) - want).max() > 0.1


SMALL = (1, 1, 1, 1)


@pytest.mark.parametrize("mode,leaky", [("class", False), ("regre", False), ("regre", True)])
def test_resnet_eval_matches_jax(mode, leaky):
    """ResNet34 (the eval depth) at 16x16 in eval mode, one block a stage in
    train mode (in train mode at ResNet34's depth, batch 8, both frameworks
    sit ~1.5e-5 of the largest |h| off an f64 forward); the regression head
    through relu, and through the training surrogate leaky_relu(0.01)."""
    outputs = 5 if mode == "class" else 1
    x = _x(8, 16, 3, 6)
    kw = {"leaky_head": True} if leaky else {}
    _check(jbackbones.ResNetEval(outputs, mode), ResNetEval(outputs, mode), (x,), 7, (False,),
           **kw)
    _check(jbackbones.ResNetEval(outputs, mode, SMALL), ResNetEval(outputs, mode, SMALL), (x,),
           7, (True,), **kw)


def test_noisy_classifier_matches_jax():
    """ResNet18 in eval mode, one block a stage in train mode."""
    x = _x(4, 16, 3, 8)
    t = np.array([0, 17, 500, 999], np.int32)
    _check(jbackbones.NoisyClassifier(6), NoisyClassifier(6), (x, t), 9, (False,))
    _check(jbackbones.NoisyClassifier(6, SMALL), NoisyClassifier(6, SMALL), (x, t), 9, (True,))


@pytest.mark.parametrize("steps", [1, 2, 4, 8])
def test_eval_resnet_lr_schedule_is_optax(steps):
    """train_eval_resnet's schedule: lr x 0.1 from int(0.5 steps) and again
    from int(0.75 steps) (train_backbones.py:99)."""
    want = optax.piecewise_constant_schedule(0.01, {int(steps * 0.5): 0.1,
                                                    int(steps * 0.75): 0.1})
    got = lr_schedule(0.01, (0.5, 0.75), steps)
    assert [got(c) for c in range(steps)] == [float(np.float32(want(c))) for c in range(steps)]
    if steps == 1:
        assert got(0) == float(np.float32(1e-3))
    if steps == 4:  # one factor from step 2, both from step 3
        assert got(1) == got(0) > got(2) > got(3)
