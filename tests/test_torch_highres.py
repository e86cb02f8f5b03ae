"""Port parity at the shipped UTKFace-128 and UTKFace-192 configurations.

scripts/UK128/run_ccdm.sh (128x128, dim 64, mults 1_2_4_4_8_8, batch 32 x
2 accumulation steps) and scripts/UK192/run_ccdm.sh (192x192, mults
1_2_2_4_4_8_8, batch 16 x 4; its bottom level is 3x3) are the deepest UNets
the repo ships; the other port tests hold 2-level ones.

- (a) The port's Unet against JAX's at each configuration's mults and image
  size, dim 8, B 1, f32, the same weights through utils/convert.py: the
  whole-UNet bound of tests/test_torch_unet.py, rtol = atol = 1e-4; the
  attention blocks the port's forward runs are chip_smoke.unet_attn_shapes
  at dim 8. Both JAX forwards run in one jit, once for the module.
- (b) build_model of both packages on each launch script's own flags, read
  from the script: the same parsed flags, the same widths (every JAX leaf
  placed in the port's model by the converter, shape for shape, and the
  same parameter count), and the attention blocks at (N, C) =
  chip_smoke.unet_attn_shapes at dim 64, the list phase 28 of chip_smoke.py
  derives its launch counts from.
- (c) One train step with gradient_accumulate_every 4 (UK192's) against the
  JAX Trainer's jitted step at f32, at the size of tests/test_torch_train.py's
  whole-step test (dim 8, mults (1, 2), 64x64, synthetic data, hv, batch 16),
  the JAX draws passed in; its bounds, the loss's ten times wider (the
  test says why); and, on a 16x16 UNet, the port's
  accumulated step against its four micro-batches taken one at a time.
"""

import shlex
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from ccdm_tpu import main as jax_main
from ccdm_tpu.data.datasets import make_synthetic
from ccdm_tpu.diffusion import DiffusionConfig as JaxDiffusionConfig
from ccdm_tpu.diffusion import GaussianDiffusion as JaxGaussianDiffusion
from ccdm_tpu.embedding import make_fn_y2h as jax_make_fn_y2h
from ccdm_tpu.models import Unet as JaxUnet
from ccdm_tpu.opts import parse_opts as jax_parse_opts
from ccdm_tpu.training import Trainer as JaxTrainer
from ccdm_tpu.training import TrainerConfig as JaxTrainerConfig
from ccdm_tpu_torch import main as port_main
from ccdm_tpu_torch.diffusion.gaussian import DiffusionConfig, GaussianDiffusion
from ccdm_tpu_torch.embedding.analytic import make_fn_y2h
from ccdm_tpu_torch.models.unet import Unet
from ccdm_tpu_torch.ops import attn_block
from ccdm_tpu_torch.opts import parse_opts
from ccdm_tpu_torch.training.trainer import Trainer, TrainerConfig
from ccdm_tpu_torch.utils.convert import unet_state_dict_from_jax
from tests.test_torch_train import (
    BN_FED_BIASES,
    _jax_variables as _small_variables,
    _port_model,
    _recording_tx,
    _step_draws,
)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
# (image size, mults) of the two configurations, as their launch scripts set them
CONFIGS = {"UK128": (128, (1, 2, 4, 4, 8, 8)), "UK192": (192, (1, 2, 2, 4, 4, 8, 8))}
DIM = 8  # the width of (a)


def _variables(size, mults, seed):
    """Random variables in the JAX Unet's tree at dim DIM (shapes from
    eval_shape, so nothing is compiled), drawn as tests/test_torch_unet.py
    draws them."""
    shapes = jax.eval_shape(lambda key: JaxUnet(dim=DIM, dim_mults=mults).init(
        key, jnp.zeros((1, size, size, 3)), jnp.zeros((1,), jnp.int32), jnp.zeros((1, 128)),
        None, train=False), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = jax.tree_util.keystr(path), leaf.shape
        if len(shape) >= 2:
            a = rng.normal(0, 1 / np.sqrt(np.prod(shape[:-1])), shape)
        elif "var" in name:
            a = rng.uniform(0.5, 1.5, shape)
        elif "bias" in name or "mean" in name or "null" in name:
            a = rng.normal(0, 0.2, shape)
        else:  # norm gains and BatchNorm scales
            a = 1 + rng.normal(0, 0.2, shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _inputs(size, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(1, size, size, 3)).astype(np.float32), np.array([500]),
            rng.uniform(size=(1, 128)).astype(np.float32), np.array([True]))


@pytest.fixture(scope="module")
def forwards():
    """{config: (variables, inputs, JAX output)}, both JAX forwards in one jit."""
    names = list(CONFIGS)
    variables = [_variables(*CONFIGS[k], seed=i) for i, k in enumerate(names)]
    inputs = [_inputs(CONFIGS[k][0], seed=10 + i) for i, k in enumerate(names)]
    models = [JaxUnet(dim=DIM, dim_mults=CONFIGS[k][1]) for k in names]
    outs = jax.jit(lambda vs, ins: [m.apply(v, *a, train=False)
                                    for m, v, a in zip(models, vs, ins)])(variables, inputs)
    return {k: (v, a, np.asarray(o)) for k, v, a, o in zip(names, variables, inputs, outs)}


@pytest.mark.parametrize("config", list(CONFIGS))
def test_unet_forward_matches_jax(forwards, config, monkeypatch):
    size, mults = CONFIGS[config]
    variables, (x, t, e, keep), want = forwards[config]
    port = Unet(dim=DIM, dim_mults=mults, in_channels=3)
    port.load_state_dict(unet_state_dict_from_jax(variables, port))
    port = port.to(memory_format=torch.channels_last)
    shapes, block = [], attn_block.fused_attn_block

    def spy(x2d, *args):
        shapes.append(tuple(x2d.shape[1:]))
        return block(x2d, *args)

    monkeypatch.setattr(attn_block, "fused_attn_block", spy)
    with torch.no_grad():
        got = port(*map(torch.from_numpy, (x, t, e, keep))).numpy()
    assert got.shape == want.shape == (1, size, size, 3)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert shapes == chip_smoke.unet_attn_shapes(size, mults, dim=DIM)
    if config == "UK192":
        assert shapes[len(mults) - 1] == (9, DIM * mults[-2])  # the 3x3 bottom level


def _script_argv(config, root):
    """The flags of scripts/<config>/run_ccdm.sh, its paths set to `root`."""
    text = (REPO / "scripts" / config / "run_ccdm.sh").read_text()
    body = text.split("python -m ccdm_tpu.main", 1)[1].split('"$@"', 1)[0]
    body = body.replace("$ROOT_PATH", str(root)).replace("$DATA_PATH", str(root))
    return shlex.split(body.replace("\\\n", " "))


@pytest.mark.parametrize("config", list(CONFIGS))
def test_build_model_on_the_launch_scripts_flags(config, tmp_path):
    size, mults = CONFIGS[config]
    argv = _script_argv(config, tmp_path)
    jargs, pargs = jax_parse_opts(argv), parse_opts(argv)
    set_by_script = {a[2:] for a in argv if a.startswith("--")}
    assert {k: getattr(pargs, k) for k in set_by_script} == \
        {k: getattr(jargs, k) for k in set_by_script}
    assert (pargs.image_size, pargs.channel_mult) == (size, "_".join(map(str, mults)))
    assert (pargs.train_batch_size * pargs.gradient_accumulate_every, pargs.samp_batch_size) \
        == (64, 200)

    jmodel = jax_main.build_model(jargs, size, 3)
    port = port_main.build_model(pargs, size, 3)
    assert (jmodel.dim, tuple(jmodel.dim_mults), jmodel.attn_heads, jmodel.attn_dim_head) == \
        (port.dim, mults, 4, 32)
    assert port.dtype == torch.bfloat16 and jmodel.dtype == jnp.bfloat16  # --train_amp
    shapes = jax.eval_shape(lambda key: jmodel.init(
        key, jnp.zeros((1, size, size, 3)), jnp.zeros((1,), jnp.int32), jnp.zeros((1, 128)),
        None, train=False), jax.random.PRNGKey(0))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    port.load_state_dict(unet_state_dict_from_jax(zeros, port))  # strict, shape for shape
    assert sum(p.numel() for p in port.parameters()) == \
        sum(s.size for s in jax.tree_util.tree_leaves(shapes["params"]))

    levels = len(mults)
    blocks = [(size >> i, getattr(port, f"down_{i}_attn")) for i in range(levels)]
    blocks += [(size >> (levels - 1 - i), getattr(port, f"up_{i}_attn")) for i in range(levels)]
    assert [(side * side, b.norm_g.numel()) for side, b in blocks] == \
        chip_smoke.unet_attn_shapes(size, mults, dim=pargs.model_channels)


def test_train_step_with_four_accumulation_steps_matches_jax(tmp_path):
    """tests/test_torch_train.py's whole-step comparison (its variables, key
    and data; hv, batch 16) at gradient_accumulate_every 4, UK192's. Each
    gradient leaf within 1e-3 of its largest |g| (the BatchNorm-fed biases
    of the model's) and the BatchNorm statistics, moved once per
    micro-batch, within 1e-5, as there. The loss to rtol 1e-4, ten times
    that file's: under hv a micro-batch's labels lie within kappa of one
    target, so the label BatchNorm's variance mean(x^2) - mean(x)^2 cancels
    in f32 (in both packages: flax's BatchNorm at dtype float32, the port's
    flax_batch_norm), and the loss moves with the order of the sums. At this
    key JAX's own step moves by 3.1e-4 of its loss between the eight-device
    mesh the conftest makes and one device, the port lies 2.6e-5 from the
    former (scripts/acc_step_spread.py prints both)."""
    acc, b = 4, 16
    bundle = make_synthetic(n=64, image_size=64, channels=3, seed=0)
    variables = _small_variables(64, seed=4)
    kw = dict(image_size=64, channels=3, timesteps=1000, objective="pred_x0",
              vicinity_type="hv", cond_drop_prob=0.5)
    tkw = dict(data_name="synthetic", train_batch_size=b, gradient_accumulate_every=acc,
               vicinity_type="hv")
    jtrainer = JaxTrainer(JaxGaussianDiffusion(JaxUnet(dim=8, dim_mults=(1, 2)).apply,
                                               JaxDiffusionConfig(**kw)),
                          variables, bundle.images, bundle.labels_norm,
                          JaxTrainerConfig(results_folder=str(tmp_path / "results"), **tkw))
    jtrainer.tx = _recording_tx()
    jtrainer.state = jtrainer.state.replace(opt_state=jtrainer.tx.init(jtrainer.state.params))
    key = jax.random.PRNGKey(9)
    new_state, jloss = jtrainer._build_train_step(jax_make_fn_y2h(128))(jtrainer.state, key)
    jgrads = jax.device_get(new_state.opt_state)

    draws = _step_draws(key, jtrainer, len(bundle.images), acc=acc, b=b)
    assert len(draws) == acc
    ttrainer = Trainer(GaussianDiffusion(_port_model(variables, 64), DiffusionConfig(**kw)),
                       bundle.images, bundle.labels_norm, TrainerConfig(**tkw))
    loss, grads = ttrainer.compute_grads(make_fn_y2h(128), draws=draws)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    model = ttrainer.state.model
    want = unet_state_dict_from_jax({"params": jgrads,
                                     "batch_stats": jax.device_get(new_state.batch_stats)}, model)
    largest = max(float(want[name].abs().max()) for name, _ in model.named_parameters())
    for (name, _), g in zip(model.named_parameters(), grads):
        w = want[name].numpy()
        scale = largest if name in BN_FED_BIASES else np.abs(w).max()
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-3 * scale, err_msg=name)
    for name, buf in model.named_buffers():
        if buf.is_floating_point():
            np.testing.assert_allclose(buf.numpy(), want[name].numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=name)


def test_accumulation_is_the_mean_of_its_micro_batches():
    """Trainer.compute_grads at gradient_accumulate_every 4 equals its four
    micro-batches taken one at a time (each draw passed in): the mean loss
    and the mean gradients to f32 rounding, the BatchNorm statistics moved
    once per micro-batch, bit for bit. A 16x16 UNet of dim 8: the sum is the
    trainer's, whatever the attention route."""
    acc, b = 4, 4
    rng = np.random.default_rng(3)
    images = rng.integers(0, 256, (32, 16, 16, 3), dtype=np.uint8)
    labels = np.linspace(0.05, 0.95, 32)
    draws = [{"idx": torch.from_numpy(rng.integers(0, 32, b)),
              "t": torch.from_numpy(rng.integers(0, 1000, b)),
              "keep_mask": torch.from_numpy(rng.uniform(size=b) < 0.7),
              "noise": torch.from_numpy(rng.normal(size=(b, 16, 16, 3)).astype(np.float32))}
             for _ in range(acc)]
    variables = _variables(16, (1, 2), seed=7)

    def trainer(a):
        model = Unet(dim=DIM, dim_mults=(1, 2), in_channels=3)
        model.load_state_dict(unet_state_dict_from_jax(variables, model))
        return Trainer(GaussianDiffusion(model, DiffusionConfig(image_size=16)), images, labels,
                       TrainerConfig(train_batch_size=b, gradient_accumulate_every=a,
                                     vicinity_type="none"))

    whole, one = trainer(acc), trainer(1)
    loss, grads = whole.compute_grads(make_fn_y2h(128), draws=draws)
    parts = [one.compute_grads(make_fn_y2h(128), draws=[d]) for d in draws]
    torch.testing.assert_close(loss, sum(p[0] for p in parts) / acc, rtol=1e-6, atol=0)
    for g, *gs in zip(grads, *(p[1] for p in parts)):
        torch.testing.assert_close(g, sum(gs) / acc, rtol=1e-5, atol=1e-6 * float(g.abs().max()))
    for name, buf in whole.state.model.named_buffers():
        if buf.is_floating_point():
            torch.testing.assert_close(buf, dict(one.state.model.named_buffers())[name],
                                       rtol=0, atol=0, msg=name)
