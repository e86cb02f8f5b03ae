"""Port parity of the rest of main.py's training entry: the DDIM trajectory
(--gif_trajectory) and its GIF, the latent interpolation (--interpolation),
and the elastic aux loss with its regressors (--lambda_aux).

The diffusion runs a small JAX Unet (dim 8, mults (1, 2), 16x16) and the
port's on the same converted weights, with JAX's draws handed to the port
(DDIM's initial noise from split(key)[0]; interpolate's two noises from
split(key, 3)[:2] and step i's from split(split(key, 3)[2], t)[i]; the
loss's t, keep mask and noise from split(key, 6) or split(key, 3)).
Tolerances, each with its reason:
- the trajectory and the interpolation: 1e-3 ([0, 1] or [-1, 1] images
  after several guided UNet passes, as tests/test_torch_sampling.py bounds
  DDIM);
- loss and weighted_loss with the aux term: rtol 1e-5 (as
  tests/test_torch_train.py holds them without it), the term itself 1e-5;
- the VGG11 and ResNet18 aux nets, train and eval mode: 1e-4 of the largest
  |value| (f32 convs and train-mode BatchNorm in another framework, as the
  ILI nets are held);
- one train_aux_net step against optax's: 1e-5;
- the GIF: grayscale frames exactly, RGB within GIF_RGB_MAX_ERROR (25).
JAX is imported inside the tests (the `jx` fixture), so that the card's
machine, which has no JAX, can run the tests marked `cuda`.
"""

import importlib.util
import io
import json
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from ccdm_tpu_torch import main as port_main
from ccdm_tpu_torch.diffusion.gaussian import DiffusionConfig, GaussianDiffusion
from ccdm_tpu_torch.models.aux_net import make_aux_net
from ccdm_tpu_torch.models.layers import FusedLinearAttentionBlock
from ccdm_tpu_torch.models.unet import Unet
from ccdm_tpu_torch.opts import parse_opts
from ccdm_tpu_torch.training import train_aux
from ccdm_tpu_torch.utils.convert import state_dict_from_jax, unet_state_dict_from_jax
from ccdm_tpu_torch.utils.viz import GIF_RGB_MAX_ERROR, encode_gif, make_grid, save_gif

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
CFG = dict(dim=8, dim_mults=(1, 2), in_channels=3)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def jx():
    """JAX and the JAX package's modules these tests hold the port to."""
    import jax
    import jax.numpy as jnp

    from ccdm_tpu import diffusion
    from ccdm_tpu.models import Unet as JaxUnet
    from ccdm_tpu.models import aux_net
    from ccdm_tpu.training import train_aux as jax_train_aux
    from ccdm_tpu.utils import ckpt

    return types.SimpleNamespace(jax=jax, jnp=jnp, diffusion=diffusion, Unet=JaxUnet,
                                 aux_net=aux_net, train_aux=jax_train_aux, ckpt=ckpt)


def _draw_variables(jx, shapes, seed):
    """Random variables in a flax tree of `shapes`: kernels scaled by
    1/sqrt(fan-in), biases, scales and BatchNorm statistics off their
    initial values."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = jx.jax.tree_util.keystr(path), leaf.shape
        if len(shape) >= 2:
            a = rng.normal(0, 1 / np.sqrt(np.prod(shape[:-1])), shape)
        elif "var" in name:
            a = rng.uniform(0.5, 1.5, shape)
        elif "bias" in name or "mean" in name or "null" in name:
            a = rng.normal(0, 0.2, shape)
        else:
            a = 1 + rng.normal(0, 0.2, shape)
        return a.astype(np.float32)

    return jx.jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def unet_variables(jx):
    model = jx.Unet(**CFG)
    shapes = jx.jax.eval_shape(lambda key: model.init(
        key, jx.jnp.zeros((2, 16, 16, 3)), jx.jnp.zeros((2,), jx.jnp.int32),
        jx.jnp.zeros((2, 128)), None, train=False), jx.jax.random.PRNGKey(0))
    return _draw_variables(jx, shapes, 31)


def _pair(jx, variables, **cfg):
    """(JAX diffusion, port diffusion) on the same weights."""
    jdiff = jx.diffusion.GaussianDiffusion(jx.Unet(**CFG).apply,
                                           jx.diffusion.DiffusionConfig(**cfg))
    model = Unet(**CFG)
    model.load_state_dict(unet_state_dict_from_jax(variables, model))
    return jdiff, GaussianDiffusion(model, DiffusionConfig(**cfg))


# ------------------------------------------------------------- sampling


def test_ddim_trajectory_matches_jax(jx, unet_variables):
    """6 DDIM steps, CFG 1.5, pred_x0: every intermediate state in [0, 1]."""
    cfg = dict(image_size=16, channels=3, timesteps=20, sampling_timesteps=6,
               objective="pred_x0")
    jdiff, port = _pair(jx, unet_variables, **cfg)
    emb = np.random.default_rng(1).uniform(size=(3, 128)).astype(np.float32)
    key = jx.jax.random.PRNGKey(4)
    want = np.asarray(jx.jax.jit(lambda v, k, e: jdiff.ddim_sample(
        v, k, e, cond_scale=1.5, save_intermediate=True))(unet_variables, key, emb))
    noise = _t(jx.jax.random.normal(jx.jax.random.split(key)[0], (3, 16, 16, 3)))
    got = port.ddim_sample(_t(emb), cond_scale=1.5, noise=noise, save_intermediate=True)
    assert got.shape == want.shape == (6, 3, 16, 16, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)
    final = port.ddim_sample(_t(emb), cond_scale=1.5, noise=noise)
    torch.testing.assert_close(got[-1], final, rtol=0, atol=0)


@pytest.mark.parametrize("lam,cond_scale", [(0.3, 1.0), (1.0, 1.5)])
def test_interpolate_matches_jax_with_its_draws(jx, unet_variables, lam, cond_scale):
    """Both images diffused to t = 5 of a T-20 schedule, blended, then the
    ancestral chain 4, ..., 0 (no noise at 0)."""
    cfg = dict(image_size=16, channels=3, timesteps=20, objective="pred_noise")
    jdiff, port = _pair(jx, unet_variables, **cfg)
    rng = np.random.default_rng(2)
    x1, x2 = (rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32) for _ in range(2))
    emb = rng.uniform(size=(2, 128)).astype(np.float32)
    key, t = jx.jax.random.PRNGKey(9), 5
    want = np.asarray(jx.jax.jit(lambda v, k, a, b, e: jdiff.interpolate(
        v, k, a, b, e, t=t, lam=lam, cond_scale=cond_scale))(unet_variables, key, x1, x2, emb))
    k1, k2, k_scan = jx.jax.random.split(key, 3)
    steps = np.stack([np.array(jx.jax.random.normal(k, x1.shape))
                      for k in jx.jax.random.split(k_scan, t)])
    got = port.interpolate(_t(x1), _t(x2), _t(emb), t=t, lam=lam, cond_scale=cond_scale,
                           noise1=_t(jx.jax.random.normal(k1, x1.shape)),
                           noise2=_t(jx.jax.random.normal(k2, x1.shape)),
                           step_noise=_t(steps))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)
    with pytest.raises(ValueError, match="step_noise"):
        port.interpolate(_t(x1), _t(x2), _t(emb), t=t, step_noise=_t(steps[:4]))


# ------------------------------------------------------------- aux nets


def _aux_variables(jx, name, seed, size=16):
    net = jx.aux_net.make_aux_net(name)
    shapes = jx.jax.eval_shape(lambda k: net.init(
        k, jx.jnp.zeros((2, size, size, 3)), jx.jnp.zeros((2,), jx.jnp.int32), train=False),
        jx.jax.random.PRNGKey(0))
    return net, _draw_variables(jx, shapes, seed)


def _port_aux(name, variables, size=16):
    net = make_aux_net(name, image_size=size)
    net.load_state_dict(state_dict_from_jax(variables, net))
    return net


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), max(np.abs(want).max(), 1e-30)
    assert err <= rel * scale, f"max abs diff {err:.3e} beyond {rel} x {scale:.3e}"


@pytest.mark.parametrize("name", ["VGG11", "ResNet18"])
def test_aux_nets_match_jax_in_train_and_eval(jx, name):
    net, variables = _aux_variables(jx, name, seed=3)
    x = np.random.default_rng(4).uniform(0, 1, (8, 16, 16, 3)).astype(np.float32)
    t = np.arange(8, dtype=np.int32)
    port = _port_aux(name, variables)
    want, upd = jx.jax.jit(lambda v, x: net.apply(v, x, None, train=True,
                                                  mutable=["batch_stats"]))(variables, x)
    got = port(_t(x), None, train=True)
    assert got.shape == (8, 1)
    _close(got.detach(), want, 1e-4)
    moved = {"params": variables["params"], "batch_stats": upd["batch_stats"]}
    for key, value in state_dict_from_jax(moved, port).items():
        if "running" in key:
            _close(port.state_dict()[key], value, 1e-4)
    port = _port_aux(name, variables)
    want = jx.jax.jit(lambda v, x, t: net.apply(v, x, t, train=False))(variables, x, t)
    with torch.no_grad():
        _close(port(_t(x), _t(t), train=False), want, 1e-4)


def test_train_aux_net_step_matches_optax(jx):
    n, seed = 16, 5
    rng = np.random.default_rng(6)
    images = rng.integers(0, 256, (n, 16, 16, 3), dtype=np.uint8)
    labels = rng.uniform(0, 1, n).astype(np.float32)
    kw = dict(name="VGG11", batch_size=n, seed=seed, log_every=0)
    want = jx.train_aux.train_aux_net(images, labels, epochs=1, **kw)
    init = jx.train_aux.train_aux_net(images, labels, epochs=0, **kw)  # its initial weights
    idx = jx.jax.random.randint(jx.jax.random.fold_in(jx.jax.random.PRNGKey(seed), 0), (n,), 0, n)
    port = _port_aux("VGG11", init)
    got = train_aux.train_aux_net(images, labels, epochs=1, net=port,
                                  draws=[{"idx": _t(idx)}], **kw)
    assert got is port and got.seconds_per_epoch > 0
    sd = got.state_dict()
    moved = 0.0
    for key, value in state_dict_from_jax(want, port).items():
        np.testing.assert_allclose(sd[key].detach().numpy(), value.numpy(), rtol=0, atol=1e-5,
                                   err_msg=key)
        moved = max(moved, float((value - state_dict_from_jax(init, port)[key]).abs().max()))
    assert moved > 1e-4  # well beyond the bound
    with pytest.raises(ValueError, match="scalar labels"):
        train_aux.train_aux_net(images, np.stack([labels, labels], 1), epochs=1, **kw)


def test_jax_aux_cache_carried_across(jx, tmp_path):
    """The converter writes JAX's aux_models/ entry as the port's; get_aux_net
    loads it and applies JAX's net, frozen, in eval mode."""
    net, variables = _aux_variables(jx, "ResNet18", seed=8)
    tag = "aux_ResNet18_e3_seed4"
    jx.ckpt.save_checkpoint(str(tmp_path / "jax" / "aux_models"), tag,
                            jx.jax.device_get(variables))
    spec = importlib.util.spec_from_file_location(
        "jax_milestone_to_torch", ROOT / "scripts" / "jax_milestone_to_torch.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    args = parse_opts(["--image_size", "16", "--num_channels", "3"])
    assert script.convert_aux_models(str(tmp_path / "jax" / "aux_models"),
                                     str(tmp_path / "port" / "aux_models"), args) == [tag]
    bundle = types.SimpleNamespace(channels=3, image_size=16)
    apply = train_aux.get_aux_net(bundle, str(tmp_path / "port"), "ResNet18", epochs=3, seed=4)
    assert apply.seconds_per_epoch is None
    x = np.random.default_rng(9).normal(size=(4, 16, 16, 3)).astype(np.float32)
    t = np.array([0, 3, 7, 19], np.int32)
    want = jx.jax.jit(lambda v, x, t: net.apply(v, x, t, train=False))(variables, x, t)
    _close(apply(_t(x), _t(t)), want, 1e-4)


# ------------------------------------------------------------- elastic loss


@pytest.fixture(scope="module")
def aux_pair(jx):
    """(JAX apply, port FrozenAux) of one VGG11 on the same weights."""
    net, variables = _aux_variables(jx, "VGG11", seed=10)
    return (lambda x, t: net.apply(variables, x, t, train=False),
            train_aux.FrozenAux(_port_aux("VGG11", variables)))


@pytest.mark.parametrize("weighted,vicinal,start", [(False, True, 0), (False, False, 0),
                                                    (True, False, 0), (False, True, 4)])
def test_loss_with_elastic_aux_matches_jax(jx, unet_variables, aux_pair, weighted, vicinal,
                                           start):
    """pred_noise, lambda_aux 0.5, radius 0.05, at step 3: the aux term adds
    to loss (with and without the vicinal gate) and weighted_loss; from
    aux_start_step 4 it is 0."""
    b = 8
    rng = np.random.default_rng(11)
    images01 = rng.uniform(0, 1, (b, 16, 16, 3)).astype(np.float32)
    labels = rng.uniform(0, 1, (b, 1)).astype(np.float32)
    emb = rng.uniform(0, 1, (b, 128)).astype(np.float32)
    weights = rng.uniform(0, 1, b).astype(np.float32)
    cfg = dict(image_size=16, channels=3, timesteps=100, objective="pred_noise",
               vicinity_type="hv", cond_drop_prob=0.5)
    jd, td = _pair(jx, unet_variables, **cfg)
    japply, tapply = aux_pair
    info = dict(lambda_aux=0.5, vicinity_radius=0.05, aux_start_step=start, current_step=3)
    key = jx.jax.random.PRNGKey(12)
    jnp = jx.jnp
    args = (unet_variables, key, jnp.asarray(images01), jnp.asarray(labels), jnp.asarray(emb))

    def jax_loss(aux):
        if weighted:
            return jx.jax.jit(lambda *a: jd.weighted_loss(*a, train=True, aux_info=aux)[0])(
                *args, jnp.asarray(weights))
        return jx.jax.jit(lambda *a: jd.loss(
            *a, vicinal_weights=jnp.ones(b) if vicinal else None, kappa=0.2, train=True,
            aux_info=aux)[0])(*args)

    want, plain = jax_loss({**info, "apply": japply}), jax_loss(None)
    keys = jx.jax.random.split(key, 3 if weighted else 6)
    draws = {"t": _t(jx.jax.random.randint(keys[0], (b,), 0, 100)),
             "keep_mask": _t(jx.jax.random.uniform(keys[1], (b,)) < 0.5),
             "noise": _t(jx.jax.random.normal(keys[2], images01.shape))}
    assert 0 < int(draws["keep_mask"].sum()) < b
    port_info = {**info, "apply": tapply}
    if weighted:
        got, term = td.weighted_loss(_t(images01), _t(labels), _t(emb), _t(weights),
                                     draws=draws, aux_info=port_info)
    else:
        got, term = td.loss(_t(images01), _t(labels), _t(emb),
                            vicinal_weights=torch.ones(b) if vicinal else None, kappa=0.2,
                            draws=draws, aux_info=port_info)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    term = float(term)
    np.testing.assert_allclose(term, float(want) - float(plain), rtol=0, atol=1e-5)
    assert (term == 0.0) == (start > 3)


def test_loss_with_aux_info_off_pred_noise_adds_nothing():
    """With aux_info and pred_x0, loss and weighted_loss return (loss, 0)
    without applying the aux net, the loss that of the call without
    aux_info (the JAX package adds the term with pred_noise only)."""
    b = 4
    rng = np.random.default_rng(21)
    images01 = _t(rng.uniform(0, 1, (b, 16, 16, 3)).astype(np.float32))
    labels = _t(rng.uniform(0, 1, (b, 1)).astype(np.float32))
    emb = _t(rng.uniform(0, 1, (b, 128)).astype(np.float32))
    draws = {"t": torch.tensor([3, 20, 50, 90]),
             "keep_mask": torch.tensor([True, False, True, True]),
             "noise": _t(rng.normal(size=(b, 16, 16, 3)).astype(np.float32))}
    diff = GaussianDiffusion(Unet(**CFG), DiffusionConfig(image_size=16, channels=3,
                                                          timesteps=100, objective="pred_x0"))

    def apply(x, t):
        raise AssertionError("the aux net was applied off pred_noise")

    info = dict(apply=apply, lambda_aux=1.0, vicinity_radius=0.0)
    with torch.no_grad():
        plain = diff.loss(images01, labels, emb, draws=draws)
        got, term = diff.loss(images01, labels, emb, draws=draws, aux_info=info)
        w_plain = diff.weighted_loss(images01, labels, emb, torch.ones(b), draws=draws)
        w_got, w_term = diff.weighted_loss(images01, labels, emb, torch.ones(b), draws=draws,
                                           aux_info=info)
    assert float(term) == 0.0 and float(w_term) == 0.0
    torch.testing.assert_close(got, plain, rtol=0, atol=0)
    torch.testing.assert_close(w_got, w_plain, rtol=0, atol=0)


def test_elastic_aux_reaches_the_denoiser_only(aux_pair):
    """The term's gradient reaches model_out through the frozen net, whose
    own weights get none."""
    _, tapply = aux_pair
    diff = GaussianDiffusion(Unet(**CFG), DiffusionConfig(image_size=16, channels=3,
                                                          timesteps=100))
    rng = np.random.default_rng(13)
    x_start = _t(rng.uniform(-1, 1, (4, 16, 16, 3)).astype(np.float32))
    model_out = _t(rng.normal(size=(4, 16, 16, 3)).astype(np.float32)).requires_grad_()
    info = dict(apply=tapply, lambda_aux=1.0, vicinity_radius=0.0)
    term = diff._elastic_aux(x_start, torch.tensor([5, 50, 70, 99]), model_out,
                             torch.ones(4, dtype=torch.bool), torch.rand(4), info)
    term.backward()
    assert float(model_out.grad.abs().max()) > 0
    assert all(p.grad is None for p in tapply.net.parameters())


# ------------------------------------------------------------- the GIF


@pytest.mark.parametrize("c", [1, 3])
def test_save_gif_decodes_with_pil(tmp_path, c):
    from PIL import Image

    frames01 = np.random.default_rng(c).uniform(-0.1, 1.1, (4, 7, 9, 5, c)).astype(np.float32)
    save_gif(frames01, str(tmp_path / "t.gif"), nrow=3, fps=4, stride=1)
    im = Image.open(tmp_path / "t.gif")
    assert im.format == "GIF" and im.n_frames == 4
    assert im.info["duration"] == 250 and im.info["loop"] == 0
    for s in range(4):
        im.seek(s)
        want = (np.clip(make_grid(frames01[s], nrow=3), 0, 1) * 255).astype(np.uint8)
        if c == 1:
            np.testing.assert_array_equal(np.asarray(im.convert("L")), want[..., 0])
        else:
            err = np.abs(np.asarray(im.convert("RGB")).astype(int) - want).max()
            assert err <= GIF_RGB_MAX_ERROR
    save_gif(frames01, str(tmp_path / "s.gif"), nrow=3, stride=3)
    assert Image.open(tmp_path / "s.gif").n_frames == 2


def test_gif_lzw_resets_its_table():
    """Noise frames large enough to fill the 12-bit LZW table many times."""
    from PIL import Image

    frames = [np.random.default_rng(i).integers(0, 256, (150, 170), dtype=np.uint8)
              for i in range(2)]
    im = Image.open(io.BytesIO(encode_gif(frames, 100)))
    for i, f in enumerate(frames):
        im.seek(i)
        np.testing.assert_array_equal(np.asarray(im.convert("L")), f)


# ------------------------------------------------------------- the CLI

MODEL = ["--image_size", "16", "--model_channels", "8", "--channel_mult", "1_2",
         "--train_timesteps", "20", "--device", "cpu"]
AUX = ["--data_name", "synthetic", "--synthetic_n", "64", "--train_batch_size", "8",
       "--vicinity_type", "hv", "--log_every", "1", "--niters", "3", "--save_every", "3",
       "--pred_objective", "pred_noise", "--lambda_aux", "0.1", "--net_aux", "ResNet18",
       "--epoch_aux", "1", "--gif_trajectory", "--interpolation",
       "--eval_mode", "4", "--FID_num_centers", "2", "--nfake_per_label", "2",
       "--sample_timesteps", "3"]


def test_cli_writes_the_aux_cache_gif_and_interpolation(tmp_path, capsys):
    from PIL import Image

    argv = ["--root_path", str(tmp_path), *MODEL, *AUX]
    port_main.main(argv)
    args = parse_opts(argv)
    results = Path(port_main.results_folder(args))
    assert (results.parent / "aux_models" / "model-aux_ResNet18_e1_seed111" / "state.pt"
            ).is_file()
    log = [json.loads(line) for line in open(results / "train_log.jsonl")]
    assert [r["step"] for r in log] == [1, 2, 3]
    assert all(np.isfinite(r["aux"]) for r in log) and any(r["aux"] > 0 for r in log)
    gif = Image.open(results / "trajectory_niters3.gif")
    assert gif.n_frames == 3 and gif.size == (6 * 17 + 1, 6 * 17 + 1)
    png = np.asarray(Image.open(results / "interpolation_niters3.png"))
    assert png.shape == (18, 8 * 17 + 1, 3)
    panels = [png[1:17, 1 + 17 * i:17 * (i + 1)] for i in range(8)]
    assert all(p.std() > 0 for p in panels)
    capsys.readouterr()
    port_main.main([*argv[:-len(AUX)], *AUX[:AUX.index("--gif_trajectory")],
                    *AUX[AUX.index("--eval_mode"):]])
    assert "aux net: loaded cached 'aux_ResNet18_e1_seed111'" in capsys.readouterr().out


# ------------------------------------------------------------- on the card


@pytest.mark.cuda
def test_cuda_trajectory_and_interpolation_launch_kernel_1():
    """On the card: each forward of the trajectory and of the interpolation
    launches kernel #1 once per attention block, and agrees with the CPU
    run from the same weights and noise within 1e-3."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    from ccdm_tpu_torch.ops import attn_block

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = DiffusionConfig(image_size=16, channels=3, timesteps=20, sampling_timesteps=4)
    cpu = GaussianDiffusion(Unet(**CFG, seed=3), cfg)
    card = GaussianDiffusion(Unet(**CFG, seed=3).cuda(), cfg, device="cuda")
    blocks = sum(isinstance(m, FusedLinearAttentionBlock) for m in cpu.model.modules())
    gen = torch.Generator().manual_seed(0)
    emb, noise = torch.rand(2, 128, generator=gen), torch.randn(2, 16, 16, 3, generator=gen)
    before = attn_block.fused_attn_block.launches
    frames = card.ddim_sample(emb.cuda(), cond_scale=1.5, noise=noise.cuda(),
                              save_intermediate=True)
    torch.cuda.synchronize()
    assert attn_block.fused_attn_block.launches - before == 4 * blocks
    want = cpu.ddim_sample(emb, cond_scale=1.5, noise=noise, save_intermediate=True)
    torch.testing.assert_close(frames.cpu(), want, rtol=0, atol=1e-3)
    x1, x2 = torch.rand(1, 16, 16, 3, generator=gen) * 2 - 1, torch.zeros(1, 16, 16, 3)
    n1, n2 = torch.randn(1, 16, 16, 3, generator=gen), torch.randn(1, 16, 16, 3, generator=gen)
    steps = torch.randn(5, 1, 16, 16, 3, generator=gen)
    before = attn_block.fused_attn_block.launches
    got = card.interpolate(x1.cuda(), x2.cuda(), emb[:1].cuda(), t=5, lam=0.5,
                           noise1=n1.cuda(), noise2=n2.cuda(), step_noise=steps.cuda())
    torch.cuda.synchronize()
    assert attn_block.fused_attn_block.launches - before == 5 * blocks
    want = cpu.interpolate(x1, x2, emb[:1], t=5, lam=0.5, noise1=n1, noise2=n2,
                           step_noise=steps)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-3)


@pytest.mark.cuda
def test_cuda_aux_net_trains_and_applies():
    """On the card: one epoch of the ResNet18 regressor, then the elastic
    term through it, finite, with a gradient at model_out. After one epoch
    the output ReLU's input sits near -0.1, where the net's output is 0
    and passes no gradient, so its bias is lifted by 1 to test the path."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (32, 16, 16, 3), dtype=np.uint8)
    labels = rng.uniform(0, 1, 32).astype(np.float32)
    net = train_aux.train_aux_net(images, labels, "ResNet18", epochs=1, batch_size=16,
                                  device="cuda", log_every=0)
    with torch.no_grad():
        net.head.fc3.bias += 1.0
    apply = train_aux.FrozenAux(net)
    diff = GaussianDiffusion(Unet(**CFG).cuda(), DiffusionConfig(image_size=16, channels=3,
                                                                 timesteps=100),
                             device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    model_out = torch.randn(4, 16, 16, 3, device="cuda", generator=gen, requires_grad=True)
    term = diff._elastic_aux(torch.rand(4, 16, 16, 3, device="cuda", generator=gen) * 2 - 1,
                             torch.tensor([1, 30, 60, 99], device="cuda"), model_out,
                             torch.ones(4, dtype=torch.bool, device="cuda"),
                             torch.rand(4, device="cuda", generator=gen),
                             dict(apply=apply, lambda_aux=1.0, vicinity_radius=0.0))
    term.backward()
    assert bool(torch.isfinite(term)) and float(model_out.grad.abs().max()) > 0
