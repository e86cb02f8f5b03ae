"""Port parity of multi-dim labels (Sliced-CCDM): the combiners, the analytic
and ILI embeddings over label vectors, the power_vector dataset, the eval
label rows and the CLI end to end.

The JAX package draws its combiners' weights (PRNGKey(seed + 7)) and the
gaussian W (PRNGKey(seed)) itself; scripts/jax_milestone_to_torch.py writes
those draws where the port reads them, so the port computes JAX's function
on them. Tolerances, each with its reason:
- the five combiners, f32: 1e-5 (a few small matmuls, a softmax and a
  LayerNorm in another framework);
- make_fn_y2h / make_fn_y2cov over 3 and 50 label dims: 1e-5 (sin and cos
  of the same f32 arguments, then the combiner);
- PowerTransformer against ccdm_tpu's (sklearn's QuantileTransformer):
  1e-6 relative, transform and inverse (the same f64 interpolation and
  norm.ppf / norm.cdf);
- make_synthetic_power, load_power_vector and get_eval_labels: exact;
- fn_y2h of a JAX multi-dim ILI cache carried across: 1e-5.
"""

import argparse
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ccdm_tpu.data.power import PowerTransformer as JaxPowerTransformer
from ccdm_tpu.data.power import load_power_vector as jax_load_power_vector
from ccdm_tpu.data.power import make_synthetic_power as jax_make_synthetic_power
from ccdm_tpu.diffusion import DiffusionConfig as JaxDiffusionConfig
from ccdm_tpu.diffusion import GaussianDiffusion as JaxGaussianDiffusion
from ccdm_tpu.embedding import combine as jcombine
from ccdm_tpu.embedding.ili import LabelEmbed as JaxLabelEmbed
from ccdm_tpu.embedding.resolve import build_label_embedding as jax_build_label_embedding
from ccdm_tpu.main import get_eval_labels as jax_get_eval_labels
from ccdm_tpu.models.resnet_embed import ModelY2Cov as JaxY2Cov
from ccdm_tpu.models.resnet_embed import ModelY2H as JaxY2H
from ccdm_tpu.utils.ckpt import save_checkpoint as jax_save_checkpoint
from ccdm_tpu_torch import main as port_main
from ccdm_tpu_torch.data.datasets import DatasetBundle, load_dataset
from ccdm_tpu_torch.data.power import PowerTransformer, load_power_vector, make_synthetic_power
from ccdm_tpu_torch.diffusion import gaussian as port_gaussian
from ccdm_tpu_torch.diffusion.gaussian import DiffusionConfig, GaussianDiffusion
from ccdm_tpu_torch.embedding import combine
from ccdm_tpu_torch.embedding.resolve import build_label_embedding
from ccdm_tpu_torch.opts import parse_opts
from ccdm_tpu_torch.serve import SamplerService
from ccdm_tpu_torch.utils.convert import state_dict_from_jax

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
COMBINATIONS = ["mean", "weighted", "attention", "cross", "cross_attention"]
E = 16  # embedding width: even, and 4 heads of 4


def _t(a):
    return torch.from_numpy(np.array(a))


def _script():
    spec = importlib.util.spec_from_file_location(
        "jax_milestone_to_torch", ROOT / "scripts" / "jax_milestone_to_torch.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    return script


def _draw_variables(shapes, seed):
    """Random variables in a flax tree of `shapes`: kernels scaled by
    1/sqrt(fan-in), biases, scales and weights off their initial values."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = jax.tree_util.keystr(path), leaf.shape
        if len(shape) >= 2:
            a = rng.normal(0, 1 / np.sqrt(np.prod(shape[:-1])), shape)
        elif "bias" in name:
            a = rng.normal(0, 0.2, shape)
        else:
            a = 1 + rng.normal(0, 0.5, shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


# ------------------------------------------------------------- combiners


@pytest.mark.parametrize("kind", COMBINATIONS)
def test_combiners_match_jax(kind):
    d, b = 5, 7
    stacked = np.random.default_rng(1).uniform(0, 1, (d, b, E)).astype(np.float32)
    jmod = jcombine.make_combiner(kind, E, d)
    port = combine.make_combiner(kind, E, d)
    if kind == "mean":
        assert jmod is None and port is None
        want = stacked.mean(0)
    else:
        shapes = jax.eval_shape(lambda k: jmod.init(k, jnp.zeros((d, 1, E))),
                                jax.random.PRNGKey(0))
        variables = _draw_variables(shapes, seed=2)
        want = np.asarray(jax.jit(jmod.apply)(variables, stacked))
        port.load_state_dict(state_dict_from_jax(variables, port))
    with torch.no_grad():
        got = combine.combine(_t(stacked), port).numpy()
    assert got.shape == (b, E)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_combiner_weights_are_read_drawn_and_written(tmp_path):
    """A draw is written where there is no file (not when load-only), and a
    file is read back as it is."""
    load_only = combine.combiner_weights(str(tmp_path), "y2h", "attention", E, 3, 9,
                                         write=False)
    assert not list(tmp_path.iterdir())
    drawn = combine.combiner_weights(str(tmp_path), "y2h", "attention", E, 3, 9)
    path = Path(combine.combiner_path(str(tmp_path), "y2h", "attention", E, 3, 9))
    assert path.is_file() and not any(p.requires_grad for p in drawn.parameters())
    for k, v in load_only.state_dict().items():
        torch.testing.assert_close(drawn.state_dict()[k], v, rtol=0, atol=0)
    torch.save({k: v + 1 for k, v in drawn.state_dict().items()}, path)
    read = combine.combiner_weights(str(tmp_path), "y2h", "attention", E, 3, 9)
    torch.testing.assert_close(read.attn_fc1.bias, drawn.attn_fc1.bias + 1, rtol=0, atol=0)
    assert combine.combiner_weights(str(tmp_path), "y2h", "mean", E, 3, 9) is None


def test_combiner_is_placed_once_then_applied_in_place(tmp_path, monkeypatch):
    """combiner_weights puts the combiner on its device; fn_y2h then applies
    it at every call without moving it."""
    from ccdm_tpu_torch.embedding.analytic import make_fn_y2h

    comb = combine.combiner_weights(str(tmp_path), "y2h", "cross_attention", E, 3, 9,
                                    device="cpu")
    assert {p.device.type for p in comb.parameters()} == {"cpu"}
    fn = make_fn_y2h(E, "sinusoidal", 3, dim_combination="cross_attention", combiner=comb)
    labels = _t(np.random.default_rng(3).uniform(0, 1, (5, 3)).astype(np.float32))
    want = fn(labels)

    def moved(*args, **kwargs):
        raise AssertionError("the combiner was moved at call time")

    monkeypatch.setattr(torch.nn.Module, "to", moved)
    got = fn(labels)
    assert got.shape == (5, E)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# ------------------------------------------------------ analytic embeddings


def _embed_args(**over):
    base = dict(dim_embed=E, y2h_embed_type="sinusoidal", y2cov_embed_type="sinusoidal",
                use_Hy=True, image_size=4, num_channels=1, label_dim=3,
                dim_combination="mean", seed=111, device="cpu")
    base.update(over)
    return argparse.Namespace(**base)


@pytest.mark.parametrize("comb", COMBINATIONS)
@pytest.mark.parametrize("embed_type", ["sinusoidal", "gaussian"])
@pytest.mark.parametrize("label_dim", [3, 50])
def test_analytic_multidim_embeddings_match_jax(label_dim, embed_type, comb, tmp_path):
    """fn_y2h and fn_y2cov (cov_dim 16) per selected dim (all 3; 10 of 50),
    combined; JAX's W and combiner init carried across by the converter;
    scalar labels take dim 0's embedding."""
    args = _embed_args(label_dim=label_dim, y2h_embed_type=embed_type,
                       y2cov_embed_type=embed_type, dim_combination=comb)
    written = _script().convert_embed_models(str(tmp_path / "none"),
                                             str(tmp_path / "embed_models"), args)
    assert len(written) == 2 * (embed_type == "gaussian") + 2 * (comb != "mean")
    fn_y2h, fn_y2cov = build_label_embedding(args, str(tmp_path), bundle=None,
                                             require_cached=True)
    jfn_y2h, jfn_y2cov = jax_build_label_embedding(args, str(tmp_path), bundle=None)
    y = np.random.default_rng(label_dim).uniform(0, 1, (6, label_dim)).astype(np.float32)
    for fn, jfn, width in ((fn_y2h, jfn_y2h, E), (fn_y2cov, jfn_y2cov, 16)):
        for labels in (y, y[:, :1], y[:, 0]):
            got = fn(_t(labels)).numpy()
            want = np.asarray(jax.jit(jfn)(labels))
            assert got.shape == (6, width)
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_analytic_multidim_draws_w_per_selected_dim(tmp_path):
    """Without the converter's file, a run draws W [10, E/2] for 50 label
    dims and writes it beside its combiner; a load-only build reads both."""
    args = _embed_args(label_dim=50, y2h_embed_type="gaussian", use_Hy=False,
                       dim_combination="cross")
    fn_train, _ = build_label_embedding(args, str(tmp_path), bundle=_MultiBundle())
    names = sorted(p.name for p in (tmp_path / "embed_models").iterdir())
    assert names == [f"combiner-y2h_cross_d{E}_n10_seed2030.pt",
                     f"gaussian_W-y2h_d{E}_n10_seed2023.pt"]
    fn_load, _ = build_label_embedding(args, str(tmp_path), bundle=None, require_cached=True)
    y = _t(np.random.default_rng(0).uniform(0, 1, (4, 50)).astype(np.float32))
    torch.testing.assert_close(fn_load(y), fn_train(y), rtol=0, atol=0)


class _MultiBundle:
    label_dim, channels, image_size = 50, 1, 4


# ------------------------------------------------------------ power data


@pytest.mark.parametrize("n,d", [(50, 8), (1500, 8)])
def test_power_transformer_matches_sklearn(n, d, tmp_path):
    """n x d values: 400 (fewer than 1000 quantiles) and 12000 (a subsample
    of 10000 drawn by RandomState(42))."""
    rng = np.random.default_rng(n)
    power = rng.gamma(2.0, 30000.0, (n, d))
    power[0, 0] = 0.0  # an end of the range
    want_t = JaxPowerTransformer().fit(power)
    got_t = PowerTransformer().fit(power)
    probe = np.concatenate([power[:20], rng.gamma(2.0, 30000.0, (5, d)),
                            np.full((1, d), 5e5)])
    for x in (probe, power):
        np.testing.assert_allclose(got_t.transform(x), want_t.transform(x), rtol=1e-6, atol=0)
    v = np.random.default_rng(1).uniform(0, 1, (9, d))
    np.testing.assert_allclose(got_t.inverse_transform(v), want_t.inverse_transform(v),
                               rtol=1e-6, atol=0)
    got_t.save(str(tmp_path / "pt.npz"))
    back = PowerTransformer.load(str(tmp_path / "pt.npz"))
    np.testing.assert_array_equal(back.transform(probe), got_t.transform(probe))


def test_make_synthetic_power_is_jaxs():
    for kw in (dict(), dict(n=40, image_size=16, label_dim=3, seed=7)):
        got, want = make_synthetic_power(**kw), jax_make_synthetic_power(**kw)
        assert got.name == want.name == "power_vector" and got.label_dim == want.label_dim
        np.testing.assert_array_equal(got.images, want.images)
        np.testing.assert_array_equal(got.labels_norm, want.labels_norm)
        np.testing.assert_array_equal(got.labels_raw, want.labels_raw)


@pytest.mark.parametrize("transformer", [False, True])
def test_load_power_vector_is_jaxs(tmp_path, transformer):
    from PIL import Image

    rng = np.random.default_rng(3)
    designs = tmp_path / "designs"
    designs.mkdir()
    for i in range(12):  # names sorted by their integer: 0, 1, 2, ..., 10, 11
        Image.fromarray(rng.integers(0, 256, (16, 16), dtype=np.uint8)).save(
            designs / f"{i}.tiff")
    (designs / "notes.txt").write_text("not a design")
    power = rng.gamma(2.0, 30000.0, (12, 4))
    np.savetxt(tmp_path / "power.csv", power, delimiter=",", header="p0,p1,p2,p3")
    kw = {}
    if transformer:
        kw = dict(power_transformer=PowerTransformer().fit(power))
        jkw = dict(power_transformer=JaxPowerTransformer().fit(power))
    got = load_dataset("power_vector", str(tmp_path), **kw)
    want = jax_load_power_vector(str(designs), str(tmp_path / "power.csv"),
                                 **(jkw if transformer else {}))
    assert got.images.shape == (12, 16, 16, 1) and got.label_dim == 4
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.labels_raw, want.labels_raw)
    if transformer:
        np.testing.assert_allclose(got.labels_norm, want.labels_norm, rtol=1e-6, atol=0)
    else:
        np.testing.assert_array_equal(got.labels_norm, want.labels_norm)
        np.testing.assert_array_equal(got.fn_denormalize(got.labels_norm),
                                      want.fn_denormalize(want.labels_norm))
    (designs / "12.tiff").write_bytes((designs / "0.tiff").read_bytes())
    with pytest.raises(ValueError, match="design files"):
        load_power_vector(str(designs), str(tmp_path / "power.csv"))


def test_load_power_vector_without_pil_says_so(tmp_path, monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_pil(name, *a, **kw):
        if name == "PIL":
            raise ImportError("no PIL")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(ImportError, match="PIL"):
        load_power_vector(str(tmp_path), str(tmp_path / "power.csv"))


# ------------------------------------------------------------ ILI, multi-dim

MLP_DIM = 64  # GroupNorm(8) over 8 channels a group
COV_DIM = 64  # 1 x 8 x 8


@pytest.fixture(scope="module")
def jax_cache(tmp_path_factory):
    """A JAX embed_models/ with a y2h and a y2cov label MLP of random
    weights (seed 3, 1 CNN and 2 MLP epochs in the tags)."""
    root = tmp_path_factory.mktemp("jax_ili")
    embed_dir = root / "embed_models"
    trees = {}
    for tag, module in ((f"y2h_d{MLP_DIM}_e1_m2_seed3", JaxY2H(MLP_DIM)),
                        (f"y2cov_d{COV_DIM}_e1_m2_seed3", JaxY2Cov(COV_DIM))):
        shapes = jax.eval_shape(lambda k: module.init(k, jnp.zeros((2,))), jax.random.PRNGKey(0))
        trees[tag] = _draw_variables(shapes, seed=len(trees) + 5)
        jax_save_checkpoint(str(embed_dir), tag, {"mlp": jax.device_get(trees[tag])})
    return root, trees


def _ili_args(**over):
    base = dict(dim_embed=MLP_DIM, y2h_embed_type="resnet", y2cov_embed_type="resnet",
                use_Hy=True, image_size=8, num_channels=1, seed=3, epoch_cnn_embed=1,
                epoch_net_y2h=2, epoch_cnn_embed_y2cov=1, epoch_net_y2cov=2, label_dim=3,
                dim_combination="mean", device="cpu")
    base.update(over)
    return argparse.Namespace(**base)


def _jax_label_embed(root, args):
    return JaxLabelEmbed(None, str(root), dim_embed=MLP_DIM, y2cov_type="resnet",
                         cov_dim=COV_DIM, epochs_cnn=1, epochs_mlp=2, epochs_cnn_y2cov=1,
                         epochs_mlp_y2cov=2, seed=3, dim_combination=args.dim_combination,
                         require_cached=True, label_dim=args.label_dim)


@pytest.mark.parametrize("comb", ["mean", "attention"])
def test_ili_multidim_cache_carried_across(jax_cache, comb, tmp_path):
    """The label MLP on each of the 3 dims, combined by the mean or by the
    attention combiner of JAX's PRNGKey(10) init, written by the converter."""
    root, _ = jax_cache
    args = _ili_args(dim_combination=comb)
    written = _script().convert_embed_models(str(root / "embed_models"),
                                             str(tmp_path / "embed_models"), args)
    want_files = {f"y2h_d{MLP_DIM}_e1_m2_seed3", f"y2cov_d{COV_DIM}_e1_m2_seed3"}
    if comb != "mean":
        want_files.add(f"combiner-y2h_{comb}_d{MLP_DIM}_n3_seed10.pt")
    assert set(written) == want_files
    fn_y2h, _ = build_label_embedding(args, str(tmp_path), bundle=None, require_cached=True)
    jax_fn = _jax_label_embed(root, args).fn_y2h
    y = np.random.default_rng(8).uniform(0, 1, (5, 3)).astype(np.float32)
    for labels in (y, y[:, 0]):
        got = fn_y2h(_t(labels)).numpy()
        np.testing.assert_allclose(got, np.asarray(jax_fn(labels)), rtol=1e-5, atol=1e-5)


def test_ili_multidim_resnet_y2cov_raises_where_jax_fails(jax_cache, tmp_path):
    """ccdm_tpu's resnet fn_y2cov flattens [B, 3] labels to [B*3] rows, so
    its H(y) reshape to [B, C, H, W] fails; the port's fn_y2cov refuses such
    labels with a ValueError naming that, and takes scalar labels as JAX's
    does."""
    root, trees = jax_cache
    args = _ili_args()
    _script().convert_embed_models(str(root / "embed_models"), str(tmp_path / "embed_models"),
                                   args)
    jle = _jax_label_embed(root, args)
    y = np.random.default_rng(9).uniform(0, 1, (4, 3)).astype(np.float32)
    assert jle.fn_y2cov(y).shape == (12, COV_DIM)
    cfg = dict(image_size=8, channels=1, use_Hy=True)
    jdiff = JaxGaussianDiffusion(lambda *a, **k: None, JaxDiffusionConfig(**cfg),
                                 fn_y2cov=jle.fn_y2cov)
    with pytest.raises(TypeError, match="reshape"):
        jdiff.convert_y_to_cov(jnp.asarray(y))
    _, fn_y2cov = build_label_embedding(args, str(tmp_path), bundle=None, require_cached=True)
    port = GaussianDiffusion(torch.nn.Identity(), DiffusionConfig(**cfg), fn_y2cov=fn_y2cov)
    with pytest.raises(ValueError, match="ili.py:635"):
        port.convert_y_to_cov(_t(y))
    np.testing.assert_allclose(fn_y2cov(_t(y[:, 0])).numpy(),
                               np.asarray(jle.fn_y2cov(y[:, 0])), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ eval labels


@pytest.mark.parametrize("eval_mode", [1, 2, 3, 4])
def test_get_eval_labels_rows_are_jaxs(eval_mode):
    rng = np.random.default_rng(eval_mode)
    raw = np.round(rng.uniform(0, 1, (30, 3)), 1)
    train = raw[::2]
    bundle = DatasetBundle("power_vector", np.zeros((15, 4, 4, 1), np.uint8), train, train,
                           None, None, eval_labels_raw=raw)
    args = argparse.Namespace(eval_mode=eval_mode, FID_num_centers=5)
    got, want = port_main.get_eval_labels(bundle, args), jax_get_eval_labels(bundle, args)
    assert got.ndim == 2 and got.shape[1] == 3
    np.testing.assert_array_equal(got, want)
    bundle.eval_labels_raw = None
    np.testing.assert_array_equal(port_main.get_eval_labels(bundle, args),
                                  jax_get_eval_labels(bundle, args))


# ------------------------------------------------------------ the CLI

MODEL = ["--image_size", "16", "--model_channels", "8", "--channel_mult", "1_2",
         "--train_timesteps", "20", "--pred_objective", "pred_x0", "--device", "cpu"]
MULTI = ["--data_name", "synthetic_power", "--label_dim", "4", "--synthetic_n", "32",
         "--train_batch_size", "16", "--vicinity_type", "shv", "--num_projections", "0",
         "--log_every", "1", "--niters", "2", "--save_every", "2",
         "--y2h_embed_type", "resnet", "--epoch_cnn_embed", "1", "--epoch_net_y2h", "2",
         "--batch_size_embed", "16", "--dim_combination", "cross_attention",
         "--eval_mode", "1", "--nfake_per_label", "2", "--sample_timesteps", "2"]


def test_multidim_cli_trains_samples_and_serves(tmp_path, monkeypatch, capsys):
    """synthetic_power, 4 label dims: the sliced vicinal weights get labels
    of width 4 (1 projection, auto-set), the eval rows get index-keyed
    grids, --comp_FID prints its skip line; then a service with --label_dim
    4 serves 1-D labels through dim 0 of the same embedding."""
    widths = []
    sliced = port_gaussian.sliced_batch_weights

    def spy(labels2d, vecs, *a, **kw):
        widths.append((labels2d.shape[1], vecs.shape))
        return sliced(labels2d, vecs, *a, **kw)

    monkeypatch.setattr(port_gaussian, "sliced_batch_weights", spy)
    argv = ["--root_path", str(tmp_path), *MODEL, *MULTI, "--comp_FID"]
    trainer = port_main.main(argv)
    out = capsys.readouterr().out
    assert "Auto-set num_projections=1 for label_dim=4" in out
    assert "comp_FID skipped" in out
    assert [w for w, _ in widths] == [4, 4] and 1 in widths[0][1]
    args = parse_opts(argv)
    bundle = load_dataset("synthetic_power", **port_main.dataset_kwargs(args))
    assert bundle.label_dim == 4 and trainer.label_dim == 4
    rows = port_main.get_eval_labels(bundle, args)
    assert rows.shape == (32, 4)
    folder = Path(port_main.fake_data_folder(args, len(rows)))
    assert sorted(p.name for p in folder.iterdir()) == [f"sample_{i:05d}.png"
                                                       for i in range(32)]
    setting = Path(port_main.results_folder(args)).parent
    assert (setting / "embed_models" / "combiner-y2h_cross_attention_d128_n4_seed118.pt"
            ).is_file()
    log = [json.loads(line) for line in open(setting / "results" / "train_log.jsonl")]
    assert [r["step"] for r in log] == [1, 2] and all(np.isfinite(r["loss"]) for r in log)

    serve_args = parse_opts(["--root_path", str(tmp_path), *MODEL, "--data_name",
                             "synthetic_power", "--num_channels", "1", "--label_dim", "4",
                             "--y2h_embed_type", "resnet", "--dim_combination",
                             "cross_attention", "--serve_milestone", "2",
                             "--sample_timesteps", "2"])
    service = SamplerService(serve_args, max_batch=2, warm=False, device="cpu")
    assert service.fn_y2h(torch.tensor([[0.3], [0.6]])).shape == (2, 128)
    assert service.fn_y2h(_t(rows[:2].astype(np.float32))).shape == (2, 128)
    images = service.generate(np.array([0.3, 0.6], np.float32))
    assert images.dtype == np.uint8 and images.shape == (2, 16, 16, 1)
