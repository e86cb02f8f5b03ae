"""Port parity of the CCGM protocol (ccdm_tpu_torch/eval/protocol.py) on a
SteeringAngle bundle built from rendered arrays (signed labels, so the
window and the Label Score take the min(min_label, 0) shift).

The port trains the pinned backbones (one epoch each on 16 images of
16x16, ResNetEval cut to one block a stage in both packages); the test
writes them in JAX's layout (utils/convert.jax_variables_from_state_dict)
as JAX's orbax entry; both packages' run_ccgm_eval score the same fakes
with every metric and analysis flag (sklearn hidden: t-SNE takes its PCA
fallback), each fitting its NIQE model. Tolerances, each with its reason:
- the fingerprint: the same string (one checkpoint, one identity);
- SFID, FID, LS and iFID within 1e-3 relative (features of f32 convs in
  another framework, then sqrtm);
- Diversity equal (argmaxes of the same logits to ~1e-6);
- PRDC within 1/N of the set size (a distance on the boundary of a radius
  may fall either side in another matmul order);
- NIQE and its control exactly (the same numpy code on the same images);
- the frequency spectra exactly, the t-SNE's PCA fallback to 1e-4 of its
  largest |value|.
"""

import importlib.util
import sys
from pathlib import Path
from typing import Sequence

import numpy as np
import pytest
import torch

from ccdm_tpu.eval import backbones as jbackbones
from ccdm_tpu.eval import train_backbones as jtb
from ccdm_tpu.eval.protocol import run_ccgm_eval as jax_run_ccgm_eval
from ccdm_tpu.utils.ckpt import save_checkpoint as jax_save_checkpoint
from ccdm_tpu_torch.data.datasets import steeringangle_from_arrays
from ccdm_tpu_torch.eval import train_backbones as tb
from ccdm_tpu_torch.eval.protocol import run_ccgm_eval
from ccdm_tpu_torch.opts import parse_opts
from ccdm_tpu_torch.utils.convert import jax_variables_from_state_dict

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SMALL = (1, 1, 1, 1)
SEED, SIZE, N = 3, 16, 16
ANGLES = np.repeat(np.linspace(-60.0, 60.0, 4), 4)
NUM_CLASSES = 4  # min(49, unique labels)
TAG = f"evalnets_SteeringAngle_{SIZE}_seed{SEED}"
EVAL_ARGV = ["--device", "cpu", "--data_name", "SteeringAngle", "--image_size", str(SIZE),
             "--min_label", "-80", "--max_label", "80", "--seed", str(SEED), "--niters", "5",
             "--sample_timesteps", "10", "--epochs_eval_ae", "1", "--epochs_eval_cnn", "1",
             "--FID_radius", "20", "--FID_num_centers", "3", "--comp_prdc",
             "--prdc_nearest_k", "3", "--comp_niqe", "--comp_intra_fid", "--knn_analysis",
             "--frequency_analysis", "--tsne_analysis"]


def _example(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class _SmallResNetEval(jbackbones.ResNetEval):
    num_blocks: Sequence[int] = SMALL


@pytest.fixture(scope="module")
def small_resnets():
    """ResNetEval at one block a stage in both packages."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jtb, "ResNetEval", _SmallResNetEval)
    mp.setattr(tb, "EVAL_RESNET_BLOCKS", SMALL)
    yield
    mp.undo()


def _roads(angles, seed):
    """[N, 3, 16, 16] uint8: render_road at 32x32 (its horizon needs more
    than 16 rows), averaged over 2x2 blocks."""
    road = _example("make_fixture_sa64").render_road
    rng = np.random.default_rng(seed)
    big = np.stack([road(float(a), 2 * SIZE, rng) for a in angles]).astype(np.float32)
    return big.reshape(len(angles), 3, SIZE, 2, SIZE, 2).mean((3, 5)).round().astype(np.uint8)


@pytest.fixture(scope="module")
def bundle():
    return steeringangle_from_arrays(_roads(ANGLES, 2026), ANGLES)


@pytest.fixture(scope="module")
def fakes():
    """Two renders a label, a noisier stand-in for a generator's samples."""
    rng = np.random.default_rng(7)
    images = _roads(ANGLES, 8).transpose(0, 2, 3, 1)
    noisy = images.astype(np.float32) + rng.normal(0, 12, images.shape)
    return np.clip(noisy, 0, 255).astype(np.uint8), ANGLES.copy()


@pytest.fixture(scope="module")
def pinned(small_resnets, bundle, tmp_path_factory):
    """(JAX's --eval_ckpt_path, the port's, the port's fingerprint): the
    port trains the backbones; the same weights go into JAX's orbax entry."""
    port_root, jax_root = (tmp_path_factory.mktemp(name) for name in ("port", "jax"))
    nets = tb.get_eval_models(bundle, str(port_root / "eval_models"), NUM_CLASSES,
                              epochs_ae=1, epochs_cnn=1, seed=SEED)
    tree = {name: jax_variables_from_state_dict(net.state_dict(), net)
            for name, net in (("ae", nets["fid"]), ("cls", nets["div"]), ("reg", nets["ls"]))}
    jax_save_checkpoint(str(jax_root / "eval_models"), TAG, tree)
    return jax_root, port_root, nets["fingerprint"]


def _eval(run, root, bundle, fakes, setting, *flags):
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "sklearn", None)
        mp.setitem(sys.modules, "sklearn.manifold", None)
        return run(parse_opts([*EVAL_ARGV, *flags, "--eval_ckpt_path", str(root)]), bundle,
                   *fakes, str(setting), 12.5)


@pytest.fixture(scope="module")
def jax_eval(pinned, bundle, fakes, tmp_path_factory):
    setting = tmp_path_factory.mktemp("jax_setting")
    return setting, _eval(jax_run_ccgm_eval, pinned[0], bundle, fakes, setting)


def _metric_lines(path):
    """The lines of an eval_results file but print(args)'s."""
    return [line for line in Path(path).read_text().splitlines()
            if line.strip() and not line.startswith("Namespace(")]


def test_protocol_matches_jax_line_by_line(pinned, jax_eval, bundle, fakes, tmp_path):
    jax_setting, want = jax_eval
    got = _eval(run_ccgm_eval, pinned[1], bundle, fakes, tmp_path)

    for name in ("sfid", "ls"):  # (mean, std)
        np.testing.assert_allclose(got[name], want[name], rtol=1e-3, err_msg=name)
    np.testing.assert_allclose(got["fid"], want["fid"], rtol=1e-3)
    np.testing.assert_allclose(got["ifid"], want["ifid"], rtol=1e-3)
    assert got["diversity"] == want["diversity"]
    for name in ("prdc", "prdc_ctrl"):
        n = N if name == "prdc" else N // 2
        for k, v in want[name].items():
            assert abs(got[name][k] - v) <= 1.0 / n + 1e-7, (name, k)
    assert got["niqe"] == want["niqe"] and got["niqe_ctrl"] == want["niqe_ctrl"]
    assert np.isfinite(got["sfid"][0]) and np.isfinite(got["fid"])

    got_lines, want_lines = _metric_lines(got["eval_path"]), _metric_lines(want["eval_path"])
    assert len(got_lines) == len(want_lines) == 14
    for g, w in zip(got_lines, want_lines):
        assert g.split(":")[0] == w.split(":")[0]
        if g.split(":")[0].strip() in ("Eval backbones", "Radius", "Sampling Steps",
                                       "Sampling Time", "Diversity",
                                       "NIQE (native, dataset-calibrated)"):
            assert g == w
    # JAX's fingerprint of the orbax entry is the port's of its own state
    assert got_lines[1] == want_lines[1] == f" Eval backbones: {pinned[2]}."
    assert got["fingerprint"] == pinned[2]

    npz = lambda setting, name: np.load(Path(setting) / "analysis" / name)
    for key in ("real_spectrum", "fake_spectrum"):
        np.testing.assert_array_equal(npz(tmp_path, "frequency_spectrum.npz")[key],
                                      npz(jax_setting, "frequency_spectrum.npz")[key])
    for key in ("real_2d", "fake_2d"):
        w = npz(jax_setting, "tsne.npz")[key]
        np.testing.assert_allclose(npz(tmp_path, "tsne.npz")[key], w, rtol=0,
                                   atol=1e-4 * np.abs(w).max())
    assert (tmp_path / "analysis" / "knn_grid.png").is_file()
    windows = np.load(tmp_path / "fid_ls_entropy_over_centers_sampstep10.npz")
    jwindows = np.load(Path(jax_setting) / "fid_ls_entropy_over_centers_sampstep10.npz")
    assert sorted(windows.files) == sorted(jwindows.files)
    np.testing.assert_array_equal(windows["centers"], jwindows["centers"])
    np.testing.assert_array_equal(windows["nrealimgs"], jwindows["nrealimgs"])
    # each package fitted its own NIQE model: the same npz
    for key in ("mu", "cov", "patch"):
        a = np.load(pinned[0] / "eval_models" / "niqe_model_p16_n8_seed3.npz")[key]
        np.testing.assert_array_equal(
            np.load(pinned[1] / "eval_models" / "niqe_model_p16_n8_seed3.npz")[key], a)


def test_is_and_fid_only_branch(pinned, jax_eval, bundle, fakes, tmp_path):
    """--comp_IS_and_FID_only: the FID of the shuffled full sets is the
    protocol's FID (inception_score itself is held to JAX's in
    test_torch_eval_metrics.py), and no eval_results file."""
    _, want = jax_eval
    got = _eval(run_ccgm_eval, pinned[1], bundle, fakes, tmp_path, "--comp_IS_and_FID_only")
    np.testing.assert_allclose(got["fid"], want["fid"], rtol=1e-3)
    assert np.isfinite(got["is"]).all() and 1.0 <= got["is"][0] <= NUM_CLASSES
    assert not (tmp_path / "eval_results_niters5.txt").exists()
