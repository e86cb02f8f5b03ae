"""A trained JAX milestone carried into the port (scripts/jax_milestone_to_torch.py).

The SteeringAngle 64x64 run of artifacts/sa64_r5 (Unet dim 32, mults
1_2_2_4, 5000 steps) is restored, converted and written as a port milestone;
the port's --serve_milestone loader reads its EMA weights back, and their
f32 UNet forward matches JAX's on the same inputs and labels_emb to 1e-4,
with the resnet blocks as the reference composition and as the plain
versions of kernels #10 + #11. These are the first weights of any port
test that were trained, not drawn (its resnet norm gains moved up to 3.8%
from their initial 1 in 5000 steps). The forward
runs at 32x32 (the UNet is convolutional; the weights fit any size that
halves three times) to keep the test short. `artifacts/` is left out of
`git archive` exports: without it the test skips.
"""

import tarfile
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
ARCHIVE = ROOT / "artifacts" / "sa64_r5" / "model-5000.tar.gz"
PORT_ARGV = ["--data_name", "SteeringAngle", "--image_size", "64", "--model_channels", "32",
             "--channel_mult", "1_2_2_4", "--num_channels", "3", "--device", "cpu"]

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    if not ARCHIVE.is_file():
        pytest.skip(f"{ARCHIVE.relative_to(ROOT)} is absent (artifacts/ is not exported)")
    import importlib.util

    tmp = tmp_path_factory.mktemp("sa64")
    with tarfile.open(ARCHIVE) as tar:
        tar.extractall(tmp / "jax", filter="data")
    spec = importlib.util.spec_from_file_location(
        "jax_milestone_to_torch", ROOT / "scripts" / "jax_milestone_to_torch.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    argv = ["--root_path", str(tmp / "port"), *PORT_ARGV]
    script.main(["--jax_results", str(tmp / "jax"), "--jax_milestone", "5000", *argv])
    from ccdm_tpu_torch.opts import parse_opts

    args = parse_opts(argv)
    return script.restore_jax_state(str(tmp / "jax"), 5000, args), args


def test_milestone_tree_carries_the_training_state(converted):
    from ccdm_tpu_torch.main import results_folder
    from ccdm_tpu_torch.utils.ckpt import load_checkpoint

    jax_state, args = converted
    tree = load_checkpoint(results_folder(args), 5000)
    assert tree["step"] == int(jax_state.step) == 5000
    assert tree["ema_step"] == int(jax_state.ema_step)
    assert tree["opt_state"]["count"] == 5000
    gains = [np.asarray(block[g]) for block in jax_state.ema_params.values()
             if isinstance(block, dict) for g in ("norm1_g", "norm2_g") if g in block]
    assert len(gains) == 2 * 19  # both gains of all 19 resnet blocks: trained, not initial
    assert max(float(np.abs(g - 1).max()) for g in gains) > 0.03


@pytest.mark.parametrize("fused", [False, True])
def test_ema_forward_matches_jax(converted, fused, monkeypatch):
    import jax

    from ccdm_tpu.models import Unet as JaxUnet
    from ccdm_tpu_torch.main import build_model, results_folder
    from ccdm_tpu_torch.ops import resnet_block
    from ccdm_tpu_torch.serve import ema_model_from_milestone

    jax_state, args = converted
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    t = np.array([3, 700])
    emb = rng.normal(size=(2, 128)).astype(np.float32)
    keep = np.array([True, False])
    variables = {"params": jax_state.ema_params, "batch_stats": jax_state.ema_batch_stats}
    jmodel = JaxUnet(dim=32, dim_mults=(1, 2, 2, 4), in_channels=3)
    want = np.asarray(jax.jit(lambda v, *a: jmodel.apply(v, *a, train=False))(
        variables, x, t, emb, keep))

    model = ema_model_from_milestone(build_model(args, 64, 3), results_folder(args), 5000)
    monkeypatch.setattr(resnet_block, "USE_FUSED", fused)
    with torch.no_grad():
        got = model.eval()(*map(torch.from_numpy, (x, t, emb, keep))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
