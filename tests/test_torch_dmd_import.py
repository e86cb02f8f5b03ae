"""A trained JAX DMD2-M student and its teacher carried into the port
(scripts/jax_milestone_to_torch.py --jax_dmd_milestone, --jax_milestone).

The Cell-200 64x64 run of artifacts/cell200_r5: the teacher (Unet dim 32,
mults 1_2_2_4, 1 channel, 10000 steps) and the student distilled from it
(SNGAN, gene_ch = disc_ch = 64, dim_z 256, 3000 DMD steps, two D steps
each) go through the script. The carried DMD tree reads step 3000 and the
optimizers' counts 3000 and 6000; the student's eval-mode one-step
forward and the teacher's EMA UNet forward match JAX's on the same inputs
within 1e-4 (f32 products of a trained net in another framework; the
teacher at 32x32, which its three halvings fit, to keep the test short).
Their ILI nets (embed_models/) are not in the repository, so both take a
drawn labels_emb, and serve_dmd's service is built on the sinusoidal
embedding: it loads the carried generator and answers with one-step
images. `artifacts/` is left out of `git archive` exports: without it the
test skips.
"""

import importlib.util
import tarfile
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
RUN = ROOT / "artifacts" / "cell200_r5"
STUDENT, TEACHER = RUN / "dmd" / "student_model-dmd-3000.tar.gz", RUN / "teacher_model-10000.tar.gz"
COMMON = ["--data_name", "Cell200", "--image_size", "64", "--num_channels", "1",
          "--model_channels", "32", "--channel_mult", "1_2_2_4", "--setting_name", "Setup_CCDM",
          "--device", "cpu"]
DMD_ARGV = [*COMMON, "--gan_arch", "sngan", "--gene_ch", "64", "--disc_ch", "64",
            "--dim_z", "256"]

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    for archive in (STUDENT, TEACHER):
        if not archive.is_file():
            pytest.skip(f"{archive.relative_to(ROOT)} is absent (artifacts/ is not exported)")
    tmp = tmp_path_factory.mktemp("cell200")
    for archive, where in ((STUDENT, "dmd_results"), (TEACHER, "results")):
        with tarfile.open(archive) as tar:
            tar.extractall(tmp / "jax" / where, filter="data")
    spec = importlib.util.spec_from_file_location(
        "jax_milestone_to_torch", ROOT / "scripts" / "jax_milestone_to_torch.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    port = ["--root_path", str(tmp / "port")]
    script.main(["--jax_results", str(tmp / "jax" / "dmd_results"), "--jax_dmd_milestone",
                 "3000", *port, *DMD_ARGV])
    script.main(["--jax_results", str(tmp / "jax" / "results"), "--jax_milestone", "10000",
                 *port, *COMMON])
    from ccdm_tpu.utils.ckpt import load_checkpoint

    return tmp, load_checkpoint(str(tmp / "jax" / "dmd_results"), "dmd-3000")


def _dmd_args(tmp, *extra):
    from ccdm_tpu_torch.dmd_main import parse_opts_dmd

    return parse_opts_dmd(["--root_path", str(tmp / "port"), *DMD_ARGV, *extra])


def test_dmd_tree_carries_the_training_state(carried):
    from ccdm_tpu_torch.dmd_main import dmd_results_folder
    from ccdm_tpu_torch.utils.ckpt import load_checkpoint

    tmp, jax_tree = carried
    tree = load_checkpoint(dmd_results_folder(_dmd_args(tmp)), "dmd-3000")
    assert tree["step"] == int(np.asarray(jax_tree["step"])) == 3000
    assert tree["gen_opt"]["count"] == 3000 and tree["gui_opt"]["count"] == 6000
    n_d = len(tree["gui_params"]["netD"])
    assert len(tree["gui_opt"]["mu"]) == n_d + len(tree["gui_params"]["fake_unet"])
    # netD's spectral norms and netG's BatchNorm statistics came across, trained
    assert max(float(t.abs().max()) for t in tree["netD_stats"]) > 1.0
    assert len(tree["gen_stats"]) == 2 * 2 * 4 + 2


def test_student_forward_matches_jax(carried):
    import jax

    from ccdm_tpu.models.sngan import SNGANGenerator as JaxG
    from ccdm_tpu_torch.dmd_main import build_gan, dmd_results_folder
    from ccdm_tpu_torch.training.dmd import load_generator
    from ccdm_tpu_torch.utils.ckpt import load_checkpoint

    tmp, jax_tree = carried
    rng = np.random.default_rng(0)
    z = rng.normal(size=(3, 256)).astype(np.float32)
    emb = rng.uniform(size=(3, 128)).astype(np.float32)
    jG = JaxG(dim_z=256, nc=1, img_size=64, gene_ch=64)
    variables = {"params": jax_tree["gen_params"], "batch_stats": jax_tree["gen_stats"]}
    want = np.asarray(jax.jit(lambda v, a, b: jG.apply(v, a, b, train=False))(variables, z, emb))
    args = _dmd_args(tmp)
    netG = load_generator(build_gan(args, 1, 64)[0],
                          load_checkpoint(dmd_results_folder(args), "dmd-3000")).eval()
    with torch.no_grad():
        got = netG(torch.from_numpy(z), torch.from_numpy(emb), train=False)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-4, atol=1e-4)
    assert float(np.std(want)) > 0.05


def test_teacher_ema_forward_matches_jax(carried):
    import jax

    from ccdm_tpu.models import Unet as JaxUnet
    from ccdm_tpu_torch.main import build_model, results_folder
    from ccdm_tpu_torch.opts import parse_opts
    from ccdm_tpu_torch.serve import ema_model_from_milestone

    tmp, _ = carried
    script_state = importlib.util.spec_from_file_location(
        "jax_milestone_to_torch", ROOT / "scripts" / "jax_milestone_to_torch.py")
    script = importlib.util.module_from_spec(script_state)
    script_state.loader.exec_module(script)
    args = parse_opts(["--root_path", str(tmp / "port"), *COMMON])
    jax_state = script.restore_jax_state(str(tmp / "jax" / "results"), 10000, args)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 32, 32, 1)).astype(np.float32)
    t = np.array([5, 800])
    emb = rng.uniform(size=(2, 128)).astype(np.float32)
    keep = np.array([True, False])
    jmodel = JaxUnet(dim=32, dim_mults=(1, 2, 2, 4), in_channels=1)
    variables = {"params": jax_state.ema_params, "batch_stats": jax_state.ema_batch_stats}
    want = np.asarray(jax.jit(lambda v, *a: jmodel.apply(v, *a, train=False))(
        variables, x, t, emb, keep))
    model = ema_model_from_milestone(build_model(args, 64, 1), results_folder(args), 10000)
    with torch.no_grad():
        got = model.eval()(*map(torch.from_numpy, (x, t, emb, keep))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_serve_dmd_serves_the_carried_student(carried):
    from ccdm_tpu_torch.serve import GeneratorService

    tmp, _ = carried
    service = GeneratorService(_dmd_args(tmp, "--serve_milestone", "3000"), max_batch=2,
                               device="cpu")
    images = service.generate(np.array([0.1, 0.5, 0.9], np.float32), seed=0)
    assert images.shape == (3, 64, 64, 1) and images.dtype == np.uint8
    assert images.std() > 0
