"""The port's DMD2-M entry points end to end on the CPU
(ccdm_tpu_torch/dmd_main.py, serve_dmd.py and serve.GeneratorService).

- `dmd_main` on the synthetic set at 64x64 (1 channel, 64 images: the
  loader's default of 512 cut for time), a Unet(dim 8, mults 1_2) teacher
  in its smoke mode, SNGAN at width 4, DiffAugment, 2 iterations of batch
  8, the counterpart of tests/test_dmd_ccgan.py:59 and :155 in one run:
  the eval-mode grid sample_2.png, the milestone, every eval label's h5
  (6 uint8 images) and grid, --comp_FID writing eval_results_niters2.txt
  with SFID, LS, PRDC and NIQE and the per-center npz, --interpolation and
  --sefa writing their PNGs; the D step's train-mode fakes move netG's
  statistics. The eval ResNets are cut to one block a stage.
- A resume from milestone 2 to 3: the tree it writes reads step 3 and
  both optimizers' counts 3.
- `serve_dmd`'s service on dmd_main's argv finds what dmd_main wrote
  (<setting>/dmd_results/model-dmd-2) and takes the teacher's embedding,
  where JAX's serve_dmd raises FileNotFoundError on the milestone its own
  dmd_main writes (it looks under <setting>/results).
- The service's API as tests/test_serve.py:98-160 holds JAX's: uint8
  images, the same per seed and different across seeds, cond_scale and
  too many labels refused (ValueError, HTTP 400), a missing milestone a
  FileNotFoundError, and the HTTP round trip.
"""

import base64
import io
import json
import os
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from ccdm_tpu_torch import dmd_main
from ccdm_tpu_torch.data import datasets
from ccdm_tpu_torch.eval import train_backbones as tb
from ccdm_tpu_torch.serve import GeneratorService, serve
from ccdm_tpu_torch.training.dmd import stats_of
from ccdm_tpu_torch.utils.ckpt import load_checkpoint

pytest.importorskip("h5py")
torch.set_num_threads(2)

ARGV = ["--device", "cpu", "--data_name", "synthetic", "--image_size", "64",
        "--num_channels", "1", "--model_channels", "8", "--channel_mult", "1_2",
        "--train_batch_size", "8", "--num_D_steps", "1", "--train_timesteps", "20",
        "--gene_ch", "4", "--disc_ch", "4", "--dim_z", "16", "--nfake_per_label", "6",
        "--samp_batch_size", "6", "--kappa", "0", "--eval_mode", "1", "--gan_DiffAugment"]
EVAL = ["--comp_FID", "--FID_radius", "0.1", "--FID_num_centers", "3", "--comp_prdc",
        "--comp_niqe", "--niqe_patch", "32", "--epochs_eval_ae", "1", "--epochs_eval_cnn", "1"]
N_IMAGES = 64


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The root of one run: 2 iterations with the eval and both analyses."""
    tmp = tmp_path_factory.mktemp("dmd_main")
    mp = pytest.MonkeyPatch()
    load = datasets.load_dataset
    mp.setattr(datasets, "load_dataset",
               lambda name, path, **kw: load(name, path, **kw, n=N_IMAGES))
    mp.setattr(tb, "EVAL_RESNET_BLOCKS", (1, 1, 1, 1))
    try:
        trainer = dmd_main.main([*ARGV, "--root_path", str(tmp), "--eval_ckpt_path", str(tmp),
                                 "--niters", "2", "--sample_every", "2", "--save_every", "2",
                                 *EVAL, "--interpolation", "--sefa"])
        yield tmp, trainer, mp
    finally:
        mp.undo()


def _setting(tmp) -> Path:
    return Path(tmp) / "output" / "synthetic_64" / "Setup1"


def test_dmd_main_trains_samples_and_writes_its_artifacts(root):
    tmp, trainer, _ = root
    results = _setting(tmp) / "dmd_results"
    assert trainer.step == 2
    assert (results / "sample_2.png").is_file()
    assert (results / "model-dmd-2" / "state.pt").is_file()
    log = [json.loads(line) for line in open(results / "train_log.jsonl")]
    assert [r["step"] for r in log] == [1] and np.isfinite(list(log[0].values())).all()
    dump = results / "fake_data_onestep_niters2"
    h5s = sorted(dump.glob("*.h5"))
    import h5py

    assert len(h5s) == len(np.unique(trainer.train_labels.numpy())) > 20
    with h5py.File(h5s[0], "r") as f:
        assert f["fake_images_i"].shape == (6, 64, 64, 1)
        assert f["fake_images_i"].dtype == np.uint8 and f["fake_labels_i"].shape == (6,)
    assert len(list(dump.glob("sample_*.png"))) == len(h5s)
    assert sorted(os.listdir(results / "analysis")) == ["interpolation.png", "sefa.png"]
    imgs, _ = trainer.sample_given_labels(np.linspace(0.1, 0.9, 4), batch_size=4)
    assert imgs.shape == (4, 64, 64, 1) and imgs.dtype == np.uint8
    # the D step draws its fakes from a train-mode netG: its statistics move
    before = [t.clone() for t in stats_of(trainer.netG)]
    trainer.d_step(torch.Generator().manual_seed(0))
    assert any(not torch.equal(a, b) for a, b in zip(before, stats_of(trainer.netG)))


def test_comp_fid_writes_the_student_eval(root):
    tmp = _setting(root[0])
    text = (tmp / "eval_results_niters2.txt").read_text()
    for key in ("SFID:", "LS:", "PRDC", "NIQE"):
        assert key in text, key
    assert list(tmp.glob("fid_ls_entropy_over_centers_*.npz"))
    assert np.isfinite(root[1].eval_results["fid"])


def test_resume_from_a_milestone(root):
    tmp, _, _ = root
    trainer = dmd_main.main([*ARGV, "--root_path", str(tmp), "--niters", "3",
                             "--resume_niter", "2", "--save_every", "100"])
    tree = load_checkpoint(str(_setting(tmp) / "dmd_results"), "dmd-3")
    assert trainer.step == tree["step"] == 3
    assert tree["gen_opt"]["count"] == tree["gui_opt"]["count"] == 3
    two = load_checkpoint(str(_setting(tmp) / "dmd_results"), "dmd-2")
    assert two["gen_opt"]["count"] == 2
    assert not torch.equal(tree["gen_params"][0], two["gen_params"][0])


@pytest.fixture(scope="module")
def service(root):
    args = dmd_main.parse_opts_dmd([*ARGV, "--root_path", str(root[0]),
                                    "--serve_milestone", "2", "--samp_batch_size", "4"])
    return GeneratorService(args, max_batch=4, max_labels=16, device="cpu")


def test_serve_dmd_finds_what_dmd_main_wrote_where_jax_raises(root, service, tmp_path,
                                                              monkeypatch):
    import jax
    import jax.numpy as jnp

    from ccdm_tpu import serve_dmd as jax_serve_dmd
    from ccdm_tpu.models.sngan import SNGANGenerator
    from ccdm_tpu.utils import compilation_cache
    from ccdm_tpu.utils.ckpt import checkpoint_exists, save_checkpoint

    tree = load_checkpoint(str(_setting(root[0]) / "dmd_results"), "dmd-2")
    got = [p.detach() for p in service.netG.parameters()]
    assert all(torch.equal(a, b) for a, b in zip(got, tree["gen_params"]))
    assert service.loaded_milestone == 2 and service.warm

    # JAX's dmd_main writes <setting>/dmd_results/model-dmd-N (dmd_main.py:139,
    # training/dmd.py:478); its serve_dmd looks under <setting>/results
    argv = ["--root_path", str(tmp_path), "--data_name", "synthetic", "--image_size", "64",
            "--num_channels", "1", "--gene_ch", "4", "--dim_z", "16", "--serve_milestone", "2"]
    G = SNGANGenerator(dim_z=16, nc=1, img_size=64, gene_ch=4)
    shapes = jax.eval_shape(lambda k: G.init(k, jnp.zeros((2, 16)), jnp.zeros((2, 128))),
                            jax.random.PRNGKey(0))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    jax_results = str(_setting(tmp_path) / "dmd_results")
    save_checkpoint(jax_results, "dmd-2", {"gen_params": zeros["params"],
                                           "gen_stats": zeros["batch_stats"]})
    assert checkpoint_exists(jax_results, "dmd-2")
    monkeypatch.setattr(compilation_cache, "enable", lambda *a, **k: None)
    with pytest.raises(FileNotFoundError, match="results"):
        jax_serve_dmd.main(argv)


def test_service_embeds_through_the_teachers_setting(root, monkeypatch):
    from ccdm_tpu_torch.embedding import resolve

    seen, build = [], resolve.build_label_embedding

    def spy(args, folder, **kwargs):
        seen.append((folder, kwargs["require_cached"]))
        return build(args, folder, **kwargs)

    monkeypatch.setattr(resolve, "build_label_embedding", spy)
    args = dmd_main.parse_opts_dmd([*ARGV, "--root_path", str(root[0]), "--serve_milestone",
                                    "2", "--teacher_setting_name", "Teacher"])
    GeneratorService(args, warm=False, device="cpu")
    assert seen == [(os.path.join(str(root[0]), "output", "synthetic_64", "Teacher"), True)]


def test_service_generates_one_step_images(service, tmp_path):
    out = service.generate(np.array([0.2, 0.8, 0.5], np.float32), seed=3)
    assert out.shape == (3, 64, 64, 1) and out.dtype == np.uint8
    a = service.generate(np.array([0.5], np.float32), seed=7)
    b = service.generate(np.array([0.5], np.float32), seed=7)
    c = service.generate(np.array([0.5], np.float32), seed=8)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    with pytest.raises(ValueError, match="cond_scale"):
        service.generate(np.array([0.5], np.float32), cond_scale=2.0)
    with pytest.raises(ValueError, match="too large"):
        service.generate(np.full(17, 0.5, np.float32))
    with pytest.raises(ValueError, match="normalized"):
        service.generate(np.array([1.5], np.float32))
    args = dmd_main.parse_opts_dmd([*ARGV, "--root_path", str(tmp_path),
                                    "--serve_milestone", "99"])
    with pytest.raises(FileNotFoundError):
        GeneratorService(args, warm=False, device="cpu")


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    return json.loads(urllib.request.urlopen(req, timeout=60).read())


def test_service_http_round_trip(service):
    httpd = serve(service, 0, host="127.0.0.1", block=False)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        health = json.loads(urllib.request.urlopen(url + "/healthz", timeout=30).read())
        assert health == {"status": "ok", "warm": True, "milestone": 2}
        reply = _post(url + "/generate", {"labels": [0.1, 0.5, 0.9, 0.3, 0.7], "seed": 1})
        images = np.load(io.BytesIO(base64.b64decode(reply["images_b64"])))["images"]
        assert images.shape == (5, 64, 64, 1) and images.dtype == np.uint8
        np.testing.assert_array_equal(images, service.generate(
            np.array([0.1, 0.5, 0.9, 0.3, 0.7], np.float32), seed=1))
        for body in ({"labels": [0.5], "cond_scale": 1.5}, {"labels": [0.5] * 17}):
            with pytest.raises(urllib.error.HTTPError) as err:
                _post(url + "/generate", body)
            assert err.value.code == 400
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
