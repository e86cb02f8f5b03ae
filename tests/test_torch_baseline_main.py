"""The baselines' entry points end to end on the CPU, against ccdm_tpu's:
ccgan_main (CcGAN and Dual-NDA) and classgan_main (studiogan, cfg, admg),
the class lookup of the class-conditional diffusion, load_gan_config.

- classgan_main --method studiogan runs in both packages on the same
  flags (tests/test_classgan_cli.py's; both loaders cut to 64 images):
  the same files in the results
  folder, the same h5 keys, shapes, dtypes and fake labels. cfg and admg
  run in the port only (JAX's take ~60 s each to compile here, and its own
  suite marks them slow): the file names each JAX run writes with these
  flags are listed below (read off ccdm_tpu.classgan_main runs), the port
  adding the class table it carries as data.
- ccgan_main with Dual-NDA b and c, a grid and the h5 dumps, as
  tests/test_dmd_ccgan.py::test_ccgan_main_cli_e2e runs JAX's: the files
  and h5 keys JAX writes (ccgan_main.py:217-242), then a resume, then
  --comp_FID: the protocol's eval_results lines (those of main.py's
  protocol, tests/test_torch_eval_main.py), the eval ResNets cut to one
  block a stage and the data to 64 images.
- _class_centers and the class lookup (searchsorted, side left, on the
  normalised f32 class uppers, then JAX's class table carried by
  utils/convert.save_class_table_from_jax): exact; the lookup is read off
  JAX's own _train_class_diffusion with its Trainer stubbed.
- classgan_main --comp_FID: JAX's parser has no --FID_radius or
  --FID_num_centers, which its protocol reads (an AttributeError in JAX);
  the port scores the fakes at main.py's defaults.
- load_gan_config on configs/{ccgan_rc49,dualnda_rc49,dmd2_sa64}.yaml:
  the same kind, fields and extras as JAX's; a near-miss key and an
  unknown kind raise the same errors.
"""

import dataclasses
import inspect
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import ccdm_tpu.data as jax_data
from ccdm_tpu import classgan_main as jax_classgan_main
from ccdm_tpu.data.datasets import make_synthetic as jax_make_synthetic
from ccdm_tpu.training import gan_config as jax_gan_config
from ccdm_tpu_torch import ccgan_main, classgan_main
from ccdm_tpu_torch.data import datasets
from ccdm_tpu_torch.diffusion.guided import class_table
from ccdm_tpu_torch.eval import train_backbones as tb
from ccdm_tpu_torch.training import gan_config
from ccdm_tpu_torch.utils.convert import save_class_table_from_jax

h5py = pytest.importorskip("h5py")
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
CLASSGAN = ["--data_name", "synthetic", "--image_size", "64", "--num_channels", "1",
            "--num_classes", "3", "--niters", "2", "--train_batch_size", "8",
            "--nfake_per_class", "2", "--samp_batch_size", "6", "--dump_fake_data",
            "--log_every", "1", "--visualize_freq", "1000000", "--save_niters_freq", "1000000"]
METHOD = {"studiogan": ["--method", "studiogan", "--cond_loss", "d2dce", "--gene_ch", "4",
                        "--disc_ch", "4", "--dim_z", "16", "--num_D_steps", "1"],
          "cfg": ["--method", "cfg", "--model_channels", "8", "--channel_mult", "1_2",
                  "--train_timesteps", "20", "--sample_timesteps", "4",
                  "--sample_cond_scale", "2.0"],
          "admg": ["--method", "admg", "--model_channels", "8", "--channel_mult", "1_2",
                   "--train_timesteps", "20", "--classifier_epochs", "1",
                   "--sample_timesteps", "4", "--classifier_scale", "1.0"]}
# what ccdm_tpu.classgan_main writes in <setting>/<method>_results with
# CLASSGAN + METHOD[method]
JAX_FILES = {"cfg": ["fake_data_cfg_niters2_nfake6.h5", "log_loss_niters2.txt", "model-2",
                     "sample_cfg.png", "train_log.jsonl"],
             "admg": ["fake_data_admg_niters2_nfake6.h5", "log_loss_niters2.txt", "model-2",
                      "model-noisycls_synthetic_64_c3_e1_seed2021", "sample_admg.png",
                      "train_log.jsonl"]}
CCGAN = ["--device", "cpu", "--data_name", "synthetic", "--image_size", "64",
         "--num_channels", "1", "--y2h_embed_type", "sinusoidal", "--batch_size_disc", "8",
         "--batch_size_gene", "8", "--num_D_steps", "1", "--gene_ch", "4", "--disc_ch", "4",
         "--dim_gan", "16", "--nda_b", "0.1", "--nda_c", "0.1", "--nda_a", "0.8",
         "--nfake_per_label", "6", "--samp_batch_size", "4", "--eval_mode", "1",
         "--visualize_freq", "2", "--dump_fake_data"]
N_IMAGES = 64


def _results(root, method) -> Path:
    return Path(root) / "output" / "synthetic_64" / "Setup_ClassCond" / f"{method}_results"


def _h5(path) -> dict:
    with h5py.File(path, "r") as f:
        return {k: (f[k].shape, f[k].dtype, f[k][:]) for k in f}


LOADERS = {module: module.load_dataset for module in (datasets, jax_data)}


def _patch_small(mp):
    """Both packages' loaders cut to N_IMAGES images; the eval ResNets to
    one block a stage."""
    for module, load in LOADERS.items():
        mp.setattr(module, "load_dataset",
                   lambda name, path, _load=load, **kw: _load(name, path, **kw, n=N_IMAGES))
    mp.setattr(tb, "EVAL_RESNET_BLOCKS", (1, 1, 1, 1))


@pytest.fixture(scope="module")
def classgan_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("classgan")
    mp = pytest.MonkeyPatch()
    _patch_small(mp)
    try:
        out = {m: classgan_main.main(["--device", "cpu", "--root_path", str(root), *CLASSGAN,
                                      *METHOD[m]]) for m in METHOD}
        yield root, out, mp
    finally:
        mp.undo()


@pytest.mark.parametrize("method", sorted(METHOD))
def test_classgan_main_writes_jaxs_files(classgan_runs, method, tmp_path):
    root, out, _ = classgan_runs
    results = _results(root, method)
    got_files = sorted(os.listdir(results))
    h5 = _h5(results / f"fake_data_{method}_niters2_nfake6.h5")
    assert sorted(h5) == ["fake_images", "fake_labels"]
    shape, dtype, fakes = h5["fake_images"]
    assert shape == (6, 64, 64, 1) and dtype == np.uint8 and fakes.std() > 0
    np.testing.assert_array_equal(fakes, out[method]["fakes"])
    labels = h5["fake_labels"][2]
    assert len(np.unique(labels)) == 3
    if method == "studiogan":
        jax_classgan_main.main(["--root_path", str(tmp_path), "--data_path", str(tmp_path),
                                *CLASSGAN, *METHOD[method]])
        want = _results(tmp_path, method)
        assert got_files == sorted(os.listdir(want))
        jh5 = _h5(want / f"fake_data_{method}_niters2_nfake6.h5")
        assert {k: v[:2] for k, v in h5.items()} == {k: v[:2] for k, v in jh5.items()}
        np.testing.assert_array_equal(labels, jh5["fake_labels"][2])
    else:
        assert got_files == sorted(JAX_FILES[method] + ["class_table_c3_d128_seed2021.pt"])
        assert (results / "model-2" / "state.pt").is_file()
    log = [json.loads(line) for line in open(results / "train_log.jsonl")]
    assert [r["step"] for r in log] == [1, 2]


def test_admg_reloads_its_cached_classifier(classgan_runs, capsys):
    root, out, _ = classgan_runs
    again = classgan_main.main(["--device", "cpu", "--root_path", str(root), *CLASSGAN,
                                *METHOD["admg"]])
    assert "noisy classifier: loaded cached 'noisycls_synthetic_64_c3_e1_seed2021'" in \
        capsys.readouterr().out
    for a, b in zip(out["admg"]["classifier"].state_dict().values(),
                    again["classifier"].state_dict().values()):
        assert torch.equal(a, b)


def test_class_centers_and_lookup_are_jaxs(tmp_path, monkeypatch):
    """The class of each normalised label and its table row, as JAX's
    _train_class_diffusion builds its fn_y2h (its Trainer stubbed)."""
    import ccdm_tpu.training as jax_training
    from ccdm_tpu.eval.train_backbones import bin_labels_to_classes as jax_bin

    bundle = jax_make_synthetic(n=64, image_size=64, channels=1)
    raw = np.asarray(bundle.labels_raw, np.float32)
    classes = jax_bin(bundle.labels_raw, 5)
    np.testing.assert_array_equal(classgan_main._class_centers(raw, classes, 6),
                                  jax_classgan_main._class_centers(raw, classes, 6))
    captured = {}

    class StubTrainer:
        def __init__(self, *args, **kwargs):
            pass

        def train(self, fn_y2h):
            captured["fn"] = fn_y2h

    monkeypatch.setattr(jax_training, "Trainer", StubTrainer)
    args = jax_classgan_main.parse_opts_classgan(["--model_channels", "8", "--channel_mult",
                                                  "1_2", "--num_classes", "5"])
    jax_classgan_main._train_class_diffusion(args, bundle, classes, str(tmp_path), None)
    save_class_table_from_jax(jax.random.normal(jax.random.PRNGKey(args.seed), (5, 128)),
                              str(tmp_path), 5, args.seed)
    port_bundle = datasets.make_synthetic(n=64, image_size=64, channels=1)
    uppers = classgan_main.class_uppers_norm(port_bundle, 5)
    fn = classgan_main.make_fn_y2h_classes(uppers, class_table(str(tmp_path), 5, 128, args.seed),
                                           "cpu")
    y = np.concatenate([np.asarray(bundle.labels_norm, np.float32), uppers,
                        np.nextafter(uppers, np.float32(2)), [0.0, 1.0]]).astype(np.float32)
    np.testing.assert_array_equal(fn(torch.from_numpy(y)).numpy(),
                                  np.asarray(captured["fn"](y)))
    # the rows are the classes bin_labels_to_classes gives the train labels
    table = class_table(str(tmp_path), 5, 128, args.seed)
    rows = fn(torch.from_numpy(np.asarray(bundle.labels_norm, np.float32)))
    np.testing.assert_array_equal(rows.numpy(), table[classes].numpy())


@pytest.fixture
def small_data(monkeypatch):
    _patch_small(monkeypatch)


EVAL_NAMES = ["Eval backbones", "Radius", "Sampling Steps", "Sampling Time", "SFID", "LS",
              "Diversity", "FID"]


def _metric_names(path):
    lines = [line for line in Path(path).read_text().splitlines()
             if line.strip() and not line.startswith("Namespace(")]
    return [line.split(":")[0].strip() for line in lines[1:]], lines


def test_classgan_comp_fid_scores_where_jax_raises(small_data, tmp_path):
    """JAX's classgan parser lacks the flags its protocol reads; the port
    takes main.py's defaults (radius 0, every center)."""
    jargs = jax_classgan_main.parse_opts_classgan(["--comp_FID"])
    assert not hasattr(jargs, "FID_radius")
    from ccdm_tpu.eval import protocol as jax_protocol

    assert "args.FID_radius" in inspect.getsource(jax_protocol.run_ccgm_eval)
    out = classgan_main.main(["--device", "cpu", "--root_path", str(tmp_path), *CLASSGAN,
                              *METHOD["studiogan"], "--comp_FID", "--eval_ckpt_path",
                              str(tmp_path), "--epochs_eval_ae", "1", "--epochs_eval_cnn", "1"])
    setting = _results(tmp_path, "studiogan").parent
    names, lines = _metric_names(setting / "eval_results_niters2.txt")
    assert names == EVAL_NAMES and lines[2].strip() == "Radius: 0.0."
    assert np.isfinite(out["eval_results"]["fid"])


# --------------------------------------------------------------- ccgan_main


def test_ccgan_main_end_to_end(small_data, tmp_path):
    trainer = ccgan_main.main([*CCGAN, "--root_path", str(tmp_path), "--niters", "2"])
    setting = tmp_path / "output" / "synthetic_64" / "Setup_CcGAN"
    results = setting / "ccgan_results"
    assert sorted(os.listdir(results)) == ["fake_data_niters2", "log_loss_niters2.txt",
                                           "model-ccgan-2", "sample_2.png", "train_log.jsonl"]
    labels = np.unique(trainer.train_labels.numpy())
    dumps = sorted((results / "fake_data_niters2").glob("*.h5"))
    assert len(dumps) == len(labels) == len(list((results / "fake_data_niters2").glob("*.png")))
    h5 = _h5(dumps[0])
    assert sorted(h5) == ["fake_images_i", "fake_labels_i"]
    assert h5["fake_images_i"][:2] == ((6, 64, 64, 1), np.uint8)
    assert h5["fake_labels_i"][:2] == ((6,), np.float64)
    assert [json.loads(line)["step"] for line in open(results / "train_log.jsonl")] == [1]

    # a resume reads every dump back (none rewritten) and scores them
    before = {p: p.stat().st_mtime_ns for p in dumps}
    again = ccgan_main.main([*CCGAN, "--root_path", str(tmp_path), "--niters", "2",
                             "--resume_niter", "2", "--comp_FID", "--FID_radius", "0.1",
                             "--FID_num_centers", "3", "--eval_ckpt_path", str(tmp_path),
                             "--epochs_eval_ae", "1", "--epochs_eval_cnn", "1"])
    assert again.step == 2 and all(p.stat().st_mtime_ns == t for p, t in before.items())
    names, _ = _metric_names(setting / "eval_results_niters2.txt")
    assert names == EVAL_NAMES and np.isfinite(again.eval_results["fid"])
    with pytest.raises(SystemExit, match="requires --badfake_niqe_path"):
        ccgan_main.main([*CCGAN, "--root_path", str(tmp_path), "--nda_d", "0.1"])


def test_load_badfake_reads_jaxs_layouts(tmp_path):
    from ccdm_tpu.ccgan_main import _load_badfake as jax_load_badfake

    rng = np.random.default_rng(0)
    for name, keys, layout in (("nhwc.h5", ("fake_images", "fake_labels"), (5, 8, 8, 3)),
                               ("nchw.h5", ("fake_images_i", "fake_labels_i"), (5, 3, 8, 8))):
        with h5py.File(tmp_path / name, "w") as f:
            f.create_dataset(keys[0], data=rng.integers(0, 256, layout).astype(np.uint8))
            f.create_dataset(keys[1], data=rng.uniform(0, 90, 5))
        got, want = ccgan_main._load_badfake(str(tmp_path / name)), \
            jax_load_badfake(str(tmp_path / name))
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    assert ccgan_main._load_badfake("") is None


# --------------------------------------------------------------- gan_config


@pytest.mark.parametrize("name", ["ccgan_rc49", "dualnda_rc49", "dmd2_sa64"])
def test_load_gan_config_is_jaxs(name):
    path = str(ROOT / "configs" / f"{name}.yaml")
    kind, cfg, extras = gan_config.load_gan_config(path)
    jkind, jcfg, jextras = jax_gan_config.load_gan_config(path)
    assert (kind, extras) == (jkind, jextras)
    assert type(cfg).__name__ == type(jcfg).__name__
    want = dataclasses.asdict(jcfg)
    got = dataclasses.asdict(cfg)
    assert {k: got[k] for k in got if k in want} == {k: want[k] for k in got if k in want}


@pytest.mark.parametrize("text,error", [("trainer: ccgan\nbatchsize_disc: 8\n",
                                         "did you mean 'batch_size_disc'"),
                                        ("trainer: stylegan\n", "unknown trainer kind")])
def test_load_gan_config_errors_are_jaxs(tmp_path, text, error):
    path = tmp_path / "bad.yaml"
    path.write_text(text)
    with pytest.raises(ValueError, match=error) as want:
        jax_gan_config.load_gan_config(str(path))
    with pytest.raises(ValueError, match=error) as got:
        gan_config.load_gan_config(str(path))
    assert str(got.value) == str(want.value)
