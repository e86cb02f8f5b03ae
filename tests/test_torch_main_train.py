"""The port's training CLI end to end on the CPU, at a tiny size.

`python -m ccdm_tpu_torch.main` trains 3 steps and writes the milestone and
train_log.jsonl; `--resume_niter 3` resumes from it; SamplerService with
`--serve_milestone 3` serves that milestone's EMA weights (compared exactly
with the tensors in the file).
"""

import json
import os

import numpy as np
import pytest
import torch

from ccdm_tpu_torch import main as port_main
from ccdm_tpu_torch.opts import parse_opts
from ccdm_tpu_torch.serve import SamplerService
from ccdm_tpu_torch.training.state import shadowed_tensors
from ccdm_tpu_torch.utils.ckpt import checkpoint_exists, load_checkpoint

torch.set_num_threads(2)

MODEL = ["--image_size", "16", "--model_channels", "8", "--channel_mult", "1_2",
         "--train_timesteps", "20", "--pred_objective", "pred_x0", "--device", "cpu"]
TRAIN = ["--data_name", "synthetic", "--synthetic_n", "64", "--train_batch_size", "8",
         "--vicinity_type", "hv", "--log_every", "1", "--save_every", "3",
         # the sampling after training: 2 eval labels x 2 images, 2 DDIM steps
         "--eval_mode", "4", "--FID_num_centers", "2", "--nfake_per_label", "2",
         "--sample_timesteps", "2"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("run"))
    argv = ["--root_path", root, *MODEL, *TRAIN, "--niters", "3"]
    trainer = port_main.main(argv)
    return root, argv, trainer


def test_cli_trains_and_writes_milestone_and_log(trained):
    root, argv, trainer = trained
    results = port_main.results_folder(parse_opts(argv))
    assert checkpoint_exists(results, 3)
    assert os.path.isfile(os.path.join(os.path.dirname(results), "setting_info.txt"))
    lines = [json.loads(line) for line in open(os.path.join(results, "train_log.jsonl"))]
    assert [r["step"] for r in lines] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) and r["imgs_per_sec"] > 0 and r["step_time_s"] > 0
               for r in lines)
    tree = load_checkpoint(results, 3)
    assert tree["step"] == 3 and tree["ema_step"] == 3 and tree["opt_state"]["count"] == 3
    assert trainer.state.step == 3


def test_resume_prints_and_continues(trained, capsys):
    root, argv, _ = trained
    trainer = port_main.main([*argv[:-1], "5", "--resume_niter", "3"])
    assert "resumed from milestone 3" in capsys.readouterr().out
    assert trainer.state.step == 5 and trainer.state.ema_step == 5
    assert checkpoint_exists(port_main.results_folder(parse_opts(argv)), 5)


def test_service_serves_the_milestones_ema_weights(trained):
    root, argv, _ = trained
    args = parse_opts(["--root_path", root, *MODEL, "--serve_milestone", "3",
                       "--sample_timesteps", "2"])
    service = SamplerService(args, max_batch=2, warm=False, device="cpu")
    assert service.loaded_milestone == 3
    tree = load_checkpoint(port_main.results_folder(args), 3)
    served = shadowed_tensors(service.diffusion.model)
    for got, want in zip(served, tree["ema_params"] + tree["ema_batch_stats"]):
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)
    images = service.generate(np.array([0.2, 0.7], np.float32))
    assert images.dtype == np.uint8 and images.shape == (2, 16, 16, 3)


def test_missing_milestone_raises(trained):
    root, _, _ = trained
    args = parse_opts(["--root_path", root, *MODEL, "--serve_milestone", "7"])
    with pytest.raises(FileNotFoundError, match="milestone 7"):
        SamplerService(args, warm=False, device="cpu")


@pytest.mark.parametrize("flags", [["--gif_trajectory"],
                                   ["--lambda_aux", "0.5", "--net_aux", "VGG11",
                                    "--epoch_aux", "1"],
                                   ["--data_name", "synthetic_power", "--label_dim", "2",
                                    "--train_batch_size", "16"],
                                   ["--interpolation"],
                                   ["--comp_FID"], ["--dump_fake_for_NIQE"],
                                   ["--architecture", "adm"], ["--architecture", "vit"],
                                   ["--tb_log"], ["--comp_FID", "--architecture", "adm"]])
def test_options_of_later_slices_raise(tmp_path, flags):
    """All nine options are ported, --comp_FID also on an ADM run (--comp_FID and --dump_fake_for_NIQE since
    the eval slice, the ADM and ViT denoisers and --tb_log since theirs;
    they raised before) and write their artifacts."""
    argv = ["--root_path", str(tmp_path), *MODEL, *TRAIN, "--niters", "1", *flags]
    if flags[0] == "--comp_FID":
        argv += ["--eval_ckpt_path", str(tmp_path), "--epochs_eval_ae", "1",
                 "--epochs_eval_cnn", "1"]
    trainer = port_main.main(argv)
    results = port_main.results_folder(parse_opts(argv))
    assert trainer.state.step == 1 and checkpoint_exists(results, 1)
    if flags[0] == "--architecture":
        model = trainer.state.model
        assert type(model).__name__ == {"adm": "ADMUnet", "vit": "ViT"}[flags[1]]
        fresh = port_main.build_model(parse_opts(argv), 16, 3)
        if flags[1] == "adm":  # frozen: Adam and the EMA leave it where it was
            for m in (model, trainer.state.ema_model):
                torch.testing.assert_close(m.null_classes_emb, fresh.null_classes_emb,
                                           rtol=0, atol=0)
        assert not torch.equal(model.init_conv.weight, fresh.init_conv.weight)
        return
    if flags[0] == "--tb_log":
        events = os.listdir(os.path.join(results, "tb"))
        assert any(name.startswith("events.out.tfevents") for name in events), events
        return
    written = {"--gif_trajectory": "trajectory_niters1.gif",
               "--interpolation": "interpolation_niters1.png",
               "--lambda_aux": os.path.join("..", "aux_models", "model-aux_VGG11_e1_seed111",
                                            "state.pt"),
               "--data_name": os.path.join(
                   os.path.basename(port_main.fake_data_folder(parse_opts(argv), 64)),
                   "sample_00063.png"),
               "--comp_FID": os.path.join("..", "eval_results_niters1.txt"),
               "--dump_fake_for_NIQE": os.path.join("saved_images", "fake_images",
                                                    "3_0.9.png")}[flags[0]]
    assert os.path.isfile(os.path.join(results, written)), written


def test_h5_dataset_without_h5py_says_so(tmp_path, monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_h5py(name, *a, **kw):
        if name == "h5py":
            raise ImportError("no h5py")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_h5py)
    argv = ["--root_path", str(tmp_path), *MODEL, *TRAIN[2:], "--niters", "1",
            "--data_name", "RC-49", "--data_path", str(tmp_path)]
    with pytest.raises(ImportError, match="h5py"):
        port_main.main(argv)
