"""Port parity of the eval backbones' training and checkpoint
(ccdm_tpu_torch/eval/train_backbones.py, scripts/jax_milestone_to_torch.py)
on a SteeringAngle bundle built from rendered arrays (signed labels).

One JAX get_eval_models run (2 epochs of the autoencoder, the classifier
and the regressor on 16 images of 16x16, ResNetEval and NoisyClassifier
cut to one block a stage in both packages) gives the pinned checkpoint.
The port's trainers take JAX's initial weights (converted) and JAX's
draws (fold_in(PRNGKey(seed), step), then for the noisy classifier split
into index, t and noise keys); the script carries the checkpoint across.
Tolerances, each with its reason:
- the loss of step 1 within 1e-5 relative of JAX's (one forward from the
  same weights), of step 2 within 1e-3 (see the Adam bound); JAX's
  _train_loop and the port's step functions are wrapped to record them;
- SGD steps (classifier, regressor): every leaf within 1e-5 of its
  largest |value| (f32 convs in another framework, as the ILI steps);
- Adam and AdamW steps (autoencoder with its decoder, noisy classifier):
  every element within 2 lr a step (Adam's own ceiling), and each leaf's
  mean error within 0.1 of its mean movement in JAX. Elementwise 1e-5
  cannot hold: Adam's first step is lr sign(g), so an element whose
  gradient lies within the frameworks' f32 difference takes a whole
  step either way, and the second step amplifies that. At 16x16 a few
  ReLU masks after the decoder's last train-mode BatchNorm flip between
  f32 and f64 (5 of 262144 at step 1), which puts the port's f32
  gradient ~1e-3 of its largest from an f64 one (JAX's, by chance, ~1e-5;
  the port in f64 agrees with JAX in f64 to 4e-8). After two steps the
  mean error is 0.3-5% of the movement and step 2's loss is 3e-4
  relative apart. A leaf whose gradient in JAX's run is below 1e-4 of
  the net's largest (read off JAX's final first moment: the conv biases
  that feed a train-mode BatchNorm, whose gradient is 0 up to rounding)
  is held only to the 2 lr ceiling, since Adam turns that rounding into
  whole steps. BatchNorm statistics within 1e-4 of max(their largest
  |value|, 1) (step 2's batch statistics come from weights moved by
  step 1);
- the fingerprint of the carried checkpoint: JAX's string.
"""

import importlib.util
from pathlib import Path
from typing import Sequence

import numpy as np
import pytest
import torch

import jax

from ccdm_tpu.eval import backbones as jbackbones
from ccdm_tpu.eval import train_backbones as jtb
from ccdm_tpu_torch.data.datasets import steeringangle_from_arrays
from ccdm_tpu_torch.eval import train_backbones as tb
from ccdm_tpu_torch.eval.backbones import AEDecoder, AEEncoder, NoisyClassifier, ResNetEval
from ccdm_tpu_torch.eval.niqe import fit_niqe_model
from ccdm_tpu_torch.utils.convert import state_dict_from_jax

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SMALL = (1, 1, 1, 1)
SEED, SIZE, N = 3, 16, 16
ANGLES = np.repeat(np.linspace(-60.0, 60.0, 8), 2)
NUM_CLASSES = 8  # min(49, unique labels)


def _example(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _script():
    spec = importlib.util.spec_from_file_location(
        "jax_milestone_to_torch", ROOT / "scripts" / "jax_milestone_to_torch.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    return script


class _SmallResNetEval(jbackbones.ResNetEval):
    num_blocks: Sequence[int] = SMALL


class _SmallNoisyClassifier(jbackbones.NoisyClassifier):
    num_blocks: Sequence[int] = SMALL


@pytest.fixture(scope="module")
def small_resnets():
    """ResNetEval and NoisyClassifier at one block a stage in both packages."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jtb, "ResNetEval", _SmallResNetEval)
    mp.setattr(jbackbones, "NoisyClassifier", _SmallNoisyClassifier)
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


def _record_steps(record):
    """JAX's _train_loop with its initial state, and each step's loss and
    state, kept under its tag."""
    loop = jtb._train_loop

    def recording(step_fn, state, n_steps, key, log_every=200, tag=""):
        entry = record.setdefault(tag, {"losses": [], "init": jax.device_get(state)})

        def step(state, k):
            state, loss = step_fn(state, k)
            entry["losses"].append(float(loss))
            entry["state"] = jax.device_get(state)
            return state, loss

        return loop(step, state, n_steps, key, log_every, tag)

    return recording


@pytest.fixture(scope="module")
def jax_run(small_resnets, bundle, tmp_path_factory):
    """JAX's get_eval_models: the pinned checkpoint, its fingerprint and
    tree, and each trainer's losses and final state."""
    root, record = tmp_path_factory.mktemp("jax_eval"), {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtb, "_train_loop", _record_steps(record))
        nets = jtb.get_eval_models(bundle, str(root / "eval_models"), NUM_CLASSES, epochs_ae=2,
                                   epochs_cnn=2, seed=SEED)
    stored = {"ae": nets["fid"][1], "cls": nets["div"][1], "reg": nets["ls"][1]}
    return root, nets["fingerprint"], jax.device_get(stored), record


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _idx_draws(seed, n, steps):
    key = jax.random.PRNGKey(seed)
    return [{"idx": torch.from_numpy(np.array(
        jax.random.randint(jax.random.fold_in(key, i), (n,), 0, n)))} for i in range(steps)]


def _port(module, variables):
    module.load_state_dict(state_dict_from_jax(variables, module))
    return module


def _record_port_steps(monkeypatch, name):
    """Wrap the port's step function `name`: its losses, and its arguments
    of the last call."""
    step, seen = getattr(tb, name), {"losses": []}

    def recording(*args, **kwargs):
        loss = step(*args, **kwargs)
        seen["losses"].append(float(loss))
        seen["args"] = args
        return loss

    monkeypatch.setattr(tb, name, recording)
    return seen


def _assert_params(got, want, stat_rel, adam=None):
    """The port's state_dict against JAX's variables `want`. Running
    statistics within stat_rel of max(their largest |value|, 1). Params:
    after SGD (adam None), within 1e-5 of their largest |value|; after
    Adam, adam = (JAX's initial variables, JAX's first moments, lr a
    step, steps): every element within 2 lr a step, and, but in a leaf
    whose JAX gradient is below 1e-4 of the net's largest, the mean error
    within 0.1 of the mean movement in JAX. Returns those leaves."""
    sd, want_sd = got.state_dict(), state_dict_from_jax(want, got)
    still = set()
    if adam is not None:
        init, moments, lr, steps = adam
        init = state_dict_from_jax(init, got)
        moments = {k: v.abs().max() for k, v in
                   state_dict_from_jax({**want, "params": moments}, got).items()
                   if k in dict(got.named_parameters())}
        largest = max(moments.values())
        still = {k for k, v in moments.items() if v < 1e-4 * largest}
    for key, value in want_sd.items():
        err = (sd[key] - value).abs()
        scale = float(value.abs().max())
        if "running" in key:
            assert float(err.max()) <= stat_rel * max(scale, 1.0), (key, float(err.max()), scale)
        elif "num_batches" in key:
            continue
        elif adam is None:
            assert float(err.max()) <= 1e-5 * max(scale, 1e-30), (key, float(err.max()), scale)
        else:
            assert float(err.max()) <= 2 * lr * steps * (1 + 1e-3), (key, float(err.max()))
            moved = float((value - init[key]).abs().mean())
            if key not in still:
                assert float(err.mean()) <= 0.1 * moved, (key, float(err.mean()), moved)
    return still


def _assert_optimizer(opt, cls, modules, **hyper):
    """opt is a `cls` over every parameter of `modules` (and no other)
    with optax's hyperparameters: two Adam steps at this lr cannot tell
    b2 0.99 from 0.999, nor AdamW's decay from none, within f32's noise."""
    assert type(opt) is cls
    for name, value in hyper.items():
        assert opt.defaults[name] == value, (name, opt.defaults[name], value)
    held = [id(q) for group in opt.param_groups for q in group["params"]]
    want = [id(q) for m in modules for q in m.parameters()]
    assert len(held) == len(set(held)) and set(held) == set(want)


def _moved(before, after) -> float:
    after = dict(_leaves(after))
    return max(float(np.abs(a - after[k]).max()) for k, a in _leaves(before))


# --------------------------------------------------------------- trainers


def test_autoencoder_steps_match_jax(jax_run, bundle, monkeypatch):
    """Two Adam steps of the encoder and the decoder, and their losses."""
    *_, record = jax_run
    ep0, es0, dp0, ds0, _ = record["ae"]["init"]  # train_backbones.py:46-47
    ev, dv = {"params": ep0, "batch_stats": es0}, {"params": dp0, "batch_stats": ds0}
    nets = (_port(AEEncoder(image_size=SIZE), ev), _port(AEDecoder(init_size=SIZE // 16), dv))
    seen = _record_port_steps(monkeypatch, "ae_step")
    got = tb.train_autoencoder(bundle.eval_images, epochs=2, seed=SEED, nets=nets,
                               draws=_idx_draws(SEED, N, 2))
    assert got is nets[0] and got.seconds_per_epoch > 0 and not got.training
    assert seen["args"][1] is nets[1]
    _assert_optimizer(seen["args"][2], torch.optim.Adam, nets, lr=1e-4, betas=(0.9, 0.999),
                      eps=1e-8, weight_decay=0, amsgrad=False, maximize=False)
    want = record["ae"]
    np.testing.assert_allclose(seen["losses"][0], want["losses"][0], rtol=1e-5)
    np.testing.assert_allclose(seen["losses"], want["losses"], rtol=1e-3)
    ep, es, dp, ds, opt = want["state"]
    mu_e, mu_d = opt[0].mu  # (1 - b1) g at step 1, plus b1 times that at step 2
    still = (_assert_params(got, {"params": ep, "batch_stats": es}, 1e-4, (ev, mu_e, 1e-4, 2))
             | _assert_params(nets[1], {"params": dp, "batch_stats": ds}, 1e-4,
                              (dv, mu_d, 1e-4, 2)))
    # only the conv biases that feed a train-mode BatchNorm have a 0 gradient
    assert still and all(k.endswith(".bias") and "conv" in k and k != "out_conv.bias"
                         for k in still), still
    assert _moved(ev["params"], ep) > 1e-4 and _moved(dv["params"], dp) > 1e-4


@pytest.mark.parametrize("mode", ["class", "regre"])
def test_eval_resnet_steps_match_jax(jax_run, bundle, mode, monkeypatch):
    """get_eval_models' classifier (seed + 1) and regressor (seed + 2):
    two SGD steps, lr 1e-2 then 1e-3 (the schedule's two boundaries meet
    at step 1), and their losses."""
    _, _, stored, record = jax_run
    raw = bundle.eval_labels_raw
    targets = (jtb.bin_labels_to_classes(raw, NUM_CLASSES) if mode == "class"
               else bundle.fn_normalize(raw))
    outputs, seed = (NUM_CLASSES, SEED + 1) if mode == "class" else (1, SEED + 2)
    params, stats, _ = record[f"eval_{mode}"]["init"]  # the regressor's bias shifted
    init = {"params": params, "batch_stats": stats}
    port = _port(ResNetEval(outputs, mode, SMALL), init)
    seen = _record_port_steps(monkeypatch, "eval_resnet_step")
    got = tb.train_eval_resnet(bundle.eval_images, targets, mode, outputs, epochs=2,
                               seed=seed, net=port, draws=_idx_draws(seed, N, 2))
    np.testing.assert_allclose(seen["losses"], record[f"eval_{mode}"]["losses"], rtol=1e-5)
    want = stored["cls" if mode == "class" else "reg"]
    _assert_params(got, want, 1e-5)
    _assert_optimizer(seen["args"][1], torch.optim.SGD, [port], momentum=0.9, dampening=0,
                      weight_decay=1e-4, nesterov=False, maximize=False)
    assert _moved(init["params"], want["params"]) > 1e-4


def test_noisy_classifier_steps_match_jax(small_resnets, bundle, monkeypatch):
    """Two AdamW steps and their losses."""
    classes = jtb.bin_labels_to_classes(bundle.eval_labels_raw, 4)
    kw = dict(timesteps=100, seed=SEED)
    record = {}
    monkeypatch.setattr(jtb, "_train_loop", _record_steps(record))
    want = jtb.train_noisy_classifier(bundle.eval_images, classes, 4, epochs=2, **kw)
    params, stats, _ = record["noisy_cls"]["init"]
    init = {"params": params, "batch_stats": stats}
    draws = []
    for i in range(2):  # train_backbones.py:158-162
        k_idx, k_t, k_noise = jax.random.split(
            jax.random.fold_in(jax.random.PRNGKey(SEED), i), 3)
        draws.append({k: torch.from_numpy(np.array(v)) for k, v in (
            ("idx", jax.random.randint(k_idx, (N,), 0, N)),
            ("t", jax.random.randint(k_t, (N,), 0, 100)),
            ("noise", jax.random.normal(k_noise, (N, SIZE, SIZE, 3))))})
    port = _port(NoisyClassifier(4, SMALL), init)
    seen = _record_port_steps(monkeypatch, "noisy_classifier_step")
    got = tb.train_noisy_classifier(bundle.eval_images, classes, 4, epochs=2, net=port,
                                    draws=draws, **kw)
    losses = record["noisy_cls"]["losses"]
    np.testing.assert_allclose(seen["losses"][0], losses[0], rtol=1e-5)
    np.testing.assert_allclose(seen["losses"], losses, rtol=1e-3)
    _, _, opt = record["noisy_cls"]["state"]
    still = _assert_params(got, want, 1e-4, (init, opt[0].mu, 3e-4, 2))
    _assert_optimizer(seen["args"][1], torch.optim.AdamW, [port], lr=3e-4, betas=(0.9, 0.999),
                      eps=1e-8, weight_decay=0.05, amsgrad=False, maximize=False)
    assert all(k.endswith(".bias") and "conv" in k for k in still), still
    assert _moved(init["params"], want["params"]) > 1e-4


# ----------------------------------------------- checkpoint and fingerprint


@pytest.fixture(scope="module")
def port_eval_root(jax_run, bundle, tmp_path_factory):
    """The JAX eval_models/ (with a NIQE model fitted there) carried across
    by the script's CLI."""
    root, *_ = jax_run
    fit_niqe_model(bundle.eval_images[:8], patch=16).save(
        str(root / "eval_models" / "niqe_model_p16_n8_seed3.npz"))
    port_root = tmp_path_factory.mktemp("port_eval")
    _script().main(["--jax_eval_ckpt_path", str(root), "--eval_ckpt_path", str(port_root),
                    "--device", "cpu"])
    return port_root


def test_carried_checkpoint_reads_jaxs_fingerprint(jax_run, port_eval_root, bundle, capsys):
    _, fingerprint, *_ = jax_run
    eval_dir = port_eval_root / "eval_models"
    tag = f"evalnets_SteeringAngle_{SIZE}_seed{SEED}"
    assert (eval_dir / f"model-{tag}" / "state.pt").is_file()
    assert len(list(eval_dir.glob("niqe_model_p16_n8_seed3.npz"))) == 1
    first = tb.get_eval_models(bundle, str(eval_dir), NUM_CLASSES, seed=SEED)
    assert "LOADED" in capsys.readouterr().out
    assert first["fingerprint"] == fingerprint and fingerprint.startswith(tag + ":")
    again = tb.get_eval_models(bundle, str(eval_dir), NUM_CLASSES, seed=SEED)
    assert again["fingerprint"] == fingerprint
    # a changed weight changes it
    with torch.no_grad():
        again["ls"].head.bias += 1e-3
    assert tb.backbone_fingerprint({"ae": again["fid"], "cls": again["div"],
                                    "reg": again["ls"]}) != fingerprint.split(":")[1]


def test_untranslated_jax_entry_raises(jax_run, bundle):
    root, *_ = jax_run
    with pytest.raises(FileExistsError, match="jax_milestone_to_torch"):
        tb.get_eval_models(bundle, str(root / "eval_models"), NUM_CLASSES, seed=SEED)


def test_port_trained_checkpoint_reloads_with_its_fingerprint(small_resnets, bundle, tmp_path):
    first = tb.get_eval_models(bundle, str(tmp_path), NUM_CLASSES, epochs_ae=1, epochs_cnn=1,
                               seed=SEED)
    assert set(tb.STAGE_SECONDS) == {"ae", "cls", "reg"}
    again = tb.get_eval_models(bundle, str(tmp_path), NUM_CLASSES, seed=SEED)
    assert again["fingerprint"] == first["fingerprint"]
    x = bundle.eval_images[:4]
    from ccdm_tpu_torch.eval.metrics import extract_features

    np.testing.assert_array_equal(extract_features(first["fid"], x),
                                  extract_features(again["fid"], x))
