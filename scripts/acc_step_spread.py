#!/usr/bin/env python3
"""How far one f32 train step of the JAX Trainer moves with its own device
layout, beside the port's distance from it, at 2 and 4 accumulation steps.

    JAX_PLATFORMS=cpu python3 scripts/acc_step_spread.py [--keys 9,10,11] [--accs 2,4]

The step of tests/test_torch_train.py's whole-step comparison (dim 8, mults
(1, 2), 64x64 synthetic data, hv, batch 16, the same variables): for each
key and accumulation count, JAX's jitted step on a mesh of eight CPU devices
(the layout the tests' conftest makes) and on one, and the port's
Trainer.compute_grads on JAX's draws. Prints the three losses, the port's
and the one-device loss's relative distance from the eight-device one, and
the largest BatchNorm-statistic distance of the port in units of the
tests' bound (|d| / (1e-5 (1 + |want|)); below 1 holds). Under hv the label
BatchNorm's variance mean(x^2) - mean(x)^2 cancels in f32 (both packages
compute it in f32: flax's BatchNorm at dtype float32, the port's
flax_batch_norm), so the loss moves with the order of the sums: the JAX
rows show how far by JAX's own layouts.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8").strip()
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from ccdm_tpu.data.datasets import make_synthetic  # noqa: E402
from ccdm_tpu.diffusion import DiffusionConfig as JaxDiffusionConfig  # noqa: E402
from ccdm_tpu.diffusion import GaussianDiffusion as JaxGaussianDiffusion  # noqa: E402
from ccdm_tpu.embedding import make_fn_y2h as jax_make_fn_y2h  # noqa: E402
from ccdm_tpu.models import Unet as JaxUnet  # noqa: E402
from ccdm_tpu.parallel import create_mesh  # noqa: E402
from ccdm_tpu.training import Trainer as JaxTrainer  # noqa: E402
from ccdm_tpu.training import TrainerConfig as JaxTrainerConfig  # noqa: E402
from ccdm_tpu_torch.diffusion.gaussian import DiffusionConfig, GaussianDiffusion  # noqa: E402
from ccdm_tpu_torch.embedding.analytic import make_fn_y2h  # noqa: E402
from ccdm_tpu_torch.training.trainer import Trainer, TrainerConfig  # noqa: E402
from ccdm_tpu_torch.utils.convert import unet_state_dict_from_jax  # noqa: E402
from tests.test_torch_train import (  # noqa: E402
    CFG,
    _jax_variables,
    _port_model,
    _recording_tx,
    _step_draws,
)


def jax_step(bundle, variables, kw, tkw, key, mesh, results):
    trainer = JaxTrainer(JaxGaussianDiffusion(JaxUnet(**CFG).apply, JaxDiffusionConfig(**kw)),
                         variables, bundle.images, bundle.labels_norm,
                         JaxTrainerConfig(results_folder=results, **tkw), mesh=mesh)
    trainer.tx = _recording_tx()
    trainer.state = trainer.state.replace(opt_state=trainer.tx.init(trainer.state.params))
    state, loss = trainer._build_train_step(jax_make_fn_y2h(128))(trainer.state, key)
    return trainer, state, float(loss)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--keys", default="9,10,11")
    parser.add_argument("--accs", default="2,4")
    parser.add_argument("--results", default="build/acc_step_spread")
    args = parser.parse_args()
    torch.set_num_threads(2)
    bundle = make_synthetic(n=64, image_size=64, channels=3, seed=0)
    variables = _jax_variables(64, seed=4)
    kw = dict(image_size=64, channels=3, timesteps=1000, objective="pred_x0",
              vicinity_type="hv", cond_drop_prob=0.5)
    meshes = {"8 devices": create_mesh(), "1 device": create_mesh(jax.devices()[:1])}
    for acc in (int(a) for a in args.accs.split(",")):
        tkw = dict(data_name="synthetic", train_batch_size=16, gradient_accumulate_every=acc,
                   vicinity_type="hv")
        for k in (int(k) for k in args.keys.split(",")):
            key = jax.random.PRNGKey(k)
            runs = {name: jax_step(bundle, variables, kw, tkw, key, mesh, args.results)
                    for name, mesh in meshes.items()}
            jtrainer, state, want = runs["8 devices"]
            port = Trainer(GaussianDiffusion(_port_model(variables, 64), DiffusionConfig(**kw)),
                           bundle.images, bundle.labels_norm, TrainerConfig(**tkw))
            loss, _ = port.compute_grads(make_fn_y2h(128), draws=_step_draws(
                key, jtrainer, len(bundle.images), acc=acc))
            model = port.state.model
            stats = unet_state_dict_from_jax({"params": state.params,
                                              "batch_stats": jax.device_get(state.batch_stats)},
                                             model)
            worst = max(float(((buf - stats[name]).abs() / (1e-5 * (1 + stats[name].abs())))
                              .max())
                        for name, buf in model.named_buffers() if buf.is_floating_point())
            one = runs["1 device"][2]
            print(f"acc {acc}, key {k}: loss JAX on 8 devices {want:.9g}, on 1 device "
                  f"{one:.9g} (relative {abs(one - want) / abs(want):.3e}), the port "
                  f"{float(loss):.9g} (relative {abs(float(loss) - want) / abs(want):.3e}); "
                  f"the port's statistics at {worst:.3f} of the 1e-5 bound", flush=True)


if __name__ == "__main__":
    main()
