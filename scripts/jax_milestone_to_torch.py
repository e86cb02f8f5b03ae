#!/usr/bin/env python3
"""Carry a JAX (orbax) training milestone across to the PyTorch port.

Runs offline on the CPU, where both packages are installed (the port itself
imports nothing of JAX, so this lives outside it):

    python scripts/jax_milestone_to_torch.py \
        --jax_results <folder holding model-<N>/> --jax_milestone N \
        --root_path <port run> --data_name SteeringAngle --image_size 64 \
        --model_channels 32 --channel_mult 1_2_2_4 --num_channels 3

Every flag but the first two is the port's (ccdm_tpu_torch/opts.py) and
names the model and the port's results folder,
<root_path>/output/<data_name>_<image_size>/<setting_name>/results, where
the milestone N is written as main.py writes it; `python -m
ccdm_tpu_torch.serve` with the same flags and --serve_milestone N serves its
EMA weights. The JAX milestone is restored with
ccdm_tpu.utils.ckpt.load_checkpoint against the train state of the JAX
denoiser of those flags (--architecture unet, adm or vit, with their
width flags; legacy parameter layouts are migrated there), and converted
with ccdm_tpu_torch.utils.convert.train_state_from_jax: online and EMA
weights, BatchNorm statistics, Adam's moments and count, step and ema_step.

The label embeddings come along: every complete entry of the JAX run's
<setting folder>/embed_models/ (the parent of --jax_results), the trained
ILI label MLPs model-y2h_*/ and model-y2cov_*/, becomes the port's
model-<tag>/state.pt under the port's setting folder, with its
datafp-<tag>.txt (the in-train CNN checkpoints, *_cnn_epoch*, stay
behind); where the flags use the gaussian embedding (--y2h_embed_type, or
--y2cov_embed_type with --use_Hy), JAX's projection W is written beside
them (embedding/analytic.gaussian_projection reads it), one row per
selected label dim of --label_dim; where --label_dim > 1 and
--dim_combination is not mean, JAX's initial combiner weights (its
PRNGKey(seed + 7) draw, never trained) are written beside them too
(embedding/combine.combiner_weights reads them). The aux regressors of
--lambda_aux come along as well: every entry model-aux_*/ of the JAX run's
<setting folder>/aux_models/ becomes the port's, params and BatchNorm
statistics.

The pinned eval backbones come along with --jax_eval_ckpt_path (alone, or
beside a milestone):

    python scripts/jax_milestone_to_torch.py --jax_eval_ckpt_path <JAX
        --eval_ckpt_path> --eval_ckpt_path <the port's>

carries every entry model-evalnets_<name>_<size>_seed<seed>/ of the JAX
<eval_ckpt_path>/eval_models/ (the AE encoder, the classifier and the
regressor) into the port's <eval_ckpt_path>/eval_models/ under the same
tag, and copies its niqe_model_*.npz; the port's run_ccgm_eval then loads
them, and prints the fingerprint JAX printed.

A DMD2-M milestone (JAX's dmd_main writes <setting>/dmd_results/model-dmd-<N>/)
comes across with --jax_dmd_milestone:

    python scripts/jax_milestone_to_torch.py --jax_results <folder holding
        model-dmd-<N>/> --jax_dmd_milestone N <dmd_main.py's flags>

restores it as orbax wrote it and converts the whole DMD2Trainer.state
with ccdm_tpu_torch.utils.convert.dmd_state_from_jax into
<root_path>/output/<data_name>_<image_size>/<setting_name>/dmd_results/
model-dmd-<N>/state.pt: `python -m ccdm_tpu_torch.serve_dmd` with the same
flags and --serve_milestone N serves its generator, and dmd_main.py
--resume_niter N trains on from it. The embed_models/ beside the JAX
results folder come along into the teacher's setting folder.
"""

from __future__ import annotations

import argparse
import os
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
os.environ.setdefault("JAX_PLATFORMS", "cpu")


def restore_jax_state(jax_results: str, milestone: int, args):
    """The JAX milestone as a namespace of numpy trees (the TrainState's
    fields), restored against the train state of the JAX denoiser of `args`
    (--architecture unet, adm or vit, built by ccdm_tpu.main.build_model)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from ccdm_tpu.main import build_model as jax_build_model
    from ccdm_tpu.training.state import create_train_state
    from ccdm_tpu.utils.ckpt import load_checkpoint

    model = jax_build_model(args, args.image_size, args.num_channels)
    size, ch = args.image_size, args.num_channels
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(args.train_lr, b1=0.9, b2=0.99))
    shapes = jax.eval_shape(lambda key: create_train_state(model.init(
        key, jnp.zeros((2, size, size, ch)), jnp.zeros((2,), jnp.int32),
        jnp.zeros((2, args.dim_embed)), None, train=False), tx), jax.random.PRNGKey(0))
    zeros = lambda tree: jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), tree)
    target = {name: zeros(getattr(shapes, name)) for name in
              ("step", "params", "batch_stats", "opt_state", "ema_step", "ema_params",
               "ema_batch_stats")}
    return types.SimpleNamespace(**load_checkpoint(jax_results, milestone, target))


def convert_embed_models(jax_embed_dir: str, port_embed_dir: str, args) -> list[str]:
    """Carry the JAX run's embed_models/ across; returns what was written."""
    import glob
    import shutil

    import jax
    import numpy as np
    import torch

    import jax.numpy as jnp

    from ccdm_tpu.embedding.combine import make_combiner as jax_make_combiner
    from ccdm_tpu.utils.ckpt import load_checkpoint
    from ccdm_tpu_torch.embedding.analytic import (
        COMBINER_SEED_OFFSET, GFP_SCALE, Y2COV_SEED, Y2H_SEED, projection_path,
        save_projection, selected_dims)
    from ccdm_tpu_torch.embedding.combine import combiner_path, make_combiner, save_combiner
    from ccdm_tpu_torch.models.resnet_embed import ModelY2Cov, ModelY2H
    from ccdm_tpu_torch.utils.ckpt import save_checkpoint
    from ccdm_tpu_torch.utils.convert import state_dict_from_jax

    written = []
    for path in sorted(glob.glob(os.path.join(jax_embed_dir, "model-y2*"))):
        tag = os.path.basename(path)[len("model-"):]
        if "_cnn_epoch" in tag:
            continue
        stored = load_checkpoint(jax_embed_dir, tag)
        if "mlp" not in stored:  # an interrupted pretrain's partial entry
            continue
        out_dim = np.asarray(stored["mlp"]["params"]["dense_out"]["kernel"]).shape[1]
        mlp = ModelY2H(out_dim) if tag.startswith("y2h_") else ModelY2Cov(out_dim)
        save_checkpoint(port_embed_dir, tag, {"mlp": state_dict_from_jax(stored["mlp"], mlp)})
        marker = os.path.join(jax_embed_dir, f"datafp-{tag}.txt")
        if os.path.isfile(marker):
            shutil.copy(marker, os.path.join(port_embed_dir, f"datafp-{tag}.txt"))
        written.append(tag)
    cov_dim = args.num_channels * args.image_size ** 2
    label_dim = getattr(args, "label_dim", 1)
    dim_combination = getattr(args, "dim_combination", "mean")
    num_dims = len(selected_dims(label_dim))
    for kind, dim, seed, used in (
            ("y2h", args.dim_embed, Y2H_SEED, args.y2h_embed_type == "gaussian"),
            ("y2cov", cov_dim, Y2COV_SEED, args.use_Hy and args.y2cov_embed_type == "gaussian")):
        if used:  # ccdm_tpu/embedding/analytic.py:60-62
            W = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (num_dims, dim // 2))
                           * GFP_SCALE)
            path = projection_path(port_embed_dir, kind, dim, seed, num_dims)
            save_projection(path, torch.from_numpy(np.array(W, np.float32)))
            written.append(os.path.basename(path))
    if label_dim > 1 and dim_combination != "mean":
        # (kind, embed_dim, dims combined, seed) of each combiner the flags
        # build: ccdm_tpu/embedding/analytic.py:65-71, ili.py:549-555
        combiners = []
        if args.y2h_embed_type == "resnet":
            combiners.append(("y2h", args.dim_embed, label_dim, args.seed))
        else:
            combiners.append(("y2h", args.dim_embed, num_dims, Y2H_SEED))
            if args.use_Hy and args.y2cov_embed_type != "resnet":
                combiners.append(("y2cov", cov_dim, num_dims, Y2COV_SEED))
        for kind, dim, dims, seed in combiners:
            seed += COMBINER_SEED_OFFSET
            variables = jax_make_combiner(dim_combination, dim, dims).init(
                jax.random.PRNGKey(seed), jnp.zeros((dims, 1, dim)))
            module = make_combiner(dim_combination, dim, dims)
            module.load_state_dict(state_dict_from_jax(jax.device_get(variables), module))
            path = combiner_path(port_embed_dir, kind, dim_combination, dim, dims, seed)
            save_combiner(path, module)
            written.append(os.path.basename(path))
    return written


def convert_aux_models(jax_aux_dir: str, port_aux_dir: str, args) -> list[str]:
    """Carry the JAX run's aux_models/ (the --lambda_aux regressors) across;
    returns the tags written."""
    import glob

    from ccdm_tpu.utils.ckpt import load_checkpoint
    from ccdm_tpu_torch.models.aux_net import make_aux_net
    from ccdm_tpu_torch.utils.ckpt import save_checkpoint
    from ccdm_tpu_torch.utils.convert import state_dict_from_jax

    written = []
    for path in sorted(glob.glob(os.path.join(jax_aux_dir, "model-aux_*"))):
        tag = os.path.basename(path)[len("model-"):]
        name = tag.split("_")[1]  # aux_<name>_e<epochs>_seed<seed>
        net = make_aux_net(name, in_channels=args.num_channels, image_size=args.image_size)
        variables = load_checkpoint(jax_aux_dir, tag)
        save_checkpoint(port_aux_dir, tag, {"net": state_dict_from_jax(variables, net)})
        written.append(tag)
    return written


def eval_nets_for(stored: dict) -> dict:
    """The port's eval backbones shaped as a JAX {"ae", "cls", "reg"} tree:
    the channels, image size, classes and ResNet depth read off its
    kernels."""
    import numpy as np

    from ccdm_tpu_torch.eval.backbones import AEEncoder, ResNetEval

    ae = stored["ae"]["params"]
    channels = np.asarray(ae["conv0"]["kernel"]).shape[2]
    flat, bottleneck = np.asarray(ae["linear"]["kernel"]).shape
    width = np.asarray(ae["conv7"]["kernel"]).shape[3]
    size = 16 * int(round((flat // width) ** 0.5))

    def resnet(tree, mode):
        p = tree["params"]
        stages = {}
        for name in p:
            if name.startswith("stage"):
                stage, block = name[len("stage"):].split("_block")
                stages[int(stage)] = max(stages.get(int(stage), 0), int(block) + 1)
        blocks = tuple(stages[i] for i in range(len(stages)))
        return ResNetEval(np.asarray(p["head"]["kernel"]).shape[1], mode, blocks, channels)

    return {"ae": AEEncoder(bottleneck, width // 8, channels, size),
            "cls": resnet(stored["cls"], "class"), "reg": resnet(stored["reg"], "regre")}


def convert_eval_models(jax_eval_dir: str, port_eval_dir: str) -> list[str]:
    """Carry a JAX --eval_ckpt_path's eval_models/ across: every
    evalnets_* entry (the pinned SFID/LS/Diversity backbones) and every
    niqe_model_*.npz (one npz layout serves both packages); returns what
    was written."""
    import glob
    import shutil

    from ccdm_tpu.utils.ckpt import load_checkpoint
    from ccdm_tpu_torch.utils.ckpt import save_checkpoint
    from ccdm_tpu_torch.utils.convert import state_dict_from_jax

    written = []
    for path in sorted(glob.glob(os.path.join(jax_eval_dir, "model-evalnets_*"))):
        tag = os.path.basename(path)[len("model-"):]
        stored = load_checkpoint(jax_eval_dir, tag)
        nets = eval_nets_for(stored)
        save_checkpoint(port_eval_dir, tag, {name: state_dict_from_jax(stored[name], net)
                                             for name, net in nets.items()})
        written.append(tag)
    for path in sorted(glob.glob(os.path.join(jax_eval_dir, "niqe_model_*.npz"))):
        os.makedirs(port_eval_dir, exist_ok=True)
        shutil.copy(path, os.path.join(port_eval_dir, os.path.basename(path)))
        written.append(os.path.basename(path))
    return written


def convert(jax_results: str, milestone: int, argv: list[str]) -> str:
    """Write the port's milestone `milestone` from the JAX one, and carry its
    setting folder's embed_models/ and aux_models/ across; returns the
    milestone's path."""
    from ccdm_tpu_torch.main import build_model, results_folder
    from ccdm_tpu_torch.opts import parse_opts
    from ccdm_tpu_torch.training.trainer import checkpoint_tree
    from ccdm_tpu_torch.utils.ckpt import save_checkpoint
    from ccdm_tpu_torch.utils.convert import train_state_from_jax

    args = parse_opts(argv)
    jax_state = restore_jax_state(jax_results, milestone, args)
    state = train_state_from_jax(jax_state, build_model(args, args.image_size, args.num_channels))
    path = save_checkpoint(results_folder(args), milestone, checkpoint_tree(state))
    jax_setting = os.path.dirname(os.path.abspath(jax_results))
    port_setting = os.path.dirname(results_folder(args))
    embed = convert_embed_models(os.path.join(jax_setting, "embed_models"),
                                 os.path.join(port_setting, "embed_models"), args)
    if embed:
        print(f"embed_models: {', '.join(embed)}")
    aux = convert_aux_models(os.path.join(jax_setting, "aux_models"),
                             os.path.join(port_setting, "aux_models"), args)
    if aux:
        print(f"aux_models: {', '.join(aux)}")
    return path


def convert_dmd(jax_results: str, milestone: int, argv: list[str]) -> str:
    """Write the port's DMD milestone dmd-<milestone> from JAX's (its
    DMD2Trainer.state: netG, netD and the fake UNet with their statistics,
    both optimizers' Adam moments and counts, step) under the port's
    <setting folder>/dmd_results/, where dmd_main.py and serve_dmd.py read
    it; carry <dirname of jax_results>/embed_models/ into the teacher's
    setting folder, where both take the label embedding. argv holds
    dmd_main.py's flags. Returns the milestone's path."""
    from ccdm_tpu.utils.ckpt import legacy_to_fused, load_checkpoint
    from ccdm_tpu_torch.dmd_main import (
        build_gan, dmd_results_folder, parse_opts_dmd, setting_folder)
    from ccdm_tpu_torch.models.unet import Unet
    from ccdm_tpu_torch.opts import parse_channel_mult
    from ccdm_tpu_torch.utils.ckpt import save_checkpoint
    from ccdm_tpu_torch.utils.convert import dmd_state_from_jax

    args = parse_opts_dmd(argv)
    tree = legacy_to_fused(load_checkpoint(jax_results, f"dmd-{milestone}"))
    netG, netD = build_gan(args, args.num_channels, args.image_size)
    fake_unet = Unet(dim=args.model_channels, dim_mults=parse_channel_mult(args.channel_mult),
                     in_channels=args.num_channels)
    path = save_checkpoint(dmd_results_folder(args), f"dmd-{milestone}",
                           dmd_state_from_jax(tree, netG, netD, fake_unet))
    jax_setting = os.path.dirname(os.path.abspath(jax_results))
    embed = convert_embed_models(os.path.join(jax_setting, "embed_models"),
                                 os.path.join(setting_folder(args, teacher=True),
                                              "embed_models"), args)
    if embed:
        print(f"embed_models: {', '.join(embed)}")
    return path


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--jax_results", default=None,
                        help="the JAX run's results folder, holding model-<N>/")
    parser.add_argument("--jax_milestone", type=int, default=None)
    parser.add_argument("--jax_dmd_milestone", type=int, default=None,
                        help="a DMD milestone model-dmd-<N>/ in --jax_results; the other "
                             "flags are then dmd_main.py's")
    parser.add_argument("--jax_eval_ckpt_path", default=None,
                        help="a JAX --eval_ckpt_path: its eval_models/ goes to the port's "
                             "--eval_ckpt_path")
    ours, port_argv = parser.parse_known_args(argv)
    if ours.jax_dmd_milestone is not None:
        if ours.jax_results is None or ours.jax_milestone is not None:
            parser.error("--jax_dmd_milestone goes with --jax_results alone")
        print(f"wrote {convert_dmd(ours.jax_results, ours.jax_dmd_milestone, port_argv)}")
        return
    if (ours.jax_results is None) != (ours.jax_milestone is None):
        parser.error("--jax_results and --jax_milestone go together")
    if ours.jax_results is None and ours.jax_eval_ckpt_path is None:
        parser.error("give --jax_results and --jax_milestone, --jax_eval_ckpt_path, or both")
    if ours.jax_results is not None:
        path = convert(ours.jax_results, ours.jax_milestone, port_argv)
        print(f"wrote {path}")
    if ours.jax_eval_ckpt_path is not None:
        from ccdm_tpu_torch.opts import parse_opts

        port_eval = os.path.join(parse_opts(port_argv).eval_ckpt_path, "eval_models")
        written = convert_eval_models(os.path.join(ours.jax_eval_ckpt_path, "eval_models"),
                                      port_eval)
        print(f"eval_models: {', '.join(written) or 'nothing to carry'} -> {port_eval}")


if __name__ == "__main__":
    main()
