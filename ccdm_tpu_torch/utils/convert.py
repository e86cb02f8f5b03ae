"""Carry JAX weights across to the port.

`state_dict_from_jax` turns the flax variables of a ccdm_tpu module
({"params": ..., "batch_stats": ...}, nested dicts of numpy arrays) into a
state_dict of the port's module of the same name tree (the Unet, a layer
such as LinearAttention or PreNormResidual(LinearAttention), an ILI net
of models/resnet_embed.py: ResNetEmbed's params and batch_stats, the label
MLPs' params, their GroupNorm scales becoming weights; a combiner of
embedding/combine.py, its LayerNorm scale becoming a weight; an aux
regressor of models/aux_net.py, params and batch_stats);
the ADM UNet and the ViT carry over by name alone (flax GroupNorm and
ChannelLayerNorm gains, their stride-2 and 1x1 convs, the *_attn children,
null_classes_emb / null_cond_emb as they are);
`unet_state_dict_from_jax` does it for a Unet:
- conv kernels HWIO -> OIHW (init_conv, the down/up convs, final_conv, the
  resnet blocks' conv1_kernel/conv2_kernel -> conv1_weight/conv2_weight);
- dense kernels [in, out] -> Linear.weight [out, in];
- a resnet block's res_kernel [Cin, Cout] -> res_weight [Cout, Cin, 1, 1];
- the attention blocks' qkv_kernel [C, 3F] and out_kernel [F, C] keep
  their layout (the kernel's signature is JAX's);
- cond_bn_* scale/bias and batch_stats mean/var -> BatchNorm weight/bias
  and running statistics; null_cond_emb as it is;
- a ConvTranspose kernel (the eval autoencoder's decoder; flax's
  transpose_kernel False) HWIO -> flipped in both spatial axes, [I, O, H, W],
  which nn.ConvTranspose2d(stride 2, padding 1) applies as flax's "SAME".
It raises on a leaf it does not consume and on a tensor of the port it
leaves unset. `jax_variables_from_state_dict` maps the state_dict of a
module of convs, Dense layers and flax norms (the eval backbones, the ADM
UNet, the ViT) back to the flax tree (the eval backbones' fingerprint
hashes that layout).

`train_state_from_jax` carries a whole JAX TrainState (numpy leaves) of
any of the three denoisers into
the port's training/state.TrainState: params and BatchNorm statistics, the
EMA shadow of both, Adam's mu, nu and count, step and ema_step.

`gan_state_dict_from_jax` does it for the GAN nets of models/sngan.py and
models/sagan.py, whose batch_stats also hold each spectral norm's u and
sigma under flax's names (<module>/SpectralNorm_<k>/<layer>/kernel/u);
`dmd_state_from_jax` carries a whole JAX DMD2Trainer.state (netG, netD and
the fake UNet with their statistics, both optimizers' Adam moments and
counts, step) into the port's DMD checkpoint tree (training/dmd.py);
`ccgan_state_from_jax` and `classgan_state_from_jax` do it for a JAX
CcGANTrainer.state and ClassGANTrainer.state (G, D, the ClassGAN's D2D-CE
or ADC head by state_dict_from_jax, statistics, both Adam states), and `save_class_table_from_jax`
writes JAX's class table of the class-conditional diffusion baselines
where the port reads it.
"""

from __future__ import annotations

import types
from typing import Any, Iterator, Mapping

import numpy as np
import torch
from torch import nn

_RENAMES = {"kernel": "weight", "scale": "weight", "conv1_kernel": "conv1_weight",
            "conv2_kernel": "conv2_weight", "res_kernel": "res_weight",
            "mean": "running_mean", "var": "running_var"}


def _leaves(tree: Mapping[str, Any], prefix=()) -> Iterator[tuple[tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v, dtype=np.float32)


def _to_torch_layout(name: str, arr: np.ndarray, transposed: bool = False) -> np.ndarray:
    if transposed:  # flax ConvTranspose HWIO, transpose_kernel False: flip, -> [I, O, H, W]
        return arr[::-1, ::-1].transpose(2, 3, 0, 1)
    if name == "res_weight":
        return arr.T[:, :, None, None]
    if name in ("weight", "conv1_weight", "conv2_weight") and arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    if name == "weight" and arr.ndim == 2:
        return arr.T  # Dense [in, out] -> Linear [out, in]
    return arr


def _named_tensors(tree: Mapping[str, Any], target: dict, transposed=frozenset()) -> dict:
    """{state_dict key: tensor} for the leaves of a flax params or
    batch_stats tree, each checked against `target`'s shape; the keys in
    `transposed` are nn.ConvTranspose2d weights."""
    out: dict[str, torch.Tensor] = {}
    for path, arr in _leaves(tree):
        names = list(path)
        if names[0] == "mid_attn_inner":  # flax registers it beside mid_attn
            names[:1] = ["mid_attn", "fn"]
        names[-1] = _RENAMES.get(names[-1], names[-1])
        key = ".".join(names)
        if key not in target or key in out:
            raise KeyError(f"JAX leaf {'/'.join(path)} has no place in the port "
                           f"(tried {key!r})")
        value = torch.from_numpy(np.array(_to_torch_layout(names[-1], arr, key in transposed)))
        if value.shape != target[key].shape:
            raise ValueError(f"{'/'.join(path)}: shape {tuple(value.shape)} does not "
                             f"fit {key} {tuple(target[key].shape)}")
        out[key] = value
    return out


def state_dict_from_jax(variables: Mapping[str, Any], model: nn.Module) -> dict:
    """The state_dict for `model` (the port's module of the same config)
    holding the JAX module's `variables`."""
    target = model.state_dict()
    out = _named_tensors(variables["params"], target, _transposed_weights(model))
    stats = _named_tensors(variables.get("batch_stats", {}), target)
    if set(out) & set(stats):
        raise KeyError(f"params and batch_stats share {sorted(set(out) & set(stats))}")
    out.update(stats)
    for key, value in target.items():
        if key in out:
            continue
        if key.endswith("num_batches_tracked"):  # unused by the port
            out[key] = value
        else:
            raise KeyError(f"the JAX variables leave {key} unset")
    return out


def _transposed_weights(model: nn.Module) -> frozenset:
    return frozenset(f"{name}.weight" for name, m in model.named_modules()
                     if isinstance(m, nn.ConvTranspose2d))


# the flax leaf of each (module type, torch name); weights and biases are
# params, running statistics batch_stats
_FLAX_LEAVES = {"weight": ("params", "kernel"), "bias": ("params", "bias"),
                "running_mean": ("batch_stats", "mean"), "running_var": ("batch_stats", "var")}


def jax_variables_from_state_dict(state_dict: Mapping[str, torch.Tensor],
                                  model: nn.Module) -> dict:
    """The inverse of state_dict_from_jax for modules built of nn.Conv2d,
    nn.ConvTranspose2d, nn.Linear, BatchNorm (resnet_embed's, or
    nn.BatchNorm1d), GroupNorm (resnet_embed's, or nn.GroupNorm), the ViT's
    ChannelLayerNorm and parameters of their own (the null embeddings):
    {"params": ..., "batch_stats": ...} in flax layout (HWIO kernels, Dense
    [in, out], norm scales), f32 numpy arrays in C order; batch_stats only
    where the model has running statistics."""
    from ccdm_tpu_torch.models.resnet_embed import BatchNorm, GroupNorm
    from ccdm_tpu_torch.models.vit import ChannelLayerNorm

    norms = (BatchNorm, GroupNorm, nn.BatchNorm1d, nn.GroupNorm)
    modules = dict(model.named_modules())
    own_params = {name for name, _ in model.named_parameters(recurse=False)}
    out: dict = {"params": {}, "batch_stats": {}}
    for key, tensor in state_dict.items():
        owner, _, leaf = key.rpartition(".")
        module = modules.get(owner)
        arr = tensor.detach().cpu().float().numpy()
        if leaf == "num_batches_tracked" and isinstance(module, nn.BatchNorm1d):
            continue  # flax keeps no count
        if key in own_params:
            out["params"][key] = np.ascontiguousarray(arr)
            continue
        collection, name = _FLAX_LEAVES.get(leaf, (None, None))
        if isinstance(module, ChannelLayerNorm) and leaf in ("g", "b"):
            collection, name = "params", leaf
        elif module is None or name is None or not isinstance(
                module, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear, *norms)):
            raise KeyError(f"{key} has no flax counterpart here")
        if isinstance(module, norms) and leaf == "weight":
            name = "scale"
        elif isinstance(module, nn.ConvTranspose2d) and leaf == "weight":
            arr = arr.transpose(2, 3, 0, 1)[::-1, ::-1]  # [I, O, H, W] -> flipped HWIO
        elif isinstance(module, nn.Conv2d) and leaf == "weight":
            arr = arr.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        elif isinstance(module, nn.Linear) and leaf == "weight":
            arr = arr.T
        node = out[collection]
        for part in owner.split("."):
            node = node.setdefault(part, {})
        node[name] = np.ascontiguousarray(arr)
    if not out["batch_stats"]:
        del out["batch_stats"]
    return out


def unet_state_dict_from_jax(variables: Mapping[str, Any], model: nn.Module) -> dict:
    """The state_dict for `model` (a port Unet of the same config) holding
    the JAX Unet's `variables`."""
    return state_dict_from_jax(variables, model)


def prenorm_linear_attention_from_fused(block: Mapping[str, torch.Tensor]) -> dict:
    """The state_dict of PreNormResidual(dim, LinearAttention(dim, ...)) that
    computes what a FusedLinearAttentionBlock with state_dict `block` computes:
    the port's copy of the mapping of ccdm_tpu/utils/ckpt.py:82-92, run the
    other way."""
    conv = lambda w: w.t().reshape(*w.t().shape, 1, 1)  # [in, out] -> OIHW 1x1
    return {"norm.g": block["norm_g"], "fn.to_qkv.weight": conv(block["qkv_kernel"]),
            "fn.to_out.weight": conv(block["out_kernel"]), "fn.to_out.bias": block["out_bias"],
            "fn.out_norm.g": block["out_norm_g"]}


def _adam_state(opt_state: Any) -> Any:
    """The optax ScaleByAdamState (count, mu, nu) inside a chain's state,
    as a namedtuple, or as the dict an orbax restore without a target
    gives (the chain's tuples then lists)."""
    if isinstance(opt_state, Mapping) and {"count", "mu", "nu"} <= set(opt_state):
        return types.SimpleNamespace(**opt_state)
    if all(hasattr(opt_state, f) for f in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for sub in opt_state:
            found = _adam_state(sub)
            if found is not None:
                return found
    return None


def train_state_from_jax(jax_state: Any, model: nn.Module):
    """The port's TrainState for `model` holding a JAX TrainState (with
    numpy leaves, e.g. jax.device_get(trainer.state)). `model` receives the
    online weights; the EMA model is a copy holding the shadow."""
    from ccdm_tpu_torch.training.state import create_train_state

    model.load_state_dict(unet_state_dict_from_jax(
        {"params": jax_state.params, "batch_stats": jax_state.batch_stats}, model))
    state = create_train_state(model)
    state.ema_model.load_state_dict(unet_state_dict_from_jax(
        {"params": jax_state.ema_params, "batch_stats": jax_state.ema_batch_stats}, model))
    adam = _adam_state(jax_state.opt_state)
    if adam is None:
        raise ValueError("the JAX opt_state holds no Adam state (count, mu, nu)")
    target = model.state_dict()
    mu, nu = _named_tensors(adam.mu, target), _named_tensors(adam.nu, target)
    names = [name for name, _ in model.named_parameters()]
    if set(mu) != set(names) or set(nu) != set(names):
        raise KeyError("the Adam moments do not cover the model's parameters")
    device = next(model.parameters()).device
    state.mu = [mu[k].to(device) for k in names]
    state.nu = [nu[k].to(device) for k in names]
    state.count = int(np.asarray(adam.count))
    state.step, state.ema_step = int(np.asarray(jax_state.step)), int(np.asarray(jax_state.ema_step))
    return state


def _spectral_batch_stats(tree: Mapping[str, Any]) -> dict:
    """flax's spectral-norm statistics, SpectralNorm_<k>: {"<layer>/kernel/u",
    "<layer>/kernel/sigma"} beside the wrapped layer, as <layer>: {u, sigma},
    the port's buffers of models/sngan.SNConv2d and SNLinear; the rest of
    the tree as it is."""
    out: dict = {}
    for key, value in tree.items():
        if not isinstance(value, Mapping):
            out[key] = value
        elif key.startswith("SpectralNorm_"):
            for name, leaf in value.items():
                layer, sep, stat = name.partition("/kernel/")
                if not sep or stat not in ("u", "sigma"):
                    raise KeyError(f"spectral-norm statistic {key}/{name} has no place "
                                   "in the port")
                out.setdefault(layer, {})[stat] = leaf
        else:
            out.setdefault(key, {}).update(_spectral_batch_stats(value))
    return out


def gan_state_dict_from_jax(variables: Mapping[str, Any], model: nn.Module) -> dict:
    """The state_dict of a port GAN net (models/sngan.py, models/sagan.py)
    holding the flax variables of its JAX counterpart: kernels to torch's
    layouts, BatchNorm statistics to running ones, and each spectral norm's
    u [1, out] and sigma to its layer's buffers."""
    return state_dict_from_jax({"params": variables["params"],
                                "batch_stats": _spectral_batch_stats(
                                    variables.get("batch_stats", {}))}, model)


def _module_tensors(model: nn.Module, state_dict: Mapping[str, torch.Tensor]) -> tuple:
    """(parameters in model.parameters() order, floating-point buffers in
    model.buffers() order) of `state_dict`: the layout of a DMD checkpoint's
    params and stats lists (training/dmd.py)."""
    params = [state_dict[name] for name, _ in model.named_parameters()]
    stats = [state_dict[name] for name, b in model.named_buffers() if b.is_floating_point()]
    return params, stats


def _moments(adam: Any, trees: list, models: list) -> tuple[list, list]:
    """Adam's mu and nu over the parameters of `models` in order, from the
    JAX moment trees `trees(mu or nu)` of each."""
    out = []
    for which in ("mu", "nu"):
        flat = []
        for tree_of, model in zip(trees, models):
            named = _named_tensors(tree_of(getattr(adam, which)), model.state_dict())
            names = [name for name, _ in model.named_parameters()]
            if set(named) != set(names):
                raise KeyError(f"Adam's {which} does not cover {type(model).__name__}'s "
                               "parameters")
            flat += [named[k] for k in names]
        out.append(flat)
    return out[0], out[1]


def dmd_state_from_jax(state: Mapping[str, Any], netG: nn.Module, netD: nn.Module,
                       fake_unet: nn.Module) -> dict:
    """The port's DMD2 checkpoint tree (training/dmd.checkpoint layout) of
    a JAX DMD2Trainer.state (numpy leaves, e.g. an orbax restore of
    model-dmd-<N>): step; netG's params and statistics (BatchNorm, spectral
    norm); gui_params {netD, fake_unet} and their statistics; each
    optimizer's (optax chain(clip_by_global_norm, adamw)) Adam moments and
    count, the guidance one over netD's then the fake UNet's parameters.
    Raises on a leaf it does not consume."""
    gen = _module_tensors(netG, gan_state_dict_from_jax(
        {"params": state["gen_params"], "batch_stats": state["gen_stats"]}, netG))
    disc = _module_tensors(netD, gan_state_dict_from_jax(
        {"params": state["gui_params"]["netD"], "batch_stats": state["netD_stats"]}, netD))
    fake = _module_tensors(fake_unet, unet_state_dict_from_jax(
        {"params": state["gui_params"]["fake_unet"],
         "batch_stats": state["fake_unet_stats"]}, fake_unet))
    if set(state["gui_params"]) != {"netD", "fake_unet"}:
        raise KeyError(f"gui_params holds {sorted(state['gui_params'])}")
    return {"step": int(np.asarray(state["step"])), "gen_params": gen[0], "gen_stats": gen[1],
            "gui_params": {"netD": disc[0], "fake_unet": fake[0]}, "netD_stats": disc[1],
            "fake_unet_stats": fake[1],
            "gen_opt": _adam_tree(state["gen_opt"], "gen_opt", [lambda t: t], [netG]),
            "gui_opt": _adam_tree(state["gui_opt"], "gui_opt",
                                  [lambda t: t["netD"], lambda t: t["fake_unet"]],
                                  [netD, fake_unet])}


def _adam_tree(opt_state: Any, name: str, trees: list, models: list) -> dict:
    """{"mu", "nu", "count"} of the Adam state inside a JAX optimizer
    state, the moments over the parameters of `models` in order."""
    adam = _adam_state(opt_state)
    if adam is None:
        raise ValueError(f"the JAX {name} holds no Adam state (count, mu, nu)")
    mu, nu = _moments(adam, trees, models)
    return {"mu": mu, "nu": nu, "count": int(np.asarray(adam.count))}


def _gan_pair_tree(state: Mapping[str, Any], netG: nn.Module, netD: nn.Module,
                   d_params: Mapping[str, Any]) -> dict:
    """G's and D's params and statistics of a JAX CcGAN or ClassGAN state
    ({"g_params", "g_stats", "d_stats", ...}; D's params given apart)."""
    gen = _module_tensors(netG, gan_state_dict_from_jax(
        {"params": state["g_params"], "batch_stats": state["g_stats"]}, netG))
    disc = _module_tensors(netD, gan_state_dict_from_jax(
        {"params": d_params, "batch_stats": state["d_stats"]}, netD))
    return {"step": int(np.asarray(state["step"])), "g_params": gen[0], "g_stats": gen[1],
            "d_params": disc[0], "d_stats": disc[1]}


def ccgan_state_from_jax(state: Mapping[str, Any], netG: nn.Module, netD: nn.Module) -> dict:
    """The port's CcGAN checkpoint tree (training/ccgan.checkpoint_tree) of a
    JAX CcGANTrainer.state (numpy leaves): step, G's and D's params and
    statistics (BatchNorm, spectral norm), both Adam states."""
    tree = _gan_pair_tree(state, netG, netD, state["d_params"])
    tree["g_opt"] = _adam_tree(state["g_opt"], "g_opt", [lambda t: t], [netG])
    tree["d_opt"] = _adam_tree(state["d_opt"], "d_opt", [lambda t: t], [netD])
    return tree


def classgan_state_from_jax(state: Mapping[str, Any], netG: nn.Module, netD: nn.Module,
                            head=None) -> dict:
    """The port's ClassGAN checkpoint tree (training/classgan.checkpoint_tree)
    of a JAX ClassGANTrainer.state: as ccgan_state_from_jax, D's params
    {"d", "head"} (the head None for --cond_loss none, whose JAX head is
    empty; D2DCEHead's embed and proxies, ADCHead's adc, by name) and one
    Adam state over both."""
    d_all = state["d_params"]
    if set(d_all) != {"d", "head"} or bool(d_all["head"]) != (head is not None):
        raise KeyError(f"d_params holds {sorted(d_all)}, head {bool(d_all.get('head'))}")
    tree = _gan_pair_tree(state, netG, netD, d_all["d"])
    head_params = []
    trees, models = [lambda t: t["d"]], [netD]
    if head is not None:
        sd = state_dict_from_jax({"params": d_all["head"]}, head)
        head_params = [sd[name] for name, _ in head.named_parameters()]
        trees.append(lambda t: t["head"])
        models.append(head)
    tree["d_params"] = {"d": tree["d_params"], "head": head_params}
    tree["g_opt"] = _adam_tree(state["g_opt"], "g_opt", [lambda t: t], [netG])
    tree["d_opt"] = _adam_tree(state["d_opt"], "d_opt", trees, models)
    return tree


def save_class_table_from_jax(table, folder: str, num_classes: int, seed: int,
                              dim: int = 128) -> str:
    """Write JAX's class table (diffusion/guided.make_fn_class_embed's
    N(0, 1) draw of PRNGKey(seed)) where the port's class_table reads it."""
    from ccdm_tpu_torch.diffusion.guided import class_table_path, save_class_table

    table = torch.from_numpy(np.array(table, np.float32))
    if tuple(table.shape) != (num_classes, dim):
        raise ValueError(f"the table is {tuple(table.shape)}, not {(num_classes, dim)}")
    path = class_table_path(folder, num_classes, dim, seed)
    save_class_table(path, table)
    return path
