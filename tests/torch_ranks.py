"""Rank groups for the port's data-parallel tests, and the steps they run.

`spawn(fn, payload, tmp, nprocs)` starts `nprocs` processes joined in one
gloo group on the CPU (torch.multiprocessing, spawned), runs
fn(mesh, payload) on each with mesh = parallel.create_mesh() and returns
the ranks' results in rank order. `fn` is a function of this module, so
that a spawned process imports torch and the port, not JAX. The same
functions run on one process with parallel.Mesh() (size 1) for the port's
one-process result.

Each `*_case` builds one of the port's trainers on the mesh from the
payload (weights, data and the JAX draws the parent re-derived), takes its
steps and returns the losses, parameters, statistics and optimizer moments.
"""

from __future__ import annotations

import os
import socket
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker(rank, nprocs, port, fn, payload_path, out_dir):
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=nprocs, rank=rank)
    try:
        from ccdm_tpu_torch.parallel.mesh import create_mesh

        out = fn(create_mesh(), torch.load(payload_path, weights_only=False))
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn, payload, tmp=None, nprocs: int = 2) -> list:
    """fn(mesh, payload) on `nprocs` gloo ranks; the ranks' results."""
    tmp = str(tmp or tempfile.mkdtemp())
    os.makedirs(tmp, exist_ok=True)
    path = os.path.join(tmp, "payload.pt")
    torch.save(payload, path)
    mp.start_processes(_worker, args=(nprocs, free_port(), fn, path, tmp), nprocs=nprocs,
                       start_method="spawn")
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(nprocs)]


def run_cases(mesh, payload: dict) -> dict:
    """Every case of the payload ({name: (case function name, its payload)})."""
    return {name: globals()[fn](mesh, p) for name, (fn, p) in payload.items()}


def _clone(ts) -> list:
    return [t.detach().clone() for t in ts]


def _stats(model) -> list:
    from ccdm_tpu_torch.training.dmd import stats_of

    return _clone(stats_of(model))


# ------------------------------------------------------------- the cases


def batch_norm_case(mesh, p: dict) -> dict:
    """flax_batch_norm (p["x1"] [B, C]) and resnet_embed.BatchNorm (p["x4"]
    [B, C, H, W]) in train mode under sharded_apply: the gathered output,
    this rank's share of the gradients of sum(out * p["w"]) with respect to
    the input and the scale (the ranks' shares sum to the whole), and the
    running statistics."""
    from ccdm_tpu_torch.models.layers import flax_batch_norm
    from ccdm_tpu_torch.models.resnet_embed import BatchNorm
    from ccdm_tpu_torch.parallel.mesh import sharded_apply

    class Dense(torch.nn.Module):  # holds its BatchNorm1d as the Unet does
        def __init__(self, c):
            super().__init__()
            self.bn = torch.nn.BatchNorm1d(c, eps=1e-5)

        def forward(self, x):
            return flax_batch_norm(self.bn, x, train=True)

    out = {}
    for key, module in (("1", Dense(p["x1"].shape[1])), ("4", BatchNorm(p["x4"].shape[1]))):
        bn = module.bn if key == "1" else module
        with torch.no_grad():
            bn.weight.copy_(p["scale" + key]), bn.bias.copy_(p["bias" + key])
            bn.running_mean.copy_(p["mean" + key]), bn.running_var.copy_(p["var" + key])
        x = p["x" + key].clone().requires_grad_(True)
        y = sharded_apply(mesh, module, x, **({} if key == "1" else {"train": True}))
        (y * p["w" + key]).sum().backward()
        out[key] = {"y": y.detach(), "x_grad": x.grad, "scale_grad": bn.weight.grad,
                    "mean": bn.running_mean.clone(), "var": bn.running_var.clone()}
    return out


def unet_case(mesh, p: dict) -> dict:
    """One diffusion Trainer step (compute_grads on the given draws and the
    label embedding sin(y p["y2h"]), then clip, Adam and the EMA); rank 0
    writes milestone 1."""
    from ccdm_tpu_torch.diffusion.gaussian import DiffusionConfig, GaussianDiffusion
    from ccdm_tpu_torch.models.unet import Unet
    from ccdm_tpu_torch.training.state import shadowed_tensors
    from ccdm_tpu_torch.training.trainer import Trainer, TrainerConfig

    model = Unet(**p["unet"])
    model.load_state_dict(p["state_dict"])
    model = model.to(memory_format=torch.channels_last)
    aux_info = None
    if p.get("aux"):
        aux_info = {"apply": lambda x, t: x.mean((1, 2, 3))[:, None] * 3.0 + 0.5,
                    "lambda_aux": 0.5, "aux_start_step": 0}
    tr = Trainer(GaussianDiffusion(model, DiffusionConfig(**p["diffusion"])), p["images"],
                 p["labels"], TrainerConfig(**p["trainer"]), aux_info=aux_info, mesh=mesh)
    w = p["y2h"]
    loss, grads = tr.compute_grads(lambda y: torch.sin(y @ w), draws=p["draws"])
    aux = tr.last_aux
    tr.apply_gradients(grads)
    tr.save(1)
    s = tr.state
    return {"loss": float(loss), "aux": None if aux is None else float(aux),
            "grads": _clone(grads), "params": _clone(s.model.parameters()),
            "buffers": _clone(s.model.buffers()), "mu": _clone(s.mu), "nu": _clone(s.nu),
            "ema": _clone(shadowed_tensors(s.ema_model))}


def dmd_case(mesh, p: dict) -> dict:
    """DMD2-M: a g_step from p["state0"], then a d_step from p["state_g"]."""
    from ccdm_tpu_torch.embedding.analytic import make_fn_y2cov, make_fn_y2h
    from ccdm_tpu_torch.models.sngan import SNGANDiscriminator, SNGANGenerator
    from ccdm_tpu_torch.models.unet import Unet
    from ccdm_tpu_torch.training.dmd import DMD2Trainer, DMDConfig

    nc, size = p["nc"], p["size"]
    teacher, fake = Unet(**p["unet"]), Unet(**p["unet"])
    teacher.load_state_dict(p["teacher"])
    netG = SNGANGenerator(**p["netG"])
    netD = SNGANDiscriminator(**p["netD"])
    tr = DMD2Trainer(teacher, fake, netG, netD, p["images"], p["labels"], make_fn_y2h(128),
                     DMDConfig(**p["cfg"]), fn_y2cov=make_fn_y2cov(nc * size * size),
                     device="cpu", mesh=mesh)
    tr.load_tree(p["state0"])
    g = [float(v) for v in tr.g_step(draws=p["g_draws"])]
    after_g = {"gen_params": _clone(netG.parameters()), "gen_stats": _stats(netG),
               "gen_mu": _clone(tr.gen_opt.mu)}
    tr.load_tree(p["state_g"])
    d = [float(v) for v in tr.d_step(draws=p["d_draws"])]
    return {"g": g, "d": d, "after_g": after_g, "tree": tr.checkpoint_tree()}


def ccgan_case(mesh, p: dict) -> dict:
    """CcGAN: a d_step with the NDA terms from p["state0"], then a g_step
    from p["state_d"]."""
    from ccdm_tpu_torch.embedding.analytic import make_fn_y2h
    from ccdm_tpu_torch.models.sngan import SNGANDiscriminator, SNGANGenerator
    from ccdm_tpu_torch.training.ccgan import CcGANConfig, CcGANTrainer

    netG, netD = SNGANGenerator(**p["netG"]), SNGANDiscriminator(**p["netD"])
    tr = CcGANTrainer(netG, netD, p["images"], p["labels"], make_fn_y2h(128),
                      CcGANConfig(**p["cfg"]), device="cpu", mesh=mesh, **p["banks"])
    tr.load_tree(p["state0"])
    d = float(tr.d_step(True, draws=p["d_draws"]))
    after_d = {"g_stats": _stats(netG), "d_stats": _stats(netD),
               "d_params": _clone(tr.d_params), "d_mu": _clone(tr.d_opt.mu)}
    tr.load_tree(p["state_d"])
    g = float(tr.g_step(draws=p["g_draws"]))
    return {"d": d, "g": g, "after_d": after_d, "tree": tr.checkpoint_tree()}


def classgan_case(mesh, p: dict) -> dict:
    """StudioGAN (D2D-CE): a d_step from p["state0"], then a g_step from
    p["state_d"]."""
    from ccdm_tpu_torch.models.sngan import SNGANDiscriminator, SNGANGenerator
    from ccdm_tpu_torch.training.classgan import ClassGANConfig, ClassGANTrainer

    netG, netD = SNGANGenerator(**p["netG"]), SNGANDiscriminator(**p["netD"])
    tr = ClassGANTrainer(netG, netD, p["images"], p["classes"], ClassGANConfig(**p["cfg"]),
                         device="cpu", mesh=mesh)
    tr.load_tree(p["state0"])
    d = float(tr.d_step(draws=p["d_draws"]))
    after_d = {"g_stats": _stats(netG), "d_stats": _stats(netD),
               "d_params": _clone(tr.d_params), "d_mu": _clone(tr.d_opt.mu)}
    tr.load_tree(p["state_d"])
    g = float(tr.g_step(draws=p["g_draws"]))
    return {"d": d, "g": g, "after_d": after_d, "tree": tr.checkpoint_tree()}
