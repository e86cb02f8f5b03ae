"""Data parallelism over torch.distributed (ccdm_tpu/parallel/mesh.py).

The JAX package shards the batch over a 1-axis `data` mesh and lets XLA
insert the collectives. Here a `Mesh` is the process group, this process's
rank and device, and the helpers say where a step's batch is split:

- every draw of a step is taken at the global batch on every rank, so the
  ranks hold the same targets, indices and noise as one process would;
- `sharded_apply` runs a model on this rank's rows of its batch arguments
  (`constrain_batch`) and gathers its outputs back to the global batch.
  The gather's backward keeps this rank's rows, so the losses (computed on
  the gathered outputs, the same on every rank) send each rank the gradient
  of its own rows, and `all_reduce_grads` sums the ranks' parameter
  gradients: the step computes the one-process step's function;
- the train-mode BatchNorms read `module.sync_mesh`, which `sharded_apply`
  sets for the duration of the call, and take their statistics over the
  global batch (`global_moments`: the row sums of x and x^2 all-reduced
  with autograd);
- a parameter used outside a sharded call (a loss head on the gathered
  features) goes through `replicated_apply`, whose gradient counts on rank
  0 only, so that the sum over ranks counts it once.

A batch whose size does not divide by the mesh size is not split
(`Mesh.over`): every rank runs the whole step and the gradients are not
summed, as XLA runs a leaf it cannot shard on every device. With no process
group the mesh has size 1 and every helper is the identity: no collective
is launched.

`init_distributed` bootstraps a multi-process run from the environment:
CCDM_COORD_ADDR / CCDM_NUM_PROCS / CCDM_PROC_ID as in the JAX package, or
torchrun's MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK (and LOCAL_RANK).
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in a 1-axis data-parallel mesh."""

    group: Optional[object] = None  # the process group; None at size 1
    rank: int = 0
    size: int = 1
    device: torch.device = torch.device("cpu")

    def over(self, batch: int) -> "Mesh":
        """The mesh a step over `batch` global rows shards on: this one, or
        the trivial mesh where `batch` does not divide by the size."""
        if self.size > 1 and batch % self.size == 0:
            return self
        return Mesh(rank=self.rank, device=self.device)

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def create_mesh(devices: Optional[Sequence] = None, group=None) -> Mesh:
    """The mesh over the default process group (or `group`), else of size 1.
    `devices` gives each rank's device (this rank takes devices[rank]); by
    default a rank of an NCCL group takes the current CUDA device and a rank
    of a gloo group the CPU."""
    if not (dist.is_available() and dist.is_initialized()):
        device = torch.device(devices[0]) if devices else torch.device("cpu")
        return Mesh(device=device)
    group = group or dist.group.WORLD
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    if devices is not None:
        if len(devices) != size:
            raise ValueError(f"{len(devices)} devices for a mesh of {size} ranks")
        device = torch.device(devices[rank])
    elif dist.get_backend(group) == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device("cpu")
    return Mesh(group=group if size > 1 else None, rank=rank, size=size, device=device)


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value else None


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device: Optional[str] = None) -> bool:
    """Join the run's process group; False when the run is single-process.

    The arguments fall back to CCDM_COORD_ADDR ("host:port"), CCDM_NUM_PROCS
    and CCDM_PROC_ID, then to torchrun's MASTER_ADDR:MASTER_PORT, WORLD_SIZE
    and RANK. The backend follows `device` (the entry points' --device):
    NCCL on the card, each rank on cuda:LOCAL_RANK (LOCAL_RANK, else the
    rank modulo the visible cards); gloo only where the caller asked for the
    CPU. Raises without a card unless device is "cpu": it never falls back
    to gloo over the CPU."""
    coordinator_address = coordinator_address or os.environ.get("CCDM_COORD_ADDR")
    if num_processes is None:
        num_processes = _env_int("CCDM_NUM_PROCS")
    if process_id is None:
        process_id = _env_int("CCDM_PROC_ID")
    if coordinator_address is None and num_processes is None:
        if os.environ.get("MASTER_ADDR") and os.environ.get("WORLD_SIZE"):
            coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                                   f"{os.environ.get('MASTER_PORT', '29500')}")
            num_processes = _env_int("WORLD_SIZE")
            process_id = _env_int("RANK")
        else:
            return False  # single-process
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("a multi-process run needs the coordinator address, the number "
                         "of processes and this process's id (CCDM_COORD_ADDR, "
                         "CCDM_NUM_PROCS, CCDM_PROC_ID)")
    on_cpu = torch.device(device or "cuda").type == "cpu"
    if not on_cpu:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available for the distributed run; "
                               "pass --device cpu to run the ranks on the CPU over gloo")
        local = _env_int("LOCAL_RANK")
        torch.cuda.set_device(process_id % torch.cuda.device_count() if local is None
                              else local)
    if not dist.is_initialized():
        dist.init_process_group("gloo" if on_cpu else "nccl",
                                init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
    return True


def bootstrap(device: Optional[str] = None) -> Mesh:
    """The entry points' start, before any device query: join the run's
    process group where the environment asks for one (init_distributed),
    print the bootstrap line, and return the mesh (size 1 otherwise)."""
    if init_distributed(device=device):
        mesh = create_mesh()
        print(describe(mesh), flush=True)
        return mesh
    return create_mesh()


def describe(mesh: Mesh) -> str:
    """The bootstrap line the entry points print (JAX's main.py:103-108)."""
    backend = dist.get_backend() if dist.is_initialized() else "none"
    local = torch.cuda.device_count() if mesh.device.type == "cuda" else 1
    return (f" torch.distributed: process {mesh.rank}/{mesh.size} ({backend}), "
            f"{local} local / {mesh.size} global devices, on {mesh.device}")


# ----------------------------------------------------------------- placement

def replicated(mesh: Mesh, module_or_tensors):
    """Broadcast a module's parameters and buffers (or a list of tensors)
    from rank 0, in place, once; returns what it was given."""
    if mesh.size == 1:
        return module_or_tensors
    if isinstance(module_or_tensors, nn.Module):
        tensors = [*module_or_tensors.parameters(), *module_or_tensors.buffers()]
    else:
        tensors = list(module_or_tensors)
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src=0, group=mesh.group)
    return module_or_tensors


def batch_sharded(mesh: Mesh, batch: int) -> slice:
    """This rank's rows of a batch of `batch` rows (all of them where the
    batch does not divide by the mesh size)."""
    if mesh.size > 1 and batch % mesh.size == 0:
        n = batch // mesh.size
        return slice(mesh.rank * n, (mesh.rank + 1) * n)
    return slice(None)


def constrain_batch(mesh: Mesh, *tensors):
    """This rank's rows of each tensor whose leading dim divides by the mesh
    size; None, scalars and other tensors pass through unchanged."""
    def one(t):
        if t is None or not isinstance(t, torch.Tensor) or t.ndim == 0:
            return t
        rows = batch_sharded(mesh, t.shape[0])
        return t if rows == slice(None) else t[rows]

    out = tuple(one(t) for t in tensors)
    return out if len(out) != 1 else out[0]


def shard_batch(x, mesh: Mesh):
    """constrain_batch over every tensor of a (nested) dict, list or tuple."""
    if isinstance(x, dict):
        return {k: shard_batch(v, mesh) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(shard_batch(v, mesh) for v in x)
    return constrain_batch(mesh, x)


# --------------------------------------------------------------- collectives

def _rows_of(mesh: Mesh, local: torch.Tensor) -> slice:
    return slice(mesh.rank * local.shape[0], (mesh.rank + 1) * local.shape[0])


def _gather_rows(mesh: Mesh, local: torch.Tensor) -> torch.Tensor:
    """The ranks' rows concatenated in rank order, in local's dtype."""
    full = local.new_empty((local.shape[0] * mesh.size, *local.shape[1:]))
    dist.all_gather(list(full.chunk(mesh.size)), local.contiguous(), group=mesh.group)
    return full


class _GatherRows(torch.autograd.Function):
    """_gather_rows; backward: this rank's rows of the gradient."""

    @staticmethod
    def forward(ctx, local, mesh):
        ctx.rows = _rows_of(mesh, local)
        return _gather_rows(mesh, local)

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.rows], None


def gather_batch(mesh: Mesh, local: torch.Tensor) -> torch.Tensor:
    """The global batch from each rank's rows; the gradient of the result
    reaches this rank's rows only."""
    if mesh.size == 1:
        return local
    if local.requires_grad:
        return _GatherRows.apply(local, mesh)
    return _gather_rows(mesh, local)


class _Rank0Grad(torch.autograd.Function):
    """Identity whose gradient is kept on rank 0 and zero elsewhere."""

    @staticmethod
    def forward(ctx, x, rank):
        ctx.keep = rank == 0
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return (grad if ctx.keep else torch.zeros_like(grad)), None


def all_reduce_grads(mesh: Mesh, grads: list) -> list:
    """The sum over the ranks of each gradient (the all-reduce XLA inserts),
    through one flattened bucket per dtype, in the list's order."""
    if mesh.size == 1 or not grads:
        return grads
    out = list(grads)
    for dtype in dict.fromkeys(g.dtype for g in grads):
        where = [i for i, g in enumerate(grads) if g.dtype == dtype]
        bucket = torch.cat([grads[i].reshape(-1) for i in where])
        dist.all_reduce(bucket, group=mesh.group)
        offset = 0
        for i in where:
            n = grads[i].numel()
            out[i] = bucket[offset:offset + n].view_as(grads[i])
            offset += n
    return out


def global_moments(x: torch.Tensor, dims, mesh: Optional[Mesh]):
    """flax's batch statistics over `dims`, over the global batch: E[x] and
    max(E[x^2] - E[x]^2, 0), the row sums of x and x^2 all-reduced with
    autograd when the mesh has more than one rank."""
    if mesh is None or mesh.size == 1:
        mean = x.mean(dims)
        return mean, torch.clamp((x * x).mean(dims) - mean * mean, min=0.0)
    from torch.distributed.nn.functional import all_reduce

    count = 1
    for d in dims:
        count *= x.shape[d]
    sums = all_reduce(torch.stack([x.sum(dims), (x * x).sum(dims)]), group=mesh.group)
    mean, mean_sq = sums[0] / (count * mesh.size), sums[1] / (count * mesh.size)
    return mean, torch.clamp(mean_sq - mean * mean, min=0.0)


# ------------------------------------------------------------- model calls

@contextlib.contextmanager
def batch_norm_mesh(module, mesh: Mesh):
    """Within the block, the train-mode BatchNorms of `module` take their
    statistics over `mesh`'s global batch."""
    if not isinstance(module, nn.Module) or mesh.size == 1:
        yield
        return
    norms = [m for m in module.modules()
             if isinstance(m, nn.modules.batchnorm._BatchNorm) or hasattr(m, "sync_mesh")]
    for m in norms:
        m.sync_mesh = mesh
    try:
        yield
    finally:
        for m in norms:
            m.sync_mesh = None


def sharded_apply(mesh: Optional[Mesh], fn: Callable, *batch_args, **kwargs):
    """fn(*batch_args, **kwargs) over this rank's rows of the batch
    arguments, its output (a tensor, or a tuple of batch tensors) gathered
    back to the global batch; kwargs pass unchanged. Without a mesh, or on
    one of size 1, fn(*batch_args, **kwargs)."""
    if mesh is None or mesh.size == 1:
        return fn(*batch_args, **kwargs)
    local = constrain_batch(mesh, *batch_args)
    local = local if isinstance(local, tuple) else (local,)
    with batch_norm_mesh(fn, mesh):
        out = fn(*local, **kwargs)
    if isinstance(out, (tuple, list)):
        return type(out)(gather_batch(mesh, o) for o in out)
    return gather_batch(mesh, out)


def replicated_apply(mesh: Mesh, module: nn.Module, *args, **kwargs):
    """module(*args, **kwargs) computed the same on every rank, the
    gradient of its parameters kept on rank 0, so that all_reduce_grads
    counts it once."""
    if mesh.size == 1:
        return module(*args, **kwargs)
    from torch.func import functional_call

    params = {name: _Rank0Grad.apply(p, mesh.rank) for name, p in module.named_parameters()}
    return functional_call(module, params, args, kwargs)


# --------------------------------------------------------- rank-0 writes

CACHE_WAIT = datetime.timedelta(days=1)  # main_first's wait for rank 0's caches


def barrier(mesh: Mesh) -> None:
    if mesh.size > 1:
        dist.barrier(group=mesh.group)


@contextlib.contextmanager
def main_first(mesh: Mesh):
    """Rank 0 runs the block first (it builds and writes a cache), the
    others after it (they load what it wrote). They wait on a gloo group of
    their own whose timeout is CACHE_WAIT: at a recipe's real epochs rank 0
    may train the ILI and aux nets for longer than the run's group waits
    (10 to 30 minutes by default, by backend). Rank 0 releases them also
    when the block raises."""
    if mesh.size == 1:
        yield
        return
    wait = dist.new_group(ranks=dist.get_process_group_ranks(mesh.group), backend="gloo",
                          timeout=CACHE_WAIT)
    try:
        if not mesh.is_main:
            dist.barrier(group=wait)
        try:
            yield
        finally:
            if mesh.is_main:
                dist.barrier(group=wait)
    finally:
        dist.destroy_process_group(wait)
