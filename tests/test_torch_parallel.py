"""The port's data parallelism (ccdm_tpu_torch/parallel/mesh.py): the
env-triplet bootstrap across two OS processes (the port's
tests/test_multihost.py), the batch split, and the global-batch BatchNorm
against one process on the whole batch and against flax's BatchNorm with
the batch sharded over the 8-device mesh (tests/test_multichip.py:48).

One module-scoped group: two processes started with CCDM_COORD_ADDR,
CCDM_NUM_PROCS and CCDM_PROC_ID and --device cpu join one gloo group
through init_distributed, all-reduce across the process boundary, split a
batch, run tests/torch_ranks.batch_norm_case and wait in main_first for
rank 0 to write a cache. Tolerances:
- the all-reduce, the split rows and the pass-through: exact;
- the BatchNorm (flax_batch_norm over [16, 8], resnet_embed.BatchNorm over
  [16, 4, 3, 3]) output, the gradients of sum(out * w) with respect to the
  input and the scale (the ranks' shares summed), and the running
  statistics, against one process and against flax under the mesh: 1e-6,
  relative and of the tensor's largest |value| (f32 sums of up to 144
  terms in another order); the output and the running statistics bit for
  bit across the two ranks.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ccdm_tpu.parallel import create_mesh as jax_create_mesh
from ccdm_tpu_torch.parallel import mesh as pmesh
from tests import torch_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 16

_WORKER = r"""
import datetime, os, sys, time
sys.path.insert(0, os.environ["CCDM_REPO"])
import torch
import torch.distributed as dist
from ccdm_tpu_torch.parallel.mesh import (constrain_batch, create_mesh, init_distributed,
                                          main_first, shard_batch)
from tests import torch_ranks

torch.set_num_threads(1)
assert init_distributed(device="cpu"), "the env triplet starts a multi-process run"
mesh = create_mesh()
out = {"backend": dist.get_backend(), "rank": mesh.rank, "size": mesh.size,
       "device": str(mesh.device)}
x = torch.arange(4, dtype=torch.float32) + 100 * mesh.rank
dist.all_reduce(x)  # across the process boundary
out["sum"] = x
out["rows"] = constrain_batch(mesh, torch.arange(8))
out["odd"] = constrain_batch(mesh, torch.arange(7))
out["tree"] = shard_batch({"a": torch.arange(8), "b": [torch.arange(6), torch.arange(3)]}, mesh)
out["bn"] = torch_ranks.batch_norm_case(mesh, torch.load(sys.argv[1], weights_only=False))
# rank 0 builds a cache for longer than the mesh's group waits
short = dist.new_group(backend="gloo", timeout=datetime.timedelta(seconds=2))
cache = os.path.join(sys.argv[2], "cache.txt")
t0 = time.monotonic()
with main_first(create_mesh(group=short)):
    if mesh.rank == 0:
        time.sleep(4)
        with open(cache, "w") as f:
            f.write("built")
    else:
        out["cache_seen"] = os.path.exists(cache)
out["waited"] = time.monotonic() - t0
torch.save(out, os.path.join(sys.argv[2], f"rank{mesh.rank}.pt"))
dist.destroy_process_group()
"""


def _payload():
    rng = np.random.default_rng(0)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    p = {"x1": t(rng.normal(size=(B, 8)) * 2 + 0.5), "w1": t(rng.normal(size=(B, 8))),
         "x4": t(rng.normal(size=(B, 4, 3, 3)) * 1.5 - 0.3),
         "w4": t(rng.normal(size=(B, 4, 3, 3)))}
    for key, c in (("1", 8), ("4", 4)):
        p["scale" + key] = t(rng.uniform(0.5, 1.5, c))
        p["bias" + key] = t(rng.normal(size=c))
        p["mean" + key] = t(rng.normal(size=c))
        p["var" + key] = t(rng.uniform(0.5, 1.5, c))
    return p


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("env_triplet")
    payload = _payload()
    torch.save(payload, tmp / "payload.pt")
    env = {**os.environ, "PYTHONPATH": REPO, "CCDM_REPO": REPO,
           "CCDM_COORD_ADDR": f"localhost:{torch_ranks.free_port()}", "CCDM_NUM_PROCS": "2"}
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(tmp / "payload.pt"), str(tmp)],
                              env={**env, "CCDM_PROC_ID": str(r)}, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{out}"
    return payload, [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(2)]


def test_env_triplet_joins_two_processes(group):
    _, ranks = group
    assert [r["rank"] for r in ranks] == [0, 1]
    for r in ranks:
        assert (r["backend"], r["size"], r["device"]) == ("gloo", 2, "cpu")
        assert torch.equal(r["sum"], torch.arange(4, dtype=torch.float32) * 2 + 100)


def test_constrain_batch_keeps_rows_or_passes_through(group):
    _, ranks = group
    for r in ranks:
        assert torch.equal(r["rows"], torch.arange(4) + 4 * r["rank"])
        assert torch.equal(r["odd"], torch.arange(7))  # 7 rows do not split over 2 ranks
        tree, k = r["tree"], r["rank"]
        assert torch.equal(tree["a"], torch.arange(4) + 4 * k)
        assert torch.equal(tree["b"][0], torch.arange(3) + 3 * k)
        assert torch.equal(tree["b"][1], torch.arange(3))


def test_main_first_outwaits_the_groups_timeout(group):
    """Rank 0 builds a cache for 4 s inside main_first on a mesh whose group
    times out after 2 s: rank 1 waits it out and then finds the cache."""
    _, ranks = group
    assert ranks[1]["cache_seen"]
    assert ranks[1]["waited"] >= 4.0


def _flax_reference(payload, key):
    """flax nn.BatchNorm in train mode with the batch sharded over the
    8-device mesh: output, d sum(out * w) / d (x, scale), batch_stats."""
    x, w = np.asarray(payload["x" + key]), np.asarray(payload["w" + key])
    if key == "4":  # NCHW -> NHWC, flax normalising the last axis
        x, w = x.transpose(0, 2, 3, 1), w.transpose(0, 2, 3, 1)
    variables = {"params": {"scale": jnp.asarray(payload["scale" + key]),
                            "bias": jnp.asarray(payload["bias" + key])},
                 "batch_stats": {"mean": jnp.asarray(payload["mean" + key]),
                                 "var": jnp.asarray(payload["var" + key])}}
    bn = fnn.BatchNorm(use_running_average=False,
                       momentum=0.99 if key == "1" else 0.9, epsilon=1e-5)

    def f(params, x):
        y, upd = bn.apply({**variables, "params": params}, x, mutable=["batch_stats"])
        return jnp.sum(y * w), (y, upd["batch_stats"])

    mesh = jax_create_mesh()
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("data")))
    (_, (y, stats)), (g_params, g_x) = jax.jit(
        jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(variables["params"], xs)
    y, g_x = np.asarray(y), np.asarray(g_x)
    if key == "4":
        y, g_x = y.transpose(0, 3, 1, 2), g_x.transpose(0, 3, 1, 2)
    return {"y": y, "x_grad": g_x, "scale_grad": np.asarray(g_params["scale"]),
            "mean": np.asarray(stats["mean"]), "var": np.asarray(stats["var"])}


@pytest.mark.parametrize("key", ["1", "4"], ids=["flax_batch_norm", "resnet_embed_BatchNorm"])
def test_batch_norm_statistics_are_global(group, key):
    payload, ranks = group
    one = torch_ranks.batch_norm_case(pmesh.Mesh(), payload)[key]
    got = [r["bn"][key] for r in ranks]
    assert torch.equal(got[0]["mean"], got[1]["mean"])
    assert torch.equal(got[0]["var"], got[1]["var"])
    assert torch.equal(got[0]["y"], got[1]["y"])
    two = {"y": got[0]["y"], "mean": got[0]["mean"], "var": got[0]["var"],
           "x_grad": got[0]["x_grad"] + got[1]["x_grad"],
           "scale_grad": got[0]["scale_grad"] + got[1]["scale_grad"]}
    flax = _flax_reference(payload, key)
    for name in ("y", "x_grad", "scale_grad", "mean", "var"):
        for want, what in ((one[name], "one process"), (flax[name], "flax under the mesh")):
            want = np.asarray(want)
            np.testing.assert_allclose(np.asarray(two[name]), want, rtol=1e-6,
                                       atol=1e-6 * max(1.0, np.abs(want).max()),
                                       err_msg=f"{name} vs {what}")


def test_a_mesh_of_one_is_the_identity(monkeypatch):
    """Without a process group every helper returns its input and launches
    no collective."""
    monkeypatch.setattr(pmesh.dist, "all_reduce", lambda *a, **k: pytest.fail("collective"))
    mesh = pmesh.create_mesh()
    assert (mesh.size, mesh.rank, mesh.group) == (1, 0, None)
    x = torch.randn(6, 3)
    assert pmesh.constrain_batch(mesh, x) is x
    assert pmesh.gather_batch(mesh, x) is x
    grads = [torch.randn(3)]
    assert pmesh.all_reduce_grads(mesh, grads) is grads
    assert pmesh.sharded_apply(mesh, lambda a: a * 2, x).equal(x * 2)
    assert pmesh.batch_sharded(mesh, 6) == slice(None)
    assert pmesh.Mesh(rank=1, size=2, group=object()).over(7).size == 1


def test_init_distributed_reads_torchrun_and_refuses_the_cpu_fallback(monkeypatch):
    calls = []
    monkeypatch.setattr(pmesh.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(pmesh.dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    for name in ("CCDM_COORD_ADDR", "CCDM_NUM_PROCS", "CCDM_PROC_ID", "MASTER_ADDR",
                 "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    assert pmesh.init_distributed() is False and not calls  # single-process
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "29511")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    assert pmesh.init_distributed(device="cpu") is True
    assert calls == [("gloo", {"init_method": "tcp://localhost:29511", "world_size": 2,
                               "rank": 1})]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.init_distributed()  # the card by default: no gloo on the CPU instead
    assert len(calls) == 1
