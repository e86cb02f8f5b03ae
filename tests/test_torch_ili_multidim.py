"""Port parity of the ILI embedding's training on multi-dim labels
(embedding/ili.py; ccdm_tpu/embedding/ili.py:478-534): the regressor's
h2y head with D outputs in train_resnet_embed, and train_label_mlp on the
unique label rows flattened to scalars, with label noise 0.05 and no
feature phase.

JAX's initial weights are converted with utils/convert.state_dict_from_jax
and JAX's draws (fold_in(PRNGKey(seed), step), for the MLP split into index
and noise keys) handed to the port's steps; the bounds are those of the
scalar-label tests (tests/test_torch_ili.py): every leaf within 1e-5.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from ccdm_tpu.embedding import ili as jili
from ccdm_tpu.models.resnet_embed import ModelY2H as JaxY2H
from ccdm_tpu.models.resnet_embed import ResNetEmbed as JaxResNetEmbed
from ccdm_tpu_torch.embedding import ili
from ccdm_tpu_torch.models.resnet_embed import ModelY2H, ResNetEmbed
from ccdm_tpu_torch.utils.convert import state_dict_from_jax

torch.set_num_threads(2)

SMALL = (1, 1, 1, 1)
DIM, MLP_DIM, D = 16, 64, 3


def _jit_init(cls):
    class JitInit(cls):
        def init(self, rngs, *args, **kwargs):
            return jax.jit(lambda r, *a: cls.init(self, r, *a, **kwargs))(rngs, *args)

    return JitInit


def _port(module, variables):
    module.load_state_dict(state_dict_from_jax(variables, module))
    return module


def _assert_tree(port_module, jax_variables, atol=1e-5):
    sd = port_module.state_dict()
    for key, want in state_dict_from_jax(jax_variables, port_module).items():
        assert float((sd[key] - want).abs().max()) <= atol, key


def _moved(before, after) -> float:
    flat_b = jax.tree_util.tree_leaves(before)
    flat_a = jax.tree_util.tree_leaves(after)
    return max(float(np.abs(np.asarray(a) - np.asarray(b)).max()) for a, b in zip(flat_a, flat_b))


def test_multidim_resnet_embed_step_matches_jax(monkeypatch):
    """One SGD step of the regressor with a 3-output h2y head on [16, 3]
    labels."""
    monkeypatch.setattr(jili, "ResNetEmbed", _jit_init(JaxResNetEmbed))
    n, seed = 16, 4
    images = np.random.default_rng(1).integers(0, 256, (n, 16, 16, 3), dtype=np.uint8)
    labels = np.random.default_rng(2).uniform(0.05, 0.95, (n, D)).astype(np.float32)
    kw = dict(batch_size=n, seed=seed, num_blocks=SMALL, log_every=0)
    want = jili.train_resnet_embed(images, labels, DIM, epochs=1, **kw)
    init = jili.train_resnet_embed(images, labels, DIM, epochs=0, **kw)
    assert np.asarray(init["params"]["h2y"]["kernel"]).shape == (DIM, D)
    idx = jax.random.randint(jax.random.fold_in(jax.random.PRNGKey(seed), 0), (n,), 0, n)
    port = _port(ResNetEmbed(DIM, label_dim=D, num_blocks=SMALL), init)
    got = ili.train_resnet_embed(images, labels, DIM, epochs=1, net=port,
                                 draws=[{"idx": torch.from_numpy(np.array(idx))}], **kw)
    _assert_tree(got, {"params": want["params"], "batch_stats": want["batch_stats"]})
    assert _moved(init["params"], want["params"]) > 1e-4


def test_multidim_label_mlp_inversion_step_matches_jax():
    """One inversion step on the 6 unique rows of 3 dims flattened to 18
    scalars, label noise 0.05, through h2y's first output (JAX regresses
    every dim's labels through it, ccdm_tpu/embedding/ili.py:326-327)."""
    rows = np.random.default_rng(3).uniform(0.05, 0.95, (6, D)).astype(np.float32)
    flat = np.unique(rows, axis=0).reshape(-1)
    rng = np.random.default_rng(4)
    head = {"kernel": rng.normal(0, 0.5, (MLP_DIM, D)).astype(np.float32),
            "bias": rng.normal(0, 0.1, D).astype(np.float32)}
    seed = 9
    kw = dict(epochs=1, seed=seed, log_every=0, noise_sigma=0.05)
    module = _jit_init(JaxY2H)(MLP_DIM)
    feat_mean = rng.uniform(0, 1, MLP_DIM).astype(np.float32)
    want = jili.train_label_mlp(flat, {"params": {"h2y": head}}, module, MLP_DIM,
                                feat_mean=feat_mean, **kw)
    init = module.init(jax.random.PRNGKey(seed), jnp.zeros((2,)))
    k_idx, k_noise = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), 0))
    draws = [{"idx": torch.from_numpy(np.array(jax.random.randint(k_idx, (18,), 0, 18))),
              "noise": torch.from_numpy(np.array(jax.random.normal(k_noise, (18,))))}]
    h2y = torch.nn.Linear(MLP_DIM, D)
    with torch.no_grad():
        h2y.weight.copy_(torch.from_numpy(head["kernel"].T))
        h2y.bias.copy_(torch.from_numpy(head["bias"]))
    got = ili.train_label_mlp(flat, h2y, _port(ModelY2H(MLP_DIM), init), feat_mean=feat_mean,
                              draws=draws, **kw)
    _assert_tree(got, want)
    assert _moved(init["params"], want["params"]) > 1e-4
