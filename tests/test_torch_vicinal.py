"""Port parity: vicinal hyperparameters, weights and vicinity selection.

- compute_vicinal_hyperparams: exact (the same numpy code);
- pairwise distances and every weight variant (classic and sliced, hard and
  soft, per-target hard and soft) for D = 1 and D = 3: rtol 1e-6 (f32
  elementwise math in another framework);
- target labels and vicinity indices from the JAX draws, re-derived from
  the key with JAX's own split order and handed to the port: the same
  indices exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ccdm_tpu.ops import vicinal as jv
from ccdm_tpu.training import hyperparams as jh
from ccdm_tpu.training import vicinity as jvic
from ccdm_tpu_torch.ops import vicinal as tv
from ccdm_tpu_torch.training import hyperparams as th
from ccdm_tpu_torch.training import vicinity as tvic

torch.set_num_threads(2)


def _labels(rng, n, d):
    return rng.uniform(0, 1, (n, d)).astype(np.float32)


@pytest.mark.parametrize("policy,vtype,kappa,sigma", [
    ("rule_of_thumb", "hv", -1.0, -1.0), ("rule_of_thumb", "sv", -2.0, 0.05),
    ("rule_of_thumb", "shv", 0.03, None), ("percentile", "hv", None, -1.0),
    ("percentile", "ssv", 0.1, 0.02)])
@pytest.mark.parametrize("d", [1, 3])
def test_hyperparams_exact(policy, vtype, kappa, sigma, d):
    rng = np.random.default_rng(0)
    labels = np.round(rng.uniform(0, 1, (300, d)), 2)
    labels = labels[:, 0] if d == 1 else labels
    want = jh.compute_vicinal_hyperparams(labels, vtype, policy, sigma, kappa, 5.0, "l2")
    got = th.compute_vicinal_hyperparams(labels, vtype, policy, sigma, kappa, 5.0, "l2")
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    assert got[1] == want[1]


@pytest.mark.parametrize("distance", ["l1", "l2", "cosine"])
@pytest.mark.parametrize("d", [1, 3])
def test_pairwise_and_weights(distance, d):
    rng = np.random.default_rng(1)
    a, b = _labels(rng, 16, d), _labels(rng, 24, d)
    null = rng.uniform(size=16) < 0.3
    kappa = 0.2
    check = lambda got, want: np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                                         rtol=1e-6, atol=1e-7)
    check(tv.pairwise_distance(torch.from_numpy(a), torch.from_numpy(b), distance),
          jv.pairwise_distance(jnp.asarray(a), jnp.asarray(b), distance))
    for hard in (True, False):
        check(tv.classic_batch_weights(torch.from_numpy(a), kappa, hard, distance,
                                       torch.from_numpy(null)),
              jv.classic_batch_weights(jnp.asarray(a), kappa, hard, distance,
                                       jnp.asarray(null)))
        vecs = rng.normal(size=(5, d)).astype(np.float32)
        check(tv.sliced_batch_weights(torch.from_numpy(a), torch.from_numpy(vecs), kappa, hard,
                                      torch.from_numpy(null)),
              jv.sliced_batch_weights(jnp.asarray(a), jnp.asarray(vecs), kappa, hard,
                                      jnp.asarray(null)))
    t = _labels(rng, 16, d)
    check(tv.hard_weights_from_targets(torch.from_numpy(a), torch.from_numpy(t), kappa, distance),
          jv.hard_weights_from_targets(jnp.asarray(a), jnp.asarray(t), kappa, distance))
    check(tv.soft_weights_from_targets(torch.from_numpy(a), torch.from_numpy(t), kappa, distance),
          jv.soft_weights_from_targets(jnp.asarray(a), jnp.asarray(t), kappa, distance))


@pytest.mark.parametrize("vector_type", ["gaussian", "rademacher", "sphere"])
def test_projection_vectors_shape_and_kind(vector_type):
    v = tv.random_projection_vectors(vector_type, 3, 7, torch.Generator().manual_seed(0))
    assert v.shape == (7, 3) and v.dtype == torch.float32
    if vector_type == "rademacher":
        assert set(v.unique().tolist()) <= {-1.0, 1.0}
    if vector_type == "sphere":
        torch.testing.assert_close(v.norm(dim=-1), torch.ones(7), rtol=1e-5, atol=1e-5)


def _j(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("vtype", ["hv", "sv"])
@pytest.mark.parametrize("d", [1, 3])
def test_vicinity_indices_from_jax_draws(vtype, d):
    rng = np.random.default_rng(2)
    train = np.round(_labels(rng, 200, d), 2)
    uniq = np.unique(train, axis=0)
    key = jax.random.PRNGKey(7)
    k_target, k_select = jax.random.split(key)
    sigma, kappa = 0.02, 0.05
    targets_j = jvic.sample_target_labels(k_target, jnp.asarray(uniq), 32, sigma)
    k_pick, k_noise = jax.random.split(k_target)
    idx = jax.random.randint(k_pick, (32,), 0, uniq.shape[0])
    eps = jax.random.normal(k_noise, (32, d))
    targets_t = tvic.sample_target_labels(torch.from_numpy(uniq), 32, sigma, idx=_j(idx),
                                          eps=_j(eps))
    np.testing.assert_allclose(targets_t.numpy(), np.asarray(targets_j), rtol=1e-6, atol=1e-7)

    want = jvic.select_vicinity_indices(k_select, targets_j, jnp.asarray(train), kappa, vtype)
    g = jvic._gumbel(k_select, (32, 200))
    got = tvic.select_vicinity_indices(_j(targets_j), torch.from_numpy(train), kappa, vtype,
                                       gumbel_noise=_j(g))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("d,m", [(1, 1), (3, 4)])
def test_sliced_vicinity_indices_from_jax_draws(d, m):
    rng = np.random.default_rng(3)
    train = np.round(_labels(rng, 150, d), 2)
    targets = _labels(rng, 24, d)
    key = jax.random.PRNGKey(11)
    kappa = 0.04
    want = jvic.select_vicinity_indices_sliced(key, jnp.asarray(targets), jnp.asarray(train),
                                               kappa, "gaussian", m)
    k_vec, k_tie, k_choice = jax.random.split(key, 3)
    vecs = jv.random_projection_vectors(k_vec, "gaussian", d, m)
    tie = jax.random.uniform(k_tie, (24, 150))
    g = jvic._gumbel(k_choice, (24, 10))
    got = tvic.select_vicinity_indices_sliced(torch.from_numpy(targets), torch.from_numpy(train),
                                              kappa, "gaussian", m, vecs=_j(vecs), tie=_j(tie),
                                              gumbel_noise=_j(g))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_selection_from_a_generator_stays_in_the_vicinity():
    train = torch.linspace(0, 1, 101)[:, None]
    targets = torch.tensor([[0.2], [0.5], [2.0]])
    idx = tvic.select_vicinity_indices(targets, train, 0.03, "hv",
                                       gen=torch.Generator().manual_seed(0))
    assert (train[idx[:2]] - targets[:2]).abs().max() <= 0.03 + 1e-6
    assert int(idx[2]) == 100  # empty vicinity: the nearest label
