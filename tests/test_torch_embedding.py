"""Port parity: the sinusoidal label and timestep embeddings.

Both are f32 transcendental math on the same inputs, so 1e-6. The two
embeddings differ on purpose (divisor half vs half-1, cos||sin vs sin||cos),
and each is held against its own JAX counterpart.
"""

import argparse

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ccdm_tpu.embedding.analytic import make_fn_y2h as jax_make_fn_y2h
from ccdm_tpu.models.layers import SinusoidalPosEmb
from ccdm_tpu_torch.embedding.analytic import make_fn_y2h
from ccdm_tpu_torch.embedding.resolve import build_label_embedding
from ccdm_tpu_torch.models.layers import sinusoidal_pos_emb

torch.set_num_threads(2)


@pytest.mark.parametrize("dim", [128, 33])
def test_sinusoidal_y2h_matches(dim):
    y = np.linspace(0.0, 1.0, 17).astype(np.float32)
    want = np.asarray(jax_make_fn_y2h(dim)(jnp.asarray(y)))
    got = make_fn_y2h(dim)(torch.from_numpy(y)).numpy()
    assert got.shape == (17, dim)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dim", [8, 64])
def test_sinusoidal_pos_emb_matches(dim):
    t = np.array([0, 1, 17, 250, 999], dtype=np.int32)
    want = np.asarray(SinusoidalPosEmb(dim).apply({}, jnp.asarray(t)))
    got = sinusoidal_pos_emb(torch.from_numpy(t), dim).numpy()
    # 1e-6, plus t times one f32 ulp of a frequency (<= 1.2e-7): XLA's and
    # torch's exp may round a frequency differently, and the argument t*freq
    # carries that ulp t-fold into sin and cos
    bound = 1e-6 + t[:, None].astype(np.float64) * 1.2e-7
    assert np.all(np.abs(got - want) <= bound)
    np.testing.assert_allclose(got[t < 20], want[t < 20], rtol=0, atol=1e-6)


@pytest.mark.parametrize("embed_type", ["gaussian", "resnet"])
def test_unported_embedding_types_raise(embed_type, tmp_path):
    """Both types take multi-dim labels now. Load-only, the gaussian one
    draws its W [2, 64] without writing it, and the resnet one raises
    FileNotFoundError without a trained cache; make_fn_y2h refuses the
    gaussian type without W and the resnet type, which is not analytic."""
    args = argparse.Namespace(dim_embed=128, y2h_embed_type=embed_type, label_dim=2,
                              use_Hy=False, image_size=16, num_channels=3, device="cpu")
    if embed_type == "gaussian":
        fn_y2h, _ = build_label_embedding(args, str(tmp_path))
        emb = fn_y2h(torch.tensor([[0.25, 0.5], [0.75, 1.0]]))
        assert emb.shape == (2, 128) and float(emb.min()) >= 0 and float(emb.max()) <= 1
        assert not (tmp_path / "embed_models").exists()
    else:
        with pytest.raises(FileNotFoundError, match="y2h"):
            build_label_embedding(args, str(tmp_path))
    with pytest.raises(ValueError, match="W" if embed_type == "gaussian" else "analytic"):
        make_fn_y2h(128, embed_type, label_dim=2)


def test_resolve_builds_sinusoidal_and_refuses_hy(tmp_path):
    """The sinusoidal y2h and, with --use_Hy, y2cov; H(y) from a resnet y2cov
    without the resnet y2h is refused, as ccdm_tpu refuses it."""
    args = argparse.Namespace(dim_embed=128, y2h_embed_type="sinusoidal", label_dim=1,
                              use_Hy=False, image_size=16, num_channels=3, device="cpu")
    fn_y2h, fn_y2cov = build_label_embedding(args, str(tmp_path))
    emb = fn_y2h(torch.tensor([0.25, 0.75]))
    assert emb.shape == (2, 128) and float(emb.min()) >= 0 and float(emb.max()) <= 1
    assert fn_y2cov is None
    args.use_Hy, args.y2cov_embed_type = True, "sinusoidal"
    _, fn_y2cov = build_label_embedding(args, str(tmp_path))
    assert fn_y2cov(torch.tensor([0.5])).shape == (1, 3 * 16 * 16)
    args.y2cov_embed_type = "resnet"
    with pytest.raises(SystemExit, match="y2h_embed_type resnet"):
        build_label_embedding(args, str(tmp_path))
