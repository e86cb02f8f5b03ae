"""The folded nearest-2x upsample + conv3x3 (ccdm_tpu_torch/ops/upsample_fold.py)
against the JAX package's (ccdm_tpu/ops/upsample_fold.py), and the
Upsample module's gate.

Tolerances: both variants and the reference composition against JAX's in
f32 at 1e-5 (the same products, summed in another order); the fold against
the port's own reference composition at 2e-5 (the JAX test's bound: the
aliased taps are pre-summed once in f32). The gate: CCDM_TPU_UPSAMPLE
sets the op's default variant, as in the JAX package, and the Upsample
module keeps the reference composition under it (the fold lost 2-4x to it
on an H100), with one conv's parameters.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ccdm_tpu.ops import upsample_fold as jfold
from ccdm_tpu_torch.models.layers import Upsample
from ccdm_tpu_torch.ops import upsample_fold


def _inputs(seed, b=2, h=9, w=7, cin=5, cout=8):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, h, w, cin)).astype(np.float32)
    kernel = (rng.normal(size=(3, 3, cin, cout)) * 0.3).astype(np.float32)
    bias = (rng.normal(size=cout) * 0.1).astype(np.float32)
    port = (torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(kernel).permute(3, 2, 0, 1),
            torch.from_numpy(bias))
    return (jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias)), port


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("variant", ["conv3", "conv2x3"])
@pytest.mark.parametrize("shape", [(2, 9, 7, 5, 8), (1, 32, 32, 4, 6)])
def test_folded_is_jaxs(variant, shape):
    b, h, w, cin, cout = shape
    jargs, targs = _inputs(1, b, h, w, cin, cout)
    got = upsample_fold.upsample_conv3x3_folded(*targs, variant)
    assert got.shape == (b, cout, 2 * h, 2 * w)
    want = np.asarray(jfold.upsample_conv3x3_folded(*jargs, variant))
    np.testing.assert_allclose(_nhwc(got), want, rtol=1e-5, atol=1e-5)
    ref = upsample_fold.upsample_conv3x3_reference(*targs)
    np.testing.assert_allclose(_nhwc(got), _nhwc(ref), rtol=2e-5, atol=2e-5)


def test_reference_is_jaxs_and_the_modules():
    jargs, targs = _inputs(2)
    got = upsample_fold.upsample_conv3x3_reference(*targs)
    np.testing.assert_allclose(_nhwc(got), np.asarray(jfold.upsample_conv3x3_reference(*jargs)),
                               rtol=1e-5, atol=1e-5)
    up = Upsample(5, 8)
    with torch.no_grad():
        up.conv.weight.copy_(targs[1]), up.conv.bias.copy_(targs[2])
    assert [n for n, _ in up.named_parameters()] == ["conv.weight", "conv.bias"]
    assert torch.equal(up(targs[0]), got)


def test_unknown_variant_raises():
    _, targs = _inputs(3)
    with pytest.raises(ValueError, match="unknown folded-upsample variant"):
        upsample_fold.upsample_conv3x3_folded(*targs, "conv9")


def test_the_gate(monkeypatch):
    """CCDM_TPU_UPSAMPLE is the op's default variant; the Upsample module
    takes the reference composition whatever it says (the JAX module folds
    on a TPU; the port does not fold on the card, where the fold lost)."""
    _, targs = _inputs(4, 1, 32, 32, 2, 3)
    monkeypatch.setattr(upsample_fold, "UPSAMPLE_VARIANT", "conv3")
    assert torch.equal(upsample_fold.upsample_conv3x3_folded(*targs),
                       upsample_fold.upsample_conv3x3_folded(*targs, "conv3"))
    calls = []
    monkeypatch.setattr(upsample_fold, "upsample_conv3x3_folded",
                        lambda *a: calls.append(a) or torch.zeros(1, 3, 64, 64))
    up = Upsample(2, 3)
    with torch.no_grad():
        up.conv.weight.copy_(targs[1]), up.conv.bias.copy_(targs[2])
    assert torch.equal(up(targs[0]), upsample_fold.upsample_conv3x3_reference(*targs))
    assert not calls
