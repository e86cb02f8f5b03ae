"""Port parity of the GAN nets and DiffAugment (ccdm_tpu_torch/models/sngan.py,
models/sagan.py, training/diffaugment.py) against ccdm_tpu's.

The JAX variables are converted by utils/convert.gan_state_dict_from_jax
(flax's spectral-norm statistics SpectralNorm_<k>/<layer>/kernel/{u, sigma}
become the layer's u and sigma buffers). Tolerances, each with its reason:
- flax's spectral norm on a conv and a dense, train and eval: the output,
  the stored u and sigma, and the gradient of the kernel (through sigma)
  within 1e-5 (f32 products in another framework; the power iteration is
  one step of the same formulas);
- ConditionalBatchNorm after two train forwards: the running statistics
  at momentum 0.9 (SNGAN) and 0.999 (SAGAN) and the outputs within 1e-6;
- SNGAN and SAGAN G and D at 64x64, gene_ch = disc_ch = 4, dim_z 8, B 4,
  train and eval, on converted weights with BatchNorm statistics and the
  attention gate moved off their initial values: outputs within 1e-5 of
  the largest |value| (a dozen f32 convs, ReLUs and tanh), and every
  statistic the train forward stored (BatchNorm, u, sigma) within 1e-5;
  the same at 128x128 and 192x192 (5 blocks, from 6x6 at 192), B 2, with
  one train step's gradient of every parameter (a weighted sum of the
  train output) within 1e-5 of its largest |value|, in f64 on both sides
  (jax.enable_x64): in f32 the train-mode BatchNorm statistics over 2 x
  128^2 to 2 x 192^2 pixels, summed in another order by XLA and PyTorch,
  move G's output by up to 1.7e-5;
- DiffAugment on JAX's draws (re-derived from the key with JAX's fold_in
  and split order): translation and cutout exact (a gather and a mask),
  color and the default chain within 1e-6 (means in another order), and
  the gradient of a weighted sum with respect to x in the same bounds.
"""

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from ccdm_tpu.models import sagan as jsagan
from ccdm_tpu.models import sngan as jsngan
from ccdm_tpu.training.diffaugment import diff_augment as jax_diff_augment
from ccdm_tpu_torch.models import sagan, sngan
from ccdm_tpu_torch.training.diffaugment import DEFAULT_POLICY, diff_augment
from ccdm_tpu_torch.utils.convert import gan_state_dict_from_jax

torch.set_num_threads(2)

B, SIZE, NC, DIM_Z, EMBED = 4, 64, 3, 8, 128


def _t(a):
    return torch.from_numpy(np.array(a))


def _nchw(a):
    return _t(a).permute(0, 3, 1, 2).contiguous()


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _variables(module, *args, seed=0):
    """Variables in the tree of module.init(*args) (shapes from eval_shape;
    flax's eager init takes ~20 s a net here), drawn with numpy: kernels
    ~ N(0, 1/fan-in), biases and norm scales near 0 and 1, u ~ N(0, 1),
    sigma 1, BatchNorm running statistics and the attention gate off their
    initial values (so that eval mode and the attention path show)."""
    shapes = jax.eval_shape(lambda k: module.init(k, *args, train=False), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = jax.tree_util.keystr(path), leaf.shape
        if name.endswith("['mean']"):
            a = rng.normal(0, 0.2, shape)
        elif name.endswith("['var']"):
            a = rng.uniform(0.5, 1.5, shape)
        elif name.endswith("/u']"):
            a = rng.normal(0, 1, shape)
        elif name.endswith("/sigma']"):
            a = np.ones(shape)
        elif name.endswith("['sigma']"):  # SAGAN's attention gate
            a = np.full(shape, 0.7)
        elif len(shape) >= 2:
            a = rng.normal(0, 1 / np.sqrt(np.prod(shape[:-1])), shape)
        elif name.endswith("['scale']"):
            a = 1 + rng.normal(0, 0.1, shape)
        else:
            a = rng.normal(0, 0.1, shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _stats_close(port_model, jax_stats, params):
    want = gan_state_dict_from_jax({"params": params, "batch_stats": jax_stats}, port_model)
    got = port_model.state_dict()
    names = [n for n, b in port_model.named_buffers() if b.is_floating_point()]
    assert names
    for name in names:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


# --------------------------------------------------------- spectral norm


class _FlaxSNConv(fnn.Module):
    @fnn.compact
    def __call__(self, x, train):
        return fnn.SpectralNorm(fnn.Conv(5, (3, 3), padding=1, name="conv"))(
            x, update_stats=train)


class _FlaxSNDense(fnn.Module):
    @fnn.compact
    def __call__(self, x, train):
        return fnn.SpectralNorm(fnn.Dense(6, name="dense"))(x, update_stats=train)


class _PortSNConv(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = sngan.SNConv2d(3, 5, 3, padding=1)

    def forward(self, x, train):
        return self.conv(x, update=train)


class _PortSNDense(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.dense = sngan.SNLinear(7, 6)

    def forward(self, x, train):
        return self.dense(x, update=train)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("layer", ["conv", "dense"])
def test_spectral_norm_is_flaxs(layer, train):
    rng = np.random.default_rng(1)
    if layer == "conv":
        fmod, port = _FlaxSNConv(), _PortSNConv()
        x = rng.normal(size=(2, 6, 6, 3)).astype(np.float32)
        to_port, from_port = _nchw, _nhwc
    else:
        fmod, port = _FlaxSNDense(), _PortSNDense()
        x = rng.normal(size=(2, 7)).astype(np.float32)
        to_port, from_port = _t, lambda t: t.detach().numpy()
    variables = _variables(fmod, x, seed=3)
    r = rng.normal(size=np.asarray(fmod.apply(variables, x, train=False)).shape)
    r = r.astype(np.float32)

    def loss(params):
        out, upd = fmod.apply({"params": params, "batch_stats": variables["batch_stats"]}, x,
                              train=train, mutable=["batch_stats"])
        return jnp.sum(out * r), (out, upd["batch_stats"])

    (_, (want, stats)), grads = jax.value_and_grad(loss, has_aux=True)(variables["params"])
    port.load_state_dict(gan_state_dict_from_jax(variables, port))
    out = port(to_port(x), train)
    out.backward(to_port(r))
    np.testing.assert_allclose(from_port(out), np.asarray(want), rtol=1e-5, atol=1e-5)
    _stats_close(port, jax.device_get(stats), variables["params"])
    if not train:  # the eval forward stores nothing
        _stats_close(port, variables["batch_stats"], variables["params"])
    want_grad = gan_state_dict_from_jax({"params": jax.device_get(grads),
                                         "batch_stats": variables["batch_stats"]}, port)
    sub = getattr(port, layer)
    for name in ("weight", "bias"):
        np.testing.assert_allclose(getattr(sub, name).grad.numpy(),
                                   want_grad[f"{layer}.{name}"].numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("momentum", [0.9, 0.999])
def test_conditional_batch_norm_statistics(momentum):
    rng = np.random.default_rng(2)
    jm = jsngan.ConditionalBatchNorm(4, momentum=momentum)
    x = (rng.normal(size=(8, 5, 5, 4)) * 3 + 1).astype(np.float32)
    y = rng.uniform(size=(8, EMBED)).astype(np.float32)
    variables = _variables(jm, x, y)
    variables["batch_stats"] = {"bn": {"mean": np.zeros(4, np.float32),
                                       "var": np.ones(4, np.float32)}}
    port = sngan.ConditionalBatchNorm(4, EMBED, momentum=momentum)
    port.load_state_dict(gan_state_dict_from_jax(variables, port))
    stats = variables["batch_stats"]
    for _ in range(2):
        want, upd = jm.apply({"params": variables["params"], "batch_stats": stats}, x, y,
                             train=True, mutable=["batch_stats"])
        stats = jax.device_get(upd["batch_stats"])
        got = port(_nchw(x), _t(y), True)
        np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=1e-6, atol=1e-6)
    _stats_close(port, stats, variables["params"])
    np.testing.assert_allclose(port.bn.running_mean.numpy(),
                               (1 - momentum ** 2) * x.mean(axis=(0, 1, 2)), rtol=1e-5)


# ------------------------------------------------------------ the nets


def _nets(arch, size=SIZE):
    if arch == "sngan":
        return (jsngan.SNGANGenerator(dim_z=DIM_Z, nc=NC, img_size=size, gene_ch=4),
                jsngan.SNGANDiscriminator(nc=NC, img_size=size, disc_ch=4),
                sngan.SNGANGenerator(dim_z=DIM_Z, nc=NC, img_size=size, gene_ch=4),
                sngan.SNGANDiscriminator(nc=NC, img_size=size, disc_ch=4))
    return (jsagan.SAGANGenerator(dim_z=DIM_Z, nc=NC, img_size=size, gene_ch=4),
            jsagan.SAGANDiscriminator(nc=NC, img_size=size, disc_ch=4),
            sagan.SAGANGenerator(dim_z=DIM_Z, nc=NC, img_size=size, gene_ch=4),
            sagan.SAGANDiscriminator(nc=NC, img_size=size, disc_ch=4))


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * max(1.0, np.abs(want).max()))


# (arch, image size, batch): the 64x64 nets, then the 128x128 and 192x192
# ones (models/sngan.py: 5 blocks, from 6x6 at 192) with one train step, in f64
NET_CASES = [pytest.param(arch, size, b, id=arch + ("" if size == SIZE else f"-{size}"))
             for size, b in ((SIZE, B), (128, 2), (192, 2)) for arch in ("sngan", "sagan")]


@pytest.mark.parametrize("arch,size,b", NET_CASES)
def test_generator_and_discriminator_are_jaxs(arch, size, b):
    step = size != SIZE  # the larger nets: f64, and one train step's gradient
    with jax.enable_x64(step):
        _nets_are_jaxs(arch, size, b, step)


def _nets_are_jaxs(arch, size, b, step):
    rng = np.random.default_rng(4)
    jG, jD, pG, pD = _nets(arch, size)
    dt = np.float64 if step else np.float32
    z = rng.normal(size=(b, DIM_Z)).astype(dt)
    y = rng.uniform(size=(b, EMBED)).astype(dt)
    x = rng.uniform(-1, 1, size=(b, size, size, NC)).astype(dt)
    gv = _variables(jG, z, y)
    dv = _variables(jD, x, y, seed=1)
    if step:
        gv, dv = (jax.tree_util.tree_map(lambda a: a.astype(dt), v) for v in (gv, dv))
        pG.double()
        pD.double()
    for jnet, pnet, v, args, port_args in ((jG, pG, gv, (z, y), (_t(z), _t(y))),
                                          (jD, pD, dv, (x, y), (_nchw(x), _t(y)))):
        pnet.load_state_dict(gan_state_dict_from_jax(v, pnet))
        kw = {"return_features": True} if jnet is jD and arch == "sngan" else {}
        first = (lambda o: o[0]) if kw else (lambda o: o)
        shape = jax.eval_shape(lambda v, *a: first(jnet.apply(v, *a, train=False, **kw)),
                               v, *args).shape
        r = rng.normal(size=shape).astype(dt)

        def train_loss(params, v, *a):
            out, _ = jnet.apply({"params": params, "batch_stats": v["batch_stats"]}, *a,
                                train=True, mutable=["batch_stats"], **kw)
            return jnp.sum(first(out) * r)

        # eval, then train, then (step) the train gradient, in one compile
        want_eval, (want, upd), want_grad = jax.jit(lambda v, *a: (
            jnet.apply(v, *a, train=False, **kw),
            jnet.apply(v, *a, train=True, mutable=["batch_stats"], **kw),
            jax.grad(train_loss)(v["params"], v, *a) if step else None))(v, *args)
        with torch.no_grad():
            got = pnet(*port_args, train=False, **kw)
        if kw:  # SNGAN's (out, phi): phi in NCHW order on both sides
            _close(got[1].numpy(), want_eval[1])
            got, want_eval = got[0], want_eval[0]
        _close(_nhwc(got) if got.ndim == 4 else got.numpy(), want_eval)
        _stats_close(pnet, v["batch_stats"], v["params"])  # eval stores nothing
        with torch.no_grad():
            got = pnet(*port_args, train=True, **kw)
        if kw:
            got, want = got[0], want[0]
        _close(_nhwc(got) if got.ndim == 4 else got.numpy(), want)
        _stats_close(pnet, jax.device_get(upd["batch_stats"]), v["params"])
        if step:  # from the same weights and statistics, the train forward's gradient
            pnet.load_state_dict(gan_state_dict_from_jax(v, pnet))
            pnet.zero_grad(set_to_none=True)
            out = first(pnet(*port_args, train=True, **kw))
            out.backward(_nchw(r) if out.ndim == 4 else _t(r))
            grads = gan_state_dict_from_jax({"params": jax.device_get(want_grad),
                                             "batch_stats": v["batch_stats"]}, pnet)
            for name, p in pnet.named_parameters():
                _close(p.grad.numpy(), grads[name].numpy())


# ---------------------------------------------------------- DiffAugment


def _jax_aug_draws(key, b, h, w, policy):
    """DiffAugment's draws as ccdm_tpu's diff_augment makes them."""
    draws = {}
    for i, name in enumerate(p.strip() for p in policy.split(",")):
        k = jax.random.fold_in(key, i + 101)
        if name == "color":
            for j, part in enumerate(("brightness", "saturation", "contrast")):
                u = jax.random.uniform(jax.random.fold_in(k, j), (b, 1, 1, 1))
                draws[part] = _t(u).reshape(b)
        elif name == "translation":
            kx, ky = jax.random.split(k)
            sh, sw = int(h * 0.125 + 0.5), int(w * 0.125 + 0.5)
            draws["tx"] = _t(jax.random.randint(kx, (b,), -sh, sh + 1))
            draws["ty"] = _t(jax.random.randint(ky, (b,), -sw, sw + 1))
        else:
            kx, ky = jax.random.split(k)
            ch, cw = int(h * 0.5 + 0.5), int(w * 0.5 + 0.5)
            draws["cy"] = _t(jax.random.randint(kx, (b, 1, 1), 0, h + (1 - ch % 2))).reshape(b)
            draws["cx"] = _t(jax.random.randint(ky, (b, 1, 1), 0, w + (1 - cw % 2))).reshape(b)
    return draws


@pytest.mark.parametrize("policy,tol", [("color", 1e-6), ("translation", 0.0), ("cutout", 0.0),
                                        (DEFAULT_POLICY, 1e-6)])
def test_diff_augment_on_jax_draws(policy, tol):
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, size=(6, 16, 16, 3)).astype(np.float32)
    r = rng.normal(size=x.shape).astype(np.float32)
    key = jax.random.PRNGKey(9)
    want, vjp = jax.vjp(lambda v: jax_diff_augment(key, v, policy), jnp.asarray(x))
    (want_grad,) = vjp(jnp.asarray(r))
    xt = _nchw(x).requires_grad_()
    got = diff_augment(xt, policy, draws=_jax_aug_draws(key, 6, 16, 16, policy))
    got.backward(_nchw(r))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=tol, atol=tol)
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(want_grad), rtol=tol, atol=tol)
    if policy == "cutout":  # a square of 8x8 zeroed (less at the border) in every image
        zeroed = (_nhwc(got) == 0).all(axis=-1).sum(axis=(1, 2))
        assert ((zeroed > 0) & (zeroed <= 64)).all(), zeroed


def test_diff_augment_draws_from_its_generator():
    x = torch.rand(3, 3, 16, 16) * 2 - 1
    a = diff_augment(x, DEFAULT_POLICY, gen=torch.Generator().manual_seed(0))
    b = diff_augment(x, DEFAULT_POLICY, gen=torch.Generator().manual_seed(0))
    c = diff_augment(x, DEFAULT_POLICY, gen=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(diff_augment(x, ""), x)
