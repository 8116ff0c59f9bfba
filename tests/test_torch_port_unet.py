"""The U-Net family against the JAX package (CPU): every building block,
the two extra losses and the three models, forward and gradients, on the
same inputs and weights, both from numpy seeds (the weights in the JAX
modules' parameter trees, bridged by
``utils.params.from_flax_image_params``).

Tolerances: in fp32 max|port − jax| <= 1e-5 max|jax| (forward) and, per
leaf and for the input, 1e-4 max|jax| (gradients).  The whole models on
the odd 13 × 21 grid run in float64 in both packages (the JAX package
under ``jax.enable_x64``), forward and gradients within 1e-6 max|jax|:
the JAX package keeps float32 upsampling fractions and a complex64
spectrum under x64, which leave up to 3.1e-7 between the two.  In fp32
that grid is beyond both packages: V1's bottleneck is 1 × 2 pixels, and
its ``BatchStatNorm`` over two values cancels terms about 1e3 times the
result, so each package's fp32 gradients of ``down3`` sit 2-3e-4 max|g|
from a float64 evaluation (by its thread count and fusions), and a
channel whose two values nearly agree moves the forward by 2.5e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphcast_lite_tpu.models import unet as J
from graphcast_lite_tpu.training.loss import gradient_loss as j_gradient_loss
from graphcast_lite_tpu.training.loss import spectral_loss as j_spectral_loss
from graphcast_lite_torch.models import unet as T
from graphcast_lite_torch.models.grid_adapter import GridImageModel
from graphcast_lite_torch.training.loss import gradient_loss, spectral_loss
from graphcast_lite_torch.utils.params import from_flax_image_params, \
    from_flax_params
from torch_port_common import jax_params, \
    one_torch_thread  # noqa: F401 (one_torch_thread: an autouse fixture)

FWD_RTOL, GRAD_RTOL, F64_RTOL = 1e-5, 1e-4, 1e-6


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(np.asarray(a, np.float32), -1, 1)))


def _nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _close(out, ref, rtol, label):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (label, out.shape, ref.shape)
    err = np.abs(out - ref).max()
    tol = rtol * np.abs(ref).max()
    assert err <= tol, f"{label}: {err:.3e} > {tol:.3e}"


def _grads(jmod, params, x_nhwc, w):
    """(out, parameter gradients as port names, input gradient) of
    sum(out · w) in the JAX package, in the inputs' dtype."""
    def loss(p, x):
        y = jmod.apply(p, x)
        return jnp.sum(y * w), y

    (_, y), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, x_nhwc)
    return (np.asarray(y), from_flax_image_params(
        jax.tree.map(np.asarray, gp)), np.asarray(gx))


def _parity(jmod, tmod, x_nhwc, seed=1, float64=False):
    """Forward and the gradients of sum(out · w) for a random w in both
    packages, the JAX parameters (``jax_params``) bridged into ``tmod``;
    in fp32, or with ``float64`` in float64 in both packages (the JAX
    package under ``jax.enable_x64``) at F64_RTOL."""
    params = jax_params(jmod, x_nhwc)
    tmod.load_state_dict(from_flax_image_params(params))
    shape = jax.eval_shape(jmod.apply, params, x_nhwc).shape
    w = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    fwd_rtol, rtol = FWD_RTOL, GRAD_RTOL
    if float64:
        tmod.double()
        with jax.enable_x64(True):
            y, gp, gx = _grads(
                jmod, jax.tree.map(lambda a: np.asarray(a, np.float64),
                                   params),
                x_nhwc.astype(np.float64), w.astype(np.float64))
        fwd_rtol = rtol = F64_RTOL
    else:
        y, gp, gx = _grads(jmod, params, x_nhwc, w)
    dtype = next(tmod.parameters()).dtype
    xt = _nchw(x_nhwc).to(dtype).requires_grad_()
    yt = tmod(xt)
    _close(_nhwc(yt), y, fwd_rtol, "forward")
    (yt * _nchw(w).to(dtype)).sum().backward()
    grads = {n: p.grad for n, p in tmod.named_parameters()}
    assert set(grads) == set(gp)
    _close(_nhwc(xt.grad), gx, rtol, "input gradient")
    for name, g in grads.items():
        _close(g.numpy(), gp[name].numpy(), rtol, name)


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_upsample_align_corners():
    """The JAX test's ramp (endpoints kept, interior linear), and random
    inputs against the JAX function with their input gradients."""
    ramp = torch.arange(4.0).reshape(1, 1, 4, 1) * torch.ones(1, 1, 4, 3)
    out = T.upsample_align_corners(ramp, (7, 5))
    np.testing.assert_allclose(out[0, 0, 0], 0.0, atol=1e-6)
    np.testing.assert_allclose(out[0, 0, -1], 3.0, atol=1e-6)
    np.testing.assert_allclose(out[0, 0, :, 0], np.linspace(0, 3, 7),
                               atol=1e-6)
    for (h, w), (oh, ow) in (((4, 3), (7, 5)), ((5, 7), (10, 14))):
        x = _x((2, h, w, 3))
        ct = _x((2, oh, ow, 3), seed=1)
        ref, vjp = jax.vjp(lambda a: J.upsample_align_corners(a, (oh, ow)),
                           jnp.asarray(x))
        xt = _nchw(x).requires_grad_()
        out = T.upsample_align_corners(xt, (oh, ow))
        _close(_nhwc(out), ref, FWD_RTOL, "upsample")
        (out * _nchw(ct)).sum().backward()
        _close(_nhwc(xt.grad), vjp(jnp.asarray(ct))[0], GRAD_RTOL,
               "upsample gradient")


@pytest.mark.parametrize("block", [
    "BatchStatNorm", "DoubleConv", "SEBlock", "ResConvBlock",
    "ResConvBlock_skip", "SelfAttention2D", "SpectralConv2d",
    "SpectralConv2d_clipped"])
def test_block_parity(block):
    """Each building block, forward and input / parameter gradients."""
    shape = (2, 6, 10, 16)
    if block == "BatchStatNorm":
        jmod, tmod = J.BatchStatNorm(), T.BatchStatNorm(16)
    elif block == "DoubleConv":
        jmod, tmod = J.DoubleConv(12), T.DoubleConv(16, 12)
    elif block == "SEBlock":
        jmod, tmod = J.SEBlock(), T.SEBlock(16)
    elif block == "ResConvBlock":
        jmod, tmod = J.ResConvBlock(16), T.ResConvBlock(16, 16)
    elif block == "ResConvBlock_skip":
        # 12 features: GroupNorm takes 6 groups (8 does not divide 12).
        jmod, tmod = J.ResConvBlock(12), T.ResConvBlock(16, 12)
    elif block == "SelfAttention2D":
        jmod, tmod = J.SelfAttention2D(4), T.SelfAttention2D(16, 4)
    elif block == "SpectralConv2d":
        jmod, tmod = J.SpectralConv2d(8, 4, 4), T.SpectralConv2d(16, 8, 4,
                                                                4)
    else:
        # A 1 × 2 image: the modes clip to mh = 1, mw = 2 (W // 2 + 1).
        shape = (2, 1, 2, 16)
        jmod, tmod = J.SpectralConv2d(8, 4, 4), T.SpectralConv2d(16, 8, 4,
                                                                4)
    x = _x(shape) + 0.5
    if block == "SEBlock":
        assert tmod.fc1.out_features == 4      # max(16 // 8, 4)
    if block == "ResConvBlock_skip":
        assert tmod.gn_0.num_groups == 6 and tmod.skip is not None
    _parity(jmod, tmod, x)


@pytest.mark.parametrize("case", ["random", "reference"])
def test_extra_losses(case):
    """Value and gradient of both losses against the JAX package, and the
    JAX test's properties (tests/test_unet.py::test_extra_losses)."""
    rng = np.random.RandomState(0)
    if case == "reference":
        a = rng.randn(2, 16, 16, 3).astype(np.float32)
        at = torch.from_numpy(a)
        assert float(spectral_loss(at, at)) == 0.0
        assert float(gradient_loss(at, at)) == 0.0
        assert float(spectral_loss(at, 0 * at)) > 0.1
        smooth = torch.from_numpy(
            0.25 * (a + np.roll(a, 1, 1) + np.roll(a, 1, 2)
                    + np.roll(np.roll(a, 1, 1), 1, 2)))
        assert float(gradient_loss(at, smooth)) > float(
            gradient_loss(at, at + 1e-3))
        # The smoothed field keeps a's mean: the two spectra's DC amplitudes
        # tie up to rounding, where |pf - tf| has no derivative; its value
        # is compared, its gradient is not.
        pairs = [(a, smooth.numpy(), False), (a, 0 * a, True),
                 (a, 0.5 * a, True)]
    else:
        pairs = [(rng.randn(3, 2, 13, 21, 4).astype(np.float32),
                  rng.randn(3, 2, 13, 21, 4).astype(np.float32), True)]
    for p, t, grad in pairs:
        for tfn, jfn in ((spectral_loss, j_spectral_loss),
                         (gradient_loss, j_gradient_loss)):
            ref, g_ref = jax.value_and_grad(jfn)(jnp.asarray(p),
                                                 jnp.asarray(t))
            pt = torch.from_numpy(p).requires_grad_()
            val = tfn(pt, torch.from_numpy(t))
            val.backward()
            _close(val.item(), float(ref), FWD_RTOL, tfn.__name__)
            if grad:
                _close(pt.grad.numpy(), g_ref, GRAD_RTOL,
                       f"{tfn.__name__} gradient")


MODELS = {
    "v1": (lambda: J.WeatherUNet(5, 8), lambda: T.WeatherUNet(12, 5, 8)),
    "v2": (lambda: J.WeatherUNetV2(5, 8),
           lambda: T.WeatherUNetV2(12, 5, 8)),
    "downscaler": (lambda: J.DownscalerUNet(5, 8),
                   lambda: T.DownscalerUNet(12, 5, 8)),
}


@pytest.mark.parametrize("hw", [(24, 16), (13, 21)], ids=["24x16", "13x21"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_unet_parity(name, hw):
    """Whole models at base 8, forward and every parameter's gradient;
    13 × 21 pools to 6 × 10, 3 × 5 and 1 × 2 and pads the upsampled
    tensors at the bottom and right."""
    jc, tc = MODELS[name]
    _parity(jc(), tc(), _x((1,) + hw + (12,)),
            float64=hw == (13, 21))


def test_grid_adapter_and_bridge():
    """``GridImageModel`` maps [G, obs·C] (lat-major) to the image and back
    as the JAX adapter does, and a whole adapter tree (``image_module``
    over a U-Net) goes through ``from_flax_params``; the three models'
    parameter counts at the reference's widths."""
    from graphcast_lite_tpu.models.grid_adapter import GridImageModel as JG

    n_lat, n_lon, c = 13, 21, 5
    jm = JG(image_module=J.WeatherUNetV2(c, 8), n_lat=n_lat, n_lon=n_lon)
    x = _x((n_lat * n_lon, 2 * c))
    params = jax_params(jm, x)
    ref, _ = jax.jit(jm.apply)(params, x)
    tm = GridImageModel(T.WeatherUNetV2(2 * c, c, 8), n_lat, n_lon)
    tm.load_state_dict(from_flax_params(params))
    assert tm.num_grid_nodes == n_lat * n_lon
    mask = torch.ones(3)
    out, m = tm(torch.from_numpy(x), None, mask)
    assert m is mask
    _close(out.detach().numpy(), ref, FWD_RTOL, "GridImageModel")
    counts = [sum(p.numel() for p in m.parameters()) for m in (
        T.WeatherUNet(92, 23, 64), T.WeatherUNetV2(92, 23, 64, 4, 4),
        T.DownscalerUNet(23, 23, 48))]
    assert counts == [7_838_423, 25_493_575, 4_390_583]


def test_init_weights_from_a_generator():
    """``init_weights`` draws flax's initial values from the generator:
    the same seed gives the same weights, norms start at 1 and 0, biases
    at 0, conv kernels with LeCun's variance (1 / fan_in)."""
    a = T.WeatherUNetV2(12, 5, 8, generator=torch.Generator().manual_seed(4))
    b = T.WeatherUNetV2(12, 5, 8, generator=torch.Generator().manual_seed(4))
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), n
    assert torch.equal(a.inc.gn_0.weight, torch.ones(8))
    assert not a.out_conv.bias.any() and not a.inc.se.fc1.bias.any()
    w = a.down3.conv_0.weight                        # fan_in 9 · 32
    assert abs(w.var().item() * 9 * 32 - 1) < 0.05
    assert w.abs().max() <= 2 / 0.87962566103423978 / (9 * 32) ** 0.5
