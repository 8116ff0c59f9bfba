"""The CNN stacks' batched forward on the CPU: ``GridImageModel`` over
U-Net V1, V2 and the downscaler with a batch [B, G, obs·C] in one call,
against ``jax.vmap`` of the JAX package's single-sample ``GridImageModel``
(weights from a numpy seed in the JAX tree, ``torch_port_common.
jax_params``, bridged by ``from_flax_params``), at B = 3 on a 24 × 16 grid,
base 8, fp32: max|port − jax| <= 1e-5 max|jax|, the single-image
tolerance of ``test_torch_port_unet.py``.

``BatchStatNorm`` (V1 and the downscaler) takes each sample's own (H, W)
statistics in the batched model, as each vmapped call sees one image:
perturbing sample 1 leaves samples 0 and 2 bitwise unchanged.  A U-Net
called directly on N > 1 images keeps the pooled (N, H, W) statistics of
the JAX module.
"""

import jax
import numpy as np
import pytest
import torch

from graphcast_lite_tpu.models import unet as J
from graphcast_lite_tpu.models.grid_adapter import GridImageModel as JG
from graphcast_lite_torch.models import unet as T
from graphcast_lite_torch.models.grid_adapter import GridImageModel
from graphcast_lite_torch.utils.params import from_flax_params
from torch_port_common import jax_params, \
    one_torch_thread  # noqa: F401 (an autouse fixture)

B, N_LAT, N_LON, C, BASE = 3, 24, 16, 5, 8
FWD_RTOL = 1e-5
MODELS = {
    "v1": (lambda: J.WeatherUNet(C, BASE),
           lambda: T.WeatherUNet(2 * C, C, BASE)),
    "v2": (lambda: J.WeatherUNetV2(C, BASE),
           lambda: T.WeatherUNetV2(2 * C, C, BASE)),
    "downscaler": (lambda: J.DownscalerUNet(C, BASE),
                   lambda: T.DownscalerUNet(2 * C, C, BASE)),
}


def _pair(name):
    jc, tc = MODELS[name]
    jm = JG(image_module=jc(), n_lat=N_LAT, n_lon=N_LON)
    x = np.random.RandomState(5).randn(B, N_LAT * N_LON, 2 * C) \
        .astype(np.float32)
    params = jax_params(jm, x[0])
    tm = GridImageModel(tc(), N_LAT, N_LON)
    tm.load_state_dict(from_flax_params(params))
    return jm, params, tm, x


def _close(out, ref, label):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (label, out.shape, ref.shape)
    err, tol = np.abs(out - ref).max(), FWD_RTOL * np.abs(ref).max()
    assert err <= tol, f"{label}: {err:.3e} > {tol:.3e}"


@pytest.mark.parametrize("name", sorted(MODELS))
def test_grid_image_model_batched_against_vmap(name):
    jm, params, tm, x = _pair(name)
    ref = jax.jit(jax.vmap(lambda s: jm.apply(params, s)[0]))(x)
    mask = torch.ones(4)
    with torch.no_grad():
        out, m = tm(torch.from_numpy(x), None, mask)
    assert m is mask
    _close(out.numpy(), ref, name)
    if name != "v1":
        return
    # Per-sample BatchStatNorm: sample 1 moved, the others stay.
    x2 = x.copy()
    x2[1] = 3.0 * x2[1] + 1.0
    with torch.no_grad():
        out2, _ = tm(torch.from_numpy(x2), None)
    assert torch.equal(out2[0], out[0]) and torch.equal(out2[2], out[2])
    assert not torch.equal(out2[1], out[1])


def test_direct_unet_keeps_pooled_statistics():
    """The U-Net itself on [N, C, H, W], N = 3: BatchStatNorm's statistics
    over (N, H, W), as the JAX module takes them over its whole input."""
    jm, params, tm, x = _pair("v1")
    imgs = x.reshape(B, N_LAT, N_LON, 2 * C)
    ref = jax.jit(lambda im: jm.image_module.apply(
        {"params": params["params"]["image_module"]}, im))(imgs)
    with torch.no_grad():
        out = tm.image_module(torch.from_numpy(
            np.ascontiguousarray(imgs.transpose(0, 3, 1, 2))))
    _close(out.numpy().transpose(0, 2, 3, 1), ref, "pooled")
