"""Loss machinery: latitude weighting, masks, weighted MSE, ACC (torch
counterpart of ``graphcast_lite_tpu.training.loss``).

The mask builders are NumPy, as in the JAX package.  Like the JAX package,
the latitude weights (and the boundary mask) are laid out in the data's
lat-major node order.  ``spectral_loss`` and ``gradient_loss`` (the
sharpness terms of the CNN trainers) take images ``[..., H, W, C]``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

__all__ = [
    "lat_weights_from_axis",
    "lat_weights_from_nodes",
    "boundary_mask",
    "channel_mask",
    "combine_spatial_masks",
    "weighted_mse",
    "weighted_sums",
    "anomaly_correlation",
    "spectral_loss",
    "gradient_loss",
    "image_extra_loss",
]


def lat_weights_from_axis(num_lat: int, num_lon: int) -> np.ndarray:
    """cos-lat weights, normalized to mean 1, expanded lat-major -> [G]
    (linspace(-90, 90) over the latitude axis)."""
    lats = np.linspace(-90.0, 90.0, num_lat)
    w = np.cos(np.deg2rad(lats))
    w = w / w.mean()
    return np.repeat(w, num_lon).astype(np.float32)  # lat-major


def lat_weights_from_nodes(node_lats: np.ndarray) -> np.ndarray:
    """Per-node cos-lat weights for flat (multires) grids -> [G]."""
    w = np.cos(np.deg2rad(node_lats.astype(np.float64)))
    w = w / w.mean()
    return w.astype(np.float32)


def boundary_mask(num_lat: int, num_lon: int, width: int) -> np.ndarray:
    """[G] float mask, 0 inside a `width`-point frame at the region edges,
    1 in the interior.  Lat-major layout."""
    m = np.zeros((num_lat, num_lon), dtype=np.float32)
    if width <= 0:
        return np.ones(num_lat * num_lon, dtype=np.float32)
    m[width: num_lat - width, width: num_lon - width] = 1.0
    return m.reshape(-1)


def channel_mask(
    num_channels: int,
    static_channels: Sequence[int] = (),
    forcing_channels: Sequence[int] = (),
) -> Optional[np.ndarray]:
    """[C] float mask with 0 on static+forcing channels; None if all live."""
    excluded = sorted(set(static_channels) | set(forcing_channels))
    if not excluded:
        return None
    cm = np.ones(num_channels, dtype=np.float32)
    for ch in excluded:
        if 0 <= ch < num_channels:
            cm[ch] = 0.0
    return cm


def combine_spatial_masks(*masks: Optional[np.ndarray]) -> Optional[np.ndarray]:
    out = None
    for m in masks:
        if m is None:
            continue
        out = m if out is None else out * m
    return out


def weighted_sums(
    pred: torch.Tensor,
    target: torch.Tensor,
    lat_weights: Optional[torch.Tensor] = None,
    chan_mask: Optional[torch.Tensor] = None,
    spatial_mask: Optional[torch.Tensor] = None,
):
    """(Σ w·(p−t)², Σ w): ``weighted_mse``'s numerator and denominator, so
    that a batch split over ranks can sum them before dividing."""
    diff = torch.square(pred - target)
    weights = torch.ones_like(diff)
    if chan_mask is not None:
        weights = weights * chan_mask
    if spatial_mask is not None:
        weights = weights * spatial_mask[..., :, None]
    if lat_weights is not None:
        weights = weights * lat_weights[..., :, None]
    return (diff * weights).sum(), weights.sum()


def weighted_mse(
    pred: torch.Tensor,
    target: torch.Tensor,
    lat_weights: Optional[torch.Tensor] = None,
    chan_mask: Optional[torch.Tensor] = None,
    spatial_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Σ w·(p−t)² / Σ w with w = lat ⊗ spatial ⊗ channel (broadcast over any
    leading batch axes).  pred/target: [..., G, C].

    As in the JAX package, the weights start as ones in the prediction's
    dtype, so without masks the sums are in that dtype (bf16 under mixed
    precision); an fp32 mask promotes them to fp32."""
    num, den = weighted_sums(pred, target, lat_weights, chan_mask,
                             spatial_mask)
    return num / torch.clamp(den, min=1e-12)


def spectral_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """L1 distance between the 2-D FFT amplitude spectra (ortho ``rfft2``
    over H, W).  pred/target: [..., H, W, C].  Penalizes the blurring
    (missing small-scale energy) that plain MSE ignores."""
    pf = torch.fft.rfft2(pred, dim=(-3, -2), norm="ortho").abs()
    tf = torch.fft.rfft2(target, dim=(-3, -2), norm="ortho").abs()
    return torch.mean(torch.abs(pf - tf))


_SOBEL_X = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))


def _sobel(x: torch.Tensor):
    """Per-channel Sobel cross-correlations, zero "SAME" padding:
    [..., H, W, C] -> (gx, gy), each [N·C, 1, H, W]."""
    h, w = x.shape[-3], x.shape[-2]
    xc = x.reshape((-1, h, w, x.shape[-1])).permute(0, 3, 1, 2)
    xc = xc.reshape(-1, 1, h, w)
    kx = torch.tensor(_SOBEL_X, dtype=x.dtype, device=x.device)
    k = torch.stack([kx, kx.T])[:, None]              # [2, 1, 3, 3]
    g = torch.nn.functional.conv2d(xc, k, padding=1)
    return g[:, :1], g[:, 1:]


def gradient_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """L1 distance between Sobel spatial gradients (a sharpness prior).
    pred/target: [..., H, W, C]."""
    pgx, pgy = _sobel(pred)
    tgx, tgy = _sobel(target)
    return torch.mean(torch.abs(pgx - tgx)) + torch.mean(torch.abs(pgy - tgy))


def image_extra_loss(n_lat: int, n_lon: int, c: int, spectral_weight: float,
                     gradient_weight: float):
    """``extra_loss_fn(out [..., G, C], target)`` of the CNN trainers: the
    weighted spectral and Sobel losses on the [..., H, W, C] images; None
    when both weights are 0."""
    if spectral_weight <= 0 and gradient_weight <= 0:
        return None

    def extra(out, target):
        img_o = out.reshape(out.shape[:-2] + (n_lat, n_lon, c))
        img_t = target.reshape(target.shape[:-2] + (n_lat, n_lon, c))
        loss = 0.0
        if spectral_weight > 0:
            loss = loss + spectral_weight * spectral_loss(img_o, img_t)
        if gradient_weight > 0:
            loss = loss + gradient_weight * gradient_loss(img_o, img_t)
        return loss

    return extra


def anomaly_correlation(
    pred: torch.Tensor,
    target: torch.Tensor,
    exclude_channels: Sequence[int] = (),
) -> torch.Tensor:
    """Spatial anomaly correlation coefficient, per feature then averaged
    over live channels (and any leading batch axes).  pred/target:
    [..., G, C]; the standard deviations are the population ones, as
    ``jnp.std``'s."""
    p = pred - pred.mean(dim=-2, keepdim=True)
    t = target - target.mean(dim=-2, keepdim=True)
    p = p / (pred.std(dim=-2, keepdim=True, correction=0) + 1e-8)
    t = t / (target.std(dim=-2, keepdim=True, correction=0) + 1e-8)
    acc_pf = (p * t).mean(dim=-2)  # [..., C]
    if exclude_channels:
        c = pred.shape[-1]
        keep = [i for i in range(c) if i not in set(exclude_channels)]
        acc_pf = acc_pf[..., keep]
    return acc_pf.mean()
