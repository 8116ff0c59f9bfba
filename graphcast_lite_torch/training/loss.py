"""Loss machinery: latitude weighting, masks, weighted MSE, ACC (torch
counterpart of ``graphcast_lite_tpu.training.loss``).

The mask builders are NumPy, as in the JAX package.  Like the JAX package,
the latitude weights (and the boundary mask) are laid out in the data's
lat-major node order.  ``spectral_loss`` and ``gradient_loss`` serve the
CNN stacks and come with them (ROADMAP A10).
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
    "anomaly_correlation",
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
    diff = torch.square(pred - target)
    weights = torch.ones_like(diff)
    if chan_mask is not None:
        weights = weights * chan_mask
    if spatial_mask is not None:
        weights = weights * spatial_mask[..., :, None]
    if lat_weights is not None:
        weights = weights * lat_weights[..., :, None]
    return (diff * weights).sum() / torch.clamp(weights.sum(), min=1e-12)


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
