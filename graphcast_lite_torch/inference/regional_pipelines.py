"""Regional composition pipelines: cascade, boundary blending, regridding
(a NumPy copy of ``graphcast_lite_tpu.inference.regional_pipelines``; the
U-Net of ``cascade_refine`` is any callable, e.g. a port
``DownscalerUNet`` on the card through ``unet_apply_nhwc``).

Covers the reference's regional inference scripts:

  * ``cascade_refine``    ~ scripts/predict_cascade.py: global GNN AR
      forecast → crop the ROI → bilinear upsample to the fine grid →
      U-Net refinement (delta added to the upsampled field).
  * ``blend_with_background`` ~ scripts/predict_pipeline.py:95-150: a
      regional forecast stitched over an interpolated global background
      with a 2-D Hann taper at the borders.
  * ``interpolate_to_region`` ~ scripts/interpolate_to_region.py: put a
      saved global forecast onto a regional grid for comparison.

All functions operate on node-flattened, lat-major arrays (the framework's
canonical layout) plus grid-axis metadata.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..assimilation.nudging import cosine_taper_2d
from ..build import resolve_device
from ..data.etl import _bilinear_to_points

__all__ = [
    "crop_region",
    "interpolate_to_region",
    "blend_with_background",
    "cascade_refine",
    "unet_apply_nhwc",
]


def crop_region(
    field_flat: np.ndarray,        # [G, ...] lat-major over (lats, lons)
    lats: np.ndarray,
    lons: np.ndarray,
    roi: Tuple[float, float, float, float],
):
    """Crop a flat global field to the ROI sub-grid.

    Returns (cropped [n_lat_r, n_lon_r, ...], roi_lats, roi_lons)."""
    lat_min, lat_max, lon_min, lon_max = roi
    li = np.flatnonzero((lats >= lat_min) & (lats <= lat_max))
    lo = np.flatnonzero((lons >= lon_min) & (lons <= lon_max))
    grid = field_flat.reshape(len(lats), len(lons), *field_flat.shape[1:])
    return grid[np.ix_(li, lo)], lats[li], lons[lo]


def interpolate_to_region(
    field_flat: np.ndarray,        # [G, C] global, lat-major
    src_lats: np.ndarray,
    src_lons: np.ndarray,
    dst_lats: np.ndarray,          # regional axes
    dst_lons: np.ndarray,
) -> np.ndarray:
    """Bilinear regrid of a flat global field onto a regional regular grid.
    Returns [n_lat_d, n_lon_d, C]."""
    c = field_flat.shape[-1]
    grid = field_flat.reshape(len(src_lats), len(src_lons), c)
    dlon2, dlat2 = np.meshgrid(dst_lons, dst_lats)
    out = np.stack(
        [
            _bilinear_to_points(grid[:, :, k], src_lats, src_lons,
                                dlat2.reshape(-1), dlon2.reshape(-1))
            for k in range(c)
        ],
        axis=-1,
    )
    return out.reshape(len(dst_lats), len(dst_lons), c)


def blend_with_background(
    regional: np.ndarray,          # [n_lat, n_lon, C]
    background: np.ndarray,        # [n_lat, n_lon, C]
    border: int,
) -> np.ndarray:
    """taper·regional + (1−taper)·background with a 2-D Hann border taper."""
    taper = cosine_taper_2d(regional.shape[0], regional.shape[1], border)
    return taper[..., None] * regional + (1 - taper[..., None]) * background


def cascade_refine(
    unet_apply,
    global_pred_flat: np.ndarray,  # [G, C] normalized, lat-major
    src_lats: np.ndarray,
    src_lons: np.ndarray,
    fine_lats: np.ndarray,
    fine_lons: np.ndarray,
    roi: Optional[Tuple[float, float, float, float]] = None,
) -> np.ndarray:
    """Global forecast → (crop) → bilinear upsample → U-Net delta.

    ``unet_apply(x [1, H, W, C]) -> [1, H, W, C]`` is the trained
    downscaler (e.g. a bound ``DownscalerUNet.apply``).  Returns the refined
    fine-grid field [n_lat_f, n_lon_f, C]."""
    if roi is not None:
        cropped, src_lats, src_lons = crop_region(
            global_pred_flat, src_lats, src_lons, roi
        )
        flat = cropped.reshape(-1, cropped.shape[-1])
    else:
        flat = global_pred_flat
    up = interpolate_to_region(flat, src_lats, src_lons, fine_lats, fine_lons)
    delta = np.asarray(unet_apply(up[None].astype(np.float32)))[0]
    return up + delta


def unet_apply_nhwc(
    module: torch.nn.Module,
    device: Union[str, torch.device, None] = None,
):
    """An NCHW image module (a port ``DownscalerUNet``) as the NHWC NumPy
    callable ``cascade_refine`` takes: ``x [B, H, W, C]`` float32 in,
    ``[B, H, W, C]`` float32 out, applied in fp32 on ``device`` (default
    ``cuda``; the module is moved there)."""
    dev = resolve_device(device)
    module = module.to(dev).eval()

    def apply(x: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            t = torch.as_tensor(np.asarray(x, np.float32), device=dev)
            out = module(t.permute(0, 3, 1, 2).contiguous())
            return out.permute(0, 2, 3, 1).float().cpu().numpy()

    return apply
