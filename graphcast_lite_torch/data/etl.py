"""Offline dataset ETL: scaler recomputation, derived channels, repairs,
multires / downscaler dataset assembly (a framework-free copy of
``graphcast_lite_tpu.data.etl``: NumPy only; the files it writes are
byte-equal to the JAX package's).

Covers the reference's offline builder scripts that operate on LOCAL data
(reference ``scripts/``):

  * ``recompute_scalers``   ~ recompute_wb2_scalers.py (Welford streaming)
  * ``add_time_features``   ~ add_time_features.py (sin/cos hour + day-of-
                              year forcing channels appended)
  * ``repair_dataset``      ~ repair_dataset.py (rescale channels whose
                              physical range overflows float16, e.g. msl/sp
                              in Pa)
  * ``build_multires_dataset`` ~ build_multires_dataset.py (flat grid:
                              coarse global nodes outside the ROI + fine
                              regional nodes inside; 'interpolate' mode
                              fills fine nodes from the coarse field for
                              training, 'merge' uses real fine data)
  * ``build_downscaler_dataset`` ~ build_downscaler_dataset.py (coarse
                              fields bilinearly upsampled to the fine grid,
                              paired with fine truth)

Network-dependent acquisition (WB2/ARCO zarr, CDS API, ERA5 download) is
the JAX package's ``data.remote`` and is not part of this package yet.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence, Tuple

import numpy as np

from .dataset import ChunkedTimeseriesDataset

__all__ = [
    "welford_scalers",
    "recompute_scalers",
    "add_time_features",
    "repair_dataset",
    "build_multires_dataset",
    "build_downscaler_dataset",
]


def _open_raw(data_dir: str):
    with open(os.path.join(data_dir, "dataset_info.json")) as f:
        info = json.load(f)
    if info.get("flat", False):
        shape = (info["n_time"], info["n_nodes"], info["n_feat"])
    else:
        shape = (info["n_time"], info["n_lon"], info["n_lat"], info["n_feat"])
    mm = np.memmap(os.path.join(data_dir, "data.npy"), dtype=np.float16,
                   mode="r", shape=shape)
    return mm, info


def welford_scalers(
    mm: np.ndarray, chunk: int = 16
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Streaming per-channel mean/std over a (T, ..., C) memmap (Welford /
    Chan parallel combination; never materializes the dataset)."""
    c = mm.shape[-1]
    n = 0
    mean = np.zeros(c, np.float64)
    m2 = np.zeros(c, np.float64)
    for t0 in range(0, mm.shape[0], chunk):
        block = np.asarray(mm[t0 : t0 + chunk], np.float64).reshape(-1, c)
        bn = block.shape[0]
        bmean = block.mean(0)
        bm2 = ((block - bmean) ** 2).sum(0)
        if n == 0:
            mean, m2, n = bmean, bm2, bn
        else:
            delta = bmean - mean
            tot = n + bn
            mean = mean + delta * bn / tot
            m2 = m2 + bm2 + delta**2 * n * bn / tot
            n = tot
    std = np.sqrt(m2 / max(n, 1))
    std = np.where(std < 1e-8, 1.0, std)
    return mean.astype(np.float32), std.astype(np.float32), n


def recompute_scalers(data_dir: str) -> Tuple[np.ndarray, np.ndarray]:
    """Recompute and rewrite scalers.npz from the raw memmap."""
    mm, _ = _open_raw(data_dir)
    mean, std, n = welford_scalers(mm)
    np.savez(os.path.join(data_dir, "scalers.npz"), mean=mean, std=std,
             n=np.array(n))
    return mean, std


def add_time_features(
    data_dir: str,
    out_dir: str,
    start_hour: int = 0,
    step_hours: int = 6,
) -> str:
    """Append 4 forcing channels (sin/cos hour-of-day, sin/cos day-of-year)
    and write a new dataset directory."""
    mm, info = _open_raw(data_dir)
    os.makedirs(out_dir, exist_ok=True)
    t_axis = np.arange(info["n_time"]) * step_hours + start_hour
    hour = (t_axis % 24) / 24.0
    doy = ((t_axis / 24.0) % 365.25) / 365.25
    feats = np.stack([
        np.sin(2 * np.pi * hour), np.cos(2 * np.pi * hour),
        np.sin(2 * np.pi * doy), np.cos(2 * np.pi * doy),
    ], axis=-1).astype(np.float16)  # [T, 4]

    spatial_shape = mm.shape[1:-1]
    new_c = info["n_feat"] + 4
    out_shape = mm.shape[:-1] + (new_c,)
    out = np.memmap(os.path.join(out_dir, "data.npy"), dtype=np.float16,
                    mode="w+", shape=out_shape)
    for t in range(info["n_time"]):
        out[t, ..., : info["n_feat"]] = mm[t]
        out[t, ..., info["n_feat"]:] = np.broadcast_to(
            feats[t], spatial_shape + (4,)
        )
    out.flush()

    info2 = dict(info, n_feat=new_c)
    with open(os.path.join(out_dir, "dataset_info.json"), "w") as f:
        json.dump(info2, f)
    for name in ("coords.npz",):
        src = os.path.join(data_dir, name)
        if os.path.exists(src):
            import shutil

            shutil.copy(src, os.path.join(out_dir, name))
    var_file = os.path.join(data_dir, "variables.json")
    variables = (json.load(open(var_file)) if os.path.exists(var_file)
                 else [f"var_{i}" for i in range(info["n_feat"])])
    variables += ["sin_hour", "cos_hour", "sin_doy", "cos_doy"]
    with open(os.path.join(out_dir, "variables.json"), "w") as f:
        json.dump(variables, f)
    # Extend scalers: time features are already in [-1, 1].
    scl = np.load(os.path.join(data_dir, "scalers.npz"))
    np.savez(
        os.path.join(out_dir, "scalers.npz"),
        mean=np.concatenate([scl["mean"], np.zeros(4, np.float32)]),
        std=np.concatenate([scl["std"], np.ones(4, np.float32)]),
    )
    return out_dir


def repair_dataset(
    data_dir: str,
    channel_scales: dict,
) -> None:
    """Rescale channels in place (float16 range repair, e.g. Pa -> hPa:
    {"msl": 0.01}).  Updates data.npy and scalers.npz consistently."""
    mm, info = _open_raw(data_dir)
    with open(os.path.join(data_dir, "variables.json")) as f:
        variables = json.load(f)
    out = np.memmap(os.path.join(data_dir, "data.npy"), dtype=np.float16,
                    mode="r+", shape=mm.shape)
    scl = np.load(os.path.join(data_dir, "scalers.npz"))
    mean, std = scl["mean"].copy(), scl["std"].copy()
    for name, scale in channel_scales.items():
        if name not in variables:
            continue
        ci = variables.index(name)
        for t in range(info["n_time"]):
            out[t, ..., ci] = (
                np.asarray(out[t, ..., ci], np.float32) * scale
            ).astype(np.float16)
        mean[ci] *= scale
        std[ci] *= scale
    out.flush()
    np.savez(os.path.join(data_dir, "scalers.npz"), mean=mean, std=std)


def _bilinear_to_points(
    field: np.ndarray,          # [n_lat, n_lon]
    src_lats: np.ndarray,
    src_lons: np.ndarray,
    dst_lats: np.ndarray,       # per-node [N]
    dst_lons: np.ndarray,
) -> np.ndarray:
    """Bilinear interpolation of a regular-grid field to scattered points
    (clamped at the grid edges; longitudes assumed within range)."""
    li = np.interp(dst_lats, src_lats, np.arange(len(src_lats)))
    lo = np.interp(dst_lons, src_lons, np.arange(len(src_lons)))
    i0 = np.clip(np.floor(li).astype(int), 0, len(src_lats) - 2)
    j0 = np.clip(np.floor(lo).astype(int), 0, len(src_lons) - 2)
    fi, fj = li - i0, lo - j0
    return (
        field[i0, j0] * (1 - fi) * (1 - fj)
        + field[i0 + 1, j0] * fi * (1 - fj)
        + field[i0, j0 + 1] * (1 - fi) * fj
        + field[i0 + 1, j0 + 1] * fi * fj
    )


def build_multires_dataset(
    coarse_dir: str,
    fine_dir: str,
    out_dir: str,
    roi: Tuple[float, float, float, float],
    mode: str = "interpolate",
) -> str:
    """Flat multires dataset: coarse global nodes OUTSIDE the ROI + fine
    regional nodes INSIDE it.

    mode='interpolate': fine-node values interpolated from the coarse field
      (training data — the model learns on a consistent resolution);
    mode='merge': real fine data at fine nodes (evaluation).
    Emits data.npy (T, N, C) + paired coords with is_regional mask.
    """
    cm, cinfo = _open_raw(coarse_dir)
    fm, finfo = _open_raw(fine_dir)
    assert not cinfo.get("flat") and not finfo.get("flat")
    cc = np.load(os.path.join(coarse_dir, "coords.npz"))
    fc = np.load(os.path.join(fine_dir, "coords.npz"))
    clats, clons = cc["latitude"], cc["longitude"]
    flats, flons = fc["latitude"], fc["longitude"]
    lat_min, lat_max, lon_min, lon_max = roi

    clon2, clat2 = np.meshgrid(clons, clats)
    coarse_nodes_lat = clat2.reshape(-1)
    coarse_nodes_lon = clon2.reshape(-1)
    outside = ~(
        (coarse_nodes_lat >= lat_min) & (coarse_nodes_lat <= lat_max)
        & (coarse_nodes_lon >= lon_min) & (coarse_nodes_lon <= lon_max)
    )
    flon2, flat2 = np.meshgrid(flons, flats)
    fine_nodes_lat = flat2.reshape(-1)
    fine_nodes_lon = flon2.reshape(-1)

    n_time = min(cinfo["n_time"], finfo["n_time"])
    c = min(cinfo["n_feat"], finfo["n_feat"])
    n_coarse = int(outside.sum())
    n_fine = len(fine_nodes_lat)
    n_nodes = n_coarse + n_fine

    out = np.memmap(_prep(out_dir), dtype=np.float16, mode="w+",
                    shape=(n_time, n_nodes, c))
    for t in range(n_time):
        # (lon, lat) -> (lat, lon) layout for interpolation convenience.
        cf = np.asarray(cm[t, :, :, :c], np.float32).transpose(1, 0, 2)
        coarse_flat = cf.reshape(-1, c)[outside]
        if mode == "interpolate":
            fine_vals = np.stack([
                _bilinear_to_points(cf[:, :, k], clats, clons,
                                    fine_nodes_lat, fine_nodes_lon)
                for k in range(c)
            ], axis=-1)
        else:
            ff = np.asarray(fm[t, :, :, :c], np.float32).transpose(1, 0, 2)
            fine_vals = ff.reshape(-1, c)
        out[t, :n_coarse] = coarse_flat.astype(np.float16)
        out[t, n_coarse:] = fine_vals.astype(np.float16)
    out.flush()

    with open(os.path.join(out_dir, "dataset_info.json"), "w") as f:
        json.dump({"n_time": n_time, "n_feat": c, "flat": True,
                   "n_nodes": n_nodes}, f)
    np.savez(
        os.path.join(out_dir, "coords.npz"),
        latitude=np.concatenate([coarse_nodes_lat[outside], fine_nodes_lat])
        .astype(np.float32),
        longitude=np.concatenate([coarse_nodes_lon[outside], fine_nodes_lon])
        .astype(np.float32),
        is_regional=np.concatenate([
            np.zeros(n_coarse, bool), np.ones(n_fine, bool)
        ]),
    )
    import shutil

    shutil.copy(os.path.join(coarse_dir, "scalers.npz"),
                os.path.join(out_dir, "scalers.npz"))
    var_file = os.path.join(coarse_dir, "variables.json")
    if os.path.exists(var_file):
        shutil.copy(var_file, os.path.join(out_dir, "variables.json"))
    return out_dir


def _prep(out_dir: str) -> str:
    os.makedirs(out_dir, exist_ok=True)
    return os.path.join(out_dir, "data.npy")


def build_downscaler_dataset(
    coarse_dir: str,
    fine_dir: str,
    out_dir: str,
    static_channels: Sequence[int] = (),
) -> str:
    """Coarse→fine training pairs: coarse fields bilinearly upsampled to the
    fine grid (inputs) + fine truth (targets), stored as
    X_coarse.npy/Y_fine.npy float16 [T, n_lat_f, n_lon_f, C] with the fine
    grid's coords/scalers."""
    cm, cinfo = _open_raw(coarse_dir)
    fm, finfo = _open_raw(fine_dir)
    cc = np.load(os.path.join(coarse_dir, "coords.npz"))
    fc = np.load(os.path.join(fine_dir, "coords.npz"))
    clats, clons = cc["latitude"], cc["longitude"]
    flats, flons = fc["latitude"], fc["longitude"]
    flon2, flat2 = np.meshgrid(flons, flats)

    os.makedirs(out_dir, exist_ok=True)
    n_time = min(cinfo["n_time"], finfo["n_time"])
    c = min(cinfo["n_feat"], finfo["n_feat"])
    h, w = len(flats), len(flons)
    x_out = np.memmap(os.path.join(out_dir, "X_coarse.npy"), np.float16,
                      "w+", shape=(n_time, h, w, c))
    y_out = np.memmap(os.path.join(out_dir, "Y_fine.npy"), np.float16,
                      "w+", shape=(n_time, h, w, c))
    for t in range(n_time):
        cf = np.asarray(cm[t, :, :, :c], np.float32).transpose(1, 0, 2)
        up = np.stack([
            _bilinear_to_points(cf[:, :, k], clats, clons,
                                flat2.reshape(-1), flon2.reshape(-1))
            .reshape(h, w)
            for k in range(c)
        ], axis=-1)
        x_out[t] = up.astype(np.float16)
        y_out[t] = np.asarray(fm[t, :, :, :c], np.float32).transpose(1, 0, 2)
    x_out.flush()
    y_out.flush()
    with open(os.path.join(out_dir, "dataset_info.json"), "w") as f:
        json.dump({"n_time": n_time, "n_lat": h, "n_lon": w, "n_feat": c,
                   "static_channels": list(static_channels)}, f)
    import shutil

    shutil.copy(os.path.join(fine_dir, "scalers.npz"),
                os.path.join(out_dir, "scalers.npz"))
    np.savez(os.path.join(out_dir, "coords.npz"), latitude=flats,
             longitude=flons)
    return out_dir
