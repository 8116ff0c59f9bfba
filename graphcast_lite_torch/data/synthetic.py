"""Synthetic dataset generation in the exact on-disk chunked format.

Serves the role of the reference's demo sample-data scripts
(reference ``experiments/demo/download_sample_data.py``) without network
access: smooth advecting spherical-harmonic-ish fields with realistic
channel structure (prognostic + static + forcing channels), written as a
float16 memmap + scalers + coords + variables.json so the full data pipeline
(windows, normalization, splits) is exercised end-to-end in tests and demos.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np

__all__ = ["generate_synthetic_dataset"]


def generate_synthetic_dataset(
    out_dir: str,
    n_time: int = 40,
    n_lon: int = 64,
    n_lat: int = 32,
    n_feat: int = 6,
    static_channels: Optional[List[int]] = None,
    forcing_channels: Optional[List[int]] = None,
    seed: int = 0,
    flat: bool = False,
    regime_drift_m_per_step: float = 0.0,
    drift_t2m_channel: int = 0,
    drift_zsurf_channel: Optional[int] = None,
    drift_start_frac: float = 0.8,
) -> str:
    """Write a synthetic chunked dataset; returns ``out_dir``.

    Dynamics: each prognostic channel is a sum of rotating large-scale waves
    (deterministically advected, so a model can actually learn the step
    transition).  Static channels are time-constant fields; forcing channels
    are global sinusoids of time (known in advance, like hour-of-day).

    ``regime_drift_m_per_step`` plants a REGIME SHIFT in the test period
    (frames >= drift_start_frac·n_time): a smooth spatial pattern of
    "surface elevation" change accrues each step, with the t2m channel
    cooling by the standard-atmosphere lapse rate (6.5 K/km) times that
    change, and (when ``drift_zsurf_channel`` is set) the z_surf channel
    carrying the geopotential of the drifted elevation.  A model trained on
    the stationary period systematically misses the per-step increment, so
    the MOS / IDW / lapse post-processing rungs have real structure to
    correct — the fixture behind tests/test_pipeline_ladder.py's
    Δskill > 0 assertions (the reference's rungs are validated on real
    station data; this is the synthetic equivalent with a known answer).
    """
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    static_channels = static_channels or []
    forcing_channels = forcing_channels or []

    lats = np.linspace(-90 + 90.0 / n_lat, 90 - 90.0 / n_lat, n_lat).astype(
        np.float32
    )
    lons = np.arange(0, 360, 360.0 / n_lon).astype(np.float32)
    lon2d, lat2d = np.meshgrid(np.deg2rad(lons), np.deg2rad(lats))  # [lat, lon]

    fields = np.zeros((n_time, n_lon, n_lat, n_feat), dtype=np.float32)
    for c in range(n_feat):
        if c in static_channels:
            f0 = (
                np.sin(2 * lat2d + rng.uniform(0, 6))
                + np.cos(3 * lon2d + rng.uniform(0, 6))
            ).T  # [lon, lat]
            fields[:, :, :, c] = f0[None]
            continue
        if c in forcing_channels:
            t = np.arange(n_time)[:, None, None]
            fields[:, :, :, c] = np.sin(2 * np.pi * t / 12.0 + c)
            continue
        # Prognostic: superposition of advecting waves.
        amp = rng.uniform(0.5, 1.5, 3)
        kx = rng.randint(1, 4, 3)
        ky = rng.randint(1, 3, 3)
        speed = rng.uniform(0.05, 0.2, 3)
        phase = rng.uniform(0, 2 * np.pi, 3)
        for t in range(n_time):
            f = sum(
                amp[i]
                * np.sin(kx[i] * lon2d + speed[i] * t * 2 * np.pi + phase[i])
                * np.cos(ky[i] * lat2d)
                for i in range(3)
            )
            fields[t, :, :, c] = f.T + 10.0 * (c + 1)  # distinct channel offsets

    if regime_drift_m_per_step:
        # Smooth positive blob centered mid-domain (lon, lat layout here).
        blob = (
            np.exp(-(((lat2d - np.deg2rad(30.0)) / 0.5) ** 2))
            * (0.5 + 0.5 * np.cos(lon2d - np.pi))
        ).T  # [lon, lat], in [0, 1]
        t0 = int(drift_start_frac * n_time)
        lapse = 6.5e-3          # K/m
        g0 = 9.80665
        for t in range(t0, n_time):
            delev = regime_drift_m_per_step * (t - t0 + 1) * blob
            fields[t, :, :, drift_t2m_channel] -= lapse * delev
            if drift_zsurf_channel is not None:
                fields[t, :, :, drift_zsurf_channel] += g0 * delev

    mean = fields.reshape(-1, n_feat).mean(0)
    std = fields.reshape(-1, n_feat).std(0)
    std = np.where(std < 1e-6, 1.0, std)

    if flat:
        # Flatten lat-major into (T, N, C) like the multires builder.
        flat_fields = fields.transpose(0, 2, 1, 3).reshape(n_time, -1, n_feat)
        flat_fields.astype(np.float16).tofile(os.path.join(out_dir, "data.npy"))
        info = {
            "n_time": n_time,
            "n_feat": n_feat,
            "flat": True,
            "n_nodes": n_lat * n_lon,
        }
        lat_flat = np.repeat(lats, n_lon)
        lon_flat = np.tile(lons, n_lat)
        np.savez(
            os.path.join(out_dir, "coords.npz"),
            latitude=lat_flat,
            longitude=lon_flat,
            is_regional=np.zeros(n_lat * n_lon, dtype=bool),
        )
    else:
        fields.astype(np.float16).tofile(os.path.join(out_dir, "data.npy"))
        info = {
            "n_time": n_time,
            "n_lon": n_lon,
            "n_lat": n_lat,
            "n_feat": n_feat,
            "flat": False,
        }
        np.savez(
            os.path.join(out_dir, "coords.npz"), latitude=lats, longitude=lons
        )

    with open(os.path.join(out_dir, "dataset_info.json"), "w") as f:
        json.dump(info, f)
    np.savez(
        os.path.join(out_dir, "scalers.npz"),
        mean=mean.astype(np.float32),
        std=std.astype(np.float32),
        n=np.array(n_time * n_lat * n_lon),
    )
    with open(os.path.join(out_dir, "variables.json"), "w") as f:
        json.dump([f"var_{i}" for i in range(n_feat)], f)
    return out_dir
