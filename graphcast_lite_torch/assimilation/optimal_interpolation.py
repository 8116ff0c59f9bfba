"""Optimal interpolation (OI) data assimilation (torch counterpart of
``graphcast_lite_tpu.assimilation.optimal_interpolation``).

~ reference ``src/assimilation/optimal_interpolation.py``:
  * Gaussian background covariance B = σ_b² · exp(−d²/L²) over grid nodes
    (haversine distances in meters, :40-56);
  * nearest-node observation operator H (:58-72);
  * per-channel analysis  x_a = x_b + B Hᵀ (H B Hᵀ + R + εI)⁻¹ (y − H x_b)
    (:74-144), restricted to an ROI node subset to keep B tractable on
    large grids (the documented 131K × 131K OOM fix).

B is built on the host in float64.  Each analysis solves A w = innovation
with ``torch.linalg.solve`` in float32 on ``device`` (default ``cuda``),
as the JAX package solves it (``jnp.linalg.solve`` of float32 arrays: it
never enables x64); a failed solve raises, it never falls back to the
host.  Channels with identical observation patterns share one solve with
a stacked right-hand side.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from ..build import resolve_device

__all__ = ["OptimalInterpolation", "haversine_matrix"]

_EARTH_RADIUS_M = 6371000.0


def haversine_matrix(coords1: np.ndarray, coords2: np.ndarray) -> np.ndarray:
    """Pairwise great-circle distances in meters.  coords: [N, 2] (lat, lon)
    degrees."""
    lat1 = np.radians(coords1[:, 0])[:, None]
    lon1 = np.radians(coords1[:, 1])[:, None]
    lat2 = np.radians(coords2[:, 0])[None, :]
    lon2 = np.radians(coords2[:, 1])[None, :]
    a = (
        np.sin((lat1 - lat2) / 2) ** 2
        + np.cos(lat1) * np.cos(lat2) * np.sin((lon1 - lon2) / 2) ** 2
    )
    return _EARTH_RADIUS_M * 2.0 * np.arcsin(np.sqrt(np.clip(a, 0.0, 1.0)))


class OptimalInterpolation:
    def __init__(
        self,
        grid_lats: np.ndarray,
        grid_lons: np.ndarray,
        sigma_b: float,
        sigma_o: float,
        length_scale_m: float,
        flat_grid: bool = False,
        roi_idx: Optional[np.ndarray] = None,
        device: Union[str, torch.device, None] = None,
    ):
        self.device = resolve_device(device)
        self.sigma_b = float(sigma_b)
        self.sigma_o = float(sigma_o)
        self.L = float(length_scale_m)
        self.roi_idx = roi_idx

        if flat_grid:
            self.grid_coords = np.stack([grid_lats, grid_lons], axis=1)
        else:
            lat2d, lon2d = np.meshgrid(grid_lats, grid_lons, indexing="ij")
            self.grid_coords = np.stack(
                [lat2d.reshape(-1), lon2d.reshape(-1)], axis=1
            )

        self._oi_coords = (
            self.grid_coords[roi_idx] if roi_idx is not None else self.grid_coords
        )
        d = haversine_matrix(self._oi_coords, self._oi_coords)
        self.B = (self.sigma_b**2) * np.exp(-(d**2) / (self.L**2))

    def _nearest_nodes(self, obs_coords: np.ndarray) -> np.ndarray:
        d = haversine_matrix(obs_coords, self._oi_coords)
        return np.argmin(d, axis=1)

    def _analyze(
        self, x_b: np.ndarray, obs_vals: np.ndarray, obs_nodes: np.ndarray
    ) -> np.ndarray:
        """x_b: [N_oi] or [N_oi, K] backgrounds; obs sharing one pattern."""
        n_obs = len(obs_vals)
        # H selects rows: HBHt = B[obs_nodes][:, obs_nodes]; BHt = B[:, obs_nodes].
        bht = self.B[:, obs_nodes]                      # [N_oi, n_obs]
        hbht = self.B[np.ix_(obs_nodes, obs_nodes)]     # [n_obs, n_obs]
        a = hbht + np.eye(n_obs) * (self.sigma_o**2 + 1e-5)
        innovation = obs_vals - x_b[obs_nodes]
        # Solve instead of invert: K @ innovation = BHt @ (A^{-1} innovation).
        w = self.solve(a, innovation)
        return x_b + bht @ w

    def solve(self, a: np.ndarray, rhs: np.ndarray) -> np.ndarray:
        """A⁻¹ rhs in float32 on ``self.device`` (``torch.linalg.solve``);
        returns a float32 host array."""
        w = torch.linalg.solve(
            torch.as_tensor(a, dtype=torch.float32, device=self.device),
            torch.as_tensor(rhs, dtype=torch.float32, device=self.device),
        )
        return w.cpu().numpy()

    def apply(self, forecast: np.ndarray, observations: np.ndarray) -> np.ndarray:
        """forecast/observations: [..., C] (NaN = unobserved).  Returns the
        analysis with only the ROI (or full grid) corrected."""
        shape = forecast.shape
        x_b = forecast.reshape(-1, shape[-1]).astype(np.float64)
        y_o = observations.reshape(-1, shape[-1])
        if x_b.shape[0] != len(self.grid_coords):
            raise RuntimeError(
                f"forecast has {x_b.shape[0]} nodes but OI grid has "
                f"{len(self.grid_coords)}"
            )
        x_a = x_b.copy()

        sub = self.roi_idx if self.roi_idx is not None else slice(None)
        y_sub = y_o[sub]
        x_sub = x_b[sub]

        # Group channels by observation pattern: channels observed at the
        # same node set (the common case — the sparse-station generator
        # observes all requested channels at every station) share ONE
        # factorization of A = HBHt + R and solve a stacked RHS.
        masks = ~np.isnan(y_sub)
        groups: dict = {}
        for c in range(shape[-1]):
            m = masks[:, c]
            if not m.any():
                continue
            groups.setdefault(m.tobytes(), []).append(c)
        for key, chans in groups.items():
            m = np.frombuffer(key, dtype=bool)
            obs_nodes = np.flatnonzero(m)
            x_new = self._analyze(
                x_sub[:, chans],                       # [N_oi, K]
                y_sub[np.ix_(obs_nodes, chans)],       # [n_obs, K]
                obs_nodes,
            )
            if self.roi_idx is not None:
                x_a[np.ix_(self.roi_idx, chans)] = x_new
            else:
                x_a[:, chans] = x_new
        return x_a.reshape(shape).astype(forecast.dtype)

    def make_step_hook(self, observations: np.ndarray, k: Optional[int] = None):
        """Adapter for evaluate_model's assimilator hook.
        observations: [G, P, C] per-step obs (NaN = unobserved)."""
        def hook(state: np.ndarray, step: int) -> np.ndarray:
            if k is not None and step >= k:
                return state
            if step >= observations.shape[1]:
                return state
            return self.apply(state, observations[:, step, :])

        return hook
