"""Nudging data assimilation (Newtonian relaxation; a NumPy copy of
``graphcast_lite_tpu.assimilation.nudging``).

~ reference ``src/assimilation/nudging.py``:
  * analysis = background + α · (obs − background) on non-NaN observations,
    with an optional per-channel feature mask (:60-93);
  * Hann cosine taper masks for boundary stitching (:35-54);
  * offline nudging of a finished trajectory (:200-206).

Pure NumPy — the per-step application plugs into the
``evaluate_model(assimilator=…)`` hook, giving the reference's
"sequential nudged rollout" (:99-198) without duplicating the AR loop.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

__all__ = [
    "NudgingAssimilator",
    "nudge_offline",
    "cosine_taper_2d",
    "boundary_taper_mask",
    "feature_mask_from_names",
    "feature_mask_from_indices",
]


def feature_mask_from_names(
    all_features: Sequence[str], assimilate: Sequence[str]
) -> np.ndarray:
    """[C] bool mask selecting channels to assimilate, by variable name."""
    idx = {n: i for i, n in enumerate(all_features)}
    m = np.zeros(len(all_features), bool)
    for name in assimilate:
        if name in idx:
            m[idx[name]] = True
    return m


def feature_mask_from_indices(indices: Sequence[int], num_features: int) -> np.ndarray:
    m = np.zeros(num_features, bool)
    for i in indices:
        if 0 <= i < num_features:
            m[i] = True
    return m


def cosine_taper_2d(n_lat: int, n_lon: int, border: int) -> np.ndarray:
    """Hann-window 2-D taper [n_lat, n_lon]: 1 in the interior, cosine decay
    to 0 at the edges over `border` points."""
    if border <= 0:
        return np.ones((n_lat, n_lon), np.float32)

    def hann(n, b):
        w = np.ones(n, np.float32)
        t = np.linspace(0.0, 1.0, b)
        win = 0.5 * (1.0 - np.cos(np.pi * t))
        w[:b] = win
        w[-b:] = win[::-1]
        return w

    return np.outer(hann(n_lat, border), hann(n_lon, border)).astype(np.float32)


def boundary_taper_mask(n_lat: int, n_lon: int, border: int) -> np.ndarray:
    """Flat [G] taper in the lat-major node order."""
    return cosine_taper_2d(n_lat, n_lon, border).reshape(-1)


class NudgingAssimilator:
    """x_a = x_b + α (y_obs − x_b) on observed (non-NaN) entries."""

    def __init__(
        self,
        alpha: float = 0.25,
        feature_mask: Optional[np.ndarray] = None,
    ):
        self.alpha = float(alpha)
        self.feature_mask = feature_mask

    def apply(self, forecast: np.ndarray, observation: np.ndarray) -> np.ndarray:
        """forecast/observation: [G, C]; observation may contain NaN."""
        if forecast.shape != observation.shape:
            return forecast
        mask = ~np.isnan(observation)
        if self.feature_mask is not None and (
            self.feature_mask.shape[0] == forecast.shape[-1]
        ):
            mask = mask & self.feature_mask[None, :]
        out = forecast.copy()
        out[mask] = forecast[mask] + self.alpha * (
            observation[mask] - forecast[mask]
        )
        return out

    def make_step_hook(self, observations: np.ndarray, k: Optional[int] = None):
        """Adapter for evaluate_model's assimilator hook.

        observations: [G, P, C] per-step obs (NaN = unobserved).
        k: assimilate only the first k AR steps (None = all).
        """
        def hook(state: np.ndarray, step: int) -> np.ndarray:
            if k is not None and step >= k:
                return state
            if step >= observations.shape[1]:
                return state
            return self.apply(state, observations[:, step, :])

        return hook


def nudge_offline(
    y_pred: np.ndarray, y_obs: np.ndarray, alpha: float = 0.25
) -> np.ndarray:
    """Nudge a finished trajectory toward observations (NaN-masked)."""
    mask = ~np.isnan(y_obs)
    out = y_pred.copy()
    out[mask] = (1.0 - alpha) * y_pred[mask] + alpha * y_obs[mask]
    return out
