"""Synthetic sparse-station observations (a NumPy copy of
``graphcast_lite_tpu.assimilation.observations``: the seeded draws are
the JAX package's, bit for bit).

~ reference ``scripts/create_obs.py`` and the inline obs path of
``scripts/predict.py:394-421``: simulate a station network by keeping a
random `sparsity` fraction of grid nodes (optionally restricted to an ROI
and a channel subset) and masking everything else with NaN — the format
both assimilators consume.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

__all__ = ["sparse_observation_mask", "make_sparse_observations"]


def sparse_observation_mask(
    num_nodes: int,
    sparsity: float,
    roi_mask: Optional[np.ndarray] = None,
    seed: int = 0,
) -> np.ndarray:
    """[G] bool mask: True at "station" nodes.  `sparsity` is the fraction of
    eligible nodes kept (e.g. 0.1 = 10% stations)."""
    rng = np.random.RandomState(seed)
    eligible = (
        np.flatnonzero(roi_mask) if roi_mask is not None
        else np.arange(num_nodes)
    )
    n_keep = max(1, int(round(len(eligible) * sparsity)))
    chosen = rng.choice(eligible, size=n_keep, replace=False)
    mask = np.zeros(num_nodes, bool)
    mask[chosen] = True
    return mask


def make_sparse_observations(
    truth: np.ndarray,                 # [G, P, C] ground truth
    sparsity: float,
    roi_mask: Optional[np.ndarray] = None,
    channels: Optional[Sequence[int]] = None,
    seed: int = 0,
    noise_std: float = 0.0,
) -> np.ndarray:
    """NaN-masked observations from the ground truth.

    Station locations are fixed across steps (like a real network); optional
    Gaussian observation noise; optional channel restriction (unobserved
    channels are NaN everywhere).
    """
    g, p, c = truth.shape
    mask = sparse_observation_mask(g, sparsity, roi_mask, seed)
    obs = np.full_like(truth, np.nan, dtype=np.float32)
    obs[mask] = truth[mask]
    if noise_std > 0:
        rng = np.random.RandomState(seed + 1)
        obs[mask] += rng.normal(0.0, noise_std, obs[mask].shape).astype(
            np.float32
        )
    if channels is not None:
        keep = np.zeros(c, bool)
        keep[list(channels)] = True
        obs[:, :, ~keep] = np.nan
    return obs
