"""Streaming evaluation metrics (constant memory over samples).

Vectorized NumPy re-design of the reference's ``StreamingMetrics``
(reference scripts/predict.py:53-123): running MSE/MAE over dynamic
channels, per-channel RMSE, and per-column spatial anomaly correlation,
accumulated without storing samples.  Columns are (horizon, channel) pairs
when fed [G, P·C] arrays; channel identity is ``col % C``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

__all__ = ["StreamingMetrics", "skill_score"]


def skill_score(rmse: float, rmse_baseline: float) -> float:
    """1 − RMSE/RMSE_persistence (reference scripts/predict.py:636)."""
    return 1.0 - rmse / (rmse_baseline + 1e-12)


class StreamingMetrics:
    def __init__(
        self,
        num_channels: int,
        exclude_channels: Optional[Sequence[int]] = None,
    ):
        self.C = num_channels
        self.exclude = set(exclude_channels or [])
        self.n = 0
        self.total_elem = 0
        self.sum_se = 0.0
        self.sum_ae = 0.0
        self.sum_se_per_ch = np.zeros(num_channels, np.float64)
        self.elem_per_ch = np.zeros(num_channels, np.int64)
        self.sum_acc = np.zeros(num_channels, np.float64)
        self.acc_count = np.zeros(num_channels, np.int64)

    def update(self, y_true: np.ndarray, y_pred: np.ndarray) -> None:
        """y_true, y_pred: [G, P·C] or [G, C] (float)."""
        yt = np.asarray(y_true, np.float64)
        yp = np.asarray(y_pred, np.float64)
        g, cp = yt.shape
        ch = np.arange(cp) % self.C

        # Per-channel squared error (accumulated for ALL channels).
        se = np.square(yp - yt).sum(axis=0)  # [CP]
        np.add.at(self.sum_se_per_ch, ch, se)
        np.add.at(self.elem_per_ch, ch, g)

        # Per-column spatial correlation.
        yt_a = yt - yt.mean(axis=0)
        yp_a = yp - yp.mean(axis=0)
        denom = np.linalg.norm(yt_a, axis=0) * np.linalg.norm(yp_a, axis=0)
        corr = (yt_a * yp_a).sum(axis=0) / (denom + 1e-8)
        np.add.at(self.sum_acc, ch, corr)
        np.add.at(self.acc_count, ch, 1)

        # Aggregate over dynamic channels only.
        dyn = ~np.isin(ch, list(self.exclude)) if self.exclude else np.ones(cp, bool)
        if dyn.any():
            err = (yp - yt)[:, dyn]
            self.sum_se += float(np.square(err).sum())
            self.sum_ae += float(np.abs(err).sum())
            self.total_elem += err.size
        self.n += 1

    @property
    def mse(self) -> float:
        return self.sum_se / max(self.total_elem, 1)

    @property
    def rmse(self) -> float:
        return float(np.sqrt(self.mse))

    @property
    def mae(self) -> float:
        return self.sum_ae / max(self.total_elem, 1)

    @property
    def rmse_per_channel(self) -> np.ndarray:
        return np.sqrt(self.sum_se_per_ch / np.maximum(self.elem_per_ch, 1))

    @property
    def acc_per_channel(self) -> np.ndarray:
        return self.sum_acc / np.maximum(self.acc_count, 1)

    @property
    def acc(self) -> float:
        dyn = [c for c in range(self.C) if c not in self.exclude]
        return float(self.acc_per_channel[dyn].mean()) if dyn else 0.0
