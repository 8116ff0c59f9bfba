"""Legacy .pt dataset loader (torch-tensor files from the reference era;
a framework-free copy of ``graphcast_lite_tpu.data.legacy_pt``).

~ reference ``src/data/dataloader.py``: experiment datasets stored as
``X_train.pt / y_train.pt / X_test.pt / y_test.pt`` torch tensors, rank-4
(already flattened, [N, G, obs, F] or [N, G, obs·F]) or rank-5
([N, lat?, lon?, obs, F]) with an optional ``coords.npz``.  Behaviors
reproduced: rank auto-detection, grid-shape override from the file, feature/
window slicing to the ``*_used`` config values, optional channel flattening
to [N, G, obs·F], and val = first half of the test split.

Output: plain in-memory NumPy datasets compatible with BatchIterator and
the shared Trainer/inference engine.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from .dataset import DatasetMetadata

__all__ = ["ArrayDataset", "load_pt_datasets"]


class ArrayDataset:
    """In-memory (X, Y) pairs with the ChunkedTimeseriesDataset interface."""

    def __init__(self, x: np.ndarray, y: np.ndarray, obs_window: int,
                 n_feat: int):
        assert len(x) == len(y)
        self.x = x
        self.y = y
        self.obs_window = obs_window
        self.n_feat = n_feat
        self.n_nodes = x.shape[1]
        self._samples = [(0, i) for i in range(len(x))]

    def __len__(self):
        return len(self.x)

    def get(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        return self.x[idx], self.y[idx]

    def __getitem__(self, idx):
        return self.get(idx)


def _load_tensor(path: str) -> np.ndarray:
    import torch

    t = torch.load(path, map_location="cpu", weights_only=True)
    return t.numpy() if hasattr(t, "numpy") else np.asarray(t)


def _shape_up(x: np.ndarray, obs: int) -> Tuple[np.ndarray, int, int, int]:
    """-> ([N, G, obs, F], n_lat, n_lon, F).  Accepts rank 3/4/5."""
    if x.ndim == 5:  # [N, lat, lon, obs, F]
        n, a, b, o, f = x.shape
        return x.reshape(n, a * b, o, f), a, b, f
    if x.ndim == 4:  # [N, G, obs, F]
        n, g, o, f = x.shape
        return x, 0, 0, f
    if x.ndim == 3:  # [N, G, obs*F]
        n, g, of = x.shape
        f = of // obs
        return x.reshape(n, g, obs, f), 0, 0, f
    raise ValueError(f"Unexpected dataset rank {x.ndim}")


def load_pt_datasets(
    data_dir: str,
    obs_window_used: int,
    pred_window_used: int,
    num_features_used: int,
    flatten: bool = True,
):
    """(train, val, test, metadata) from legacy X/y .pt files."""
    x_train = _load_tensor(os.path.join(data_dir, "X_train.pt"))
    y_train = _load_tensor(os.path.join(data_dir, "y_train.pt"))
    x_test = _load_tensor(os.path.join(data_dir, "X_test.pt"))
    y_test = _load_tensor(os.path.join(data_dir, "y_test.pt"))

    obs_file = x_train.shape[-2] if x_train.ndim >= 4 else obs_window_used
    x_train, n_lat, n_lon, f_file = _shape_up(x_train, obs_file)
    x_test, *_ = _shape_up(x_test, obs_file)
    y_train, *_ = _shape_up(y_train, y_train.shape[-2] if y_train.ndim >= 4
                            else pred_window_used)
    y_test, *_ = _shape_up(y_test, y_test.shape[-2] if y_test.ndim >= 4
                           else pred_window_used)

    # Slice to the used windows/features (last obs frames, first pred frames).
    x_train = x_train[:, :, -obs_window_used:, :num_features_used]
    x_test = x_test[:, :, -obs_window_used:, :num_features_used]
    y_train = y_train[:, :, :pred_window_used, :num_features_used]
    y_test = y_test[:, :, :pred_window_used, :num_features_used]

    def flat(a):
        n, g = a.shape[:2]
        return np.ascontiguousarray(
            a.reshape(n, g, -1).astype(np.float32)
        )

    coords = None
    coords_file = os.path.join(data_dir, "coords.npz")
    if os.path.exists(coords_file):
        cz = np.load(coords_file)
        coords = (cz["latitude"].astype(np.float32),
                  cz["longitude"].astype(np.float32))
        if n_lat == 0:
            n_lat, n_lon = len(coords[0]), len(coords[1])

    n_val = len(x_test) // 2
    mk = lambda x, y: ArrayDataset(flat(x), flat(y), obs_window_used,
                                   num_features_used)
    train = mk(x_train, y_train)
    val = mk(x_test[:n_val], y_test[:n_val])
    test = mk(x_test[n_val:], y_test[n_val:])

    meta = DatasetMetadata(
        flattened=flatten,
        num_latitudes=n_lat,
        num_longitudes=n_lon,
        num_features=num_features_used,
        obs_window=obs_window_used,
        pred_window=pred_window_used,
        num_grid_nodes=train.n_nodes,
        coordinates=coords,
    )
    return train, val, test, meta
