"""Chunked normalized weather datasets (NumPy host pipeline).

On-disk format is byte-compatible with the reference's
(reference ``src/data/dataloader_chunked.py``):

  <dir>/data.npy          raw float16 memmap, (T, n_lon, n_lat, C) regular
                          or (T, N, C) flat multires (headerless, shape from
                          dataset_info.json)
  <dir>/dataset_info.json {n_time, n_lon, n_lat, n_feat, flat, n_nodes}
  <dir>/scalers.npz       {mean, std[, n]} per channel
  <dir>/coords.npz        {latitude, longitude[, is_regional]}
  <dir>/variables.json    canonical variable-name order
  (legacy: chunk_*.npy standard .npy files instead of data.npy)

Key behaviors reproduced:
  * sliding (obs+pred)-frame windows that never cross chunk boundaries;
  * on-the-fly (x - mean)/std normalization at sample extraction;
  * lat-major flattening (lat slow, lon fast), matching
    ``np.meshgrid(lons, lats)`` in the graph builder;
  * chronological splits: train = first 80%, test = last 20%,
    val = first half of test, test_only = second half.

TPU-side difference: samples are delivered as batched NumPy arrays ready for
a single host->device transfer per step (the reference uses per-sample torch
DataLoader workers; here batching is vectorized slicing on the memmap).
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

__all__ = [
    "DatasetMetadata",
    "ChunkedTimeseriesDataset",
    "load_chunked_datasets",
    "BatchIterator",
]


@dataclasses.dataclass
class DatasetMetadata:
    """Grid/window metadata (reference src/data/data_configs.py:4-109)."""

    flattened: bool
    num_latitudes: int
    num_longitudes: int
    num_features: int
    obs_window: int
    pred_window: int
    flat_grid: bool = False
    num_grid_nodes: int = 0
    coordinates: Optional[Tuple[np.ndarray, np.ndarray]] = None  # (lats, lons)
    is_regional: Optional[np.ndarray] = None
    variables: Optional[List[str]] = None

    @property
    def grid_shape(self) -> Tuple[int, int]:
        return self.num_latitudes, self.num_longitudes


class ChunkedTimeseriesDataset:
    """Sliding-window view over raw float16 timeseries memmaps."""

    def __init__(
        self,
        data_dir: str,
        obs_window: int = 2,
        pred_steps: int = 1,
        split: str = "train",
        n_features: Optional[int] = None,
        test_fraction: float = 0.2,
    ):
        self.data_dir = data_dir
        self.obs_window = obs_window
        self.pred_steps = pred_steps
        self.split = split

        scalers = np.load(os.path.join(data_dir, "scalers.npz"))
        mean = scalers["mean"].astype(np.float32)
        std = scalers["std"].astype(np.float32)

        single = os.path.join(data_dir, "data.npy")
        info_file = os.path.join(data_dir, "dataset_info.json")
        if os.path.exists(single) and os.path.exists(info_file):
            with open(info_file) as f:
                info = json.load(f)
            self.flat_grid = bool(info.get("flat", False))
            if self.flat_grid:
                shape = (info["n_time"], info["n_nodes"], info["n_feat"])
            else:
                shape = (info["n_time"], info["n_lon"], info["n_lat"], info["n_feat"])
            mm = np.memmap(single, dtype=np.float16, mode="r", shape=shape)
            self.chunks = [mm]
        else:
            self.flat_grid = False
            files = sorted(glob.glob(os.path.join(data_dir, "chunk_*.npy")))
            if not files:
                raise FileNotFoundError(
                    f"No data.npy or chunk_*.npy in {data_dir}"
                )
            self.chunks = [np.load(f, mmap_mode="r") for f in files]

        first = self.chunks[0]
        if self.flat_grid:
            self.n_nodes = int(first.shape[1])
            self.n_lon = self.n_lat = None
            n_feat_total = int(first.shape[2])
        else:
            self.n_lon = int(first.shape[1])
            self.n_lat = int(first.shape[2])
            self.n_nodes = self.n_lon * self.n_lat
            n_feat_total = int(first.shape[3])
        self.n_feat = int(n_features) if n_features else n_feat_total
        self.mean = mean[: self.n_feat]
        self.std = std[: self.n_feat]

        window = obs_window + pred_steps
        samples: List[Tuple[int, int]] = []
        for ci, chunk in enumerate(self.chunks):
            n_valid = chunk.shape[0] - window + 1
            samples.extend((ci, t) for t in range(max(n_valid, 0)))

        split_idx = int(len(samples) * (1 - test_fraction))
        if split == "train":
            samples = samples[:split_idx]
        elif split == "test":
            samples = samples[split_idx:]
        elif split == "val":
            tail = samples[split_idx:]
            samples = tail[: len(tail) // 2]
        elif split == "test_only":
            tail = samples[split_idx:]
            samples = tail[len(tail) // 2:]
        elif split == "all":
            pass
        else:
            raise ValueError(f"Unknown split: {split}")
        self._samples = samples

    def __len__(self) -> int:
        return len(self._samples)

    def get(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (X [G, obs·C], Y [G, pred·C]) float32, normalized."""
        ci, t = self._samples[idx]
        window = np.asarray(
            self.chunks[ci][t : t + self.obs_window + self.pred_steps]
        )
        if self.flat_grid:
            window = window[:, :, : self.n_feat].astype(np.float32)
            window = (window - self.mean) / self.std
            x = window[: self.obs_window].transpose(1, 0, 2)
            y = window[self.obs_window :].transpose(1, 0, 2)
            g = self.n_nodes
        else:
            window = window[:, :, :, : self.n_feat].astype(np.float32)
            window = (window - self.mean) / self.std
            # (t, lon, lat, f) -> (lat, lon, t, f): lat-major node order.
            x = window[: self.obs_window].transpose(2, 1, 0, 3)
            y = window[self.obs_window :].transpose(2, 1, 0, 3)
            g = self.n_nodes
            x = x.reshape(g, self.obs_window, self.n_feat)
            y = y.reshape(g, self.pred_steps, self.n_feat)
        return (
            np.ascontiguousarray(x.reshape(g, self.obs_window * self.n_feat)),
            np.ascontiguousarray(y.reshape(g, self.pred_steps * self.n_feat)),
        )

    def __getitem__(self, idx: int):
        return self.get(idx)


class BatchIterator:
    """Batched, optionally shuffled iteration yielding stacked numpy arrays.

    One (B, G, obs·C) / (B, G, pred·C) pair per step — a single host->device
    transfer.  Drops the final partial batch during training (static shapes
    for XLA); keeps it for evaluation via ``drop_remainder=False`` with
    padding-free per-sample fallback.
    """

    def __init__(
        self,
        dataset: ChunkedTimeseriesDataset,
        batch_size: int = 1,
        shuffle: bool = False,
        seed: int = 0,
        drop_remainder: bool = True,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_remainder:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self._epoch)
            rng.shuffle(order)
        self._epoch += 1
        b = self.batch_size
        stop = n - (n % b) if self.drop_remainder else n
        for i in range(0, stop, b):
            idx = order[i : i + b]
            xs, ys = zip(*(self.dataset.get(int(j)) for j in idx))
            yield np.stack(xs), np.stack(ys)


def load_chunked_datasets(
    data_path: str,
    obs_window: int = 2,
    pred_steps: int = 1,
    n_features: Optional[int] = None,
    test_fraction: float = 0.2,
    test_split: str = "test_only",
):
    """(train, val, test, metadata) — reference-compatible convenience loader."""
    coords = np.load(os.path.join(data_path, "coords.npz"))
    lats = coords["latitude"].astype(np.float32)
    lons = coords["longitude"].astype(np.float32)

    info_file = os.path.join(data_path, "dataset_info.json")
    is_flat = False
    if os.path.exists(info_file):
        with open(info_file) as f:
            is_flat = bool(json.load(f).get("flat", False))

    variables = None
    var_file = os.path.join(data_path, "variables.json")
    if os.path.exists(var_file):
        with open(var_file) as f:
            variables = json.load(f)

    n_feat = n_features or (len(variables) if variables else None)

    mk = lambda split: ChunkedTimeseriesDataset(
        data_path, obs_window=obs_window, pred_steps=pred_steps,
        split=split, n_features=n_feat, test_fraction=test_fraction,
    )
    train_ds, val_ds, test_ds = mk("train"), mk("val"), mk(test_split)

    meta = DatasetMetadata(
        flattened=True,
        num_latitudes=0 if is_flat else len(lats),
        num_longitudes=0 if is_flat else len(lons),
        num_features=train_ds.n_feat,
        obs_window=obs_window,
        pred_window=pred_steps,
        flat_grid=is_flat,
        num_grid_nodes=train_ds.n_nodes,
        coordinates=(lats, lons),
        is_regional=coords["is_regional"] if "is_regional" in coords else None,
        variables=variables,
    )
    return train_ds, val_ds, test_ds, meta
