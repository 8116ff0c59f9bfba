"""Live runtime bundle: self-contained operational inference artifact
(torch counterpart of ``graphcast_lite_tpu.operational.bundle``; NumPy and
file copies only, no device).

~ reference ``scripts/export_live_runtime_bundle.py``: packs everything live
inference needs — normalization scalers, grid coordinates, canonical
variable order, static-channel template fields, the experiment config and
the trained parameters — so a forecast run needs NO training dataset on
disk (the reference ships ``live_runtime_bundle/``).

Bundle layout:
  <dir>/config.json        experiment config (reference-compatible schema)
  <dir>/params.pt          model parameters: the port's state dict, or
  <dir>/params.msgpack     the JAX package's params (either loads here, so
                           a bundle the JAX package exported runs in the
                           port)
  <dir>/scalers.npz        {mean, std}
  <dir>/coords.npz         {latitude, longitude[, is_regional]}
  <dir>/variables.json     canonical variable order
  <dir>/static_fields.npz  {values [G, n_static], channels [n_static]}
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any, Dict, List, Optional

import numpy as np

from ..config import ExperimentConfig, load_experiment_config

__all__ = ["RuntimeBundle", "export_runtime_bundle", "load_runtime_bundle"]

# The params file a bundle holds: the port's, else the JAX package's.
PARAMS_FILES = ("params.pt", "params.msgpack")


@dataclasses.dataclass
class RuntimeBundle:
    config: ExperimentConfig
    params_path: str
    mean: np.ndarray
    std: np.ndarray
    latitude: np.ndarray
    longitude: np.ndarray
    variables: List[str]
    static_values: Optional[np.ndarray]    # [G, n_static] normalized units
    static_channels: List[int]
    flat_grid: bool = False

    @property
    def num_nodes(self) -> int:
        if self.flat_grid:
            return len(self.latitude)
        return len(self.latitude) * len(self.longitude)


def export_runtime_bundle(
    exp_dir: str,
    data_dir: str,
    out_dir: str,
    params_file: Optional[str] = None,
) -> str:
    """Pack an experiment + dataset dir into a runtime bundle.  The params
    file (default ``best_model.pt``, else ``best_model.msgpack``) is
    copied as ``params`` with its own extension."""
    os.makedirs(out_dir, exist_ok=True)
    cfg = load_experiment_config(os.path.join(exp_dir, "config.json"))
    shutil.copy(os.path.join(exp_dir, "config.json"),
                os.path.join(out_dir, "config.json"))
    if params_file is None:
        params_file = next(
            (n for n in ("best_model.pt", "best_model.msgpack")
             if os.path.exists(os.path.join(exp_dir, n))),
            "best_model.pt")
    ext = os.path.splitext(params_file)[1]
    shutil.copy(os.path.join(exp_dir, params_file),
                os.path.join(out_dir, "params" + ext))
    for name in ("scalers.npz", "coords.npz", "variables.json",
                 "dataset_info.json"):
        src = os.path.join(data_dir, name)
        if os.path.exists(src):
            shutil.copy(src, os.path.join(out_dir, name))

    # Static template fields: values of the static channels from the first
    # frame of the dataset (normalized units, node-flattened).
    if cfg.static_channels:
        from ..data.dataset import ChunkedTimeseriesDataset

        ds = ChunkedTimeseriesDataset(
            data_dir, obs_window=1, pred_steps=1, split="all",
            n_features=cfg.data.num_features_used,
        )
        x0, _ = ds.get(0)
        frame = x0.reshape(ds.n_nodes, 1, ds.n_feat)[:, 0, :]
        np.savez(
            os.path.join(out_dir, "static_fields.npz"),
            values=frame[:, cfg.static_channels].astype(np.float32),
            channels=np.asarray(cfg.static_channels, np.int32),
        )
    return out_dir


def _params_path(bundle_dir: str) -> str:
    for name in PARAMS_FILES:
        path = os.path.join(bundle_dir, name)
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"no {' or '.join(PARAMS_FILES)} in {bundle_dir}")


def load_runtime_bundle(bundle_dir: str) -> RuntimeBundle:
    cfg = load_experiment_config(os.path.join(bundle_dir, "config.json"))
    scalers = np.load(os.path.join(bundle_dir, "scalers.npz"))
    coords = np.load(os.path.join(bundle_dir, "coords.npz"))
    with open(os.path.join(bundle_dir, "variables.json")) as f:
        variables = json.load(f)
    flat = False
    info_path = os.path.join(bundle_dir, "dataset_info.json")
    if os.path.exists(info_path):
        with open(info_path) as f:
            flat = bool(json.load(f).get("flat", False))
    static_values, static_channels = None, list(cfg.static_channels)
    sf = os.path.join(bundle_dir, "static_fields.npz")
    if os.path.exists(sf):
        blob = np.load(sf)
        static_values = blob["values"]
        static_channels = blob["channels"].tolist()
    return RuntimeBundle(
        config=cfg,
        params_path=_params_path(bundle_dir),
        mean=scalers["mean"].astype(np.float32),
        std=scalers["std"].astype(np.float32),
        latitude=coords["latitude"].astype(np.float32),
        longitude=coords["longitude"].astype(np.float32),
        variables=variables,
        static_values=static_values,
        static_channels=static_channels,
        flat_grid=flat,
    )
