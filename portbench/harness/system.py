"""The system under test, built through the program's own entry points
from a configuration file, and the inputs the benchmark makes from the
seed: the weights (by the reference's parameter list, on the device, in
one draw) and the random fields the traffic feeds."""

from __future__ import annotations

import importlib
from typing import Dict, Tuple

import numpy as np
import torch

__all__ = ["reference_module", "sub_seed", "generator", "make_weights",
           "experiment_config", "metadata", "build_model", "compute_dtype",
           "grid_axes"]


def reference_module(cfg: dict):
    """The plain reference that a configuration names (``reference``)."""
    return importlib.import_module(f"portbench.reference.{cfg['reference']}")


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed of its own for each use of the run's seed."""
    state = np.random.SeedSequence([int(seed) % 2 ** 64, stream])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, stream))


_CENTER = {"alpha": 0.25, "ln_weight": 1.0}
_SPREAD = {"alpha": 0.05, "ln_weight": 0.1, "ln_bias": 0.1, "gcn_bias": 0.1}


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """fp32 weights of every parameter of the reference's list, drawn in
    one call on ``device``: linear layers U(+-1/sqrt(fan_in)), GCN
    kernels U(+-sqrt(6/(in+out))), and the LayerNorm affines, PReLU
    slopes and GCN biases spread around their initial values so that
    every parameter changes the forecast."""
    spec = reference_module(cfg).param_spec(cfg)
    sizes = [int(np.prod(shape)) for _, shape, _, _ in spec]
    u = torch.rand(sum(sizes), generator=generator(seed, 1, device),
                   device=device) * 2.0 - 1.0
    out, off = {}, 0
    for (name, shape, kind, fan), n in zip(spec, sizes):
        if kind == "fan_in":
            bound = 1.0 / np.sqrt(fan)
        elif kind == "glorot":
            bound = np.sqrt(6.0 / fan)
        else:
            bound = _SPREAD[kind]
        out[name] = (u[off:off + n] * bound + _CENTER.get(kind, 0.0)) \
            .reshape(shape)
        off += n
    return out


def grid_axes(cfg: dict):
    """The grid's (lat, lon) axes: the benchmark's input, handed to the
    program and the reference alike."""
    from portbench.reference import mesh
    return mesh.grid_axes(cfg["grid"])


def experiment_config(cfg: dict):
    """The program's ``ExperimentConfig`` of a configuration file."""
    from graphcast_lite_torch.config import ExperimentConfig, from_dict
    return from_dict(ExperimentConfig, cfg)


def compute_dtype(cfg: dict) -> torch.dtype:
    from graphcast_lite_torch.build import resolve_dtype
    return resolve_dtype(cfg["tpu"]["compute_dtype"])


def metadata(cfg: dict):
    from graphcast_lite_torch.data.dataset import DatasetMetadata
    lat, lon = grid_axes(cfg)
    d = cfg["data"]
    return DatasetMetadata(
        flattened=True, num_latitudes=lat.size, num_longitudes=lon.size,
        num_features=d["num_features_used"], obs_window=d["obs_window_used"],
        pred_window=d["pred_window_used"], num_grid_nodes=lat.size * lon.size,
        coordinates=(lat, lon))


def build_model(cfg: dict, device, seed: int) -> Tuple[object, object,
                                                        Dict[str, torch.Tensor]]:
    """(fp32 WeatherModel carrying the benchmark's weights, its graphs,
    those weights), built by the program's ``build_weather_model``."""
    from graphcast_lite_torch.build import build_weather_model
    model, graphs, _ = build_weather_model(
        experiment_config(cfg), metadata(cfg), device=device)
    weights = make_weights(cfg, seed, device)
    model.load_state_dict(weights, strict=True)
    return model, graphs, weights
