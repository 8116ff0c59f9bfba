"""Model/graph construction from an ExperimentConfig + dataset metadata
(torch counterpart of ``graphcast_lite_tpu.build``).

Entry points run on the card: ``device`` defaults to ``cuda``, and a
missing card raises unless the caller asks for ``cpu``.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from .config import ExperimentConfig
from .data.dataset import DatasetMetadata
from .graphs.build import GraphSet, build_graph_set
from .models.weather import STATIC_NODE_FEATURES, ModelGraphs, WeatherModel, \
    model_output_dim

__all__ = ["resolve_device", "resolve_dtype", "detect_region_bounds",
           "build_weather_model", "config_direct_steps"]

_DTYPES = {"fp32": torch.float32, "float32": torch.float32,
           "bf16": torch.bfloat16, "bfloat16": torch.bfloat16}


def resolve_device(device: Union[str, torch.device, None] = None) \
        -> torch.device:
    """``cuda`` unless told otherwise; raises when CUDA is asked for and no
    card is present (never falls back to the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def resolve_dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    """'fp32' | 'bf16' (or the torch dtype) -> torch dtype."""
    if isinstance(dtype, torch.dtype):
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"unsupported serve dtype {dtype}")
        return dtype
    try:
        return _DTYPES[dtype]
    except KeyError:
        raise ValueError(f"unsupported serve dtype {dtype!r} "
                         "(fp32 | bf16)") from None


def config_direct_steps(cfg: ExperimentConfig) -> int:
    """P for DIRECT multi-step models — configs whose decoder emits P·C
    channels in one forward — else 1 (statically from the config)."""
    if getattr(cfg, "pipeline", None) is None \
            or getattr(cfg, "data", None) is None:
        return 1
    c = cfg.data.num_features_used
    if cfg.pipeline.product_graph is not None:
        enc_in = c + STATIC_NODE_FEATURES
    else:
        enc_in = c * cfg.data.obs_window_used + STATIC_NODE_FEATURES
    dec_in = model_output_dim(
        cfg.pipeline.processor,
        model_output_dim(cfg.pipeline.encoder, enc_in),
    )
    dec_out = model_output_dim(cfg.pipeline.decoder, dec_in)
    if dec_out > c and dec_out % c == 0:
        return dec_out // c
    return 1


def detect_region_bounds(
    meta: DatasetMetadata, span_threshold_deg: float = 90.0
) -> Optional[Tuple[float, float, float, float]]:
    """(lat_min, lat_max, lon_min, lon_max) if the grid covers a region
    smaller than `span_threshold_deg` in both axes, else None."""
    if meta.coordinates is None:
        return None
    lats, lons = meta.coordinates
    lat_span = float(lats.max() - lats.min())
    lon_span = float(lons.max() - lons.min())
    if lat_span < span_threshold_deg and lon_span < span_threshold_deg:
        return (
            float(lats.min()), float(lats.max()),
            float(lons.min()), float(lons.max()),
        )
    return None


def build_weather_model(
    cfg: ExperimentConfig,
    meta: DatasetMetadata,
    region_bounds: Optional[Tuple[float, float, float, float]] = None,
    auto_region: bool = True,
    device: Union[str, torch.device, None] = None,
    seed: int = 0,
    mesh_buffer_deg: float = 15.0,
) -> Tuple[WeatherModel, ModelGraphs, GraphSet]:
    """Build the WeatherModel (fp32, weights drawn from a generator seeded
    with ``seed``) and its graphs, both on ``device``.  A grid spanning
    less than 90° in both axes (``detect_region_bounds``), or
    ``region_bounds``, prunes the mesh to the region plus
    ``mesh_buffer_deg``."""
    dev = resolve_device(device)
    if cfg.graph is None or cfg.pipeline is None:
        raise ValueError("GNN model construction requires graph+pipeline "
                         "configs")
    lats, lons = meta.coordinates
    if region_bounds is None and auto_region:
        region_bounds = detect_region_bounds(meta)

    gs = build_graph_set(
        np.asarray(lats), np.asarray(lons),
        cfg.graph.mesh_levels,
        cfg.graph.grid2mesh_radius_query,
        flat_grid=meta.flat_grid,
        region_bounds=region_bounds,
        mesh_buffer_deg=mesh_buffer_deg,
    )
    graphs = ModelGraphs.from_graph_set(
        gs, product_config=cfg.pipeline.product_graph,
        obs_window=cfg.data.obs_window_used,
    ).to(dev)
    model = WeatherModel(
        pipeline=cfg.pipeline,
        data=cfg.data,
        num_grid_nodes=gs.num_grid_nodes,
        num_mesh_nodes=gs.num_mesh_nodes,
        generator=torch.Generator().manual_seed(seed),
    ).to(dev)
    return model, graphs, gs
