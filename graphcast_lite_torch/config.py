"""Experiment configuration schema.

Dataclass counterpart of ``graphcast_lite_tpu.config`` (same field names,
defaults and enums) with no pydantic dependency.  ``from_dict`` builds a
config from a parsed ``config.json``: it coerces enum strings and nested
blocks, ignores unknown keys (as pydantic's default does) and fixes the
known key typos of reference experiment files.
"""

from __future__ import annotations

import dataclasses
import json
import typing
from enum import Enum
from typing import List, Optional

__all__ = [
    "Grid2MeshEdgeCreation",
    "Mesh2GridEdgeCreation",
    "GraphLayerType",
    "ProductGraphType",
    "GraphBuildingConfig",
    "MLPBlock",
    "GATProps",
    "GraphBlock",
    "ModelConfig",
    "ProductGraphConfig",
    "PipelineConfig",
    "DataConfig",
    "TpuConfig",
    "ExperimentConfig",
    "GridExperimentConfig",
    "from_dict",
    "to_dict",
    "is_grid_config",
    "load_experiment_config",
]


class Grid2MeshEdgeCreation(str, Enum):
    K_NEAREST = "k_nearest"
    RADIUS = "radius"


class Mesh2GridEdgeCreation(str, Enum):
    CONTAINED = "contained"


class GraphLayerType(str, Enum):
    ConvGCN = "conv_gcn"
    SimpleConv = "simple_conv"
    GATConv = "conv_gat"
    SparseGATConv = "sparse_gat"
    InteractionNet = "interaction_net"


class ProductGraphType(str, Enum):
    KRONECKER = "kronecker"
    CARTESIAN = "cartesian"
    STRONG = "strong"


@dataclasses.dataclass
class GraphBuildingConfig:
    grid2mesh_edge_creation: Grid2MeshEdgeCreation
    mesh_levels: List[int]
    mesh2grid_edge_creation: Mesh2GridEdgeCreation
    grid2mesh_radius_query: Optional[float] = None
    grid2mesh_k: Optional[int] = None


@dataclasses.dataclass
class MLPBlock:
    output_dim: int
    mlp_hidden_dims: Optional[List[int]] = None
    use_layer_norm: bool = False
    layer_norm_mode: Optional[str] = None


@dataclasses.dataclass
class GATProps:
    num_heads: int
    sparsity_thresholds: List[float]


@dataclasses.dataclass
class GraphBlock:
    layer_type: GraphLayerType
    gat_props: Optional[GATProps] = None
    hidden_dims: Optional[List[int]] = None
    output_dim: Optional[int] = None
    use_layer_norm: Optional[bool] = None
    layer_norm_mode: Optional[str] = None
    activation: Optional[str] = "prelu"
    num_message_passing_steps: Optional[int] = None
    edge_feature_dim: Optional[int] = None


@dataclasses.dataclass
class ModelConfig:
    gcn: GraphBlock
    mlp: Optional[MLPBlock] = None


@dataclasses.dataclass
class ProductGraphConfig:
    model: ModelConfig
    num_k: int
    self_loop: bool
    type: ProductGraphType


@dataclasses.dataclass
class PipelineConfig:
    encoder: ModelConfig
    processor: ModelConfig
    decoder: ModelConfig
    product_graph: Optional[ProductGraphConfig] = None


@dataclasses.dataclass
class DataConfig:
    dataset_name: str
    num_features_used: int
    obs_window_used: int
    pred_window_used: int
    want_feats_flattened: bool


@dataclasses.dataclass
class TpuConfig:
    """Runtime knobs of the JAX package, kept so its config files load."""

    compute_dtype: str = "float32"
    remat_rollout: bool = True
    data_parallel: int = 1
    spatial_parallel: int = 1
    donate_state: bool = True


@dataclasses.dataclass
class ExperimentConfig:
    data: DataConfig
    batch_size: int = 1
    learning_rate: float = 1e-5
    early_stopping_patience: int = 10
    early_stopping_delta: float = 1e-4
    num_epochs: int = 100
    random_seed: Optional[int] = 42
    graph: Optional[GraphBuildingConfig] = None
    pipeline: Optional[PipelineConfig] = None
    wandb_log: bool = False
    wandb_name: Optional[str] = None
    wandb_key: Optional[str] = None
    use_latitude_weighting: bool = True
    max_ar_steps: int = 1
    data_dir: Optional[str] = None
    static_channels: List[int] = dataclasses.field(default_factory=list)
    forcing_channels: List[int] = dataclasses.field(default_factory=list)
    roi_only_loss: bool = False
    boundary_mask_width: int = 0
    freeze_processor_epochs: int = 0
    finetune_processor_lr_factor: float = 0.1
    use_residual: bool = True
    tpu: TpuConfig = dataclasses.field(default_factory=TpuConfig)


@dataclasses.dataclass(kw_only=True)
class GridExperimentConfig:
    """The reference's CNN-stack schema: the flat ``config.json`` of its
    U-Net and downscaler trainers (``cli/train_unet.py``,
    ``cli/train_downscaler.py``), turned into the ``ExperimentConfig`` the
    shared ``Trainer`` takes by ``to_experiment_config``."""

    data_dir: Optional[str] = None
    num_features: int
    obs_window: int = 2
    pred_steps: int = 4
    batch_size: int = 16
    learning_rate: float = 1e-3
    num_epochs: int = 50
    patience: int = 10
    base_filters: int = 64
    max_ar_steps: int = 4
    attn_heads: int = 4
    spectral_modes: int = 4
    spectral_weight: float = 0.0
    gradient_weight: float = 0.0
    static_channels: List[int] = dataclasses.field(default_factory=list)
    forcing_channels: List[int] = dataclasses.field(default_factory=list)
    random_seed: Optional[int] = 42
    static_context: bool = False
    residual: bool = True
    gnn_input: bool = False
    input_noise: float = 0.0
    augment_flip: bool = False
    notes: Optional[str] = None

    def to_experiment_config(self) -> ExperimentConfig:
        """The ``ExperimentConfig`` of the shared ``Trainer`` (no graph
        and no pipeline: a CNN stack has no graph)."""
        return ExperimentConfig(
            batch_size=self.batch_size,
            learning_rate=self.learning_rate,
            num_epochs=self.num_epochs,
            early_stopping_patience=self.patience,
            random_seed=self.random_seed,
            max_ar_steps=self.max_ar_steps,
            static_channels=list(self.static_channels),
            forcing_channels=list(self.forcing_channels),
            use_residual=self.residual,
            data_dir=self.data_dir,
            data=DataConfig(
                dataset_name="unet",
                num_features_used=self.num_features,
                obs_window_used=self.obs_window,
                pred_window_used=max(self.pred_steps, 1),
                want_feats_flattened=True,
            ),
        )


def _coerce(tp, value):
    """Convert a JSON value to the annotated field type ``tp``."""
    if value is None:
        return None
    origin = typing.get_origin(tp)
    if origin is typing.Union:   # Optional[X]
        (inner,) = [a for a in typing.get_args(tp) if a is not type(None)]
        return _coerce(inner, value)
    if origin in (list, List):
        (inner,) = typing.get_args(tp)
        return [_coerce(inner, v) for v in value]
    if isinstance(tp, type) and issubclass(tp, Enum):
        return tp(value)
    if dataclasses.is_dataclass(tp):
        return from_dict(tp, value)
    if tp is float:
        return float(value)
    return value


def from_dict(cls, raw: dict):
    """Build the dataclass ``cls`` from a parsed JSON mapping (nested blocks
    and enum strings coerced; unknown keys ignored; key typos fixed)."""
    if isinstance(raw, cls):
        return raw
    raw = json.loads(json.dumps(raw))   # private copy for _normalize_typos
    _normalize_typos(raw)
    hints = typing.get_type_hints(cls)
    kwargs = {
        f.name: _coerce(hints[f.name], raw[f.name])
        for f in dataclasses.fields(cls) if f.name in raw
    }
    return cls(**kwargs)


def to_dict(cfg) -> dict:
    """JSON-ready mapping of a config (enums as their string values)."""
    def plain(v):
        if isinstance(v, Enum):
            return v.value
        if isinstance(v, dict):
            return {k: plain(x) for k, x in v.items()}
        if isinstance(v, list):
            return [plain(x) for x in v]
        return v

    return plain(dataclasses.asdict(cfg))


def is_grid_config(raw: dict) -> bool:
    """True for the reference's flat CNN schema (no pipeline/data blocks)."""
    return "pipeline" not in raw and "data" not in raw and (
        "base_filters" in raw or "num_features" in raw
    )


def load_experiment_config(path: str):
    """Load an experiment ``config.json`` (credentials dropped): an
    ``ExperimentConfig`` for a GNN experiment, a ``GridExperimentConfig``
    for the reference's flat U-Net / downscaler schema."""
    with open(path) as f:
        raw = json.load(f)
    raw.pop("wandb_key", None)  # never carry credentials forward
    if is_grid_config(raw):
        return from_dict(GridExperimentConfig, raw)
    return from_dict(ExperimentConfig, raw)


def _normalize_typos(node) -> None:
    """Fix known key typos from reference experiment files in place
    (demo_low/config.json writes `use_layzer_norm: true`; silently
    defaulting LN off would change that model's architecture)."""
    if isinstance(node, dict):
        if "use_layzer_norm" in node and "use_layer_norm" not in node:
            node["use_layer_norm"] = node.pop("use_layzer_norm")
        for v in node.values():
            _normalize_typos(v)
    elif isinstance(node, list):
        for v in node:
            _normalize_typos(v)
