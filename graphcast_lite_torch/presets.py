"""Experiment presets of the flagship InteractionNet model (the counterpart
of ``graphcast_lite_tpu.presets`` for the configurations this package
runs).  Each returns an ExperimentConfig; grids/graphs are built
separately with ``build_graph_set``.
"""

from __future__ import annotations

import numpy as np

from .config import (
    DataConfig,
    ExperimentConfig,
    GraphBlock,
    GraphBuildingConfig,
    GraphLayerType,
    Grid2MeshEdgeCreation,
    Mesh2GridEdgeCreation,
    MLPBlock,
    ModelConfig,
    PipelineConfig,
)

__all__ = [
    "wb2_64x32_grid",
    "wb2_512x256_grid",
    "interaction_net_512x256",
    "interaction_net_64x32",
]


def wb2_64x32_grid():
    """WB2 5.625°: 64 lon × 32 lat axes (lat values exclude the poles)."""
    lat = np.linspace(-87.1875, 87.1875, 32).astype(np.float32)
    lon = np.arange(0.0, 360.0, 5.625).astype(np.float32)
    return lat, lon


def wb2_512x256_grid():
    """0.7° global grid: 512 lon × 256 lat."""
    lat = np.linspace(-89.6484375, 89.6484375, 256).astype(np.float32)
    lon = np.arange(0.0, 360.0, 0.703125).astype(np.float32)
    return lat, lon


def _graph_cfg(mesh_levels, radius=0.6):
    return GraphBuildingConfig(
        grid2mesh_edge_creation=Grid2MeshEdgeCreation.RADIUS,
        grid2mesh_radius_query=radius,
        mesh_levels=mesh_levels,
        mesh2grid_edge_creation=Mesh2GridEdgeCreation.CONTAINED,
    )


def _data_cfg(n_feat, obs, pred, name="wb2"):
    return DataConfig(
        dataset_name=name, num_features_used=n_feat, obs_window_used=obs,
        pred_window_used=pred, want_feats_flattened=True,
    )


def _interaction_pipeline(n_feat, hidden, mp_steps):
    return PipelineConfig(
        encoder=ModelConfig(
            mlp=MLPBlock(mlp_hidden_dims=[2 * hidden], output_dim=hidden,
                         use_layer_norm=True, layer_norm_mode="node"),
            gcn=GraphBlock(layer_type=GraphLayerType.ConvGCN,
                           hidden_dims=[hidden], output_dim=hidden,
                           use_layer_norm=False),
        ),
        processor=ModelConfig(
            gcn=GraphBlock(layer_type=GraphLayerType.InteractionNet,
                           output_dim=hidden,
                           num_message_passing_steps=mp_steps,
                           edge_feature_dim=4, activation="swish",
                           use_layer_norm=True),
        ),
        decoder=ModelConfig(
            mlp=MLPBlock(mlp_hidden_dims=[2 * hidden], output_dim=hidden,
                         use_layer_norm=False),
            gcn=GraphBlock(layer_type=GraphLayerType.ConvGCN,
                           hidden_dims=[hidden], output_dim=n_feat,
                           use_layer_norm=False),
        ),
    )


def interaction_net_512x256(n_feat=19, obs=2, pred=4, hidden=256,
                            mp_steps=12) -> ExperimentConfig:
    """The flagship 'freeze6-class' model: hidden 256, 12 MP steps, AR=4 —
    the wb2_512x256_19f_ar_v2 configuration (~5.9M params)."""
    return ExperimentConfig(
        learning_rate=3e-4,
        graph=_graph_cfg([4, 6]),
        pipeline=_interaction_pipeline(n_feat, hidden, mp_steps),
        data=_data_cfg(n_feat, obs, pred),
        max_ar_steps=pred,
        static_channels=[8, 7],   # lsm, z_surf in the canonical 19-var order
        use_residual=True,
    )


def interaction_net_64x32(n_feat=33, obs=2, pred=4, hidden=256,
                          mp_steps=12) -> ExperimentConfig:
    """Flagship architecture on the 64x32 benchmark grid."""
    cfg = interaction_net_512x256(n_feat, obs, pred, hidden, mp_steps)
    cfg.graph = _graph_cfg([3, 5])
    cfg.static_channels = []
    return cfg
