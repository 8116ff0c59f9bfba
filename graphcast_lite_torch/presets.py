"""Experiment presets (the counterpart of ``graphcast_lite_tpu.presets``
for the configurations this package runs): the four WB2 64x32 BASELINE
families (GCN, GAT, SparseGAT, product graph) and the flagship
InteractionNet model.  Each returns an ExperimentConfig; grids/graphs are
built separately with ``build_graph_set``.
"""

from __future__ import annotations

import numpy as np

from .config import (
    DataConfig,
    ExperimentConfig,
    GATProps,
    GraphBlock,
    GraphBuildingConfig,
    GraphLayerType,
    Grid2MeshEdgeCreation,
    Mesh2GridEdgeCreation,
    MLPBlock,
    ModelConfig,
    PipelineConfig,
    ProductGraphConfig,
    ProductGraphType,
)

__all__ = [
    "wb2_64x32_grid",
    "wb2_512x256_grid",
    "baseline_gcn_64x32",
    "gat_64x32",
    "sparse_gat_64x32",
    "product_graph_64x32",
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


def baseline_gcn_64x32(n_feat=33, obs=2, pred=1,
                       hidden=64) -> ExperimentConfig:
    """Baseline encode-process-decode GCN (WB2 64x32, 33 features, P=1)."""
    return ExperimentConfig(
        learning_rate=1e-4,
        graph=_graph_cfg([3, 5]),
        pipeline=PipelineConfig(
            encoder=ModelConfig(
                mlp=MLPBlock(mlp_hidden_dims=[2 * hidden], output_dim=hidden,
                             use_layer_norm=True, layer_norm_mode="node"),
                gcn=GraphBlock(layer_type=GraphLayerType.ConvGCN,
                               hidden_dims=[hidden], output_dim=hidden,
                               use_layer_norm=False),
            ),
            processor=ModelConfig(
                gcn=GraphBlock(layer_type=GraphLayerType.ConvGCN,
                               hidden_dims=[hidden, hidden],
                               output_dim=hidden, use_layer_norm=False),
            ),
            decoder=ModelConfig(
                mlp=MLPBlock(mlp_hidden_dims=[2 * hidden], output_dim=hidden,
                             use_layer_norm=False),
                gcn=GraphBlock(layer_type=GraphLayerType.ConvGCN,
                               hidden_dims=[hidden], output_dim=n_feat,
                               use_layer_norm=False),
            ),
        ),
        data=_data_cfg(n_feat, obs, pred),
        max_ar_steps=pred,
    )


def gat_64x32(n_feat=33, obs=2, pred=1, hidden=64,
              heads=1) -> ExperimentConfig:
    """GATConv attention processor (gcn_vs_gat, WB2 64x32);
    ``experiments/wb2_64x32_gat`` runs it at 4 heads."""
    cfg = baseline_gcn_64x32(n_feat, obs, pred, hidden)
    cfg.pipeline.processor = ModelConfig(
        gcn=GraphBlock(
            layer_type=GraphLayerType.GATConv,
            hidden_dims=[hidden], output_dim=hidden, use_layer_norm=False,
            gat_props=GATProps(num_heads=heads, sparsity_thresholds=[]),
        )
    )
    return cfg


def sparse_gat_64x32(n_feat=33, obs=2, pred=1, hidden=64,
                     heads=1) -> ExperimentConfig:
    """SparseGAT processor with scheduled edge pruning (one head, as the
    JAX package's preset, whatever ``heads``)."""
    cfg = baseline_gcn_64x32(n_feat, obs, pred, hidden)
    cfg.pipeline.processor = ModelConfig(
        gcn=GraphBlock(
            layer_type=GraphLayerType.SparseGATConv,
            output_dim=hidden, use_layer_norm=False,
            gat_props=GATProps(num_heads=1, sparsity_thresholds=[0.1356]),
        )
    )
    return cfg


def product_graph_64x32(n_feat=33, obs=5, pred=1, hidden=64,
                        num_k=4) -> ExperimentConfig:
    """Product-graph temporal GCN (O=5 observation windows)."""
    cfg = baseline_gcn_64x32(n_feat, obs, pred, hidden)
    cfg.pipeline.product_graph = ProductGraphConfig(
        model=ModelConfig(
            gcn=GraphBlock(layer_type=GraphLayerType.ConvGCN,
                           hidden_dims=[hidden], output_dim=n_feat,
                           use_layer_norm=False),
        ),
        num_k=num_k,
        self_loop=False,
        type=ProductGraphType.KRONECKER,
    )
    return cfg


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
