"""Create a self-contained demo experiment (synthetic data + config.json).

A synthetic advecting-wave dataset in the chunked on-disk format, next to
a config.json in the JAX package's schema (the same config and the same
data files as ``graphcast_lite_tpu.cli.make_demo`` writes), ready for
``cli.train`` / ``cli.predict``, for every ``--processor``.

Usage: python -m graphcast_lite_torch.cli.make_demo <dir> [--size small|medium]
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("out_dir")
    parser.add_argument("--size", choices=["small", "medium"], default="small")
    parser.add_argument("--processor", default="interaction_net",
                        choices=["conv_gcn", "conv_gat", "sparse_gat",
                                 "interaction_net", "simple_conv"])
    args = parser.parse_args(argv)

    from ..config import (
        DataConfig, ExperimentConfig, GATProps, GraphBlock,
        GraphBuildingConfig, GraphLayerType, Grid2MeshEdgeCreation,
        Mesh2GridEdgeCreation, MLPBlock, ModelConfig, PipelineConfig,
        to_dict,
    )
    from ..data.synthetic import generate_synthetic_dataset

    if args.size == "small":
        n_lon, n_lat, n_time, n_feat, hidden, levels = 32, 16, 60, 6, 32, [1, 2]
    else:
        n_lon, n_lat, n_time, n_feat, hidden, levels = 64, 32, 120, 8, 64, [2, 3]

    os.makedirs(args.out_dir, exist_ok=True)
    data_dir = os.path.join(args.out_dir, "data")
    static, forcing = [n_feat - 2], [n_feat - 1]
    generate_synthetic_dataset(
        data_dir, n_time=n_time, n_lon=n_lon, n_lat=n_lat, n_feat=n_feat,
        static_channels=static, forcing_channels=forcing,
    )

    lt = GraphLayerType(args.processor)
    if lt == GraphLayerType.InteractionNet:
        proc = GraphBlock(layer_type=lt, output_dim=hidden,
                          num_message_passing_steps=4, edge_feature_dim=4,
                          activation="swish", use_layer_norm=True)
    elif lt in (GraphLayerType.GATConv, GraphLayerType.SparseGATConv):
        proc = GraphBlock(layer_type=lt, hidden_dims=[hidden],
                          output_dim=hidden,
                          gat_props=GATProps(num_heads=2,
                                             sparsity_thresholds=[0.1356]))
    elif lt == GraphLayerType.SimpleConv:
        proc = GraphBlock(layer_type=lt)
    else:
        proc = GraphBlock(layer_type=lt, hidden_dims=[hidden, hidden],
                          output_dim=hidden)

    cfg = ExperimentConfig(
        batch_size=2,
        learning_rate=1e-3,
        num_epochs=10,
        max_ar_steps=2,
        early_stopping_patience=10,
        static_channels=static,
        forcing_channels=forcing,
        data_dir=data_dir,
        graph=GraphBuildingConfig(
            grid2mesh_edge_creation=Grid2MeshEdgeCreation.RADIUS,
            grid2mesh_radius_query=0.6,
            mesh_levels=levels,
            mesh2grid_edge_creation=Mesh2GridEdgeCreation.CONTAINED,
        ),
        pipeline=PipelineConfig(
            encoder=ModelConfig(
                mlp=MLPBlock(mlp_hidden_dims=[2 * hidden], output_dim=hidden,
                             use_layer_norm=True, layer_norm_mode="node"),
                gcn=GraphBlock(layer_type=GraphLayerType.ConvGCN,
                               hidden_dims=[hidden], output_dim=hidden),
            ),
            processor=ModelConfig(gcn=proc),
            decoder=ModelConfig(
                mlp=MLPBlock(mlp_hidden_dims=[2 * hidden], output_dim=hidden,
                             use_layer_norm=False),
                gcn=GraphBlock(layer_type=GraphLayerType.ConvGCN,
                               hidden_dims=[hidden], output_dim=n_feat),
            ),
        ),
        data=DataConfig(dataset_name="synthetic_demo",
                        num_features_used=n_feat, obs_window_used=2,
                        pred_window_used=2, want_feats_flattened=True),
    )
    with open(os.path.join(args.out_dir, "config.json"), "w") as f:
        json.dump(to_dict(cfg), f, indent=1)
    print(f"[make_demo] experiment ready at {args.out_dir} "
          f"(grid {n_lon}x{n_lat}, {n_feat} features, processor {args.processor})")


if __name__ == "__main__":
    main()
