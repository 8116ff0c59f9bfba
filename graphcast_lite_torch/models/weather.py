"""The flagship encode-process-decode weather model (torch counterpart of
``graphcast_lite_tpu.models.weather``).

Forward, on one sample or a batch:

    out, mask = model(x_grid, graphs, mask, attention_threshold, prune)
                                           # x_grid [G, obs·F] -> [G, C_out]
                                           # or [B, G, obs·F] -> [B, G, C_out]

A batch is B samples in one call, each computed as the single-sample
model computes it (the JAX package's ``jax.vmap`` of its model): the
graphs, the parameters and the edge mask are shared, and each sample keeps
its own graph-mode LayerNorm statistics.

SparseGAT's edge pruning is an explicit processing-edge mask carried
through the call and returned updated (only SparseGAT changes it).  With a
product graph, a small GNN over the (T x N)-node temporal product graph
runs first on the time-major window and keeps its last time slice.

A grad-enabled call runs under the train step's memory policies
(``models.remat``): ``GCLT_ENCDEC_REMAT`` checkpoints the encoder and the
decoder, ``GCLT_SCAN_REMAT`` each processor step.

Module and parameter names follow the JAX package's flax tree
(``encoder`` / ``processor`` / ``decoder``, each with ``mlp`` and
``graph_layer``), so its parameters load through
``utils.params.from_flax_params``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from .. import tracing
from ..config import DataConfig, GraphBlock, GraphLayerType, ModelConfig, \
    PipelineConfig
from ..graphs.build import GraphSet
from ..graphs.product import build_product_graph_edges
from ..graphs.structure import Graph, build_graph
from .gnn import GATConv, GCNConv, InteractionNetProcessor, SimpleConv, \
    SparseGATConv
from .nn import MLPTower, PReLU, PyGLayerNorm, resolve_activation
from .remat import checkpointed, encdec_remat

__all__ = ["ModelGraphs", "WeatherModel", "graph_layer_output_dim",
           "model_output_dim"]

# Static per-node features concatenated to the grid input (graphs.build).
STATIC_NODE_FEATURES = 6


@dataclasses.dataclass
class ModelGraphs:
    """The static graph bundle the model consumes."""

    encoding: Graph
    processing: Graph
    decoding: Graph
    grid_static: torch.Tensor   # [N, 6]
    mesh_static: torch.Tensor   # [M, 6]
    product: Optional[Graph] = None   # temporal product graph over T·N
    num_grid_nodes: int = 0
    num_mesh_nodes: int = 0

    @classmethod
    def from_graph_set(cls, gs: GraphSet, product_config=None,
                       obs_window: int = 1) -> "ModelGraphs":
        """The bundle of ``gs``; with a ``ProductGraphConfig`` also the
        product graph over ``obs_window`` frames of the grid (no ELL
        table, as the JAX package builds it)."""
        product = None
        if product_config is not None:
            ps, pr = build_product_graph_edges(
                np.unique(gs.grid_lat), np.unique(gs.grid_lon), obs_window,
                product_config.num_k, product_config.type)
            product = build_graph(ps, pr,
                                  num_nodes=gs.num_grid_nodes * obs_window)
        return cls(
            encoding=gs.encoding,
            processing=gs.processing,
            decoding=gs.decoding,
            grid_static=torch.from_numpy(np.asarray(gs.grid_static,
                                                    np.float32)),
            mesh_static=torch.from_numpy(np.asarray(gs.mesh_static,
                                                    np.float32)),
            product=product,
            num_grid_nodes=gs.num_grid_nodes,
            num_mesh_nodes=gs.num_mesh_nodes,
        )

    def to(self, device=None, float_dtype=None) -> "ModelGraphs":
        """Copy onto ``device``; float arrays cast to ``float_dtype``."""
        def mv(t):
            return t.to(device=device, dtype=float_dtype or t.dtype)

        return dataclasses.replace(
            self,
            encoding=self.encoding.to(device, float_dtype),
            processing=self.processing.to(device, float_dtype),
            decoding=self.decoding.to(device, float_dtype),
            grid_static=mv(self.grid_static),
            mesh_static=mv(self.mesh_static),
            product=(self.product.to(device, float_dtype)
                     if self.product is not None else None),
        )


def graph_layer_output_dim(cfg: GraphBlock, input_dim: int) -> int:
    if cfg.layer_type == GraphLayerType.SimpleConv:
        return input_dim
    return int(cfg.output_dim)


def model_output_dim(cfg: ModelConfig, input_dim: int) -> int:
    gl_in = cfg.mlp.output_dim if cfg.mlp is not None else input_dim
    return graph_layer_output_dim(cfg.gcn, gl_in)


class GraphLayerModule(nn.Module):
    """Dispatcher over graph-layer types: (x, graph, edge_mask,
    attention_threshold, prune) -> (x, edge_mask').  Only SparseGAT ever
    changes the mask."""

    def __init__(self, cfg: GraphBlock, input_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.layer_type = lt = cfg.layer_type
        self.norm = None
        self.act = None
        if lt == GraphLayerType.SimpleConv:
            self.conv = SimpleConv()
        elif lt in (GraphLayerType.ConvGCN, GraphLayerType.GATConv):
            dims = [input_dim] + list(cfg.hidden_dims or []) \
                + [int(cfg.output_dim)]
            self.num_convs = len(dims) - 1
            for i in range(self.num_convs):
                if lt == GraphLayerType.ConvGCN:
                    conv = GCNConv(dims[i], dims[i + 1], generator=generator)
                else:
                    conv = GATConv(dims[i], dims[i + 1],
                                   heads=cfg.gat_props.num_heads,
                                   generator=generator)
                setattr(self, f"conv_{i}", conv)
            self._act = resolve_activation(cfg.activation)
            # The reference shares ONE activation module across the stack.
            self.act = PReLU() if self._act is None else None
        elif lt == GraphLayerType.SparseGATConv:
            self.conv_0 = SparseGATConv(input_dim, int(cfg.output_dim),
                                        heads=cfg.gat_props.num_heads,
                                        generator=generator)
        elif lt == GraphLayerType.InteractionNet:
            if int(cfg.output_dim) != input_dim:
                raise ValueError("InteractionNet requires output_dim == "
                                 "input_dim (residuals)")
            use_ln = cfg.use_layer_norm if cfg.use_layer_norm is not None \
                else True
            self.inet = InteractionNetProcessor(
                node_dim=input_dim,
                raw_edge_dim=cfg.edge_feature_dim or 4,
                edge_latent_dim=input_dim,
                hidden_dim=input_dim,
                num_steps=cfg.num_message_passing_steps or 4,
                activation=cfg.activation or "swish",
                use_layer_norm=use_ln,
                generator=generator,
            )
        else:
            raise NotImplementedError(f"layer type {lt} is not supported")
        if cfg.use_layer_norm and lt in (GraphLayerType.ConvGCN,
                                         GraphLayerType.GATConv,
                                         GraphLayerType.SparseGATConv):
            self.norm = PyGLayerNorm(int(cfg.output_dim),
                                     cfg.layer_norm_mode or "node")

    def forward(self, x: torch.Tensor, graph: Graph,
                edge_mask: Optional[torch.Tensor] = None,
                attention_threshold=0.0, prune: bool = False):
        lt = self.layer_type
        if lt == GraphLayerType.SimpleConv:
            return self.conv(x, graph, edge_mask), edge_mask
        if lt == GraphLayerType.InteractionNet:
            return self.inet(x, graph, edge_mask=edge_mask), edge_mask
        if lt == GraphLayerType.SparseGATConv:
            x, edge_mask = self.conv_0(x, graph, edge_mask,
                                       attention_threshold, prune)
        else:
            for i in range(self.num_convs):
                x = getattr(self, f"conv_{i}")(x, graph, edge_mask)
                if i < self.num_convs - 1:
                    x = self.act(x) if self._act is None else self._act(x)
        if self.norm is not None:
            x = self.norm(x)
        return x, edge_mask


class ModelBlock(nn.Module):
    """(optional MLP) -> GraphLayer."""

    def __init__(self, cfg: ModelConfig, input_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gl_in = input_dim
        self.mlp = None
        if cfg.mlp is not None:
            self.mlp = MLPTower(
                input_dim, cfg.mlp.mlp_hidden_dims, cfg.mlp.output_dim,
                use_layer_norm=cfg.mlp.use_layer_norm,
                layer_norm_mode=cfg.mlp.layer_norm_mode,
                generator=generator,
            )
            gl_in = cfg.mlp.output_dim
        self.graph_layer = GraphLayerModule(cfg.gcn, gl_in,
                                            generator=generator)

    def forward(self, x, graph: Graph, edge_mask=None,
                attention_threshold=0.0, prune: bool = False):
        if self.mlp is not None:
            x = self.mlp(x)
        return self.graph_layer(x, graph, edge_mask, attention_threshold,
                                prune)


class WeatherModel(nn.Module):
    """Encode-process-decode over grid + icosahedral multi-mesh, with the
    optional product-graph temporal pre-encoder (``product_model``).

    Returns (grid_prediction [N, C_out], processing-edge mask); with
    ``with_latents`` also the encoder grid latents and the processed mesh
    latents.  A leading batch axis on ``x_grid`` runs B samples in one
    call; SparseGAT's returned mask is then sample 0's.
    """

    def __init__(self, pipeline: PipelineConfig, data: DataConfig,
                 num_grid_nodes: int, num_mesh_nodes: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_grid_nodes = num_grid_nodes
        self.num_mesh_nodes = num_mesh_nodes
        self.obs_window = data.obs_window_used
        self.num_features = feats = data.num_features_used
        self.product_model = None
        if pipeline.product_graph is not None:
            self.product_model = ModelBlock(pipeline.product_graph.model,
                                            feats, generator)
            enc_in = feats + STATIC_NODE_FEATURES
        else:
            enc_in = feats * data.obs_window_used + STATIC_NODE_FEATURES
        proc_in = model_output_dim(pipeline.encoder, enc_in)
        dec_in = model_output_dim(pipeline.processor, proc_in)
        # Width of the encoder's grid latents (``with_latents``).
        self.latent_dim = proc_in
        self.encoder = ModelBlock(pipeline.encoder, enc_in, generator)
        self.processor = ModelBlock(pipeline.processor, proc_in, generator)
        self.decoder = ModelBlock(pipeline.decoder, dec_in, generator)

    def forward(self, x_grid: torch.Tensor, graphs: ModelGraphs,
                processing_edge_mask: Optional[torch.Tensor] = None,
                attention_threshold=0.0, prune: bool = False,
                with_latents: bool = False):
        """Inside a ``model`` span, each block inside its own
        (``model.encoder``, ``model.processor``, ``model.decoder``;
        ``tracing``)."""
        with tracing.span("model"):
            return self._forward(x_grid, graphs, processing_edge_mask,
                                 attention_threshold, prune, with_latents)

    def _forward(self, x_grid, graphs, processing_edge_mask,
                 attention_threshold, prune, with_latents):
        n_grid = self.num_grid_nodes
        lead = x_grid.shape[:-2]  # () or (B,)
        if self.product_model is not None:
            # Time-major window over the T x N product graph, per sample;
            # keep the last time slice.
            obs, feats = self.obs_window, self.num_features
            xt = x_grid.reshape(lead + (n_grid, obs, feats)) \
                .transpose(-3, -2).reshape(lead + (obs * n_grid, feats))
            xt, _ = self.product_model(xt, graphs.product)
            x_grid = xt[..., -n_grid:, :]
        # Static features; zero dynamic state for mesh nodes; concat.
        grid_static = graphs.grid_static.expand(
            lead + graphs.grid_static.shape)
        mesh_static = graphs.mesh_static.expand(
            lead + graphs.mesh_static.shape)
        grid_in = torch.cat([x_grid, grid_static], dim=-1)
        mesh_dyn = x_grid.new_zeros(lead + (self.num_mesh_nodes,
                                            x_grid.shape[-1]))
        mesh_in = torch.cat([mesh_dyn, mesh_static], dim=-1)
        x = torch.cat([grid_in, mesh_in], dim=-2)       # [..., (N+M), C]

        # With grad enabled and GCLT_ENCDEC_REMAT on, the encoder and the
        # decoder keep only their inputs for the backward and recompute
        # the rest (``models.remat``); the product pre-encoder and the
        # processor (``GCLT_SCAN_REMAT``) are not wrapped by it.
        remat = torch.is_grad_enabled() and encdec_remat()

        def block(module, *args):
            return checkpointed(module, module, *args) if remat \
                else module(*args)

        with tracing.span("model.encoder"):
            x, _ = block(self.encoder, x, graphs.encoding)
        grid_latent = x[..., :n_grid, :]
        mesh_latent = x[..., n_grid:, :]

        with tracing.span("model.processor"):
            mesh_processed, new_mask = self.processor(
                mesh_latent, graphs.processing, processing_edge_mask,
                attention_threshold, prune,
            )

        combined = torch.cat([grid_latent, mesh_processed], dim=-2)
        with tracing.span("model.decoder"):
            decoded, _ = block(self.decoder, combined, graphs.decoding)
        out = decoded[..., :n_grid, :]
        if with_latents:
            return out, new_mask, grid_latent, mesh_processed
        return out, new_mask
