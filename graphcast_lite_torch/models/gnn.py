"""Graph neural-network layers on static padded graphs (torch counterpart
of ``graphcast_lite_tpu.models.gnn`` for the flagship path).

* ``GCNConv`` ~ PyG GCNConv: symmetric normalization with implicit self
  loops, handled analytically (a per-node term added after aggregation).
  Static-norm branch: the normalizer and degree are host precomputes.
* ``InteractionNetProcessor`` ~ the GraphCast-style processor: a raw-edge
  encoder, then N unshared interaction steps in a plain Python loop, each
  a lazy-LN step (``_LazyINLayer``).

The lazy-LN step takes the reference's routes, picked by its own switches
with its defaults, read when the step is called:

* ``GCLT_REG_EDGE`` (default on): the constant-degree RegularBlocks layout
  where the graph has one; otherwise, or with ``GCLT_REG_EDGE=0``, the
  receiver-sorted COO layout, where
* ``GCLT_EDGE_STEP=1`` runs the whole edge side in the fused edge-step
  kernel (``ops.edge_step``);
* else ``GCLT_MEGA_EDGE=1`` fuses the second edge-MLP layer with the
  aggregation (``ops.edge_mlp``);
* else the composed route aggregates through the segment-sum kernel.

Not ported yet (they raise): the masked GCN branch and the GAT family
(ROADMAP A8), runtime edge masks and the non-lazy InteractionNetLayer.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
from torch import nn

from ..graphs.structure import Graph
from ..ops import edge_mlp, edge_step
from ..ops import segment as seg_ops
from ..ops.gather import gather_rows
from ..ops.reg_edge import RegStatic, reg_edge_tail
from .nn import PReLU, PyGLayerNorm, TorchLinear, glorot_uniform_pyg, \
    resolve_activation

__all__ = ["GCNConv", "InteractionNetProcessor"]

_OFF = ("0", "false", "off")


class GCNConv(nn.Module):
    """PyG-parity GCN convolution with implicit self loops.

    out = D^{-1/2} (A + I) D^{-1/2} X W + b, where D is the in-degree
    (+1 for the self loop) computed over the *receiver* side, and a sender's
    normalizer looks up the same degree array (PyG gcn_norm semantics).
    """

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel = nn.Parameter(
            glorot_uniform_pyg((in_features, features), generator)
        )
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor, graph: Graph,
                edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if graph.num_receivers != graph.num_nodes:
            raise ValueError("GCNConv expects the unified node-space "
                             "convention")
        if edge_mask is not None:
            raise NotImplementedError(
                "GCNConv under a runtime edge mask is not ported yet "
                "(ROADMAP A8: remaining layer families)"
            )
        xw = x @ self.kernel
        deg = graph.static_in_degree + 1.0
        msgs = xw.index_select(0, graph.senders) * graph.gcn_norm[:, None]
        agg = seg_ops.aggregate_sum(msgs, graph)
        # Implicit self loop: norm_ii = 1/deg_i.
        out = agg + xw / deg[:, None]
        return out + self.bias if self.bias is not None else out


class _TwoLayerMLP(nn.Module):
    """Linear -> act -> Linear (children ``lin_0``, ``act``, ``lin_1``)."""

    def __init__(self, in_features: int, hidden: int, out: int,
                 activation: str = "swish",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.lin_0 = TorchLinear(in_features, hidden, generator=generator)
        self._act = resolve_activation(activation)
        self.act = PReLU() if self._act is None else None
        self.lin_1 = TorchLinear(hidden, out, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.lin_0(x)
        x = self.act(x) if self._act is None else self._act(x)
        return self.lin_1(x)


def _use_reg_blocks(graph: Graph, edge_mask) -> bool:
    """The RegularBlocks layout where the graph has one and no runtime mask
    overrides the static one; ``GCLT_REG_EDGE=0`` turns it off."""
    if graph.reg_blocks is None or edge_mask is not None:
        return False
    return os.environ.get("GCLT_REG_EDGE", "1") not in _OFF


def _use_edge_step_path(graph: Graph, hidden_dim: int, edge_dim: int,
                        activation: str) -> bool:
    """The fused edge-step kernel: only with ``GCLT_EDGE_STEP=1`` (off by
    default, as in the reference) and where the kernel takes the shapes."""
    flag = os.environ.get("GCLT_EDGE_STEP")
    return (flag is not None and flag not in _OFF
            and edge_step.eligible(graph.padded_num_edges, hidden_dim,
                                   edge_dim, activation))


def _use_mega_edge_path(graph: Graph, hidden_dim: int, edge_dim: int,
                        activation: str) -> bool:
    """The edge-MLP segment kernel: only with ``GCLT_MEGA_EDGE=1``, and on
    the reference's structural conditions (16,384 real edges or more, a
    unified node space, a full receiver band).  The port sends every
    segment sum through its kernel, so the reference's segment-kernel
    condition always holds here."""
    if os.environ.get("GCLT_MEGA_EDGE", "0") in _OFF:
        return False
    return (edge_mlp.supports(hidden_dim, edge_dim, activation)
            and graph.num_edges >= 16384
            and graph.num_receivers == graph.num_nodes
            and graph.full_receiver_band)


class _LazyINLayer(nn.Module):
    """One InteractionNet step with the edge LayerNorm applied LAZILY.

    The step carries the PRE-norm edge state ``v`` plus the per-feature
    affine ``(a, c)`` of the previous step's LN:

        e_t   = a ∘ v + c                       (never materialized)
        h_pre = xs[s] + xr[r] + v @ (a[:,None]·W1e) + (b1 + c@W1e)
        v'    = e_t + u = a ∘ v + c + u
        (μ, σ) = masked graph-mode stats of v'   (fp32)
        a', c' = γ/σ,  β − γμ/σ

    Each route keeps the reference's own variance formula: E[v²] − μ²
    clamped at 0 on the reg-block and edge-step routes, E[(v − μ)²] on the
    composed and mega routes.  ``route`` records the route the last call
    took.  Call: (x, v, a, c) -> (x', v', a', c').
    """

    def __init__(self, node_dim: int, edge_dim: int, hidden_dim: int,
                 activation: str = "swish",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.node_dim, self.edge_dim = node_dim, edge_dim
        self.hidden_dim = hidden_dim
        self.activation = activation
        self.route: Optional[str] = None
        self.edge_mlp = nn.Module()
        self.edge_mlp.lin_0 = TorchLinear(2 * node_dim + edge_dim,
                                          hidden_dim, generator=generator)
        self.edge_mlp.lin_1 = TorchLinear(hidden_dim, edge_dim,
                                          generator=generator)
        self.node_mlp = _TwoLayerMLP(node_dim + edge_dim, hidden_dim,
                                     node_dim, activation,
                                     generator=generator)
        self.edge_norm = PyGLayerNorm(edge_dim, mode="graph")
        self.node_norm = PyGLayerNorm(node_dim, mode="node")

    def _node_step(self, x, agg_sum, graph: Graph):
        deg = seg_ops.masked_in_degree(graph)
        agg = agg_sum / deg.clamp(min=1.0)[:, None].to(agg_sum.dtype)
        node_update = self.node_mlp(torch.cat([x, agg], dim=-1))
        return self.node_norm(x + node_update)

    def _affine(self, mu, var):
        """The next step's (a, c) from the masked stats (fp32)."""
        inv_sigma = torch.rsqrt(var + 1e-5)
        gamma = self.edge_norm.weight.float()
        beta = self.edge_norm.bias.float()
        return gamma * inv_sigma, beta - gamma * mu * inv_sigma

    def forward(self, x, v, a, c, graph: Graph):
        d, de, hid = self.node_dim, self.edge_dim, self.hidden_dim
        k0, b0 = self.edge_mlp.lin_0.kernel, self.edge_mlp.lin_0.bias
        k1, b1 = self.edge_mlp.lin_1.kernel, self.edge_mlp.lin_1.bias
        w1s, w1r, w1e = k0[:d], k0[d:2 * d], k0[2 * d:]
        w1e_eff = a[:, None].to(w1e.dtype) * w1e
        b1_eff = b0 + c.to(w1e.dtype) @ w1e

        rb = graph.reg_blocks
        if _use_reg_blocks(graph, None) and v.shape[0] == rb.rows_padded:
            self.route = "reg_block"
            static = RegStatic(block_recv=rb.block_recv, block_k=rb.block_k,
                               num_nodes=graph.num_receivers,
                               activation=self.activation)
            u, agg_sum = reg_edge_tail(
                static, x, v, rb.mask.to(x.dtype), rb.senders,
                w1s, w1r, w1e_eff, b1_eff, k1, b1,
            )
            new_x = self._node_step(x, agg_sum, graph)
            # Lazy-LN residual + masked graph-mode stats (pad rows carry u
            # but are mask-excluded; their values are never read).
            v_new = a.to(v.dtype)[None, :] * v + c.to(v.dtype) + u
            w = rb.mask.float()[:, None]
            vf = v_new.float()
            denom = torch.clamp(w.sum() * de, min=1.0)
            mu = (vf * w).sum() / denom
            var = torch.clamp((torch.square(vf) * w).sum() / denom
                              - torch.square(mu), min=0.0)
            return (new_x, v_new) + self._affine(mu, var)

        mask = graph.edge_mask
        if _use_edge_step_path(graph, hid, de, self.activation):
            # The whole edge side in one kernel; only the sender gather and
            # the two node projections stay outside.
            self.route = "edge_step"
            xsg = gather_rows(x @ w1s, graph.senders)
            v_new, agg_sum, stats = edge_step.edge_step(
                xsg, v, x @ w1r, w1e_eff, b1_eff, k1, b1, a.float(),
                c.float(), mask, graph.indptr, graph.num_receivers,
                self.activation,
            )
            new_x = self._node_step(x, agg_sum, graph)
            denom = torch.clamp(stats[2] * de, min=1.0)
            mu = stats[0] / denom
            var = torch.clamp(stats[1] / denom - torch.square(mu), min=0.0)
            return (new_x, v_new) + self._affine(mu, var)

        h = (gather_rows(x @ w1s, graph.senders)
             + gather_rows(x @ w1r, graph.receivers)
             + v @ w1e_eff + b1_eff)
        if _use_mega_edge_path(graph, hid, de, self.activation):
            self.route = "mega"
            u, agg_sum = edge_mlp.edge_mlp(h, k1, b1, mask, graph.indptr,
                                           graph.num_receivers,
                                           self.activation)
        else:
            self.route = "composed"
            u = resolve_activation(self.activation)(h) @ k1 + b1
            agg_sum = seg_ops.aggregate_sum(u, graph, mask)
        new_x = self._node_step(x, agg_sum, graph)
        # Residual in the pre-norm space + masked graph-mode stats (fp32,
        # PyGLayerNorm semantics: scalar mean/var over masked elements).
        v_new = a.to(v.dtype)[None, :] * v + c.to(v.dtype) + u
        vf = v_new.float()
        w = mask.float()[:, None]
        denom = torch.clamp(w.sum() * de, min=1.0)
        mu = (vf * w).sum() / denom
        var = (torch.square(vf - mu) * w).sum() / denom
        return (new_x, v_new) + self._affine(mu, var)


class InteractionNetProcessor(nn.Module):
    """N unshared-weight interaction steps + raw-edge encoder.

    Children: ``edge_encoder_lin`` (and ``edge_encoder_act`` for PReLU) and
    ``steps`` (one ``_LazyINLayer`` per step; the JAX package stacks their
    parameters on axis 0 under ``nn.scan``)."""

    def __init__(self, node_dim: int, raw_edge_dim: int,
                 edge_latent_dim: int, hidden_dim: int, num_steps: int,
                 activation: str = "swish", use_layer_norm: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        try:
            stateless = resolve_activation(activation) is not None
        except ValueError:
            stateless = False
        if not (use_layer_norm and stateless):
            raise NotImplementedError(
                "the non-lazy InteractionNetLayer (no edge LayerNorm, or a "
                "PReLU activation) is not ported yet (see ROADMAP)"
            )
        self.edge_latent_dim = edge_latent_dim
        self._act = resolve_activation(activation)
        self.edge_encoder_lin = TorchLinear(raw_edge_dim, edge_latent_dim,
                                            generator=generator)
        self.steps = nn.ModuleList(
            _LazyINLayer(node_dim, edge_latent_dim, hidden_dim, activation,
                         generator=generator)
            for _ in range(num_steps)
        )

    def forward(self, x: torch.Tensor, graph: Graph,
                edge_attr_raw: Optional[torch.Tensor] = None,
                edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if edge_mask is not None:
            raise NotImplementedError(
                "the processor under a runtime edge mask is not ported yet "
                "(ROADMAP A8: remaining layer families)"
            )
        raw = edge_attr_raw if edge_attr_raw is not None else graph.edge_attr
        if edge_attr_raw is None and _use_reg_blocks(graph, edge_mask):
            # The reg-block steps run the block row order: the edge carrier
            # starts in that order too.
            raw = graph.reg_blocks.edge_attr
        e = self._act(self.edge_encoder_lin(raw))
        a = torch.ones(self.edge_latent_dim, dtype=torch.float32,
                       device=x.device)
        c = torch.zeros(self.edge_latent_dim, dtype=torch.float32,
                        device=x.device)
        for step in self.steps:
            x, e, a, c = step(x, e, a, c, graph)
        return x
