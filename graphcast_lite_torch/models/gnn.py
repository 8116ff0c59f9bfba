"""Graph neural-network layers on static padded graphs (torch counterpart
of ``graphcast_lite_tpu.models.gnn`` for the flagship path).

* ``GCNConv`` ~ PyG GCNConv: symmetric normalization with implicit self
  loops, handled analytically (a per-node term added after aggregation).
  Static-norm branch: the normalizer and degree are host precomputes.
* ``InteractionNetProcessor`` ~ the GraphCast-style processor: a raw-edge
  encoder, then N unshared interaction steps in a plain Python loop, each
  a lazy-LN step (``_LazyINLayer``) on the constant-degree RegularBlocks
  layout.

Not ported yet (they raise): the masked GCN branch and the GAT family
(ROADMAP A8), the COO lazy branch and the non-lazy InteractionNetLayer.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..graphs.structure import Graph
from ..ops import segment as seg_ops
from ..ops.reg_edge import RegStatic, reg_edge_tail
from .nn import PReLU, PyGLayerNorm, TorchLinear, glorot_uniform_pyg, \
    resolve_activation

__all__ = ["GCNConv", "InteractionNetProcessor"]


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


class _LazyINLayer(nn.Module):
    """One InteractionNet step with the edge LayerNorm applied LAZILY.

    The step carries the PRE-norm edge state ``v`` plus the per-feature
    affine ``(a, c)`` of the previous step's LN:

        e_t   = a ∘ v + c                       (never materialized)
        h_pre = xs[s] + xr[r] + v @ (a[:,None]·W1e) + (b1 + c@W1e)
        v'    = e_t + u = a ∘ v + c + u
        (μ, σ) = masked graph-mode stats of v'   (fp32, E[v²] − μ², ≥ 0)
        a', c' = γ/σ,  β − γμ/σ

    Reg-block branch of ``graphcast_lite_tpu.models.gnn._LazyINLayer``
    (its own variance formula, not the COO branch's E[(v−μ)²]).
    Call: (x, v, a, c) -> (x', v', a', c').
    """

    def __init__(self, node_dim: int, edge_dim: int, hidden_dim: int,
                 activation: str = "swish",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.node_dim, self.edge_dim = node_dim, edge_dim
        self.activation = activation
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

    def forward(self, x, v, a, c, graph: Graph):
        d, de = self.node_dim, self.edge_dim
        k0, b0 = self.edge_mlp.lin_0.kernel, self.edge_mlp.lin_0.bias
        k1, b1 = self.edge_mlp.lin_1.kernel, self.edge_mlp.lin_1.bias
        w1s, w1r, w1e = k0[:d], k0[d:2 * d], k0[2 * d:]
        w1e_eff = a[:, None].to(w1e.dtype) * w1e
        b1_eff = b0 + c.to(w1e.dtype) @ w1e

        rb = graph.reg_blocks
        static = RegStatic(block_recv=rb.block_recv, block_k=rb.block_k,
                           num_nodes=graph.num_receivers,
                           activation=self.activation)
        u, agg_sum = reg_edge_tail(
            static, x, v, rb.mask.to(x.dtype), rb.senders,
            w1s, w1r, w1e_eff, b1_eff, k1, b1,
        )
        deg = seg_ops.masked_in_degree(graph)
        agg = agg_sum / deg.clamp(min=1.0)[:, None].to(agg_sum.dtype)
        node_update = self.node_mlp(torch.cat([x, agg], dim=-1))
        new_x = self.node_norm(x + node_update)

        # Lazy-LN residual + masked graph-mode stats (pad rows carry u but
        # are mask-excluded; their values are never read).
        v_new = a.to(v.dtype)[None, :] * v + c.to(v.dtype) + u
        w = rb.mask.float()[:, None]
        vf = v_new.float()
        denom = torch.clamp(w.sum() * de, min=1.0)
        mu = (vf * w).sum() / denom
        var = torch.clamp((torch.square(vf) * w).sum() / denom
                          - torch.square(mu), min=0.0)
        inv_sigma = torch.rsqrt(var + 1e-5)
        gamma = self.edge_norm.weight.float()
        beta = self.edge_norm.bias.float()
        return new_x, v_new, gamma * inv_sigma, beta - gamma * mu * inv_sigma


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
        if graph.reg_blocks is None or edge_mask is not None \
                or edge_attr_raw is not None:
            raise NotImplementedError(
                "the processor runs only the RegularBlocks layout so far; "
                "the COO lazy branch is not ported yet (see ROADMAP)"
            )
        e = self._act(self.edge_encoder_lin(graph.reg_blocks.edge_attr))
        a = torch.ones(self.edge_latent_dim, dtype=torch.float32,
                       device=x.device)
        c = torch.zeros(self.edge_latent_dim, dtype=torch.float32,
                        device=x.device)
        for step in self.steps:
            x, e, a, c = step(x, e, a, c, graph)
        return x
