"""Graph neural-network layers on static padded graphs (torch counterpart
of ``graphcast_lite_tpu.models.gnn``).

* ``GCNConv`` ~ PyG GCNConv: symmetric normalization with implicit self
  loops, handled analytically (a per-node term added after aggregation).
  Without a runtime mask the normalizer and degree are host precomputes;
  under one (SparseGAT pruning) the degrees are a segment sum of the mask.
* ``GATConv`` ~ PyG GATConv(concat=False): per-head additive attention
  with LeakyReLU(0.2), a softmax over the incoming edges and the implicit
  self loop (``ops.segment.segment_softmax_coo``), head average, bias.
* ``SparseGATConv``: a GAT layer that can also return a pruned edge mask
  (mean-head α ≥ threshold) over the fixed edge superset.
* ``SimpleConv`` ~ PyG SimpleConv(aggr="mean"): neighbour mean, no weights.
* ``InteractionNetProcessor``: a raw-edge encoder, then N unshared
  ``InteractionNetLayer`` steps in a Python loop, each either the lazy-LN
  step (``InteractionNetLayer.lazy``) or the plain one
  (``InteractionNetLayer.forward``), picked as the JAX package picks them
  (``_use_lazy_processor``).

Every layer takes one route on the card, the receiver-sorted COO layout
through the segment-sum kernel: the JAX package's ELL branches
(``ops/ell.py``, taken where a graph has a neighbour table) compute the
same functions and are not ported.

The lazy-LN step takes the reference's routes, picked by its own switches
with its defaults, read when the step is called:

* ``GCLT_REG_EDGE`` (default on): the constant-degree RegularBlocks layout
  where the graph has one and no runtime mask overrides the static one;
  otherwise, or with ``GCLT_REG_EDGE=0``, the receiver-sorted COO layout,
  where
* ``GCLT_EDGE_STEP=1`` runs the whole edge side in the fused edge-step
  kernel (``ops.edge_step``);
* else ``GCLT_MEGA_EDGE=1`` fuses the second edge-MLP layer with the
  aggregation (``ops.edge_mlp``);
* else the composed route aggregates through the segment-sum kernel.

The plain step splits the first edge-MLP layer by input block (the
reference's ``_SplitEdgeMLP``) and, with ``GCLT_MEGA_EDGE=1``, runs the
second layer and the aggregation in the edge-MLP kernel (its
``_MegaEdgeMLP``).

The two fused kernels are forward only: inside ``ops.fused_edge.
training_trace()`` (set by ``training.rollout.rollout_loss``) both
switches are ignored, as in the JAX package.  There, on the reference's
conditions (``_use_fused_edge_path``: 131,072 real edges or more, both
widths multiples of 128, a stateless activation, a unified node space),
the plain step and the lazy COO step train through the fused edge unit
(``ops.fused_edge.edge_pipeline``, the reference's ``_FusedEdgeMLP``:
its backward scatters through the segment-sum kernel, and under
``GCLT_MEGA_EDGE=1`` its forward tail is the edge-MLP kernel); below
them the COO layout takes the composed route.  ``GCNConv`` aggregates
through ``ops.gcn_agg.gcn_aggregate`` where ``GCLT_GCN_AGG=1`` opts in
(``supports_gcn_aggregate``).  Every row gather passes its index's sorted
CSR to ``ops.gather.gather_rows``, so its adjoint is the segment-sum
kernel.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..graphs.structure import Graph
from ..ops import edge_mlp, edge_step
from ..ops import segment as seg_ops
from ..ops.fused_edge import edge_pipeline, in_training, use_fused_edge
from ..ops.gcn_agg import gcn_aggregate, supports_gcn_aggregate
from ..ops.gather import gather_rows
from ..ops.reg_edge import RegStatic, reg_edge_tail
from .nn import PReLU, PyGLayerNorm, TorchLinear, glorot_uniform_pyg, \
    resolve_activation

__all__ = ["GCNConv", "GATConv", "SparseGATConv", "SimpleConv",
           "InteractionNetLayer", "InteractionNetProcessor"]

_OFF = ("0", "false", "off")


def _edge_mask(graph: Graph, override: Optional[torch.Tensor]):
    return graph.edge_mask if override is None else override


def _senders(graph: Graph):
    """The senders' sorted CSR (``gather_rows``'s aux)."""
    return graph.s_perm, graph.s_indptr


def _receivers(graph: Graph):
    """The receivers' CSR: the COO rows are sorted by receiver."""
    return None, graph.indptr


def _stateless(activation: str) -> bool:
    try:
        return resolve_activation(activation) is not None
    except ValueError:
        return False


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
        mask = _edge_mask(graph, edge_mask)
        xw = x @ self.kernel
        if edge_mask is None:
            # Mask-static graph: the normalizer and the self-loop degree
            # are host precomputes.
            deg = graph.static_in_degree + 1.0
            norm = graph.gcn_norm
        else:
            deg = seg_ops.masked_in_degree(graph, mask) + 1.0
            dinv = torch.rsqrt(deg)[:, None]
            norm = (gather_rows(dinv, graph.senders, _senders(graph))
                    * gather_rows(dinv, graph.receivers,
                                  _receivers(graph)))[:, 0]
        if supports_gcn_aggregate(graph, xw.shape[-1]):
            # Gather, scale and segment sum in one unit whose backward is
            # the sender-CSR segment sum (opt-in, in training).
            agg = gcn_aggregate(xw, norm * mask.to(norm.dtype), graph)
        else:
            msgs = gather_rows(xw, graph.senders, _senders(graph)) \
                * norm[:, None]
            agg = seg_ops.aggregate_sum(msgs, graph, mask)
        # Implicit self loop: norm_ii = 1/deg_i.
        out = agg + xw / deg[:, None]
        return out + self.bias if self.bias is not None else out


class _GATCore(nn.Module):
    """Shared math of GATConv / SparseGATConv: (x, graph, mask) -> (out,
    α), α the mean-head attention of each edge (zero on masked edges)."""

    def __init__(self, in_features: int, features: int, heads: int = 1,
                 negative_slope: float = 0.2, use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.heads, self.features = heads, features
        self.negative_slope = negative_slope
        self.kernel = nn.Parameter(
            glorot_uniform_pyg((in_features, heads * features), generator))
        self.att_src = nn.Parameter(
            glorot_uniform_pyg((1, heads, features), generator))
        self.att_dst = nn.Parameter(
            glorot_uniform_pyg((1, heads, features), generator))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor, graph: Graph,
                edge_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if graph.num_receivers != graph.num_nodes:
            raise ValueError("GATConv expects the unified node-space "
                             "convention")
        mask = _edge_mask(graph, edge_mask)
        h, c = self.heads, self.features
        xw = x @ self.kernel                           # [N, H·C]
        xp = xw.reshape(-1, h, c)
        a_src = (xp * self.att_src).sum(-1)            # [N, H]
        a_dst = (xp * self.att_dst).sum(-1)
        logits = (gather_rows(a_src, graph.senders, _senders(graph))
                  + gather_rows(a_dst, graph.receivers, _receivers(graph)))
        logits = F.leaky_relu(logits, self.negative_slope)
        # The implicit self loop of every receiver joins its softmax.
        self_logits = F.leaky_relu(a_src + a_dst, self.negative_slope)
        w, self_w = seg_ops.segment_softmax_coo(logits, graph, mask,
                                                self_logits)
        # Messages as [E, H·C] rows: the segment sum reads a 3-D input as
        # [B, E, F].
        e = graph.padded_num_edges
        msgs = (gather_rows(xw, graph.senders, _senders(graph))
                .reshape(e, h, c) * w[..., None]).reshape(e, h * c)
        out = seg_ops.aggregate_sum(msgs, graph, mask).reshape(-1, h, c)
        out = out + xp * self_w[..., None]
        out = out.mean(dim=1)                          # concat=False
        if self.bias is not None:
            out = out + self.bias
        return out, w.mean(dim=-1) * mask


class GATConv(nn.Module):
    """PyG GATConv(concat=False) parity layer (child ``core``)."""

    def __init__(self, in_features: int, features: int, heads: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.core = _GATCore(in_features, features, heads,
                             generator=generator)

    def forward(self, x, graph: Graph, edge_mask=None):
        return self.core(x, graph, edge_mask)[0]


class SparseGATConv(nn.Module):
    """GAT that can return a pruned edge mask: with ``prune``, the edges
    whose mean-head attention is below ``attention_threshold`` leave the
    returned mask (the caller carries it to later steps and epochs).  Self
    loops are implicit and never pruned."""

    def __init__(self, in_features: int, features: int, heads: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.core = _GATCore(in_features, features, heads,
                             generator=generator)

    def forward(self, x, graph: Graph, edge_mask=None,
                attention_threshold=0.0, prune: bool = False):
        mask = _edge_mask(graph, edge_mask)
        out, alpha = self.core(x, graph, mask)
        if prune:
            # Compared in fp32, as the JAX package compares against its
            # fp32 threshold whatever the compute dtype.
            keep = alpha.float() >= attention_threshold
            return out, mask * keep.to(mask.dtype)
        return out, mask


class SimpleConv(nn.Module):
    """PyG SimpleConv(aggr='mean'): unweighted neighbour mean, no self
    loops (isolated receivers get 0)."""

    def forward(self, x, graph: Graph, edge_mask=None):
        return seg_ops.aggregate_mean(
            gather_rows(x, graph.senders, _senders(graph)), graph,
            _edge_mask(graph, edge_mask))


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

    def activate(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(x) if self._act is None else self._act(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.lin_1(self.activate(self.lin_0(x)))


def _use_lazy_processor(graph: Graph, activation: str,
                        use_layer_norm: bool) -> bool:
    """The lazy-LN steps, on the reference's structural conditions (edge
    LayerNorm, a stateless activation, a unified node space).
    ``GCLT_LAZY_EDGE=0`` turns them off, as it does in the reference;
    without the flag the port stays lazy wherever the conditions hold (the
    reference also asks for its TPU segment kernel and 128-multiple widths
    there)."""
    structural = (use_layer_norm and _stateless(activation)
                  and graph.num_receivers == graph.num_nodes)
    return structural and os.environ.get("GCLT_LAZY_EDGE", "1") not in _OFF


def _use_reg_blocks(graph: Graph, edge_mask) -> bool:
    """The RegularBlocks layout where the graph has one and no runtime mask
    overrides the static one; ``GCLT_REG_EDGE=0`` turns it off."""
    if graph.reg_blocks is None or edge_mask is not None:
        return False
    return os.environ.get("GCLT_REG_EDGE", "1") not in _OFF


def _use_edge_step_path(graph: Graph, hidden_dim: int, edge_dim: int,
                        activation: str) -> bool:
    """The fused edge-step kernel: only with ``GCLT_EDGE_STEP=1`` (off by
    default, as in the reference), outside training, and where the kernel
    takes the shapes."""
    flag = os.environ.get("GCLT_EDGE_STEP")
    return (flag is not None and flag not in _OFF and not in_training()
            and edge_step.eligible(graph.padded_num_edges, hidden_dim,
                                   edge_dim, activation))


def _use_mega_edge_path(graph: Graph, hidden_dim: int, edge_dim: int,
                        activation: str) -> bool:
    """The edge-MLP segment kernel: only with ``GCLT_MEGA_EDGE=1``, outside
    training, and on the reference's structural conditions (16,384 real
    edges or more, a unified node space, a full receiver band).  The port
    sends every segment sum through its kernel, so the reference's
    segment-kernel condition always holds here."""
    if os.environ.get("GCLT_MEGA_EDGE", "0") in _OFF or in_training():
        return False
    return (edge_mlp.supports(hidden_dim, edge_dim, activation)
            and graph.num_edges >= 16384
            and graph.num_receivers == graph.num_nodes
            and graph.full_receiver_band)


def _use_fused_edge_path(graph: Graph, hidden_dim: int, edge_dim: int,
                         activation: str) -> bool:
    """The fused edge unit (``ops.fused_edge.edge_pipeline``), on the
    reference's conditions: a stateless activation, a unified node space,
    131,072 real edges or more (below that the reference measured the
    unit a loss), both widths multiples of 128, and ``use_fused_edge()``
    (in training; ``GCLT_FUSED_EDGE=0/1`` overrides)."""
    return (_stateless(activation)
            and graph.num_receivers == graph.num_nodes
            and graph.num_edges >= 131072
            and hidden_dim % 128 == 0 and edge_dim % 128 == 0
            and use_fused_edge())


class InteractionNetLayer(nn.Module):
    """One GraphCast-style interaction step (parameters ``edge_mlp`` with
    ``lin_0``, ``lin_1`` and, for PReLU, ``act``; ``node_mlp``; with edge
    LayerNorm ``edge_norm`` and ``node_norm``: the reference's names, which
    its lazy and plain steps share, so one checkpoint loads into both).

    ``forward(x, e, graph, mask)`` is the plain step:

        e' = LN_g(e + MLP_e([x_s ‖ x_r ‖ e]))
        x' = LN_n(x + MLP_n([x ‖ mean_agg(MLP_e(...))]))

    with the graph-mode edge LN's variance E[(v − μ)²] over the live edges.

    ``lazy(x, v, a, c, graph, mask)`` is the same step with the edge
    LayerNorm applied LAZILY: it carries the PRE-norm edge state ``v`` plus
    the per-feature affine ``(a, c)`` of the previous step's LN:

        e_t   = a ∘ v + c                       (never materialized)
        h_pre = xs[s] + xr[r] + v @ (a[:,None]·W1e) + (b1 + c@W1e)
        v'    = e_t + u = a ∘ v + c + u
        (μ, σ) = masked graph-mode stats of v'   (fp32)
        a', c' = γ/σ,  β − γμ/σ

    Each lazy route keeps the reference's own variance formula: E[v²] − μ²
    clamped at 0 on the reg-block and edge-step routes, E[(v − μ)²] on the
    fused, composed and mega routes.  ``route`` records the route the last
    call took (``reg_block``, ``edge_step``, ``fused``, ``mega`` or
    ``composed`` for the lazy step; ``nonlazy_fused``, ``nonlazy_mega`` or
    ``nonlazy`` for the plain step).
    """

    def __init__(self, node_dim: int, edge_dim: int, hidden_dim: int,
                 activation: str = "swish", use_layer_norm: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.node_dim, self.edge_dim = node_dim, edge_dim
        self.hidden_dim = hidden_dim
        self.activation = activation
        self.route: Optional[str] = None
        self._act = resolve_activation(activation)
        self.edge_mlp = nn.Module()
        self.edge_mlp.lin_0 = TorchLinear(2 * node_dim + edge_dim,
                                          hidden_dim, generator=generator)
        self.edge_mlp.act = PReLU() if self._act is None else None
        self.edge_mlp.lin_1 = TorchLinear(hidden_dim, edge_dim,
                                          generator=generator)
        self.node_mlp = _TwoLayerMLP(node_dim + edge_dim, hidden_dim,
                                     node_dim, activation,
                                     generator=generator)
        self.edge_norm = self.node_norm = None
        if use_layer_norm:
            self.edge_norm = PyGLayerNorm(edge_dim, mode="graph")
            self.node_norm = PyGLayerNorm(node_dim, mode="node")

    def _edge_act(self, h: torch.Tensor) -> torch.Tensor:
        return self.edge_mlp.act(h) if self._act is None else self._act(h)

    def forward(self, x, e, graph: Graph, edge_mask=None):
        """The plain step: (x, e) -> (x', e')."""
        mask = _edge_mask(graph, edge_mask)
        d, de, hid = self.node_dim, self.edge_dim, self.hidden_dim
        k0, b0 = self.edge_mlp.lin_0.kernel, self.edge_mlp.lin_0.bias
        k1, b1 = self.edge_mlp.lin_1.kernel, self.edge_mlp.lin_1.bias
        if _use_fused_edge_path(graph, hid, de, self.activation):
            self.route = "nonlazy_fused"
            update, agg = edge_pipeline(
                x, e, mask, k0[:d], k0[d:2 * d], k0[2 * d:], b0, k1, b1,
                graph, self.activation,
                deg=seg_ops.masked_in_degree(graph, mask))
            return self._plain_tail(x, e, agg, update, mask)
        h = (gather_rows(x @ k0[:d], graph.senders, _senders(graph))
             + gather_rows(x @ k0[d:2 * d], graph.receivers,
                           _receivers(graph))
             + e @ k0[2 * d:] + b0)
        if _use_mega_edge_path(graph, hid, de, self.activation):
            self.route = "nonlazy_mega"
            update, agg_sum = edge_mlp.edge_mlp(
                h, k1, b1, mask, graph.indptr, graph.num_receivers,
                self.activation)
            deg = seg_ops.masked_in_degree(graph, mask)
            agg = agg_sum / deg.clamp(min=1.0)[:, None].to(agg_sum.dtype)
        else:
            self.route = "nonlazy"
            update = self._edge_act(h) @ k1 + b1
            agg = seg_ops.aggregate_mean(update, graph, mask)
        return self._plain_tail(x, e, agg, update, mask)

    def _plain_tail(self, x, e, agg, update, mask):
        """The plain step's node update, residuals and LayerNorms."""
        new_x = x + self.node_mlp(torch.cat([x, agg], dim=-1))
        new_e = e + update
        if self.edge_norm is not None:
            new_e = self.edge_norm(new_e, mask=mask)
            new_x = self.node_norm(new_x)
        return new_x, new_e

    def _node_step(self, x, agg_sum, graph: Graph, mask):
        deg = seg_ops.masked_in_degree(graph, mask)
        agg = agg_sum / deg.clamp(min=1.0)[:, None].to(agg_sum.dtype)
        return self._node_update(x, agg)

    def _node_update(self, x, agg):
        return self.node_norm(x + self.node_mlp(torch.cat([x, agg], dim=-1)))

    def _affine(self, mu, var):
        """The next step's (a, c) from the masked stats (fp32)."""
        inv_sigma = torch.rsqrt(var + 1e-5)
        gamma = self.edge_norm.weight.float()
        beta = self.edge_norm.bias.float()
        return gamma * inv_sigma, beta - gamma * mu * inv_sigma

    def lazy(self, x, v, a, c, graph: Graph, edge_mask=None):
        """The lazy-LN step: (x, v, a, c) -> (x', v', a', c')."""
        mask = _edge_mask(graph, edge_mask)
        d, de, hid = self.node_dim, self.edge_dim, self.hidden_dim
        k0, b0 = self.edge_mlp.lin_0.kernel, self.edge_mlp.lin_0.bias
        k1, b1 = self.edge_mlp.lin_1.kernel, self.edge_mlp.lin_1.bias
        w1s, w1r, w1e = k0[:d], k0[d:2 * d], k0[2 * d:]
        w1e_eff = a[:, None].to(w1e.dtype) * w1e
        b1_eff = b0 + c.to(w1e.dtype) @ w1e

        rb = graph.reg_blocks
        if _use_reg_blocks(graph, edge_mask) \
                and v.shape[0] == rb.rows_padded:
            self.route = "reg_block"
            static = RegStatic(block_recv=rb.block_recv, block_k=rb.block_k,
                               num_nodes=graph.num_receivers,
                               activation=self.activation)
            u, agg_sum = reg_edge_tail(
                static, x, v, rb.mask.to(x.dtype), rb.senders, rb.s_perm,
                rb.s_indptr, w1s, w1r, w1e_eff, b1_eff, k1, b1,
            )
            new_x = self._node_step(x, agg_sum, graph, edge_mask)
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

        if _use_edge_step_path(graph, hid, de, self.activation):
            # The whole edge side in one kernel; only the sender gather and
            # the two node projections stay outside.
            self.route = "edge_step"
            xsg = gather_rows(x @ w1s, graph.senders, _senders(graph))
            v_new, agg_sum, stats = edge_step.edge_step(
                xsg, v, x @ w1r, w1e_eff, b1_eff, k1, b1, a.float(),
                c.float(), mask, graph.indptr, graph.num_receivers,
                self.activation,
            )
            new_x = self._node_step(x, agg_sum, graph, mask)
            denom = torch.clamp(stats[2] * de, min=1.0)
            mu = stats[0] / denom
            var = torch.clamp(stats[1] / denom - torch.square(mu), min=0.0)
            return (new_x, v_new) + self._affine(mu, var)

        if _use_fused_edge_path(graph, hid, de, self.activation):
            # The folded weights enter the unit as inputs: their gradients
            # flow on to (a, c) and the previous LayerNorm through
            # autograd.  The unit returns the mean aggregate.
            self.route = "fused"
            u, agg = edge_pipeline(
                x, v, mask, w1s, w1r, w1e_eff, b1_eff, k1, b1, graph,
                self.activation, deg=seg_ops.masked_in_degree(graph, mask))
            new_x = self._node_update(x, agg)
        else:
            h = (gather_rows(x @ w1s, graph.senders, _senders(graph))
                 + gather_rows(x @ w1r, graph.receivers, _receivers(graph))
                 + v @ w1e_eff + b1_eff)
            if _use_mega_edge_path(graph, hid, de, self.activation):
                self.route = "mega"
                u, agg_sum = edge_mlp.edge_mlp(h, k1, b1, mask, graph.indptr,
                                               graph.num_receivers,
                                               self.activation)
            else:
                self.route = "composed"
                u = self._act(h) @ k1 + b1
                agg_sum = seg_ops.aggregate_sum(u, graph, mask)
            new_x = self._node_step(x, agg_sum, graph, mask)
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
    ``steps`` (one ``InteractionNetLayer`` per step; the JAX package stacks
    their parameters on axis 0 under ``nn.scan``).  The steps run lazily
    where ``_use_lazy_processor`` says so, else plainly."""

    def __init__(self, node_dim: int, raw_edge_dim: int,
                 edge_latent_dim: int, hidden_dim: int, num_steps: int,
                 activation: str = "swish", use_layer_norm: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.edge_latent_dim = edge_latent_dim
        self.activation = activation
        self.use_layer_norm = use_layer_norm
        self._act = resolve_activation(activation)
        self.edge_encoder_lin = TorchLinear(raw_edge_dim, edge_latent_dim,
                                            generator=generator)
        self.edge_encoder_act = PReLU() if self._act is None else None
        self.steps = nn.ModuleList(
            InteractionNetLayer(node_dim, edge_latent_dim, hidden_dim,
                                activation, use_layer_norm,
                                generator=generator)
            for _ in range(num_steps)
        )

    def forward(self, x: torch.Tensor, graph: Graph,
                edge_attr_raw: Optional[torch.Tensor] = None,
                edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        lazy = _use_lazy_processor(graph, self.activation,
                                   self.use_layer_norm)
        raw = edge_attr_raw if edge_attr_raw is not None else graph.edge_attr
        if lazy and edge_attr_raw is None \
                and _use_reg_blocks(graph, edge_mask):
            # The reg-block steps run the block row order: the edge
            # carrier starts in that order too.
            raw = graph.reg_blocks.edge_attr
        e = self.edge_encoder_lin(raw)
        e = self.edge_encoder_act(e) if self._act is None else self._act(e)
        if not lazy:
            for step in self.steps:
                x, e = step(x, e, graph, edge_mask)
            return x
        a = torch.ones(self.edge_latent_dim, dtype=torch.float32,
                       device=x.device)
        c = torch.zeros(self.edge_latent_dim, dtype=torch.float32,
                        device=x.device)
        for step in self.steps:
            x, e, a, c = step.lazy(x, e, a, c, graph, edge_mask)
        return x
