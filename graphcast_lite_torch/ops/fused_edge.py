"""The fused InteractionNet edge pipeline with a hand-written backward, and
the training flag of the fused routes (torch counterpart of
``graphcast_lite_tpu.ops.fused_edge``).

``edge_pipeline`` runs the whole edge side of one InteractionNet step —

    h_pre       = x@W1s [senders] + x@W1r [receivers] + e@W1e + b1
    edge_update = act(h_pre) @ W2 + b2
    agg         = segment_mean(edge_update · mask, receivers)

— as one ``autograd.Function`` whose backward is written in closed form
after the reference's ``_bwd`` (its ``"pallas"`` branch), with both
node-space scatters through the segment-sum kernel (``ops.cuda_segment``):

    d_xr = segment_sum(d_h_pre) over the receiver CSR (rows already sorted)
    d_xs = segment_sum(d_h_pre[s_perm]) over the sender CSR

The forward's aggregation is the same kernel, or, with
``GCLT_MEGA_EDGE=1`` where the edge-MLP kernel takes the widths and the
receiver band is full, the second layer and the aggregation run in one
launch of ``ops.edge_mlp`` (the reference's ``_edge_tail``).  That kernel
has no backward; the Function's backward never calls it.  The forward
saves ``h_pre`` unless ``GCLT_FUSED_SAVE_HPRE=0``, and the backward then
recomputes it.  The reference's ``GCLT_FUSED_BWD=ell|hybrid`` modes
(dense gathers over its ELL tables) compute the same gradient; the port
keeps no ELL tables, so every mode takes the CSR route.  The backward is
the exact adjoint of the forward on every row, padding rows included
(they point at sender 0 and receiver R - 1, where their cotangents land).

``edge_gather_mlp_agg`` is the same unit on pre-projected inputs
(sender rows, receiver rows and edge rows projected outside), returning
the masked sum rather than the mean; it also returns the gradients of the
edge rows and of ``b1``.

The fused kernels are forward only: ``training.rollout.rollout_loss`` runs
the model inside ``training_trace()``, and the processor's route policy
(``models.gnn``) reads ``in_training()``, so the same model code takes
differentiable routes when it is trained and the forward-only kernels when
it serves, as the JAX package does.  ``use_fused_edge()`` is the policy of
this unit: on in training, ``GCLT_FUSED_EDGE=0/1`` overrides.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
from typing import Optional, Tuple

import torch

from . import cuda_segment, edge_mlp
from .reg_edge import _act_fn
from .segment import masked_in_degree

__all__ = ["training_trace", "in_training", "use_fused_edge",
           "edge_pipeline", "edge_gather_mlp_agg"]

_TRAINING_TRACE = contextvars.ContextVar("gclt_training_trace",
                                         default=False)
_OFF = ("0", "false", "off")


@contextlib.contextmanager
def training_trace():
    """Mark the dynamic extent of a training computation."""
    token = _TRAINING_TRACE.set(True)
    try:
        yield
    finally:
        _TRAINING_TRACE.reset(token)


def in_training() -> bool:
    return _TRAINING_TRACE.get()


def use_fused_edge() -> bool:
    """The fused unit's policy: on inside ``training_trace()``;
    ``GCLT_FUSED_EDGE=0/1`` overrides.  (The reference also asks for its
    TPU segment kernel; the port sends every segment sum through its
    kernel, so that condition always holds here.)"""
    flag = os.environ.get("GCLT_FUSED_EDGE")
    if flag is not None:
        return flag not in _OFF
    return in_training()


@dataclasses.dataclass(frozen=True)
class _Static:
    """What the unit needs of a graph beyond its index tensors."""

    num_nodes: int          # rows of the sender table (sender CSR)
    num_receivers: int      # rows of the aggregate (receiver CSR)
    activation: str
    full_receiver_band: bool = True


def _mega_enabled() -> bool:
    return os.environ.get("GCLT_MEGA_EDGE", "0") not in _OFF


def _edge_tail(static: _Static, h_pre, w2, b2, mask, indptr):
    """(act(h_pre) @ w2 + b2, its masked receiver segment sum): through the
    edge-MLP kernel under ``GCLT_MEGA_EDGE=1`` where it takes the widths and
    the receiver band is full (the reference's conditions), else the
    composed ops and the segment-sum kernel."""
    if (_mega_enabled()
            and edge_mlp.supports(h_pre.shape[-1], w2.shape[-1],
                                  static.activation)
            and static.full_receiver_band):
        return edge_mlp.edge_mlp(h_pre, w2, b2, mask, indptr,
                                 static.num_receivers, static.activation)
    u = _act_fn(static.activation)(h_pre) @ w2 + b2
    agg_sum = cuda_segment.segment_sum(
        (u * mask[:, None]).contiguous(), indptr, static.num_receivers)
    return u, agg_sum


def _h_pre(x, e_attr, w1s, w1r, w1e, b1, senders, receivers):
    return ((x @ w1s).index_select(0, senders)
            + (x @ w1r).index_select(0, receivers)
            + e_attr @ w1e + b1)


def _scatter_both(static: _Static, d_hp, indptr, s_perm, s_indptr):
    """(d_xr, d_xs): the receiver and the sender scatters of ``d_hp``, both
    through the segment-sum kernel."""
    d_xr = cuda_segment.segment_sum(d_hp.contiguous(), indptr,
                                    static.num_receivers)
    d_xs = cuda_segment.segment_sum(d_hp.index_select(0, s_perm), s_indptr,
                                    static.num_nodes)
    return d_xr, d_xs


def _act_backward(name: str, grad: torch.Tensor,
                  h_pre: torch.Tensor) -> torch.Tensor:
    """d act(h_pre) / d h_pre applied to ``grad``, in one pass (the
    derivative autograd takes through the activation)."""
    if name in ("swish", "silu"):
        return torch.ops.aten.silu_backward(grad, h_pre)
    if name == "relu":
        return torch.ops.aten.threshold_backward(grad, h_pre, 0)
    raise ValueError(f"fused edge unit: activation {name!r}")


def _save_h_pre() -> bool:
    return os.environ.get("GCLT_FUSED_SAVE_HPRE", "1") not in _OFF


class _EdgePipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, static, x, e_attr, mask, deg, w1s, w1r, w1e, b1, w2,
                b2, senders, receivers, indptr, s_perm, s_indptr):
        h_pre = _h_pre(x, e_attr, w1s, w1r, w1e, b1, senders, receivers)
        u, agg_sum = _edge_tail(static, h_pre, w2, b2, mask, indptr)
        agg = agg_sum / deg.clamp(min=1.0)[:, None].to(agg_sum.dtype)
        ctx.static = static
        ctx.saved_h_pre = _save_h_pre()
        ctx.save_for_backward(
            x, e_attr, mask, deg, w1s, w1r, w1e, b1, w2, senders, receivers,
            indptr, s_perm, s_indptr, h_pre if ctx.saved_h_pre else None)
        return u, agg

    @staticmethod
    def backward(ctx, d_eu, d_agg):
        (x, e_attr, mask, deg, w1s, w1r, w1e, b1, w2, senders, receivers,
         indptr, s_perm, s_indptr, h_pre) = ctx.saved_tensors
        static = ctx.static
        if not ctx.saved_h_pre:
            h_pre = _h_pre(x, e_attr, w1s, w1r, w1e, b1, senders, receivers)
        inv = 1.0 / deg.clamp(min=1.0).to(d_agg.dtype)
        d_sum = d_agg * inv[:, None]                          # [R, De]
        d_eu_tot = d_eu + mask[:, None] * d_sum.index_select(0, receivers)
        d_w2 = _act_fn(static.activation)(h_pre).T @ d_eu_tot
        d_b2 = d_eu_tot.sum(dim=0)
        d_hp = _act_backward(static.activation, d_eu_tot @ w2.T,
                             h_pre)                           # [E, H]
        d_b1 = d_hp.sum(dim=0)
        d_e = d_hp @ w1e.T
        d_w1e = e_attr.T @ d_hp
        d_xr, d_xs = _scatter_both(static, d_hp, indptr, s_perm, s_indptr)
        d_x = d_xs @ w1s.T + d_xr @ w1r.T
        d_w1s = x.T @ d_xs
        d_w1r = x.T @ d_xr
        return (None, d_x, d_e, None, None, d_w1s, d_w1r, d_w1e, d_b1, d_w2,
                d_b2, None, None, None, None, None)


def edge_pipeline(x, e_attr, mask, w1s, w1r, w1e, b1, w2, b2, graph,
                  activation: str, deg: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(edge_update [E_pad, De], agg_mean [R, De]) for one InteractionNet
    step on ``graph`` (the senders' CSR spans ``graph.num_nodes`` rows).
    ``deg`` is the in-degree [R] under ``mask`` (default
    ``ops.segment.masked_in_degree``: the graph's static degree for its
    own mask); the mask gets no gradient.  Callers gate on
    ``use_fused_edge()`` and the reference's size conditions
    (``models.gnn._use_fused_edge_path``)."""
    if deg is None:
        deg = masked_in_degree(graph, mask)
    static = _Static(num_nodes=graph.num_nodes,
                     num_receivers=graph.num_receivers,
                     activation=activation,
                     full_receiver_band=graph.full_receiver_band)
    args = (x, e_attr, w1s, w1r, w1e, b1, w2, b2)
    if not (torch.is_grad_enabled() and any(a.requires_grad for a in args)):
        h_pre = _h_pre(x, e_attr, w1s, w1r, w1e, b1, graph.senders,
                       graph.receivers)
        u, agg_sum = _edge_tail(static, h_pre, w2, b2, mask, graph.indptr)
        return u, agg_sum / deg.clamp(min=1.0)[:, None].to(agg_sum.dtype)
    return _EdgePipeline.apply(
        static, x, e_attr, mask, deg, w1s, w1r, w1e, b1, w2, b2,
        graph.senders, graph.receivers, graph.indptr, graph.s_perm,
        graph.s_indptr)


class _EdgeGatherMlpAgg(torch.autograd.Function):
    @staticmethod
    def forward(ctx, static, xs, xr, ep, b1, w2, b2, mask, senders,
                receivers, indptr, s_perm, s_indptr):
        h_pre = (xs.index_select(0, senders) + xr.index_select(0, receivers)
                 + ep + b1)
        u, agg_sum = _edge_tail(static, h_pre, w2, b2, mask, indptr)
        ctx.static = static
        ctx.save_for_backward(w2, mask, h_pre, receivers, indptr, s_perm,
                              s_indptr)
        return u, agg_sum

    @staticmethod
    def backward(ctx, d_eu, d_agg):
        w2, mask, h_pre, receivers, indptr, s_perm, s_indptr = \
            ctx.saved_tensors
        static = ctx.static
        d_eu_tot = d_eu + mask[:, None] * d_agg.index_select(0, receivers)
        d_w2 = _act_fn(static.activation)(h_pre).T @ d_eu_tot
        d_b2 = d_eu_tot.sum(dim=0)
        d_hp = _act_backward(static.activation, d_eu_tot @ w2.T, h_pre)
        d_b1 = d_hp.sum(dim=0)
        d_xr, d_xs = _scatter_both(static, d_hp, indptr, s_perm, s_indptr)
        return (None, d_xs, d_xr, d_hp, d_b1, d_w2, d_b2, None, None, None,
                None, None, None)


def edge_gather_mlp_agg(xs, xr, ep, b1, w2, b2, mask, senders, receivers,
                        indptr, s_perm, s_indptr, activation: str
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The edge pipeline on PRE-PROJECTED rows:

        h_pre       = xs[senders] + xr[receivers] + ep + b1
        edge_update = act(h_pre) @ w2 + b2
        agg_sum     = segment_sum(edge_update · mask, receivers)

    ``xs`` [N_s, H] sender rows, ``xr`` [R, H] receiver rows, ``ep``
    [E_pad, H] edge rows; ``indptr`` [R + 1] the receivers' CSR (rows
    sorted by receiver), ``s_perm`` / ``s_indptr`` [N_s + 1] the senders'.
    Returns (edge_update [E_pad, De], agg_sum [R, De]); the backward is
    ``edge_pipeline``'s with the projections left to the caller.  Under
    ``GCLT_MEGA_EDGE=1`` the tail takes the edge-MLP kernel wherever it
    takes the widths (the reference also asks for a full band of its
    clipped receiver schedule, which raw CSR arrays do not have)."""
    static = _Static(num_nodes=s_indptr.numel() - 1,
                     num_receivers=indptr.numel() - 1,
                     activation=activation)
    args = (xs, xr, ep, b1, w2, b2)
    if not (torch.is_grad_enabled() and any(a.requires_grad for a in args)):
        h_pre = (xs.index_select(0, senders) + xr.index_select(0, receivers)
                 + ep + b1)
        return _edge_tail(static, h_pre, w2, b2, mask, indptr)
    return _EdgeGatherMlpAgg.apply(static, xs, xr, ep, b1, w2, b2, mask,
                                   senders, receivers, indptr, s_perm,
                                   s_indptr)
