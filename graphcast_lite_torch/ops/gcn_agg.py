"""GCN edge aggregation as one unit with a layout-matched backward (torch
counterpart of ``graphcast_lite_tpu.ops.gcn_agg``).

``gcn_aggregate(x, scale, graph)`` computes

    agg[r] = Σ_{e: recv[e] = r} scale[e] · x[sender[e]]           [R, F]

with the segment-sum kernel (``ops.cuda_segment``) over the receiver CSR,
and its backward in closed form, the sender-CSR segment sum of the
receiver-gathered cotangent:

    d_x = segment_sum((d_agg[recv] · scale)[s_perm]) over the sender CSR

This is the reference's ``"pallas"`` backward; its ``"tell"`` mode (a
dense gather over a transpose-ELL table) computes the same gradient, and
the port, which keeps no ELL tables, takes the CSR route in both.
``scale`` (the symmetric norm times the 0/1 edge mask) is not
differentiated: the mask comes from comparisons, so every gradient path
through it is zero.  Do not use the unit where a learned per-edge weight
needs gradients.

The policy (``supports_gcn_aggregate``) is the reference's: opt-in with
``GCLT_GCN_AGG=1``, in training only, at 128-multiple widths and 16,384
real edges or more.
"""

from __future__ import annotations

import os

import torch

from . import cuda_segment
from .fused_edge import in_training

__all__ = ["gcn_aggregate", "supports_gcn_aggregate"]


def supports_gcn_aggregate(graph, features: int) -> bool:
    """Whether ``GCNConv`` aggregates through ``gcn_aggregate``: only with
    ``GCLT_GCN_AGG=1`` (off by default, as in the reference), inside
    ``training_trace()``, at ``features % 128 == 0`` and 16,384 real edges
    or more."""
    if os.environ.get("GCLT_GCN_AGG") != "1":
        return False
    return (in_training() and features % 128 == 0
            and graph.num_edges >= 16384)


class _GcnAggregate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, senders, receivers, indptr, s_perm,
                s_indptr):
        msgs = x.index_select(0, senders) * scale[:, None]
        ctx.save_for_backward(scale, receivers, s_perm, s_indptr)
        return cuda_segment.segment_sum(msgs, indptr, indptr.numel() - 1)

    @staticmethod
    def backward(ctx, d_agg):
        scale, receivers, s_perm, s_indptr = ctx.saved_tensors
        d_msgs = d_agg.index_select(0, receivers) * scale[:, None]
        d_x = cuda_segment.segment_sum(d_msgs.index_select(0, s_perm),
                                       s_indptr, s_indptr.numel() - 1)
        return d_x, None, None, None, None, None, None


def gcn_aggregate(x: torch.Tensor, scale: torch.Tensor,
                  graph) -> torch.Tensor:
    """``agg[r] = Σ_e scale[e] · x[sender[e]]`` [R, F]; ``scale`` [E_pad]
    pre-masked and not differentiated.  Callers gate on
    ``supports_gcn_aggregate``."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        msgs = x.index_select(0, graph.senders) * scale[:, None]
        return cuda_segment.segment_sum(msgs, graph.indptr,
                                        graph.num_receivers)
    return _GcnAggregate.apply(x, scale.detach(), graph.senders,
                               graph.receivers, graph.indptr, graph.s_perm,
                               graph.s_indptr)
