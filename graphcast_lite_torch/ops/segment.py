"""Aggregation primitives for message passing on static padded graphs
(torch counterpart of ``graphcast_lite_tpu.ops.segment``).

Messages are multiplied by the edge mask before they are summed, so
padding rows and pruned edges contribute exact zeros.  A constant-in-degree
graph (the M2G decoder: exactly 3 senders per grid node) aggregates by a
reshape-sum; every other sum goes through the CUDA segment-sum kernel
(``ops.cuda_segment``) at every size and width: the aggregations, the
degrees under a runtime edge mask (SparseGAT's pruned mask, ``[E_pad, 1]``
rows) and the edge softmax's denominators (``[E_pad, H]`` rows).  The
softmax's segment max is a plain ``scatter_reduce`` (the JAX package takes
it outside any Pallas kernel too; a max does not depend on the order).
Every gather by receiver id goes through ``ops.gather.gather_rows`` with
the receiver CSR, so its adjoint is the kernel as well.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..graphs.structure import Graph
from . import cuda_segment
from .gather import gather_rows

__all__ = ["masked_in_degree", "aggregate_sum", "aggregate_mean",
           "segment_softmax_coo"]

_EPS = 1e-16


def _by_receiver(values: torch.Tensor, graph: Graph) -> torch.Tensor:
    """``values[receivers]`` for [R, F] values, with the receiver CSR as
    the gather's sorted index (its adjoint is the segment-sum kernel)."""
    return gather_rows(values, graph.receivers, (None, graph.indptr))


def masked_in_degree(graph: Graph,
                     edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[R] in-degree per receiver under the (possibly pruned) mask: the
    graph's host-side static degree for no mask or the graph's own, else
    a segment sum of the mask (in the mask's dtype)."""
    if edge_mask is None or edge_mask is graph.edge_mask:
        return graph.static_in_degree
    return cuda_segment.segment_sum(
        edge_mask[:, None].contiguous(), graph.indptr, graph.num_receivers
    )[:, 0]


def aggregate_sum(messages: torch.Tensor, graph: Graph,
                  edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum messages [E_pad, F] into receivers -> [R, F]."""
    mask = graph.edge_mask if edge_mask is None else edge_mask
    masked = messages * mask[:, None]
    if graph.const_in_degree > 0 and masked.dim() == 2:
        # Constant in-degree + sorted receivers: the segment reduction is
        # a reshape-sum (fp32 accumulation, as the JAX package does).
        k, r0 = graph.const_in_degree, graph.num_const_receivers
        out = masked.reshape(r0, k, masked.shape[-1]).float().sum(dim=1) \
            .to(masked.dtype)
        if r0 < graph.num_receivers:
            out = torch.nn.functional.pad(
                out, (0, 0, 0, graph.num_receivers - r0)
            )
        return out
    return cuda_segment.segment_sum(
        masked.contiguous(), graph.indptr, graph.num_receivers
    )


def aggregate_mean(messages: torch.Tensor, graph: Graph,
                   edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean of messages into receivers; receivers with no live edges get 0
    (PyG ``scatter(..., reduce="mean")``)."""
    mask = graph.edge_mask if edge_mask is None else edge_mask
    total = aggregate_sum(messages, graph, mask)
    deg = masked_in_degree(graph, mask)
    return total / deg.clamp(min=1.0)[:, None]


def segment_softmax_coo(
    logits: torch.Tensor,
    graph: Graph,
    edge_mask: Optional[torch.Tensor] = None,
    extra_logit: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Numerically stable softmax over each receiver's incoming edges.

    ``logits`` [E_pad] or [E_pad, H]; ``extra_logit`` an optional [R] or
    [R, H] per-receiver term that joins the softmax (GAT's self-loop
    logit).  Returns (edge weights, zero on masked edges; self weights or
    None), normalized so that the edges and the self term of a receiver
    with any term sum to 1.  The max is detached, and receivers with no
    live edge keep a finite -1e30 floor in the logits' dtype, as in the
    JAX package."""
    mask = graph.edge_mask if edge_mask is None else edge_mask
    squeeze = logits.dim() == 1
    if squeeze:
        logits = logits[:, None]
        if extra_logit is not None:
            extra_logit = extra_logit[:, None]
    mask_b = mask[:, None]
    r, h = graph.num_receivers, logits.shape[1]

    neg = torch.tensor(-1e30, dtype=logits.dtype, device=logits.device)
    masked_logits = torch.where(mask_b > 0, logits, neg)
    with torch.no_grad():
        seg_max = torch.full((r, h), float("-inf"), dtype=logits.dtype,
                             device=logits.device)
        seg_max = seg_max.scatter_reduce(
            0, graph.receivers.long()[:, None].expand(-1, h),
            masked_logits, "amax", include_self=False)
        if extra_logit is not None:
            seg_max = torch.maximum(seg_max, extra_logit)
        seg_max = torch.maximum(seg_max, neg)

    shifted = torch.exp(masked_logits - _by_receiver(seg_max, graph)) \
        * mask_b
    denom = cuda_segment.segment_sum(shifted.contiguous(), graph.indptr, r)
    self_exp = None
    if extra_logit is not None:
        self_exp = torch.exp(extra_logit - seg_max)
        denom = denom + self_exp
    denom = denom.clamp(min=_EPS)

    edge_w = shifted / _by_receiver(denom, graph)
    self_w = self_exp / denom if self_exp is not None else None
    if squeeze:
        edge_w = edge_w[:, 0]
        self_w = self_w[:, 0] if self_w is not None else None
    return edge_w, self_w
