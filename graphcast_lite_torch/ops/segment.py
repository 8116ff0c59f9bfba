"""Aggregation primitives for message passing on static padded graphs
(torch counterpart of ``graphcast_lite_tpu.ops.segment``).

Messages are multiplied by the edge mask before they are summed, so
padding rows contribute exact zeros.  A constant-in-degree graph (the M2G
decoder: exactly 3 senders per grid node) aggregates by a reshape-sum;
every other graph goes through the CUDA segment-sum kernel
(``ops.cuda_segment``) at every size and width.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..graphs.structure import Graph
from . import cuda_segment

__all__ = ["masked_in_degree", "aggregate_sum", "aggregate_mean"]


def masked_in_degree(graph: Graph,
                     edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[R] in-degree per receiver: the graph's host-side static degree."""
    if edge_mask is not None and edge_mask is not graph.edge_mask:
        raise NotImplementedError(
            "degrees under runtime edge masks (SparseGAT pruning) are not "
            "ported yet (ROADMAP A8: remaining layer families)"
        )
    return graph.static_in_degree


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
    """Mean of messages into receivers; receivers with no edges get 0."""
    total = aggregate_sum(messages, graph, edge_mask)
    deg = masked_in_degree(graph, edge_mask)
    return total / deg.clamp(min=1.0)[:, None]
