"""The InteractionNet processor alone, sharded over the space group (torch
counterpart of ``graphcast_lite_tpu.parallel.spmd``).

Every rank owns one latitude band (or tile) of mesh nodes
(``graphs.partition``) and the edges whose receivers it owns:

* per message-passing step, the node PROJECTIONS of the edge MLP's split
  first matmul cross ranks, by gather-by-owner (one all-gather: correct
  for any edge span, as the multimesh's coarse levels connect distant
  bands) or, given a banded plan, over two point-to-point boundary slabs
  and a compact hub all-gather (``parallel.collectives``);
* aggregation, the node and edge MLPs and the node-mode LayerNorm are
  local; the edge LayerNorm's graph-mode statistics are all-reduced over
  the group.

This is the full model's sharded processor
(``sharded_model._interaction_processor``) called on its own: it reads the
parameters of the port's ``models.gnn.InteractionNetProcessor``, so a
processor trained on one device runs sharded unchanged.
"""

from __future__ import annotations

from typing import Optional

import torch

from .sharded_model import GraphArrays, _interaction_processor, _Tree
from .sharding import ProcessMesh

__all__ = ["sharded_interaction_processor"]


def sharded_interaction_processor(
    processor,
    x_local: torch.Tensor,
    sgraph_arrays: GraphArrays,
    mesh: ProcessMesh,
    use_layer_norm: bool = True,
    halos: Optional[GraphArrays] = None,
) -> torch.Tensor:
    """Run ``processor``'s N steps on this rank's [N_s, D] node latents, or
    on a batch [B, N_s, D] in one call (one exchange a step for the batch,
    the edge LayerNorm's statistics per sample).

    ``sgraph_arrays``: this rank's shard of the processing graph in
    gather mode (``sharded_model.graph_arrays(sg, None, shard)``): one
    all-gather of the sender projections a step.  ``halos``: the same
    shard under a banded plan (``graph_arrays(sg, build_banded_halos(sg),
    shard)``), which is then used in its place: only the boundary slabs
    and the hub rows cross ranks.

    Returns the processed latents of the rank's nodes [N_s, D] (or [B,
    N_s, D])."""
    return _interaction_processor(
        _Tree(dict(processor.named_parameters())), x_local,
        halos if halos is not None else sgraph_arrays, mesh.space_group,
        use_layer_norm, processor.activation.lower())
