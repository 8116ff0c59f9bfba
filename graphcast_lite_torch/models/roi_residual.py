"""ROI-residual regional corrector (torch counterpart of
``graphcast_lite_tpu.models.roi_residual``).

~ reference ``src/roi_residual.py``: a simpler regional head than the
dual-mesh — a k-NN graph over the ROI *grid* points themselves, input
[raw obs ‖ global encoder grid latent ‖ global prediction], an unshared
InteractionNet processor (6 steps), and a near-zero-init MLP head whose
output corrects the frozen global prediction on the ROI:

  output = global_pred + scatter(correction, roi_idx)

The same composition as the dual-mesh module: the global model runs
outside under ``torch.no_grad()``; this module is the trainable corrector.
Its processor is ``models.gnn.InteractionNetProcessor``, which takes the
lazy-LN step where its structural conditions hold and ``GCLT_LAZY_EDGE``
does not turn it off (the JAX package takes it on its TPU segment kernel
only; ROADMAP Queue C).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..graphs.structure import Graph
from .dual_mesh import _SmallInitLinear
from .gnn import InteractionNetProcessor
from .nn import TorchLinear

__all__ = ["ROIResidualHead", "ROIResidualModule", "roi_residual_forward"]


class ROIResidualHead(nn.Module):
    """Linear → SiLU → Linear → SiLU → small-init Linear on [state ‖ skip]
    (children ``lin_0``, ``lin_1``, ``out``)."""

    def __init__(self, in_features: int, hidden_dim: int, output_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.lin_0 = TorchLinear(in_features, hidden_dim, generator=generator)
        self.lin_1 = TorchLinear(hidden_dim, hidden_dim, generator=generator)
        self.out = _SmallInitLinear(hidden_dim, output_dim, generator)

    def forward(self, node_state, skip_features):
        x = torch.cat([node_state, skip_features], dim=-1)
        return self.out(F.silu(self.lin_1(F.silu(self.lin_0(x)))))


class ROIResidualModule(nn.Module):
    """Trainable ROI corrector: input-projection MLP → InteractionNet over
    the ROI k-NN graph → residual head.  Inputs: ROI raw features [n_roi,
    raw_dim], the global grid latents [n_roi, latent_dim] and the global
    prediction [n_roi, output_channels] at the ROI; returns [n_roi,
    output_channels]."""

    def __init__(self, raw_dim: int, latent_dim: int, hidden_dim: int = 256,
                 output_channels: int = 19, processor_steps: int = 6,
                 raw_edge_dim: int = 4,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        skip = raw_dim + latent_dim + output_channels
        self.proj_0 = TorchLinear(skip, hidden_dim, generator=generator)
        self.proj_1 = TorchLinear(hidden_dim, hidden_dim, generator=generator)
        self.processor = InteractionNetProcessor(
            node_dim=hidden_dim, raw_edge_dim=raw_edge_dim,
            edge_latent_dim=hidden_dim, hidden_dim=hidden_dim,
            num_steps=processor_steps, activation="swish",
            use_layer_norm=True, generator=generator)
        self.head = ROIResidualHead(hidden_dim + skip, hidden_dim,
                                    output_channels, generator)

    def forward(self, roi_raw, roi_global_latent, roi_global_pred,
                roi_graph: Graph):
        skip = torch.cat([roi_raw, roi_global_latent, roi_global_pred],
                         dim=-1)
        x = self.proj_1(F.silu(self.proj_0(skip)))
        x = self.processor(x, roi_graph)
        return self.head(x, skip)


def roi_residual_forward(global_apply: Callable, regional_apply: Callable,
                         x_grid: torch.Tensor, roi_idx: torch.Tensor,
                         roi_graph: Graph) -> torch.Tensor:
    """The frozen global model plus the ROI correction.

    ``global_apply(x) -> (pred [G, C], grid_latent [G, D], _)`` runs under
    ``torch.no_grad()``; ``regional_apply(roi_raw, roi_latent, roi_pred,
    graph) -> [n_roi, C]``."""
    with torch.no_grad():
        pred, grid_latent, _ = global_apply(x_grid)
    correction = regional_apply(x_grid.index_select(0, roi_idx),
                                grid_latent.index_select(0, roi_idx),
                                pred.index_select(0, roi_idx), roi_graph)
    return pred.index_add(0, roi_idx, correction.to(pred.dtype))
