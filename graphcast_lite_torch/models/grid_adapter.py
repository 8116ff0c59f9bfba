"""Adapter: image (H, W) models speak the flat-node model interface (torch
counterpart of ``graphcast_lite_tpu.models.grid_adapter``).

The training, rollout and inference stack works on node-flattened state
[G, obs·C] with G = n_lat·n_lon in lat-major order.  ``GridImageModel``
wraps an NCHW image module (the U-Net family) in that interface, so the
same ``Trainer``, AR rollout and ``evaluate_model`` serve the GNN and the
CNN stacks.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

__all__ = ["GridImageModel"]


class GridImageModel(nn.Module):
    """``forward(x [G, obs·C], graphs, edge_mask, thr, prune) -> (delta
    [G, C], edge_mask)``; the graphs and the mask are ignored (a CNN needs
    no graph), the image is ``[1, obs·C, n_lat, n_lon]``."""

    def __init__(self, image_module: nn.Module, n_lat: int, n_lon: int):
        super().__init__()
        self.image_module = image_module
        self.n_lat, self.n_lon = n_lat, n_lon

    @property
    def num_grid_nodes(self) -> int:
        return self.n_lat * self.n_lon

    def forward(self, x: torch.Tensor, graphs=None,
                edge_mask: Optional[torch.Tensor] = None,
                attention_threshold: float = 0.0, prune: bool = False):
        img = x.reshape(self.n_lat, self.n_lon, x.shape[-1])
        out = self.image_module(img.permute(2, 0, 1)[None])
        return (out[0].permute(1, 2, 0).reshape(self.num_grid_nodes, -1),
                edge_mask)
