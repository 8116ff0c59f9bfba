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

from .unet import per_sample_statistics

__all__ = ["GridImageModel"]


class GridImageModel(nn.Module):
    """``forward(x [G, obs·C], graphs, edge_mask, thr, prune) -> (delta
    [G, C], edge_mask)``; the graphs and the mask are ignored (a CNN needs
    no graph), the image is ``[1, obs·C, n_lat, n_lon]``.  A batch x [B,
    G, obs·C] -> [B, G, C] is one call on ``[B, obs·C, n_lat, n_lon]``
    under ``per_sample_statistics()``, so that each sample is normalized
    by its own statistics, as the JAX package's ``vmap`` of the
    single-image model does."""

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
        lead = x.shape[:-2]
        img = x.reshape((-1, self.n_lat, self.n_lon, x.shape[-1]))
        # NCHW-contiguous: the permuted view has channels-last strides,
        # which would send the convolutions to cuDNN's NHWC algorithms.
        img = img.permute(0, 3, 1, 2).contiguous()
        with per_sample_statistics():
            out = self.image_module(img)
        return (out.permute(0, 2, 3, 1)
                .reshape(lead + (self.num_grid_nodes, out.shape[1])),
                edge_mask)
