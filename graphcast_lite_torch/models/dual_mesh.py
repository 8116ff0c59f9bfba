"""Dual-mesh regional refinement model (torch counterpart of
``graphcast_lite_tpu.models.dual_mesh``).

~ reference ``src/dual_mesh.py``: a frozen pretrained global model provides
the base forecast plus latents; a trainable regional module over a refined
icosahedral mesh (level 7/8 minus the global prefix) predicts a correction
added to the ROI grid points:

  output = global_pred + scatter(correction, roi_idx)

The regional module never contains the global model: ``dual_mesh_forward``
runs the global model's ``with_latents`` forward under ``torch.no_grad()``
and feeds (global_pred, grid_latent, processed_mesh_latent) into
``DualMeshRegional``.

Sub-modules (reference line refs):
  * RegionalEncoder (:401-426): MLP on [raw ROI features ‖ global grid
    latent], scatter-mean onto the regional mesh.
  * CrossMessageLayer (:302-359): one global→regional message from the
    PROCESSED global mesh latents + residual + node LayerNorm.
  * RegionalProcessor (:364-396): shared-weight InteractionNetLayer × steps
    (the plain step; at 131,072 edges or more and 128-multiple widths it
    trains through the fused edge unit, ``models.gnn``).
  * RegionalDecoder (:429-474): IDW-weighted scatter-sum + raw-feature skip
    connection, output head with small-scale (σ=0.01) init.

Every row gather whose table needs a gradient passes its index's sorted
CSR to ``ops.gather.gather_rows``, so its adjoint is the segment-sum
kernel; the global latents are detached, so the cross graph's sender
gather has no adjoint.  Parameter names are the JAX package's flax names
(``utils.params.from_flax_params`` maps a flax tree of the module onto
it).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..graphs.regional import RegionalGraphs
from ..graphs.structure import Graph
from ..ops import segment as seg_ops
from ..ops.gather import gather_rows
from .gnn import InteractionNetLayer
from .nn import PReLU, PyGLayerNorm, TorchLinear, resolve_activation

__all__ = ["RegionalDeviceGraphs", "CrossMessageLayer", "RegionalProcessor",
           "DualMeshRegional", "dual_mesh_forward"]


@dataclasses.dataclass
class RegionalDeviceGraphs:
    """The regional graph bundle as tensors (``to`` moves and casts it)."""

    processing: Graph
    cross_g2r: Graph
    encoding: Graph
    decoding: Graph
    dec_idw: torch.Tensor       # [E_dec_pad] float
    roi_idx: torch.Tensor       # [n_roi] int64, ascending
    n_reg_mesh: int = 0
    n_roi: int = 0
    num_grid_nodes: int = 0

    @classmethod
    def from_host(cls, rg: RegionalGraphs, num_grid_nodes: int):
        return cls(
            processing=rg.processing, cross_g2r=rg.cross_g2r,
            encoding=rg.encoding, decoding=rg.decoding,
            dec_idw=torch.as_tensor(rg.dec_idw, dtype=torch.float32),
            roi_idx=torch.as_tensor(rg.roi_idx, dtype=torch.int64),
            n_reg_mesh=rg.n_reg_mesh, n_roi=rg.n_roi,
            num_grid_nodes=num_grid_nodes,
        )

    def to(self, device=None, float_dtype=None) -> "RegionalDeviceGraphs":
        """Copy onto ``device``, casting the float arrays to
        ``float_dtype`` when given."""
        return dataclasses.replace(
            self,
            processing=self.processing.to(device, float_dtype),
            cross_g2r=self.cross_g2r.to(device, float_dtype),
            encoding=self.encoding.to(device, float_dtype),
            decoding=self.decoding.to(device, float_dtype),
            dec_idw=self.dec_idw.to(device=device,
                                    dtype=float_dtype or torch.float32),
            roi_idx=self.roi_idx.to(device=device),
        )


class _SiluMLP(nn.Module):
    """Linear -> SiLU -> Linear (children ``lin_0``, ``lin_1``)."""

    def __init__(self, in_features: int, hidden: int, out: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.lin_0 = TorchLinear(in_features, hidden, generator=generator)
        self.lin_1 = TorchLinear(hidden, out, generator=generator)

    def forward(self, x):
        return self.lin_1(F.silu(self.lin_0(x)))


class _SmallInitLinear(nn.Module):
    """Linear with an N(0, 0.01) kernel and a zero bias (a near-zero
    correction at init, but non-zero so gradients reach upstream
    modules)."""

    def __init__(self, in_features: int, features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel = nn.Parameter(0.01 * torch.randn(
            (in_features, features), generator=generator))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        return x @ self.kernel + self.bias


class CrossMessageLayer(nn.Module):
    """Global→regional message + residual + node LayerNorm (children
    ``g2r_edge_mlp``, ``norm_reg``)."""

    def __init__(self, global_dim: int, node_dim: int, edge_dim: int,
                 hidden_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.g2r_edge_mlp = _SiluMLP(global_dim + node_dim + edge_dim,
                                     hidden_dim, node_dim, generator)
        self.norm_reg = PyGLayerNorm(node_dim, mode="node")

    def forward(self, h_global, h_regional, cross: Graph, cross_edge_attr):
        sender = gather_rows(h_global, cross.senders,
                             (cross.s_perm, cross.s_indptr))
        receiver = gather_rows(h_regional, cross.receivers,
                               (None, cross.indptr))
        msg = self.g2r_edge_mlp(
            torch.cat([sender, receiver, cross_edge_attr], dim=-1))
        agg = seg_ops.aggregate_mean(msg, cross)
        return self.norm_reg(h_regional + agg)


class RegionalProcessor(nn.Module):
    """One shared-weight ``InteractionNetLayer`` (child ``step``, the plain
    step) applied ``num_steps`` times after a raw-edge encoder."""

    def __init__(self, node_dim: int, hidden_dim: int, num_steps: int = 4,
                 raw_edge_dim: int = 4, activation: str = "swish",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_steps = num_steps
        self._act = resolve_activation(activation)
        self.edge_encoder_lin = TorchLinear(raw_edge_dim, node_dim,
                                            generator=generator)
        self.edge_encoder_act = PReLU() if self._act is None else None
        self.step = InteractionNetLayer(node_dim, node_dim, hidden_dim,
                                        activation, use_layer_norm=True,
                                        generator=generator)

    def forward(self, x, graph: Graph):
        e = self.edge_encoder_lin(graph.edge_attr)
        e = self.edge_encoder_act(e) if self._act is None else self._act(e)
        for _ in range(self.num_steps):
            x, e = self.step(x, e, graph)
        return x


class DualMeshRegional(nn.Module):
    """The trainable regional correction module: ROI raw features [n_roi,
    raw_dim] + the global grid latents at the ROI [n_roi, latent_dim] +
    the processed global mesh latents [M, latent_dim] -> the ROI
    correction [n_roi, output_channels]."""

    def __init__(self, raw_dim: int, latent_dim: int, hidden_dim: int = 256,
                 output_channels: int = 19, processor_steps: int = 4,
                 raw_edge_dim: int = 4,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        roi_in = raw_dim + latent_dim
        self.reg_encoder = _SiluMLP(roi_in, hidden_dim, hidden_dim,
                                    generator)
        self.cross_edge_lin = TorchLinear(raw_edge_dim, hidden_dim,
                                          generator=generator)
        self.cross_message = CrossMessageLayer(latent_dim, hidden_dim,
                                               hidden_dim, hidden_dim,
                                               generator)
        self.reg_processor = RegionalProcessor(
            hidden_dim, hidden_dim, processor_steps, raw_edge_dim,
            generator=generator)
        self.dec_lin0 = TorchLinear(hidden_dim + roi_in, hidden_dim,
                                    generator=generator)
        self.dec_out = _SmallInitLinear(hidden_dim, output_channels,
                                        generator)

    def forward(self, roi_raw, roi_grid_latent, global_mesh_latent,
                graphs: RegionalDeviceGraphs):
        roi_input = torch.cat([roi_raw, roi_grid_latent], dim=-1)
        enc, dec = graphs.encoding, graphs.decoding

        # Encoder: MLP, then the scatter-mean grid -> regional mesh.
        x = self.reg_encoder(roi_input)
        msg = gather_rows(x, enc.senders, (enc.s_perm, enc.s_indptr))
        mesh_feat = seg_ops.aggregate_mean(msg, enc)

        # Cross message from the processed global mesh latents.
        cross_attr = F.silu(self.cross_edge_lin(graphs.cross_g2r.edge_attr))
        mesh_feat = self.cross_message(global_mesh_latent, mesh_feat,
                                       graphs.cross_g2r, cross_attr)

        # Regional processing (shared weights).
        mesh_feat = self.reg_processor(mesh_feat, graphs.processing)

        # Decoder: IDW-weighted scatter-sum + skip connection + small head.
        mesh_msg = gather_rows(mesh_feat, dec.senders,
                               (dec.s_perm, dec.s_indptr))
        grid_agg = seg_ops.aggregate_sum(mesh_msg * graphs.dec_idw[:, None],
                                         dec)
        h = F.silu(self.dec_lin0(torch.cat([grid_agg, roi_input], dim=-1)))
        return self.dec_out(h)


def dual_mesh_forward(global_apply: Callable, regional_apply: Callable,
                      x_grid: torch.Tensor,
                      graphs: RegionalDeviceGraphs) -> torch.Tensor:
    """The frozen global model plus the regional correction.

    ``global_apply(x_grid) -> (pred [G, C], grid_latent [G, D],
    processed_mesh_latent [M, D])`` runs under ``torch.no_grad()`` (the
    reference freezes the global model); ``regional_apply(roi_raw,
    roi_latent, mesh_latent) -> [n_roi, C]``.  The correction is added to
    the prediction's ROI rows (``roi_idx`` is unique)."""
    with torch.no_grad():
        pred, grid_latent, mesh_latent = global_apply(x_grid)
    roi = graphs.roi_idx
    correction = regional_apply(x_grid.index_select(0, roi),
                                grid_latent.index_select(0, roi),
                                mesh_latent)
    return pred.index_add(0, roi, correction.to(pred.dtype))
