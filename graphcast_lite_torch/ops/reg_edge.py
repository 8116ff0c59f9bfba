"""Edge unit of the regular-block processor layout (torch counterpart of
``graphcast_lite_tpu.ops.reg_edge``: ``_tile_expand``, ``_slice_sum``,
``_fwd_impl`` and the custom VJP ``_fwd`` / ``_bwd``).

On the constant-degree per-level layout (``graphs.structure.RegularBlocks``)
the InteractionNet edge step needs no receiver gather and no segment sum:

  u       = act(take(xs, snd) + tile(xr) + v @ W1e' + b1') @ W2 + b2
  agg_sum = per-block k-slice sums of (u · mask)

``reg_edge_tail`` is an ``autograd.Function`` whose backward follows the
reference's ``_bwd`` step by step: it saves ``h_pre``, takes the receiver
adjoints structurally (the tile's adjoint is the slice sum, the slice
sum's is the tile times the mask) and sends the one irreducible scatter,
the sender side, through the segment-sum kernel over the blocks'
sender-sorted CSR (``RegularBlocks.s_perm`` / ``s_indptr``).  Padding rows
(mask 0) get exact zero cotangents, so that scatter needs no masking.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from . import cuda_segment

__all__ = ["RegStatic", "reg_edge_tail"]


@dataclasses.dataclass(frozen=True)
class RegStatic:
    block_recv: Tuple[int, ...]
    block_k: Tuple[int, ...]
    num_nodes: int
    activation: str


def _act_fn(name: str):
    if name in ("swish", "silu"):
        return F.silu
    if name == "relu":
        return F.relu
    raise ValueError(name)


def _tile_expand(static: RegStatic, nodes: torch.Tensor,
                 rows_pad: int) -> torch.Tensor:
    """[M, F] node rows -> [rows_pad, F] block rows (slot-major tiles)."""
    parts = [nodes[:v_sz].repeat(k, 1)
             for v_sz, k in zip(static.block_recv, static.block_k)]
    out = torch.cat(parts, dim=0)
    if out.shape[0] < rows_pad:
        out = F.pad(out, (0, 0, 0, rows_pad - out.shape[0]))
    return out


def _slice_sum(static: RegStatic, rows: torch.Tensor) -> torch.Tensor:
    """[rows_pad, F] block rows -> [M, F] per-receiver sums (fp32 within a
    block, then the blocks added in the rows' dtype)."""
    m = static.num_nodes
    total = None
    off = 0
    for v_sz, k in zip(static.block_recv, static.block_k):
        blk = rows[off:off + v_sz].float()
        for s_i in range(1, k):
            blk = blk + rows[off + s_i * v_sz:
                             off + (s_i + 1) * v_sz].float()
        blk = blk.to(rows.dtype)
        if v_sz < m:
            blk = F.pad(blk, (0, 0, 0, m - v_sz))
        total = blk if total is None else total + blk
        off += v_sz * k
    return total


def _fwd_impl(static, x, v, mask, snd, w1s, w1r, w1e_eff, b1_eff, w2, b2):
    act = _act_fn(static.activation)
    xs = x @ w1s
    xr = x @ w1r
    rows_pad = snd.shape[0]
    h_pre = (
        xs.index_select(0, snd)
        + _tile_expand(static, xr, rows_pad)
        + v @ w1e_eff
        + b1_eff
    )
    u = act(h_pre) @ w2 + b2
    agg_sum = _slice_sum(static, u * mask[:, None].to(u.dtype))
    return u, agg_sum, h_pre


def _act_and_grad(name: str, h_pre: torch.Tensor):
    """(act(h_pre), d act / d h_pre) in h_pre's dtype."""
    if name in ("swish", "silu"):
        s = torch.sigmoid(h_pre)
        return h_pre * s, s * (1 + h_pre * (1 - s))
    if name == "relu":
        return F.relu(h_pre), (h_pre > 0).to(h_pre.dtype)
    raise ValueError(name)


class _RegEdgeTail(torch.autograd.Function):
    @staticmethod
    def forward(ctx, static, x, v, mask, snd, s_perm, s_indptr, w1s, w1r,
                w1e_eff, b1_eff, w2, b2):
        u, agg_sum, h_pre = _fwd_impl(
            static, x, v, mask, snd, w1s, w1r, w1e_eff, b1_eff, w2, b2
        )
        ctx.static = static
        ctx.save_for_backward(x, v, mask, s_perm, s_indptr, w1s, w1r,
                              w1e_eff, w2, h_pre)
        return u, agg_sum

    @staticmethod
    def backward(ctx, d_u, d_agg):
        (x, v, mask, s_perm, s_indptr, w1s, w1r, w1e_eff, w2,
         h_pre) = ctx.saved_tensors
        static = ctx.static
        rows_pad = h_pre.shape[0]
        # d(agg_sum) enters u through the masked slice sum: its adjoint is
        # the tile-expand (a broadcast) times the mask.
        d_u_tot = d_u + mask[:, None].to(d_u.dtype) * _tile_expand(
            static, d_agg, rows_pad
        )
        h, act_grad = _act_and_grad(static.activation, h_pre)
        d_w2 = h.T @ d_u_tot
        d_b2 = d_u_tot.sum(dim=0)
        d_hp = (d_u_tot @ w2.T) * act_grad          # [rows_pad, H]
        d_b1 = d_hp.sum(dim=0)
        d_v = d_hp @ w1e_eff.T
        d_w1e = v.T @ d_hp
        # Receiver side: the slice sum (the tile's adjoint).  Sender side:
        # the one irreducible scatter, through the segment-sum kernel over
        # the sender-sorted rows.
        d_xr = _slice_sum(static, d_hp)
        d_xs = cuda_segment.segment_sum(d_hp.index_select(0, s_perm),
                                        s_indptr, static.num_nodes)
        d_x = d_xs @ w1s.T + d_xr @ w1r.T
        d_w1s = x.T @ d_xs
        d_w1r = x.T @ d_xr
        return (None, d_x, d_v, None, None, None, None, d_w1s, d_w1r,
                d_w1e, d_b1, d_w2, d_b2)


def reg_edge_tail(static: RegStatic, x, v, mask, snd, s_perm, s_indptr,
                  w1s, w1r, w1e_eff, b1_eff, w2, b2):
    """Returns (u [rows_pad, De], agg_sum [M, De]) — mask pre-applied to
    the aggregation only (the caller divides by the degree).
    ``s_perm`` / ``s_indptr``: the senders' sorted CSR over the M rows,
    read by the backward only."""
    args = (x, v, w1s, w1r, w1e_eff, b1_eff, w2, b2)
    if not (torch.is_grad_enabled() and any(a.requires_grad for a in args)):
        u, agg_sum, _ = _fwd_impl(static, x, v, mask, snd, w1s, w1r,
                                  w1e_eff, b1_eff, w2, b2)
        return u, agg_sum
    return _RegEdgeTail.apply(static, x, v, mask, snd, s_perm, s_indptr,
                              w1s, w1r, w1e_eff, b1_eff, w2, b2)
