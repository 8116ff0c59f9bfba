"""Edge unit of the regular-block processor layout, forward only
(torch counterpart of ``graphcast_lite_tpu.ops.reg_edge``: ``_tile_expand``,
``_slice_sum`` and ``_fwd_impl``).

On the constant-degree per-level layout (``graphs.structure.RegularBlocks``)
the InteractionNet edge step needs no receiver gather and no segment sum:

  u       = act(take(xs, snd) + tile(xr) + v @ W1e' + b1') @ W2 + b2
  agg_sum = per-block k-slice sums of (u · mask)

The backward (an ``autograd.Function`` whose sender scatter is the segment
kernel) comes with training.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

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


def reg_edge_tail(static: RegStatic, x, v, mask, snd, w1s, w1r, w1e_eff,
                  b1_eff, w2, b2):
    """Returns (u [rows_pad, De], agg_sum [M, De]) — mask pre-applied to
    the aggregation only (the caller divides by the degree)."""
    u, agg_sum, _ = _fwd_impl(
        static, x, v, mask, snd, w1s, w1r, w1e_eff, b1_eff, w2, b2
    )
    return u, agg_sum
