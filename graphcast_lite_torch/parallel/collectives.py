"""Differentiable collectives over a ``torch.distributed`` group.

Inside ``jax.shard_map`` the JAX package differentiates through
``all_gather``, ``ppermute`` and ``psum`` for free (JAX transposes each
collective).  Here every rank is a process that runs ``backward`` on its
own local loss, so each collective is a ``torch.autograd.Function`` whose
backward is the exact adjoint of its forward, taken over the same group:

* ``all_gather_rows(x, group)``: the tiled all-gather, [n, F] -> [S·n, F]
  with rank i's rows at block i.  Rank r receives a cotangent for every
  block; the gradient of its own rows is the sum over ranks of their
  cotangents' block r: a reduce-scatter.
* ``ppermute_rows(x, pairs, group)``: one round of point-to-point sends,
  (src, dst) pairs of group ranks, each rank the source of any number of
  pairs and the destination of at most one; a rank with no source gets
  zeros, as ``jax.lax.ppermute`` gives.  The adjoint is the same round
  with every pair reversed.
* ``all_reduce_sum(x, group)``: the sum over the group, on every rank.  Its
  adjoint is the sum of the ranks' cotangents, an all-reduce again.  This
  is what makes a graph-mode LayerNorm's statistics or a loss summed over
  ranks give each rank the global gradient when every rank runs backward
  on its own local numerator.

Rows are the second-to-last axis: a batch [B, n, F] of B samples' rows
goes through ONE collective whatever B is (the gather gives [B, S·n, F],
each sample's blocks in rank order, as ``jax.vmap`` of the collective
does), and a [n, F] input is one sample.  The all-gather and its
reduce-scatter move the row axis first for the transfer (one copy on the
device) and back after.

Ranks are group ranks; the point-to-point calls convert them to global
ranks.  ``broadcast_`` and ``all_reduce_`` are the in-place, undifferentiated
forms the train step uses for parameters, gradients and denominators.

The transport follows the group's backend, never a caught error: under
``nccl`` the tensors go on the card directly (``all_gather_into_tensor``,
``reduce_scatter_tensor``); under ``gloo`` a CUDA tensor is copied to a
host buffer (a batch in one transfer), the collective runs there and the
result is copied back (gloo has no reduce-scatter: its adjoint is an all-reduce of the whole
cotangent, of which the rank keeps its block, the same sum).  That is how
several ranks share one card, where NCCL allows one rank a device.
``transport`` counts the collectives and the bytes and host seconds of
those copies; nothing moves compute to the host.
"""

from __future__ import annotations

import time
from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["all_gather_rows", "ppermute_rows", "all_reduce_sum",
           "all_reduce_", "broadcast_", "transport", "reset_transport"]

# Collectives run, and the bytes copied to and from the host for gloo (both
# directions) with the host seconds those copies took.
transport: Dict[str, float] = {"collectives": 0, "staged_bytes": 0,
                               "staged_s": 0.0}


def reset_transport() -> None:
    transport.update(collectives=0, staged_bytes=0, staged_s=0.0)


def _backend(group) -> str:
    return dist.get_backend(group)


def _staged(t: torch.Tensor, group) -> bool:
    """A CUDA tensor under gloo goes through a host buffer."""
    return t.is_cuda and _backend(group) == "gloo"


def _host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of a CUDA tensor, counted in ``transport``."""
    t0 = time.perf_counter()
    h = t.detach().to("cpu")
    transport["staged_s"] += time.perf_counter() - t0
    transport["staged_bytes"] += h.numel() * h.element_size()
    return h


def _device(h: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``h`` back on ``like``'s card, counted in ``transport``."""
    t0 = time.perf_counter()
    out = h.to(like.device)
    torch.cuda.current_stream(like.device).synchronize()
    transport["staged_s"] += time.perf_counter() - t0
    transport["staged_bytes"] += h.numel() * h.element_size()
    return out


def _buffer(t: torch.Tensor, group) -> torch.Tensor:
    """What a collective runs on: a host copy of a CUDA tensor under gloo,
    else ``t`` itself (contiguous)."""
    transport["collectives"] += 1
    return _host(t) if _staged(t, group) else t.detach().contiguous()


def _back(buf: torch.Tensor, like: torch.Tensor, group) -> torch.Tensor:
    return _device(buf, like) if _staged(like, group) else buf


def _global(group, group_rank: int) -> int:
    if group is None or group is dist.group.WORLD:
        return group_rank
    return dist.get_global_rank(group, group_rank)


# ---- the plain collectives -----------------------------------------------


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over the group, in place; returns ``t``."""
    buf = _buffer(t, group)
    dist.all_reduce(buf, group=group)
    if buf.data_ptr() != t.data_ptr():
        t.copy_(_back(buf, t, group))
    return t


def broadcast_(t: torch.Tensor, src_group_rank: int, group) -> torch.Tensor:
    """``t`` of the group's rank ``src_group_rank`` on every rank, in place."""
    buf = _buffer(t, group)
    dist.broadcast(buf, src=_global(group, src_group_rank), group=group)
    if buf.data_ptr() != t.data_ptr():
        t.copy_(_back(buf, t, group))
    return t


def _rows_first(t: torch.Tensor) -> torch.Tensor:
    """A batch [B, n, F] as [n, B, F] (contiguous), so that the collectives
    over rows run on axis 0; a [n, F] tensor as it is."""
    return t.movedim(-2, 0).contiguous() if t.dim() > 2 else t


def _rows_back(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return t.movedim(0, -2) if like.dim() > 2 else t


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    xr = _rows_first(x)
    buf = _buffer(xr, group)
    if _backend(group) == "nccl":
        out = buf.new_empty((n * buf.shape[0],) + tuple(buf.shape[1:]))
        dist.all_gather_into_tensor(out, buf, group=group)
        return _rows_back(out, x)
    parts = [torch.empty_like(buf) for _ in range(n)]
    dist.all_gather(parts, buf, group=group)
    return _rows_back(_back(torch.cat(parts, dim=0), xr, group), x)


def _reduce_scatter(g: torch.Tensor, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    gr = _rows_first(g)
    rows = gr.shape[0] // n
    buf = _buffer(gr, group)
    if _backend(group) == "nccl":
        out = buf.new_empty((rows,) + tuple(buf.shape[1:]))
        dist.reduce_scatter_tensor(out, buf, group=group)
        return _rows_back(out, g)
    # gloo has no reduce-scatter: the whole sum (in a copy: the cotangent
    # is not ours to change), of which this rank keeps its block.
    buf = buf.clone() if buf.data_ptr() == g.data_ptr() else buf
    dist.all_reduce(buf, group=group)
    r = dist.get_rank(group)
    return _rows_back(_back(buf[r * rows:(r + 1) * rows].contiguous(), gr,
                            group), g)


def _ppermute(x: torch.Tensor, pairs: Sequence[Tuple[int, int]],
              group) -> torch.Tensor:
    me = dist.get_rank(group)
    dsts = [d for s, d in pairs if s == me]
    srcs = [s for s, d in pairs if d == me]
    if len(srcs) > 1:
        raise ValueError(f"ppermute: rank {me} receives from {srcs}")
    if not dsts and not srcs:
        return torch.zeros_like(x)
    buf = _buffer(x, group)
    ops: List[dist.P2POp] = [
        dist.P2POp(dist.isend, buf, _global(group, d), group) for d in dsts]
    recv = None
    if srcs:
        recv = torch.zeros_like(buf)
        ops.append(dist.P2POp(dist.irecv, recv, _global(group, srcs[0]),
                              group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return torch.zeros_like(x) if recv is None else _back(recv, x, group)


# ---- the differentiable ones -----------------------------------------------


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group), None


class _PpermuteRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pairs, group):
        ctx.pairs, ctx.group = pairs, group
        return _ppermute(x, pairs, group)

    @staticmethod
    def backward(ctx, g):
        back = [(d, s) for s, d in ctx.pairs]
        return _ppermute(g, back, ctx.group), None, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.detach().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.detach().clone(), ctx.group), None


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """[n, F] on each of the group's S ranks -> [S·n, F], rank i's rows at
    block i (``jax.lax.all_gather(x, axis, tiled=True)``); a batch [B, n,
    F] -> [B, S·n, F] in one collective."""
    return _AllGatherRows.apply(x, group)


def ppermute_rows(x: torch.Tensor, pairs: Sequence[Tuple[int, int]],
                  group) -> torch.Tensor:
    """``x`` of rank src at rank dst for each (src, dst) pair of group
    ranks; zeros at a rank that is no pair's destination
    (``jax.lax.ppermute``).  Any shape; a batch is one round."""
    return _PpermuteRows.apply(x, tuple(tuple(p) for p in pairs), group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the group's ranks, on each
    (``jax.lax.psum``).  Any shape; a batch is one all-reduce."""
    return _AllReduceSum.apply(x, group)
