"""Sorted segment sum: the hand-written CUDA kernel and its plain version.

The counterpart of ``graphcast_lite_tpu/ops/pallas_segment.py:
segment_sum_sorted`` (forward; the TPU kernel sums 1024-edge chunks into
receiver tiles as one-hot MXU products).  ``segment_sum(msgs, indptr, R)``
returns ``out[..., r, :] = Σ_{e ∈ [indptr[r], indptr[r+1])} msgs[..., e, :]``
with fp32 accumulation, in the messages' dtype, zeros in empty rows.
Messages are receiver-sorted and pre-masked (padding rows are zero);
``indptr`` is the graph's receiver CSR offsets
(``graphs.structure.Graph.indptr``).

* On a CPU tensor the wrapper runs ``segment_sum_reference``, the plain
  torch version (fp32 ``index_add_``, then a cast).
* On a CUDA tensor it launches ``csrc/segment_sum.cu`` or raises; it never
  falls back.  The kernel is built by ``ops.nvcc_build`` at first use.
* It is differentiable: the adjoint of a segment sum is a gather of the
  cotangent by receiver id (``g.index_select(-2, receiver_ids)``, the
  JAX package's VJP, ``ops/pallas_segment.py:_segment_sum_bwd``), with the
  ids read off ``indptr`` and clipped into range, so message rows past
  ``indptr[R]`` read row R - 1 (they are padding rows, which the callers
  mask).

It is bound by bytes: one add per message element, one read of msgs and
one write of out (193 MB, about 58 us on an H100 at the flagship encoder
shape in bf16).  ``segment_design`` mirrors the library's choice of design
by shape (``gclt_segment_sum_design``):

* ``"balanced"`` (fp32 or bf16 rows of 256-1024 bytes, a multiple of 16,
  on 16-byte aligned tensors; the flagship's F = 256 in both): the merged
  sequence of row ends and edges is cut into tiles of ``TILE_ITEMS`` items
  (``tile_partition``; a boundary inside a shorter row moves back to its
  start), one a warp, handed out in order as warps finish; each warp
  streams its edge rows into shared memory by bulk copies and sums them in
  fp32 registers.  A long row that crosses tiles (``split_rows``) is
  summed from its tiles' fp32 pieces, in tile order, by the last of them
  to finish (an integer arrival counter a tile, no floating-point
  atomics), so two launches give bitwise-equal results.  The wrapper keeps
  the pieces' workspace and the counters (zero between launches) per
  device and stream.
* ``"warp"`` (every other shape: F = 19, bf16 F = 64, fp32 F = 512,
  misaligned views): one warp per receiver row, the design of the first
  port; on rows narrower than 16 lanes' worth (F = 19), the warp's lanes
  form groups that sum every groups-th edge, added in group order.

``design=`` forces one of the two (raising where ``"balanced"`` cannot
run); only measurements use it.  ``launches`` counts wrapper calls that
launched the kernel (one a call, never plain-version calls);
``launches_by_csr`` counts the same launches by the CSR and shape they
ran at, keyed ``(indptr.data_ptr(), R, E, F)``, so that a measurement can
tell apart the callers of one run.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, Optional, Tuple

import torch

from . import nvcc_build

__all__ = [
    "SOURCE",
    "SIGNATURES",
    "DESIGNS",
    "TILE_ITEMS",
    "launches",
    "launches_by_csr",
    "segment_design",
    "tile_partition",
    "split_rows",
    "segment_sum",
    "segment_sum_reference",
]

SOURCE = os.path.join(nvcc_build.CSRC, "segment_sum.cu")
launches = 0
launches_by_csr: Dict[Tuple[int, int, int, int], int] = {}

# The designs of csrc/segment_sum.cu, by their code in its C interface.
DESIGNS = {"warp": 0, "balanced": 1}
# Merge items a tile, and the row widths in bytes, of the balanced design
# (csrc/segment_sum.cu: kTileItems, kMinRowBytes, kMaxRowBytes).
TILE_ITEMS = 20
MIN_ROW_BYTES = 256
MAX_ROW_BYTES = 1024
# The C interface of csrc/segment_sum.cu.
SIGNATURES = {
    "gclt_segment_sum": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # msgs, indptr, out
        ctypes.c_void_p, ctypes.c_longlong,                  # workspace, bytes
        ctypes.c_void_p,                                     # counters
        ctypes.c_int, ctypes.c_int, ctypes.c_int,            # dtype, R, E
        ctypes.c_int, ctypes.c_int,                          # F, B
        ctypes.c_longlong, ctypes.c_longlong,                # batch strides
        ctypes.c_int,                                        # design
        ctypes.c_void_p,                                     # stream
    ]),
    "gclt_segment_sum_design": (ctypes.c_int, [ctypes.c_int] * 3),
    "gclt_segment_sum_tile_items": (ctypes.c_int, []),
}
# The balanced design's scratch, by (device, stream): the fp32 pieces of
# split rows (written before they are read) and the arrival counters (zero
# when made; every launch leaves them zero).  Kept from launch to launch,
# grown as needed, so that no launch allocates or clears them; one set a
# stream keeps launches on two streams apart.
_scratch: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def segment_design(dtype: torch.dtype, num_features: int,
                   aligned: bool = True) -> str:
    """The design the library takes for rows of ``num_features`` values of
    ``dtype`` (``aligned``: msgs and out 16-byte aligned, as a contiguous
    tensor of 16-byte rows is): ``"balanced"`` or ``"warp"``."""
    if dtype not in nvcc_build.DTYPE_CODES:
        return "warp"
    row_bytes = num_features * dtype.itemsize
    ok = (aligned and row_bytes % 16 == 0
          and MIN_ROW_BYTES <= row_bytes <= MAX_ROW_BYTES)
    return "balanced" if ok else "warp"


def tile_partition(indptr: torch.Tensor,
                   num_edges: Optional[int] = None) -> torch.Tensor:
    """[tiles + 1, 2] int64: (rows ended, edges taken) at the start of each
    tile of the balanced design, and (R, E) last, as the kernel finds them.

    Row end r sits at index ``indptr[r+1] + r`` of the merged sequence of
    R row ends and E edges (``num_edges``, the message rows; by default
    indptr[R]).  Tile k begins at item ``k * TILE_ITEMS``, moved back to the
    start of the row under way there unless that row has ``TILE_ITEMS``
    items (edges and end) or more."""
    ip = indptr.to(torch.int64).cpu()
    r = ip.numel() - 1
    total = r + (int(ip[-1]) if num_edges is None else num_edges)
    tiles = -(-total // TILE_ITEMS)
    d = torch.clamp(torch.arange(tiles + 1, dtype=torch.int64) * TILE_ITEMS,
                    max=total)
    end_index = ip[1:] + torch.arange(r, dtype=torch.int64)
    rows = torch.searchsorted(end_index, d)  # row ends before each d
    edges = d - rows
    beg = ip[rows.clamp(max=r - 1)]
    items = ip[(rows + 1).clamp(max=r)] - beg + 1
    snap = (rows < r) & (edges > beg) & (items < TILE_ITEMS)
    return torch.stack([rows, torch.where(snap, beg, edges)], dim=1)


def split_rows(indptr: torch.Tensor) -> torch.Tensor:
    """The rows whose items fall in more than one tile (the rows that the
    last of their tiles to finish stores), ascending: rows of
    ``TILE_ITEMS`` items or more whose first edge and end lie in different
    tiles."""
    ip = indptr.to(torch.int64).cpu()
    rows = torch.arange(ip.numel() - 1, dtype=torch.int64)
    first = ip[:-1] + rows  # merge index of each row's first edge
    last = ip[1:] + rows    # merge index of its end
    long = last - first + 1 >= TILE_ITEMS
    return rows[long & (first // TILE_ITEMS != last // TILE_ITEMS)]


def segment_sum_reference(msgs: torch.Tensor, indptr: torch.Tensor,
                          num_receivers: int) -> torch.Tensor:
    """Plain torch version: fp32 ``index_add_`` over the rows
    ``[0, indptr[-1])``, then one cast to the messages' dtype (float64
    messages accumulate in float64)."""
    counts = (indptr[1:] - indptr[:-1]).long()
    recv = torch.repeat_interleave(
        torch.arange(num_receivers, device=msgs.device), counts
    )
    n = recv.numel()
    acc = torch.promote_types(msgs.dtype, torch.float32)
    out = torch.zeros(msgs.shape[:-2] + (num_receivers, msgs.shape[-1]),
                      dtype=acc, device=msgs.device)
    out.index_add_(-2, recv, msgs[..., :n, :].to(acc))
    return out.to(msgs.dtype)


class _SegmentSum(torch.autograd.Function):
    """The segment sum with the JAX package's VJP: a gather of the
    cotangent by receiver id, clipped into range."""

    @staticmethod
    def forward(ctx, msgs, indptr, num_receivers, design):
        ctx.save_for_backward(indptr)
        ctx.num_edges = msgs.shape[-2]
        return _segment_sum(msgs, indptr, num_receivers, design)

    @staticmethod
    def backward(ctx, g):
        (indptr,) = ctx.saved_tensors
        edges = torch.arange(ctx.num_edges, dtype=indptr.dtype,
                             device=indptr.device)
        ids = torch.searchsorted(indptr[1:], edges, right=True)
        ids = ids.clamp_(max=indptr.numel() - 2)
        return g.index_select(-2, ids), None, None, None


def segment_sum(msgs: torch.Tensor, indptr: torch.Tensor,
                num_receivers: int,
                design: Optional[str] = None) -> torch.Tensor:
    """Sum receiver-sorted messages [E, F] or [B, E, F] into [..., R, F];
    differentiable in ``msgs``.

    ``design`` (``"warp"`` or ``"balanced"``) forces the kernel's design on
    a CUDA tensor; by default the library picks it by shape."""
    if torch.is_grad_enabled() and msgs.requires_grad:
        return _SegmentSum.apply(msgs, indptr, num_receivers, design)
    return _segment_sum(msgs, indptr, num_receivers, design)


def _segment_sum(msgs: torch.Tensor, indptr: torch.Tensor,
                 num_receivers: int,
                 design: Optional[str] = None) -> torch.Tensor:
    """``segment_sum``'s forward: the plain version on the CPU, the kernel
    on the card."""
    if design is not None and design not in DESIGNS:
        raise ValueError(f"segment_sum: unknown design {design!r}")
    if msgs.device.type == "cpu":
        return segment_sum_reference(msgs, indptr, num_receivers)
    if msgs.device.type != "cuda":
        raise ValueError(f"segment_sum: unsupported device {msgs.device}")
    if indptr.device != msgs.device:
        raise ValueError("segment_sum: msgs and indptr on different devices")
    if msgs.dtype not in nvcc_build.DTYPE_CODES:
        raise TypeError(f"segment_sum: dtype {msgs.dtype} (fp32/bf16 only)")
    if indptr.dtype != torch.int32:
        raise TypeError("segment_sum: indptr must be int32")
    if msgs.dim() not in (2, 3) or indptr.dim() != 1 \
            or indptr.shape[0] != num_receivers + 1:
        raise ValueError(
            f"segment_sum: msgs {tuple(msgs.shape)} / indptr "
            f"{tuple(indptr.shape)} / R {num_receivers}"
        )
    if not (msgs.is_contiguous() and indptr.is_contiguous()):
        raise ValueError("segment_sum: msgs and indptr must be contiguous")
    batch = msgs.shape[0] if msgs.dim() == 3 else 1
    e, f = msgs.shape[-2], msgs.shape[-1]
    out = torch.empty(msgs.shape[:-2] + (num_receivers, f),
                      dtype=msgs.dtype, device=msgs.device)
    if out.numel() == 0:
        return out
    if batch > 65535:
        raise ValueError(f"segment_sum: batch {batch} > 65535")
    if num_receivers + e >= 2 ** 31:
        raise ValueError(f"segment_sum: R + E = {num_receivers + e} >= 2^31")
    aligned = msgs.data_ptr() % 16 == 0
    took = segment_design(msgs.dtype, f, aligned)
    if design == "balanced" and took != "balanced":
        raise ValueError(
            f"segment_sum: the balanced design does not take {msgs.dtype} "
            f"F={f} (aligned: {aligned})")
    code = -1 if design is None else DESIGNS[design]  # -1: the library picks
    took = design or took
    lib = nvcc_build.load(SOURCE, SIGNATURES)
    with torch.cuda.device(msgs.device):
        stream = torch.cuda.current_stream().cuda_stream
        workspace = counters = None
        if took == "balanced":
            tiles = batch * -(-(num_receivers + e) // TILE_ITEMS)
            key = (msgs.device.index, stream)
            workspace, counters = _scratch.get(key, (None, None))
            if workspace is None or workspace.numel() < tiles * 2 * f:
                # fp32 pieces of the split rows [batch, tiles, 2, F].
                workspace = torch.empty(tiles * 2 * f, dtype=torch.float32,
                                        device=msgs.device)
            if counters is None or counters.numel() < tiles:
                counters = torch.zeros(tiles, dtype=torch.int32,
                                       device=msgs.device)
            _scratch[key] = (workspace, counters)
        err = lib.gclt_segment_sum(
            msgs.data_ptr(), indptr.data_ptr(), out.data_ptr(),
            None if workspace is None else workspace.data_ptr(),
            0 if workspace is None else workspace.numel() * 4,
            None if counters is None else counters.data_ptr(),
            nvcc_build.DTYPE_CODES[msgs.dtype], num_receivers, e, f, batch,
            e * f, num_receivers * f, code, stream,
        )
    if err != 0:
        raise RuntimeError(f"segment_sum kernel launch failed: CUDA error {err}")
    global launches
    launches += 1
    key = (indptr.data_ptr(), num_receivers, e, f)
    launches_by_csr[key] = launches_by_csr.get(key, 0) + 1
    return out
