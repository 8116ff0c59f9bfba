"""Static padded graph structures (torch counterpart of
``graphcast_lite_tpu.graphs.structure``).

Graphs are built once on the host with NumPy, in exactly the JAX
package's layout:

* COO edges sorted by receiver (stable sort), padded to a multiple of 128
  rows; padding rows carry sender 0, receiver ``num_receivers - 1`` and
  mask 0;
* the mask-static precomputes ``static_in_degree`` and ``gcn_norm``;
* the constant-in-degree structure of the M2G decoder;
* the constant-degree per-level blocks of the multimesh processor
  (``RegularBlocks``, slot-major rows).

In place of the Pallas chunk schedule the graph carries ``indptr``, the
receiver CSR offsets read by the CUDA segment-sum kernel
(``ops.cuda_segment``): receiver ``r`` owns edge rows
``[indptr[r], indptr[r+1])`` of the padded, sorted arrays.  For the
adjoint of the sender gather (``ops.gather``) it also carries the
sender-sorted CSR: ``s_perm``, a stable argsort of the padded senders, and
``s_indptr``, the senders' CSR offsets over the node space (the counterpart
of the JAX package's ``senders_aux`` and ``RegularBlocks.s_perm/s_sorted``).
Padding rows keep sender 0, so they sort into row 0's run; their
cotangents are exact zeros (mask and ``gcn_norm`` are 0 there), so any
valid row would do.  The JAX package moves them to the smallest real
sender instead, which is the same gradient.

Node-index convention: one flat node array, grid nodes 0..N-1 then mesh
nodes N..N+M-1; bipartite graphs index into the combined space.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

__all__ = ["Graph", "RegularBlocks", "pad_to_multiple",
           "indptr_from_receivers", "sender_csr", "build_graph",
           "build_regular_blocks"]

_LANE = 128  # edge-count padding multiple (same as the JAX package)
# The reference's receiver tile (its segment kernels' ``tile_receivers``).
# The port has no tiles; it keeps the tile only to mirror the reference's
# route conditions (``Graph.full_receiver_band``).
_REF_TILE_RECEIVERS = 256


def pad_to_multiple(n: int, m: int = _LANE) -> int:
    return ((n + m - 1) // m) * m


def indptr_from_receivers(receivers: torch.Tensor,
                          num_receivers: int) -> torch.Tensor:
    """[R + 1] int32 CSR offsets of a sorted receiver array."""
    bounds = torch.arange(num_receivers + 1, device=receivers.device,
                          dtype=receivers.dtype)
    return torch.searchsorted(receivers, bounds).to(torch.int32)


def sender_csr(senders: np.ndarray, num_nodes: int):
    """(s_perm [E] int32, s_indptr [num_nodes + 1] int32): a stable
    argsort of ``senders`` and the CSR offsets of the sorted senders."""
    senders = np.asarray(senders, np.int64)
    perm = np.argsort(senders, kind="stable")
    s_indptr = np.searchsorted(senders[perm], np.arange(num_nodes + 1))
    return (torch.from_numpy(perm.astype(np.int32)),
            torch.from_numpy(s_indptr.astype(np.int32)))


def _move(t: Optional[torch.Tensor], device, float_dtype):
    """Move ``t`` to ``device``; cast it to ``float_dtype`` if floating."""
    if t is None:
        return None
    if t.is_floating_point() and float_dtype is not None:
        return t.to(device=device, dtype=float_dtype)
    return t.to(device=device)


@dataclasses.dataclass
class RegularBlocks:
    """Constant-degree per-level edge layout for icosahedral multimeshes.

    Within one subdivision level every vertex has exactly 6 neighbours
    (12 pentagon seeds: 5), and the level-ℓ edges of the multimesh connect
    only the nested vertex prefix ids < V(ℓ).  Each level becomes a dense
    [K, V(ℓ)] table, stored SLOT-MAJOR (row = k·V + r has receiver r):
    receiver broadcast is a k-fold tile and aggregation a k-term slice sum.
    Blocks are concatenated and padded to 128 rows; padding rows carry
    mask 0 / sender 0.  ``s_perm`` / ``s_indptr`` are the senders' sorted
    CSR over the ``num_nodes`` rows (``sender_csr``), read by the sender
    scatter of the edge unit's backward (``ops.reg_edge``).
    """

    senders: torch.Tensor              # [rows_pad] int32
    mask: torch.Tensor                 # [rows_pad] float
    edge_attr: Optional[torch.Tensor]  # [rows_pad, F_e]
    s_perm: torch.Tensor               # [rows_pad] int32
    s_indptr: torch.Tensor             # [num_nodes + 1] int32
    block_recv: tuple = ()
    block_k: tuple = ()
    num_nodes: int = 0

    @property
    def rows_padded(self) -> int:
        return int(self.senders.shape[0])

    def to(self, device=None, float_dtype=None) -> "RegularBlocks":
        return dataclasses.replace(
            self,
            senders=_move(self.senders, device, float_dtype),
            mask=_move(self.mask, device, float_dtype),
            edge_attr=_move(self.edge_attr, device, float_dtype),
            s_perm=_move(self.s_perm, device, float_dtype),
            s_indptr=_move(self.s_indptr, device, float_dtype),
        )


def build_regular_blocks(
    senders: np.ndarray,
    receivers: np.ndarray,
    level_sizes,
    num_receivers: int,
    edge_attr: Optional[np.ndarray] = None,
    max_waste: float = 0.25,
    pad_multiple: int = _LANE,
    avoid_rows: int = -1,
) -> Optional[RegularBlocks]:
    """Per-level constant-degree tables, or None when the structure does
    not hold (pruned/regional meshes, exotic level sets).

    ``level_sizes``: ascending vertex-prefix sizes V(ℓ) of the multimesh
    levels.  An edge belongs to the smallest level with BOTH endpoints in
    its prefix (coarse vertices are never adjacent at finer levels)."""
    senders = np.asarray(senders, np.int64)
    receivers = np.asarray(receivers, np.int64)
    e = senders.shape[0]
    if e == 0 or not level_sizes:
        return None
    sizes = sorted(int(v) for v in level_sizes)
    if sizes[-1] > num_receivers:
        return None
    both_max = np.maximum(senders, receivers)
    level_of = np.searchsorted(sizes, both_max, side="right")
    if (level_of >= len(sizes)).any():
        return None   # edges outside every level prefix

    snd_tabs, mask_tabs, attr_tabs = [], [], []
    block_recv, block_k = [], []
    total_rows = 0
    for li, v in enumerate(sizes):
        em = level_of == li
        if not em.any():
            return None
        r = receivers[em]
        s = senders[em]
        deg = np.bincount(r, minlength=v)
        k = int(deg.max())
        if k == 0 or v * k > (1.0 + max_waste) * em.sum():
            return None
        order = np.argsort(r, kind="stable")
        r_s, s_s = r[order], s[order]
        slot = np.arange(r_s.size) - np.concatenate(
            [[0], np.cumsum(deg)[:-1]]
        )[r_s]
        st = np.zeros((k, v), np.int32)
        mt = np.zeros((k, v), np.float32)
        st[slot, r_s] = s_s
        mt[slot, r_s] = 1.0
        snd_tabs.append(st.reshape(-1))
        mask_tabs.append(mt.reshape(-1))
        if edge_attr is not None:
            at = np.zeros((k, v, edge_attr.shape[1]), np.float32)
            at[slot, r_s] = edge_attr[em][order]
            attr_tabs.append(at.reshape(k * v, -1))
        block_recv.append(v)
        block_k.append(k)
        total_rows += v * k

    rows_pad = max(pad_to_multiple(total_rows, pad_multiple), pad_multiple)
    if rows_pad == avoid_rows:
        # Keep the block row count distinct from the COO edge count, as the
        # JAX package does (its processor tells the layouts apart by it).
        rows_pad += pad_multiple
    snd = np.zeros(rows_pad, np.int32)
    msk = np.zeros(rows_pad, np.float32)
    snd[:total_rows] = np.concatenate(snd_tabs)
    msk[:total_rows] = np.concatenate(mask_tabs)
    attr = None
    if edge_attr is not None:
        attr = np.zeros((rows_pad, edge_attr.shape[1]), np.float32)
        attr[:total_rows] = np.concatenate(attr_tabs, axis=0)

    s_perm, s_indptr = sender_csr(snd, num_receivers)
    return RegularBlocks(
        senders=torch.from_numpy(snd),
        mask=torch.from_numpy(msk),
        edge_attr=torch.from_numpy(attr) if attr is not None else None,
        s_perm=s_perm,
        s_indptr=s_indptr,
        block_recv=tuple(block_recv),
        block_k=tuple(block_k),
        num_nodes=int(num_receivers),
    )


@dataclasses.dataclass
class Graph:
    """A static padded message-passing graph.

    Attributes:
      senders: [E_pad] int32 sender node ids (padding slots point at node 0).
      receivers: [E_pad] int32 receiver node ids, sorted ascending; padding
        slots point at node ``num_receivers - 1`` to keep sortedness.
      edge_mask: [E_pad] float, 1 for real edges, 0 for padding.
      edge_attr: optional [E_pad, F_e] static edge features.
      indptr: [R + 1] int32 receiver CSR offsets into the padded arrays
        (``indptr[R] == E_pad``).
      s_perm / s_indptr: [E_pad] int32 stable argsort of the padded
        senders and [num_nodes + 1] int32 CSR offsets of the sorted
        senders (``sender_csr``).
      static_in_degree: [R] float unmasked in-degree.
      gcn_norm: [E_pad] float GCN symmetric normalizer dinv_s·dinv_r (0 on
        padding rows).
      reg_blocks: constant-degree multimesh layout, or None.
      num_nodes / num_receivers / num_edges: node-space size, aggregation
        rows and real edge count.
      const_in_degree / num_const_receivers: every receiver in
        [0, num_const_receivers) has exactly const_in_degree consecutive
        edges and no padding rows interleave (0 when that does not hold).
      full_receiver_band: real edges reach the first and the last
        256-receiver tile, the reference's condition for its edge-MLP
        kernel route (it clips its segment schedule to the band of tiles
        that own edges).
    """

    senders: torch.Tensor
    receivers: torch.Tensor
    edge_mask: torch.Tensor
    indptr: torch.Tensor
    static_in_degree: torch.Tensor
    gcn_norm: torch.Tensor
    s_perm: torch.Tensor
    s_indptr: torch.Tensor
    edge_attr: Optional[torch.Tensor] = None
    reg_blocks: Optional[RegularBlocks] = None
    num_nodes: int = 0
    num_receivers: int = 0
    num_edges: int = 0
    const_in_degree: int = 0
    num_const_receivers: int = 0
    full_receiver_band: bool = True

    @property
    def padded_num_edges(self) -> int:
        return int(self.senders.shape[0])

    def to(self, device=None, float_dtype=None) -> "Graph":
        """Copy onto ``device``, casting the float arrays (mask, edge
        features, degrees, norms) to ``float_dtype`` when given."""
        return dataclasses.replace(
            self,
            senders=_move(self.senders, device, float_dtype),
            receivers=_move(self.receivers, device, float_dtype),
            edge_mask=_move(self.edge_mask, device, float_dtype),
            indptr=_move(self.indptr, device, float_dtype),
            s_perm=_move(self.s_perm, device, float_dtype),
            s_indptr=_move(self.s_indptr, device, float_dtype),
            static_in_degree=_move(self.static_in_degree, device,
                                   float_dtype),
            gcn_norm=_move(self.gcn_norm, device, float_dtype),
            edge_attr=_move(self.edge_attr, device, float_dtype),
            reg_blocks=(self.reg_blocks.to(device, float_dtype)
                        if self.reg_blocks is not None else None),
        )


def build_graph(
    senders: np.ndarray,
    receivers: np.ndarray,
    num_nodes: int,
    num_receivers: Optional[int] = None,
    edge_attr: Optional[np.ndarray] = None,
    pad_multiple: int = _LANE,
    level_sizes=None,
) -> Graph:
    """Sort COO edges by receiver, pad, and precompute the static arrays.

    Args:
      senders/receivers: [E] integer edge endpoints (any order).
      num_nodes: size of the node space the ids index into.
      num_receivers: number of aggregation rows (defaults to num_nodes).
      edge_attr: optional [E, F_e] static edge features.
      level_sizes: multimesh level prefix sizes; builds ``reg_blocks``.
    """
    senders = np.asarray(senders, dtype=np.int64)
    receivers = np.asarray(receivers, dtype=np.int64)
    num_receivers = num_nodes if num_receivers is None else int(num_receivers)
    e = int(senders.shape[0])

    order = np.argsort(receivers, kind="stable")
    s_sorted = senders[order]
    r_sorted = receivers[order]
    attr_sorted = edge_attr[order] if edge_attr is not None else None

    e_pad = max(pad_to_multiple(e, pad_multiple), pad_multiple)
    s_full = np.zeros(e_pad, dtype=np.int32)
    r_full = np.full(e_pad, num_receivers - 1, dtype=np.int32)
    m_full = np.zeros(e_pad, dtype=np.float32)
    s_full[:e] = s_sorted
    r_full[:e] = r_sorted
    m_full[:e] = 1.0

    attr_full = None
    if attr_sorted is not None:
        attr_full = np.zeros((e_pad, attr_sorted.shape[1]), dtype=np.float32)
        attr_full[:e] = attr_sorted

    # Receiver CSR offsets over the padded rows (padding rows belong to the
    # last receiver and carry zero messages after the mask multiply).
    indptr = indptr_from_receivers(torch.from_numpy(r_full), num_receivers)

    # Mask-static precomputes: unmasked in-degree and the GCN symmetric
    # normalizer with implicit self loops.
    degrees_f = np.bincount(
        r_sorted, minlength=num_receivers
    ).astype(np.float32) if e > 0 else np.zeros(num_receivers, np.float32)
    dinv = 1.0 / np.sqrt(degrees_f + 1.0)
    gcn_norm = np.zeros(e_pad, np.float32)
    if e > 0:
        # Sender normalizer looks up the RECEIVER-side degree array (PyG
        # gcn_norm semantics — unified node space asserted by GCNConv).
        dinv_nodes = np.zeros(num_nodes, np.float32)
        dinv_nodes[: min(num_receivers, num_nodes)] = dinv[
            : min(num_receivers, num_nodes)
        ]
        gcn_norm[:e] = dinv_nodes[s_sorted] * dinv[r_sorted]

    # Constant-degree structure (decoder M2G: k = 3 for every grid node).
    const_k, const_r = 0, 0
    if e > 0 and e == e_pad:
        nz = np.flatnonzero(degrees_f)
        if nz.size and nz[-1] == nz.size - 1:  # receivers 0..R0-1 contiguous
            k0 = int(degrees_f[0])
            if k0 > 0 and np.all(degrees_f[: nz.size] == k0) \
                    and k0 * nz.size == e:
                const_k, const_r = k0, int(nz.size)

    ntiles = -(-num_receivers // _REF_TILE_RECEIVERS)
    if e > 0:
        band = (int(r_sorted[0]) // _REF_TILE_RECEIVERS,
                int(r_sorted[-1]) // _REF_TILE_RECEIVERS + 1)
    else:
        band = (0, 1)
    full_band = band[0] == 0 and band[1] in (0, ntiles)

    reg_blocks = None
    if level_sizes:
        reg_blocks = build_regular_blocks(
            senders, receivers, level_sizes, num_receivers,
            edge_attr=edge_attr, pad_multiple=pad_multiple,
            avoid_rows=e_pad,
        )

    s_perm, s_indptr = sender_csr(s_full, num_nodes)
    return Graph(
        senders=torch.from_numpy(s_full),
        receivers=torch.from_numpy(r_full),
        edge_mask=torch.from_numpy(m_full),
        indptr=indptr,
        s_perm=s_perm,
        s_indptr=s_indptr,
        static_in_degree=torch.from_numpy(degrees_f),
        gcn_norm=torch.from_numpy(gcn_norm),
        edge_attr=(torch.from_numpy(attr_full)
                   if attr_full is not None else None),
        reg_blocks=reg_blocks,
        num_nodes=int(num_nodes),
        num_receivers=num_receivers,
        num_edges=e,
        const_in_degree=const_k,
        num_const_receivers=const_r,
        full_receiver_band=full_band,
    )
