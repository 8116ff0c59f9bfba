"""Spatial graph partitioning for SPMD message passing (host side; a
NumPy copy of ``graphcast_lite_tpu.graphs.partition`` over this
package's ``graphs.structure.Graph``).

The graph's tensors are read through ``.cpu().numpy()``, so a graph that
already lives on the card partitions as well; a bf16 ``edge_attr`` is
read as fp32, the type of the sharded attribute array.  Only the first
``num_edges`` edges are read, so the padding convention of the graph
(this package pads receivers with ``num_receivers - 1``, the JAX package
with ``num_nodes - 1``) does not reach the partition.

Domain decomposition of a node set into S latitude bands (SURVEY §5.8 /
§2.9 design): each shard owns a contiguous block of the permuted node
order, every edge is assigned to the shard that owns its RECEIVER, senders
keep global (permuted, padded-layout) ids so a halo gather of node features
makes every message computable locally.

Products (all leading-axis-stacked per shard, equal padded sizes — the
layout a per-shard SPMD step consumes):

  * node permutation old→new + per-shard node validity masks;
  * per-shard edge arrays: global sender ids (into the padded stacked node
    layout), local receiver ids, edge masks, edge attributes;
  * helpers to scatter node arrays into the sharded layout and back.

The round-1 halo strategy is gather-by-owner (`all_gather` of the node
features, correct for arbitrary edge spans — the multimesh's coarse levels
connect distant bands); the banded-neighbor `ppermute` exchange for the
fine-level edges is the planned refinement and slots into the same layout.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .structure import Graph

__all__ = ["ShardedGraph", "BandedHalos", "NodePartition", "TileShape",
           "partition_nodes_by_latitude", "tile_boundaries",
           "partition_nodes_by_tiles", "build_node_partition",
           "shard_graph", "shard_graph_bipartite", "build_banded_halos",
           "build_tiled_halos", "scatter_nodes", "gather_nodes"]


@dataclasses.dataclass
class NodePartition:
    """A padded S-way partition of one node space (host-side).

    Layout: nodes grouped by shard into equal padded blocks; slot of node i
    is ``perm[i]`` in the stacked ``[S * nodes_per_shard]`` space.
    """

    shard_of: np.ndarray      # [N] shard id per node
    perm: np.ndarray          # [N] old id -> slot in padded stacked layout
    inv_slots: np.ndarray     # [S, N_s] slot -> old id (-1 for padding)
    node_mask: np.ndarray     # [S, N_s] 1 for real nodes
    num_shards: int
    nodes_per_shard: int
    num_nodes: int

    @property
    def padded_num_nodes(self) -> int:
        return self.num_shards * self.nodes_per_shard

    @property
    def slot_sources(self) -> np.ndarray:
        """[S, N_s] gather indices into the original order (padding -> 0)."""
        return np.where(self.inv_slots >= 0, self.inv_slots, 0)

    def scatter(self, x: np.ndarray) -> np.ndarray:
        """[..., N, F] -> sharded layout [..., S, N_s, F] (padding rows 0)."""
        take = np.ascontiguousarray(
            np.take(x, self.slot_sources.reshape(-1), axis=x.ndim - 2)
        )
        out = take.reshape(
            x.shape[:-2] + (self.num_shards, self.nodes_per_shard, x.shape[-1])
        )
        return out * self.node_mask[..., :, :, None]

    def gather(self, x_sharded: np.ndarray) -> np.ndarray:
        """Sharded [..., S, N_s, F] -> original order [..., N, F]."""
        x = np.asarray(x_sharded)
        flat = x.reshape(x.shape[:-3] + (-1, x.shape[-1]))
        return np.take(flat, self.perm, axis=flat.ndim - 2)


@dataclasses.dataclass
class ShardedGraph:
    """Per-shard padded edge/node layout (NumPy; ship with
    torch.from_numpy)."""

    # nodes
    perm: np.ndarray          # [N] old id -> slot in padded stacked layout
    inv_slots: np.ndarray     # [S, N_s] slot -> old id (-1 for padding)
    node_mask: np.ndarray     # [S, N_s] 1 for real nodes
    # edges (receiver-sharded)
    senders_global: np.ndarray   # [S, E_s] ids into the SENDER padded layout
    receivers_local: np.ndarray  # [S, E_s] ids into the shard's node block
    edge_mask: np.ndarray        # [S, E_s]
    edge_attr: Optional[np.ndarray]  # [S, E_s, F_e]
    num_shards: int
    nodes_per_shard: int
    num_nodes: int
    # Bipartite graphs: sender node space differs from the receiver space.
    # 0 means "same as nodes_per_shard" (unified graphs).
    sender_nodes_per_shard: int = 0

    @property
    def padded_num_nodes(self) -> int:
        return self.num_shards * self.nodes_per_shard

    @property
    def sender_block(self) -> int:
        return self.sender_nodes_per_shard or self.nodes_per_shard


def partition_nodes_by_latitude(
    node_lats: np.ndarray, num_shards: int
) -> np.ndarray:
    """[N] shard id per node: contiguous latitude bands balanced by count."""
    order = np.argsort(node_lats, kind="stable")
    shard_of = np.empty(len(node_lats), np.int32)
    splits = np.array_split(order, num_shards)
    for s, idx in enumerate(splits):
        shard_of[idx] = s
    return shard_of


@dataclasses.dataclass(frozen=True)
class TileShape:
    """Static 2-D tile topology: ``s_lat`` latitude bands × ``s_lon``
    longitude sectors (cyclic); shard id = band * s_lon + sector."""

    s_lat: int
    s_lon: int

    @property
    def num_shards(self) -> int:
        return self.s_lat * self.s_lon

    @staticmethod
    def factor(num_shards: int) -> "TileShape":
        """Near-square factorization, more splits on the (cyclic) lon axis."""
        s_lat = int(np.sqrt(num_shards))
        while num_shards % s_lat:
            s_lat -= 1
        return TileShape(s_lat, num_shards // s_lat)


def tile_boundaries(
    all_lats: np.ndarray,
    all_lons: np.ndarray,
    weights: np.ndarray,
    shape: TileShape,
) -> Tuple[np.ndarray, np.ndarray]:
    """Shared 2-D tile boundaries balancing the COMBINED weighted node set.

    Why shared: the grid (uniform per lat-degree) and the icosphere mesh
    (density ∝ cos lat) have different latitude distributions, so
    independently count-balanced bands MISALIGN — bipartite G2M/M2G edges
    then span many sender bands and the banded halo degenerates toward
    all_gather at high shard counts (the S≥16 failure in MULTICHIP_r02).
    One set of boundaries, computed from grid+mesh nodes weighted by their
    per-node compute cost, keeps every radius/containment edge within ±1
    band while balancing total WORK per shard.

    Returns (lat_edges [s_lat−1], lon_edges [s_lat, s_lon−1]).
    """
    order = np.argsort(all_lats, kind="stable")
    csum = np.cumsum(weights[order])
    total = csum[-1]
    lat_edges = np.empty(shape.s_lat - 1, np.float64)
    band_targets = total * np.arange(1, shape.s_lat) / shape.s_lat
    cut_idx = np.searchsorted(csum, band_targets)
    lat_edges = all_lats[order][np.minimum(cut_idx, len(order) - 1)]

    band_of = np.searchsorted(lat_edges, all_lats, side="right")
    lon_edges = np.empty((shape.s_lat, shape.s_lon - 1), np.float64)
    for b in range(shape.s_lat):
        sel = band_of == b
        lons_b = all_lons[sel]
        w_b = weights[sel]
        if lons_b.size == 0:
            lon_edges[b] = np.linspace(0, 360, shape.s_lon + 1)[1:-1]
            continue
        o = np.argsort(lons_b, kind="stable")
        c = np.cumsum(w_b[o])
        targets = c[-1] * np.arange(1, shape.s_lon) / shape.s_lon
        ci = np.minimum(np.searchsorted(c, targets), lons_b.size - 1)
        lon_edges[b] = lons_b[o][ci]
    return np.asarray(lat_edges, np.float64), lon_edges


def partition_nodes_by_tiles(
    node_lats: np.ndarray,
    node_lons: np.ndarray,
    lat_edges: np.ndarray,
    lon_edges: np.ndarray,
    shape: TileShape,
) -> np.ndarray:
    """[N] shard id per node for shared 2-D tile boundaries."""
    band = np.searchsorted(lat_edges, node_lats, side="right")
    shard = np.empty(len(node_lats), np.int32)
    for b in range(shape.s_lat):
        sel = band == b
        sector = np.searchsorted(lon_edges[b], node_lons[sel], side="right")
        shard[sel] = b * shape.s_lon + sector
    return shard


def build_node_partition(
    node_shard: np.ndarray, num_shards: int,
    pad_nodes_multiple: int = 8,
) -> NodePartition:
    """Padded block layout for a shard assignment (see NodePartition)."""
    n = len(node_shard)
    nodes_of = [np.flatnonzero(node_shard == s) for s in range(num_shards)]
    n_s = max(len(x) for x in nodes_of)
    n_s = ((n_s + pad_nodes_multiple - 1) // pad_nodes_multiple
           ) * pad_nodes_multiple
    perm = np.full(n, -1, np.int64)
    inv = np.full((num_shards, n_s), -1, np.int64)
    node_mask = np.zeros((num_shards, n_s), np.float32)
    for s, ids in enumerate(nodes_of):
        slots = s * n_s + np.arange(len(ids))
        perm[ids] = slots
        inv[s, : len(ids)] = ids
        node_mask[s, : len(ids)] = 1.0
    return NodePartition(
        shard_of=np.asarray(node_shard, np.int32), perm=perm, inv_slots=inv,
        node_mask=node_mask, num_shards=num_shards, nodes_per_shard=n_s,
        num_nodes=n,
    )


def _host(t: torch.Tensor) -> np.ndarray:
    """A graph tensor as a host array (a bf16 one as fp32)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def shard_graph_bipartite(
    graph: Graph,
    sender_part: NodePartition,
    recv_part: NodePartition,
    sender_offset: int = 0,
    recv_offset: int = 0,
    pad_edges_multiple: int = 128,
) -> ShardedGraph:
    """Partition edges by receiver ownership with distinct sender/receiver
    node spaces (the bipartite G2M / M2G case).

    ``sender_offset`` / ``recv_offset`` subtract the unified-node-space
    offsets (grid 0..N-1, mesh N..N+M-1) so the two partitions index their
    own local spaces.
    """
    senders = _host(graph.senders)[: graph.num_edges] - sender_offset
    receivers = _host(graph.receivers)[: graph.num_edges] - recv_offset
    attr = (_host(graph.edge_attr)[: graph.num_edges]
            if graph.edge_attr is not None else None)
    if graph.num_edges:  # .min() on a zero-edge graph raises an opaque error
        if senders.min() < 0 or senders.max() >= sender_part.num_nodes:
            raise ValueError(
                f"sender ids out of range [0, {sender_part.num_nodes}) after "
                f"offset {sender_offset}: [{senders.min()}, {senders.max()}]"
            )
        if receivers.min() < 0 or receivers.max() >= recv_part.num_nodes:
            raise ValueError(
                f"receiver ids out of range [0, {recv_part.num_nodes}) after "
                f"offset {recv_offset}: [{receivers.min()}, {receivers.max()}]"
            )

    num_shards = recv_part.num_shards
    n_s = recv_part.nodes_per_shard
    recv_shard = recv_part.shard_of[receivers]
    e_per = [np.flatnonzero(recv_shard == s) for s in range(num_shards)]
    e_max = max(len(x) for x in e_per)
    e_max = max(
        ((e_max + pad_edges_multiple - 1) // pad_edges_multiple
         ) * pad_edges_multiple,
        pad_edges_multiple,
    )
    sg = np.zeros((num_shards, e_max), np.int32)
    rl = np.zeros((num_shards, e_max), np.int32)
    em = np.zeros((num_shards, e_max), np.float32)
    ea = (np.zeros((num_shards, e_max, attr.shape[1]), np.float32)
          if attr is not None else None)
    for s, idx in enumerate(e_per):
        k = len(idx)
        sg[s, :k] = sender_part.perm[senders[idx]]
        rl[s, :k] = recv_part.perm[receivers[idx]] - s * n_s
        em[s, :k] = 1.0
        if ea is not None:
            ea[s, :k] = attr[idx]
        rl[s, k:] = n_s - 1
    return ShardedGraph(
        perm=recv_part.perm,
        inv_slots=recv_part.inv_slots,
        node_mask=recv_part.node_mask,
        senders_global=sg,
        receivers_local=rl,
        edge_mask=em,
        edge_attr=ea,
        num_shards=num_shards,
        nodes_per_shard=n_s,
        num_nodes=recv_part.num_nodes,
        sender_nodes_per_shard=sender_part.nodes_per_shard,
    )


def shard_graph(
    graph: Graph,
    node_shard: np.ndarray,
    num_shards: int,
    pad_edges_multiple: int = 128,
) -> ShardedGraph:
    """Partition a (unified-node-space) Graph by receiver ownership."""
    part = build_node_partition(node_shard, num_shards, pad_nodes_multiple=1)
    return shard_graph_bipartite(
        graph, part, part, pad_edges_multiple=pad_edges_multiple
    )


@dataclasses.dataclass
class BandedHalos:
    """Banded-neighbor halo plan: replaces the full per-step ``all_gather``.

    Edges are classified by the latitude-band distance between the sender's
    owner ``o`` and the receiver's owner ``s``:

      * ``o == s``      — local, no communication;
      * ``|o − s| == 1`` — *neighbor*: the owner ships only the boundary-slab
        rows the adjacent band actually references (one ``ppermute`` per
        direction per step);
      * ``|o − s| ≥ 2`` — *far* (the multimesh's coarse levels): the union of
        such sender rows per owner is small (≈ the coarse-level vertex set),
        so those rows are replicated via one compact ``all_gather``.

    ``senders_ext`` re-indexes every edge's sender into the per-shard
    extended table ``[local N_s | slab-from-below H | slab-from-above H |
    hub S·Hh]``, so the SPMD step is a single static-shape gather.
    """

    send_up: np.ndarray      # [S, H] local slots shard s ships to s+1
    send_down: np.ndarray    # [S, H] local slots shard s ships to s-1
    hub_idx: np.ndarray      # [S, Hh] local slots replicated to all shards
    senders_ext: np.ndarray  # [S, E_s] edge sender ids into the ext table
    slab_size: int           # H
    hub_size: int            # Hh

    def rows_exchanged_per_step(self, sg: "ShardedGraph") -> dict:
        """Comm-volume accounting (rows shipped per MP step, whole mesh)."""
        s = sg.num_shards
        return {
            "all_gather_baseline": s * (s - 1) * sg.sender_block,
            "banded": 2 * (s - 1) * self.slab_size
            + s * (s - 1) * self.hub_size,
        }


def _pad_pow(n: int, multiple: int = 8) -> int:
    return max(multiple, ((n + multiple - 1) // multiple) * multiple)


def build_banded_halos(sg: ShardedGraph) -> BandedHalos:
    """Derive the banded halo plan from a receiver-sharded graph.

    Works for unified graphs and for bipartite graphs with a distinct sender
    space: owners/slots are computed in the SENDER partition's layout, so
    slab/hub indices are local sender rows and ``senders_ext`` indexes the
    per-shard extended sender table.
    """
    s_n, n_s = sg.num_shards, sg.sender_block
    owner = sg.senders_global // n_s          # [S, E]
    local = sg.senders_global % n_s
    live = sg.edge_mask > 0

    # Per-consumer needed-row sets, split by band distance.
    from_down = [np.empty(0, np.int64) for _ in range(s_n)]  # owner s-1
    from_up = [np.empty(0, np.int64) for _ in range(s_n)]    # owner s+1
    far_need = [[] for _ in range(s_n)]  # far rows needed FROM owner o
    for s in range(s_n):
        o, l = owner[s][live[s]], local[s][live[s]]
        if s - 1 >= 0:
            from_down[s] = np.unique(l[o == s - 1])
        if s + 1 < s_n:
            from_up[s] = np.unique(l[o == s + 1])
        far = np.abs(o - s) >= 2
        for oo in np.unique(o[far]):
            far_need[oo].append(np.unique(l[far][o[far] == oo]))

    send_up_sets = [from_down[s + 1] if s + 1 < s_n else np.empty(0, np.int64)
                    for s in range(s_n)]
    send_down_sets = [from_up[s - 1] if s - 1 >= 0 else np.empty(0, np.int64)
                      for s in range(s_n)]
    hub_sets = [np.unique(np.concatenate(f)) if f else np.empty(0, np.int64)
                for f in far_need]

    h = _pad_pow(max(max((len(x) for x in send_up_sets), default=0),
                     max((len(x) for x in send_down_sets), default=0)))
    hh = _pad_pow(max((len(x) for x in hub_sets), default=0))

    send_up = np.zeros((s_n, h), np.int32)
    send_down = np.zeros((s_n, h), np.int32)
    hub_idx = np.zeros((s_n, hh), np.int32)
    for s in range(s_n):
        send_up[s, : len(send_up_sets[s])] = send_up_sets[s]
        send_down[s, : len(send_down_sets[s])] = send_down_sets[s]
        hub_idx[s, : len(hub_sets[s])] = hub_sets[s]

    # Remap edge senders into the extended local table.
    senders_ext = np.zeros((s_n,) + sg.senders_global.shape[1:], np.int32)
    for s in range(s_n):
        o, l, m = owner[s], local[s], live[s]
        ext = np.zeros(o.shape, np.int64)
        is_loc = (o == s) & m
        ext[is_loc] = l[is_loc]
        if s - 1 >= 0:
            nb = (o == s - 1) & m
            ext[nb] = n_s + np.searchsorted(send_up_sets[s - 1], l[nb])
        if s + 1 < s_n:
            nb = (o == s + 1) & m
            ext[nb] = n_s + h + np.searchsorted(send_down_sets[s + 1], l[nb])
        far = (np.abs(o - s) >= 2) & m
        if far.any():
            for oo in np.unique(o[far]):
                sel = far & (o == oo)
                ext[sel] = (n_s + 2 * h + oo * hh
                            + np.searchsorted(hub_sets[oo], l[sel]))
        senders_ext[s] = ext
    return BandedHalos(send_up=send_up, send_down=send_down, hub_idx=hub_idx,
                       senders_ext=senders_ext, slab_size=h, hub_size=hh)


@dataclasses.dataclass
class TiledHalos:
    """2-D tile halo plan: per-direction ``ppermute`` slabs + compact hub.

    Directions are consumer-relative tile offsets (Δband, Δsector) over the
    s_lat × s_lon topology (lon cyclic, lat bounded).  ``senders_ext``
    re-indexes every edge's sender into the extended table
    ``[local N_s | dir_0 slab H | ... | dir_{D-1} slab H | hub S·Hh]``.
    """

    shape: TileShape
    dirs: Tuple[Tuple[int, int], ...]   # static (db, ds) list
    send_idx: np.ndarray                # [S, D, H] local rows to ship per dir
    hub_idx: np.ndarray                 # [S, Hh]
    senders_ext: np.ndarray             # [S, E]
    slab_size: int
    hub_size: int

    def rows_exchanged_per_step(self, sg: "ShardedGraph") -> dict:
        s = sg.num_shards
        n_pairs = sum(len(_tile_pairs(self.shape, d)) for d in self.dirs)
        return {
            "all_gather_baseline": s * (s - 1) * sg.sender_block,
            "banded": n_pairs * self.slab_size
            + s * (s - 1) * self.hub_size,
        }


def _tile_nbr(shape: TileShape, shard: int, d: Tuple[int, int]):
    """Shard at consumer-relative offset d from `shard`, or None."""
    b, j = divmod(shard, shape.s_lon)
    db, ds = d
    nb = b + db
    if nb < 0 or nb >= shape.s_lat:
        return None
    return nb * shape.s_lon + (j + ds) % shape.s_lon


def _tile_pairs(shape: TileShape, d: Tuple[int, int]):
    """ppermute (src owner, dst consumer) pairs for consumer-offset d."""
    pairs = []
    for s in range(shape.num_shards):
        o = _tile_nbr(shape, s, d)
        if o is not None and o != s:
            pairs.append((o, s))
    return pairs


def _tile_dirs(shape: TileShape) -> Tuple[Tuple[int, int], ...]:
    if shape.s_lon > 2:
        ds_list = (-1, 0, 1)
    elif shape.s_lon == 2:
        ds_list = (0, 1)
    else:
        ds_list = (0,)
    dirs = [(db, ds) for db in (-1, 0, 1) for ds in ds_list
            if (db, ds) != (0, 0)]
    return tuple(d for d in dirs if _tile_pairs(shape, d))


def build_tiled_halos(sg: ShardedGraph, shape: TileShape) -> TiledHalos:
    """Derive the 2-D tile halo plan from a receiver-sharded graph whose
    node partitions came from :func:`partition_nodes_by_tiles` with SHARED
    boundaries for senders and receivers."""
    s_n, n_s = sg.num_shards, sg.sender_block
    assert s_n == shape.num_shards
    owner = sg.senders_global // n_s
    local = sg.senders_global % n_s
    live = sg.edge_mask > 0
    dirs = _tile_dirs(shape)
    d_index = {d: i for i, d in enumerate(dirs)}

    def classify(consumer: int, o: int):
        """(db, ds) canonical offset of owner o from consumer, or None."""
        cb, cj = divmod(consumer, shape.s_lon)
        ob, oj = divmod(o, shape.s_lon)
        db = ob - cb
        if abs(db) > 1:
            return None
        raw = (oj - cj) % shape.s_lon
        if raw == 0:
            ds = 0
        elif raw == 1:
            ds = 1
        elif raw == shape.s_lon - 1 and shape.s_lon > 2:
            ds = -1
        else:
            return None
        d = (db, ds)
        return d if d in d_index else None

    # need[s][d] = sorted unique local rows of owner _tile_nbr(s, d) that
    # consumer s references in direction d.
    need = [dict() for _ in range(s_n)]
    hub_need = [[] for _ in range(s_n)]   # rows needed FROM owner o (global)
    for s in range(s_n):
        o, l = owner[s][live[s]], local[s][live[s]]
        rem = o != s
        for oo in np.unique(o[rem]):
            rows = np.unique(l[rem][o[rem] == oo])
            d = classify(s, int(oo))
            if d is not None:
                need[s][d] = rows
            else:
                hub_need[oo].append(rows)

    hub_sets = [np.unique(np.concatenate(h)) if h else np.empty(0, np.int64)
                for h in hub_need]
    h = _pad_pow(max((len(r) for nd in need for r in nd.values()),
                     default=0))
    hh = _pad_pow(max((len(x) for x in hub_sets), default=0))

    # send_idx[o][d] = rows owner o ships in direction d = need of the
    # consumer s with _tile_nbr(s, d) == o, i.e. s = _tile_nbr(o, -d).
    send_idx = np.zeros((s_n, len(dirs), h), np.int32)
    for o in range(s_n):
        for i, d in enumerate(dirs):
            s = _tile_nbr(shape, o, (-d[0], -d[1]))
            if s is None or s == o:
                continue
            rows = need[s].get(d, np.empty(0, np.int64))
            send_idx[o, i, : len(rows)] = rows
    hub_idx = np.zeros((s_n, hh), np.int32)
    for o in range(s_n):
        hub_idx[o, : len(hub_sets[o])] = hub_sets[o]

    senders_ext = np.zeros((s_n,) + sg.senders_global.shape[1:], np.int32)
    for s in range(s_n):
        o, l, m = owner[s], local[s], live[s]
        ext = np.zeros(o.shape, np.int64)
        is_loc = (o == s) & m
        ext[is_loc] = l[is_loc]
        rem = (o != s) & m
        for oo in np.unique(o[rem]):
            sel = rem & (o == oo)
            d = classify(s, int(oo))
            if d is not None:
                rows = need[s][d]
                ext[sel] = (n_s + d_index[d] * h
                            + np.searchsorted(rows, l[sel]))
            else:
                ext[sel] = (n_s + len(dirs) * h + oo * hh
                            + np.searchsorted(hub_sets[oo], l[sel]))
        senders_ext[s] = ext
    return TiledHalos(shape=shape, dirs=dirs, send_idx=send_idx,
                      hub_idx=hub_idx, senders_ext=senders_ext,
                      slab_size=h, hub_size=hh)


def scatter_nodes(sg: ShardedGraph, x: np.ndarray) -> np.ndarray:
    """[N, F] node array -> sharded layout [S, N_s, F] (padding rows 0)."""
    f = x.shape[-1]
    out = np.zeros((sg.num_shards, sg.nodes_per_shard, f), x.dtype)
    flat = out.reshape(-1, f)
    flat[sg.perm] = x
    return out


def gather_nodes(sg: ShardedGraph, x_sharded: np.ndarray) -> np.ndarray:
    """Sharded layout [S, N_s, F] -> original node order [N, F]."""
    flat = np.asarray(x_sharded).reshape(-1, x_sharded.shape[-1])
    return flat[sg.perm]
