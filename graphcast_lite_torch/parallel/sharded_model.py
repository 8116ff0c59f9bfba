"""Full-model multi-device training: encode-process-decode, the AR rollout
loss and its gradients over a (data, space) grid of ranks (torch
counterpart of ``graphcast_lite_tpu.parallel.sharded_model``).

The JAX package runs this inside ONE ``jax.shard_map``; here every rank is
a process (``torch.distributed``) that runs the same program on its own
shard:

* the grid and mesh node spaces are each partitioned into S latitude bands
  or 2-D tiles (``graphs.partition``); every rank of a space group owns a
  block of grid nodes, a block of mesh nodes and the edges whose receivers
  it owns, for all THREE graphs (G2M encoding, E_M processing, M2G
  decoding);
* per graph, sender rows cross ranks by gather-by-owner (one all-gather),
  by the banded plan (two point-to-point boundary slabs + a compact hub
  all-gather for the multimesh's coarse levels) or by the tiled plan (one
  slab a 2-D tile direction + the hub); the cheaper plan is chosen per
  graph from exact host-side row accounting (``ShardingPlan.comm_stats``);
* the batch axis is data-parallel over the ``data`` axis, and a rank's
  local batch [B_l, G_s, obs·F] goes through ONE forward call, as
  ``jax.vmap`` maps the JAX forward: one halo exchange a layer, one
  all-reduce a graph-mode LayerNorm statistic and one kernel launch a
  layer carry every sample, and each sample is computed as a call on it
  alone would compute it (the LayerNorm statistics are per sample, and
  graphs, parameters and edge masks are shared);
* the loss is a local numerator over a denominator summed over all ranks;
  each rank runs ``backward`` on its local numerator, and one all-reduce
  of the flattened fp32 gradients over all ranks gives exactly
  ∂(global loss)/∂θ, because the weighted-MSE denominator is parameter-free
  and every collective on the way is differentiable
  (``parallel.collectives``: the graph-mode LayerNorm statistics are
  all-reduces, the halo exchanges all-gathers and point-to-point rounds,
  each with its adjoint as backward);
* the whole thing reads the port's ``WeatherModel`` parameters by name, so
  a model trained on one device trains sharded unchanged.

Per rank, each sharded graph is a ``graphs.structure.Graph`` over the
rank's shard only: its receiver CSR covers the rank's ``nodes_per_shard``
rows, its sender CSR the EXTENDED sender table the exchange builds
(gather: ``S × sender_block`` rows; banded: ``sender_block + 2·slab +
S·hub``; tiled: ``sender_block + dirs·slab + S·hub``).  So every
aggregation, every gather adjoint and the fused edge unit's two backward
scatters run through the segment-sum kernel (``ops.cuda_segment``) on
shard-local CSRs, as everywhere in the port.

Supported layer types (``ShardedWeatherForward._validate``, the gate):
encoder/decoder ConvGCN or GATConv stacks; processor InteractionNet,
ConvGCN, GAT or SparseGAT (per-shard edge-mask pruning).  The other
families (product graph, SimpleConv / SparseGAT / InteractionNet encoders
and decoders, graph-mode LayerNorm, direct multi-step models, the CNN
stacks) are refused, as the JAX package refuses them and trains them under
GSPMD with a data-sharded batch; the port's counterpart of that is the
data-parallel step, ``parallel.sharding.make_data_parallel_train_step``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..build import resolve_device
from ..config import DataConfig, GraphLayerType, PipelineConfig
from ..graphs.build import GraphSet
from ..graphs.partition import (
    NodePartition,
    ShardedGraph,
    TiledHalos,
    TileShape,
    _tile_pairs,
    build_banded_halos,
    build_node_partition,
    build_tiled_halos,
    partition_nodes_by_latitude,
    partition_nodes_by_tiles,
    shard_graph_bipartite,
    tile_boundaries,
)
from ..graphs.structure import Graph, sender_csr
from ..ops import cuda_segment
from ..ops import segment as seg_ops
from ..ops.fused_edge import edge_gather_mlp_agg, training_trace
from ..ops.gather import gather_rows
from ..ops.gcn_agg import gcn_aggregate
from ..training.rollout import RolloutSpec, carry_forward
from .collectives import all_gather_rows, all_reduce_, all_reduce_sum, \
    broadcast_, ppermute_rows
from .sharding import ProcessMesh, shard_batch

__all__ = [
    "ShardingPlan",
    "GraphArrays",
    "PlanArrays",
    "build_sharding_plan",
    "graph_arrays",
    "plan_device_arrays",
    "ShardedWeatherForward",
    "make_sharded_forward",
    "make_sharded_train_step",
    "make_sharded_eval_step",
    "predict_scaling_efficiency",
    "estimate_sharded_hbm",
    "halo_rows",
    "reset_halo_rows",
]

_OFF = ("0", "false", "off")


# --------------------------------------------------------------------------
# Host-side plan
# --------------------------------------------------------------------------


@dataclasses.dataclass
class ShardingPlan:
    """Host-side partition of the full model's node/edge spaces."""

    num_shards: int
    grid_part: NodePartition
    mesh_part: NodePartition
    enc: ShardedGraph
    proc: ShardedGraph
    dec: ShardedGraph
    enc_halos: Optional[object]   # BandedHalos | TiledHalos | None
    proc_halos: Optional[object]
    dec_halos: Optional[object]
    comm_stats: Dict[str, Dict[str, int]]
    partition: str = "lat"        # "lat" (1-D bands) | "tiles" (2-D)

    def scatter_grid(self, x: np.ndarray) -> np.ndarray:
        """[..., G, F] -> [..., S, G_s, F]."""
        return self.grid_part.scatter(x)

    def gather_grid(self, x_sh) -> np.ndarray:
        return self.grid_part.gather(np.asarray(x_sh))


# Per-node forward-compute weight of a mesh node relative to a grid node,
# used to balance WORK, not node counts, when choosing shared 2-D tile
# boundaries.  Kept at the JAX package's value so that both packages draw
# the same plans; chip_smoke.py phase 11a measures the card's own ratio
# from its stage times (PERF.md).
MESH_NODE_WEIGHT = 7.0


def build_sharding_plan(
    gs: GraphSet,
    num_shards: int,
    halo_mode: str = "auto",
    pad_edges_multiple: int = 128,
    partition: str = "auto",
) -> ShardingPlan:
    """Partition grid+mesh and shard all three graphs.

    ``partition``: "lat" — independent 1-D latitude bands per node space;
    "tiles" — 2-D lat×lon tiles with SHARED boundaries balancing combined
    work (misaligned per-space bands make G2M/M2G edges span many sender
    bands at S ≥ 16); "auto" — build both and keep the one moving fewer
    total rows/step.
    ``halo_mode``: "auto" picks gather vs banded/tiled per graph from the
    exact rows-exchanged accounting; "banded"/"gather" force one plan.
    """
    if partition == "auto":
        lat_plan = build_sharding_plan(gs, num_shards, halo_mode,
                                       pad_edges_multiple, "lat")
        if num_shards < 4:
            return lat_plan          # tiles degenerate to bands
        tile_plan = build_sharding_plan(gs, num_shards, halo_mode,
                                        pad_edges_multiple, "tiles")

        def total(plan):
            return sum(
                min(st["banded"], st["all_gather_baseline"])
                for st in plan.comm_stats.values()
            )

        return tile_plan if total(tile_plan) < total(lat_plan) else lat_plan

    if partition == "tiles":
        shape = TileShape.factor(num_shards)
        all_lats = np.concatenate([gs.grid_lat, gs.mesh_lat])
        all_lons = np.concatenate([gs.grid_lon, gs.mesh_lon])
        weights = np.concatenate([
            np.ones(gs.num_grid_nodes, np.float64),
            np.full(gs.num_mesh_nodes, MESH_NODE_WEIGHT, np.float64),
        ])
        lat_e, lon_e = tile_boundaries(all_lats, all_lons, weights, shape)
        grid_shard = partition_nodes_by_tiles(
            gs.grid_lat, gs.grid_lon, lat_e, lon_e, shape
        )
        mesh_shard = partition_nodes_by_tiles(
            gs.mesh_lat, gs.mesh_lon, lat_e, lon_e, shape
        )
        grid_part = build_node_partition(grid_shard, num_shards)
        mesh_part = build_node_partition(mesh_shard, num_shards)

        def make_halos(sg):
            return build_tiled_halos(sg, shape)
    else:
        grid_part = build_node_partition(
            partition_nodes_by_latitude(gs.grid_lat, num_shards), num_shards
        )
        mesh_part = build_node_partition(
            partition_nodes_by_latitude(gs.mesh_lat, num_shards), num_shards
        )
        make_halos = build_banded_halos

    n_grid = gs.num_grid_nodes
    enc = shard_graph_bipartite(
        gs.encoding, grid_part, mesh_part, 0, n_grid, pad_edges_multiple
    )
    proc = shard_graph_bipartite(
        gs.processing, mesh_part, mesh_part, 0, 0, pad_edges_multiple
    )
    dec = shard_graph_bipartite(
        gs.decoding, mesh_part, grid_part, n_grid, 0, pad_edges_multiple
    )

    halos = {}
    stats = {}
    for name, sg in (("enc", enc), ("proc", proc), ("dec", dec)):
        h = make_halos(sg)
        acct = h.rows_exchanged_per_step(sg)
        if halo_mode == "banded":
            use = True
        elif halo_mode == "gather":
            use = False
        else:  # auto: halo plan only when it moves strictly fewer rows
            use = acct["banded"] < acct["all_gather_baseline"]
        acct["chosen"] = (
            ("tiled" if partition == "tiles" else "banded") if use
            else "gather"
        )
        halos[name] = h if use else None
        stats[name] = acct

    return ShardingPlan(
        num_shards=num_shards,
        grid_part=grid_part,
        mesh_part=mesh_part,
        enc=enc,
        proc=proc,
        dec=dec,
        enc_halos=halos["enc"],
        proc_halos=halos["proc"],
        dec_halos=halos["dec"],
        comm_stats=stats,
        partition=partition,
    )


def predict_scaling_efficiency(
    plan: ShardingPlan,
    t1_step_ms: float,
    link_gbps: float,
    hidden: int = 256,
    ar_steps: int = 4,
    mp_steps: int = 12,
    dtype_bytes: int = 2,
    overhead_frac: Optional[float] = None,
) -> Dict[str, float]:
    """Analytic worst-case (zero-overlap) scaling-efficiency estimate of S
    devices against one, for a measured one-device step ``t1_step_ms`` and
    a per-link bandwidth ``link_gbps`` (GB/s) that the caller measures or
    states for its interconnect (there is no default):

      compute_ms  = t1_step_ms / S          (work splits evenly: the node
                                             partitions are count-balanced)
      comm_ms     = Σ_graph  exchanges × rows/exchange × hidden × b / link
      efficiency  = compute / (compute + comm) / (1 + overhead_frac)

    ``overhead_frac`` is the measured sharded-body overhead against the
    unsharded step (halo indexing, per-shard kernel differences), e.g.
    from a one-rank sharded step; folding it in gives the composite number
    (``efficiency_composite``).  When None, only the comm model applies.

    Exchange counts per train step: the processor halo runs every MP step,
    forward + its adjoint in the backward (the AR checkpoint replays the
    forward once more): 3 × mp × ar; the encoder/decoder halos run once per
    model call: 3 × ar.  ``rows`` are whole-grid totals per exchange
    (``rows_exchanged_per_step``) and all S links carry their share
    concurrently, so per-link bytes = total_bytes / S.

    Deliberately pessimistic: no compute/comm overlap, the replay counted.
    """
    s = plan.num_shards
    if s <= 1:
        return {"S": 1, "efficiency": 1.0, "compute_ms": t1_step_ms,
                "comm_ms": 0.0}
    per_exchange_rows = {
        name: min(st["banded"], st["all_gather_baseline"])
        for name, st in plan.comm_stats.items()
    }
    exchanges = {
        "enc": 3 * ar_steps,
        "dec": 3 * ar_steps,
        "proc": 3 * ar_steps * mp_steps,
    }
    total_bytes = sum(
        per_exchange_rows[g] * exchanges[g] * hidden * dtype_bytes
        for g in ("enc", "proc", "dec")
    )
    comm_ms = total_bytes / s / (link_gbps * 1e9) * 1e3
    compute_ms = t1_step_ms / s
    eff = compute_ms / (compute_ms + comm_ms)
    out = {
        "S": s,
        "efficiency": round(eff, 4),
        "compute_ms": round(compute_ms, 2),
        "comm_ms": round(comm_ms, 2),
        "comm_bytes_per_step": int(total_bytes),
    }
    if overhead_frac is not None:
        out["overhead_frac"] = round(float(overhead_frac), 4)
        out["efficiency_composite"] = round(eff / (1.0 + overhead_frac), 4)
    return out


def estimate_sharded_hbm(
    plan: ShardingPlan,
    hidden: int = 256,
    mp_steps: int = 12,
    ar_steps: int = 4,
    num_params: int = 5_950_000,
    obs_window: int = 2,
    num_features: int = 19,
    compute_bytes: int = 2,
    scan_remat: bool = False,
) -> Dict[str, float]:
    """Per-shard device-memory accounting of the sharded train-step body
    (bytes, reported in GB), the JAX package's model unchanged.  Per shard
    (bf16 compute, fp32 master params + Adam):

      params      = P · (4 master + 8 adam + 2 cast)            [replicated]
      edges       = Σ_graph E_s · (4 snd + 4 rcv + 2 mask) + proc attr/mask
      BPTT saves  = ar · mp · (k_e·E_s^proc + k_n·M_s) · h · b
                    (k_e=2: edge-MLP pre-activation + updated edge carry;
                     k_n=3: aggregate, node pre-activation, node carry)
      enc/dec     = ar · k_ed · (G_s + M_s) · h · b
      state       = AR window + targets + grid outputs

    With ``scan_remat=True`` the BPTT term drops to one live step plus the
    per-step carries (``GCLT_SHARDED_SCAN_REMAT=full``).  chip_smoke.py
    phase 11a prints the card's measured peak beside this estimate.
    """
    s = plan.num_shards
    h, b = hidden, compute_bytes
    g_s = plan.grid_part.nodes_per_shard
    m_s = plan.mesh_part.nodes_per_shard
    e_proc = plan.proc.senders_global.shape[1]
    e_enc = plan.enc.senders_global.shape[1]
    e_dec = plan.dec.senders_global.shape[1]

    params_b = num_params * (4 + 8 + 2)
    edges_b = (
        (e_proc + e_enc + e_dec) * 10
        + e_proc * (4 * 4 + 4)          # 4-feature f32 edge attr + f32 mask
    )
    k_e, k_n, k_ed = 2.0, 3.0, 4.0
    if scan_remat:
        bptt_b = ar_steps * (
            (k_e * e_proc + k_n * m_s) * h * b          # one live step
            + mp_steps * (e_proc + m_s) * h * b         # stacked carries
        )
    else:
        bptt_b = ar_steps * mp_steps * (k_e * e_proc + k_n * m_s) * h * b
    encdec_b = ar_steps * k_ed * (g_s + m_s) * h * b
    state_b = g_s * (obs_window + 2 * ar_steps) * num_features * 4

    total = params_b + edges_b + bptt_b + encdec_b + state_b
    return {
        "S": s,
        "params_gb": params_b / 1e9,
        "edges_gb": edges_b / 1e9,
        "bptt_gb": bptt_b / 1e9,
        "encdec_gb": encdec_b / 1e9,
        "state_gb": state_b / 1e9,
        "total_gb": total / 1e9,
    }


# --------------------------------------------------------------------------
# Per-rank arrays: this rank's shard of each graph as a Graph with its CSRs
# --------------------------------------------------------------------------


# A gather of local rows by ``idx`` with its sorted CSR (``gather_rows``'s
# aux), so that its adjoint is the segment-sum kernel.
_Take = Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]


@dataclasses.dataclass
class GraphArrays:
    """One rank's shard of one sharded graph.

    ``graph``: the shard's edges (senders into the extended sender table,
    receivers local, mask, edge features) with the receiver CSR over the
    shard's ``num_recv`` rows and the sender CSR over the table's
    ``num_sender_rows`` rows; ``static_in_degree`` is the host degree
    under the static mask.  ``slabs``: the exchange's point-to-point
    rounds, each (rows to send as a ``_Take``, (src, dst) space ranks);
    ``hub``: the rows replicated to every rank (a ``_Take``)."""

    name: str
    mode: str                    # "gather" | "banded" | "tiled"
    graph: Graph
    num_shards: int
    num_recv: int
    num_sender_rows: int
    slabs: Tuple[Tuple[_Take, Tuple[Tuple[int, int], ...]], ...] = ()
    hub: Optional[_Take] = None


@dataclasses.dataclass
class PlanArrays:
    """Everything static the sharded model needs on this rank."""

    enc: GraphArrays
    proc: GraphArrays
    dec: GraphArrays
    grid_static: torch.Tensor    # [G_s, 6]
    mesh_static: torch.Tensor    # [M_s, 6]
    grid_mask: torch.Tensor      # [G_s] 1 for real grid rows
    loss_weight: torch.Tensor    # [G_s] node_mask × lat × spatial
    group: object                # the space group the exchanges run over
    num_shards: int = 1
    shard: int = 0


def _take(idx: np.ndarray, rows: int, device) -> _Take:
    perm, indptr = sender_csr(idx, rows)
    return (torch.from_numpy(np.asarray(idx, np.int32)).to(device),
            perm.to(device), indptr.to(device))


def _static_degrees(sg: ShardedGraph) -> np.ndarray:
    """[S, N_s] in-degree of every shard's receivers under the static
    mask."""
    deg = np.zeros((sg.num_shards, sg.nodes_per_shard), np.float32)
    for s in range(sg.num_shards):
        np.add.at(deg[s], sg.receivers_local[s],
                  np.asarray(sg.edge_mask[s], np.float32))
    return deg


def graph_arrays(sg: ShardedGraph, halos, shard: int, name: str = "",
                 bipartite: bool = True, device=None) -> GraphArrays:
    """Shard ``shard`` of ``sg`` under ``halos`` (None: gather-by-owner)
    as the rank's ``GraphArrays`` on ``device``.  The receivers must be
    sorted with padding rows at ``nodes_per_shard - 1``
    (``graphs.partition.shard_graph_bipartite``); this is checked, not
    assumed.  ``bipartite=False`` (a graph over one node space) gives the
    sender side of ``gcn_norm`` the senders' own degrees."""
    dev = resolve_device(device)
    tiled = isinstance(halos, TiledHalos)
    senders = (halos.senders_ext if halos is not None
               else sg.senders_global)[shard]
    if halos is None:
        n_sender_rows = sg.num_shards * sg.sender_block
        mode = "gather"
    elif tiled:
        n_sender_rows = (
            sg.sender_block + len(halos.dirs) * halos.slab_size
            + sg.num_shards * halos.hub_size
        )
        mode = "tiled"
    else:
        n_sender_rows = (
            sg.sender_block + 2 * halos.slab_size
            + sg.num_shards * halos.hub_size
        )
        mode = "banded"
    n_s = sg.nodes_per_shard
    rl = np.asarray(sg.receivers_local[shard], np.int64)
    mask = np.asarray(sg.edge_mask[shard], np.float32)
    live = int(mask.sum())
    if (np.diff(rl) < 0).any() or not (mask[:live] == 1).all() \
            or (mask[live:] != 0).any() or (rl[live:] != n_s - 1).any():
        raise ValueError(f"{name} shard {shard}: receivers are not sorted "
                         f"with padding rows at {n_s - 1}")
    if live and (senders.min() < 0 or senders.max() >= n_sender_rows):
        raise ValueError(f"{name} shard {shard}: sender ids outside the "
                         f"{n_sender_rows}-row sender table")
    indptr = np.searchsorted(rl, np.arange(n_s + 1)).astype(np.int32)
    s_perm, s_indptr = sender_csr(senders, n_sender_rows)
    deg = _static_degrees(sg)
    dinv_r = 1.0 / np.sqrt(deg[shard] + 1.0)
    dinv_s = (np.ones(senders.shape, np.float32) if bipartite
              else 1.0 / np.sqrt(deg.reshape(-1)[sg.senders_global[shard]]
                                 + 1.0))
    gcn_norm = (dinv_s * dinv_r[rl] * mask).astype(np.float32)
    attr = (sg.edge_attr[shard] if sg.edge_attr is not None else None)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    graph = Graph(
        senders=t(senders.astype(np.int32)),
        receivers=t(rl.astype(np.int32)),
        edge_mask=t(mask),
        indptr=t(indptr),
        static_in_degree=t(deg[shard]),
        gcn_norm=t(gcn_norm),
        s_perm=s_perm.to(dev),
        s_indptr=s_indptr.to(dev),
        edge_attr=t(attr.astype(np.float32)) if attr is not None else None,
        num_nodes=int(n_sender_rows),
        num_receivers=int(n_s),
        num_edges=live,
    )
    block = sg.sender_block
    slabs, hub = (), None
    if tiled:
        slabs = tuple(
            (_take(halos.send_idx[shard, i], block, dev),
             tuple(_tile_pairs(halos.shape, d)))
            for i, d in enumerate(halos.dirs))
    elif halos is not None:
        s_n = sg.num_shards
        slabs = (
            (_take(halos.send_up[shard], block, dev),
             tuple((i, i + 1) for i in range(s_n - 1))),
            (_take(halos.send_down[shard], block, dev),
             tuple((i, i - 1) for i in range(1, s_n))),
        )
    if halos is not None:
        hub = _take(halos.hub_idx[shard], block, dev)
    return GraphArrays(name=name, mode=mode, graph=graph,
                       num_shards=sg.num_shards, num_recv=int(n_s),
                       num_sender_rows=int(n_sender_rows), slabs=slabs,
                       hub=hub)


def plan_device_arrays(
    plan: ShardingPlan,
    gs: GraphSet,
    mesh: ProcessMesh,
    lat_weights: Optional[np.ndarray] = None,
    spatial_mask: Optional[np.ndarray] = None,
    device=None,
) -> PlanArrays:
    """This rank's ``PlanArrays`` (its space index's shard of every graph
    and node array) on ``device`` (default ``cuda``; raises without a card
    unless ``device='cpu'``)."""
    if mesh.space != plan.num_shards:
        raise ValueError(f"mesh space axis {mesh.space} != plan shards "
                         f"{plan.num_shards}")
    dev = resolve_device(device)
    s = mesh.space_index
    w = plan.grid_part.node_mask.copy()
    if lat_weights is not None:
        w = w * plan.grid_part.scatter(
            np.asarray(lat_weights, np.float32)[:, None]
        )[..., 0]
    if spatial_mask is not None:
        w = w * plan.grid_part.scatter(
            np.asarray(spatial_mask, np.float32)[:, None]
        )[..., 0]

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    return PlanArrays(
        enc=graph_arrays(plan.enc, plan.enc_halos, s, "enc", True, dev),
        proc=graph_arrays(plan.proc, plan.proc_halos, s, "proc", False,
                          dev),
        dec=graph_arrays(plan.dec, plan.dec_halos, s, "dec", True, dev),
        grid_static=t(plan.grid_part.scatter(
            np.asarray(gs.grid_static, np.float32))[s]),
        mesh_static=t(plan.mesh_part.scatter(
            np.asarray(gs.mesh_static, np.float32))[s]),
        grid_mask=t(plan.grid_part.node_mask[s]),
        loss_weight=t(w[s]),
        group=mesh.space_group,
        num_shards=plan.num_shards,
        shard=s,
    )


# --------------------------------------------------------------------------
# Per-shard layer math (mirrors models/nn.py + models/gnn.py)
# --------------------------------------------------------------------------

# Rows this rank received in the exchanges of each graph, and the exchanges
# (forward calls, recomputes included): rows / exchanges summed over a space
# group is the plan's ``rows_exchanged_per_step`` of the chosen plan.
halo_rows: Dict[str, int] = {}
halo_exchanges: Dict[str, int] = {}


def reset_halo_rows() -> None:
    halo_rows.clear()
    halo_exchanges.clear()


class _Tree:
    """A view of a flat ``{dotted name: tensor}`` parameter dict by path:
    ``p["encoder"]["mlp"]["lin_0"]["kernel"]`` reads
    ``params["encoder.mlp.lin_0.kernel"]``."""

    def __init__(self, params: Dict[str, torch.Tensor], prefix: str = ""):
        self._params, self._prefix = params, prefix

    def __getitem__(self, key):
        full = self._prefix + str(key)
        if full in self._params:
            return self._params[full]
        if not self._has(full):
            raise KeyError(full)
        return _Tree(self._params, full + ".")

    def _has(self, full: str) -> bool:
        return full in self._params or any(
            k.startswith(full + ".") for k in self._params)

    def __contains__(self, key) -> bool:
        return self._has(self._prefix + str(key))


def _prelu(x, alpha):
    return torch.where(x >= 0, x, alpha * x)


def _activate(x, name: str, p=None):
    """The stack's activation ``name``; PReLU reads ``p["alpha"]``."""
    if name == "prelu":
        return _prelu(x, p["alpha"])
    return F.silu(x) if name in ("swish", "silu") else F.relu(x)


def _node_ln(x, p, eps=1e-5):
    """PyG node-mode LayerNorm (``models.nn.PyGLayerNorm``: fp32 statistics
    cast back to the input's dtype)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True).to(x.dtype)
    var = xf.var(dim=-1, unbiased=False, keepdim=True).to(x.dtype)
    return (x - mean) / torch.sqrt(var + eps) * p["weight"] + p["bias"]


def _graph_ln_psum(x, p, mask, group, eps=1e-5):
    """PyG graph-mode LayerNorm with masked statistics summed over the space
    group: the mean and then E[(v − μ)²], each one differentiable
    all-reduce (fp32 statistics cast back to the input's dtype, as
    ``models.nn.PyGLayerNorm``).  A batch [B, E, F] has statistics per
    sample ([B, 2] then [B], one all-reduce each), as ``jax.vmap`` gives:
    pooling them over the batch would normalise each sample by the
    others."""
    w = mask.float()[:, None]
    xf = x.float()
    lead = x.shape[:-2]
    count = (w.sum() * x.shape[-1]).expand(lead)
    sums = all_reduce_sum(torch.stack([(xf * w).sum(dim=(-2, -1)), count],
                                      dim=-1), group)
    cnt = torch.clamp(sums[..., 1], min=1.0)
    mean = (sums[..., 0] / cnt)[..., None, None]
    var = all_reduce_sum((torch.square(xf - mean) * w).sum(dim=(-2, -1))
                         [..., None], group)[..., 0] / cnt
    var = var[..., None, None]
    out = (x - mean.to(x.dtype)) / torch.sqrt(var.to(x.dtype) + eps)
    return out * p["weight"] + p["bias"]


def _mlp_tower(p, x):
    """MLPTower (models/nn.py): lin_i -> prelu_i ... -> node LN."""
    i = 0
    while f"lin_{i}" in p:
        lp = p[f"lin_{i}"]
        x = x @ lp["kernel"] + lp["bias"]
        if f"prelu_{i}" in p:
            x = _prelu(x, p[f"prelu_{i}"]["alpha"])
        i += 1
    if "norm" in p:
        x = _node_ln(x, p["norm"])
    return x


def _use_sharded_kernels(ga: GraphArrays, features: int,
                         x: torch.Tensor) -> bool:
    """Kernel-faithful per-shard compute: the fused edge unit
    (``edge_gather_mlp_agg``) in the processor and ``gcn_aggregate`` in GCN
    layers, on the card at 16,384 per-shard edge rows or more and
    128-multiple widths (one sample's: the batch size plays no part);
    ``GCLT_SHARDED_KERNELS=0/1`` overrides the first two conditions.
    Every aggregation and scatter goes through the segment-sum kernel
    either way."""
    flag = os.environ.get("GCLT_SHARDED_KERNELS")
    if flag is not None:
        enabled = flag not in _OFF
    else:
        enabled = ga.graph.padded_num_edges >= 16384 and x.is_cuda
    return enabled and features % 128 == 0


def _halo_rows(rows: torch.Tensor, ga: GraphArrays, group) -> torch.Tensor:
    """Extended sender table: local rows + exchanged remote rows.

    Gather mode: one tiled all-gather (ids are global slots).  Banded mode:
    two point-to-point boundary slabs + the hub all-gather (ids are
    ext-table offsets; ``graphs.partition.BandedHalos``).  Tiled mode: one
    slab a 2-D tile direction + the hub (``graphs.partition.TiledHalos``).
    A batch [B, N, F] is one exchange (each collective carries every
    sample); ``halo_exchanges`` counts exchanges, ``halo_rows`` the rows
    one sample received.
    """
    s_n = ga.num_shards
    halo_exchanges[ga.name] = halo_exchanges.get(ga.name, 0) + 1
    if ga.mode == "gather":
        halo_rows[ga.name] = halo_rows.get(ga.name, 0) \
            + (s_n - 1) * rows.shape[-2]
        return all_gather_rows(rows, group)
    parts = [rows]
    me = torch.distributed.get_rank(group)
    received = 0
    for take, pairs in ga.slabs:
        slab = gather_rows(rows, take[0], take[1:])
        parts.append(ppermute_rows(slab, pairs, group))
        if any(d == me for _, d in pairs):
            received += slab.shape[-2]
    hub = gather_rows(rows, ga.hub[0], ga.hub[1:])
    parts.append(all_gather_rows(hub, group))
    received += (s_n - 1) * hub.shape[-2]
    halo_rows[ga.name] = halo_rows.get(ga.name, 0) + received
    return torch.cat(parts, dim=-2)


def _by_sender(table, g: Graph):
    return gather_rows(table, g.senders, (g.s_perm, g.s_indptr))


def _by_receiver(table, g: Graph):
    return gather_rows(table, g.receivers, (None, g.indptr))


def _gcn_layer(conv_p, x_send, x_recv, ga: GraphArrays, group,
               bipartite: bool):
    """PyG-parity GCNConv (models/gnn.py) on a sharded graph.

    Bipartite graphs (G2M / M2G): senders have in-degree 0 in the unified
    node space, so their symmetric-norm factor is 1 and their own output is
    the pure self-loop term xW + b.  Unified graphs: senders scale their
    projections by their local dinv BEFORE the halo exchange.
    Returns (out_send, out_recv).
    """
    k, b = conv_p["kernel"], conv_p["bias"]
    g = ga.graph
    xw_r = x_recv @ k
    deg = g.static_in_degree.float() + 1.0
    dinv = torch.rsqrt(deg).to(xw_r.dtype)
    if bipartite:
        xw_s = x_send @ k
        scaled = xw_s
    else:
        xw_s = xw_r
        scaled = xw_s * dinv[:, None]
    ext = _halo_rows(scaled, ga, group)
    mask = g.edge_mask.to(xw_r.dtype)
    if _use_sharded_kernels(ga, int(xw_r.shape[-1]), xw_r):
        agg = gcn_aggregate(ext, mask, g)
    else:
        msgs = _by_sender(ext, g) * mask[:, None]
        agg = cuda_segment.segment_sum(msgs.contiguous(), g.indptr,
                                       g.num_receivers)
    out_r = agg * dinv[:, None] + xw_r * torch.square(dinv)[:, None] + b
    out_s = (xw_s + b) if bipartite else out_r
    return out_s, out_r


def _stack_act(gl_p, cfg):
    name = (cfg.activation or "prelu").lower()
    p = gl_p["act"] if name == "prelu" else None
    return lambda v: _activate(v, name, p)


def _gcn_stack(gl_p, cfg, x_send, x_recv, ga: GraphArrays, group,
               bipartite: bool):
    """GraphLayerModule's ConvGCN branch (models/weather.py)."""
    n_layers = len(list(cfg.hidden_dims or [])) + 1
    act = _stack_act(gl_p, cfg)
    for i in range(n_layers):
        x_send, x_recv = _gcn_layer(
            gl_p[f"conv_{i}"], x_send, x_recv, ga, group, bipartite
        )
        if i < n_layers - 1:
            x_send, x_recv = act(x_send), act(x_recv)
    if cfg.use_layer_norm:
        x_send = _node_ln(x_send, gl_p["norm"])
        x_recv = _node_ln(x_recv, gl_p["norm"])
    return x_send, x_recv


def _gat_attention(core_p, xp_r, a_dst_r, a_src_self, ext, ga: GraphArrays,
                   heads: int, edge_mask):
    """The receiver-local part of a GAT layer: logits from the exchanged
    sender terms, the masked softmax with the implicit self loop, the
    aggregated messages.  Returns (out_r [N_s, C] with bias, w [E, H]); a
    batch [B, ...] of each in one softmax and one aggregation."""
    g = ga.graph
    lead = xp_r.shape[:-3]
    nr, hc = xp_r.shape[-3], xp_r.shape[-2] * xp_r.shape[-1]
    c = hc // heads
    logits = _by_sender(ext[..., hc:], g) + _by_receiver(a_dst_r, g)
    logits = F.leaky_relu(logits, 0.2)
    self_logits = F.leaky_relu(a_src_self + a_dst_r, 0.2)
    w, self_w = seg_ops.segment_softmax_coo(logits, g, edge_mask,
                                            self_logits)
    e = g.padded_num_edges
    msgs = (_by_sender(ext[..., :hc], g).reshape(lead + (e, heads, c))
            * w[..., None]).reshape(lead + (e, hc))
    out = seg_ops.aggregate_sum(msgs, g, edge_mask).reshape(
        lead + (nr, heads, c))
    out = (out + xp_r * self_w[..., None]).mean(dim=-2)
    if "bias" in core_p:
        out = out + core_p["bias"]
    return out, w


def _gat_core(core_p, x, ga: GraphArrays, group, heads: int, edge_mask):
    """PyG-parity GATConv(concat=False) core on a sharded unified graph.
    Receivers own their incoming edges, so the masked softmax (with the
    implicit self loop) is receiver-LOCAL; only the sender projections and
    their attention terms cross ranks (one packed exchange).  Returns
    (out [N_s, C], alpha [E]), or ([B, N_s, C], [B, E]) for a batch."""
    kernel = core_p["kernel"]
    lead, n, hc = x.shape[:-2], x.shape[-2], kernel.shape[1]
    xp = (x @ kernel).reshape(lead + (n, heads, hc // heads))
    a_src = (xp * core_p["att_src"]).sum(-1)            # [N_s, H]
    a_dst = (xp * core_p["att_dst"]).sum(-1)
    ext = _halo_rows(torch.cat([xp.reshape(lead + (n, hc)), a_src], dim=-1),
                     ga, group)
    out, w = _gat_attention(core_p, xp, a_dst, a_src, ext, ga, heads,
                            edge_mask)
    return out, w.mean(dim=-1) * edge_mask


def _gat_core_bipartite(core_p, x_send, x_recv, ga: GraphArrays, group,
                        heads: int, edge_mask):
    """GATConv on a sharded BIPARTITE graph (G2M / M2G enc/dec stacks):
    receivers softmax over their incoming edges PLUS the implicit self
    loop; sender-side rows have no incoming edges, so their softmax
    collapses to the self loop and their output is the projection (mean
    over heads) + bias, the single-device model's value for those rows.
    Returns (out_send, out_recv)."""
    kernel = core_p["kernel"]
    lead, hc = x_send.shape[:-2], kernel.shape[1]
    ns, nr = x_send.shape[-2], x_recv.shape[-2]
    c = hc // heads
    xp_s = (x_send @ kernel).reshape(lead + (ns, heads, c))
    xp_r = (x_recv @ kernel).reshape(lead + (nr, heads, c))
    a_src_s = (xp_s * core_p["att_src"]).sum(-1)
    a_src_r = (xp_r * core_p["att_src"]).sum(-1)  # receiver self-loop term
    a_dst_r = (xp_r * core_p["att_dst"]).sum(-1)
    ext = _halo_rows(torch.cat([xp_s.reshape(lead + (ns, hc)), a_src_s],
                               dim=-1), ga, group)
    out_r, _ = _gat_attention(core_p, xp_r, a_dst_r, a_src_r, ext, ga,
                              heads, edge_mask)
    out_s = xp_s.mean(dim=-2)                  # self-only softmax -> w=1
    if "bias" in core_p:
        out_s = out_s + core_p["bias"]
    return out_s, out_r


def _gat_stack_bipartite(gl_p, cfg, x_send, x_recv, ga: GraphArrays, group):
    """GraphLayerModule's GATConv branch over a bipartite graph (the
    attention-model encoder/decoder stacks)."""
    heads = cfg.gat_props.num_heads if cfg.gat_props else 1
    n_layers = len(list(cfg.hidden_dims or [])) + 1
    act = _stack_act(gl_p, cfg)
    for i in range(n_layers):
        x_send, x_recv = _gat_core_bipartite(
            gl_p[f"conv_{i}"]["core"], x_send, x_recv, ga, group, heads,
            ga.graph.edge_mask.to(x_recv.dtype),
        )
        if i < n_layers - 1:
            x_send, x_recv = act(x_send), act(x_recv)
    if cfg.use_layer_norm:
        x_send = _node_ln(x_send, gl_p["norm"])
        x_recv = _node_ln(x_recv, gl_p["norm"])
    return x_send, x_recv


def _gat_stack(gl_p, cfg, x, ga: GraphArrays, group):
    """GraphLayerModule's GATConv branch (models/weather.py)."""
    heads = cfg.gat_props.num_heads if cfg.gat_props else 1
    n_layers = len(list(cfg.hidden_dims or [])) + 1
    act = _stack_act(gl_p, cfg)
    for i in range(n_layers):
        x, _ = _gat_core(gl_p[f"conv_{i}"]["core"], x, ga, group, heads,
                         ga.graph.edge_mask.to(x.dtype))
        if i < n_layers - 1:
            x = act(x)
    if cfg.use_layer_norm:
        x = _node_ln(x, gl_p["norm"])
    return x


def _sparse_gat(gl_p, cfg, x, ga: GraphArrays, group, edge_mask,
                attention_threshold, prune: bool):
    """SparseGATConv (models/gnn.py): GAT + threshold pruning of the
    per-shard edge mask (compared in fp32, as the single-device layer).
    A batch prunes on sample 0's attention (``_GATCore`` on a batch; the
    JAX package keeps ``masks[0]`` of its vmapped forward)."""
    heads = cfg.gat_props.num_heads if cfg.gat_props else 1
    out, alpha = _gat_core(gl_p["conv_0"]["core"], x, ga, group, heads,
                           edge_mask)
    if prune:
        keep = alpha.reshape(-1, alpha.shape[-1])[0].float() \
            >= attention_threshold
        new_mask = edge_mask * keep.to(edge_mask.dtype)
    else:
        new_mask = edge_mask
    if cfg.use_layer_norm:
        out = _node_ln(out, gl_p["norm"])
    return out, new_mask


def _scan_remat() -> bool:
    """``GCLT_SHARDED_SCAN_REMAT=full``, or where that is unset
    ``GCLT_SCAN_REMAT=full`` (the JAX package's precedence): recompute each
    message-passing step in the backward.  ``dots`` and every other value
    leave it off, as in the JAX package's sharded scan."""
    mode = os.environ.get("GCLT_SHARDED_SCAN_REMAT",
                          os.environ.get("GCLT_SCAN_REMAT", "none"))
    return mode.lower() == "full"


def _interaction_processor(inet_p, x, ga: GraphArrays, group,
                           use_layer_norm: bool, activation: str):
    """InteractionNetProcessor (models/gnn.py, the plain step) on the
    sharded mesh.  The edge MLP's first matmul is split by input block so
    that only node PROJECTIONS cross ranks; the edge LayerNorm is
    ``_graph_ln_psum``; the degree is hoisted out of the step loop (the
    mask never changes during it).  ``x`` [N_s, D] or a batch [B, N_s, D]:
    the edge state starts shared (the edge encoder reads the graph alone)
    and is per sample from the first step's update on."""
    p = inet_p
    g = ga.graph
    enc_p = p["edge_encoder_lin"]
    e = g.edge_attr.to(x.dtype) @ enc_p["kernel"] + enc_p["bias"]
    e = _activate(e, activation,
                  p["edge_encoder_act"] if activation == "prelu" else None)
    d = x.shape[-1]
    mask = g.edge_mask.to(x.dtype)
    use_kernels = (activation in ("swish", "silu", "relu")
                   and _use_sharded_kernels(ga, d, x))
    deg = seg_ops.masked_in_degree(g)

    def body(step_p, x, e):
        k0 = step_p["edge_mlp"]["lin_0"]["kernel"]
        b0 = step_p["edge_mlp"]["lin_0"]["bias"]
        w2 = step_p["edge_mlp"]["lin_1"]["kernel"]
        b2 = step_p["edge_mlp"]["lin_1"]["bias"]
        xs = x @ k0[:d]
        xr = x @ k0[d:2 * d]
        ep = e @ k0[2 * d:]
        ext = _halo_rows(xs, ga, group)
        if use_kernels:
            # The single-device trainer's fused edge unit on the shard:
            # both backward scatters through the segment-sum kernel (the
            # sender one over the extended table's CSR); the projections'
            # and the exchange's backward compose through autograd.
            e_upd, agg = edge_gather_mlp_agg(
                ext, xr, ep, b0, w2, b2, mask, g.senders, g.receivers,
                g.indptr, g.s_perm, g.s_indptr,
                "swish" if activation == "silu" else activation)
        else:
            h = _by_sender(ext, g) + _by_receiver(xr, g) + ep + b0
            h = _activate(h, activation, step_p["edge_mlp"]["act"]
                          if activation == "prelu" else None)
            e_upd = h @ w2 + b2
            agg = cuda_segment.segment_sum(
                (e_upd * mask[:, None]).contiguous(), g.indptr,
                g.num_receivers)
        agg = agg / torch.clamp(deg, min=1.0)[:, None].to(agg.dtype)
        nm = step_p["node_mlp"]
        h2 = torch.cat([x, agg], dim=-1) @ nm["lin_0"]["kernel"] \
            + nm["lin_0"]["bias"]
        h2 = _activate(h2, activation,
                       nm["act"] if activation == "prelu" else None)
        n_upd = h2 @ nm["lin_1"]["kernel"] + nm["lin_1"]["bias"]
        new_e = e + e_upd
        new_x = x + n_upd
        if use_layer_norm:
            new_e = _graph_ln_psum(new_e, step_p["edge_norm"], mask, group)
            new_x = _node_ln(new_x, step_p["node_norm"])
        return new_x, new_e

    remat = _scan_remat() and torch.is_grad_enabled()
    i = 0
    while str(i) in p["steps"]:
        step_p = p["steps"][str(i)]
        if remat:
            x, e = checkpoint(body, step_p, x, e, use_reentrant=False)
        else:
            x, e = body(step_p, x, e)
        i += 1
    return x


# --------------------------------------------------------------------------
# Full per-shard forward
# --------------------------------------------------------------------------


def _param_dict(params) -> Dict[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return params


class ShardedWeatherForward:
    """Per-rank forward of the full WeatherModel (static config holder).

    ``__call__(params, x_grid [B, G_s, obs·F], arrs)`` returns the grid
    delta [B, G_s, C_out] of this rank's shard for the whole local batch
    in one call (``jax.vmap`` of the JAX forward); a [G_s, obs·F] input is
    one sample.  ``params`` is the model's ``{name: tensor}`` parameters
    (``dict(model.named_parameters())``, cast for mixed precision) or the
    ``WeatherModel`` itself.
    """

    def __init__(self, pipeline: PipelineConfig, data: DataConfig,
                 num_shards: int):
        self.pipeline = pipeline
        self.data = data
        self.num_shards = num_shards
        self._validate()

    def _validate(self):
        pl = self.pipeline
        if pl.product_graph is not None:
            raise NotImplementedError(
                "product-graph models train data-parallel: "
                "parallel.sharding.make_data_parallel_train_step"
            )
        for name in ("encoder", "decoder"):
            mc = getattr(pl, name)
            if mc.gcn.layer_type not in (
                GraphLayerType.ConvGCN, GraphLayerType.GATConv,
            ):
                raise NotImplementedError(
                    f"sharded {name} supports ConvGCN/GATConv only "
                    f"(got {mc.gcn.layer_type}); train data-parallel "
                    "with parallel.sharding.make_data_parallel_train_step"
                )
            if mc.gcn.use_layer_norm and (mc.gcn.layer_norm_mode
                                          or "node") != "node":
                raise NotImplementedError(
                    "graph-mode trailing LN unsupported; train data-parallel "
                    "with parallel.sharding.make_data_parallel_train_step")
            if mc.mlp is not None and mc.mlp.use_layer_norm and (
                mc.mlp.layer_norm_mode or "node"
            ) != "node":
                raise NotImplementedError(
                    "graph-mode MLP LN unsupported; train data-parallel "
                    "with parallel.sharding.make_data_parallel_train_step")
        if pl.processor.gcn.layer_type not in (
            GraphLayerType.InteractionNet, GraphLayerType.ConvGCN,
            GraphLayerType.GATConv, GraphLayerType.SparseGATConv,
        ):
            raise NotImplementedError(
                "sharded processor supports InteractionNet/ConvGCN/GAT/"
                "SparseGAT only; train data-parallel with "
                "parallel.sharding.make_data_parallel_train_step"
            )

    @property
    def sparse_gat(self) -> bool:
        return (self.pipeline.processor.gcn.layer_type
                == GraphLayerType.SparseGATConv)

    def __call__(self, params, x_grid: torch.Tensor, arrs: PlanArrays,
                 proc_edge_mask=None, attention_threshold=0.0,
                 prune: bool = False):
        """Returns (grid delta [B, G_s, C_out] or [G_s, C_out], new
        processing edge mask) — the mask is the input mask unchanged
        except under SparseGAT pruning (per-shard [E] layout, one for the
        batch: sample 0's)."""
        p = _Tree(_param_dict(params))
        pl = self.pipeline
        group = arrs.group
        dt = x_grid.dtype
        lead = x_grid.shape[:-2]

        def per_sample(static):
            return static.to(dt).expand(lead + tuple(static.shape))

        grid_in = torch.cat([x_grid, per_sample(arrs.grid_static)], dim=-1)
        mesh_dyn = x_grid.new_zeros(lead + (arrs.mesh_static.shape[0],
                                            x_grid.shape[-1]))
        mesh_in = torch.cat([mesh_dyn, per_sample(arrs.mesh_static)], dim=-1)

        # Encoder: (MLP) + graph stack over G2M (senders grid, receivers
        # mesh).
        pe = p["encoder"]
        if pl.encoder.mlp is not None:
            grid_in = _mlp_tower(pe["mlp"], grid_in)
            mesh_in = _mlp_tower(pe["mlp"], mesh_in)
        if pl.encoder.gcn.layer_type == GraphLayerType.GATConv:
            grid_latent, mesh_latent = _gat_stack_bipartite(
                pe["graph_layer"], pl.encoder.gcn, grid_in, mesh_in,
                arrs.enc, group,
            )
        else:
            grid_latent, mesh_latent = _gcn_stack(
                pe["graph_layer"], pl.encoder.gcn, grid_in, mesh_in,
                arrs.enc, group, bipartite=True,
            )

        # Processor over E_M (mesh-local).
        pp = p["processor"]
        x_mesh = mesh_latent
        new_mask = proc_edge_mask
        if pl.processor.mlp is not None:
            x_mesh = _mlp_tower(pp["mlp"], x_mesh)
        lt = pl.processor.gcn.layer_type
        if lt == GraphLayerType.InteractionNet:
            use_ln = (pl.processor.gcn.use_layer_norm
                      if pl.processor.gcn.use_layer_norm is not None
                      else True)
            mesh_processed = _interaction_processor(
                pp["graph_layer"]["inet"], x_mesh, arrs.proc, group,
                use_ln, (pl.processor.gcn.activation or "swish").lower(),
            )
        elif lt == GraphLayerType.GATConv:
            mesh_processed = _gat_stack(
                pp["graph_layer"], pl.processor.gcn, x_mesh, arrs.proc,
                group,
            )
        elif lt == GraphLayerType.SparseGATConv:
            mask = (proc_edge_mask if proc_edge_mask is not None
                    else arrs.proc.graph.edge_mask).to(x_mesh.dtype)
            mesh_processed, new_mask = _sparse_gat(
                pp["graph_layer"], pl.processor.gcn, x_mesh, arrs.proc,
                group, mask, attention_threshold, prune,
            )
        else:
            _, mesh_processed = _gcn_stack(
                pp["graph_layer"], pl.processor.gcn, x_mesh, x_mesh,
                arrs.proc, group, bipartite=False,
            )

        # Decoder: (MLP) + graph stack over M2G (senders mesh, receivers
        # grid).
        pd = p["decoder"]
        g = grid_latent
        m = mesh_processed
        if pl.decoder.mlp is not None:
            g = _mlp_tower(pd["mlp"], g)
            m = _mlp_tower(pd["mlp"], m)
        if pl.decoder.gcn.layer_type == GraphLayerType.GATConv:
            _, out_grid = _gat_stack_bipartite(
                pd["graph_layer"], pl.decoder.gcn, m, g, arrs.dec, group,
            )
        else:
            _, out_grid = _gcn_stack(
                pd["graph_layer"], pl.decoder.gcn, m, g, arrs.dec, group,
                bipartite=True,
            )
        return out_grid, new_mask


# --------------------------------------------------------------------------
# Train / eval steps
# --------------------------------------------------------------------------


def _check_mesh(fwd: ShardedWeatherForward, mesh: ProcessMesh, what: str):
    if mesh.space != fwd.num_shards:
        raise ValueError(f"{what}: mesh space axis {mesh.space} != plan "
                         f"shards {fwd.num_shards}")


def _local(x, mesh: ProcessMesh, device, dtype) -> torch.Tensor:
    """This rank's block of a [B, S, G_s, ...] batch (NumPy or a tensor),
    on ``device`` in ``dtype``, without the shard axis: [B_l, G_s, ...]."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return shard_batch(x, mesh)[:, 0].to(device=device, dtype=dtype)


def make_sharded_forward(fwd: ShardedWeatherForward,
                         mesh: ProcessMesh) -> Callable:
    """Single-step sharded forward:
    ``f(params, x_sh [B, S, G_s, obs·F], arrs, edge_mask=None) ->
    delta [B_l, 1, G_s, C]``, this rank's block of the ``P("data",
    "space")`` layout, its B_l local samples in one forward call.

    ``edge_mask`` is this rank's per-shard [E_s] processing-edge mask (a
    ``TrainState``'s pruned SparseGAT mask), applied when given."""
    _check_mesh(fwd, mesh, "make_sharded_forward")

    def call(params, x, arrs: PlanArrays, edge_mask=None):
        dev = arrs.grid_static.device
        xl = _local(x, mesh, dev, torch.float32)
        with torch.no_grad():
            out = fwd(params, xl, arrs, edge_mask)[0]
        return out[:, None]

    return call


def _local_weights(arrs: PlanArrays, chan_mask, num_features):
    """[G_s, C] per-element loss weights (0 on padding rows)."""
    w = arrs.loss_weight[:, None]
    if chan_mask is not None:
        cm = torch.as_tensor(np.asarray(chan_mask, np.float32),
                             device=w.device)
        return w * cm[None, :]
    return w.expand(w.shape[0], num_features)


class ShardedTrainStep:
    """One BPTT + optimizer step of the sharded model on this rank (built
    by ``make_sharded_train_step``)."""

    def __init__(self, fwd, spec, mesh, model, optimizer, steps, chan_mask,
                 compute_dtype, freeze_processor, prune):
        self.fwd, self.spec, self.mesh = fwd, spec, mesh
        self.model, self.optimizer, self.steps = model, optimizer, steps
        self.chan_mask, self.compute_dtype = chan_mask, compute_dtype
        self.freeze_processor, self.prune = freeze_processor, prune

    def _numerator(self, x, y, arrs, edge_mask, thr):
        """(local weighted squared error summed over the AR steps, fp32,
        differentiable in the masters; the new edge mask or None)."""
        spec, fwd, cdt = self.spec, self.fwd, self.compute_dtype
        obs, nf = spec.obs_window, spec.num_features
        b_l, g_s = x.shape[0], x.shape[1]
        params = {n: (p if cdt == torch.float32 else p.to(cdt))
                  for n, p in self.model.named_parameters()}
        window = x.reshape(b_l, g_s, obs, nf)
        targets = y.reshape(b_l, g_s, -1, nf)
        wc = _local_weights(arrs, self.chan_mask, nf).to(cdt)
        mask = edge_mask.to(cdt) if edge_mask is not None else None

        def one_step(window, mask, do_prune):
            # The local batch in one call; pruning is a batch-level
            # decision, on sample 0's attention.
            with training_trace():
                delta, new_mask = fwd(params,
                                      window.reshape(b_l, g_s, obs * nf),
                                      arrs, mask, thr, do_prune)
            if spec.use_residual:
                return window[:, :, -1, :] + delta, new_mask
            return delta, new_mask

        num = torch.zeros((), dtype=torch.float32, device=x.device)
        for step in range(self.steps):
            # The reference prunes once a batch (its first model call).
            do_prune = self.prune and step == 0
            if spec.remat:
                out, mask = checkpoint(one_step, window, mask, do_prune,
                                       use_reentrant=False)
            else:
                out, mask = one_step(window, mask, do_prune)
            tgt = targets[:, :, step, :]
            num = num + (torch.square(out - tgt) * wc).sum().float()
            out = carry_forward(out, window[:, :, -1, :], tgt, spec)
            window = torch.cat([window[:, :, 1:, :], out[:, :, None, :]],
                               dim=2)
        return num, mask

    def __call__(self, x_sh, y_sh, arrs: PlanArrays, edge_mask=None,
                 thr=0.0):
        """One step on the global batch (x_sh [B, S, G_s, obs·C], y_sh
        [B, S, G_s, P·C]; this rank reads its block) -> (fp32 loss, new
        edge mask or None)."""
        mesh, model = self.mesh, self.model
        dev = arrs.grid_static.device
        x = _local(x_sh, mesh, dev, self.compute_dtype)
        y = _local(y_sh, mesh, dev, self.compute_dtype)
        nf = self.spec.num_features
        self.optimizer.zero_grad(set_to_none=True)
        num, new_mask = self._numerator(x, y, arrs, edge_mask, thr)
        num.backward()
        w = _local_weights(arrs, self.chan_mask, nf)
        sums = all_reduce_(torch.stack([num.detach(),
                                        w.sum() * x.shape[0]]),
                           mesh.world_group)
        den = torch.clamp(sums[1], min=1e-12)
        scale = 1.0 / (den * self.steps)
        params = list(model.parameters())
        flat = torch.cat([(p.grad if p.grad is not None
                           else torch.zeros_like(p)).float().reshape(-1)
                          for p in params]) * scale
        all_reduce_(flat, mesh.world_group)
        offset = 0
        for p in params:
            n = p.numel()
            p.grad = flat[offset:offset + n].view_as(p).to(p.dtype)
            offset += n
        if self.freeze_processor:
            from ..training.trainer import _zero_processor_grads

            _zero_processor_grads(model)
        self.optimizer.step()
        if new_mask is not None:
            # One canonical mask a batch: data row 0's (the data rows saw
            # different samples).
            new_mask = broadcast_(new_mask.detach().float().contiguous(), 0,
                                  mesh.data_group)
        return sums[0] * scale, new_mask


def make_sharded_train_step(
    fwd: ShardedWeatherForward,
    spec: RolloutSpec,
    mesh: ProcessMesh,
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    steps: int,
    chan_mask=None,
    compute_dtype: torch.dtype = torch.float32,
    freeze_processor: bool = False,
    prune: bool = False,
) -> ShardedTrainStep:
    """``step(x_sh, y_sh, arrs, edge_mask=None, thr=0.0) -> (loss,
    new_mask)`` over ``steps`` AR steps: ``model``'s fp32 masters (the same
    on every rank: ``parallel.sharding.replicated``) cast to
    ``compute_dtype`` for the forward, the local numerator's backward on
    each rank, one all-reduce of the flattened fp32 gradients over all
    ranks scaled by 1 / (den · steps), the processor's gradients zeroed
    with ``freeze_processor``, then ``optimizer`` (Adam) steps on every
    rank, so the ranks stay bitwise equal.  ``loss`` is the global fp32
    loss on every rank.  For a SparseGAT processor ``edge_mask`` is this
    rank's per-shard [E_s] pruning state and ``new_mask`` its update (data
    row 0's, on every data row; None for other families).

    ``x_sh``: [B, S, G_s, obs·F] (``ShardingPlan.scatter_grid`` of the
    batch), ``y_sh``: [B, S, G_s, P·F]; each rank reads its
    ``P("data", "space")`` block.
    """
    if spec.direct_steps > 1:
        raise NotImplementedError(
            "direct multi-step (P·C decode) models are not wired into the "
            "explicit sharded rollout; train them data-parallel with "
            "parallel.sharding.make_data_parallel_train_step"
        )
    _check_mesh(fwd, mesh, "sharded train step")
    return ShardedTrainStep(fwd, spec, mesh, model, optimizer, steps,
                            chan_mask, compute_dtype, freeze_processor,
                            prune)


def make_sharded_eval_step(
    fwd: ShardedWeatherForward,
    spec: RolloutSpec,
    mesh: ProcessMesh,
    model,
    chan_mask=None,
    exclude_channels: Tuple[int, ...] = (),
) -> Callable:
    """``eval(x_sh, y_sh, sample_mask, arrs, edge_mask=None) -> (loss, acc,
    raw_rmse)`` of the first rollout step in fp32 (the single-device
    ``Trainer`` evaluation's quantities).

    The batch is split over the data axis: each data row computes 1/data of
    the samples.  Partial batches are zero-padded to a multiple of the data
    axis with ``sample_mask`` [B_pad] (1 for real samples): every reduction
    weights by it, so the results do not depend on the padding.  The ACC's
    spatial moments are summed over the space group, per sample."""
    obs, nf = spec.obs_window, spec.num_features
    _check_mesh(fwd, mesh, "sharded eval step")
    keep = [i for i in range(nf) if i not in set(exclude_channels)]

    def call(x_sh, y_sh, sample_mask, arrs: PlanArrays, edge_mask=None):
        dev = arrs.grid_static.device
        x = _local(x_sh, mesh, dev, torch.float32)
        y = _local(y_sh, mesh, dev, torch.float32)
        b_l, g_s = x.shape[0], x.shape[1]
        sm = torch.as_tensor(np.asarray(sample_mask, np.float32),
                             device=dev)
        sm = sm[mesh.data_index * b_l:(mesh.data_index + 1) * b_l]
        with torch.no_grad():
            window = x.reshape(b_l, g_s, obs, nf)
            targets = y.reshape(b_l, g_s, -1, nf)
            delta = fwd(model, window.reshape(b_l, g_s, obs * nf), arrs,
                        edge_mask)[0]
            out = window[:, :, -1, :] + delta if spec.use_residual \
                else delta
            tgt = targets[:, :, 0, :]
            out = carry_forward(out, window[:, :, -1, :], tgt, spec)

            w = _local_weights(arrs, chan_mask, nf)           # [G_s, C]
            wsm = sm[:, None, None] * w[None]
            nm = arrs.grid_mask[None, :, None]                # [1, G_s, 1]
            nmsm = sm[:, None, None] * nm
            sq = torch.square(out - tgt)
            sums = all_reduce_(torch.stack([
                (sq * wsm).sum(), wsm.sum(), (sq * nmsm).sum(),
                nmsm.sum() * nf]), mesh.world_group)
            loss = sums[0] / torch.clamp(sums[1], min=1e-12)
            raw_rmse = torch.sqrt(sums[2] / torch.clamp(sums[3], min=1.0))

            n_nodes = all_reduce_(arrs.grid_mask.sum().reshape(1),
                                  arrs.group)[0]
            n_samples = torch.clamp(all_reduce_(
                sm.sum().reshape(1), mesh.data_group)[0], min=1.0)

            def moments(v):
                mean = all_reduce_((v * nm).sum(dim=1),
                                   arrs.group) / n_nodes
                var = all_reduce_(
                    (torch.square(v - mean[:, None, :]) * nm).sum(dim=1),
                    arrs.group) / n_nodes
                return mean, torch.sqrt(var)

            mp, sp = moments(out)
            mt, st = moments(tgt)
            pn = (out - mp[:, None, :]) / (sp[:, None, :] + 1e-8)
            tn = (tgt - mt[:, None, :]) / (st[:, None, :] + 1e-8)
            acc_pf = all_reduce_((pn * tn * nm).sum(dim=1),
                                 arrs.group) / n_nodes
            acc_per_sample = acc_pf[:, keep].mean(dim=1)      # [b_l]
            acc = all_reduce_((acc_per_sample * sm).sum().reshape(1),
                              mesh.data_group)[0] / n_samples
        return float(loss), float(acc), float(raw_rmse)

    return call
