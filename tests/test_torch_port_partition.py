"""The port's host-side graph partition (``graphs.partition``) against the
JAX package's, on the CPU.

On the 64x32 graph set (mesh [1, 2]) that each package builds, the three
graphs are sharded as the JAX package's ``parallel.sharded_model.
build_sharding_plan`` shards them — by latitude bands (banded halos) and
by shared 2-D tiles (tiled halos), at S = 2 and 4 — and every array and
size of each ``NodePartition``, ``ShardedGraph`` and halo plan is equal,
as is ``rows_exchanged_per_step``.  The port's graphs pad receivers with
``num_receivers - 1`` where the JAX package's pad with ``num_nodes - 1``;
the partition reads only the first ``num_edges`` edges, so the padding
does not reach it (shown by rewriting it).  Scatter and gather return
their input.  The product graph is left out: its k-NN ties differ by
design.
"""

import dataclasses

import numpy as np
import pytest
import torch

from graphcast_lite_tpu.graphs import partition as jpart
from graphcast_lite_torch.graphs import partition as ppart
from torch_port_common import graph_sets
from torch_port_common import \
    one_torch_thread  # noqa: F401 (an autouse fixture)

# parallel/sharded_model.MESH_NODE_WEIGHT of the JAX package.
MESH_NODE_WEIGHT = 7.0
CASES = [(s, mode) for s in (2, 4) for mode in ("lat", "tiles")]


def _plan(part, gs, num_shards, mode):
    """(grid partition, mesh partition, {graph: (ShardedGraph, halos)})
    as ``build_sharding_plan(gs, num_shards, partition=mode)`` builds
    them, with the partition module ``part``."""
    if mode == "tiles":
        shape = part.TileShape.factor(num_shards)
        lat_e, lon_e = part.tile_boundaries(
            np.concatenate([gs.grid_lat, gs.mesh_lat]),
            np.concatenate([gs.grid_lon, gs.mesh_lon]),
            np.concatenate([np.ones(gs.num_grid_nodes, np.float64),
                            np.full(gs.num_mesh_nodes, MESH_NODE_WEIGHT,
                                    np.float64)]),
            shape)
        grid = part.build_node_partition(part.partition_nodes_by_tiles(
            gs.grid_lat, gs.grid_lon, lat_e, lon_e, shape), num_shards)
        mesh = part.build_node_partition(part.partition_nodes_by_tiles(
            gs.mesh_lat, gs.mesh_lon, lat_e, lon_e, shape), num_shards)

        def halos(sg):
            return part.build_tiled_halos(sg, shape)
    else:
        grid = part.build_node_partition(part.partition_nodes_by_latitude(
            gs.grid_lat, num_shards), num_shards)
        mesh = part.build_node_partition(part.partition_nodes_by_latitude(
            gs.mesh_lat, num_shards), num_shards)
        halos = part.build_banded_halos
    n = gs.num_grid_nodes
    sharded = {
        "enc": part.shard_graph_bipartite(gs.encoding, grid, mesh, 0, n),
        "proc": part.shard_graph_bipartite(gs.processing, mesh, mesh),
        "dec": part.shard_graph_bipartite(gs.decoding, mesh, grid, n, 0),
    }
    return grid, mesh, {k: (sg, halos(sg)) for k, sg in sharded.items()}


def _assert_fields_equal(port, ref, label):
    assert type(port).__name__ == type(ref).__name__
    for f in dataclasses.fields(ref):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        where = f"{label}.{f.name}"
        if isinstance(b, np.ndarray):
            assert isinstance(a, np.ndarray), where
            assert a.dtype == b.dtype and a.shape == b.shape, where
            np.testing.assert_array_equal(a, b, err_msg=where)
        elif dataclasses.is_dataclass(b):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), where
        else:
            assert a == b, where


@pytest.mark.parametrize("num_shards,mode", CASES)
def test_partition_equals_jax(num_shards, mode):
    jgs, pgs = graph_sets()
    jgrid, jmesh, jgraphs = _plan(jpart, jgs, num_shards, mode)
    pgrid, pmesh, pgraphs = _plan(ppart, pgs, num_shards, mode)
    _assert_fields_equal(pgrid, jgrid, "grid")
    _assert_fields_equal(pmesh, jmesh, "mesh")
    for name, (jsg, jh) in jgraphs.items():
        psg, ph = pgraphs[name]
        _assert_fields_equal(psg, jsg, name)
        _assert_fields_equal(ph, jh, f"{name} halos")
        assert type(ph).__name__ == ("TiledHalos" if mode == "tiles"
                                     else "BandedHalos")
        assert ph.rows_exchanged_per_step(psg) \
            == jh.rows_exchanged_per_step(jsg)


def test_plan_is_the_jax_sharding_plan():
    """``_plan`` is how the JAX package's ``build_sharding_plan`` shards
    the graph set: its arrays at S = 4, by tiles."""
    from graphcast_lite_tpu.parallel.sharded_model import \
        build_sharding_plan

    jgs, _ = graph_sets()
    plan = build_sharding_plan(jgs, 4, halo_mode="banded",
                               partition="tiles")
    grid, mesh, graphs = _plan(jpart, jgs, 4, "tiles")
    _assert_fields_equal(grid, plan.grid_part, "grid")
    _assert_fields_equal(mesh, plan.mesh_part, "mesh")
    for name, (sg, h) in graphs.items():
        _assert_fields_equal(sg, getattr(plan, name), name)
        _assert_fields_equal(h, getattr(plan, f"{name}_halos"), name)


def test_padding_does_not_reach_the_partition():
    """The port pads receivers with ``num_receivers - 1`` and the JAX
    package with ``num_nodes - 1`` (equal on these unified graphs): the
    port's partition of the encoder graph is the same with its padded
    edges rewritten, and with a bf16 edge_attr it reads the fp32 values
    rounded to bf16."""
    _, pgs = graph_sets()
    enc = pgs.encoding
    e = enc.num_edges
    assert enc.padded_num_edges > e
    shape = ppart.TileShape.factor(4)
    grid, mesh, graphs = _plan(ppart, pgs, 4, "lat")
    rewritten = dataclasses.replace(
        enc, receivers=torch.cat([enc.receivers[:e],
                                  torch.zeros_like(enc.receivers[e:])]),
        senders=torch.cat([enc.senders[:e],
                           torch.full_like(enc.senders[e:], -5)]))
    _assert_fields_equal(ppart.shard_graph_bipartite(
        rewritten, grid, mesh, 0, pgs.num_grid_nodes), graphs["enc"][0],
        "enc")

    proc = pgs.processing
    node_shard = ppart.partition_nodes_by_tiles(
        pgs.mesh_lat, pgs.mesh_lon, *ppart.tile_boundaries(
            pgs.mesh_lat, pgs.mesh_lon, np.ones(pgs.num_mesh_nodes), shape),
        shape)
    ref = ppart.shard_graph(proc, node_shard, 4)
    half = proc.to(float_dtype=torch.bfloat16)
    assert half.edge_attr.dtype == torch.bfloat16
    got = ppart.shard_graph(half, node_shard, 4)
    assert got.edge_attr.dtype == np.float32
    expect = torch.from_numpy(ref.edge_attr).bfloat16().float().numpy()
    np.testing.assert_array_equal(got.edge_attr, expect)
    for name in ("senders_global", "receivers_local", "edge_mask"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(ref, name))


@pytest.mark.parametrize("num_shards,mode", CASES)
def test_scatter_gather_round_trip(num_shards, mode):
    _, pgs = graph_sets()
    grid, mesh, graphs = _plan(ppart, pgs, num_shards, mode)
    rng = np.random.RandomState(num_shards)
    for part, n in ((grid, pgs.num_grid_nodes), (mesh, pgs.num_mesh_nodes)):
        x = rng.randn(3, n, 5).astype(np.float32)
        sh = part.scatter(x)
        assert sh.shape == (3, num_shards, part.nodes_per_shard, 5)
        assert not sh[..., part.node_mask == 0, :].any()
        np.testing.assert_array_equal(part.gather(sh), x)
    for name, (sg, _) in graphs.items():
        n = sg.num_nodes
        x = rng.randn(n, 4).astype(np.float32)
        sh = ppart.scatter_nodes(sg, x)
        assert sh.shape == (num_shards, sg.nodes_per_shard, 4)
        np.testing.assert_array_equal(ppart.gather_nodes(sg, sh), x)
        # And equal to the JAX package's scatter.
        np.testing.assert_array_equal(sh, jpart.scatter_nodes(sg, x))
