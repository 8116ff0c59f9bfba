"""Every field the port's graph builder makes equals the JAX package's
``Graph`` / ``RegularBlocks`` exactly (the builders share one algorithm;
the M2G triangle test must break ties the same way), and ``indptr`` agrees
with ``receivers``."""

import numpy as np
import pytest

from graphcast_lite_tpu.graphs.build import build_graph_set as jax_build
from graphcast_lite_torch.graphs.build import build_graph_set as port_build
from torch_port_common import assert_graph_equal

LAT = np.linspace(-87.1875, 87.1875, 32).astype(np.float32)
LON = np.arange(0, 360, 5.625).astype(np.float32)

_CACHE = {}


def _pair(levels):
    key = tuple(levels)
    if key not in _CACHE:
        _CACHE[key] = (jax_build(LAT, LON, levels, 0.6),
                       port_build(LAT, LON, levels, 0.6))
    return _CACHE[key]


def _statics_equal(jgs, tgs):
    for name in ("grid_static", "mesh_static", "grid_lat", "grid_lon",
                 "mesh_lat", "mesh_lon"):
        np.testing.assert_array_equal(getattr(tgs, name), getattr(jgs, name))
    assert tgs.num_grid_nodes == jgs.num_grid_nodes
    assert tgs.num_mesh_nodes == jgs.num_mesh_nodes


@pytest.mark.parametrize("levels", [[1, 2], [3, 5]])
@pytest.mark.parametrize("which", ["encoding", "processing", "decoding"])
def test_graph_fields_equal_jax(levels, which):
    jgs, tgs = _pair(levels)
    assert_graph_equal(getattr(jgs, which), getattr(tgs, which))


@pytest.mark.parametrize("levels", [[1, 2], [3, 5]])
def test_static_features_equal_jax(levels):
    _statics_equal(*_pair(levels))


def _eq_bf16(port_t, jax_a):
    """A port array cast to bf16 equals the JAX array cast as the bf16
    serve casts it (``bench.py``: every fp32 graph array to bf16)."""
    import jax.numpy as jnp
    import torch

    assert port_t.dtype == torch.bfloat16
    expect = np.asarray(jnp.asarray(jax_a).astype(jnp.bfloat16)
                        .astype(jnp.float32))
    np.testing.assert_array_equal(port_t.float().numpy(), expect)


def test_to_casts_float_arrays_only():
    """``.to(device, bf16)`` casts the float arrays, degrees and norms
    included, and rounds them where the JAX package's bf16 cast does; the
    index arrays stay int32."""
    import torch

    from graphcast_lite_tpu.graphs.structure import build_graph as jax_graph
    from graphcast_lite_torch.graphs.structure import build_graph

    jgs, tgs = _pair([1, 2])
    g = tgs.encoding.to("cpu", torch.bfloat16)
    for name in ("edge_mask", "gcn_norm", "static_in_degree"):
        _eq_bf16(getattr(g, name), getattr(jgs.encoding, name))
    assert g.senders.dtype == torch.int32 and g.indptr.dtype == torch.int32
    proc = tgs.processing.to("cpu", torch.bfloat16)
    _eq_bf16(proc.edge_attr, jgs.processing.edge_attr)
    rb = proc.reg_blocks
    for name in ("mask", "edge_attr"):
        _eq_bf16(getattr(rb, name), getattr(jgs.processing.reg_blocks, name))
    assert rb.senders.dtype == torch.int32

    # A hub of in-degree 347, which bf16 cannot hold exactly (it rounds to
    # 348).  The flagship encoder's busiest node has 346 edges, so 347 with
    # its self loop.
    snd = np.arange(1, 348)
    rcv = np.zeros(347, np.int64)
    hub = build_graph(snd, rcv, 400).to("cpu", torch.bfloat16)
    jhub = jax_graph(snd, rcv, 400)
    assert float(hub.static_in_degree[0]) == 348.0
    for name in ("static_in_degree", "gcn_norm"):
        _eq_bf16(getattr(hub, name), getattr(jhub, name))


# A region of the WB2 64x32 grid with a 5° mesh buffer, and the same grid
# given as per-node coordinates (a flat grid).
REGION, BUFFER = (40.0, 60.0, 60.0, 90.0), 5.0
FLAT_LON, FLAT_LAT = (a.reshape(-1) for a in np.meshgrid(LON, LAT))


def _flat_or_regional(kind, levels):
    key = (kind, tuple(levels))
    if key not in _CACHE:
        if kind == "regional":
            args = (LAT, LON, levels, 0.6)
            kw = dict(region_bounds=REGION, mesh_buffer_deg=BUFFER)
        else:
            args = (FLAT_LAT, FLAT_LON, levels, 0.6)
            kw = dict(flat_grid=True)
        _CACHE[key] = (jax_build(*args, **kw), port_build(*args, **kw))
    return _CACHE[key]


def test_regional_and_flat_grids_raise():
    """The port builds regional meshes and flat grids (it raised for both
    before they were ported; the name is kept): every array of both graph
    sets equals the JAX package's, and the pruned mesh has no
    constant-degree blocks."""
    for kind in ("regional", "flat"):
        jgs, tgs = _flat_or_regional(kind, [1, 2])
        for which in ("encoding", "processing", "decoding"):
            assert_graph_equal(getattr(jgs, which), getattr(tgs, which))
        _statics_equal(jgs, tgs)
    jgs, tgs = _flat_or_regional("regional", [1, 2])
    assert tgs.processing.reg_blocks is None
    assert tgs.num_mesh_nodes < _pair([1, 2])[1].num_mesh_nodes
    flat, regular = _flat_or_regional("flat", [1, 2])[1], _pair([1, 2])[1]
    np.testing.assert_array_equal(flat.grid_static, regular.grid_static)


@pytest.mark.parametrize("kind", ["regional", "flat"])
@pytest.mark.parametrize("which", ["encoding", "processing", "decoding"])
def test_flat_and_regional_fields_equal_jax(kind, which):
    """At mesh [3, 5], the flagship's 64x32 levels."""
    jgs, tgs = _flat_or_regional(kind, [3, 5])
    assert_graph_equal(getattr(jgs, which), getattr(tgs, which))
    _statics_equal(jgs, tgs)
