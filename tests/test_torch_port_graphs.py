"""Every field the port's graph builder makes equals the JAX package's
``Graph`` / ``RegularBlocks`` exactly (the builders share one algorithm;
the M2G triangle test must break ties the same way), and ``indptr`` agrees
with ``receivers``."""

import numpy as np
import pytest

from graphcast_lite_tpu.graphs.build import build_graph_set as jax_build
from graphcast_lite_torch.graphs.build import build_graph_set as port_build

LAT = np.linspace(-87.1875, 87.1875, 32).astype(np.float32)
LON = np.arange(0, 360, 5.625).astype(np.float32)

_CACHE = {}


def _pair(levels):
    key = tuple(levels)
    if key not in _CACHE:
        _CACHE[key] = (jax_build(LAT, LON, levels, 0.6),
                       port_build(LAT, LON, levels, 0.6))
    return _CACHE[key]


def _eq(port_t, jax_a):
    a = np.asarray(jax_a)
    b = port_t.numpy()
    assert b.shape == a.shape and b.dtype == a.dtype, (b.dtype, a.dtype)
    np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("levels", [[1, 2], [3, 5]])
@pytest.mark.parametrize("which", ["encoding", "processing", "decoding"])
def test_graph_fields_equal_jax(levels, which):
    jgs, tgs = _pair(levels)
    jg, tg = getattr(jgs, which), getattr(tgs, which)
    for name in ("senders", "receivers", "edge_mask", "static_in_degree",
                 "gcn_norm"):
        _eq(getattr(tg, name), getattr(jg, name))
    assert (jg.edge_attr is None) == (tg.edge_attr is None)
    if jg.edge_attr is not None:
        _eq(tg.edge_attr, jg.edge_attr)
    for name in ("num_nodes", "num_receivers", "num_edges",
                 "const_in_degree", "num_const_receivers"):
        assert getattr(tg, name) == getattr(jg, name), name

    # indptr: receiver CSR offsets over the padded, sorted rows.
    recv = tg.receivers.numpy()
    ip = tg.indptr.numpy()
    assert ip.dtype == np.int32 and ip.shape == (tg.num_receivers + 1,)
    assert ip[0] == 0 and ip[-1] == tg.padded_num_edges
    np.testing.assert_array_equal(np.diff(ip), np.bincount(
        recv, minlength=tg.num_receivers))
    np.testing.assert_array_equal(
        np.repeat(np.arange(tg.num_receivers), np.diff(ip)), recv)

    assert (jg.reg_blocks is None) == (tg.reg_blocks is None)
    if jg.reg_blocks is not None:
        jr, tr = jg.reg_blocks, tg.reg_blocks
        for name in ("senders", "mask", "edge_attr"):
            _eq(getattr(tr, name), getattr(jr, name))
        assert tr.block_recv == jr.block_recv
        assert tr.block_k == jr.block_k
        assert tr.num_nodes == jr.num_nodes
        assert tr.rows_padded == jr.rows_padded


@pytest.mark.parametrize("levels", [[1, 2], [3, 5]])
def test_static_features_equal_jax(levels):
    jgs, tgs = _pair(levels)
    for name in ("grid_static", "mesh_static", "grid_lat", "grid_lon",
                 "mesh_lat", "mesh_lon"):
        np.testing.assert_array_equal(getattr(tgs, name), getattr(jgs, name))
    assert tgs.num_grid_nodes == jgs.num_grid_nodes
    assert tgs.num_mesh_nodes == jgs.num_mesh_nodes


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


def test_regional_and_flat_grids_raise():
    with pytest.raises(NotImplementedError, match="A10"):
        port_build(LAT, LON, [1, 2], 0.6, region_bounds=(40, 60, 60, 90))
    with pytest.raises(NotImplementedError, match="A10"):
        port_build(LAT, LON, [1, 2], 0.6, flat_grid=True)
