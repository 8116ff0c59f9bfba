"""The port's product graph against the JAX package on the CPU.

The JAX package builds the product graph's spatial k-NN with sklearn's
KD-tree; the port has no sklearn and keeps the lowest node ids among
equidistant candidates (``graphs/product.py``).  On a regular grid many
neighbours tie, so:

* the port's k-NN against sklearn's on the WB2 64x32 grid at k = 4 and 8:
  every node has the same sorted neighbour distances, the same neighbours
  nearer than its k-th distance, and the two edge sets differ only among
  the k-th-distance ties (81 edges of each set at k = 4, 162 in their
  symmetric difference; 2 of each at k = 8);
* the three product types against ``build_product_graph_edges`` on the
  same spatial edges (exactly), and on each package's own (differing only
  in the tie-decided spatial edges, once per spatial block);
* the product-graph model (pre-encoder, encoder, GCN processor, decoder)
  against the JAX model, with the port's product graph built from the
  JAX package's edges so that no tie enters the comparison, forward at
  atol 5e-5 / rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphcast_lite_tpu.config import ProductGraphType as JType
from graphcast_lite_tpu.graphs import product as jprod
from graphcast_lite_torch.config import ProductGraphType as PType
from graphcast_lite_torch.graphs import product as pprod
from torch_port_common import ATOL, LAT, LON, RTOL, graph_sets, \
    one_torch_thread  # noqa: F401 (an autouse fixture)

# Edges of each set that are not in the other, on the WB2 64x32 grid.
TIE_EDGES = {4: 81, 8: 2}


def _dist(lat, lon, s, r):
    pts = np.stack([np.repeat(lat, lon.size), np.tile(lon, lat.size)], 1) \
        .astype(np.float64)
    return np.linalg.norm(pts[s] - pts[r], axis=1)


@pytest.mark.parametrize("k", sorted(TIE_EDGES))
def test_knn_against_sklearn(k):
    js, jr = jprod.spatial_knn_adjacency(LAT, LON, k)
    ps, pr = pprod.spatial_knn_adjacency(LAT, LON, k)
    n = LAT.size * LON.size
    assert ps.shape == pr.shape == js.shape == (n * k,)
    np.testing.assert_array_equal(ps, np.repeat(np.arange(n), k))
    assert (pr != ps).all()
    jd = _dist(LAT, LON, js, jr)
    pd = _dist(LAT, LON, ps, pr)
    jorder = np.lexsort((jd, js))
    jd_sorted, jr_sorted = jd[jorder].reshape(n, k), jr[jorder].reshape(n, k)
    pd_rows, pr_rows = pd.reshape(n, k), pr.reshape(n, k)
    # The same distances at every node; the port's nearest first, ties by
    # lowest id.
    np.testing.assert_array_equal(pd_rows, jd_sorted)
    assert ((pd_rows[:, 1:] > pd_rows[:, :-1])
            | ((pd_rows[:, 1:] == pd_rows[:, :-1])
               & (pr_rows[:, 1:] > pr_rows[:, :-1]))).all()
    kth = pd_rows[:, -1:]
    # Neighbours nearer than the k-th distance: the same sets.
    near_p = np.where(pd_rows < kth, pr_rows, -1)
    near_j = np.where(jd_sorted < kth, jr_sorted, -1)
    np.testing.assert_array_equal(np.sort(near_p, 1), np.sort(near_j, 1))
    # Among the k-th-distance ties the port keeps the lowest ids.
    pedges = set(zip(ps.tolist(), pr.tolist()))
    jedges = set(zip(js.tolist(), jr.tolist()))
    assert len(pedges - jedges) == len(jedges - pedges) == TIE_EDGES[k]
    for s, r in pedges ^ jedges:
        assert np.isclose(_dist(LAT, LON, np.array([s]), np.array([r]))[0],
                          kth[s, 0])


@pytest.mark.parametrize("ptype", ["kronecker", "cartesian", "strong"])
def test_product_edges(ptype, monkeypatch):
    t, k = 5, 4
    jedges = jprod.build_product_graph_edges(LAT, LON, t, k, JType(ptype))
    own = pprod.build_product_graph_edges(LAT, LON, t, k, PType(ptype))
    # Own k-NN: the product repeats each spatial tie once per spatial
    # block (T - 1 time-chain blocks, T same-time blocks).
    blocks = {"kronecker": t - 1, "cartesian": t, "strong": 2 * t - 1}
    pe, je = set(zip(*(a.tolist() for a in own))), \
        set(zip(*(a.tolist() for a in jedges)))
    assert len(own[0]) == len(jedges[0])
    assert len(pe - je) == len(je - pe) == TIE_EDGES[k] * blocks[ptype]
    # On the JAX package's spatial edges: the same arrays.
    monkeypatch.setattr(pprod, "spatial_knn_adjacency",
                        jprod.spatial_knn_adjacency)
    same = pprod.build_product_graph_edges(LAT, LON, t, k, PType(ptype))
    for a, b in zip(same, jedges):
        np.testing.assert_array_equal(a, b)


def test_product_model_matches_jax():
    """The product-graph configuration at hidden 16, 5 features, obs 5,
    mesh [1, 2]: the port's forward against the JAX model's on the same
    product edges and weights."""
    from graphcast_lite_tpu import presets as jpresets
    from graphcast_lite_tpu.models.weather import ModelGraphs as JGraphs
    from graphcast_lite_tpu.models.weather import WeatherModel as JModel
    from graphcast_lite_torch import presets as ppresets
    from graphcast_lite_torch.graphs.structure import build_graph
    from graphcast_lite_torch.models.weather import ModelGraphs as PGraphs
    from graphcast_lite_torch.models.weather import WeatherModel as PModel
    from graphcast_lite_torch.utils.params import from_flax_params

    n_feat, obs = 5, 5
    jcfg = jpresets.product_graph_64x32(n_feat=n_feat, hidden=16)
    pcfg = ppresets.product_graph_64x32(n_feat=n_feat, hidden=16)
    jgs, tgs = graph_sets()
    jgraphs = JGraphs.from_graph_set(jgs, jcfg.pipeline.product_graph, obs)
    ps, pr = jprod.build_product_graph_edges(
        np.unique(jgs.grid_lat), np.unique(jgs.grid_lon), obs, 4,
        JType.KRONECKER)
    pgraphs = PGraphs.from_graph_set(tgs, pcfg.pipeline.product_graph, obs)
    assert pgraphs.product.num_nodes == obs * tgs.num_grid_nodes
    assert pgraphs.product.num_edges == ps.size
    pgraphs.product = build_graph(ps, pr, num_nodes=obs * tgs.num_grid_nodes)
    jmodel = JModel(pipeline=jcfg.pipeline, data=jcfg.data,
                    num_grid_nodes=jgs.num_grid_nodes,
                    num_mesh_nodes=jgs.num_mesh_nodes)
    x = np.random.RandomState(3).randn(jgs.num_grid_nodes,
                                       obs * n_feat).astype(np.float32)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x), jgraphs)
    expect, _ = jmodel.apply(params, jnp.asarray(x), jgraphs)
    pmodel = PModel(pcfg.pipeline, pcfg.data, tgs.num_grid_nodes,
                    tgs.num_mesh_nodes)
    state = from_flax_params(jax.tree.map(np.asarray, params))
    assert any(k.startswith("product_model.") for k in state)
    pmodel.load_state_dict(state)
    with torch.no_grad():
        out, mask = pmodel(torch.from_numpy(x), pgraphs)
    assert mask is None
    np.testing.assert_allclose(out.numpy(), np.asarray(expect), atol=ATOL,
                               rtol=RTOL)
