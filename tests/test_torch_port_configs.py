"""The four WB2 64x32 BASELINE configurations of the JAX package's presets
(GCN, GAT at 4 heads, SparseGAT, product graph) through the port against
the JAX package on the CPU, at a reduced size: 5 features, hidden 16,
mesh [1, 2].  The product graph takes the JAX package's edges (no k-NN
tie enters, ``test_torch_port_product.py``).

* Forward: the single-sample model, fp32, atol 5e-5 / rtol 1e-4.
* One AR-2 BPTT train step: the port's ``make_train_step`` (``run``, with
  the edge mask carried) against ``jax.value_and_grad`` of the JAX
  package's ``rollout_loss`` as its ``Trainer`` builds it: the loss within
  1e-5 relative, every gradient within 1e-4 of the leaf's largest + 1e-6.
  SparseGAT prunes at 0.1356 in both AR steps, and the returned masks are
  equal on every edge whose α (the port's, at each AR step) lies more than
  1e-5 from the threshold.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphcast_lite_tpu import presets as jpresets
from graphcast_lite_tpu.config import ProductGraphType as JType
from graphcast_lite_tpu.graphs.product import build_product_graph_edges
from graphcast_lite_tpu.models.weather import ModelGraphs as JGraphs
from graphcast_lite_tpu.models.weather import WeatherModel as JModel
from graphcast_lite_torch import presets as ppresets
from graphcast_lite_torch.graphs.structure import build_graph
from graphcast_lite_torch.models.weather import ModelGraphs as PGraphs
from graphcast_lite_torch.models.weather import WeatherModel as PModel
from graphcast_lite_torch.utils.params import from_flax_params
from torch_port_common import ATOL, GRAD_ATOL, GRAD_RTOL, LEVELS, \
    LOSS_RTOL, RTOL, flax_numpy, graph_sets, \
    one_torch_thread  # noqa: F401 (an autouse fixture)

N_FEAT, HID, AR, THR = 5, 16, 2, 0.1356
CONFIGS = {
    "gcn": ("baseline_gcn_64x32", {}),
    "gat": ("gat_64x32", {"heads": 4}),
    "sparse_gat": ("sparse_gat_64x32", {}),
    "product_graph": ("product_graph_64x32", {}),
}
ALPHA_MARGIN = 1e-5


def _pair(name):
    """(jax cfg, jax model, params, jax graphs, port cfg, port model, port
    graphs), the JAX init bridged into the port."""
    fn, kw = CONFIGS[name]
    jcfg = getattr(jpresets, fn)(n_feat=N_FEAT, hidden=HID, **kw)
    pcfg = getattr(ppresets, fn)(n_feat=N_FEAT, hidden=HID, **kw)
    for cfg in (jcfg, pcfg):
        cfg.graph.mesh_levels = list(LEVELS)
        cfg.max_ar_steps = AR
    obs = jcfg.data.obs_window_used
    jgs, tgs = graph_sets()
    jgraphs = JGraphs.from_graph_set(jgs, jcfg.pipeline.product_graph, obs)
    pgraphs = PGraphs.from_graph_set(tgs)
    if jcfg.pipeline.product_graph is not None:
        ps, pr = build_product_graph_edges(
            np.unique(jgs.grid_lat), np.unique(jgs.grid_lon), obs, 4,
            JType.KRONECKER)
        pgraphs.product = build_graph(ps, pr,
                                      num_nodes=obs * tgs.num_grid_nodes)
    jmodel = JModel(pipeline=jcfg.pipeline, data=jcfg.data,
                    num_grid_nodes=jgs.num_grid_nodes,
                    num_mesh_nodes=jgs.num_mesh_nodes)
    dummy = np.zeros((jgs.num_grid_nodes, obs * N_FEAT), np.float32)
    params = jmodel.init(jax.random.PRNGKey(0), dummy, jgraphs)
    pmodel = PModel(pcfg.pipeline, pcfg.data, tgs.num_grid_nodes,
                    tgs.num_mesh_nodes)
    pmodel.load_state_dict(from_flax_params(flax_numpy(params)))
    return jcfg, jmodel, params, jgraphs, pcfg, pmodel, pgraphs


def _batch(g, obs, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(1, g, obs * N_FEAT).astype(np.float32),
            rng.randn(1, g, AR * N_FEAT).astype(np.float32))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward(name):
    jcfg, jmodel, params, jgraphs, _, pmodel, pgraphs = _pair(name)
    x, _ = _batch(pmodel.num_grid_nodes, jcfg.data.obs_window_used)
    prune = name == "sparse_gat"
    expect, jmask = jmodel.apply(params, jnp.asarray(x[0]), jgraphs, None,
                                 THR, prune)
    with torch.no_grad():
        out, pmask = pmodel(torch.from_numpy(x[0]), pgraphs, None, THR,
                            prune)
    np.testing.assert_allclose(out.numpy(), np.asarray(expect), atol=ATOL,
                               rtol=RTOL)
    assert (pmask is None) == (jmask is None) == (not prune)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_train_step(name):
    from graphcast_lite_tpu.training.rollout import RolloutSpec as JSpec
    from graphcast_lite_tpu.training.rollout import rollout_loss
    from graphcast_lite_torch.training.loss import lat_weights_from_axis
    from graphcast_lite_torch.training.rollout import RolloutSpec as PSpec
    from graphcast_lite_torch.training.trainer import make_train_step

    jcfg, jmodel, params, jgraphs, pcfg, pmodel, pgraphs = _pair(name)
    obs = jcfg.data.obs_window_used
    g = pmodel.num_grid_nodes
    x, y = _batch(g, obs, 1)
    lw = lat_weights_from_axis(32, 64)
    sparse = name == "sparse_gat"
    mask0 = pgraphs.processing.edge_mask.clone() if sparse else None
    spec = dict(obs_window=obs, num_features=N_FEAT, use_residual=True,
                remat=True)

    def loss_fn(p):
        def fn(inp, m, t, pr):
            out, nm = jmodel.apply(p, inp[0], jgraphs, m, t, pr)
            return out[None], nm

        return rollout_loss(
            fn, jnp.asarray(x).reshape(1, g, obs, N_FEAT),
            jnp.asarray(y).reshape(1, g, AR, N_FEAT), AR, JSpec(**spec),
            None if mask0 is None else jnp.asarray(mask0.numpy()),
            jnp.asarray(THR, jnp.float32), sparse, jnp.asarray(lw))

    (jloss, jmask), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        params)
    alphas = []
    if sparse:
        pmodel.processor.graph_layer.conv_0.core.register_forward_hook(
            lambda mod, args, out: alphas.append(out[1].detach().clone()))
    step = make_train_step(pmodel, pgraphs, PSpec(**spec), pcfg,
                           device="cpu", lat_weights=lw)
    loss, pmask = step.run(x, y, mask0, THR, sparse)
    assert abs(float(loss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    expect = from_flax_params(flax_numpy(jgrads))
    grads = {n: p.grad for n, p in pmodel.named_parameters()}
    assert set(grads) == set(expect)
    for n, gr in grads.items():
        err = (gr - expect[n]).abs().max().item()
        assert err <= GRAD_RTOL * expect[n].abs().max().item() + GRAD_ATOL, \
            (n, err)
    if not sparse:
        assert pmask is None and jmask is None
        return
    # The forward's two AR steps (the backward's recompute runs them
    # again).
    far = np.ones(mask0.numel(), bool)
    for alpha in alphas[:AR]:
        far &= np.abs(alpha.numpy() - THR) > ALPHA_MARGIN
    live = float(mask0.sum())
    assert 0 < float(pmask.sum()) < live
    assert pmask.dtype == torch.float32
    np.testing.assert_array_equal(pmask.numpy()[far], np.asarray(jmask)[far])
