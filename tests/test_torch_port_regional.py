"""The regional refinement stack against the JAX package on the CPU.

* Every array of ``create_regional_mesh``, ``build_regional_graphs`` and
  ``build_roi_knn_graph`` equals the JAX package's, on
  ``tests/test_regional.py``'s ROI and levels (a 20x24 grid, global mesh
  level 2, regional level 3, 5° buffer; the ROI graph at k = 4 and 8).
* ``DualMeshRegional`` and ``ROIResidualModule`` forwards with the JAX
  package's initial weights bridged in (``utils.params.from_flax_params``).
* The composed forwards (``dual_mesh_forward``, ``roi_residual_forward``)
  over the small flagship architecture's 64x32 global model, the head's
  gradients of the ROI loss against ``jax.grad``, and one Adam step
  against ``optax.adam``.

The ROI-residual processor runs lazily on the port and plainly in the
JAX package on the CPU by default (ROADMAP Queue C): both packages run
under the same ``GCLT_LAZY_EDGE``.  fp32 tolerances: outputs atol 5e-5 /
rtol 1e-4, the loss 1e-5 relative, per gradient leaf 1e-4 max|g| + 1e-6;
the Adam update as ``tests/test_torch_port_train.py`` holds it.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from graphcast_lite_tpu.graphs import regional as jreg
from graphcast_lite_torch.graphs import regional as treg
from graphcast_lite_torch.utils.params import from_flax_params
from torch_port_common import (
    ATOL,
    GRAD_ATOL,
    GRAD_RTOL,
    LOSS_RTOL,
    RTOL,
    assert_graph_equal,
    flax_numpy,
    graph_sets,
    model_pair,
    one_torch_thread,  # noqa: F401 (an autouse fixture)
    to_torch,
)

ROI = (30.0, 60.0, 60.0, 120.0)
LEVELS = dict(reg_mesh_level=3, reg_mesh_buffer=5.0, global_level=2)
HIDDEN, STEPS, LR = 32, 2, 1e-3


def _grid():
    lats = np.linspace(-80, 80, 20).astype(np.float32)
    lons = np.arange(0, 360, 15).astype(np.float32)
    lon2d, lat2d = np.meshgrid(lons, lats)
    return lat2d.reshape(-1), lon2d.reshape(-1)


@functools.lru_cache(maxsize=None)
def _regional(pkg):
    from graphcast_lite_tpu.mesh.icosphere import build_hierarchy, \
        mesh_lat_lon

    mlats, mlons = mesh_lat_lon(build_hierarchy(2)[-1])
    glats, glons = _grid()
    mod = jreg if pkg == "jax" else treg
    return mod.build_regional_graphs(mlats, mlons, glats, glons, ROI,
                                     **LEVELS)


def test_create_regional_mesh_equals_jax():
    jm, jlat, jlon = jreg.create_regional_mesh(ROI, level=3, buffer_deg=5.0,
                                               global_level=2)
    tm, tlat, tlon = treg.create_regional_mesh(ROI, level=3, buffer_deg=5.0,
                                               global_level=2)
    for a, b in ((tm.vertices, jm.vertices), (tm.faces, jm.faces),
                 (tlat, jlat), (tlon, jlon)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("which", ["processing", "cross_g2r", "encoding",
                                   "decoding"])
def test_regional_graphs_equal_jax(which):
    jrg, trg = _regional("jax"), _regional("port")
    assert_graph_equal(getattr(jrg, which), getattr(trg, which))
    for name in ("dec_idw", "roi_mask", "roi_idx", "reg_lats", "reg_lons"):
        a, b = getattr(trg, name), getattr(jrg, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (trg.n_reg_mesh, trg.n_roi) == (jrg.n_reg_mesh, jrg.n_roi)
    # The IDW weights sum to 1 over each ROI point's decoding edges.
    sums = np.zeros(trg.n_roi)
    np.add.at(sums, trg.decoding.receivers.numpy(),
              trg.dec_idw * trg.decoding.edge_mask.numpy())
    np.testing.assert_allclose(sums, 1.0, atol=1e-4)


@pytest.mark.parametrize("k", [4, 8])
def test_roi_knn_graph_equals_jax(k):
    glats, glons = _grid()
    jmask, jg = jreg.build_roi_knn_graph(glats, glons, ROI, k=k)
    tmask, tg = treg.build_roi_knn_graph(glats, glons, ROI, k=k)
    np.testing.assert_array_equal(tmask, jmask)
    assert_graph_equal(jg, tg)


def _jax_dual(rg, n_grid, raw, d_g, n_mesh):
    from graphcast_lite_tpu.models.dual_mesh import DualMeshRegional, \
        RegionalDeviceGraphs

    graphs = RegionalDeviceGraphs.from_host(rg, n_grid)
    module = DualMeshRegional(hidden_dim=HIDDEN, output_channels=5,
                              processor_steps=STEPS)
    params = module.init(jax.random.PRNGKey(1),
                         jnp.zeros((rg.n_roi, raw)),
                         jnp.zeros((rg.n_roi, d_g)),
                         jnp.zeros((n_mesh, d_g)), graphs)
    return module, params, graphs


def _port_dual(rg, n_grid, raw, d_g, params):
    from graphcast_lite_torch.models.dual_mesh import DualMeshRegional, \
        RegionalDeviceGraphs

    head = DualMeshRegional(raw, d_g, HIDDEN, 5, STEPS)
    head.load_state_dict(from_flax_params(flax_numpy(params)))
    return head, RegionalDeviceGraphs.from_host(rg, n_grid)


def _jax_roi(graph, n_roi, raw, d_g, c=5):
    from graphcast_lite_tpu.models.roi_residual import ROIResidualModule

    module = ROIResidualModule(hidden_dim=HIDDEN, output_channels=c,
                               processor_steps=STEPS)
    params = module.init(jax.random.PRNGKey(1), jnp.zeros((n_roi, raw)),
                         jnp.zeros((n_roi, d_g)), jnp.zeros((n_roi, c)),
                         graph)
    return module, params


def _port_roi(params, raw, d_g, c=5):
    from graphcast_lite_torch.models.roi_residual import ROIResidualModule

    head = ROIResidualModule(raw, d_g, HIDDEN, c, STEPS)
    head.load_state_dict(from_flax_params(flax_numpy(params)))
    return head


def _perturbed(params, scale=0.05):
    """The init with every leaf moved (LayerNorm affines, zero biases and
    the small output kernel all become non-trivial)."""
    leaves, tree = jax.tree.flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(9), len(leaves))
    return jax.tree.unflatten(tree, [
        v + scale * jax.random.normal(k, v.shape)
        for v, k in zip(leaves, keys)])


def test_dual_mesh_module_forward(monkeypatch):
    monkeypatch.delenv("GCLT_LAZY_EDGE", raising=False)
    rg_j, rg_t = _regional("jax"), _regional("port")
    glats, _ = _grid()
    n_grid, raw, d_g, n_mesh = len(glats), 6, 16, 162
    module, params, jgraphs = _jax_dual(rg_j, n_grid, raw, d_g, n_mesh)
    params = _perturbed(params)
    head, tgraphs = _port_dual(rg_t, n_grid, raw, d_g, params)
    rng = np.random.RandomState(0)
    args = (rng.randn(rg_j.n_roi, raw), rng.randn(rg_j.n_roi, d_g),
            rng.randn(n_mesh, d_g))
    args = [a.astype(np.float32) for a in args]
    expect = module.apply(params, *map(jnp.asarray, args), jgraphs)
    with torch.no_grad():
        out = head(*map(to_torch, args), tgraphs)
    assert head.reg_processor.step.route == "nonlazy"
    np.testing.assert_allclose(out.numpy(), np.asarray(expect), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("lazy", ["0", "1"])
def test_roi_residual_module_forward(monkeypatch, lazy):
    monkeypatch.setenv("GCLT_LAZY_EDGE", lazy)
    glats, glons = _grid()
    _, jg = jreg.build_roi_knn_graph(glats, glons, ROI, k=4)
    _, tg = treg.build_roi_knn_graph(glats, glons, ROI, k=4)
    n_roi, raw, d_g = tg.num_nodes, 6, 16
    module, params = _jax_roi(jg, n_roi, raw, d_g)
    params = _perturbed(params)
    head = _port_roi(params, raw, d_g)
    rng = np.random.RandomState(1)
    args = [rng.randn(n_roi, f).astype(np.float32) for f in (raw, d_g, 5)]
    expect = module.apply(params, *map(jnp.asarray, args), jg)
    with torch.no_grad():
        out = head(*map(to_torch, args), tg)
    assert {s.route for s in head.processor.steps} == {
        "nonlazy" if lazy == "0" else "composed"}
    np.testing.assert_allclose(out.numpy(), np.asarray(expect), atol=ATOL,
                               rtol=RTOL)


# ---- the composed model over the 64x32 global model ----------------------


@pytest.fixture
def composed(monkeypatch):
    """Both packages' small 64x32 global model (plain processor in both)
    and a dual-mesh and an ROI-residual head over it; a seeded input and
    target."""
    monkeypatch.setenv("GCLT_LAZY_EDGE", "0")
    for name in ("GCLT_REG_EDGE", "GCLT_EDGE_STEP", "GCLT_MEGA_EDGE",
                 "GCLT_FUSED_EDGE"):
        monkeypatch.delenv(name, raising=False)
    jmodel, gparams, jgraphs, tmodel, tgraphs = model_pair()
    jgs, tgs = graph_sets()
    roi = (20.0, 60.0, 60.0, 140.0)
    kw = dict(reg_mesh_level=3, global_level=2)
    rg_j = jreg.build_regional_graphs(jgs.mesh_lat, jgs.mesh_lon,
                                      jgs.grid_lat, jgs.grid_lon, roi, **kw)
    rg_t = treg.build_regional_graphs(tgs.mesh_lat, tgs.mesh_lon,
                                      tgs.grid_lat, tgs.grid_lon, roi, **kw)
    roi_j, graph_j = jreg.build_roi_knn_graph(jgs.grid_lat, jgs.grid_lon,
                                              roi, k=8)
    _, graph_t = treg.build_roi_knn_graph(tgs.grid_lat, tgs.grid_lon, roi,
                                          k=8)
    g, d_g, c = tgs.num_grid_nodes, tmodel.latent_dim, 5
    rng = np.random.RandomState(2)
    x = rng.randn(g, 2 * c).astype(np.float32)
    y = rng.randn(g, c).astype(np.float32)

    def jglobal(xg):
        pred, _, lat, mesh = jmodel.apply(gparams, xg, jgraphs,
                                          with_latents=True)
        return pred, lat, mesh

    def tglobal(xg):
        pred, _, lat, mesh = tmodel(xg, tgraphs, with_latents=True)
        return pred, lat, mesh

    return dict(jglobal=jglobal, tglobal=tglobal, rg_j=rg_j, rg_t=rg_t,
                roi_idx=np.flatnonzero(roi_j), graph_j=graph_j,
                graph_t=graph_t, x=x, y=y, g=g, d_g=d_g,
                n_mesh=tgs.num_mesh_nodes)


def _head_pair(kind, ctx):
    """(jax apply(params, x) -> composed out, jax params, port head,
    port composed(x) -> out)."""
    from graphcast_lite_tpu.models.dual_mesh import dual_mesh_forward as jdm
    from graphcast_lite_tpu.models.roi_residual import \
        roi_residual_forward as jrr
    from graphcast_lite_torch.models.dual_mesh import dual_mesh_forward
    from graphcast_lite_torch.models.roi_residual import \
        roi_residual_forward

    raw, d_g = ctx["x"].shape[1], ctx["d_g"]
    if kind == "dual_mesh":
        module, params, jgraphs = _jax_dual(ctx["rg_j"], ctx["g"], raw, d_g,
                                            ctx["n_mesh"])
        params = _perturbed(params)
        head, tgraphs = _port_dual(ctx["rg_t"], ctx["g"], raw, d_g, params)

        def japply(p, xg):
            return jdm(ctx["jglobal"],
                       lambda rr, rl, ml: module.apply(p, rr, rl, ml,
                                                       jgraphs), xg, jgraphs)

        def tapply(xg):
            return dual_mesh_forward(
                ctx["tglobal"],
                lambda rr, rl, ml: head(rr, rl, ml, tgraphs), xg, tgraphs)
        return japply, params, head, tapply
    n_roi = len(ctx["roi_idx"])
    module, params = _jax_roi(ctx["graph_j"], n_roi, raw, d_g)
    params = _perturbed(params)
    head = _port_roi(params, raw, d_g)
    roi_j = jnp.asarray(ctx["roi_idx"])
    roi_t = torch.from_numpy(ctx["roi_idx"])

    def japply(p, xg):
        return jrr(ctx["jglobal"],
                   lambda rr, rl, rp, gr: module.apply(p, rr, rl, rp, gr),
                   xg, roi_j, ctx["graph_j"])

    def tapply(xg):
        return roi_residual_forward(ctx["tglobal"], head, xg, roi_t,
                                    ctx["graph_t"])
    return japply, params, head, tapply


@pytest.mark.parametrize("kind", ["dual_mesh", "roi_residual"])
def test_composed_forward_gradients_and_adam(composed, kind):
    from graphcast_lite_tpu.training.loss import weighted_mse as jmse
    from graphcast_lite_torch.training.loss import weighted_mse

    ctx = composed
    japply, params, head, tapply = _head_pair(kind, ctx)
    roi = ctx["roi_idx"]
    x, y = ctx["x"], ctx["y"]

    def jloss(p):
        out = japply(p, jnp.asarray(x))
        return jmse(out[roi], jnp.asarray(y)[roi]), out

    (expect_loss, expect), jgrads = jax.value_and_grad(
        jloss, has_aux=True)(params)
    roi_t = torch.from_numpy(roi)
    out = tapply(to_torch(x))
    loss = weighted_mse(out[roi_t], to_torch(y)[roi_t])
    loss.backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(expect),
                               atol=ATOL, rtol=RTOL)
    # Outside the ROI the output is the global prediction.
    outside = np.setdiff1d(np.arange(ctx["g"]), roi)
    pred = ctx["tglobal"](to_torch(x))[0].detach().numpy()
    np.testing.assert_array_equal(out.detach().numpy()[outside],
                                  pred[outside])
    assert abs(loss.item() - float(expect_loss)) \
        <= LOSS_RTOL * abs(float(expect_loss))
    expect_grads = from_flax_params(flax_numpy(jgrads))
    assert set(expect_grads) == {n for n, _ in head.named_parameters()}
    for name, p in head.named_parameters():
        ref = expect_grads[name].numpy()
        got = (p.grad if p.grad is not None
               else torch.zeros_like(p)).numpy()
        err = np.abs(got - ref).max()
        assert err <= GRAD_RTOL * np.abs(ref).max() + GRAD_ATOL, \
            f"{name}: {err:.3e}"

    # One Adam step on the port's own gradients against optax.adam.
    before = {n: p.detach().clone() for n, p in head.named_parameters()}
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in head.named_parameters()}
    torch.optim.Adam(head.parameters(), lr=LR).step()
    jp = {n: jnp.asarray(p.numpy()) for n, p in before.items()}
    opt = optax.adam(LR)
    updates, _ = opt.update({n: jnp.asarray(g.numpy())
                             for n, g in grads.items()}, opt.init(jp), jp)
    after = optax.apply_updates(jp, updates)
    for name, p in head.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(after[name]), rtol=1e-6,
                                   atol=1e-7, err_msg=name)
