"""The port's COO processor routes against the JAX package on the CPU.

The lazy-LN step takes the COO layout where the graph has no RegularBlocks
or with ``GCLT_REG_EDGE=0``, and within it one of three routes, picked by
the reference's own switches: composed (segment sum), edge step
(``GCLT_EDGE_STEP=1``) or mega (``GCLT_MEGA_EDGE=1``).  Each test sets the
same switches for both packages, checks the route each took (the port's
``InteractionNetLayer.route``; on the JAX side, calls of its Pallas functions
while it traces), and compares in fp32 at atol 5e-5 / rtol 1e-4, with the
weights carried by ``from_flax_params``.  The JAX package reads
``GCLT_EDGE_STEP`` also when it builds a graph (its step schedule), so its
graphs are built under that switch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphcast_lite_torch.utils.params import from_flax_params
from torch_port_common import (
    ATOL,
    LAT,
    LEVELS,
    LON,
    N_FEAT,
    RTOL,
    bf16_close,
    flax_numpy,
    graph_sets,
    jax_build,
    model_pair,
    to_torch,
)
from torch_port_common import \
    one_torch_thread  # noqa: F401 (an autouse fixture)

ROUTES = {
    "composed": {},
    "edge_step": {"GCLT_EDGE_STEP": "1"},
    "mega": {"GCLT_MEGA_EDGE": "1", "GCLT_PALLAS_SEGMENT": "1"},
}


@pytest.fixture
def jax_kernel_calls(monkeypatch):
    """Counts the JAX package's calls of its two fused Pallas kernels (the
    step imports them when it runs, so the counting wrappers are seen)."""
    from graphcast_lite_tpu.ops import pallas_edge_mlp, pallas_edge_step

    calls = {"edge_step": 0, "mega": 0}

    def counting(key, fn):
        def wrapped(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(pallas_edge_step, "edge_step_fused",
                        counting("edge_step", pallas_edge_step.edge_step_fused))
    monkeypatch.setattr(pallas_edge_mlp, "edge_mlp_segment",
                        counting("mega", pallas_edge_mlp.edge_mlp_segment))
    return calls


def _set_route(monkeypatch, route):
    for name in ("GCLT_EDGE_STEP", "GCLT_MEGA_EDGE", "GCLT_PALLAS_SEGMENT"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("GCLT_LAZY_EDGE", "1")
    monkeypatch.setenv("GCLT_REG_EDGE", "0")
    for name, value in ROUTES[route].items():
        monkeypatch.setenv(name, value)


def _check_routes(route, calls, port_steps):
    assert {s.route for s in port_steps} == {route}
    for key, n in calls.items():
        assert (n > 0) == (key == route), (route, calls)


@pytest.mark.parametrize("route", list(ROUTES))
def test_processor_routes(route, monkeypatch, jax_kernel_calls):
    """A random receiver-sorted graph of 700 nodes and 20,000 edges (96
    padding rows), d = 128, 2 steps, raw edge features passed in."""
    from graphcast_lite_tpu.graphs.structure import build_graph as jbuild
    from graphcast_lite_tpu.models.gnn import InteractionNetProcessor as JP
    from graphcast_lite_torch.graphs.structure import build_graph as tbuild
    from graphcast_lite_torch.models.gnn import InteractionNetProcessor

    _set_route(monkeypatch, route)
    rng = np.random.RandomState(7)
    n, e, d = 700, 20000, 128
    s, r = rng.randint(0, n, e), rng.randint(0, n, e)
    jg = jbuild(s, r, num_nodes=n, build_ell=False, pad_multiple=128)
    tg = tbuild(s, r, num_nodes=n)
    assert tg.full_receiver_band and tg.reg_blocks is None
    kw = dict(node_dim=d, raw_edge_dim=4, edge_latent_dim=d, hidden_dim=d,
              num_steps=2, activation="swish", use_layer_norm=True)
    x = rng.randn(n, d).astype(np.float32)
    raw = rng.randn(tg.padded_num_edges, 4).astype(np.float32)
    jproc = JP(**kw)
    params = jproc.init(jax.random.PRNGKey(5), jnp.asarray(x), jg,
                        jnp.asarray(raw))
    # Non-trivial LayerNorm affines, so the lazy fold is exercised.
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: v + 0.1 * jax.random.normal(
            jax.random.PRNGKey(len(str(path))), v.shape)
        if "norm" in jax.tree_util.keystr(path) else v,
        params,
    )
    for key in jax_kernel_calls:
        jax_kernel_calls[key] = 0
    expect = jproc.apply(params, jnp.asarray(x), jg, jnp.asarray(raw))

    tproc = InteractionNetProcessor(**kw)
    tproc.load_state_dict(from_flax_params(flax_numpy(params)))
    with torch.no_grad():
        out = tproc(to_torch(x), tg, edge_attr_raw=to_torch(raw))
    _check_routes(route, jax_kernel_calls, tproc.steps)
    np.testing.assert_allclose(out.numpy(), np.asarray(expect),
                               atol=ATOL, rtol=RTOL)


def test_edge_step_route_wide_rows(monkeypatch, jax_kernel_calls):
    """d = 384 (a multiple of 128 wider than the Hopper bf16 kernel's
    widths): both packages take the edge-step route and agree in fp32, and
    the port's bf16 processor takes it too."""
    from graphcast_lite_tpu.graphs.structure import build_graph as jbuild
    from graphcast_lite_tpu.models.gnn import InteractionNetProcessor as JP
    from graphcast_lite_torch.graphs.structure import build_graph as tbuild
    from graphcast_lite_torch.models.gnn import InteractionNetProcessor

    _set_route(monkeypatch, "edge_step")
    rng = np.random.RandomState(9)
    n, e, d = 300, 3000, 384
    s, r = rng.randint(0, n, e), rng.randint(0, n, e)
    jg = jbuild(s, r, num_nodes=n, build_ell=False, pad_multiple=128)
    tg = tbuild(s, r, num_nodes=n)
    kw = dict(node_dim=d, raw_edge_dim=4, edge_latent_dim=d, hidden_dim=d,
              num_steps=1, activation="swish", use_layer_norm=True)
    x = rng.randn(n, d).astype(np.float32)
    raw = rng.randn(tg.padded_num_edges, 4).astype(np.float32)
    jproc = JP(**kw)
    params = jproc.init(jax.random.PRNGKey(6), jnp.asarray(x), jg,
                        jnp.asarray(raw))
    for key in jax_kernel_calls:
        jax_kernel_calls[key] = 0
    expect = jproc.apply(params, jnp.asarray(x), jg, jnp.asarray(raw))

    tproc = InteractionNetProcessor(**kw)
    tproc.load_state_dict(from_flax_params(flax_numpy(params)))
    with torch.no_grad():
        out = tproc(to_torch(x), tg, edge_attr_raw=to_torch(raw))
    _check_routes("edge_step", jax_kernel_calls, tproc.steps)
    np.testing.assert_allclose(out.numpy(), np.asarray(expect),
                               atol=ATOL, rtol=RTOL)

    tproc16 = tproc.to(torch.bfloat16)
    with torch.no_grad():
        out16 = tproc16(to_torch(x).bfloat16(), tg.to("cpu", torch.bfloat16),
                        edge_attr_raw=to_torch(raw).bfloat16())
    assert {s.route for s in tproc16.steps} == {"edge_step"}
    assert out16.dtype == torch.bfloat16
    assert torch.isfinite(out16.float()).all()


def test_mega_route_needs_its_structure(monkeypatch):
    """Below 16,384 real edges, or without a full receiver band, the mega
    switch leaves the step on the composed route, as in the reference."""
    from graphcast_lite_torch.graphs.structure import build_graph
    from graphcast_lite_torch.models.gnn import _use_mega_edge_path

    _set_route(monkeypatch, "mega")
    rng = np.random.RandomState(8)
    small = build_graph(rng.randint(0, 700, 9000), rng.randint(0, 700, 9000),
                        num_nodes=700)
    banded = build_graph(rng.randint(0, 700, 20000),
                         rng.randint(300, 700, 20000), num_nodes=700)
    full = build_graph(rng.randint(0, 700, 20000),
                       rng.randint(0, 700, 20000), num_nodes=700)
    assert not banded.full_receiver_band
    assert not _use_mega_edge_path(small, 128, 128, "swish")
    assert not _use_mega_edge_path(banded, 128, 128, "swish")
    assert _use_mega_edge_path(full, 128, 128, "swish")
    assert not _use_mega_edge_path(full, 128, 96, "swish")
    monkeypatch.setenv("GCLT_MEGA_EDGE", "0")
    assert not _use_mega_edge_path(full, 128, 128, "swish")


def _jax_edge_step_graphs(monkeypatch):
    """The JAX graph set built with its edge-step schedule."""
    from graphcast_lite_tpu.models.weather import ModelGraphs

    monkeypatch.setenv("GCLT_EDGE_STEP", "1")
    gs = jax_build(LAT, LON, LEVELS, 0.6)
    assert gs.processing.step_sched is not None
    return gs, ModelGraphs.from_graph_set(gs)


def _rollouts(jmodel, params, jgraphs, tmodel, tgraphs, dtype=None):
    """AR-4 rollouts of both packages on the same window and forcing; with
    ``dtype=torch.bfloat16`` also the JAX bf16 rollout (bench.py's cast)
    and the port's bf16 serve (``serving_copy``)."""
    from graphcast_lite_tpu.training.rollout import RolloutSpec as JSpec
    from graphcast_lite_tpu.training.rollout import rollout_predict as jroll
    from graphcast_lite_torch.inference.predict import serving_copy
    from graphcast_lite_torch.training.rollout import (
        RolloutSpec,
        rollout_predict,
    )

    g = tgraphs.num_grid_nodes
    rng = np.random.RandomState(4)
    window = rng.randn(g, 2, N_FEAT).astype(np.float32)
    forcing = rng.randn(g, 4, N_FEAT).astype(np.float32)
    kw = dict(obs_window=2, num_features=N_FEAT, use_residual=True,
              remat=False, static_channels=(1,), forcing_channels=(3,))

    def jax_rollout(p, gr, jdt):
        def fn(inp, m, t, pr):
            return jmodel.apply(p, inp, gr)[0], None

        out = jroll(fn, jnp.asarray(window, jdt), 4, JSpec(**kw),
                    forcing=jnp.asarray(forcing, jdt))
        return np.asarray(out.astype(jnp.float32))

    tdt = dtype or torch.float32
    model, graphs = serving_copy(tmodel, tgraphs, torch.device("cpu"), tdt)

    def tfn(inp, m, t, p):
        return model(inp, graphs)[0], None

    with torch.no_grad():
        out = rollout_predict(tfn, to_torch(window).to(tdt), 4,
                              RolloutSpec(**kw),
                              forcing=to_torch(forcing).to(tdt))
    assert out.dtype == tdt and out.shape == (g, 4, N_FEAT)
    steps = model.processor.graph_layer.inet.steps
    expect32 = jax_rollout(params, jgraphs, jnp.float32)
    if dtype is None:
        return out.numpy(), expect32, steps
    cast = jax.tree.map(
        lambda a: a.astype(jnp.bfloat16)
        if hasattr(a, "dtype") and a.dtype == jnp.float32 else a,
        (params, jgraphs))
    expect16 = jax_rollout(*cast, jnp.bfloat16)
    return out.float().numpy(), (expect16, expect32), steps


@pytest.mark.parametrize("route", ["composed", "edge_step"])
def test_rollout_predict_ar4(route, monkeypatch, jax_kernel_calls):
    """AR-4 rollout of the small flagship architecture (64x32, mesh [1, 2],
    hidden 128, 2 steps) on a COO route.  The mega route needs 16,384
    edges, more than this mesh has: chip_smoke.py runs it at 64x32."""
    _set_route(monkeypatch, route)
    jgs = _jax_edge_step_graphs(monkeypatch)[0] if route == "edge_step" \
        else None
    jmodel, params, jgraphs, tmodel, tgraphs = model_pair(
        hidden=128, jax_graph_set=jgs)
    out, expect, steps = _rollouts(jmodel, params, jgraphs, tmodel, tgraphs)
    _check_routes(route, jax_kernel_calls, steps)
    np.testing.assert_allclose(out, expect, atol=ATOL, rtol=RTOL)


def test_rollout_predict_ar4_bf16_edge_step(monkeypatch, jax_kernel_calls):
    """The AR-4 bf16 serve on the edge-step route, each AR step held to the
    JAX package's own bf16 error (``bf16_close``)."""
    _set_route(monkeypatch, "edge_step")
    jgs, _ = _jax_edge_step_graphs(monkeypatch)
    jmodel, params, jgraphs, tmodel, tgraphs = model_pair(
        hidden=128, jax_graph_set=jgs)
    out, (expect16, expect32), steps = _rollouts(
        jmodel, params, jgraphs, tmodel, tgraphs, torch.bfloat16)
    _check_routes("edge_step", jax_kernel_calls, steps)
    for s in range(4):
        bf16_close(out[:, s], expect16[:, s], expect32[:, s])


def test_default_route_is_reg_block(monkeypatch):
    """With no switch set the port takes the reg-block route."""
    from graphcast_lite_torch.models.gnn import InteractionNetProcessor

    for name in ("GCLT_REG_EDGE", "GCLT_EDGE_STEP", "GCLT_MEGA_EDGE"):
        monkeypatch.delenv(name, raising=False)
    _, tgs = graph_sets()
    proc = InteractionNetProcessor(128, 4, 128, 128, 2)
    with torch.no_grad():
        proc(torch.zeros(tgs.num_mesh_nodes, 128), tgs.processing)
    assert {s.route for s in proc.steps} == {"reg_block"}
