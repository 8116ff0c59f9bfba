"""The fused edge unit (``ops.fused_edge``) against the JAX package on the
CPU.

* ``edge_pipeline``'s forward and the gradients of every input under
  random cotangents on both outputs, padding rows included, against the
  JAX package's ``edge_pipeline`` (its Pallas segment kernel in interpret
  mode) under ``GCLT_FUSED_BWD=pallas``, ``ell`` and ``hybrid`` (the JAX
  package's three backwards; the port takes its CSR route in all three)
  and ``GCLT_FUSED_SAVE_HPRE=0`` / ``1``.  The graph has a real edge from
  node 0 and one into receiver R - 1: there the JAX package's padding
  conventions (its kernel-facing copies repoint padding rows to the last
  real receiver and the smallest real sender) put the padding rows'
  cotangents where the port's do, so all three JAX modes are one function.
* The same unit against torch autograd of the plain math on a graph where
  those conventions differ: the port's backward is the exact adjoint of
  its forward on every row.
* ``GCLT_MEGA_EDGE=1`` at H = De = 128: the forward tail is the edge-MLP
  kernel's plain version here and its Pallas kernel in interpret mode
  there.
* ``edge_gather_mlp_agg`` against the JAX package's.
* The policy (``use_fused_edge``), as ``tests/test_fused_edge.py`` holds
  the JAX package's.
* The plain and the lazy COO processor with ``_use_fused_edge_path``
  forced on in both packages (the route recorded), and a 64x32 AR-2
  ``rollout_loss`` step with the gate forced, against
  ``jax.value_and_grad``.

Tolerances (fp32): forwards atol 5e-5 / rtol 1e-4 at hidden 32 and per
gradient leaf max|g - g_jax| <= 1e-4 max|g_jax| + 1e-6.  At the width of
128 the mega tail needs, the forward is held within 1e-5 of its largest
value and the gradients within 1e-3 max|g| (+ 1e-6): there fp32 rounding
alone moves either package's gradients by about 1e-4 of their largest
value (``tests/torch_port_common.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphcast_lite_tpu.graphs.structure import build_graph as jax_graph
from graphcast_lite_torch.graphs.structure import build_graph as port_graph
from graphcast_lite_torch.ops import edge_mlp as port_edge_mlp
from graphcast_lite_torch.ops import fused_edge
from graphcast_lite_torch.utils.params import from_flax_params
from torch_port_common import (
    ATOL,
    RTOL,
    flax_numpy,
    one_torch_thread,  # noqa: F401 (an autouse fixture)
    to_torch,
)

NAMES = ("x", "e_attr", "mask", "w1s", "w1r", "w1e", "b1", "w2", "b2")
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
WIDE_FWD_RTOL, WIDE_GRAD_RTOL = 1e-5, 1e-3
_SWITCHES = ("GCLT_FUSED_BWD", "GCLT_FUSED_SAVE_HPRE", "GCLT_MEGA_EDGE",
             "GCLT_PALLAS_SEGMENT", "GCLT_FUSED_EDGE", "GCLT_LAZY_EDGE",
             "GCLT_REG_EDGE", "GCLT_EDGE_STEP", "GCLT_GCN_AGG")


@pytest.fixture
def env(monkeypatch):
    for name in _SWITCHES:
        monkeypatch.delenv(name, raising=False)

    def put(**kv):
        for k, v in kv.items():
            monkeypatch.setenv(k, v)
    return put


def _edges(rng, n=300, e=2000, ends=True):
    s, r = rng.randint(0, n, e), rng.randint(0, n, e)
    if ends:
        # A real edge from node 0 and one into receiver n - 1.
        s[0], r[1] = 0, n - 1
    else:
        s, r = s % (n - 3) + 2, r % (n - 3) + 1
    return s, r, n


def _inputs(rng, n, e_pad, d, de, h):
    def w(*shape, scale=0.1):
        return (rng.randn(*shape) * scale).astype(np.float32)
    return dict(x=w(n, d, scale=1.0), e_attr=w(e_pad, de, scale=1.0),
                w1s=w(d, h), w1r=w(d, h), w1e=w(de, h), b1=w(h), w2=w(h, de),
                b2=w(de))


def _args(inputs, mask, conv):
    return [conv(inputs[k]) if k != "mask" else conv(mask) for k in NAMES]


def _jax_run(jg, inputs, p_eu, p_agg):
    from graphcast_lite_tpu.ops.fused_edge import edge_pipeline

    args = _args(inputs, np.asarray(jg.edge_mask), jnp.asarray)

    def loss(*a):
        eu, agg = edge_pipeline(*a, jg, activation="swish")
        return jnp.sum(eu * p_eu) + jnp.sum(agg * p_agg), (eu, agg)

    (_, out), grads = jax.value_and_grad(loss, argnums=tuple(range(9)),
                                         has_aux=True)(*args)
    return ([np.asarray(o) for o in out],
            {k: np.asarray(g) for k, g in zip(NAMES, grads)})


def _port_run(tg, inputs, p_eu, p_agg, fn=None):
    args = _args(inputs, tg.edge_mask.numpy(), to_torch)
    for k, a in zip(NAMES, args):
        a.requires_grad_(k != "mask")
    if fn is None:
        eu, agg = fused_edge.edge_pipeline(*args, tg, "swish")
    else:
        eu, agg = fn(*args)
    loss = (eu * to_torch(p_eu)).sum() + (agg * to_torch(p_agg)).sum()
    loss.backward()
    return ([eu.detach().numpy(), agg.detach().numpy()],
            {k: a.grad.numpy() for k, a in zip(NAMES, args)
             if k != "mask"})


def _grads_close(got, expect, rtol=GRAD_RTOL):
    for name, g in got.items():
        ref = expect[name]
        err = np.abs(g - ref).max()
        tol = rtol * np.abs(ref).max() + GRAD_ATOL
        assert err <= tol, f"{name}: max|err| {err:.3e} > {tol:.3e}"


def _cotangents(rng, e_pad, r, de):
    return (rng.randn(e_pad, de).astype(np.float32),
            rng.randn(r, de).astype(np.float32))


@pytest.mark.parametrize("save_h_pre", ["1", "0"])
@pytest.mark.parametrize("bwd", ["pallas", "ell", "hybrid"])
def test_edge_pipeline_matches_jax(env, bwd, save_h_pre):
    env(GCLT_FUSED_BWD=bwd, GCLT_FUSED_SAVE_HPRE=save_h_pre)
    rng = np.random.RandomState(0)
    s, r, n = _edges(rng)
    jg = jax_graph(s, r, num_nodes=n)
    tg = port_graph(s, r, num_nodes=n)
    if bwd != "pallas":   # the JAX package runs the mode asked for
        assert jg.t_neigh_edge is not None
        assert bwd == "hybrid" or jg.neigh_edge is not None
    d = de = h = 32
    inputs = _inputs(rng, n, tg.padded_num_edges, d, de, h)
    p_eu, p_agg = _cotangents(rng, tg.padded_num_edges, n, de)
    (jeu, jagg), jgrads = _jax_run(jg, inputs, p_eu, p_agg)
    (eu, agg), grads = _port_run(tg, inputs, p_eu, p_agg)
    np.testing.assert_allclose(eu, jeu, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(agg, jagg, atol=ATOL, rtol=RTOL)
    assert set(grads) == set(NAMES) - {"mask"}
    _grads_close(grads, jgrads)


def _plain_math(tg):
    """The unit's function in plain torch ops (autograd differentiates
    it): the oracle of the port's own backward."""
    def fn(x, e_attr, mask, w1s, w1r, w1e, b1, w2, b2):
        h = ((x @ w1s)[tg.senders.long()] + (x @ w1r)[tg.receivers.long()]
             + e_attr @ w1e + b1)
        u = torch.nn.functional.silu(h) @ w2 + b2
        agg = torch.zeros(tg.num_receivers, u.shape[1]).index_add(
            0, tg.receivers.long(), u * mask[:, None])
        deg = torch.zeros(tg.num_receivers).index_add(
            0, tg.receivers.long(), mask)
        return u, agg / deg.clamp(min=1.0)[:, None]
    return fn


@pytest.mark.parametrize("save_h_pre", ["1", "0"])
def test_edge_pipeline_backward_is_exact_on_every_row(env, save_h_pre):
    """Padding rows point at sender 0 and receiver R - 1, which here have
    no real edge; their (random) cotangents land there."""
    env(GCLT_FUSED_SAVE_HPRE=save_h_pre)
    rng = np.random.RandomState(1)
    s, r, n = _edges(rng, ends=False)
    tg = port_graph(s, r, num_nodes=n)
    assert tg.padded_num_edges > tg.num_edges
    inputs = _inputs(rng, n, tg.padded_num_edges, 32, 32, 32)
    p_eu, p_agg = _cotangents(rng, tg.padded_num_edges, n, 32)
    (eu, agg), grads = _port_run(tg, inputs, p_eu, p_agg)
    (peu, pagg), pgrads = _port_run(tg, inputs, p_eu, p_agg,
                                    fn=_plain_math(tg))
    np.testing.assert_allclose(eu, peu, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(agg, pagg, atol=ATOL, rtol=RTOL)
    _grads_close(grads, pgrads)


@pytest.fixture
def kernel_calls(monkeypatch):
    """Counts the edge-MLP kernel's calls in both packages (the Pallas
    kernel there, the plain version the port's wrapper runs on the CPU)."""
    from graphcast_lite_tpu.ops import pallas_edge_mlp

    calls = {"jax": 0, "port": 0}

    def counting(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(pallas_edge_mlp, "edge_mlp_segment",
                        counting("jax", pallas_edge_mlp.edge_mlp_segment))
    monkeypatch.setattr(port_edge_mlp, "edge_mlp_reference",
                        counting("port", port_edge_mlp.edge_mlp_reference))
    return calls


def test_mega_tail_matches_jax(env, kernel_calls):
    env(GCLT_MEGA_EDGE="1", GCLT_PALLAS_SEGMENT="1")
    rng = np.random.RandomState(2)
    s, r, n = _edges(rng)
    jg = jax_graph(s, r, num_nodes=n)
    tg = port_graph(s, r, num_nodes=n)
    d, de, h = 32, 128, 128
    inputs = _inputs(rng, n, tg.padded_num_edges, d, de, h)
    p_eu, p_agg = _cotangents(rng, tg.padded_num_edges, n, de)
    (jeu, jagg), jgrads = _jax_run(jg, inputs, p_eu, p_agg)
    (eu, agg), grads = _port_run(tg, inputs, p_eu, p_agg)
    assert kernel_calls["jax"] >= 1 and kernel_calls["port"] == 1
    for got, ref in ((eu, jeu), (agg, jagg)):
        assert np.abs(got - ref).max() <= WIDE_FWD_RTOL * np.abs(ref).max()
    _grads_close(grads, jgrads, rtol=WIDE_GRAD_RTOL)


def test_edge_gather_mlp_agg_matches_jax(env):
    from graphcast_lite_tpu.ops.fused_edge import _StaticPre
    from graphcast_lite_tpu.ops.fused_edge import edge_gather_mlp_agg as jfn

    rng = np.random.RandomState(3)
    s, r, n = _edges(rng)
    jg = jax_graph(s, r, num_nodes=n)
    tg = port_graph(s, r, num_nodes=n)
    h, de, e_pad = 32, 32, tg.padded_num_edges
    names = ("xs", "xr", "ep", "b1", "w2", "b2")
    vals = dict(xs=rng.randn(n, h), xr=rng.randn(n, h),
                ep=rng.randn(e_pad, h), b1=rng.randn(h) * 0.1,
                w2=rng.randn(h, de) * 0.1, b2=rng.randn(de) * 0.1)
    vals = {k: v.astype(np.float32) for k, v in vals.items()}
    p_eu, p_agg = _cotangents(rng, e_pad, n, de)
    aux = jg.senders_aux
    static = _StaticPre(
        num_sender_rows=n, num_receivers=n,
        tile_receivers=jg.seg_tile_receivers, activation="swish",
        interpret=True, r_tile_lo=jg.seg_tile_lo, r_tile_hi=jg.seg_tile_hi,
        s_tile_lo=aux.tile_lo, s_tile_hi=aux.tile_hi)
    mask = jnp.asarray(jg.edge_mask)

    def jloss(*a):
        eu, agg = jfn(static, *a, mask, jg.senders, jg.seg_recv,
                      jg.seg_chunk_base, jg.seg_chunk_tile, aux.perm,
                      aux.idx_sorted, aux.chunk_base, aux.chunk_tile)
        return jnp.sum(eu * p_eu) + jnp.sum(agg * p_agg), (eu, agg)

    (_, (jeu, jagg)), jgrads = jax.value_and_grad(
        jloss, argnums=tuple(range(6)), has_aux=True)(
        *(jnp.asarray(vals[k]) for k in names))
    args = [to_torch(vals[k]).requires_grad_() for k in names]
    eu, agg = fused_edge.edge_gather_mlp_agg(
        *args, tg.edge_mask, tg.senders, tg.receivers, tg.indptr, tg.s_perm,
        tg.s_indptr, "swish")
    ((eu * to_torch(p_eu)).sum() + (agg * to_torch(p_agg)).sum()).backward()
    np.testing.assert_allclose(eu.detach().numpy(), np.asarray(jeu),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(agg.detach().numpy(), np.asarray(jagg),
                               atol=ATOL, rtol=RTOL)
    _grads_close({k: a.grad.numpy() for k, a in zip(names, args)},
                 {k: np.asarray(g) for k, g in zip(names, jgrads)})


def test_training_trace_gates_the_fused_unit(env, monkeypatch):
    """``use_fused_edge()`` is off outside and on inside
    ``training_trace()``, ``GCLT_FUSED_EDGE`` overrides both ways, and
    ``rollout_loss`` sets the flag while the model runs."""
    from graphcast_lite_torch.training.rollout import RolloutSpec, \
        rollout_loss

    assert not fused_edge.use_fused_edge()
    with fused_edge.training_trace():
        assert fused_edge.use_fused_edge()
    assert not fused_edge.use_fused_edge()
    env(GCLT_FUSED_EDGE="1")
    assert fused_edge.use_fused_edge()
    env(GCLT_FUSED_EDGE="0")
    with fused_edge.training_trace():
        assert not fused_edge.use_fused_edge()

    seen = []

    def model_fn(inp, m, t, p):
        seen.append(fused_edge.use_fused_edge())
        return torch.zeros_like(inp[..., :4]), m

    monkeypatch.delenv("GCLT_FUSED_EDGE")
    spec = RolloutSpec(obs_window=1, num_features=4, use_residual=False,
                       remat=False)
    rollout_loss(model_fn, torch.zeros(2, 5, 1, 4), torch.zeros(2, 5, 1, 4),
                 1, spec)
    assert seen == [True]
    assert not fused_edge.use_fused_edge()


def test_fused_gate_conditions(env):
    """``_use_fused_edge_path`` on the reference's conditions: 131,072
    real edges or more, both widths multiples of 128, a stateless
    activation, a unified node space, in training."""
    from graphcast_lite_torch.models.gnn import _use_fused_edge_path

    rng = np.random.RandomState(4)
    n = 2000
    big = port_graph(rng.randint(0, n, 131072), rng.randint(0, n, 131072),
                     num_nodes=n)
    small = port_graph(rng.randint(0, n, 131071), rng.randint(0, n, 131071),
                       num_nodes=n)
    bip = port_graph(rng.randint(0, n, 131072), rng.randint(0, 100, 131072),
                     num_nodes=n, num_receivers=100)
    assert not _use_fused_edge_path(big, 128, 128, "swish")
    with fused_edge.training_trace():
        assert _use_fused_edge_path(big, 128, 256, "swish")
        assert _use_fused_edge_path(big, 256, 128, "relu")
        assert not _use_fused_edge_path(small, 128, 128, "swish")
        assert not _use_fused_edge_path(big, 96, 128, "swish")
        assert not _use_fused_edge_path(big, 128, 64, "swish")
        assert not _use_fused_edge_path(big, 128, 128, "prelu")
        assert not _use_fused_edge_path(bip, 128, 128, "swish")
        env(GCLT_FUSED_EDGE="0")
        assert not _use_fused_edge_path(big, 128, 128, "swish")


D, STEPS = 16, 2


def _force_gate(monkeypatch):
    """Force the gate on in both packages; returns the JAX package's
    ``edge_pipeline`` calls (a list that grows by one a call)."""
    from graphcast_lite_tpu.models import gnn as jgnn
    from graphcast_lite_tpu.ops import fused_edge as jfused
    from graphcast_lite_torch.models import gnn as tgnn

    monkeypatch.setattr(jgnn, "_use_fused_edge_path", lambda *a, **k: True)
    monkeypatch.setattr(tgnn, "_use_fused_edge_path", lambda *a, **k: True)
    calls, unit = [], jfused.edge_pipeline
    monkeypatch.setattr(jfused, "edge_pipeline",
                        lambda *a, **k: calls.append(1) or unit(*a, **k))
    return calls


@pytest.mark.parametrize("lazy,route", [("0", "nonlazy_fused"),
                                        ("1", "fused")])
def test_processor_on_the_fused_route(env, monkeypatch, lazy, route):
    """The 64x32 multimesh [1, 2] processor, 2 steps at width 16, with the
    gate forced in both packages: the plain step (``GCLT_LAZY_EDGE=0``)
    and the lazy COO step (``GCLT_REG_EDGE=0``); output and every
    parameter's gradient under a random cotangent."""
    from graphcast_lite_tpu.models.gnn import InteractionNetProcessor as JP
    from graphcast_lite_torch.models.gnn import InteractionNetProcessor
    from torch_port_common import graph_sets

    env(GCLT_LAZY_EDGE=lazy, GCLT_REG_EDGE="0")
    jax_calls = _force_gate(monkeypatch)
    jgs, tgs = graph_sets()
    jg, tg = jgs.processing, tgs.processing
    rng = np.random.RandomState(5)
    x = rng.randn(tg.num_nodes, D).astype(np.float32)
    cot = rng.randn(tg.num_nodes, D).astype(np.float32)
    kw = dict(node_dim=D, raw_edge_dim=4, edge_latent_dim=D, hidden_dim=D,
              num_steps=STEPS)
    jproc = JP(**kw)
    params = jproc.init(jax.random.PRNGKey(6), jnp.asarray(x), jg)
    params = jax.tree.map(
        lambda v: v + 0.05 * jax.random.normal(jax.random.PRNGKey(7),
                                               v.shape), params)
    expect, jgrads = jax.value_and_grad(
        lambda p: jnp.sum(jproc.apply(p, jnp.asarray(x), jg) * cot))(params)
    tproc = InteractionNetProcessor(**kw)
    tproc.load_state_dict(from_flax_params(flax_numpy(params)))
    loss = (tproc(to_torch(x), tg) * to_torch(cot)).sum()
    loss.backward()
    assert {s.route for s in tproc.steps} == {route} and jax_calls
    np.testing.assert_allclose(loss.item(), float(expect), rtol=1e-5)
    # The last step's edge LayerNorm reaches no output: no gradient.
    _grads_close({n: (p.grad if p.grad is not None
                      else torch.zeros_like(p)).numpy()
                  for n, p in tproc.named_parameters()},
                 {k: v.numpy()
                  for k, v in from_flax_params(flax_numpy(jgrads)).items()})


@pytest.mark.parametrize("lazy,route", [("0", "nonlazy_fused"),
                                        ("1", "fused")])
def test_ar2_train_step_on_the_fused_route(env, monkeypatch, lazy, route):
    """The small flagship architecture's AR-2 ``rollout_loss`` step with
    the gate forced in both packages: the loss and all parameters'
    gradients against ``jax.value_and_grad``."""
    from torch_port_common import LOSS_RTOL, assert_grads_close, batch, \
        jax_step, model_pair, port_step

    env(GCLT_LAZY_EDGE=lazy, GCLT_REG_EDGE="0")
    jax_calls = _force_gate(monkeypatch)
    jmodel, params, jgraphs, tmodel, tgraphs = model_pair()
    x, y, lw, cm = batch(tgraphs.num_grid_nodes)
    jloss, jgrads = jax_step(jmodel, params, jgraphs, x, y, lw, cm, ar=2)
    loss, grads, _, _ = port_step(tmodel, tgraphs, x, y, lw, cm, ar=2)
    steps = tmodel.processor.graph_layer.inet.steps
    assert {s.route for s in steps} == {route} and jax_calls
    assert abs(loss - jloss) <= LOSS_RTOL * abs(jloss), (loss, jloss)
    assert_grads_close(grads, jgrads)
