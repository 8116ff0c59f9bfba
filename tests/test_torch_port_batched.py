"""The batched forward on the CPU: B samples in one call of the port's
``WeatherModel`` against ``jax.vmap`` of the JAX package's single-sample
model, the batched train step against the JAX package's vmapped step, and
the amortized serve against the JAX package's ``evaluate_model``.  Inputs
come from numpy seeds, weights through ``from_flax_params``.

* Every family at B = 3: GCN, GAT (4 heads), SparseGAT (pruning at
  0.1356 on sample 0, as the JAX trainer keeps the first sample's mask of
  its vmapped model) and the product graph, the presets of
  ``test_torch_port_configs.py``; InteractionNet on the reg-block, COO
  composed and plain routes (``test_torch_port_model.py``'s model), the
  route each took asserted.  fp32, atol 5e-5 / rtol 1e-4 (the parity
  tolerance of the single-sample tests); the masks equal on every edge
  whose sample-0 α lies more than 1e-5 from the threshold.
* Independence: perturbing sample 1 leaves sample 0's output bitwise
  unchanged (the lazy-LN statistics are per sample).
* The fused serve routes (edge step, mega) and the fused training unit:
  the batched call against the port's own per-sample calls, within 1e-5
  of the largest value (those single-sample routes are held against the
  JAX package by ``test_torch_port_coo.py`` and
  ``test_torch_port_fused_edge.py``).
* The train step at B = 2 (reg-block, AR 2): the loss within 1e-5 relative
  and every gradient within 1e-4 of the leaf's largest JAX gradient
  (+ 1e-6) of ``jax.value_and_grad`` of the JAX package's
  ``rollout_loss`` over its vmapped model; the Adam step of the port
  against ``optax.adam`` on the JAX gradients wherever both gradients lie
  beyond that tolerance (rtol 1e-6, atol 1e-7, as
  ``test_torch_port_train.py`` holds Adam); ``GCLT_BATCH_VMAP=0`` (one call a
  sample) against the batched step, loss within 1e-6 relative and
  gradients within 1e-5 of each leaf's largest.
* ``evaluate_model(rollouts_per_dispatch=3)`` over 5 samples (one full
  chunk and a partial one) against the JAX package's
  ``evaluate_model(rollouts_per_dispatch=3)`` on the same ConvGCN
  experiment: every metric within rtol 1e-6, the JAX package's own
  tolerance for its amortized serve (``tests/test_inference.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphcast_lite_torch.utils.params import from_flax_params
from test_torch_port_configs import ALPHA_MARGIN, CONFIGS, THR
from test_torch_port_configs import _pair as config_pair
from torch_port_common import ATOL, GRAD_ATOL, GRAD_RTOL, LOSS_RTOL, LR, \
    N_FEAT, RTOL, assert_grads_close, batch, flax_numpy, model_pair, \
    one_torch_thread  # noqa: F401 (an autouse fixture)

B = 3


def _jax_batched(jmodel, params, jgraphs, x, thr=0.0, prune=False):
    """(out [B, G, C], sample 0's new mask or None) of ``jax.vmap`` of the
    single-sample JAX model over ``x``, the graphs shared."""
    def single(s):
        return jmodel.apply(params, s, jgraphs, None, thr, prune)

    out, masks = jax.jit(jax.vmap(single))(jnp.asarray(x))
    return np.asarray(out), (None if masks is None else np.asarray(masks[0]))


def _close(port, ref):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_families_batched_against_vmap(name):
    jcfg, jmodel, params, jgraphs, _, pmodel, pgraphs = config_pair(name)
    obs = jcfg.data.obs_window_used
    g = pmodel.num_grid_nodes
    x = np.random.RandomState(11).randn(B, g, obs * N_FEAT) \
        .astype(np.float32)
    prune = name == "sparse_gat"
    expect, jmask = _jax_batched(jmodel, params, jgraphs, x, THR, prune)
    alphas = []
    if prune:
        pmodel.processor.graph_layer.conv_0.core.register_forward_hook(
            lambda mod, args, out: alphas.append(out[1].detach().clone()))
    with torch.no_grad():
        out, pmask = pmodel(torch.from_numpy(x), pgraphs, None, THR, prune)
    assert out.shape == (B, g, N_FEAT)
    _close(out, expect)
    assert (pmask is None) == (jmask is None) == (not prune)
    if prune:
        far = np.abs(alphas[0].numpy() - THR) > ALPHA_MARGIN
        live = float(pgraphs.processing.edge_mask.sum())
        assert pmask.shape == pgraphs.processing.edge_mask.shape
        assert 0 < float(pmask.sum()) < live
        np.testing.assert_array_equal(pmask.numpy()[far], jmask[far])


INET_ROUTES = {
    "reg_block": ({"GCLT_LAZY_EDGE": "1"}, "reg_block"),
    "composed": ({"GCLT_LAZY_EDGE": "1", "GCLT_REG_EDGE": "0"}, "composed"),
    "plain": ({"GCLT_LAZY_EDGE": "0"}, "nonlazy"),
}


def _set_env(monkeypatch, env):
    for name in ("GCLT_LAZY_EDGE", "GCLT_REG_EDGE", "GCLT_EDGE_STEP",
                 "GCLT_MEGA_EDGE", "GCLT_FUSED_EDGE", "GCLT_BATCH_VMAP"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)


@pytest.mark.parametrize("route", list(INET_ROUTES))
def test_interaction_net_batched_against_vmap(route, monkeypatch):
    env, port_route = INET_ROUTES[route]
    _set_env(monkeypatch, env)
    jmodel, params, jgraphs, tmodel, tgraphs = model_pair()
    g = tgraphs.num_grid_nodes
    x = np.random.RandomState(12).randn(B, g, 2 * N_FEAT).astype(np.float32)
    expect, _ = _jax_batched(jmodel, params, jgraphs, x)
    with torch.no_grad():
        out, _ = tmodel(torch.from_numpy(x), tgraphs)
        steps = tmodel.processor.graph_layer.inet.steps
        assert {s.route for s in steps} == {port_route}
        _close(out, expect)
        if route == "reg_block":
            # Sample 1 moved: sample 0 stays, bit for bit.
            x2 = x.copy()
            x2[1] += np.random.RandomState(13).randn(*x2[1].shape) \
                .astype(np.float32)
            out2, _ = tmodel(torch.from_numpy(x2), tgraphs)
            assert torch.equal(out2[0], out[0]) and torch.equal(out2[2],
                                                                out[2])
            assert not torch.equal(out2[1], out[1])


def _largest_err(got, want):
    return (got - want).abs().max().item() / want.abs().max().item()


@pytest.mark.parametrize("route", ["edge_step", "mega"])
def test_fused_serve_routes_batched(route, monkeypatch):
    """The lazy COO step on the fused kernels' serve routes (d = 128,
    16,500 edges): a batch of 3 against three single calls."""
    from graphcast_lite_torch.graphs.structure import build_graph
    from graphcast_lite_torch.models.gnn import InteractionNetProcessor

    _set_env(monkeypatch, {"GCLT_LAZY_EDGE": "1", "GCLT_REG_EDGE": "0",
                           ("GCLT_EDGE_STEP" if route == "edge_step"
                            else "GCLT_MEGA_EDGE"): "1"})
    rng = np.random.RandomState(14)
    n, e, d = 400, 16500, 128
    graph = build_graph(rng.randint(0, n, e), rng.randint(0, n, e),
                        num_nodes=n)
    proc = InteractionNetProcessor(d, 4, d, d, 2, generator=torch.Generator()
                                   .manual_seed(1))
    with torch.no_grad():
        for st in proc.steps:  # non-trivial LayerNorm affines
            st.edge_norm.weight.add_(0.1 * torch.randn(d))
            st.edge_norm.bias.add_(0.1 * torch.randn(d))
        x = torch.from_numpy(rng.randn(B, n, d).astype(np.float32))
        raw = torch.from_numpy(rng.randn(graph.padded_num_edges, 4)
                               .astype(np.float32))
        out = proc(x, graph, edge_attr_raw=raw)
        assert {s.route for s in proc.steps} == {route}
        singles = torch.stack([proc(x[i], graph, edge_attr_raw=raw)
                               for i in range(B)])
    assert _largest_err(out, singles) <= 1e-5


def test_fused_unit_batched_backward():
    """``ops.fused_edge.edge_pipeline`` on a batch (per-sample edge state
    and folded W1e / b1, as the lazy step passes them): outputs and every
    input's gradient against the per-sample calls, the shared weights'
    gradients summed over the samples."""
    from graphcast_lite_torch.graphs.structure import build_graph
    from graphcast_lite_torch.ops.fused_edge import edge_pipeline

    rng = np.random.RandomState(15)
    n, e, d, h = 60, 400, 16, 24
    graph = build_graph(rng.randint(0, n, e), rng.randint(0, n, e),
                        num_nodes=n)
    ep = graph.padded_num_edges

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float64)) \
            .requires_grad_()

    x, v = t(B, n, d), t(B, ep, d)
    w1s, w1r, w2, b2 = t(d, h), t(d, h), t(h, d), t(d)
    w1e, b1 = t(B, d, h), t(B, 1, h)
    mask = graph.edge_mask.double()
    cot = [torch.from_numpy(rng.randn(B, ep, d)),
           torch.from_numpy(rng.randn(B, n, d))]
    leaves = (x, v, w1s, w1r, w1e, b1, w2, b2)

    def run(i=None):
        pick = (lambda a: a) if i is None else (lambda a: a[i])
        u, agg = edge_pipeline(pick(x), pick(v), mask, w1s, w1r, pick(w1e),
                               pick(b1), w2, b2, graph, "swish")
        loss = (u * pick(cot[0])).sum() + (agg * pick(cot[1])).sum()
        return torch.autograd.grad(loss, leaves), (u, agg)

    grads, outs = run()
    per = [run(i) for i in range(B)]
    for k in range(2):
        torch.testing.assert_close(outs[k], torch.stack(
            [p[1][k] for p in per]))
    for k, leaf in enumerate(leaves):
        want = sum(p[0][k] for p in per)  # zero rows for other samples
        torch.testing.assert_close(grads[k], want, msg=str(k))


# ---- the train step ------------------------------------------------------

AR2 = 2


def _jax_batched_step(jmodel, params, jgraphs, x, y, lw, cm, steps=AR2,
                      direct_steps=1):
    """(loss, gradients as a port state dict) of the JAX package's
    ``rollout_loss`` over ``jax.vmap`` of its model (fp32, AR 2; a direct
    model of ``direct_steps`` steps emits them all in one call)."""
    from graphcast_lite_tpu.training.rollout import RolloutSpec, rollout_loss
    from torch_port_common import OBS, SPEC

    spec = RolloutSpec(**SPEC, direct_steps=direct_steps)
    b, g = x.shape[:2]
    window = jnp.asarray(x).reshape(b, g, OBS, N_FEAT)
    targets = jnp.asarray(y).reshape(b, g, -1, N_FEAT)

    def loss_fn(p):
        def fn(inp, m, t, pr):
            return jax.vmap(lambda s: jmodel.apply(p, s, jgraphs)[0])(inp), \
                None

        loss, _ = rollout_loss(fn, window, targets, steps, spec, None, 0.0,
                               False, jnp.asarray(lw), jnp.asarray(cm))
        return loss

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    grads = jax.tree.map(lambda a: np.asarray(a, np.float32), grads)
    return float(loss), from_flax_params(flax_numpy(grads))


def _two_samples(g):
    x0, y0, lw, cm = batch(g, seed=21)
    x1, y1, _, _ = batch(g, seed=22)
    return (np.concatenate([x0, x1]), np.concatenate([y0, y1])[..., :AR2 *
                                                                N_FEAT],
            lw, cm)


def test_train_step_b2_against_jax_vmap(monkeypatch):
    import optax

    from torch_port_common import port_step

    _set_env(monkeypatch, {"GCLT_LAZY_EDGE": "1"})
    jmodel, params, jgraphs, tmodel, tgraphs = model_pair()
    x, y, lw, cm = _two_samples(tgraphs.num_grid_nodes)
    jloss, jgrads = _jax_batched_step(jmodel, params, jgraphs, x, y, lw, cm)
    loss, grads, before, after = port_step(tmodel, tgraphs, x, y, lw, cm,
                                           ar=AR2)
    assert {s.route for s in tmodel.processor.graph_layer.inet.steps} \
        == {"reg_block"}
    assert abs(loss - jloss) <= LOSS_RTOL * abs(jloss), (loss, jloss)
    assert_grads_close(grads, jgrads)
    # Adam's first step moves each entry by lr · g / (|g| + 1e-8): compare
    # it where both gradients lie beyond the gradient tolerance (one sign,
    # far from Adam's epsilon), at test_torch_port_train.py's tolerance.
    opt = optax.adam(LR)
    p0 = {n: jnp.asarray(p.numpy()) for n, p in before.items()}
    jg = {n: jnp.asarray(g.numpy()) for n, g in jgrads.items()}
    updates, _ = opt.update(jg, opt.init(p0), p0)
    expect = optax.apply_updates(p0, updates)
    for name, p in after.items():
        jgr, gr = jgrads[name].numpy(), grads[name].numpy()
        tol = GRAD_RTOL * np.abs(jgr).max() + GRAD_ATOL
        clear = (np.abs(jgr) > tol) & (np.abs(gr) > tol)
        np.testing.assert_allclose(p.numpy()[clear],
                                   np.asarray(expect[name])[clear],
                                   rtol=1e-6, atol=1e-7, err_msg=name)


def test_batch_vmap_off_equals_batched(monkeypatch):
    """``GCLT_BATCH_VMAP=0``: the samples one model call each, as the JAX
    package's ``lax.map``; the same step as the batched one."""
    from torch_port_common import port_step

    _set_env(monkeypatch, {"GCLT_LAZY_EDGE": "1"})
    runs = []
    for flag in ("1", "0"):
        monkeypatch.setenv("GCLT_BATCH_VMAP", flag)
        _, _, _, tmodel, tgraphs = model_pair()
        x, y, lw, cm = _two_samples(tgraphs.num_grid_nodes)
        calls = []
        tmodel.register_forward_hook(
            lambda mod, args, out: calls.append(tuple(args[0].shape)))
        loss, grads, _, _ = port_step(tmodel, tgraphs, x, y, lw, cm, ar=AR2)
        runs.append((loss, grads, calls))
    (loss, grads, calls), (loss0, grads0, calls0) = runs
    g = x.shape[1]
    # One call a step batched, one a sample a step looped (and again in
    # the checkpoint's recompute, which may stop early).
    assert set(calls) == {(2, g, 2 * N_FEAT)} and len(calls) >= AR2
    assert set(calls0) == {(g, 2 * N_FEAT)} and len(calls0) >= 2 * AR2
    assert abs(loss0 - loss) <= 1e-6 * abs(loss)
    for name, gr in grads.items():
        tol = 1e-5 * gr.abs().max().item() + GRAD_ATOL
        assert (grads0[name] - gr).abs().max().item() <= tol, name


DIRECT = 3   # the direct model's steps, all emitted by one call


def test_direct_model_b2_step_against_jax_vmap(monkeypatch):
    """A direct multi-step model (``direct_steps = 3``: the decoder emits
    the three steps' channels at once) trained at B = 2: one model call
    for the batch, its loss and gradients against the JAX package's
    vmapped step."""
    from graphcast_lite_torch.training.rollout import RolloutSpec
    from graphcast_lite_torch.training.trainer import make_train_step
    from torch_port_common import SPEC, small_configs

    _set_env(monkeypatch, {"GCLT_LAZY_EDGE": "1"})
    jmodel, params, jgraphs, tmodel, tgraphs = model_pair(
        direct_steps=DIRECT)
    x, _, lw, cm = _two_samples(tgraphs.num_grid_nodes)
    g = x.shape[1]
    y = np.random.RandomState(23).randn(2, g, DIRECT * N_FEAT) \
        .astype(np.float32)
    jloss, jgrads = _jax_batched_step(jmodel, params, jgraphs, x, y, lw, cm,
                                      steps=DIRECT, direct_steps=DIRECT)
    _, cfg = small_configs()
    cfg.learning_rate = LR
    calls = []
    tmodel.register_forward_hook(
        lambda mod, args, out: calls.append(tuple(args[0].shape)))
    step = make_train_step(tmodel, tgraphs,
                           RolloutSpec(**SPEC, direct_steps=DIRECT), cfg,
                           steps=DIRECT, device="cpu", lat_weights=lw,
                           chan_mask=cm)
    loss = float(step(x, y))
    # The batch in one call (and again in the checkpoint's recompute).
    assert set(calls) == {(2, g, 2 * N_FEAT)} and 1 <= len(calls) <= 2
    assert abs(loss - jloss) <= LOSS_RTOL * abs(jloss), (loss, jloss)
    assert_grads_close({n: p.grad for n, p in tmodel.named_parameters()},
                       jgrads)


# ---- the amortized serve -----------------------------------------------

def test_amortized_serve_against_jax(tmp_path):
    """K = 3 over 5 samples in both packages, the same ConvGCN model (the
    JAX init bridged) and data."""
    from graphcast_lite_tpu.inference.predict import \
        evaluate_model as jax_evaluate
    from graphcast_lite_torch.inference.predict import evaluate_model
    from test_torch_port_cli import assert_reports_close
    from torch_port_common import fit_experiment

    (jcfg, jmodel, jgraphs, (jval, _, jmeta), pcfg, pmodel, pgraphs,
     (pval, _, pmeta)) = fit_experiment(tmp_path)
    assert len(pval) == len(jval) >= 5
    g = jval.n_nodes
    params = jax.jit(jmodel.init)(
        jax.random.PRNGKey(0),
        np.zeros((g, jval.obs_window * jval.n_feat), np.float32), jgraphs)
    pmodel.load_state_dict(from_flax_params(flax_numpy(params)))
    kw = dict(ar_steps=2, use_residual=jcfg.use_residual,
              static_channels=tuple(jcfg.static_channels),
              forcing_channels=tuple(jcfg.forcing_channels), max_samples=5,
              rollouts_per_dispatch=3)
    want = jax_evaluate(jmodel, params, jgraphs, jval, jmeta, **kw)
    got = evaluate_model(pmodel, pgraphs, pval, pmeta, device="cpu", **kw)
    assert got.num_samples == want.num_samples == 5
    jj, pj = want.to_json(), got.to_json()
    assert set(pj) == set(jj)
    assert_reports_close({k: pj[k] for k in jj}, jj)
