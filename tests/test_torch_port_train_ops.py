"""The port's differentiable pieces of the train step on the CPU.

* ``segment_sum`` and ``gather_rows`` (plain versions): their adjoints
  against ``torch.autograd.gradcheck`` in float64, with empty rows and
  padding rows.
* ``reg_edge_tail``: its backward against plain ``jax.grad`` through the
  JAX package's ``_fwd_impl`` (not its custom VJP), per input within
  1e-4·max|g| + 1e-6.
* ``training.loss`` against the JAX package's.
* Direct multi-step models (the decoder emits P·C channels in one
  forward): ``rollout_loss`` and its gradients, ``rollout_predict`` and
  ``evaluate_model`` against the JAX package, with more steps asked for
  than the model emits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import (
    GRAD_ATOL,
    GRAD_RTOL,
    LOSS_RTOL,
    N_FEAT,
    assert_grads_close,
    flax_numpy,
    graph_sets,
    model_pair,
    to_torch,
)
from graphcast_lite_torch.utils.params import from_flax_params
from torch_port_common import \
    one_torch_thread  # noqa: F401 (an autouse fixture)


def _csr(ids, rows):
    from graphcast_lite_torch.graphs.structure import indptr_from_receivers

    return indptr_from_receivers(torch.as_tensor(ids, dtype=torch.int32),
                                 rows)


def test_segment_sum_gradcheck():
    """Rows 0, 3 and 6 empty, a 5-edge row, two padding rows in the last
    receiver's run (as ``build_graph`` lays them out), batched too."""
    from graphcast_lite_torch.ops.cuda_segment import segment_sum

    ids = [1, 2, 2, 2, 2, 2, 4, 5, 5, 7, 7, 7]
    indptr = _csr(ids, 8)
    gen = torch.Generator().manual_seed(0)
    msgs = torch.randn(len(ids), 3, generator=gen, dtype=torch.float64,
                       requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda m: segment_sum(m, indptr, 8), (msgs,))
    batched = torch.randn(2, len(ids), 3, generator=gen, dtype=torch.float64,
                          requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda m: segment_sum(m, indptr, 8), (batched,))
    # The adjoint is the gather of the cotangent by receiver id.
    g = torch.randn(8, 3, generator=gen, dtype=torch.float64)
    (d,) = torch.autograd.grad(segment_sum(msgs, indptr, 8), msgs, g)
    assert torch.equal(d, g[torch.as_tensor(ids)])


@pytest.mark.parametrize("sorted_index", [False, True])
def test_gather_rows_gradcheck(sorted_index):
    """Rows gathered many times, rows never gathered (empty CSR rows) and
    padding entries pointing at row 0, through the sender CSR
    (``sender_csr``) or, for a sorted index, the receiver CSR."""
    from graphcast_lite_torch.graphs.structure import sender_csr
    from graphcast_lite_torch.ops.gather import gather_rows

    idx = np.array([5, 2, 2, 7, 5, 5, 1, 2, 0, 0], np.int32)  # 2 padding
    if sorted_index:
        idx = np.sort(idx)
        aux = (None, _csr(idx, 9))
    else:
        aux = sender_csr(idx, 9)
    gen = torch.Generator().manual_seed(1)
    table = torch.randn(9, 4, generator=gen, dtype=torch.float64,
                        requires_grad=True)
    idx_t = torch.from_numpy(idx)
    assert torch.autograd.gradcheck(lambda t: gather_rows(t, idx_t, aux),
                                    (table,))
    plain = table.detach().index_select(0, idx_t.long())
    assert torch.equal(gather_rows(table, idx_t, aux).detach(), plain)


@pytest.mark.parametrize("activation", ["swish", "relu"])
def test_reg_edge_backward_matches_plain_jax_grad(activation):
    """The small multimesh's RegularBlocks (padding rows included), random
    inputs and random cotangents of both outputs."""
    from graphcast_lite_tpu.ops import reg_edge as jre
    from graphcast_lite_torch.ops.reg_edge import RegStatic, reg_edge_tail

    _, tgs = graph_sets()
    rb = tgs.processing.reg_blocks
    m, rows = tgs.processing.num_receivers, rb.rows_padded
    assert float(rb.mask.sum()) < rows   # padding rows present
    d, de, hid = 12, 8, 16
    rng = np.random.RandomState(2)

    def r(*shape, s=1.0):
        return (rng.randn(*shape) * s).astype(np.float32)

    ins = dict(x=r(m, d), v=r(rows, de), w1s=r(d, hid, s=0.3),
               w1r=r(d, hid, s=0.3), w1e_eff=r(de, hid, s=0.3),
               b1_eff=r(hid, s=0.1), w2=r(hid, de, s=0.3), b2=r(de, s=0.1))
    cu, ca = r(rows, de), r(m, de)
    mask, snd = rb.mask.numpy(), rb.senders.numpy()
    names = list(ins)

    jstatic = jre.RegStatic(rb.block_recv, rb.block_k, m, 256, 0, 0,
                            activation, True)

    def jloss(*args):
        kw = dict(zip(names, args))
        u, agg, _ = jre._fwd_impl(jstatic, kw["x"], kw["v"],
                                  jnp.asarray(mask), jnp.asarray(snd),
                                  kw["w1s"], kw["w1r"], kw["w1e_eff"],
                                  kw["b1_eff"], kw["w2"], kw["b2"])
        return (u * cu).sum() + (agg * ca).sum()

    expect = jax.grad(jloss, argnums=tuple(range(len(names))))(
        *(jnp.asarray(ins[n]) for n in names))

    t = {n: torch.from_numpy(a).requires_grad_(True) for n, a in ins.items()}
    static = RegStatic(rb.block_recv, rb.block_k, m, activation)
    u, agg = reg_edge_tail(static, t["x"], t["v"], rb.mask, rb.senders,
                           rb.s_perm, rb.s_indptr, t["w1s"], t["w1r"],
                           t["w1e_eff"], t["b1_eff"], t["w2"], t["b2"])
    ((u * to_torch(cu)).sum() + (agg * to_torch(ca)).sum()).backward()
    for name, ref in zip(names, expect):
        ref = np.asarray(ref)
        err = np.abs(t[name].grad.numpy() - ref).max()
        assert err <= GRAD_RTOL * np.abs(ref).max() + GRAD_ATOL, (name, err)


def test_loss_functions_match_jax():
    from graphcast_lite_tpu.training import loss as jl
    from graphcast_lite_torch.training import loss as tl

    for fn, args in ((tl.lat_weights_from_axis, (32, 64)),
                     (tl.lat_weights_from_nodes,
                      (np.linspace(-80, 80, 50).astype(np.float32),)),
                     (tl.boundary_mask, (10, 12, 2)),
                     (tl.boundary_mask, (10, 12, 0)),
                     (tl.channel_mask, (6, (1,), (4, 9)))):
        np.testing.assert_array_equal(fn(*args),
                                      getattr(jl, fn.__name__)(*args))
    assert tl.channel_mask(6) is None
    np.testing.assert_array_equal(
        tl.combine_spatial_masks(None, np.ones(4), np.arange(4.0)),
        jl.combine_spatial_masks(None, np.ones(4), np.arange(4.0)))

    rng = np.random.RandomState(3)
    p, t = rng.randn(2, 30, 5).astype(np.float32), \
        rng.randn(2, 30, 5).astype(np.float32)
    lw = tl.lat_weights_from_nodes(np.linspace(-80, 80, 30))
    cm = tl.channel_mask(5, (1,), (3,))
    sm = tl.boundary_mask(5, 6, 1)
    got = tl.weighted_mse(to_torch(p), to_torch(t), to_torch(lw),
                          to_torch(cm), to_torch(sm))
    want = jl.weighted_mse(jnp.asarray(p), jnp.asarray(t), jnp.asarray(lw),
                           jnp.asarray(cm), jnp.asarray(sm))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    # No masks in bf16: the weights and the sums stay in bf16, as in JAX.
    got16 = tl.weighted_mse(to_torch(p).bfloat16(), to_torch(t).bfloat16())
    want16 = jl.weighted_mse(jnp.asarray(p, jnp.bfloat16),
                             jnp.asarray(t, jnp.bfloat16))
    assert got16.dtype == torch.bfloat16 and want16.dtype == jnp.bfloat16
    np.testing.assert_allclose(got16.float().item(), float(want16),
                               rtol=2.0 ** -7)
    for exclude in ((), (0, 2)):
        got = tl.anomaly_correlation(to_torch(p), to_torch(t), exclude)
        want = jl.anomaly_correlation(jnp.asarray(p), jnp.asarray(t),
                                      exclude)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5,
                                   atol=1e-7)


P = 3   # direct steps of the direct model


@pytest.fixture(scope="module")
def direct_pair():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GCLT_LAZY_EDGE", "1")
        mp.delenv("GCLT_REG_EDGE", raising=False)
        yield model_pair(direct_steps=P)


def _direct_inputs(g, steps):
    rng = np.random.RandomState(5)
    return (rng.randn(g, 2, N_FEAT).astype(np.float32),
            rng.randn(g, steps, N_FEAT).astype(np.float32))


SPEC = dict(obs_window=2, num_features=N_FEAT, use_residual=True,
            remat=True, static_channels=(1,), forcing_channels=(3,),
            direct_steps=P)


def test_direct_rollout_loss_and_gradients(direct_pair, monkeypatch):
    """Four steps asked of a 3-step direct model: both clip to 3."""
    from graphcast_lite_tpu.training.rollout import RolloutSpec as JSpec
    from graphcast_lite_tpu.training.rollout import rollout_loss as jloss
    from graphcast_lite_torch.training.rollout import RolloutSpec, \
        rollout_loss

    monkeypatch.setenv("GCLT_LAZY_EDGE", "1")
    jmodel, params, jgraphs, tmodel, tgraphs = direct_pair
    window, targets = _direct_inputs(tgraphs.num_grid_nodes, 4)

    def jfn_loss(p):
        def fn(inp, m, t, pr):
            return jmodel.apply(p, inp, jgraphs)[0], None
        return jloss(fn, jnp.asarray(window), jnp.asarray(targets), 4,
                     JSpec(**SPEC))[0]

    want, jgrads = jax.jit(jax.value_and_grad(jfn_loss))(params)
    jgrads = from_flax_params(flax_numpy(jgrads))

    def tfn(inp, m, t, p):
        return tmodel(inp, tgraphs)[0], None

    tmodel.zero_grad(set_to_none=True)
    got, _ = rollout_loss(tfn, to_torch(window), to_torch(targets), 4,
                          RolloutSpec(**SPEC))
    got.backward()
    assert abs(got.item() - float(want)) <= LOSS_RTOL * abs(float(want))
    assert_grads_close({n: p.grad if p.grad is not None
                        else torch.zeros_like(p)
                        for n, p in tmodel.named_parameters()}, jgrads)


def test_direct_rollout_predict(direct_pair, monkeypatch):
    from graphcast_lite_tpu.training.rollout import RolloutSpec as JSpec
    from graphcast_lite_tpu.training.rollout import rollout_predict as jroll
    from graphcast_lite_torch.training.rollout import RolloutSpec, \
        rollout_predict

    monkeypatch.setenv("GCLT_LAZY_EDGE", "1")
    jmodel, params, jgraphs, tmodel, tgraphs = direct_pair
    window, forcing = _direct_inputs(tgraphs.num_grid_nodes, P)

    def jfn(inp, m, t, p):
        return jmodel.apply(params, inp, jgraphs)[0], None

    def tfn(inp, m, t, p):
        return tmodel(inp, tgraphs)[0], None

    for steps in (2, P):
        want = jroll(jfn, jnp.asarray(window), steps, JSpec(**SPEC),
                     forcing=jnp.asarray(forcing))
        with torch.no_grad():
            got = rollout_predict(tfn, to_torch(window), steps,
                                  RolloutSpec(**SPEC),
                                  forcing=to_torch(forcing))
        assert got.shape == (tgraphs.num_grid_nodes, steps, N_FEAT)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=5e-5, rtol=1e-4)
        # Carry-forward on every step: the forcing channel is the input.
        np.testing.assert_array_equal(got[:, :, 3].numpy(),
                                      forcing[:, :steps, 3])
    with pytest.raises(ValueError, match="direct model emits"):
        rollout_predict(tfn, to_torch(window), P + 1, RolloutSpec(**SPEC))


def test_direct_evaluate_model_clips_steps(direct_pair, monkeypatch,
                                           tmp_path):
    """``evaluate_model`` with ar_steps 4 on a 3-step direct model scores
    3 steps, as the JAX package's does, with the same metrics."""
    from graphcast_lite_tpu.data.dataset import load_chunked_datasets as jld
    from graphcast_lite_tpu.inference.predict import evaluate_model as jev
    from graphcast_lite_torch.data.dataset import load_chunked_datasets
    from graphcast_lite_torch.data.synthetic import \
        generate_synthetic_dataset
    from graphcast_lite_torch.inference.predict import evaluate_model

    monkeypatch.setenv("GCLT_LAZY_EDGE", "1")
    jmodel, params, jgraphs, tmodel, tgraphs = direct_pair
    d = generate_synthetic_dataset(str(tmp_path), n_time=20, n_feat=N_FEAT,
                                   seed=2)
    kw = dict(ar_steps=4, static_channels=(1,), forcing_channels=(3,),
              direct_steps=P, max_samples=2)
    _, _, test_ds, meta = load_chunked_datasets(d, 2, 4, N_FEAT)
    got = evaluate_model(tmodel, tgraphs, test_ds, meta, device="cpu", **kw)
    _, _, jtest_ds, jmeta = jld(d, 2, 4, N_FEAT)
    want = jev(jmodel, params, jgraphs, jtest_ds, jmeta, **kw)
    assert got.num_samples == want.num_samples == 2
    assert len(got.per_horizon) == len(want.per_horizon) == P
    np.testing.assert_allclose(got.rmse, want.rmse, rtol=1e-5)
    np.testing.assert_allclose([h["rmse"] for h in got.per_horizon],
                               [h["rmse"] for h in want.per_horizon],
                               rtol=1e-5)
