"""The reg-block lazy-LN edge step outside autograd
(``graphcast_lite_torch.ops.reg_edge.reg_edge_step``, the CUDA kernel
``csrc/reg_edge.cu`` on the card) on the CPU.

* Its plain version, ``reg_edge_step_reference``, against the JAX
  package's ``ops/reg_edge._fwd_impl`` followed by the reg-block residual
  and statistics (``E[v'^2] - mu^2``), in fp32 at the port's tolerance, on
  the small multimesh's RegularBlocks (two levels, pentagon slots, padding
  rows); also on a batch of 3 with the first step's shared v, a, c and
  folded weights and with per-sample ones.
* The kernel's work items (``work_items``, the Python mirror of its
  schedule): every (block, slot, receiver) row exactly once, every
  receiver given every block that holds it, the heaviest tiles first.
* The guards: training (a bf16 ``TrainStep`` and a forward with grad
  enabled) goes through ``_RegEdgeTail`` and never asks for the kernel,
  even where the tensors are made to look as if they were on the card,
  while a no-grad bf16 forward there does; and a bf16 serve on the CPU
  takes the plain code, bitwise as before.

The kernel itself is held against the plain version on the card by
``chip_smoke.py`` (phase 1d) and its launches counted there (1e).
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphcast_lite_tpu.ops import reg_edge as jre
from graphcast_lite_torch.ops import reg_edge
from torch_port_common import ATOL, N_FEAT, RTOL, batch, graph_sets, \
    model_pair, port_step
from torch_port_common import \
    one_torch_thread  # noqa: F401 (an autouse fixture)

D, HID, DE = 12, 16, 8


def _layout():
    _, tgs = graph_sets()
    g = tgs.processing
    rb = g.reg_blocks
    assert len(rb.block_recv) == 2 and float(rb.mask.sum()) < rb.rows_padded
    return g, rb


def _inputs(rng, m, rows, lead=(), own=()):
    def r(*shape, s=1.0):
        return (rng.randn(*shape) * s).astype(np.float32)

    return dict(x=r(*lead, m, D), w1s=r(D, HID, s=0.3), w1r=r(D, HID, s=0.3),
                v=r(*own, rows, DE), w1e_eff=r(*own, DE, HID, s=0.3),
                b1_eff=r(*own, HID, s=0.1), w2=r(HID, DE, s=0.3),
                b2=r(DE, s=0.1), a=1.0 + r(*own, DE, s=0.1),
                c=r(*own, DE, s=0.1))


def _jax_step(static, rb, ins):
    """(v', agg, stats) of one sample through the JAX package's
    ``_fwd_impl``, the residual and the masked sums."""
    mask, snd = rb.mask.numpy(), rb.senders.numpy()
    u, agg, _ = jre._fwd_impl(
        static, jnp.asarray(ins["x"]), jnp.asarray(ins["v"]),
        jnp.asarray(mask), jnp.asarray(snd), *(jnp.asarray(ins[k]) for k in (
            "w1s", "w1r", "w1e_eff", "b1_eff", "w2", "b2")))
    v_new = ins["a"] * ins["v"] + ins["c"] + np.asarray(u)
    w = mask[:, None]
    stats = np.array([(v_new * w).sum(), (v_new ** 2 * w).sum(), w.sum()],
                     np.float32)
    return v_new, np.asarray(agg), stats


def _port_step(static, rb, ins):
    t = {k: torch.from_numpy(a) for k, a in ins.items()}
    before = reg_edge.launches
    out = reg_edge.reg_edge_step(
        static, t["x"] @ t["w1s"], t["x"] @ t["w1r"], t["v"], rb.mask,
        rb.senders, t["w1e_eff"], t["b1_eff"], t["w2"], t["b2"], t["a"],
        t["c"])
    assert reg_edge.launches == before  # the plain version ran
    return [o.numpy() for o in out]


def _check_sample(got, want, total):
    (v_new, agg, stats), (v_ref, agg_ref, stats_ref) = got, want
    np.testing.assert_allclose(v_new[:total], v_ref[:total], atol=ATOL,
                               rtol=RTOL)
    assert np.all(v_new[total:] == 0)   # rows past the last block
    np.testing.assert_allclose(agg, agg_ref, atol=ATOL, rtol=RTOL)
    mag = np.array([np.abs(v_ref[:total]).sum(),
                    (v_ref[:total] ** 2).sum(), 0.0])
    np.testing.assert_array_less(np.abs(stats - stats_ref),
                                 1e-5 * mag + 1e-6)
    assert stats[2] == stats_ref[2]
    # The reg-block route's statistics: E[v'^2] - mu^2 clamped at 0.
    denom = max(stats[2] * v_new.shape[-1], 1.0)
    mu, mu_ref = stats[0] / denom, stats_ref[0] / denom
    var = max(stats[1] / denom - mu ** 2, 0.0)
    var_ref = max(stats_ref[1] / denom - mu_ref ** 2, 0.0)
    np.testing.assert_allclose([mu, var], [mu_ref, var_ref], atol=ATOL,
                               rtol=RTOL)


def _statics(g, rb, activation):
    return (jre.RegStatic(rb.block_recv, rb.block_k, g.num_receivers, 256,
                          0, 0, activation, True),
            reg_edge.RegStatic(rb.block_recv, rb.block_k, g.num_receivers,
                               activation))


@pytest.mark.parametrize("activation", ["swish", "relu"])
def test_reference_matches_jax_fwd_impl(activation):
    g, rb = _layout()
    jstatic, static = _statics(g, rb, activation)
    ins = _inputs(np.random.RandomState(0), g.num_receivers, rb.rows_padded)
    total = sum(v * k for v, k in zip(rb.block_recv, rb.block_k))
    _check_sample(_port_step(static, rb, ins), _jax_step(jstatic, rb, ins),
                  total)


@pytest.mark.parametrize("shared", [True, False])
def test_reference_batched_matches_jax_per_sample(shared):
    """B = 3: the node tables per sample; v, a, c, W1e and b1 those of the
    first step, one for every sample (``shared``), or per sample."""
    g, rb = _layout()
    jstatic, static = _statics(g, rb, "swish")
    own = () if shared else (3,)
    ins = _inputs(np.random.RandomState(1), g.num_receivers, rb.rows_padded,
                  lead=(3,), own=own)
    got = _port_step(static, rb, ins)
    assert got[0].shape == (3, rb.rows_padded, DE)
    assert got[1].shape == (3, g.num_receivers, DE) and got[2].shape == (3, 3)
    total = sum(v * k for v, k in zip(rb.block_recv, rb.block_k))
    for s in range(3):
        one = {k: (a[s] if k == "x" or (own and k in (
            "v", "w1e_eff", "b1_eff", "a", "c")) else a)
            for k, a in ins.items()}
        _check_sample([o[s] for o in got], _jax_step(jstatic, rb, one),
                      total)


@pytest.mark.parametrize("blocks,batch_size", [
    (None, 1),                        # the small multimesh [1, 2]
    (None, 2),
    (((642, 10242), (6, 6)), 3),      # the 64x32 model's [3, 5]
    (((2562, 40962), (6, 6)), 1),     # the flagship's [4, 6]
    (((42, 100, 642), (6, 5, 7)), 2),  # three levels, a wider one
])
def test_work_items_cover_every_row_once(blocks, batch_size):
    if blocks is None:
        g, rb = _layout()
        recv, ks, m = rb.block_recv, rb.block_k, g.num_receivers
    else:
        recv, ks = blocks
        m = recv[-1]
    static = reg_edge.RegStatic(recv, ks, m, "swish")
    total = sum(v * k for v, k in zip(recv, ks))
    items = reg_edge.work_items(static, batch_size)
    tiles = reg_edge.tiles(static)
    assert tiles == -(-max(recv) // reg_edge.TILE_RECEIVERS)
    assert sorted((s, t) for s, t, _ in items) == [
        (s, t) for s in range(batch_size) for t in range(tiles)]
    # Heavy first: no item carries more sub-tiles than one before it.
    loads = [len(subs) for _, _, subs in items]
    assert loads == sorted(loads, reverse=True)
    # The block and receiver of every row, from the layout's definition.
    row_recv = np.concatenate([np.tile(np.arange(v), k)
                               for v, k in zip(recv, ks)])
    row_block = np.concatenate([np.full(v * k, b)
                                for b, (v, k) in enumerate(zip(recv, ks))])
    for smp in range(batch_size):
        seen = np.zeros(total, np.int64)
        blocks_of = [set() for _ in range(m)]
        for s, tile, subs in items:
            if s != smp:
                continue
            for row0, nvalid, r0 in subs:
                assert r0 == tile * reg_edge.TILE_RECEIVERS
                assert 1 <= nvalid <= reg_edge.TILE_RECEIVERS
                rows = np.arange(row0, row0 + nvalid)
                assert np.array_equal(row_recv[rows], r0 + np.arange(nvalid))
                seen[rows] += 1
                for r, b in zip(row_recv[rows], row_block[rows]):
                    blocks_of[r].add(int(b))
        assert np.all(seen == 1)
        for r in range(m):
            assert blocks_of[r] == {b for b, v in enumerate(recv) if r < v}


def test_engagement_conditions():
    """bf16 on the card, H = De in {128, 256}, a taken activation, no
    gradient."""
    x = torch.zeros(4, 8, dtype=torch.bfloat16)
    v = torch.zeros(4, 8, dtype=torch.bfloat16)
    w = torch.zeros(2, 2, requires_grad=True)
    assert not reg_edge.step_engages(x, v, 256, 256, "swish", ())
    card = pytest.MonkeyPatch()
    card.setattr(reg_edge, "_kernel_device", lambda t: True)
    try:
        assert reg_edge.step_engages(x, v, 128, 128, "silu", ())
        assert not reg_edge.step_engages(x, v, 256, 128, "silu", ())
        assert not reg_edge.step_engages(x.float(), v.float(), 256, 256,
                                         "swish", ())
        assert not reg_edge.step_engages(x, v, 192, 256, "swish", ())
        assert not reg_edge.step_engages(x, v, 256, 256, "gelu", ())
        assert not reg_edge.step_engages(x, v, 256, 256, "relu", (w,))
        with torch.no_grad():
            assert reg_edge.step_engages(x, v, 256, 256, "relu", (w,))
    finally:
        card.undo()


def _small_model(hidden=128):
    """The small flagship-shaped port model (fp32, CPU) at widths the
    kernel takes, its graphs and a bf16 input [G, obs C]."""
    _, _, _, tmodel, tgraphs = model_pair(hidden=hidden)
    inp = torch.from_numpy(np.random.RandomState(3).randn(
        tgraphs.num_grid_nodes, 2 * N_FEAT).astype(np.float32))
    return tmodel, tgraphs, inp.to(torch.bfloat16)


def _steps(model):
    return model.processor.graph_layer.inet.steps


def _bf16(model, graphs):
    return (copy.deepcopy(model).to(torch.bfloat16),
            graphs.to(torch.device("cpu"), torch.bfloat16))


class _Spy:
    """Counts ``_RegEdgeTail.apply`` calls; makes tensors look as if they
    were on the card and the kernel's launch raise."""

    def __init__(self, monkeypatch):
        self.tail = 0
        apply = reg_edge._RegEdgeTail.apply

        def counted(*args):
            self.tail += 1
            return apply(*args)

        def launch(*args, **kw):
            raise AssertionError("the reg-edge kernel was asked for")

        monkeypatch.setattr(reg_edge._RegEdgeTail, "apply", counted)
        monkeypatch.setattr(reg_edge, "_kernel_device", lambda t: True)
        monkeypatch.setattr(reg_edge, "reg_edge_step", launch)


def test_training_never_engages_the_kernel(monkeypatch):
    """A bf16 ``TrainStep`` (``rollout_loss`` under BPTT, a checkpoint an
    AR step) and a bf16 forward with grad enabled take ``_RegEdgeTail``;
    the kernel is never asked for and never launches."""
    tmodel, tgraphs, inp = _small_model()
    launches = reg_edge.launches
    spy = _Spy(monkeypatch)
    x, y, lw, cm = batch(tgraphs.num_grid_nodes)
    loss, _, _, _ = port_step(tmodel, tgraphs, x, y, lw, cm,
                              dtype="bfloat16", hidden=128)
    assert np.isfinite(loss) and spy.tail > 0
    assert all(s.route == "reg_block" for s in _steps(tmodel))
    n = spy.tail
    m16, g16 = _bf16(tmodel, tgraphs)
    m16(inp, g16)[0].float().sum().backward()
    assert spy.tail == n + len(_steps(m16))
    assert reg_edge.launches == launches


def test_no_grad_forward_asks_for_the_kernel(monkeypatch):
    """The control of the guard above: under ``torch.no_grad`` the same
    bf16 forward, with its tensors made to look as if on the card, asks
    for the kernel."""
    tmodel, tgraphs, inp = _small_model()
    _Spy(monkeypatch)
    m16, g16 = _bf16(tmodel, tgraphs)
    with torch.no_grad(), pytest.raises(AssertionError, match="reg-edge"):
        m16(inp, g16)


def _unchanged_reg_block_lazy(self, x, v, a, c, graph, edge_mask=None):
    """``InteractionNetLayer.lazy`` on the reg-block route as the port
    composed it before the kernel, for the bitwise comparison below."""
    from graphcast_lite_torch.ops.reg_edge import RegStatic, reg_edge_tail

    d, de = self.node_dim, self.edge_dim
    k0, b0 = self.edge_mlp.lin_0.kernel, self.edge_mlp.lin_0.bias
    k1, b1 = self.edge_mlp.lin_1.kernel, self.edge_mlp.lin_1.bias
    w1s, w1r, w1e = k0[:d], k0[d:2 * d], k0[2 * d:]
    w1e_eff = a[..., :, None].to(w1e.dtype) * w1e
    b1_eff = b0 + c.to(w1e.dtype) @ w1e
    b1_row = b1_eff[..., None, :]
    a_row, c_row = a.to(v.dtype)[..., None, :], c.to(v.dtype)[..., None, :]
    rb = graph.reg_blocks
    assert edge_mask is None and v.shape[-2] == rb.rows_padded
    static = RegStatic(block_recv=rb.block_recv, block_k=rb.block_k,
                       num_nodes=graph.num_receivers,
                       activation=self.activation)
    u, agg_sum = reg_edge_tail(
        static, x, v, rb.mask.to(x.dtype), rb.senders, rb.s_perm,
        rb.s_indptr, w1s, w1r, w1e_eff, b1_row, k1, b1)
    new_x = self._node_step(x, agg_sum, graph, edge_mask)
    v_new = a_row * v + c_row + u
    w = rb.mask.float()[:, None]
    vf = v_new.float()
    denom = torch.clamp(w.sum() * de, min=1.0)
    mu = (vf * w).sum(dim=(-2, -1)) / denom
    var = torch.clamp((torch.square(vf) * w).sum(dim=(-2, -1)) / denom
                      - torch.square(mu), min=0.0)
    return (new_x, v_new) + self._affine(mu, var)


@pytest.mark.parametrize("samples", [None, 2])
def test_cpu_bf16_serve_is_bitwise_unchanged(samples, monkeypatch):
    """A bf16 AR-2 serve rollout on the CPU (one request, and two through
    the batched model) takes the plain code: bitwise the rollout through
    the composition the port ran before the kernel; no launch."""
    from graphcast_lite_torch.inference.predict import serving_copy
    from graphcast_lite_torch.models.gnn import InteractionNetLayer
    from graphcast_lite_torch.training.rollout import RolloutSpec, \
        rollout_predict

    tmodel, tgraphs, _ = _small_model()
    smodel, sgraphs = serving_copy(tmodel, tgraphs, torch.device("cpu"),
                                   torch.bfloat16)
    spec = RolloutSpec(obs_window=2, num_features=N_FEAT, use_residual=True,
                       remat=False)
    lead = () if samples is None else (samples,)
    window = torch.from_numpy(np.random.RandomState(4).randn(
        *lead, tgraphs.num_grid_nodes, 2, N_FEAT).astype(np.float32)
    ).to(torch.bfloat16)

    def rollout():
        with torch.inference_mode():
            return rollout_predict(
                lambda inp, m, t, p: (smodel(inp, sgraphs)[0], None),
                window, 2, spec)

    launches = reg_edge.launches
    got = rollout()
    assert all(s.route == "reg_block" for s in _steps(smodel))
    monkeypatch.setattr(InteractionNetLayer, "lazy",
                        _unchanged_reg_block_lazy)
    want = rollout()
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    assert reg_edge.launches == launches
