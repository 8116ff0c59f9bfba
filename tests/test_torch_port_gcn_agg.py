"""The GCN aggregation unit (``ops.gcn_agg``) against the JAX package on the
CPU.

* ``gcn_aggregate`` and its gradient against the JAX package's in both of
  its backward modes (``tests/test_gcn_agg.py`` parametrises them: a
  graph with a transpose-ELL table takes its ``"tell"`` backward, one of
  a few high-out-degree senders its ``"pallas"`` backward); the port
  takes the sender-CSR route in both.
* ``GCNConv`` under ``GCLT_GCN_AGG=1`` inside ``training_trace()`` on a
  16,400-edge graph at width 128: the unit is taken (and is not outside
  training or without the switch), and the output and the parameters'
  gradients match the JAX package's ``GCNConv`` on the same switch.

Tolerances (fp32): atol 5e-5 / rtol 1e-4 for outputs, per gradient leaf
1e-4 max|g| + 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphcast_lite_tpu.graphs.structure import build_graph as jax_graph
from graphcast_lite_torch.graphs.structure import build_graph as port_graph
from graphcast_lite_torch.ops import gcn_agg
from graphcast_lite_torch.ops.fused_edge import training_trace
from torch_port_common import ATOL, RTOL, flax_numpy, \
    one_torch_thread, to_torch  # noqa: F401 (an autouse fixture)

GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6


def _close_grad(got, ref):
    err = np.abs(got - ref).max()
    assert err <= GRAD_RTOL * np.abs(ref).max() + GRAD_ATOL, err


@pytest.mark.parametrize("high_out_degree", [False, True])
def test_gcn_aggregate_matches_jax(high_out_degree):
    from graphcast_lite_tpu.ops.gcn_agg import gcn_aggregate as jfn

    rng = np.random.RandomState(0)
    n, e, f = 40, 300, 128
    s = rng.randint(0, 3 if high_out_degree else n, e)
    r = rng.randint(0, n, e)
    s[0], r[1] = 0, n - 1   # the padding conventions of both coincide
    jg = jax_graph(s, r, num_nodes=n)
    tg = port_graph(s, r, num_nodes=n)
    # The JAX package's "tell" backward needs the transpose-ELL table.
    assert (jg.t_neigh_edge is None) == high_out_degree
    x = rng.randn(n, f).astype(np.float32)
    scale = (rng.rand(tg.padded_num_edges)
             * tg.edge_mask.numpy()).astype(np.float32)
    cot = rng.randn(n, f).astype(np.float32)
    expect, vjp = jax.vjp(lambda a: jfn(a, jnp.asarray(scale), jg),
                          jnp.asarray(x))
    (jgrad,) = vjp(jnp.asarray(cot))
    xt = to_torch(x).requires_grad_()
    out = gcn_agg.gcn_aggregate(xt, to_torch(scale), tg)
    (out * to_torch(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(expect),
                               atol=ATOL, rtol=RTOL)
    _close_grad(xt.grad.numpy(), np.asarray(jgrad))


def test_gcn_conv_under_the_switch(monkeypatch):
    from graphcast_lite_tpu.models.gnn import GCNConv as JGCN
    from graphcast_lite_tpu.ops.fused_edge import training_trace as jtrace
    from graphcast_lite_torch.models.gnn import GCNConv
    from graphcast_lite_torch.utils.params import from_flax_params

    monkeypatch.delenv("GCLT_GCN_AGG", raising=False)
    rng = np.random.RandomState(1)
    n, e, f = 64, 16400, 128
    s, r = rng.randint(0, n, e), rng.randint(0, n, e)
    jg = jax_graph(s, r, num_nodes=n)
    tg = port_graph(s, r, num_nodes=n)
    x = rng.randn(n, f).astype(np.float32)
    cot = rng.randn(n, f).astype(np.float32)
    jconv = JGCN(f)
    params = jconv.init(jax.random.PRNGKey(0), jnp.asarray(x), jg)
    params = jax.tree.map(lambda v: v + 0.1, params)   # a non-zero bias
    conv = GCNConv(f, f)
    conv.load_state_dict(from_flax_params(flax_numpy(params)))

    calls = []
    unit = gcn_agg.gcn_aggregate
    from graphcast_lite_torch.models import gnn
    monkeypatch.setattr(gnn, "gcn_aggregate",
                        lambda *a, **k: calls.append(1) or unit(*a, **k))
    assert not gcn_agg.supports_gcn_aggregate(tg, f)
    with training_trace():
        assert not gcn_agg.supports_gcn_aggregate(tg, f)
    monkeypatch.setenv("GCLT_GCN_AGG", "1")
    monkeypatch.setenv("GCLT_PALLAS_SEGMENT", "1")
    assert not gcn_agg.supports_gcn_aggregate(tg, f)
    with training_trace():
        assert not gcn_agg.supports_gcn_aggregate(tg, 96)
        assert gcn_agg.supports_gcn_aggregate(tg, f)
        small = port_graph(s[:16383], r[:16383], num_nodes=n)
        assert not gcn_agg.supports_gcn_aggregate(small, f)

    def jloss(p):
        return jnp.sum(jconv.apply(p, jnp.asarray(x), jg) * cot)

    with jtrace():
        expect, jgrads = jax.value_and_grad(jloss)(params)
    with training_trace():
        loss = (conv(to_torch(x), tg) * to_torch(cot)).sum()
        loss.backward()
    assert calls == [1]
    np.testing.assert_allclose(loss.item(), float(expect), rtol=1e-5)
    expect_grads = from_flax_params(flax_numpy(jgrads))
    for name, p in conv.named_parameters():
        _close_grad(p.grad.numpy(), expect_grads[name].numpy())
