"""The port's plain (non-lazy) InteractionNet step and the processor under
a runtime edge mask, against the JAX package on the CPU.

Both packages take the plain step with ``GCLT_LAZY_EDGE=0``, and wherever
the lazy fold does not apply (PReLU, or no edge LayerNorm).  Its edge
LayerNorm is ``PyGLayerNorm(mode="graph", mask=)``, variance E[(v − μ)²]
over the live edges (ROADMAP trap 2).  Cases:

* swish with LN, PReLU with LN, swish without LN, each with no mask and
  under a runtime mask, against the JAX package's ELL branch (the
  multimesh as built) and its COO branch (the same graph without its
  neighbour table);
* the mega route (``GCLT_MEGA_EDGE=1``: the reference's ``_MegaEdgeMLP``,
  the edge-MLP kernel's plain version here, its Pallas kernel in interpret
  mode there) on a 20,000-edge graph at d = 128;
* one flax tree loaded into the port's processor, run lazily and plainly,
  each against the JAX package's same processor;
* the lazy processor under a runtime mask: no reg-blocks, the COO step
  takes the mask.

fp32 tolerance atol 5e-5 / rtol 1e-4 (``torch_port_common``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphcast_lite_torch.utils.params import from_flax_params
from torch_port_common import ATOL, RTOL, flax_numpy, graph_sets, \
    one_torch_thread, to_torch  # noqa: F401 (an autouse fixture)

D, STEPS = 16, 2


@pytest.fixture
def switches(monkeypatch):
    """Clear the route switches; returns a setter for both packages."""
    for name in ("GCLT_LAZY_EDGE", "GCLT_REG_EDGE", "GCLT_EDGE_STEP",
                 "GCLT_MEGA_EDGE", "GCLT_PALLAS_SEGMENT"):
        monkeypatch.delenv(name, raising=False)

    def put(**env):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
    return put


def _graphs(layout):
    jgs, tgs = graph_sets()
    jg = jgs.processing
    if layout == "coo":
        jg = jg.replace(neigh_senders=None, neigh_edge=None, neigh_mask=None)
    return jg, tgs.processing


def _mask(g, seed):
    rng = np.random.RandomState(seed)
    mask = g.edge_mask.numpy() * (rng.rand(g.padded_num_edges) > 0.25)
    mask[g.receivers.numpy() < 3] = 0.0
    return mask.astype(np.float32)


def _params(jproc, x, jg, seed):
    """The JAX processor's init with non-trivial LayerNorm affines."""
    params = jproc.init(jax.random.PRNGKey(seed), jnp.asarray(x), jg)
    return jax.tree_util.tree_map_with_path(
        lambda path, v: v + 0.1 * jax.random.normal(
            jax.random.PRNGKey(len(str(path))), v.shape)
        if "norm" in jax.tree_util.keystr(path) else v,
        params,
    )


def _kw(activation="swish", use_layer_norm=True):
    return dict(node_dim=D, raw_edge_dim=4, edge_latent_dim=D, hidden_dim=D,
                num_steps=STEPS, activation=activation,
                use_layer_norm=use_layer_norm)


def _run_pair(jproc, params, tproc, x, jg, tg, mask):
    expect = jproc.apply(params, jnp.asarray(x), jg,
                         edge_mask=None if mask is None
                         else jnp.asarray(mask))
    with torch.no_grad():
        out = tproc(to_torch(x), tg,
                    edge_mask=None if mask is None else to_torch(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(expect), atol=ATOL,
                               rtol=RTOL)
    return out


@pytest.mark.parametrize("layout", ["ell", "coo"])
@pytest.mark.parametrize("activation,use_ln", [("swish", True),
                                               ("prelu", True),
                                               ("swish", False)])
def test_nonlazy_processor(switches, layout, activation, use_ln):
    from graphcast_lite_tpu.models.gnn import InteractionNetProcessor as JP
    from graphcast_lite_torch.models.gnn import InteractionNetProcessor

    switches(GCLT_LAZY_EDGE="0")
    jg, tg = _graphs(layout)
    x = np.random.RandomState(1).randn(tg.num_nodes, D).astype(np.float32)
    jproc = JP(**_kw(activation, use_ln))
    params = _params(jproc, x, jg, 2)
    tproc = InteractionNetProcessor(**_kw(activation, use_ln))
    tproc.load_state_dict(from_flax_params(flax_numpy(params)))
    if activation == "prelu":
        assert "steps.0.edge_mlp.act.alpha" in tproc.state_dict()
        assert "edge_encoder_act.alpha" in tproc.state_dict()
    for mask in (None, _mask(tg, 3)):
        _run_pair(jproc, params, tproc, x, jg, tg, mask)
        assert {s.route for s in tproc.steps} == {"nonlazy"}


def test_nonlazy_mega_route(switches, monkeypatch):
    """The plain step's mega route: the JAX package runs its edge-MLP
    Pallas kernel (interpret mode), the port the kernel's plain version;
    a random receiver-sorted graph of 700 nodes and 20,000 edges, d = 128,
    2 steps, under a runtime mask."""
    from graphcast_lite_tpu.graphs.structure import build_graph as jbuild
    from graphcast_lite_tpu.models.gnn import InteractionNetProcessor as JP
    from graphcast_lite_tpu.ops import pallas_edge_mlp
    from graphcast_lite_torch.graphs.structure import build_graph as tbuild
    from graphcast_lite_torch.models.gnn import InteractionNetProcessor

    calls = []
    kernel = pallas_edge_mlp.edge_mlp_segment
    monkeypatch.setattr(pallas_edge_mlp, "edge_mlp_segment",
                        lambda *a, **k: calls.append(1) or kernel(*a, **k))
    switches(GCLT_LAZY_EDGE="0", GCLT_MEGA_EDGE="1", GCLT_PALLAS_SEGMENT="1")
    rng = np.random.RandomState(7)
    n, e, d = 700, 20000, 128
    s, r = rng.randint(0, n, e), rng.randint(0, n, e)
    jg = jbuild(s, r, num_nodes=n, build_ell=False, pad_multiple=128)
    tg = tbuild(s, r, num_nodes=n, edge_attr=None)
    raw = rng.randn(tg.padded_num_edges, 4).astype(np.float32)
    kw = dict(_kw(), node_dim=d, edge_latent_dim=d, hidden_dim=d)
    x = rng.randn(n, d).astype(np.float32)
    mask = _mask(tg, 9)
    jproc = JP(**kw)
    params = jproc.init(jax.random.PRNGKey(4), jnp.asarray(x), jg,
                        jnp.asarray(raw))
    expect = jproc.apply(params, jnp.asarray(x), jg, jnp.asarray(raw),
                         jnp.asarray(mask))
    tproc = InteractionNetProcessor(**kw)
    tproc.load_state_dict(from_flax_params(flax_numpy(params)))
    with torch.no_grad():
        out = tproc(to_torch(x), tg, edge_attr_raw=to_torch(raw),
                    edge_mask=to_torch(mask))
    assert calls and {st.route for st in tproc.steps} == {"nonlazy_mega"}
    np.testing.assert_allclose(out.numpy(), np.asarray(expect), atol=ATOL,
                               rtol=RTOL)


def test_one_tree_loads_both_processors(switches, monkeypatch):
    """One flax tree of the JAX package's processor drives the port's
    processor lazily (reg-block route) and plainly, each matching the JAX
    package's processor on the same switch; the two ways differ only by
    the LayerNorm variance formula (trap 2)."""
    from graphcast_lite_tpu.models.gnn import InteractionNetProcessor as JP
    from graphcast_lite_torch.models.gnn import InteractionNetProcessor

    jg, tg = _graphs("ell")
    x = np.random.RandomState(5).randn(tg.num_nodes, D).astype(np.float32)
    jproc = JP(**_kw())
    switches(GCLT_LAZY_EDGE="0")
    params = _params(jproc, x, jg, 6)
    tproc = InteractionNetProcessor(**_kw())
    tproc.load_state_dict(from_flax_params(flax_numpy(params)))
    plain = _run_pair(jproc, params, tproc, x, jg, tg, None)
    assert {s.route for s in tproc.steps} == {"nonlazy"}
    monkeypatch.setenv("GCLT_LAZY_EDGE", "1")
    lazy = _run_pair(jproc, params, tproc, x, jg, tg, None)
    assert {s.route for s in tproc.steps} == {"reg_block"}
    # tests/test_gnn_parity.py accepts 2e-5 between the two formulas.
    np.testing.assert_allclose(lazy.numpy(), plain.numpy(), atol=2e-5)


def test_lazy_processor_under_a_runtime_mask(switches):
    """Under a runtime mask the lazy processor leaves the reg-block layout
    (its mask is static) for the COO composed step, which takes the mask,
    as in the JAX package."""
    from graphcast_lite_tpu.models.gnn import InteractionNetProcessor as JP
    from graphcast_lite_torch.models.gnn import InteractionNetProcessor

    switches(GCLT_LAZY_EDGE="1")
    jg, tg = _graphs("ell")
    x = np.random.RandomState(8).randn(tg.num_nodes, D).astype(np.float32)
    jproc = JP(**_kw())
    params = _params(jproc, x, jg, 9)
    tproc = InteractionNetProcessor(**_kw())
    tproc.load_state_dict(from_flax_params(flax_numpy(params)))
    _run_pair(jproc, params, tproc, x, jg, tg, _mask(tg, 10))
    assert {s.route for s in tproc.steps} == {"composed"}
    _run_pair(jproc, params, tproc, x, jg, tg, None)
    assert {s.route for s in tproc.steps} == {"reg_block"}
