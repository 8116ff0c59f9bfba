"""The port's remaining layer families against the JAX package on the CPU:
``GCNConv`` under a runtime edge mask, ``GATConv`` and ``SparseGATConv``
at 1 and 4 heads, ``SimpleConv``, ``segment_softmax_coo`` and
``masked_in_degree``, with the same numpy-seeded inputs and the JAX
parameters bridged by ``from_flax_params``.

The port has one route for these layers, the receiver-sorted COO layout
through the segment-sum kernel's plain version.  The JAX package takes its
ELL branch (``ops/ell.py``) wherever the graph carries a neighbour table,
as the multimesh does, and its COO branch otherwise: each layer is held
against both, the multimesh as built (``ell``) and the same graph without
its table (``coo``).

fp32 tolerance atol 5e-5 / rtol 1e-4 (``torch_port_common``); gradients
per leaf within 1e-4 of the leaf's largest JAX gradient + 1e-6 (hidden
16, ROADMAP trap 5).  SparseGAT's pruned masks are equal on every edge
whose α lies more than 1e-5 from the threshold.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphcast_lite_torch.utils.params import from_flax_params
from torch_port_common import ATOL, GRAD_ATOL, GRAD_RTOL, RTOL, \
    flax_numpy, graph_sets, one_torch_thread, \
    to_torch  # noqa: F401 (one_torch_thread: an autouse fixture)

IN, HID = 12, 16
# SparseGAT: masks compared on edges whose α is farther than this from the
# threshold (fp32 rounding of α is about 1e-7 here).
ALPHA_MARGIN = 1e-5


def _jax_graph(layout):
    jgs, _ = graph_sets()
    g = jgs.processing
    if layout == "coo":
        g = g.replace(neigh_senders=None, neigh_edge=None, neigh_mask=None)
    assert g.has_ell == (layout == "ell")
    return g


def _inputs(seed=0):
    """(x [N, IN], runtime mask [E_pad]) on the multimesh: 30% of the edges
    pruned, and every edge of receivers 0-4 too (receivers with no live
    edge)."""
    _, tgs = graph_sets()
    g = tgs.processing
    rng = np.random.RandomState(seed)
    x = rng.randn(g.num_nodes, IN).astype(np.float32)
    mask = g.edge_mask.numpy() * (rng.rand(g.padded_num_edges) > 0.3)
    mask[g.receivers.numpy() < 5] = 0.0
    return x, mask.astype(np.float32)


def _perturb(params, seed):
    """Non-zero biases (they init to zero)."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, v: (rng.randn(*v.shape).astype(np.float32)
                      if "bias" in jax.tree_util.keystr(p) else v),
        flax_numpy(params))


def _close(port, ref):
    np.testing.assert_allclose(np.asarray(port.detach()), np.asarray(ref),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("layout", ["ell", "coo"])
def test_gcnconv_under_a_runtime_mask(layout):
    from graphcast_lite_tpu.models.gnn import GCNConv as JaxGCN
    from graphcast_lite_torch.models.gnn import GCNConv

    jg = _jax_graph(layout)
    _, tgs = graph_sets()
    x, mask = _inputs()
    conv = JaxGCN(HID)
    params = _perturb(conv.init(jax.random.PRNGKey(0), jnp.asarray(x), jg),
                      1)
    tconv = GCNConv(IN, HID)
    tconv.load_state_dict(from_flax_params(params))
    for m in (mask, None):
        expect = conv.apply(params, jnp.asarray(x), jg,
                            None if m is None else jnp.asarray(m))
        with torch.no_grad():
            out = tconv(to_torch(x), tgs.processing,
                        None if m is None else to_torch(m))
        _close(out, expect)


@pytest.mark.parametrize("layout", ["ell", "coo"])
@pytest.mark.parametrize("heads", [1, 4])
def test_gatconv(layout, heads):
    from graphcast_lite_tpu.models.gnn import GATConv as JaxGAT
    from graphcast_lite_torch.models.gnn import GATConv

    jg = _jax_graph(layout)
    _, tgs = graph_sets()
    x, mask = _inputs(heads)
    conv = JaxGAT(HID, heads=heads)
    params = _perturb(conv.init(jax.random.PRNGKey(heads), jnp.asarray(x),
                                jg), 2)
    tconv = GATConv(IN, HID, heads=heads)
    tconv.load_state_dict(from_flax_params(params))
    assert set(tconv.state_dict()) == {"core.kernel", "core.att_src",
                                       "core.att_dst", "core.bias"}
    for m in (None, mask):
        expect = conv.apply(params, jnp.asarray(x), jg,
                            None if m is None else jnp.asarray(m))
        with torch.no_grad():
            out = tconv(to_torch(x), tgs.processing,
                        None if m is None else to_torch(m))
        _close(out, expect)


@pytest.mark.parametrize("heads", [1, 4])
def test_gatconv_gradients(heads):
    """The GAT layer's gradients (parameters and input, under a runtime
    mask) against ``jax.grad``: every segment sum and receiver gather of
    its backward goes through the kernel's plain version."""
    from graphcast_lite_tpu.models.gnn import GATConv as JaxGAT
    from graphcast_lite_torch.models.gnn import GATConv

    jg = _jax_graph("coo")
    _, tgs = graph_sets()
    x, mask = _inputs(7)
    cot = np.random.RandomState(8).randn(
        tgs.processing.num_nodes, HID).astype(np.float32)
    conv = JaxGAT(HID, heads=heads)
    params = _perturb(conv.init(jax.random.PRNGKey(3), jnp.asarray(x), jg),
                      3)

    def loss(p, xx):
        return (conv.apply(p, xx, jg, jnp.asarray(mask)) * cot).sum()

    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    tconv = GATConv(IN, HID, heads=heads)
    tconv.load_state_dict(from_flax_params(params))
    tx = to_torch(x).requires_grad_(True)
    (tconv(tx, tgs.processing, to_torch(mask)) * to_torch(cot)).sum() \
        .backward()
    expect = from_flax_params(flax_numpy(gp))
    expect["x"] = to_torch(np.asarray(gx))
    got = {n: p.grad for n, p in tconv.named_parameters()}
    got["x"] = tx.grad
    assert set(got) == set(expect)
    for name, g in got.items():
        ref = expect[name]
        err = (g - ref).abs().max().item()
        assert err <= GRAD_RTOL * ref.abs().max().item() + GRAD_ATOL, \
            (name, err)


@pytest.mark.parametrize("layout", ["ell", "coo"])
@pytest.mark.parametrize("heads", [1, 4])
def test_sparse_gat_prunes_as_the_jax_package(layout, heads):
    """The output and the pruned mask at a threshold that cuts about half
    the live edges, and the mask passed through without ``prune``."""
    from graphcast_lite_tpu.models.gnn import SparseGATConv as JaxSparse
    from graphcast_lite_tpu.models.gnn import _GATCore
    from graphcast_lite_torch.models.gnn import SparseGATConv

    jg = _jax_graph(layout)
    _, tgs = graph_sets()
    x, mask = _inputs(11)
    conv = JaxSparse(HID, heads=heads)
    params = _perturb(conv.init(jax.random.PRNGKey(5), jnp.asarray(x), jg),
                      5)
    # The JAX package's own α, for the threshold and the margin.
    _, alpha = _GATCore(HID, heads).apply(
        {"params": params["params"]["core"]}, jnp.asarray(x), jg,
        jnp.asarray(mask))
    alpha = np.asarray(alpha)
    thr = float(np.median(alpha[mask > 0]))
    tconv = SparseGATConv(IN, HID, heads=heads)
    tconv.load_state_dict(from_flax_params(params))
    for prune in (True, False):
        out_j, mask_j = conv.apply(params, jnp.asarray(x), jg,
                                   jnp.asarray(mask), thr, prune)
        with torch.no_grad():
            out_t, mask_t = tconv(to_torch(x), tgs.processing,
                                  to_torch(mask), thr, prune)
        _close(out_t, out_j)
        far = np.abs(alpha - thr) > ALPHA_MARGIN
        np.testing.assert_array_equal(mask_t.numpy()[far],
                                      np.asarray(mask_j)[far])
        live = mask_t.sum().item()
        if prune:
            assert 0 < live < mask.sum()
        else:
            assert live == mask.sum()


@pytest.mark.parametrize("layout", ["ell", "coo"])
def test_simple_conv(layout):
    from graphcast_lite_tpu.models.gnn import SimpleConv as JaxSimple
    from graphcast_lite_torch.models.gnn import SimpleConv

    jg = _jax_graph(layout)
    _, tgs = graph_sets()
    x, mask = _inputs(13)
    for m in (None, mask):
        expect = JaxSimple().apply({}, jnp.asarray(x), jg,
                                   None if m is None else jnp.asarray(m))
        out = SimpleConv()(to_torch(x), tgs.processing,
                           None if m is None else to_torch(m))
        _close(out, expect)


@pytest.mark.parametrize("heads", [0, 3])
@pytest.mark.parametrize("self_term", [True, False])
def test_segment_softmax_coo(heads, self_term):
    """[E_pad] (heads 0) and [E_pad, H] logits, with and without the
    per-receiver self term, under a mask that leaves receivers with no
    live edge: the weights, zero on masked edges, finite everywhere, and
    summing to 1 with the self term at every receiver that has one."""
    from graphcast_lite_tpu.ops.segment import segment_softmax_coo as jsm
    from graphcast_lite_torch.ops.segment import segment_softmax_coo

    jg = _jax_graph("coo")
    _, tgs = graph_sets()
    g = tgs.processing
    _, mask = _inputs(17)
    rng = np.random.RandomState(19)
    shape = (g.padded_num_edges,) + ((heads,) if heads else ())
    logits = (4 * rng.randn(*shape)).astype(np.float32)
    extra = None
    if self_term:
        extra = (4 * rng.randn(g.num_receivers, *shape[1:])).astype(
            np.float32)
    w_j, s_j = jsm(jnp.asarray(logits), jg, jnp.asarray(mask),
                   None if extra is None else jnp.asarray(extra))
    w_t, s_t = segment_softmax_coo(to_torch(logits), g, to_torch(mask),
                                   None if extra is None else to_torch(extra))
    assert torch.isfinite(w_t).all()
    _close(w_t, w_j)
    assert (w_t.reshape(g.padded_num_edges, -1)[mask == 0] == 0).all()
    total = torch.zeros((g.num_receivers,) + w_t.shape[1:])
    total.index_add_(0, g.receivers.long(), w_t)
    if self_term:
        _close(s_t, s_j)
        np.testing.assert_allclose(total + s_t, 1.0, atol=1e-5)
    else:
        assert s_t is None and s_j is None
        live = np.bincount(g.receivers.numpy(), weights=mask,
                           minlength=g.num_receivers) > 0
        np.testing.assert_allclose(total[torch.from_numpy(live)], 1.0,
                                   atol=1e-5)
        assert (total[torch.from_numpy(~live)] == 0).all()


def test_masked_in_degree():
    from graphcast_lite_tpu.ops.segment import masked_in_degree as jdeg
    from graphcast_lite_torch.ops.segment import masked_in_degree

    jg = _jax_graph("coo")
    _, tgs = graph_sets()
    g = tgs.processing
    _, mask = _inputs(23)
    deg = masked_in_degree(g, to_torch(mask))
    np.testing.assert_array_equal(deg.numpy(),
                                  np.asarray(jdeg(jg, jnp.asarray(mask))))
    assert (deg[:5] == 0).all()
    # No mask, or the graph's own: the host-side static degree.
    assert masked_in_degree(g) is g.static_in_degree
    assert masked_in_degree(g, g.edge_mask) is g.static_in_degree
