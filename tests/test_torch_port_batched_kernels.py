"""The batched forward's kernels and callers on the CPU.

* The plain versions of the two fused kernels, ``edge_mlp_reference`` and
  ``edge_step_reference`` (the kernels' oracles on the card), take a
  leading batch axis: each sample of a batched call equals a call on that
  sample alone (fp32 and bf16, the edge step with per-sample W1e, b_eff,
  a and c), within 1e-6 of the largest value in fp32 (the batched
  products may round in another order) and one bf16 ulp in bf16.
* The per-sample weight images (``wgmma_b_image``, ``tf32x3_b_image``) of
  a batch are each sample's image, bitwise.
* One launch for a batch: counting the segment-sum wrapper's forward
  (``cuda_segment._segment_sum``, where the kernel launches on the card)
  and the fused wrappers, a batched forward and backward of the model
  makes exactly as many calls as a single-sample one, on the reg-block,
  COO composed and fused routes, GAT's softmax and the mega and edge-step
  serve routes.
"""

import numpy as np
import pytest
import torch

from graphcast_lite_torch.ops import cuda_segment, edge_mlp, edge_step
from torch_port_common import N_FEAT, model_pair, \
    one_torch_thread  # noqa: F401 (an autouse fixture)

B = 3


def _graph(n=300, e=1500, seed=0):
    from graphcast_lite_torch.graphs.structure import build_graph

    rng = np.random.RandomState(seed)
    return build_graph(rng.randint(0, n, e), rng.randint(0, n, e),
                       num_nodes=n)


def _close(batched, singles, dtype):
    want = torch.stack(singles).float()
    got = batched.float()
    if dtype == torch.float32:
        tol = 1e-6 * want.abs().max().item()
        assert (got - want).abs().max().item() <= tol
    else:
        # One bf16 ulp of each value.
        ulp = want.abs().clamp(min=1e-30) * 2.0 ** -7
        assert ((got - want).abs() <= ulp).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_edge_mlp_reference_batched(dtype):
    g = _graph()
    rng = np.random.RandomState(1)
    hid, de = 128, 64
    h = torch.from_numpy(rng.randn(B, g.padded_num_edges, hid)
                         .astype(np.float32)).to(dtype)
    w2 = torch.from_numpy(rng.randn(hid, de).astype(np.float32) / 11) \
        .to(dtype)
    b2 = torch.from_numpy(rng.randn(de).astype(np.float32)).to(dtype)
    mask = g.edge_mask.to(dtype)
    u, agg = edge_mlp.edge_mlp(h, w2, b2, mask, g.indptr, g.num_receivers)
    assert u.shape == (B, g.padded_num_edges, de)
    assert agg.shape == (B, g.num_receivers, de)
    singles = [edge_mlp.edge_mlp(h[i], w2, b2, mask, g.indptr,
                                 g.num_receivers) for i in range(B)]
    _close(u, [s[0] for s in singles], dtype)
    _close(agg, [s[1] for s in singles], dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_edge_step_reference_batched(dtype):
    g = _graph(seed=2)
    rng = np.random.RandomState(3)
    hid, de, e, r = 128, 128, g.padded_num_edges, g.num_receivers

    def t(*shape, scale=1.0, dt=dtype):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)
                                * scale).to(dt)

    per_sample = dict(xsg=t(B, e, hid), v=t(B, e, de), xr=t(B, r, hid),
                      w1e=t(B, de, hid, scale=0.1), b_eff=t(B, hid),
                      a=t(B, de, dt=torch.float32),
                      c=t(B, de, dt=torch.float32))
    shared = dict(w2=t(hid, de, scale=0.1), b2=t(de), mask=g.edge_mask.to(
        dtype), indptr=g.indptr, num_receivers=r)
    v_new, agg, stats = edge_step.edge_step(**per_sample, **shared)
    assert v_new.shape == (B, e, de) and agg.shape == (B, r, de)
    assert stats.shape == (B, 3) and stats.dtype == torch.float32
    singles = [edge_step.edge_step(**{k: x[i] for k, x in per_sample.items()},
                                   **shared) for i in range(B)]
    _close(v_new, [s[0] for s in singles], dtype)
    _close(agg, [s[1] for s in singles], dtype)
    want = torch.stack([s[2] for s in singles])
    torch.testing.assert_close(stats, want, rtol=1e-6, atol=1e-6 * float(
        want.abs().max()))


def test_weight_images_per_sample():
    """A batch of weights gives each sample's image, in the layout the
    kernels index by sample (image i at offset i · image size)."""
    w = torch.randn(B, 128, 256)
    img = edge_mlp.wgmma_b_image(w)
    img32 = edge_mlp.tf32x3_b_image(w)
    for i in range(B):
        assert torch.equal(img[i], edge_mlp.wgmma_b_image(w[i]))
        assert torch.equal(img32[i], edge_mlp.tf32x3_b_image(w[i]))
    assert img.is_contiguous() and img32.is_contiguous()
    assert img32[0].numel() == 2 * w[0].numel()


class _Calls:
    """Counts calls of the segment-sum forward and the fused wrappers'
    plain versions (what the wrappers run on a CPU tensor)."""

    def __init__(self, monkeypatch):
        self.n = {"segment_sum": 0, "edge_mlp": 0, "edge_step": 0}
        for mod, name, key in (
                (cuda_segment, "_segment_sum", "segment_sum"),
                (edge_mlp, "edge_mlp_reference", "edge_mlp"),
                (edge_step, "edge_step_reference", "edge_step")):
            monkeypatch.setattr(mod, name, self._counting(
                key, getattr(mod, name)))

    def _counting(self, key, fn):
        def wrapped(*args, **kwargs):
            self.n[key] += 1
            return fn(*args, **kwargs)
        return wrapped

    def take(self):
        out = dict(self.n)
        self.n = dict.fromkeys(self.n, 0)
        return out


ROUTES = {
    "reg_block": {"GCLT_LAZY_EDGE": "1"},
    "composed": {"GCLT_LAZY_EDGE": "1", "GCLT_REG_EDGE": "0"},
    "fused": {"GCLT_LAZY_EDGE": "1", "GCLT_REG_EDGE": "0"},
    "nonlazy": {"GCLT_LAZY_EDGE": "0"},
}


def _set(monkeypatch, env):
    for name in ("GCLT_LAZY_EDGE", "GCLT_REG_EDGE", "GCLT_FUSED_EDGE",
                 "GCLT_EDGE_STEP", "GCLT_MEGA_EDGE", "GCLT_BATCH_VMAP"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)


@pytest.mark.parametrize("route", list(ROUTES))
def test_one_launch_per_batch_train(route, monkeypatch):
    """The model's forward and backward in training (gather adjoints,
    aggregations, the reg-block sender scatter, the fused unit's
    scatters): as many segment-sum calls at B = 3 as at B = 1."""
    from graphcast_lite_torch.models import gnn
    from graphcast_lite_torch.ops.fused_edge import training_trace

    _set(monkeypatch, ROUTES[route])
    if route == "fused":
        # The fused unit takes graphs of 131,072 edges or more: forced
        # here on the small mesh.
        monkeypatch.setattr(gnn, "_use_fused_edge_path", lambda *a: True)
    _, _, _, tmodel, tgraphs = model_pair()
    calls = _Calls(monkeypatch)
    g = tgraphs.num_grid_nodes
    x = torch.randn(B, g, 2 * N_FEAT)
    counts = []
    for inp in (x[0], x):
        with training_trace():
            out, _ = tmodel(inp, tgraphs)
        out.square().sum().backward()
        counts.append(calls.take())
    assert counts[0] == counts[1] and counts[0]["segment_sum"] > 0, counts
    routes = {s.route for s in tmodel.processor.graph_layer.inet.steps}
    assert routes == {route}


@pytest.mark.parametrize("route", ["edge_step", "mega"])
def test_one_launch_per_batch_serve(route, monkeypatch):
    """The fused serve routes at d = 128 on a graph of 16,500 edges: one
    fused-kernel call a step and as many segment sums at B = 2 as at
    B = 1."""
    from graphcast_lite_torch.graphs.structure import build_graph
    from graphcast_lite_torch.models.gnn import InteractionNetProcessor

    _set(monkeypatch, {"GCLT_LAZY_EDGE": "1", "GCLT_REG_EDGE": "0",
                       ("GCLT_EDGE_STEP" if route == "edge_step"
                        else "GCLT_MEGA_EDGE"): "1"})
    rng = np.random.RandomState(7)
    n, e, d = 400, 16500, 128
    graph = build_graph(rng.randint(0, n, e), rng.randint(0, n, e),
                        num_nodes=n)
    proc = InteractionNetProcessor(d, 4, d, d, 2, generator=torch.Generator()
                                   .manual_seed(0))
    calls = _Calls(monkeypatch)
    x = torch.randn(2, n, d)
    raw = torch.randn(graph.padded_num_edges, 4)
    counts = []
    with torch.no_grad():
        for inp in (x[0], x):
            proc(inp, graph, edge_attr_raw=raw)
            counts.append(calls.take())
    assert counts[0] == counts[1], counts
    assert counts[0][route.replace("mega", "edge_mlp")] == 2
    assert {s.route for s in proc.steps} == {route}
