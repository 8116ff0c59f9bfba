"""The train step's memory policies (``models.remat``) on the CPU:
``GCLT_SCAN_REMAT`` (none / dots / full: each InteractionNet processor
step's checkpoint) and ``GCLT_ENCDEC_REMAT`` (0 / 1: the encoder's and
the decoder's), on the small flagship architecture (64x32, mesh [1, 2],
hidden 32, 2 processor steps) at AR 2 and a batch of 2, on three routes:
the lazy reg-block step, the lazy COO composed step (``GCLT_REG_EDGE=0``)
and the plain step (``GCLT_LAZY_EDGE=0``).

* Every policy computes the same function: the loss and every gradient
  of a train step are bitwise those of (none, 0), in fp32 on the three
  routes and in bf16 mixed precision on the reg-block route.  The CPU is
  deterministic, so any difference is a bug.
* The policies take effect.  Per AR step of a train step (which
  checkpoints each AR step), the encoder runs twice with its remat off
  (the forward, the AR step's recompute) and three times with it on (its
  own recompute), each processor step twice under ``none`` and three
  times under ``dots`` and ``full``.  The decoder runs twice either way:
  with its remat on, the AR step's recompute stops once it has rebuilt
  what that checkpoint saved, the decoder's inputs last (torch's early
  stop), and the decoder's own recompute runs it the second time.  A forward
  pre-hook counts the encoder, the decoder and the plain steps; the lazy
  steps (``InteractionNetLayer.lazy``, not a module call) by a wrapper.
  The bytes one grad-enabled model call leaves for its backward (the
  storages created in the call that are still alive after it, each
  counted once, the output's excluded) are ordered full < dots < none,
  and less with encoder/decoder remat on than off.
* Under (full, 1) the port's AR-2 loss and gradients on the reg-block
  route are within the existing tolerances of ``jax.value_and_grad`` of
  the JAX package's ``rollout_loss`` under the same switches (read by the
  JAX package while it traces).
* SparseGAT's pruned mask, loss and gradients under (full, 1) are bitwise
  those under (none, 0).
* ``parallel.sharded_model._scan_remat`` reads ``GCLT_SHARDED_SCAN_REMAT``
  and, where that is unset, ``GCLT_SCAN_REMAT``; only ``full`` turns it
  on, as in the JAX package's sharded scan.
"""

import copy
import gc
import itertools
import weakref

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from graphcast_lite_torch import presets as port_presets
from graphcast_lite_torch.models import remat
from graphcast_lite_torch.models.weather import ModelGraphs, WeatherModel
from graphcast_lite_torch.ops.fused_edge import training_trace
from graphcast_lite_torch.parallel import sharded_model
from graphcast_lite_torch.training.loss import channel_mask, \
    lat_weights_from_axis
from graphcast_lite_torch.training.rollout import RolloutSpec
from graphcast_lite_torch.training.trainer import make_train_step
from torch_port_common import LEVELS, LOSS_RTOL, N_FEAT, OBS, SPEC, \
    assert_grads_close, graph_sets, jax_step, model_pair, \
    one_torch_thread, port_step, small_configs  # noqa: F401 (autouse)

AR, BATCH = 2, 2
ROUTES = {
    "reg_block": ({}, "reg_block"),
    "composed": ({"GCLT_REG_EDGE": "0"}, "composed"),
    "plain": ({"GCLT_LAZY_EDGE": "0"}, "nonlazy"),
}
_ROUTE_SWITCHES = ("GCLT_REG_EDGE", "GCLT_EDGE_STEP", "GCLT_MEGA_EDGE",
                   "GCLT_FUSED_EDGE", "GCLT_FUSED_SAVE_HPRE")
POLICIES = list(itertools.product(("none", "dots", "full"), ("0", "1")))
_RUNS = {}


def _policy_env(mp, route, scan, encdec):
    mp.setenv("GCLT_LAZY_EDGE", "1")
    for name in _ROUTE_SWITCHES:
        mp.delenv(name, raising=False)
    for name, value in ROUTES[route][0].items():
        mp.setenv(name, value)
    mp.setenv("GCLT_SCAN_REMAT", scan)
    mp.setenv("GCLT_ENCDEC_REMAT", encdec)


@pytest.fixture(scope="module")
def setup():
    """(model, graphs, x [B, G, obs·C], y [B, G, AR·C], lat weights,
    channel mask), the weights from a seeded generator."""
    _, cfg = small_configs()
    _, tgs = graph_sets()
    model = WeatherModel(cfg.pipeline, cfg.data, tgs.num_grid_nodes,
                         tgs.num_mesh_nodes,
                         generator=torch.Generator().manual_seed(0))
    rng = np.random.RandomState(1)
    g = tgs.num_grid_nodes
    x = rng.randn(BATCH, g, OBS * N_FEAT).astype(np.float32)
    y = rng.randn(BATCH, g, AR * N_FEAT).astype(np.float32)
    lw = lat_weights_from_axis(32, 64)
    cm = channel_mask(N_FEAT, SPEC["static_channels"],
                      SPEC["forcing_channels"])
    return model, ModelGraphs.from_graph_set(tgs), x, y, lw, cm


def _counters(model):
    """Calls of the encoder, the decoder and each processor step."""
    counts = {"encoder": 0, "decoder": 0}
    steps = model.processor.graph_layer.inet.steps

    def bump(name):
        def hook(*_):
            counts[name] += 1
        return hook

    for name in ("encoder", "decoder"):
        getattr(model, name).register_forward_pre_hook(bump(name))
    for i, step in enumerate(steps):
        counts[f"step{i}"] = 0
        step.register_forward_pre_hook(bump(f"step{i}"))
        lazy, hook = step.lazy, bump(f"step{i}")

        def counted(*args, _lazy=lazy, _hook=hook):
            _hook()
            return _lazy(*args)

        step.lazy = counted
    return counts


def _train(setup, route, scan, encdec, dtype="float32"):
    """(loss, gradients, call counts, routes) of one AR-2 train step of
    a copy of the model under a policy, computed once."""
    key = (route, scan, encdec, dtype)
    if key not in _RUNS:
        base, graphs, x, y, lw, cm = setup
        model = copy.deepcopy(base)
        counts = _counters(model)
        _, cfg = small_configs()
        cfg.max_ar_steps = AR
        cfg.tpu.compute_dtype = dtype
        with pytest.MonkeyPatch.context() as mp:
            _policy_env(mp, route, scan, encdec)
            step = make_train_step(model, graphs, RolloutSpec(**SPEC), cfg,
                                   device="cpu", lat_weights=lw,
                                   chan_mask=cm)
            loss = step(x, y)
        grads = {n: p.grad.clone() for n, p in model.named_parameters()
                 if p.grad is not None}
        routes = {s.route for s in model.processor.graph_layer.inet.steps}
        _RUNS[key] = (loss.item(), grads, counts, routes)
    return _RUNS[key]


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("scan,encdec", POLICIES)
def test_policy_is_bitwise_the_plain_step(setup, route, scan, encdec):
    loss, grads, _, routes = _train(setup, route, scan, encdec)
    ref_loss, ref_grads, _, _ = _train(setup, route, "none", "0")
    assert routes == {ROUTES[route][1]}
    assert loss == ref_loss
    assert grads.keys() == ref_grads.keys() and len(grads) > 40
    for name, g in grads.items():
        assert torch.equal(g, ref_grads[name]), name


@pytest.mark.parametrize("scan,encdec", POLICIES[1:])
def test_bf16_policy_is_bitwise_the_plain_step(setup, scan, encdec):
    """The mixed-precision step binds bf16 copies of the parameters
    (``functional_call``) for the forward; each recompute, run in the
    backward, must bind the same copies."""
    loss, grads, _, _ = _train(setup, "reg_block", scan, encdec, "bfloat16")
    ref_loss, ref_grads, _, _ = _train(setup, "reg_block", "none", "0",
                                       "bfloat16")
    assert loss == ref_loss
    for name, g in grads.items():
        assert torch.equal(g, ref_grads[name]), name


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("scan,encdec", POLICIES)
def test_policy_recomputes_as_stated(setup, route, scan, encdec):
    counts = _train(setup, route, scan, encdec)[2]
    step = AR * (2 if scan == "none" else 3)
    assert counts == {"encoder": AR * (3 if encdec == "1" else 2),
                      "decoder": AR * 2, "step0": step, "step1": step}


class _LiveStorages(TorchDispatchMode):
    """Weak references to the storage of every tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.refs = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.refs.append(weakref.ref(t.untyped_storage()))
        return out

    def live_bytes(self, exclude):
        """Bytes of the storages still alive, each counted once, those of
        ``exclude`` left out."""
        gc.collect()
        live = {s.data_ptr(): s.nbytes() for s in (r() for r in self.refs)
                if s is not None}
        for t in exclude:
            live.pop(t.untyped_storage().data_ptr(), None)
        return sum(live.values())


def _saved_bytes(setup, route, scan, encdec):
    base, graphs, x, _, _, _ = setup
    model = copy.deepcopy(base)
    inp = torch.from_numpy(x)
    with pytest.MonkeyPatch.context() as mp:
        _policy_env(mp, route, scan, encdec)
        mode = _LiveStorages()
        with training_trace(), mode:
            out, _ = model(inp, graphs)
        nbytes = mode.live_bytes([out])
        out.sum().backward()
    return nbytes


@pytest.mark.parametrize("route", list(ROUTES))
def test_saved_bytes_follow_the_policy(setup, route):
    none, dots, full, encdec = (
        _saved_bytes(setup, route, s, e)
        for s, e in (("none", "0"), ("dots", "0"), ("full", "0"),
                     ("none", "1")))
    print(f"{route}: saved bytes none {none}, dots {dots}, full {full}; "
          f"encoder/decoder remat {encdec}")
    assert 0 < full < dots < none
    assert encdec < none


def test_port_matches_jax_under_full_remat(monkeypatch):
    """(full, 1) on the reg-block route, B = 1, against the JAX
    package's rollout_loss under the same switches."""
    _policy_env(monkeypatch, "reg_block", "full", "1")
    jmodel, params, jgraphs, tmodel, tgraphs = model_pair()
    _, tgs = graph_sets()
    rng = np.random.RandomState(2)
    g = tgs.num_grid_nodes
    x = rng.randn(1, g, OBS * N_FEAT).astype(np.float32)
    y = rng.randn(1, g, 4 * N_FEAT).astype(np.float32)
    lw = lat_weights_from_axis(32, 64)
    cm = channel_mask(N_FEAT, SPEC["static_channels"],
                      SPEC["forcing_channels"])
    jloss, jgrads = jax_step(jmodel, params, jgraphs, x, y, lw, cm, ar=AR)
    loss, grads, _, _ = port_step(tmodel, tgraphs, x, y, lw, cm, ar=AR)
    assert {s.route for s in tmodel.processor.graph_layer.inet.steps} \
        == {"reg_block"}
    assert abs(loss - jloss) <= LOSS_RTOL * abs(jloss), (loss, jloss)
    assert_grads_close(grads, jgrads)


def test_sparse_gat_mask_under_full_remat():
    """SparseGAT (hidden 16) prunes the same edges, and its train step
    gives the same loss and gradients, under (full, 1) as under
    (none, 0)."""
    cfg = port_presets.sparse_gat_64x32(n_feat=N_FEAT, hidden=16)
    cfg.graph.mesh_levels = list(LEVELS)
    cfg.max_ar_steps = AR
    _, tgs = graph_sets()
    graphs = ModelGraphs.from_graph_set(tgs)
    base = WeatherModel(cfg.pipeline, cfg.data, tgs.num_grid_nodes,
                        tgs.num_mesh_nodes,
                        generator=torch.Generator().manual_seed(3))
    obs = cfg.data.obs_window_used
    rng = np.random.RandomState(4)
    g = tgs.num_grid_nodes
    x = rng.randn(BATCH, g, obs * N_FEAT).astype(np.float32)
    y = rng.randn(BATCH, g, AR * N_FEAT).astype(np.float32)
    spec = RolloutSpec(obs_window=obs, num_features=N_FEAT,
                       use_residual=True, remat=True)
    out = {}
    for scan, encdec in (("none", "0"), ("full", "1")):
        model = copy.deepcopy(base)
        mask0 = graphs.processing.edge_mask.clone()
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("GCLT_SCAN_REMAT", scan)
            mp.setenv("GCLT_ENCDEC_REMAT", encdec)
            step = make_train_step(model, graphs, spec, cfg, device="cpu",
                                   lat_weights=lat_weights_from_axis(32, 64))
            loss, mask = step.run(x, y, mask0, 0.1356, True)
        out[scan] = (loss.item(), mask, {n: p.grad.clone() for n, p in
                                         model.named_parameters()})
    (loss0, mask0, grads0), (loss1, mask1, grads1) = out.values()
    assert 0 < int(mask0.sum()) < mask0.numel()
    assert torch.equal(mask1, mask0)
    assert loss1 == loss0
    for name, grad in grads1.items():
        assert torch.equal(grad, grads0[name]), name


def test_policy_switches_read_as_the_reference(monkeypatch):
    monkeypatch.setenv("GCLT_SCAN_REMAT", "dot")
    with pytest.raises(ValueError, match="any value other than none"):
        remat.scan_remat()
    monkeypatch.delenv("GCLT_ENCDEC_REMAT", raising=False)
    assert remat.encdec_remat() is remat.ENCDEC_REMAT_DEFAULT
    for value, on in (("0", False), ("false", False), ("off", False),
                      ("1", True), ("yes", True)):
        monkeypatch.setenv("GCLT_ENCDEC_REMAT", value)
        assert remat.encdec_remat() is on


_UNSET = None


@pytest.mark.parametrize("sharded", [_UNSET, "none", "dots", "full", "FULL"])
@pytest.mark.parametrize("scan", [_UNSET, "none", "dots", "full"])
def test_sharded_scan_remat_precedence(monkeypatch, sharded, scan):
    for name, value in (("GCLT_SHARDED_SCAN_REMAT", sharded),
                        ("GCLT_SCAN_REMAT", scan)):
        if value is _UNSET:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    read = sharded if sharded is not _UNSET else scan
    assert sharded_model._scan_remat() is (
        read is not _UNSET and read.lower() == "full")
