"""The program's spans and synchronization counter (``tracing``) on the
CPU, on the small flagship architecture (64x32, mesh [1, 2], hidden 16,
2 processor steps):

* With recording off, ``span`` returns the shared no-op, records nothing
  and emits no profiler range.
* With recording on, a ``rollout_predict`` of 2 AR steps gives the tree
  ``rollout`` -> 2 x ``model`` -> encoder, processor and decoder under one
  trace id, with nested host stamps; a ``TrainStep`` step gives
  ``train.step`` -> forward, backward and optimizer, with the AR
  checkpoints' recompute (``model`` spans) under ``train.backward``.  A
  span opened in a thread that did not inherit the context sits under
  the span last opened elsewhere.
* Under a CPU ``torch.profiler`` the ``gclt::`` ranges are
  ``user_annotation`` events inside the profiled range.
* A planted synchronization warning is counted once, on the innermost
  span, every occurrence at one call site, and shown again once
  recording is off.
* Outputs, losses and gradients are bitwise equal with recording on and
  off.
"""

import copy
import functools
import json
import threading
import warnings

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from graphcast_lite_torch import tracing
from graphcast_lite_torch.graphs.build import build_graph_set
from graphcast_lite_torch.models.weather import ModelGraphs, WeatherModel
from graphcast_lite_torch.training.rollout import RolloutSpec, \
    rollout_predict
from graphcast_lite_torch.training.trainer import make_train_step
from torch_port_common import LAT, LEVELS, LON, N_FEAT, OBS, SPEC, \
    batch, one_torch_thread, small_configs  # noqa: F401 (autouse)

BLOCKS = ["model", "model.encoder", "model.processor", "model.decoder"]


@pytest.fixture(autouse=True)
def recording_off():
    tracing.disable()
    yield
    tracing.disable()


@functools.lru_cache(maxsize=None)
def _parts():
    _, cfg = small_configs(hidden=16)
    gs = build_graph_set(LAT, LON, LEVELS, 0.6)
    torch.manual_seed(0)
    model = WeatherModel(cfg.pipeline, cfg.data, gs.num_grid_nodes,
                         gs.num_mesh_nodes)
    return cfg, model, ModelGraphs.from_graph_set(gs)


def _predict(steps=2):
    _, model, graphs = _parts()
    window = torch.randn((model.num_grid_nodes, OBS, N_FEAT),
                         generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        return rollout_predict(lambda x, m, t, p: model(x, graphs, m),
                               window, steps, RolloutSpec(**SPEC))


def _train_step():
    """(loss, {name: grad}, {name: param after}) of one AR-2 step on a
    fresh copy of the model, with each AR step checkpointed."""
    cfg, model, graphs = _parts()
    cfg = copy.deepcopy(cfg)
    cfg.max_ar_steps, cfg.tpu.compute_dtype = 2, "float32"
    model = copy.deepcopy(model)
    x, y, lw, cm = batch(model.num_grid_nodes)
    y = y[..., :2 * N_FEAT]
    step = make_train_step(model, graphs, RolloutSpec(**SPEC), cfg,
                           device="cpu", lat_weights=lw, chan_mask=cm)
    loss = step(x, y)
    named = dict(model.named_parameters())
    return (loss, {n: p.grad.clone() for n, p in named.items()},
            {n: p.detach().clone() for n, p in named.items()})


def _children(spans, parent):
    return [s for s in spans if s.parent == parent.index]


def test_off_is_the_shared_no_op():
    assert tracing.recorder() is None
    a, b = tracing.span("rollout"), tracing.span("model", steps=2)
    assert a is b
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("outer"):
            with a as got:
                assert got is None
            _predict()
    names = {e.name for e in prof.events()}
    assert "outer" in names
    assert not [n for n in names if n.startswith(tracing.PROFILER_PREFIX)]
    assert tracing.recorder() is None


def test_rollout_tree():
    rec = tracing.enable(cuda_events=False)
    assert tracing.enable(cuda_events=False) is rec
    with pytest.raises(ValueError):
        tracing.enable(cuda_events=True)
    _predict(steps=2)
    assert tracing.disable() is rec and tracing.recorder() is None
    (tree,) = rec.trees()
    assert tree == rec.spans
    assert [s.name for s in tree] == ["rollout"] + BLOCKS * 2
    root = tree[0]
    assert root.parent == -1 and len({s.trace for s in tree}) == 1
    models = _children(tree, root)
    assert [s.name for s in models] == ["model", "model"]
    for m in models:
        blocks = _children(tree, m)
        assert [s.name for s in blocks] == BLOCKS[1:]
        # Siblings in order, each inside its parent.
        for a, b in zip(blocks, blocks[1:]):
            assert a.end_ns <= b.start_ns
    for s in tree[1:]:
        up = rec.spans[s.parent]
        assert up.start_ns <= s.start_ns <= s.end_ns <= up.end_ns
        assert s.host_ms >= 0 and s.device_ms is None and s.syncs == 0
    assert models[0].end_ns <= models[1].start_ns


def test_attributes_and_trace_ids():
    rec = tracing.enable(cuda_events=False)
    for i in range(2):
        with tracing.span("rollout", request=i):
            with tracing.span("model"):
                pass
    tracing.disable()
    a, b = rec.trees()
    assert [s.attrs for s in a] == [{"request": 0}, {}]
    assert {s.trace for s in a} != {s.trace for s in b}
    assert rec.trees(start=2) == [b] and rec.trees(count=1) == [a]


def test_train_step_tree_with_the_recompute_under_backward():
    rec = tracing.enable(cuda_events=False)
    _train_step()
    tracing.disable()
    (tree,) = rec.trees()
    root = tree[0]
    assert root.name == "train.step" and len({s.trace for s in tree}) == 1
    fwd, bwd, opt = _children(tree, root)
    assert [fwd.name, bwd.name, opt.name] == ["train.forward",
                                              "train.backward",
                                              "train.optimizer"]
    (rollout,) = _children(tree, fwd)
    assert rollout.name == "rollout"
    assert [s.name for s in _children(tree, rollout)] == ["model"] * 2
    # Each AR step's checkpoint recomputes its model call in the backward.
    assert [s.name for s in _children(tree, bwd)] == ["model"] * 2
    assert _children(tree, opt) == []


def test_a_thread_without_the_context_takes_the_last_open_span():
    rec = tracing.enable(cuda_events=False)

    def work():
        with tracing.span("model"):
            with tracing.span("model.encoder"):
                pass

    with tracing.span("train.backward"):
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        with tracing.span("train.optimizer"):
            pass
    tracing.disable()
    bwd, model, enc, opt = rec.spans
    assert (model.parent, enc.parent, opt.parent) == (0, 1, 0)
    assert len({s.trace for s in rec.spans}) == 1


def test_profiler_ranges_inside_the_profiled_range(tmp_path):
    tracing.enable(cuda_events=False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("outer"):
            _predict(steps=2)
    tracing.disable()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    (outer,) = [e for e in events if e["name"] == "outer"]
    ours = [e for e in events
            if e["name"].startswith(tracing.PROFILER_PREFIX)]
    assert sorted(e["name"] for e in ours) == sorted(
        tracing.PROFILER_PREFIX + n for n in ["rollout"] + BLOCKS * 2)
    for e in ours:
        assert outer["ts"] <= e["ts"]
        assert e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]


def test_planted_sync_counted_once_on_the_innermost_span():
    rec = tracing.enable(cuda_events=False)
    with tracing.span("rollout"):
        with tracing.span("model"):
            warnings.warn(tracing.SYNC_WARNING + " (planted)", UserWarning)
        for _ in range(3):
            warnings.warn(tracing.SYNC_WARNING, UserWarning)
    warnings.warn(tracing.SYNC_WARNING, UserWarning)
    with pytest.warns(UserWarning, match="not a sync"):
        warnings.warn("not a sync", UserWarning)
    tracing.disable()
    rollout, model = rec.spans
    assert (model.syncs, rollout.syncs, rec.outside) == (1, 3, 1)
    with pytest.warns(UserWarning, match=tracing.SYNC_WARNING):
        warnings.warn(tracing.SYNC_WARNING, UserWarning)
    assert (model.syncs, rollout.syncs, rec.outside) == (1, 3, 1)


def test_recording_changes_no_bit():
    off = _predict(steps=2), _train_step()
    tracing.enable(cuda_events=False)
    on = _predict(steps=2), _train_step()
    tracing.disable()
    assert torch.equal(off[0], on[0])
    (loss0, grads0, after0), (loss1, grads1, after1) = off[1], on[1]
    assert torch.equal(loss0, loss1)
    for n in grads0:
        assert torch.equal(grads0[n], grads1[n]), n
        assert torch.equal(after0[n], after1[n]), n
