"""The readers of the program's spans and synchronization counter
(``metrics/{encoder,decoder,rollout_self,forward,backward}_ms.*`` and
``metrics/host_syncs.*`` over ``graphcast_lite_torch.tracing``).

On a hand-built recording, each reader gives its metric's value from the
window's units alone: the first ``attempted`` root spans recorded after
``install``, so that a warm-up unit before it and a profiled unit after
them are left out.  Off the card, and on a program that records nothing,
the readers give None.  On the card (``card``): an ``.item()`` inside a
span counts as exactly one synchronization, device ms are positive, and
a forward's encoder, processor and decoder spans fit in its ``model``
span."""

import os
import types

import pytest
import torch

from conftest import REPO
from graphcast_lite_torch import tracing
from portbench.harness import bench, system

SERVE = ["encoder_ms.latency", "decoder_ms.latency",
         "rollout_self_ms.latency", "host_syncs.latency",
         "encoder_ms.serve", "decoder_ms.serve", "host_syncs.serve"]
TRAIN = ["forward_ms.train", "backward_ms.train", "host_syncs.train"]


@pytest.fixture(autouse=True)
def recording_off():
    tracing.disable()
    yield
    tracing.disable()


def _reader(name):
    return bench.load_module(os.path.join(REPO, "portbench", "metrics",
                                          name + ".py"))


def _run(attempted):
    return types.SimpleNamespace(cuda=False, probes={},
                                 window=types.SimpleNamespace(
                                     attempted=attempted))


def _span(ms, name, syncs=0, inner=()):
    """Record ``name`` with ``syncs`` synchronizations of its own and the
    spans ``inner`` ((ms, name, syncs, inner) each) under it, and give it
    ``ms`` device milliseconds."""
    with tracing.span(name) as record:
        for _ in range(syncs):
            tracing.recorder().count_sync()
        for child in inner:
            _span(*child)
    record.device_ms = ms


def _request(scale):
    """One AR-2 request: rollout 100 s; its forwards 20 s and 30 s (encoder
    2 s / 3 s, processor 15 s / 25 s, decoder 1 s / 1.5 s); a
    synchronization in each AR step's carry-forward."""
    blocks = [(2.0, "model.encoder"), (15.0, "model.processor"),
              (1.0, "model.decoder")]
    later = [(3.0, "model.encoder"), (25.0, "model.processor"),
             (1.5, "model.decoder")]
    _span(100 * scale, "rollout", 2, [
        (20 * scale, "model", 0, [(ms * scale, n) for ms, n in blocks]),
        (30 * scale, "model", 0, [(ms * scale, n) for ms, n in later])])


def _step(scale, recomputes=True):
    """One train step: forward 10 s, backward 25 s (a recompute 6 s under
    it), optimizer 1 s; three synchronizations in the rollout."""
    _span(40 * scale, "train.step", 0, [
        (10 * scale, "train.forward", 0, [
            (9 * scale, "rollout", 3, [(8 * scale, "model", 0, [])])]),
        (25 * scale, "train.backward", 0,
         [(6 * scale, "model", 0, [])] if recomputes else []),
        (1 * scale, "train.optimizer")])


def _read(names, unit, attempted=2):
    """Warm-up unit, install, ``attempted`` window units (scale 1 and 2),
    a profiled unit (scale 1000); each reader's value on the card."""
    tracing.enable(cuda_events=False)
    unit(1000)
    run = _run(attempted)
    readers = {n: _reader(n) for n in names}
    for reader in readers.values():
        reader.install(run)
    for scale in (1, 2)[:attempted]:
        unit(scale)
    unit(1000)
    run.cuda = True
    return {n: r.read(run) for n, r in readers.items()}


def test_serve_readers():
    got = _read(SERVE, _request)
    # Four forwards in the window: encoder (2 + 3 + 4 + 6) / 4.
    assert got["encoder_ms.latency"] == pytest.approx(3.75)
    assert got["encoder_ms.serve"] == pytest.approx(3.75)
    assert got["decoder_ms.latency"] == pytest.approx(1.875)
    assert got["decoder_ms.serve"] == pytest.approx(1.875)
    # A request's rollout less its forwards: 50 and 100.
    assert got["rollout_self_ms.latency"] == pytest.approx(75.0)
    assert got["host_syncs.latency"] == 2 and got["host_syncs.serve"] == 2
    assert tracing.recorder() is None


def test_train_readers():
    got = _read(TRAIN, _step)
    assert got["forward_ms.train"] == pytest.approx(15.0)
    assert got["backward_ms.train"] == pytest.approx(37.5)
    assert got["host_syncs.train"] == 3


def test_a_profiled_unit_is_dropped():
    # One unit attempted: only the first root after install is read.
    got = _read(["encoder_ms.latency", "rollout_self_ms.latency"], _request,
                attempted=1)
    assert got["encoder_ms.latency"] == pytest.approx(2.5)
    assert got["rollout_self_ms.latency"] == pytest.approx(50.0)


def test_no_card_or_no_spans_reads_none():
    for name in SERVE + TRAIN:
        reader = _reader(name)
        run = _run(1)
        reader.install(run)
        _request(1)
        assert reader.read(run) is None      # off the card
        assert tracing.recorder() is None    # reading ends the recording
        assert reader.read(_run(1)) is None  # a program without spans


@pytest.mark.card
def test_card_counts_one_sync_and_nests_device_ms(tiny_root):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from graphcast_lite_torch.training.rollout import RolloutSpec, \
        rollout_predict

    dev = torch.device("cuda")
    cfg = bench.load_json(os.path.join(tiny_root, "tiny", "flagship.json"))
    model, graphs, _ = system.build_model(cfg, dev, 7)
    d = cfg["data"]
    spec = RolloutSpec(obs_window=d["obs_window_used"],
                       num_features=d["num_features_used"],
                       use_residual=cfg["use_residual"], remat=False,
                       static_channels=tuple(cfg["static_channels"]),
                       forcing_channels=tuple(cfg["forcing_channels"]))
    x = torch.randn((model.num_grid_nodes, spec.obs_window,
                     spec.num_features), device=dev)
    rec = tracing.enable(cuda_events=True)
    try:
        with torch.no_grad():
            rollout_predict(lambda i, m, t, p: model(i, graphs, m), x, 2,
                            spec)
        with tracing.span("probe"):
            x.sum().item()
    finally:
        tracing.disable()
    rollout, (probe,) = rec.trees()
    assert probe.syncs == 1 and rec.outside == 0
    print(f"rollout syncs: {sum(s.syncs for s in rollout)}")
    assert all(s.device_ms > 0 for s in rollout + [probe])
    models = [s for s in rollout if s.name == "model"]
    assert len(models) == 2
    for m in models:
        blocks = [s for s in rollout if s.parent == m.index]
        assert len(blocks) == 3
        assert sum(s.device_ms for s in blocks) <= m.device_ms
