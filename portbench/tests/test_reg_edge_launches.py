"""The readers of the reg-edge kernel's launch counter
(``metrics/reg_edge_launches.{latency,serve}`` over
``graphcast_lite_torch.ops.reg_edge.launches``).

Each reader wraps the driver's unit at install and gives the counter's
mean rise over the window's units: units before install (warm-up) and
units while the harness profiles (after the window) are left out.  Off the
card, and on a program whose ``ops.reg_edge`` has no counter, it gives
None and raises nothing."""

import os
import types

import pytest

from conftest import REPO
from graphcast_lite_torch.ops import reg_edge
from portbench.harness import bench

READERS = ["reg_edge_launches.latency", "reg_edge_launches.serve"]


def _reader(name):
    return bench.load_module(os.path.join(REPO, "portbench", "metrics",
                                          name + ".py"))


class _Driver:
    """A unit that launches the kernel ``per_unit`` times."""

    def __init__(self, per_unit):
        self.per_unit = per_unit

    def unit(self):
        reg_edge.launches += self.per_unit
        return None


def _run(cuda, per_unit):
    return types.SimpleNamespace(cuda=cuda, probes={}, profiling=False,
                                 system=_Driver(per_unit))


@pytest.mark.parametrize("name", READERS)
def test_reader_counts_the_window_units(name, monkeypatch):
    monkeypatch.setattr(reg_edge, "launches", 0)
    reader = _reader(name)
    run = _run(True, 48)
    run.system.unit()                  # warm-up: before install
    reader.install(run)
    reader.install(run)                # a second install wraps nothing
    for _ in range(3):
        run.system.unit()
    run.profiling = True               # the profiled units after the window
    run.system.unit()
    assert reader.read(run) == 48.0
    assert reg_edge.launches == 5 * 48


@pytest.mark.parametrize("name", READERS)
def test_reader_gives_none_off_the_card_or_without_a_counter(name,
                                                             monkeypatch):
    reader = _reader(name)
    run = _run(False, 48)
    reader.install(run)
    run.system.unit()
    assert reader.read(run) is None
    monkeypatch.delattr(reg_edge, "launches")
    run = _run(True, 0)
    unit = run.system.unit
    reader.install(run)
    assert run.system.unit == unit and reader.read(run) is None
