"""Launches of the program's reg-edge step kernel a dispatch, mean over the
window's dispatches: ``reg_edge_launches.latency``'s reader, loaded from
its file (the harness loads one file a metric), over the batched serve's
unit, one dispatch of its states.  A program without the counter reads
nothing."""

import importlib.util
import os

_spec = importlib.util.spec_from_file_location(
    "portbench_metrics_reg_edge_launches_latency",
    os.path.join(os.path.dirname(os.path.abspath(__file__)),
                 "reg_edge_launches.latency.py"))
_reader = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_reader)
install, read = _reader.install, _reader.read
