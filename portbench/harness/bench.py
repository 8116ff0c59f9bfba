"""One run of one cell: the harness around a traffic driver.

``BENCHMARK.json`` names the cell; the cell names a configuration (its
file under ``configs``) and a traffic mix (``traffic/<name>.json``, which
names its driver, ``drivers/<driver>.py``).  Every metric is a reader of
its own, ``metrics/<name>.py``, with ``read(run)`` (and, for a per-layer
metric, an optional ``install(run)`` called before the window); a reader
that finds nothing to read returns None and its metric is left out.  The
limits of the comparison that decides ``correct`` are
``limits/<cell>.json``.

A run: set-up and warm-up by the driver (``setup_s`` runs from the start
of the process to the window), the window of ``seconds``, with ``trace``
the per-layer readers installed over the window and a profiled
sub-window after it, the device memory peak, the program's state freed,
then the driver's comparison with the plain reference.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

from . import trace as trace_lib

__all__ = ["Run", "WindowStats", "load_benchmark", "cell_metrics", "main",
           "BANNED_MODULES"]

BANNED_MODULES = ("jax", "jaxlib", "flax", "graphcast_lite_tpu")
PKG = "portbench"


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(path: str):
    """Import the file ``path`` as a module of its own."""
    name = "portbench_file_" + "".join(
        c if c.isalnum() else "_" for c in os.path.relpath(path))
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_benchmark(root: str) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell_metrics(spec: dict, cell: str):
    """(end-to-end metrics, per-layer metrics) that ``cell`` reports."""
    e2e = [m for m in spec["end_to_end"] if _applies(m, cell)]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if ("workloads" in m and cell in m["workloads"])
             or ("workloads" not in m and m["moves"] in names)]
    return e2e, layer


class WindowStats:
    """What the driver did in the window: units of work (a forecast
    dispatch or a train step), the grid points x AR steps forecast, the
    samples trained, each unit's latency, how late an open loop's
    generator ran, and the window's length."""

    def __init__(self):
        self.units = 0
        self.attempted = 0
        self.failed = 0
        self.points = 0
        self.samples = 0
        self.latencies_s: List[float] = []
        self.late_s = 0.0         # an open loop's lateness at its worst
        self.seconds = 0.0


class Run:
    """The context of one run, shared by the driver and the readers."""

    def __init__(self, root, cell, config, traffic, seed, seconds, trace,
                 device):
        self.root, self.cell = root, cell
        self.config, self.traffic = config, traffic
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = device
        self.system = None        # the driver: .model, .optimizer
        self.window = WindowStats()
        self.setup_s = 0.0
        self.memory_peak_bytes = 0
        self.trace_summary: Optional[trace_lib.TraceSummary] = None
        self.profiling = False    # probes record only in the sub-window
        self.annotations: List[str] = []
        self.probes: Dict[str, object] = {}
        self._spans: Dict[str, list] = {}
        self._open: Dict[str, list] = {}

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def synchronize(self):
        if self.cuda:
            import torch
            torch.cuda.synchronize(self.device)

    def _stamp(self):
        if self.cuda:
            import torch
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def span_start(self, name: str):
        """Open a span of ``name`` (device time on the card: a CUDA event
        on the current stream).  Spans are the window's: none is taken in
        the profiled sub-window."""
        if not self.profiling:
            self._open.setdefault(name, []).append(self._stamp())

    def span_end(self, name: str):
        if not self.profiling:
            start = self._open[name].pop()
            self._spans.setdefault(name, []).append((start, self._stamp()))

    def span_ms(self, name: str) -> List[float]:
        """Milliseconds of every closed span of ``name``."""
        self.synchronize()
        out = []
        for a, b in self._spans.get(name, []):
            out.append(a.elapsed_time(b) if self.cuda else (b - a) * 1e3)
        return out

    def annotate(self, name: str):
        """A profiler range of ``name`` inside the traced sub-window, or
        nothing elsewhere."""
        if not self.profiling:
            return _NULL
        from torch.profiler import record_function
        return record_function(name)


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def _card(device) -> dict:
    """The card's name and power limit (``nvidia-smi``), read once."""
    import torch
    out = {"name": torch.cuda.get_device_name(device)}
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=30)
        out["nvidia_smi"] = res.stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        out["nvidia_smi"] = f"unavailable ({exc.__class__.__name__})"
    return out


def _banned_loaded() -> List[str]:
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(BANNED_MODULES))


def run_cell(root: str, workload: str, seed: int, seconds: float,
             trace: bool, t0: float, device=None) -> dict:
    """Run the cell once; returns the result object (``correct`` and the
    rest, ``checks`` last).  ``device`` None means the first CUDA card,
    which has to be there."""
    import torch

    spec = load_benchmark(root)
    cells = {c["name"]: c for c in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"portbench: no workload {workload!r} in "
                         "BENCHMARK.json")
    cell = cells[workload]
    if device is None:
        found = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if found < cell["chips"]:
            raise SystemExit(f"portbench: {workload} needs {cell['chips']} "
                             f"CUDA device(s); found {found}")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    configs = {c["name"]: c for c in spec["configs"]}
    config = load_json(os.path.join(root, configs[cell["config"]]["file"]))
    traffic = load_json(os.path.join(root, PKG, "traffic",
                                     cell["traffic"] + ".json"))
    limits = load_json(os.path.join(root, PKG, "limits",
                                    workload + ".json"))
    e2e, layer = cell_metrics(spec, workload)
    metrics = layer if trace else e2e
    readers = {m["name"]: load_module(os.path.join(
        root, PKG, "metrics", m["name"] + ".py")) for m in metrics}

    run = Run(root, workload, config, traffic, seed, seconds, trace, device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    driver = load_module(os.path.join(root, PKG, "drivers",
                                      traffic["driver"] + ".py")).Driver(run)
    run.system = driver
    driver.setup()
    if trace:
        for reader in readers.values():
            install = getattr(reader, "install", None)
            if install is not None:
                install(run)
    run.synchronize()
    run.setup_s = time.perf_counter() - t0
    driver.window(seconds)
    run.synchronize()
    if device.type == "cuda":
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated(device))
    if trace:
        run.profiling = True
        try:
            run.trace_summary = trace_lib.profile_units(
                driver.unit, int(traffic["profile_units"]), run.synchronize,
                tuple(run.annotations))
        finally:
            run.profiling = False
    values = {}
    for m in metrics:
        v = readers[m["name"]].read(run)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    driver.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    readings = driver.check()
    checks = {}
    for name, limit in limits.items():
        value = readings.get(name)
        checks[name] = {"value": value, "limit": limit}
    w = run.window
    correct = (all(c["value"] is not None and math.isfinite(c["value"])
                   and c["value"] <= c["limit"] for c in checks.values())
               and set(readings) <= set(limits) and w.failed == 0
               and w.units > 0)
    result = {"correct": bool(correct), "attempted": w.attempted,
              "failed": w.failed, "metrics": values}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": run.memory_peak_bytes}
    result["device"] = dev
    if trace:
        ts = run.trace_summary
        dev["busy_s"], dev["window_s"] = ts.busy_s, ts.window_s
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in ts.device_ops],
            "idle_gaps": [[n, s] for n, s in ts.idle_gaps]}
    if device.type == "cuda":
        result["card"] = dict(_card(device), peak_bf16_flops=None,
                              peak_hbm_bytes_per_s=None)
        from ..costs import peaks
        pk = peaks.lookup(result["card"]["name"])
        if pk is not None:
            result["card"]["peak_bf16_flops"] = pk["bf16_flops"]
            result["card"]["peak_hbm_bytes_per_s"] = pk["hbm_bytes_per_s"]
    lat = sorted(w.latencies_s)
    result["window"] = {
        "seconds": w.seconds, "units": w.units,
        "latency_ms_p50": 1e3 * lat[len(lat) // 2] if lat else None,
        "latency_ms_max": 1e3 * lat[-1] if lat else None,
        "generator_late_ms": 1e3 * w.late_s}
    result["checks"] = checks
    return result


def main(root: str, workload: str, seed: int, seconds: float, trace: bool,
         t0: float, device=None) -> int:
    """Run the cell and print: the checks on standard error, the result
    as the last line of standard output.  A run in a process that has
    loaded JAX or the JAX package prints no result and fails."""
    result = run_cell(root, workload, seed, seconds, trace, t0, device)
    banned = _banned_loaded()
    if banned:
        print(f"portbench: the process loaded {', '.join(banned)}; "
              "no result", file=sys.stderr)
        return 4
    card = result.get("card")
    if card:
        print(f"portbench: card {card['name']} ({card['nvidia_smi']}), "
              f"peaks {card['peak_bf16_flops']} FLOP/s bf16, "
              f"{card['peak_hbm_bytes_per_s']} B/s", file=sys.stderr)
    print(f"portbench: correct={result['correct']} attempted="
          f"{result['attempted']} failed={result['failed']}",
          file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
