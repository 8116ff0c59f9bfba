"""The traced sub-window: a few units of work under ``torch.profiler``
(CPU and CUDA), its Chrome trace read back into device busy time, the
device operations that took most time, the device's idle gaps by what the
host was doing, and the device time of the launches the harness's probes
annotated."""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import shutil
import tempfile
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import numpy as np

__all__ = ["WINDOW", "TraceSummary", "profile_units", "summarize"]

WINDOW = "portbench::window"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
_NAME_CHARS = 160


@dataclasses.dataclass
class TraceSummary:
    window_s: float                       # the sub-window, host side
    busy_s: float                         # union of device operations
    device_ops: List[Tuple[str, float]]   # top 10 by device seconds
    idle_gaps: List[Tuple[str, float]]    # top 10 by idle seconds
    annotated_s: Dict[str, float]         # device s of annotated launches
    annotated_n: Dict[str, int]           # launches found per annotation


def profile_units(unit: Callable[[], None], n: int, synchronize,
                  annotations=()) -> TraceSummary:
    """Run ``unit`` ``n`` times under the profiler and summarize."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    import torch
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    tmp = tempfile.mkdtemp(prefix="portbench-trace-")
    try:
        with profile(activities=activities) as prof:
            with record_function(WINDOW):
                synchronize()
                for _ in range(n):
                    unit()
                synchronize()
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return summarize(events, annotations)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _top(totals: Dict[str, float]) -> List[Tuple[str, float]]:
    return sorted(((k[:_NAME_CHARS], v) for k, v in totals.items()),
                  key=lambda kv: -kv[1])[:10]


def summarize(events, annotations=()) -> TraceSummary:
    """Read a Chrome trace's events (microseconds) into a summary."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in xs if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError("the traced window's annotation is missing")
    w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    dev = [e for e in xs if e.get("cat") in _DEVICE_CATS]
    host = [e for e in xs if e.get("cat") in _HOST_CATS
            and e.get("name") != WINDOW]

    clipped = [(max(e["ts"], w0), min(e["ts"] + e["dur"], w1)) for e in dev]
    busy = _union([(s, t) for s, t in clipped if t > s])
    busy_us = sum(t - s for s, t in busy)
    ops: Dict[str, float] = defaultdict(float)
    for e in dev:
        ops[e["name"]] += e["dur"] * 1e-6

    # Idle gaps, each put down to the innermost host operation (on any
    # thread) that was running at its middle.
    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < w1:
        gaps.append((t, w1))
    idle: Dict[str, float] = defaultdict(float)
    if gaps:
        hs = np.array([e["ts"] for e in host], np.float64)
        he = hs + np.array([e["dur"] for e in host], np.float64)
        hd = he - hs
        names = [e["name"] for e in host]
        mids = np.array([(a + b) / 2 for a, b in gaps])
        for lo in range(0, len(gaps), 256):
            m = mids[lo:lo + 256, None]
            inside = (hs[None, :] <= m) & (he[None, :] >= m) if host \
                else np.zeros((m.shape[0], 0), bool)
            for row, (a, b) in zip(inside, gaps[lo:lo + 256]):
                idx = np.flatnonzero(row)
                name = names[idx[np.argmin(hd[idx])]] if idx.size \
                    else "host, outside any operation"
                idle[name] += (b - a) * 1e-6

    # Launches inside each annotation: the runtime calls made within it
    # on the same thread, and the device operations they launched.
    annotated_s: Dict[str, float] = {}
    annotated_n: Dict[str, int] = {}
    if annotations:
        by_corr = defaultdict(float)
        for e in dev:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                by_corr[corr] += e["dur"] * 1e-6
        runtime = defaultdict(list)
        for e in host:
            if e.get("cat") in ("cuda_runtime", "cuda_driver") \
                    and "aunch" in e["name"]:
                runtime[e.get("tid")].append(
                    (e["ts"], e.get("args", {}).get("correlation")))
        for calls in runtime.values():
            calls.sort(key=lambda c: c[0])
        for name in annotations:
            total, count = 0.0, 0
            for a in xs:
                if a.get("name") != name or a.get("cat") != "user_annotation":
                    continue
                calls = runtime.get(a.get("tid"), [])
                starts = [c[0] for c in calls]
                i = bisect.bisect_left(starts, a["ts"])
                j = bisect.bisect_right(starts, a["ts"] + a["dur"])
                for _, corr in calls[i:j]:
                    total += by_corr.get(corr, 0.0)
                count += 1
            annotated_s[name], annotated_n[name] = total, count
    return TraceSummary(window_s=(w1 - w0) * 1e-6, busy_s=busy_us * 1e-6,
                        device_ops=_top(ops), idle_gaps=_top(idle),
                        annotated_s=annotated_s, annotated_n=annotated_n)
