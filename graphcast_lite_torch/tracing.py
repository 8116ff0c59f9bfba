"""Spans and a synchronization counter inside the program, off by default.

    from graphcast_lite_torch import tracing

    rec = tracing.enable(cuda_events=True)    # or False off the card
    ...                                       # rollouts, train steps
    tracing.disable()
    for tree in rec.trees():                  # one list a root span
        ...

The program opens a span at each layer boundary: ``rollout``
(``training.rollout``), ``model`` and its ``model.encoder`` /
``model.processor`` / ``model.decoder`` blocks (``models.weather``), and
``train.step`` with ``train.forward`` / ``train.backward`` /
``train.optimizer`` (``training.trainer``).  Nothing finer.

While recording is off, ``span`` returns one shared no-op context manager
after a single check of a module-level reference: it creates nothing,
records nothing and calls no profiler.  Recording is turned on and off
only through ``enable`` and ``disable``; ``recorder`` returns the active
``Recorder`` or None.

While recording is on, each span keeps in memory its name, the trace id
it shares with every span under its root (one request, one train step),
the index of its parent, host start and end (``time.perf_counter_ns``),
its attributes, the number of host-device synchronizations made while it
was the innermost open span, and, with ``cuda_events``, a pair of timing
events on the current CUDA stream.  The events give its device
milliseconds, idle time the host caused inside it included; they are
resolved lazily, with one synchronize, when read.  While a
``torch.profiler`` is active each span also opens a profiler range
``gclt::<name>``, so that the device trace carries it on its own clock.

The parent of a span is the innermost span open in the same
``contextvars`` context.  A thread that did not inherit that context
(autograd's device threads, where a checkpoint's recompute runs) takes the
innermost span last opened in any thread, so that a recompute's ``model``
spans sit under the ``train.backward`` that caused them.

Synchronizations (with ``cuda_events``): PyTorch's sync debug mode is set
to ``"warn"`` while recording and restored on ``disable``; each of its
warnings, every occurrence and not only the first at a call site, is
counted on the innermost open span (on ``Recorder.outside`` when none is
open) and not shown.  It covers the synchronizations PyTorch reports:
copies between the host and pageable memory, ``.item()``, ``nonzero``
and the like, not ``torch.cuda.synchronize``.
"""

from __future__ import annotations

import contextvars
import threading
import time
import warnings
from typing import Dict, List, Optional

import torch

__all__ = ["PROFILER_PREFIX", "SYNC_WARNING", "Recorder", "SpanRecord",
           "disable", "enable", "recorder", "span"]

PROFILER_PREFIX = "gclt::"
# The start of the warning that PyTorch's sync debug mode raises.
SYNC_WARNING = "called a synchronizing CUDA operation"

_RECORDER: Optional["Recorder"] = None


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def span(name: str, **attrs):
    """A context manager that records a span of ``name`` while recording
    is on, and the shared no-op while it is off."""
    rec = _RECORDER
    if rec is None:
        return _NO_SPAN
    return _Span(rec, name, attrs)


def recorder() -> Optional["Recorder"]:
    """The active recorder, or None while recording is off."""
    return _RECORDER


def enable(cuda_events: bool) -> "Recorder":
    """Turn recording on and return the recorder; when it is already on,
    return the active one (which has to agree on ``cuda_events``)."""
    global _RECORDER
    if _RECORDER is not None:
        if _RECORDER.cuda_events != bool(cuda_events):
            raise ValueError("tracing is already on with cuda_events="
                             f"{_RECORDER.cuda_events}")
        return _RECORDER
    rec = Recorder(cuda_events)
    rec._start()
    _RECORDER = rec
    return rec


def disable() -> Optional["Recorder"]:
    """Turn recording off (restoring the sync debug mode and the warning
    filters) and return the recorder that was on, whose spans stay
    readable; None when recording was off."""
    global _RECORDER
    rec, _RECORDER = _RECORDER, None
    if rec is not None:
        rec._stop()
    return rec


class SpanRecord:
    """One span as recorded: ``index`` is its place in ``Recorder.spans``,
    ``parent`` its parent's (-1 for a root), ``trace`` the id its root's
    tree shares, ``syncs`` the synchronizations made while it was the
    innermost open span."""

    __slots__ = ("name", "index", "trace", "parent", "start_ns", "end_ns",
                 "attrs", "syncs", "events", "device_ms")

    def __init__(self, name, index, trace, parent, attrs, events):
        self.name, self.index = name, index
        self.trace, self.parent = trace, parent
        self.attrs: Dict[str, object] = attrs
        self.start_ns = time.perf_counter_ns()
        self.end_ns: Optional[int] = None
        self.syncs = 0
        self.events = events
        # Milliseconds between the two CUDA events: None without events,
        # while open, and until ``Recorder.resolve``.
        self.device_ms: Optional[float] = None

    @property
    def host_ms(self) -> Optional[float]:
        if self.end_ns is None:
            return None
        return (self.end_ns - self.start_ns) * 1e-6


class _Frame:
    """A link of the stack of open spans."""

    __slots__ = ("recorder", "index", "up")

    def __init__(self, recorder, index, up):
        self.recorder, self.index, self.up = recorder, index, up


_STACK: contextvars.ContextVar[Optional[_Frame]] = contextvars.ContextVar(
    "gclt_tracing_stack", default=None)


class Recorder:
    """The spans and synchronizations recorded between ``enable`` and
    ``disable``."""

    def __init__(self, cuda_events: bool):
        self.cuda_events = bool(cuda_events)
        self.spans: List[SpanRecord] = []
        self.outside = 0              # synchronizations outside any span
        self._ambient: Optional[_Frame] = None
        self._lock = threading.Lock()
        self._traces = 0
        self._resolved = 0
        self._warnings = None         # the warning filters' saved state
        self._shown = None            # the ``showwarning`` it replaced
        self._sync_mode = None        # the sync debug mode it replaced

    # ---------------------------------------------------------- recording
    def _innermost(self) -> Optional[_Frame]:
        frame = _STACK.get()
        if frame is not None and frame.recorder is self:
            return frame
        return self._ambient

    def _open(self, name, attrs) -> _Frame:
        events = None
        if self.cuda_events:
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        with self._lock:
            up = self._innermost()
            if up is None:
                parent, trace = -1, self._traces
                self._traces += 1
            else:
                parent, trace = up.index, self.spans[up.index].trace
            record = SpanRecord(name, len(self.spans), trace, parent, attrs,
                                events)
            self.spans.append(record)
            frame = _Frame(self, record.index, up)
            self._ambient = frame
        if events is not None:
            events[0].record()
        return frame

    def _close(self, frame: _Frame):
        record = self.spans[frame.index]
        if record.events is not None:
            record.events[1].record()
        record.end_ns = time.perf_counter_ns()
        self._ambient = frame.up

    def count_sync(self):
        """Count one host-device synchronization on the innermost open
        span."""
        with self._lock:
            frame = self._innermost()
            if frame is None:
                self.outside += 1
            else:
                self.spans[frame.index].syncs += 1

    def _showwarning(self, message, category, *args, **kwargs):
        if issubclass(category, UserWarning) \
                and str(message).startswith(SYNC_WARNING):
            self.count_sync()
        else:
            self._shown(message, category, *args, **kwargs)

    def _start(self):
        self._warnings = warnings.catch_warnings()
        self._warnings.__enter__()
        self._shown = warnings.showwarning
        warnings.filterwarnings("always", message=SYNC_WARNING,
                                category=UserWarning)
        warnings.showwarning = self._showwarning
        if self.cuda_events:
            self._sync_mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")

    def _stop(self):
        if self._sync_mode is not None:
            torch.cuda.set_sync_debug_mode(self._sync_mode)
            self._sync_mode = None
        if self._warnings is not None:
            self._warnings.__exit__(None, None, None)
            self._warnings = None

    # ------------------------------------------------------------ reading
    def resolve(self):
        """Fill ``device_ms`` of every closed span with events (one
        synchronize)."""
        if self.cuda_events:
            torch.cuda.synchronize()
        for s in self.spans[self._resolved:]:
            if s.end_ns is None:
                break
            if s.events is not None:
                s.device_ms = s.events[0].elapsed_time(s.events[1])
            self._resolved += 1

    def trees(self, start: int = 0,
              count: Optional[int] = None) -> List[List[SpanRecord]]:
        """The trees of the first ``count`` (default: all) root spans
        recorded at or after index ``start``: for each root, it and every
        span under it, in the order they opened, device ms resolved."""
        self.resolve()
        roots = [s.trace for s in self.spans[start:] if s.parent < 0]
        if count is not None:
            roots = roots[:count]
        by_trace = {t: [] for t in roots}
        for s in self.spans[start:]:
            tree = by_trace.get(s.trace)
            if tree is not None:
                tree.append(s)
        return [by_trace[t] for t in roots]


class _Span:
    __slots__ = ("recorder", "name", "attrs", "frame", "token", "range")

    def __init__(self, rec: Recorder, name: str, attrs):
        self.recorder, self.name, self.attrs = rec, name, attrs
        self.range = None

    def __enter__(self) -> SpanRecord:
        if torch.autograd._profiler_enabled():
            self.range = torch.autograd.profiler.record_function(
                PROFILER_PREFIX + self.name)
            self.range.__enter__()
        self.frame = self.recorder._open(self.name, self.attrs)
        self.token = _STACK.set(self.frame)
        return self.recorder.spans[self.frame.index]

    def __exit__(self, *exc):
        _STACK.reset(self.token)
        self.recorder._close(self.frame)
        if self.range is not None:
            self.range.__exit__(*exc)
        return False
