"""The trace reader on a hand-made Chrome trace (microseconds)."""

import pytest

from portbench.harness import trace
from portbench.harness.probes import SEGMENT_SUM


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


EVENTS = [
    _x("user_annotation", trace.WINDOW, 0, 100),
    _x("cpu_op", "aten::mm", 0, 100),
    _x("user_annotation", SEGMENT_SUM, 4, 2),
    _x("cuda_runtime", "cudaLaunchKernel", 5, 0.5, corr=1),
    _x("cuda_runtime", "cudaLaunchKernel", 20, 0.5, corr=2),
    _x("cpu_op", "aten::foo", 45, 10),
    _x("kernel", "segment_kernel", 10, 20, tid=7, corr=1),
    _x("kernel", "gemm", 25, 15, tid=7, corr=2),
    _x("gpu_memcpy", "Memcpy DtoH", 60, 10, tid=7, corr=3),
    _x("gpu_user_annotation", SEGMENT_SUM, 10, 20, tid=7),
]


def test_summary():
    s = trace.summarize(EVENTS, (SEGMENT_SUM,))
    assert s.window_s == pytest.approx(100e-6)
    # Device busy: [10, 40] and [60, 70].
    assert s.busy_s == pytest.approx(40e-6)
    assert s.device_ops[0] == ("segment_kernel", pytest.approx(20e-6))
    # Gaps [0, 10], [40, 60], [70, 100], each put down to the innermost
    # host operation at its middle (at 5 the launch inside the
    # annotation).
    idle = dict(s.idle_gaps)
    assert idle["cudaLaunchKernel"] == pytest.approx(10e-6)
    assert idle["aten::foo"] == pytest.approx(20e-6)
    assert idle["aten::mm"] == pytest.approx(30e-6)
    # The annotated launch ran the kernel of correlation 1 alone.
    assert s.annotated_s[SEGMENT_SUM] == pytest.approx(20e-6)
    assert s.annotated_n[SEGMENT_SUM] == 1


def test_missing_window():
    with pytest.raises(RuntimeError):
        trace.summarize(EVENTS[1:])
