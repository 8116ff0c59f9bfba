"""Probes that the per-layer readers install from the benchmark's own
files: CUDA-event spans around a module's forward or the optimizer's
step, and a recorder around the segment-sum launch that counts each
launch's bytes and annotates it for the profiler in the traced
sub-window."""

from __future__ import annotations

from typing import Optional

__all__ = ["SEGMENT_SUM", "module_span", "optimizer_span",
           "segment_sum_recorder", "mean_span_ms", "roofline_pct",
           "mfu_pct", "mfu_latency_pct", "idle_pct"]

SEGMENT_SUM = "portbench::segment_sum"


def module_span(run, module, name: str) -> None:
    """A span of ``name`` around every forward of ``module``."""
    if name in run.probes:
        return
    module.register_forward_pre_hook(lambda *_: run.span_start(name))
    module.register_forward_hook(lambda *_: run.span_end(name))
    run.probes[name] = module


def optimizer_span(run, optimizer, name: str) -> None:
    """A span of ``name`` around every ``optimizer.step``."""
    if name in run.probes:
        return
    optimizer.register_step_pre_hook(lambda *_: run.span_start(name))
    optimizer.register_step_post_hook(lambda *_: run.span_end(name))
    run.probes[name] = optimizer


def segment_sum_recorder(run) -> None:
    """Wrap the segment-sum launch (``ops.cuda_segment._segment_sum``,
    which every caller reaches through its module): in the traced
    sub-window each launch on the card is annotated and its bytes
    counted (``costs.segment_sum``)."""
    if SEGMENT_SUM in run.probes:
        return
    from graphcast_lite_torch.ops import cuda_segment
    from torch.profiler import record_function

    from ..costs.segment_sum import launch_bytes

    launch = cuda_segment._segment_sum
    stats = {"bytes": 0, "launches": 0}

    def recorded(msgs, indptr, num_receivers, design=None):
        if not (run.profiling and msgs.is_cuda):
            return launch(msgs, indptr, num_receivers, design)
        with record_function(SEGMENT_SUM):
            out = launch(msgs, indptr, num_receivers, design)
        stats["bytes"] += launch_bytes(tuple(msgs.shape), msgs.element_size(),
                                       num_receivers)
        stats["launches"] += 1
        return out

    cuda_segment._segment_sum = recorded
    run.annotations.append(SEGMENT_SUM)
    run.probes[SEGMENT_SUM] = stats


def mean_span_ms(run, name: str) -> Optional[float]:
    ms = run.span_ms(name)
    return sum(ms) / len(ms) if ms and run.cuda else None


def _peaks(run):
    if not run.cuda:
        return None
    import torch

    from ..costs import peaks
    return peaks.lookup(torch.cuda.get_device_name(run.device))


def roofline_pct(run) -> Optional[float]:
    """The segment-sum launches' share of their memory roofline in the
    traced sub-window: their bytes over the peak bandwidth, over the
    device time of the kernels they launched."""
    stats, ts, peak = run.probes.get(SEGMENT_SUM), run.trace_summary, \
        _peaks(run)
    if not stats or ts is None or peak is None or not stats["launches"]:
        return None
    device_s = ts.annotated_s.get(SEGMENT_SUM, 0.0)
    if device_s <= 0:
        return None
    return 100.0 * stats["bytes"] / peak["hbm_bytes_per_s"] / device_s


def mfu_pct(run, flops_per_unit: float) -> Optional[float]:
    """The window's FLOPs (the configuration's count, a unit's times the
    units completed) over its host-clock length times the bf16 peak."""
    peak, w = _peaks(run), run.window
    if peak is None or w.units == 0 or w.seconds <= 0:
        return None
    return 100.0 * flops_per_unit * w.units / w.seconds / peak["bf16_flops"]


def mfu_latency_pct(run, flops_per_request: float) -> Optional[float]:
    """A request's FLOPs over the window's median latency times the bf16
    peak."""
    peak, lat = _peaks(run), sorted(run.window.latencies_s)
    if peak is None or not lat:
        return None
    return 100.0 * flops_per_request / lat[len(lat) // 2] / peak["bf16_flops"]


def idle_pct(run) -> Optional[float]:
    ts = run.trace_summary
    if ts is None or not run.cuda or ts.window_s <= 0:
        return None
    return 100.0 * (1.0 - ts.busy_s / ts.window_s)
