"""The segment-sum launches' share of their memory roofline in the traced
sub-window: bytes (each input and output once, from each launch's own
arguments) over 3.35 TB/s, over the profiler's device time of the kernels
those launches ran."""

from portbench.harness import probes


def install(run):
    probes.segment_sum_recorder(run)


def read(run):
    return probes.roofline_pct(run)
