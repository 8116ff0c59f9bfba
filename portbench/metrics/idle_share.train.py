"""The device's idle share of the traced sub-window: 1 - (union of device
operations) / (its wall time), from the profiler's trace."""

from portbench.harness import probes


def read(run):
    return probes.idle_pct(run)
