"""A forecast request's FLOPs (``costs.flops``: the configuration's
count, never the route's) over the window's median request latency times
the bf16 peak: the share of the chip's peak that one request gets."""

from portbench.costs import flops
from portbench.harness import probes


def read(run):
    t = run.traffic
    return probes.mfu_latency_pct(run, flops.serve_flops(
        run.config, t["rollouts_per_dispatch"], t["ar_steps"]))
