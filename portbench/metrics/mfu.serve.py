"""The window's forecast FLOPs (``costs.flops``: the configuration's
count, never the route's) over its length times the bf16 peak."""

from portbench.costs import flops
from portbench.harness import probes


def read(run):
    t = run.traffic
    return probes.mfu_pct(run, flops.serve_flops(
        run.config, t["rollouts_per_dispatch"], t["ar_steps"]))
