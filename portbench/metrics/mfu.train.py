"""The window's training FLOPs (``costs.flops``: three forwards a
forward, recomputation not counted) over its length times the bf16
peak."""

from portbench.costs import flops
from portbench.harness import probes


def read(run):
    t = run.traffic
    return probes.mfu_pct(run, flops.train_flops(
        run.config, t["batch"], t["ar_steps"]))
