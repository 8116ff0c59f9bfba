"""Device ms of one Adam step (CUDA events from the optimizer's step
hooks), mean over the window's steps."""

from portbench.harness import probes


def install(run):
    probes.optimizer_span(run, run.system.optimizer, "optimizer")


def read(run):
    return probes.mean_span_ms(run, "optimizer")
