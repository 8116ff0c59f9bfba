"""Device ms of one processor forward (CUDA events around the serve
copy's ``processor`` block), mean over the window's forwards."""

from portbench.harness import probes


def install(run):
    probes.module_span(run, run.system.model.processor, "processor")


def read(run):
    return probes.mean_span_ms(run, "processor")
