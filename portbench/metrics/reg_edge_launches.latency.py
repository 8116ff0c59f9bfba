"""Launches of the program's reg-edge step kernel (``ops.reg_edge``'s
``launches`` counter) a request, mean over the window's requests: one a
processor step of every forward while the kernel serves the reg-block
route.  A program without the counter reads nothing.  The batched serve's
``reg_edge_launches.serve`` takes this reader over its unit, a dispatch."""

KEY = "gclt.reg_edge_launches"


def install(run):
    """Wrap the driver's unit: each unit of the window records the
    counter's rise (the profiled units after the window are left out)."""
    if KEY in run.probes:
        return
    try:
        from graphcast_lite_torch.ops import reg_edge
    except ImportError:
        return
    if not hasattr(reg_edge, "launches"):
        return
    driver, counts = run.system, []
    unit = driver.unit

    def counted():
        before = reg_edge.launches
        out = unit()
        if not run.profiling:
            counts.append(reg_edge.launches - before)
        return out

    driver.unit = counted
    run.probes[KEY] = counts


def read(run):
    counts = run.probes.get(KEY)
    if not counts or not run.cuda:
        return None
    return sum(counts) / len(counts)
