"""Device ms of a request's ``rollout`` span (the program's, CUDA events)
less the ``model`` spans directly under it: the rollout loop's own work
(carry-forward, concatenation, stacking) and the device's idle time
between the AR steps' forwards that the host caused, mean over the
window's requests."""

KEY = "gclt.tracing"


def install(run):
    try:
        from graphcast_lite_torch import tracing
    except ImportError:      # a program without spans: nothing to read
        return
    rec = tracing.enable(cuda_events=run.cuda)
    run.probes.setdefault(KEY, (rec, len(rec.spans)))


def _window(run):
    """The window's units: the trees of the first ``attempted`` root spans
    recorded after install (warm-up came before it, the profiled units
    come after them); recording ends here.  None off the card."""
    if KEY not in run.probes:
        return None
    from graphcast_lite_torch import tracing
    tracing.disable()
    rec, start = run.probes[KEY]
    return rec.trees(start, run.window.attempted) if run.cuda else None


def read(run):
    trees = _window(run)
    if not trees:
        return None
    own = []
    for root, *spans in trees:
        own.append(root.device_ms - sum(
            s.device_ms for s in spans
            if s.parent == root.index and s.name == "model"))
    return sum(own) / len(own)
