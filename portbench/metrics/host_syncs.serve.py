"""Host-device stream synchronizations a dispatch inside the program's
``rollout`` span and the spans under it (the program's counter: PyTorch's
sync debug mode), mean over the window's dispatches."""

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
    return sum(s.syncs for tree in trees for s in tree) / len(trees)
