"""Device ms of the encoder block a forward: the program's
``model.encoder`` span (CUDA events), mean over the window's requests'
forwards."""

KEY = "gclt.tracing"
SPAN = "model.encoder"


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
    ms = [s.device_ms for tree in trees or () for s in tree
          if s.name == SPAN]
    return sum(ms) / len(ms) if ms else None
