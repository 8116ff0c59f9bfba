"""The 90th percentile (linear interpolation) of every request's latency
in the window, from the input window on the host to the forecast on the
host."""

import numpy as np


def read(run):
    lat = run.window.latencies_s
    return float(np.percentile(lat, 90)) * 1e3 if lat else None
