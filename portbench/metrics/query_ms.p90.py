"""The 90th percentile (linear between order statistics) of every query
completed in the window, each timed from its call to its return and the
synchronize that follows, by CUDA events on the stream (the device is idle
at the call, so the first event marks it)."""

import numpy as np


def read(w):
    return float(np.percentile(w.latencies_ms, 90)) if w.latencies_ms \
        else None
