"""The share of the traced queries' time in which no kernel, copy or memset
ran on the device, in %."""


def read(t):
    return 100.0 * (1 - t.trace.busy_s / t.trace.window_s) \
        if t.trace.window_s > 0 else None
