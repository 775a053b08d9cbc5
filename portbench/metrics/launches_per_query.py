"""Kernels the profiler saw in the traced queries, per query."""


def read(t):
    return t.trace.kernels / t.queries if t.queries and t.trace.kernels \
        else None
