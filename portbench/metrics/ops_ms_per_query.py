"""Self time of the spans around calls into `arrowtpu_torch.ops`, per query
(the operators less their row-format children), from the window of spans."""

SPANS = "arrowtpu_torch.ops"


def read(t):
    return t.span_ms[SPANS] / t.span_queries if t.span_count[SPANS] \
        else None
