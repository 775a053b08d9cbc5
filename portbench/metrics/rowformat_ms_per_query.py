"""Self time of the spans around calls into `arrowtpu_torch.rowformat`, per
query (encode, pack, sort), from the window of spans."""

SPANS = "arrowtpu_torch.rowformat"


def read(t):
    return t.span_ms[SPANS] / t.span_queries if t.span_count[SPANS] \
        else None
