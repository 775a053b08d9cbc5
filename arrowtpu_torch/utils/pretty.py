"""Human-readable table formatting.

Counterpart of `arrowtpu/utils/pretty.py`: `pretty_format_batches` draws
the +---+ ASCII grid of the Arrow ecosystem, cell text as the JAX package
writes it (None empty, booleans true / false, bytes in hex, floats by
repr)."""

from __future__ import annotations

from typing import List

from ..core import batch as bt


def _fmt(v) -> str:
    if v is None:
        return ""
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, bytes):
        return v.hex()
    if isinstance(v, float):
        return repr(v)
    return str(v)


def pretty_format_batches(batches, max_rows: int = 100) -> str:
    if isinstance(batches, bt.RecordBatch):
        batches = [batches]
    if not batches:
        return "(no batches)"
    names = batches[0].schema.names
    rows: List[List[str]] = []
    for b in batches:
        for tup in zip(*(c.to_pylist() for c in b.columns)):
            if len(rows) >= max_rows:
                break
            rows.append([_fmt(v) for v in tup])
    widths = [max([len(n)] + [len(r[i]) for r in rows])
              for i, n in enumerate(names)]
    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"

    def line(cells):
        return "| " + " | ".join(c.ljust(w) for c, w in zip(cells, widths)) \
            + " |"
    return "\n".join([sep, line(names), sep] + [line(r) for r in rows]
                     + [sep])


def print_batches(batches, max_rows: int = 100):
    print(pretty_format_batches(batches, max_rows))
