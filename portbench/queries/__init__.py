"""The query kinds a mix can name, one module each.

A module gives: `TABLES`, the tables it reads (their rows are its input
rows, and a cell draws the tables its queries read); `run(entry, tables,
params)`, the timed call into the program, over the cell's batches by
table; `light(out)`, what is kept of every output; `SAMPLE`, how many
whole outputs a run keeps (drawn from the seed; None keeps all); `read(out)`,
an output (or its light part) in the form of the reference's answer;
`reference(arrays, params, device, control)`, the plain reference's answer
over the cell's arrays by table (under `portbench/reference/`); `compare(got, want)`, the numbers compared;
`LIMITS`, each number's limit.  The helpers below read the program's
string views as bytes, by the Arrow view layout, without its code.
"""

from __future__ import annotations

import torch


def views_matrix(c, n: int, width: int):
    """A string view column's first n rows -> ((n, width) uint8 bytes, zero
    past each length; (n,) int64 lengths), on the column's device.  A view
    is [length, first 4 bytes, buffer, offset] as int32 words; a string of
    at most 12 bytes lies inline in bytes 4..15 of the view."""
    views = c.views[:n]
    length = views[:, 0].to(torch.int64)
    raw = views.contiguous().view(torch.uint8).reshape(n, 16)
    j = torch.arange(width, device=views.device)
    inline = raw[:, 4:16]
    if width > 12:
        inline = torch.nn.functional.pad(inline, (0, width - 12))
    else:
        inline = inline[:, :width]
    arena = c.arena
    at = (views[:, 3].to(torch.int64)[:, None] + j).clamp_(
        0, max(arena.shape[0] - 1, 0))
    outline = arena[at] if arena.shape[0] else torch.zeros_like(inline)
    matrix = torch.where((length <= 12)[:, None], inline, outline)
    return torch.where(j < length[:, None], matrix, 0).to(torch.uint8), length


def read_views(c, n: int) -> list:
    """A string view column's first n rows as Python bytes."""
    width = int(c.views[:n, 0].max()) if n else 0
    matrix, length = views_matrix(c, n, max(width, 1))
    return [bytes(row[:k]) for row, k in zip(matrix.cpu().tolist(),
                                             length.tolist())]
