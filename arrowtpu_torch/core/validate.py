"""Validation of untrusted column data, on the columns' device.

Counterpart of `arrowtpu/core/validate.py`, after arrow-rs's
`ArrayData::validate_full` (arrow-data/src/data.rs:1388: the structural
checks, the dictionary key bounds and the UTF-8 check of
`validate_values`, :1495), which arrow-rs's IPC reader runs on input it
does not trust.  `validate_column` returns {check: 0-d bool tensor, True =
violation} with no read-back; `check_column` / `check_batch` stack every
flag of the call, read them back in one transfer and raise
`schema.ValidationError` naming those set.  The flags, their names and
their `child.` / `childN.` prefixes are the JAX package's:

  * `length_exceeds_capacity`;
  * a dictionary's `dict_key_out_of_bounds` (a valid key outside [0,
    dictionary length));
  * a string view's `view_out_of_bounds` (a string of more than 12 bytes
    reaching past the arena) and `negative_length`, and for Utf8 (never
    binary) `invalid_utf8`;
  * a list view's `list_view_out_of_bounds`, then its child's flags;
  * a struct's children's flags.

A view's length is Arrow's signed int32 here, so a length with its top
bit set is a `negative_length`; the JAX package reads it as uint32 (ROADMAP
C.3).  The UTF-8 check runs over `ops.strings.byte_matrix` in chunks of
rows of at most `UTF8_CHUNK_BYTES` matrix bytes, in uint8 and bool, so its
working memory stays near a dozen such chunks whatever the row count.  It
leaves out the rows already flagged as out of bounds or negative, whose
untrusted lengths would otherwise set the matrix's width.
"""

from __future__ import annotations

from typing import Dict

import torch

from .. import schema as st
from . import batch as bt
from . import column as col

# bytes of the (rows, L) byte matrix the UTF-8 check holds at a time; its
# bool temporaries are the same size, about a dozen of them at the peak
UTF8_CHUNK_BYTES = 1 << 26


def _shift(x: torch.Tensor, k: int) -> torch.Tensor:
    """x moved k positions right along the byte axis, zeros shifted in."""
    out = torch.zeros_like(x)
    if k < x.shape[1]:
        out[:, k:] = x[:, :x.shape[1] - k]
    return out


def _utf8_invalid(mat: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """(rows, L) uint8 byte matrix, (rows,) lengths -> (rows,) bool, True
    where the first lens[i] bytes of row i are not UTF-8.

    The JAX package's shifted-mask form of the DFA (arrow-rs calls
    `str::from_utf8`): each byte classified as ASCII, continuation or a 2-,
    3- or 4-byte lead; a byte is a continuation exactly when a lead k
    positions back asks for one; the overlong, surrogate and too-large
    (lead, next byte) pairs; a lead whose span crosses the end."""
    L = mat.shape[1]
    j = torch.arange(L, dtype=torch.int32, device=mat.device)
    lens = lens.to(torch.int32)[:, None]
    inb = j < lens
    b = torch.where(inb, mat, 0)
    cont = (b & 0xC0) == 0x80
    lead2 = (b & 0xE0) == 0xC0
    lead3 = (b & 0xF0) == 0xE0
    lead4 = (b & 0xF8) == 0xF0
    bad = ~((b < 0x80) | cont | lead2 | lead3 | lead4)
    lead34 = lead3 | lead4
    need = _shift(lead2 | lead34, 1)
    need |= _shift(lead34, 2)
    need |= _shift(lead4, 3)
    bad |= need != cont
    del need, lead34
    nxt = torch.zeros_like(b)
    nxt[:, :L - 1] = b[:, 1:]
    bad |= lead2 & (b < 0xC2)
    bad |= lead3 & (b == 0xE0) & (nxt < 0xA0)
    bad |= lead3 & (b == 0xED) & (nxt >= 0xA0)
    bad |= lead4 & (b == 0xF0) & (nxt < 0x90)
    bad |= lead4 & ((b > 0xF4) | ((b == 0xF4) & (nxt >= 0x90)))
    bad |= lead2 & (j + 2 > lens)
    bad |= lead3 & (j + 3 > lens)
    bad |= lead4 & (j + 4 > lens)
    return (bad & inb).any(dim=1)


def utf8_invalid_rows(c: col.StringViewColumn, ok: torch.Tensor
                      ) -> torch.Tensor:
    """(capacity,) bool: row i is in `ok` and its bytes are not UTF-8;
    the byte matrix built a chunk of rows at a time.  Rows left out of
    `ok` (a view outside the arena, a negative length) do not set the
    matrix width, so an untrusted length cannot make it large."""
    from ..ops.strings import byte_matrix, matrix_width

    bound = c.len_bound
    if bound is None or bound > max(12, c.arena.shape[0]):
        # a checked row's length is at most the arena's size or 12
        bound = int(torch.where(ok, c.views[:, 0], 0).max()
                    ) if c.capacity else 0
    L = matrix_width(bound)
    step = max(1, UTF8_CHUNK_BYTES // L)
    bad = torch.zeros(c.capacity, dtype=torch.bool, device=c.device)
    for i in range(0, c.capacity, step):
        part = col.StringViewColumn(c.views[i:i + step], c.arena, None,
                                    min(step, c.capacity - i), c.dtype,
                                    bound)
        mat, plens = byte_matrix(part, L)
        rows = ok[i:i + step]
        bad[i:i + step] = _utf8_invalid(mat, torch.where(rows, plens, 0)
                                        ) & rows
    return bad


def _flag(x, device) -> torch.Tensor:
    return torch.full((), bool(x), dtype=torch.bool, device=device)


def validate_column(c: col.Column, *, full: bool = True
                    ) -> Dict[str, torch.Tensor]:
    """{check name: 0-d bool tensor, True = violation}, no read-back.
    `full=False` skips the UTF-8 check and the children."""
    dev = c.device
    flags: Dict[str, torch.Tensor] = {
        "length_exceeds_capacity": _flag(c.length > c.capacity, dev)}
    if isinstance(c, col.NullColumn):
        return flags
    if isinstance(c, col.DictionaryColumn):
        keys = c.keys.values.to(torch.int64)
        flags["dict_key_out_of_bounds"] = (
            c.keys.valid_bool() & ((keys < 0) | (keys >= c.values.length))
        ).any()
        return flags
    if isinstance(c, col.StringViewColumn):
        ok = c.valid_bool()
        lens = c.views[:, 0].to(torch.int64)
        offs = c.views[:, 3].to(torch.int64) & 0xFFFFFFFF
        oob = (lens > 12) & (offs + lens > c.arena.shape[0])
        flags["view_out_of_bounds"] = (ok & oob).any()
        flags["negative_length"] = (ok & (lens < 0)).any()
        if full and isinstance(c.dtype, st.Utf8):
            flags["invalid_utf8"] = utf8_invalid_rows(
                c, ok & (lens >= 0) & ~oob).any()
        return flags
    if isinstance(c, col.ListViewColumn):
        ok = c.valid_bool()
        starts = c.starts.to(torch.int64)
        sizes = c.sizes.to(torch.int64)
        flags["list_view_out_of_bounds"] = (ok & (
            (starts < 0) | (sizes < 0) | (starts + sizes > c.child.capacity))
        ).any()
        if full:
            for k, v in validate_column(c.child, full=full).items():
                flags[f"child.{k}"] = v
        return flags
    if isinstance(c, col.StructColumn) and full:
        for i, ch in enumerate(c.children):
            for k, v in validate_column(ch, full=full).items():
                flags[f"child{i}.{k}"] = v
    return flags


def validate_batch(batch: bt.RecordBatch, *, full: bool = True
                   ) -> Dict[str, torch.Tensor]:
    """Every column's flags, each name prefixed by its field's."""
    flags: Dict[str, torch.Tensor] = {}
    for f, c in zip(batch.schema.fields, batch.columns):
        for k, v in validate_column(c, full=full).items():
            flags[f"{f.name}.{k}"] = v
    return flags


def check_column(c: col.Column, *, full: bool = True, name: str = "") -> None:
    """Raise ValidationError if any flag of `c` is set (one read-back)."""
    _raise_on(validate_column(c, full=full), name)


def check_batch(batch: bt.RecordBatch, *, full: bool = True) -> None:
    _raise_on(validate_batch(batch, full=full), "batch")


def _raise_on(flags: Dict[str, torch.Tensor], name: str) -> None:
    if not flags:
        return
    keys = list(flags)
    vals = torch.stack([flags[k] for k in keys]).cpu().tolist()
    bad = [k for k, v in zip(keys, vals) if v]
    if bad:
        where = f" in {name}" if name else ""
        raise st.ValidationError(
            f"invalid array data{where}: {', '.join(bad)}")
