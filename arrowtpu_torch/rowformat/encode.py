"""Order-preserving key encoding: columns -> int64 comparison planes.

Counterpart of `arrowtpu/rowformat/encode.py` for integer, boolean, float
and dictionary columns.  Each column encodes to a sentinel plane
(null/valid, ordered per `nulls_first`) followed by its value plane;
comparing rows by the plane sequence lexicographically, as signed int64,
gives the SortOptions order.  Null rows zero their value planes, so all
nulls tie and keep their row order.  Native int64 values and the float
total-order key (`float_key`) are one plane each (the JAX package splits
them into two u32 planes); the order and the ties are the same.  A
dictionary column sorts by its values' ranks.  String-view sort keys and
the grouped string encoding (`encode_columns_grouped`) are not ported yet.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from .. import schema as st
from ..config import SortOptions
from ..core import column as col


def float_key(values: torch.Tensor) -> torch.Tensor:
    """float32 / float64 values -> int64 whose signed order is Rust's
    `total_cmp` order: -NaN < -inf < ... < -0 < +0 < ... < +inf < +NaN.
    A negative float's bits below the sign are inverted, which reverses
    the order of magnitudes; the sign bit keeps negatives below positives.
    (The JAX package's total-order planes, `core/wide.py`
    f64_total_order_planes, are this key with the sign bit flipped, read
    as unsigned.)"""
    if values.dtype == torch.float64:
        b = values.view(torch.int64)
        return b ^ ((b >> 63) & 0x7FFFFFFFFFFFFFFF)
    if values.dtype == torch.float32:
        b = values.view(torch.int32).to(torch.int64)
        return b ^ ((b >> 31) & 0x7FFFFFFF)
    raise st.ComputeError(f"float_key: {values.dtype} is not float32/64")


def encode_column(c: col.Column, opts: SortOptions = SortOptions()
                  ) -> List[torch.Tensor]:
    if isinstance(c, col.BooleanColumn):
        value = c.values_bool().to(torch.int64)
    elif isinstance(c, col.PrimitiveColumn) and isinstance(c.dtype, st.Int):
        value = c.values.to(torch.int64)
    elif isinstance(c, col.PrimitiveColumn) and isinstance(c.dtype, st.Float):
        value = float_key(c.values)
    elif isinstance(c, col.DictionaryColumn):
        if c.value_ranks is None:
            raise st.ComputeError("dictionary sort needs value_ranks (build "
                                  "the column with dictionary_encode_host)")
        keys = c.keys.values.to(torch.int64).clamp(0, c.values.capacity - 1)
        value = c.value_ranks.to(torch.int64)[keys]
    elif isinstance(c, col.StringViewColumn):
        raise st.ComputeError("encode: string-view sort keys are not ported "
                              "yet (sort a dictionary column instead)")
    else:
        raise st.ComputeError(
            f"encode: unsupported sort key {type(c).__name__} {c.dtype}")
    valid = c.valid_bool().to(torch.int64)
    value = value * valid
    if opts.descending:
        value = ~value * valid  # ~x = -x - 1 reverses the signed order
    sentinel = valid if opts.nulls_first else 1 - valid
    return [sentinel, value]


def encode_columns(columns: Sequence[col.Column],
                   options: Sequence[SortOptions] = None) -> List[torch.Tensor]:
    """Planes of several key columns; column 0 is most significant."""
    if options is None:
        options = [SortOptions()] * len(columns)
    planes: List[torch.Tensor] = []
    for c, o in zip(columns, options):
        planes.extend(encode_column(c, o))
    return planes


_U32 = 0xFFFFFFFF


def hash_planes_of(columns: Sequence[col.Column]) -> List[torch.Tensor]:
    """The JAX package's u32 key planes of `columns` (ascending, nulls
    first), as int64 tensors holding values in [0, 2**32): what
    rowformat/hashing.py hashes, so that a key hashes as it does there.

    Per column: the sentinel plane (1 valid, 0 null), then for int64
    `hi ^ 0x80000000, lo`, for a narrower signed int `value - min`, for
    uint8 and bool the value; null rows zero their value planes."""
    planes: List[torch.Tensor] = []
    for c in columns:
        if isinstance(c, col.BooleanColumn):
            values = [c.values_bool().to(torch.int64)]
        elif (isinstance(c, col.PrimitiveColumn)
              and isinstance(c.dtype, st.Int)):
            v = c.values.to(torch.int64)
            if c.dtype.bits == 64:
                values = [((v >> 32) & _U32) ^ 0x80000000, v & _U32]
            elif c.dtype.signed:
                values = [v - torch.iinfo(c.values.dtype).min]
            else:
                values = [v]
        else:
            raise st.ComputeError(
                f"hash: unsupported key {type(c).__name__} {c.dtype}")
        valid = c.valid_bool().to(torch.int64)
        planes.append(valid)
        planes.extend(p * valid for p in values)
    return planes
