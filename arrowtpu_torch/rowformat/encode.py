"""Order-preserving key encoding: columns -> int64 comparison planes.

Counterpart of `arrowtpu/rowformat/encode.py`.  Each column encodes to a
sentinel plane (null/valid, ordered per `nulls_first`) followed by its
value planes; comparing rows by the plane sequence lexicographically, as
signed int64, gives the SortOptions order.  Null rows zero their value
planes, so all nulls tie and keep their row order.

  * integers (temporal types included) and booleans: one plane, the
    value; native int64 values and the float total-order key
    (`float_key`) are one plane each (the JAX package splits them into two
    u32 planes); the order and the ties are the same;
  * a dictionary sorts by its values' ranks;
  * decimals: the JAX package's u32 planes of `core/limbs.sort_planes`
    (the top limb's sign bit flipped, then the limbs high to low);
  * fixed-size binary: each little-endian word byte-swapped, first word
    first (memcmp order);
  * string views: the byte matrix (ops/strings.py) as big-endian 4-byte
    words, then a length plane that orders strings equal up to trailing
    zero bytes.

The u32 planes hold the JAX package's plane values, in [0, 2**32).
`encode_columns_grouped` splits a long string key into a prefix of
`STRING_CHUNK_WORDS` word planes and refinement groups of as many, for the
rank-chained sort (rowformat/pack.py `sort_by_plane_groups`).  Struct and
list-view sort keys are not ported yet; they raise ComputeError.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from .. import schema as st
from ..config import SortOptions
from ..core import column as col
from ..core import limbs as lb

_U32 = 0xFFFFFFFF

STRING_CHUNK_WORDS = 4


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


def byteswap_words(words: torch.Tensor) -> torch.Tensor:
    """int32 little-endian words -> the u32 value of their bytes read
    big-endian, in int64."""
    u = lb.unsigned(words)
    return (((u & 0xFF) << 24) | ((u & 0xFF00) << 8)
            | ((u >> 8) & 0xFF00) | (u >> 24))


def _string_planes(c: col.StringViewColumn) -> List[torch.Tensor]:
    """Big-endian word planes of the byte matrix, then the length plane;
    a word past `len_bound` is zero on every row."""
    from ..ops.strings import byte_matrix, max_byte_length

    L = max_byte_length(c)
    mat, lens = byte_matrix(c, L)
    words = mat.view(torch.int32)  # (capacity, L / 4), little-endian
    used = L // 4 if c.len_bound is None else -(-c.len_bound // 4)
    return ([byteswap_words(words[:, k]) if k < used else
             torch.zeros(c.capacity, dtype=torch.int64, device=c.device)
             for k in range(L // 4)] + [lens.to(torch.int64)])


def _value_planes(c: col.Column) -> List[torch.Tensor]:
    if isinstance(c, col.BooleanColumn):
        return [c.values_bool().to(torch.int64)]
    if isinstance(c, col.DictionaryColumn):
        if c.value_ranks is None:
            raise st.ComputeError("dictionary sort needs value_ranks (build "
                                  "the column with dictionary_encode_host)")
        keys = c.keys.values.to(torch.int64).clamp(0, c.values.capacity - 1)
        return [c.value_ranks.to(torch.int64)[keys]]
    if isinstance(c, col.StringViewColumn):
        return _string_planes(c)
    if isinstance(c, col.PrimitiveColumn):
        if st.decimal_limbs(c.dtype) is not None:
            return lb.order_planes(c.values)
        if isinstance(c.dtype, st.FixedSizeBinary):
            return [byteswap_words(c.values[:, j])
                    for j in range(c.values.shape[1])]
        if c.values.dim() == 1 and c.values.dtype.is_floating_point:
            return [float_key(c.values)]
        if c.values.dim() == 1:
            return [c.values.to(torch.int64)]
    raise st.ComputeError(
        f"encode: unsupported sort key {type(c).__name__} {c.dtype}")


def encode_column(c: col.Column, opts: SortOptions = SortOptions()
                  ) -> List[torch.Tensor]:
    """[sentinel, value planes...] of one key column."""
    planes = _value_planes(c)
    valid = c.valid_bool().to(torch.int64)
    planes = [p * valid for p in planes]
    if opts.descending:
        # ~x = -x - 1 reverses the signed order
        planes = [~p * valid for p in planes]
    sentinel = valid if opts.nulls_first else 1 - valid
    return [sentinel] + planes


def encode_columns(columns: Sequence[col.Column],
                   options: Sequence[SortOptions] = None) -> List[torch.Tensor]:
    """Planes of several key columns; column 0 is most significant."""
    if options is None:
        options = [SortOptions()] * len(columns)
    planes: List[torch.Tensor] = []
    for c, o in zip(columns, options):
        planes.extend(encode_column(c, o))
    return planes


def encode_columns_grouped(columns: Sequence[col.Column],
                           options: Sequence[SortOptions] = None
                           ) -> List[List[torch.Tensor]]:
    """The key planes as groups for `pack.sort_by_plane_groups`: a string
    key longer than STRING_CHUNK_WORDS words contributes its sentinel and
    first STRING_CHUNK_WORDS word planes to the current group, then one
    group of as many planes at a time (its length plane last), so the
    first 16 bytes sort first and ties refine 16 bytes at a time.  Every
    other key stays whole in the current group."""
    chunk = STRING_CHUNK_WORDS
    if options is None:
        options = [SortOptions()] * len(columns)
    groups: List[List[torch.Tensor]] = [[]]
    for c, o in zip(columns, options):
        planes = encode_column(c, o)
        words = len(planes) - 2  # sentinel and length aside
        if isinstance(c, col.StringViewColumn) and words > chunk:
            groups[-1].extend(planes[:1 + chunk])
            rest = planes[1 + chunk:]
            for i in range(0, len(rest), chunk):
                groups.append(rest[i:i + chunk])
            continue
        groups[-1].extend(planes)
    return [g for g in groups if g] or [[]]


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
