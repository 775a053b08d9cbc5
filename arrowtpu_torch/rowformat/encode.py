"""Order-preserving key encoding: columns -> int64 comparison planes.

Counterpart of `arrowtpu/rowformat/encode.py`.  Each column encodes to a
sentinel plane (null/valid, ordered per `nulls_first`) followed by its
value planes; comparing rows by the plane sequence lexicographically, as
signed int64, gives the SortOptions order.  Null rows zero their value
planes, so all nulls tie and keep their row order.

  * integers (temporal types included) and booleans: one plane, the
    value; native int64 values and the float total-order key
    (`float_key`) are one plane each (the JAX package splits them into two
    u32 planes); the order and the ties are the same.  A uint64 plane is
    its bits with the top bit flipped (the JAX package's u32 planes flip
    no bit for uint64 and the sign bit for int64: the port's signed
    planes need the reverse); float16 takes its own 16-bit total-order key,
    which orders and ties as the JAX package's float32 planes of it
    (`_float_planes`) and keeps a NaN's payload through a decode on the
    card (whose float32 -> float16 conversion makes NaNs canonical); its
    hash plane is that float32 key;
  * a dictionary sorts by its values' ranks;
  * decimals: the JAX package's u32 planes of `core/limbs.sort_planes`
    (the top limb's sign bit flipped, then the limbs high to low);
  * fixed-size binary: each little-endian word byte-swapped, first word
    first (memcmp order);
  * string views: the byte matrix (ops/strings.py) as big-endian 4-byte
    words, then a length plane that orders strings equal up to trailing
    zero bytes.  `key_planes` / `hash_planes_of` take a width (bytes, a
    multiple of 16) for each string key, where several columns must give
    one string the same planes (a join's two sides, a partition's ranks);
    words past a string's bytes are 0.

The u32 planes hold the JAX package's plane values, in [0, 2**32).
`encode_columns_grouped` splits a long string key into a prefix of
`STRING_CHUNK_WORDS` word planes and refinement groups of as many, for the
rank-chained sort (rowformat/pack.py `sort_by_plane_groups`).

  * a struct: its own sentinel, then each child's full encoding (its
    sentinel and value planes, default options) in field order;
  * a list view of primitive elements: for each element j below
    `config.LIST_SORT_BOUND`, a present plane (the list has more than j
    elements), an element-valid plane and that element's planes (zero
    where absent or null), then a length plane.  Lists that differ only
    past the bound compare by their lengths, exactly as in the JAX
    package.  Other element classes raise ComputeError;
  * a null column is one zero plane and no sentinel.

`hash_planes_of` gives the JAX package's u32 key planes (ascending, nulls
first) of every class `encode_column` takes but struct and list view
(which raise: no join or partition takes them), for rowformat/hashing.py: a
plane that is signed here (integers, temporal types, the float key) is
rebased or split as the JAX package holds it; a null column is one zero
plane.  Intervals raise: the JAX package's plane of an interval is
(capacity, W), which its hash does not take as a key plane.  `key_planes`
gives a join both sets from one encoding.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from .. import schema as st
from ..config import LIST_SORT_BOUND, SortOptions
from ..core import column as col
from ..core import limbs as lb
from ..core import u64

_U32 = 0xFFFFFFFF

STRING_CHUNK_WORDS = 4


def float_key(values: torch.Tensor) -> torch.Tensor:
    """float32 / float64 values -> int64 whose signed order is Rust's
    `total_cmp` order: -NaN < -inf < ... < -0 < +0 < ... < +inf < +NaN.
    A negative float's bits below the sign are inverted, which reverses
    the order of magnitudes; the sign bit keeps negatives below positives.
    (The JAX package's total-order planes, `core/wide.py`
    f64_total_order_planes, are this key with the sign bit flipped, read
    as unsigned.)  float32 and float16 keys are their width's key,
    sign-extended."""
    if values.dtype == torch.float64:
        b = values.view(torch.int64)
        return b ^ ((b >> 63) & 0x7FFFFFFFFFFFFFFF)
    if values.dtype in _NARROW_FLOATS:
        bits, low = _NARROW_FLOATS[values.dtype]
        b = values.view(bits).to(torch.int64)
        return b ^ ((b >> 63) & low)
    raise st.ComputeError(f"float_key: {values.dtype} is not a float")


# a narrow float's bits as a signed integer, and the mask below its sign
_NARROW_FLOATS = {torch.float32: (torch.int32, 0x7FFFFFFF),
                  torch.float16: (torch.int16, 0x7FFF)}


def float_from_key(k: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The inverse of `float_key` (its own inverse on the bits; a narrow
    key is sign-extended, so bit 63 is its sign)."""
    if dtype == torch.float64:
        return (k ^ ((k >> 63) & 0x7FFFFFFFFFFFFFFF)).view(torch.float64)
    bits, low = _NARROW_FLOATS[dtype]
    return (k ^ ((k >> 63) & low)).to(bits).view(dtype)


def byteswap_words(words: torch.Tensor) -> torch.Tensor:
    """int32 little-endian words -> the u32 value of their bytes read
    big-endian, in int64."""
    u = lb.unsigned(words)
    return (((u & 0xFF) << 24) | ((u & 0xFF00) << 8)
            | ((u >> 8) & 0xFF00) | (u >> 24))


def _string_planes(c: col.StringViewColumn, width: Optional[int] = None
                   ) -> List[torch.Tensor]:
    """Big-endian word planes of the byte matrix (`width` bytes wide, by
    default the column's `max_byte_length`), then the length plane; a word
    past `len_bound` is zero on every row."""
    from ..ops.strings import byte_matrix, max_byte_length

    L = max_byte_length(c) if width is None else width
    mat, lens = byte_matrix(c, L)
    words = mat.view(torch.int32)  # (capacity, L / 4), little-endian
    used = L // 4 if c.len_bound is None else min(L // 4,
                                                  -(-c.len_bound // 4))
    return ([byteswap_words(words[:, k]) if k < used else
             torch.zeros(c.capacity, dtype=torch.int64, device=c.device)
             for k in range(L // 4)] + [lens.to(torch.int64)])


def _element_planes(child: col.Column, idx: torch.Tensor
                    ) -> List[torch.Tensor]:
    """The value planes of a list's primitive child at rows `idx`."""
    if (isinstance(child, col.PrimitiveColumn)
            and (child.values.dim() == 1
                 or st.decimal_limbs(child.dtype) is not None)):
        from ..ops.take import gather_rows

        return _value_planes(dataclasses.replace(
            child, values=gather_rows(child.values, idx), validity=None,
            length=idx.shape[0]))
    raise st.ComputeError("encode: list sort keys support primitive "
                          f"elements, not {child.dtype}")


def _list_planes(c: col.ListViewColumn) -> List[torch.Tensor]:
    """[present_j, element-valid_j, element j's planes] for j below
    LIST_SORT_BOUND, then the length plane (null rows count 0)."""
    child = c.child
    valid = c.valid_bool()
    starts = c.starts.to(torch.int64)
    sizes = torch.where(valid, c.sizes.to(torch.int64), 0)
    child_ok = child.valid_bool()
    last = max(child.capacity - 1, 0)
    planes: List[torch.Tensor] = []
    for j in range(LIST_SORT_BOUND):
        present = (sizes > j).to(torch.int64)
        idx = (starts + j).clamp(0, last)
        ok = present * child_ok[idx].to(torch.int64)
        planes += [present, ok] + [p * ok for p in _element_planes(child,
                                                                   idx)]
    return planes + [sizes]


def _value_planes(c: col.Column, width: Optional[int] = None
                  ) -> List[torch.Tensor]:
    if isinstance(c, col.StructColumn):
        return [p for ch in c.children for p in encode_column(ch)]
    if isinstance(c, col.ListViewColumn):
        return _list_planes(c)
    if isinstance(c, col.BooleanColumn):
        return [c.values_bool().to(torch.int64)]
    if isinstance(c, col.DictionaryColumn):
        if c.value_ranks is None:
            raise st.ComputeError("dictionary sort needs value_ranks (build "
                                  "the column with dictionary_encode_host)")
        keys = c.keys.values.to(torch.int64).clamp(0, c.values.capacity - 1)
        return [c.value_ranks.to(torch.int64)[keys]]
    if isinstance(c, col.StringViewColumn):
        return _string_planes(c, width)
    if isinstance(c, col.PrimitiveColumn):
        if st.decimal_limbs(c.dtype) is not None:
            return lb.order_planes(c.values)
        if isinstance(c.dtype, st.FixedSizeBinary):
            return [byteswap_words(c.values[:, j])
                    for j in range(c.values.shape[1])]
        if c.values.dim() == 1 and c.values.dtype.is_floating_point:
            return [float_key(c.values)]
        if st.is_u64(c.dtype):
            return [u64.order_key(c.values)]
        if c.values.dim() == 1:
            return [c.values.to(torch.int64)]
    raise st.ComputeError(
        f"encode: unsupported sort key {type(c).__name__} {c.dtype}")


def encode_column(c: col.Column, opts: SortOptions = SortOptions()
                  ) -> List[torch.Tensor]:
    """[sentinel, value planes...] of one key column (a null column: one
    zero plane)."""
    if isinstance(c, col.NullColumn):
        return [torch.zeros(c.capacity, dtype=torch.int64, device=c.device)]
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


def _hash_value_planes(c: col.Column, planes: List[torch.Tensor]
                       ) -> List[torch.Tensor]:
    """The JAX package's u32 value planes of `c` from its `_value_planes`
    (before null masking): a 64-bit integer, temporal value or float key
    as `hi ^ 0x80000000, lo` (a uint64 plane's flipped top bit comes back
    unflipped: its `hi, lo`); a narrower signed one (the float32 key) as
    `value - min`; a float16 column as its float32 key's, as the JAX
    package converts it; every other plane (unsigned integers, booleans,
    dictionary ranks, decimal, fixed-size binary and string words, string
    lengths) already is one."""
    if not (isinstance(c, col.PrimitiveColumn) and c.values.dim() == 1):
        return planes
    (p,) = planes
    dt = c.values.dtype
    if dt in (torch.int64, torch.float64):
        return [((p >> 32) & _U32) ^ 0x80000000, p & _U32]
    if dt == torch.float16:  # the JAX package hashes its float32 key
        return [float_key(c.values.to(torch.float32)) + 2**31]
    if dt == torch.float32:
        return [p + 2**31]
    if dt.is_signed:
        return [p - torch.iinfo(dt).min]
    return [p]


def key_planes(columns: Sequence[col.Column],
               widths: Optional[Sequence[Optional[int]]] = None
               ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """-> (the value planes of `encode_column` with no sentinels, for
    equality; `hash_planes_of`), from one encoding of each column.
    `widths`, parallel to `columns`, sets a string key's byte-matrix width
    (None: the column's own)."""
    widths = [None] * len(columns) if widths is None else widths
    eq: List[torch.Tensor] = []
    hashed: List[torch.Tensor] = []
    for c, w in zip(columns, widths):
        if isinstance(c, col.NullColumn):  # one zero plane, no sentinel
            zero = torch.zeros(c.capacity, dtype=torch.int64, device=c.device)
            eq.append(zero)
            hashed.append(zero)
            continue
        if isinstance(c, (col.StructColumn, col.ListViewColumn)) or (
                isinstance(c, col.PrimitiveColumn)
                and isinstance(c.dtype, st.Interval)):
            raise st.ComputeError(
                f"hash: unsupported key {type(c).__name__} {c.dtype}")
        raw = _value_planes(c, w)
        valid = c.valid_bool().to(torch.int64)
        eq.extend(p * valid for p in raw)
        hashed.append(valid)
        hashed.extend(p * valid for p in _hash_value_planes(c, raw))
    return eq, hashed


def hash_planes_of(columns: Sequence[col.Column],
                   widths: Optional[Sequence[Optional[int]]] = None
                   ) -> List[torch.Tensor]:
    """The JAX package's u32 key planes of `columns` (ascending, nulls
    first), as int64 tensors holding values in [0, 2**32): what
    rowformat/hashing.py hashes, so that a key hashes as it does there.
    Per column: the sentinel plane (1 valid, 0 null), then its value
    planes (`_hash_value_planes`), zero on null rows; a null column is one
    zero plane.  `widths` as in `key_planes`."""
    return key_planes(columns, widths)[1]
