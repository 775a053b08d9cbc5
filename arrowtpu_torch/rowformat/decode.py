"""Row-format decode: key planes -> columns (the convert_rows round trip).

Counterpart of `arrowtpu/rowformat/decode.py`.  Every transform of
rowformat/encode.py has an exact inverse:

  * the sentinel plane -> validity (per `nulls_first`);
  * descending -> a NOT of the value planes (self-inverse on valid rows);
  * integers, temporal types and booleans -> the value itself (uint64's
    top bit flipped back);
  * floats -> `encode.float_key` inverted bit for bit (it is its own
    inverse on the bits), NaN payloads and -0 included;
  * decimals -> their limbs from the order planes (`limbs.from_order_planes`;
    the JAX package's decoder has no decimal branch and raises);
  * fixed-size binary -> each word byte-swapped back;
  * strings -> the big-endian word planes and the length plane rebuild the
    byte matrix (`ops.strings.from_byte_matrix`, whose `len_bound` is the
    matrix width, as in the JAX package);
  * dictionaries -> the rank plane through the rank -> value-index
    inverse, keys over the same dictionary; a padding entry of
    `value_ranks` (rank 0) contests rank 0 and the least index wins, as in
    the JAX package.

Null rows decode to zero values (a dictionary's to key 0), rows past the
length to zero with validity 0; the output always carries a bitmap.
Struct, list-view and interval columns raise ComputeError.

`RowConverter` pairs the two directions and keeps what the inverse needs
(each column's dtype, options, string width, dictionary), as the reference
RowConverter's field state does.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from .. import schema as st
from ..config import SortOptions
from ..core import bitmap as bm
from ..core import column as col
from ..core import limbs as lb
from ..core import u64
from . import encode as rf


@dataclasses.dataclass
class _Codec:
    # null | bool | int | u64 | float | decimal | fsb | string | dict
    kind: str
    dtype: st.DataType
    n_planes: int  # value planes (the sentinel aside)
    opts: SortOptions
    torch_dtype: Optional[torch.dtype] = None
    width: int = 0  # a string's matrix bytes, a fixed-size binary's words
    dictionary: Optional[col.DictionaryColumn] = None


def _codec_for(c: col.Column, opts: SortOptions) -> _Codec:
    if isinstance(c, col.NullColumn):
        return _Codec("null", c.dtype, 0, opts)
    if isinstance(c, col.DictionaryColumn):
        return _Codec("dict", c.dtype, 1, opts, dictionary=c)
    if isinstance(c, col.BooleanColumn):
        return _Codec("bool", c.dtype, 1, opts)
    if isinstance(c, col.StringViewColumn):
        from ..ops.strings import max_byte_length

        L = max_byte_length(c)
        return _Codec("string", c.dtype, L // 4 + 1, opts, width=L)
    if isinstance(c, col.PrimitiveColumn):
        nl = st.decimal_limbs(c.dtype)
        if nl is not None:
            return _Codec("decimal", c.dtype, nl, opts)
        if isinstance(c.dtype, st.FixedSizeBinary):
            w = c.values.shape[1]
            return _Codec("fsb", c.dtype, w, opts, width=w)
        if c.values.dim() == 1:
            kind = ("float" if c.values.dtype.is_floating_point else
                    "u64" if st.is_u64(c.dtype) else "int")
            return _Codec(kind, c.dtype, 1, opts, torch_dtype=c.values.dtype)
    raise st.ComputeError(
        f"row decode: unsupported column {type(c).__name__} {c.dtype}")


_SIGNED = {torch.uint16: torch.int16, torch.uint32: torch.int32}


def _n_planes(codec: _Codec) -> int:
    # a null column is one zero plane with no sentinel
    return 1 if codec.kind == "null" else 1 + codec.n_planes


def _string(vp: List[torch.Tensor], codec: _Codec, validity, length: int,
            valid: torch.Tensor) -> col.StringViewColumn:
    from ..ops.strings import from_byte_matrix

    cap = vp[0].shape[0]
    words = torch.stack([rf.byteswap_words(p.to(torch.int32))
                         for p in vp[:-1]], dim=1).to(torch.int32)
    mat = words.contiguous().view(torch.uint8).reshape(cap, codec.width)
    lens = torch.where(valid, vp[-1], 0)
    return from_byte_matrix(mat, lens, validity, length, codec.dtype)


def _dict_keys(codec: _Codec, rank: torch.Tensor) -> torch.Tensor:
    """Key of each rank: the least value index holding it."""
    d = codec.dictionary
    ranks = d.value_ranks.to(torch.int64)
    nvals = ranks.shape[0]
    inverse = torch.full((nvals,), nvals - 1, dtype=torch.int64,
                         device=ranks.device).scatter_reduce(
        0, ranks.clamp(0, nvals - 1),
        torch.arange(nvals, device=ranks.device), "amin")
    return inverse[rank.clamp(0, nvals - 1)]


def _decode_one(codec: _Codec, planes: List[torch.Tensor],
                length: int) -> col.Column:
    cap = planes[0].shape[0]
    device = planes[0].device
    if codec.kind == "null":
        return col.NullColumn(length, cap, device)
    opts = codec.opts
    live = bm.row_mask_bool(cap, length, device)
    valid = (planes[0] == (1 if opts.nulls_first else 0)) & live
    vi = valid.to(torch.int64)
    vp = [~p * vi if opts.descending else p * vi for p in planes[1:]]
    validity = bm.pack(valid)
    if codec.kind == "bool":
        return col.BooleanColumn(bm.pack(vp[0] != 0), validity, length)
    if codec.kind == "int":
        # uint16 / uint32 through their signed twins: a copy into them
        # keeps the low bits on every backend
        signed = _SIGNED.get(codec.torch_dtype)
        values = (vp[0].to(codec.torch_dtype) if signed is None
                  else vp[0].to(signed).view(codec.torch_dtype))
        return col.PrimitiveColumn(values, validity, length, codec.dtype)
    if codec.kind == "u64":
        return col.PrimitiveColumn(
            torch.where(valid, u64.order_key(vp[0]), 0), validity, length,
            codec.dtype)
    if codec.kind == "float":
        f = rf.float_from_key(vp[0], codec.torch_dtype)
        return col.PrimitiveColumn(torch.where(valid, f, 0.0), validity,
                                   length, codec.dtype)
    if codec.kind == "decimal":
        limbs = torch.where(valid[:, None], lb.from_order_planes(vp), 0)
        return col.PrimitiveColumn(limbs, validity, length, codec.dtype)
    if codec.kind == "fsb":
        words = torch.stack([rf.byteswap_words(p.to(torch.int32))
                             for p in vp], dim=1).to(torch.int32)
        return col.PrimitiveColumn(words, validity, length, codec.dtype)
    if codec.kind == "string":
        return _string(vp, codec, validity, length, valid)
    d = codec.dictionary  # "dict"
    keys = torch.where(valid, _dict_keys(codec, vp[0]), 0)
    return col.DictionaryColumn(
        col.PrimitiveColumn(keys.to(d.keys.values.dtype), validity, length,
                            d.keys.dtype), d.values, d.value_ranks, d.dtype)


class RowConverter:
    """Two-way row-format conversion (the reference's RowConverter):
    `convert_columns(columns)` -> the key planes of `encode_columns` under
    the converter's options; `convert_rows(planes, length)` -> the
    columns back.  The first call records each column's codec."""

    def __init__(self, options: Optional[Sequence[SortOptions]] = None):
        self.options = options
        self.codecs: Optional[List[_Codec]] = None

    def convert_columns(self, columns: Sequence[col.Column]
                        ) -> List[torch.Tensor]:
        opts = (list(self.options) if self.options is not None
                else [SortOptions()] * len(columns))
        self.codecs = [_codec_for(c, o) for c, o in zip(columns, opts)]
        return rf.encode_columns(columns, opts)

    def convert_rows(self, planes: Sequence[torch.Tensor], length: int
                     ) -> List[col.Column]:
        if self.codecs is None:
            raise st.ComputeError("convert_rows before convert_columns")
        expected = sum(_n_planes(c) for c in self.codecs)
        if len(planes) != expected:
            raise st.ComputeError(
                f"convert_rows: {len(planes)} planes, expected {expected}")
        out, i = [], 0
        for codec in self.codecs:
            n = _n_planes(codec)
            out.append(_decode_one(codec, list(planes[i:i + n]), length))
            i += n
        return out
