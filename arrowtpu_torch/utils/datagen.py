"""Seeded random columns and batches for benches and fuzz tests.

Counterpart of `arrowtpu/utils/datagen.py`: for one seed (one numpy
Generator) every function draws the JAX package's values in its order;
the columns are built on `device` (None: the card)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from .. import schema as st
from ..core import batch as bt
from ..core import column as col


def seedable_rng(seed: int = 42) -> np.random.Generator:
    return np.random.default_rng(seed)


def _validity(rng, n: int, null_density: float):
    if null_density <= 0:
        return None
    return rng.random(n) >= null_density


def create_primitive_column(
        size: int, null_density: float = 0.0, dtype: st.DataType = st.int64,
        rng: Optional[np.random.Generator] = None,
        device=None) -> col.Column:
    """Floats standard normal, booleans fair coins, integers uniform over
    the type's range within +-2**53; 0 under a null."""
    rng = rng or seedable_rng()
    valid = _validity(rng, size, null_density)
    if isinstance(dtype, st.Boolean):
        return col.boolean(rng.random(size) < 0.5, validity=valid,
                           device=device)
    npdt = col.numpy_dtype(dtype)
    if isinstance(dtype, st.Float):
        vals = rng.standard_normal(size).astype(npdt)
    else:
        info = np.iinfo(npdt)
        vals = rng.integers(max(info.min, -(2**53)), min(info.max, 2**53),
                            size).astype(npdt)
    if valid is not None:
        vals = np.where(valid, vals, np.zeros(1, vals.dtype))
    return col.primitive(vals, dtype, validity=valid, device=device)


def create_string_column(
        size: int, null_density: float = 0.0, max_len: int = 20,
        rng: Optional[np.random.Generator] = None,
        device=None) -> col.StringViewColumn:
    """Lower-case strings of 0 to max_len letters."""
    rng = rng or seedable_rng()
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    out = []
    for _ in range(size):
        if null_density and rng.random() < null_density:
            out.append(None)
        else:
            out.append("".join(rng.choice(letters,
                                          int(rng.integers(0, max_len + 1)))))
    return col.string_view(out, device=device)


def create_dict_column(
        size: int, cardinality: int = 16, null_density: float = 0.0,
        rng: Optional[np.random.Generator] = None,
        device=None) -> col.DictionaryColumn:
    """Keys into `cardinality` words "value-0000", ..."""
    rng = rng or seedable_rng()
    values = [f"value-{i:04d}" for i in range(cardinality)]
    data = [None if (null_density and rng.random() < null_density)
            else values[int(rng.integers(0, cardinality))]
            for _ in range(size)]
    return col.dictionary_encode_host(data, st.Dictionary(st.int32, st.utf8),
                                      device)


def create_random_batch(
        size: int, null_density: float = 0.1,
        rng: Optional[np.random.Generator] = None,
        device=None) -> bt.RecordBatch:
    """int64, int32, float64, bool, utf8 and dictionary columns."""
    rng = rng or seedable_rng()
    return bt.RecordBatch(
        st.Schema((st.Field("i64", st.int64), st.Field("i32", st.int32),
                   st.Field("f64", st.float64), st.Field("b", st.bool_),
                   st.Field("s", st.utf8),
                   st.Field("d", st.Dictionary(st.int32, st.utf8)))),
        (create_primitive_column(size, null_density, st.int64, rng, device),
         create_primitive_column(size, null_density, st.int32, rng, device),
         create_primitive_column(size, null_density, st.float64, rng, device),
         create_primitive_column(size, null_density, st.bool_, rng, device),
         create_string_column(size, null_density, rng=rng, device=device),
         create_dict_column(size, null_density=null_density, rng=rng,
                            device=device)))
