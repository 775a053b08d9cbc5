"""Append builders: columns assembled a value at a time on the host.

Counterpart of `arrowtpu/core/builders.py`: `PrimitiveBuilder`,
`BooleanBuilder`, `StringBuilder`, `StringDictionaryBuilder` and
`RecordBatchBuilder`.  Appending has no vector shape, so it is host work:
values gather in amortized-growth numpy buffers (or Python lists), and
`finish()` builds one column on the builder's device (None: the card) and
resets the builder.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .. import schema as st
from ..config import resolve_device
from . import batch as bt
from . import column as col


class _Bits:
    """Append-only validity."""

    def __init__(self):
        self.bools: List[bool] = []
        self.any_null = False

    def append(self, valid: bool):
        self.bools.append(valid)
        self.any_null |= not valid

    def finish(self) -> Optional[np.ndarray]:
        return np.array(self.bools, dtype=bool) if self.any_null else None


class PrimitiveBuilder:
    """Fixed-width values of a type with one torch dtype (as in the JAX
    package, a decimal or interval raises: it has none), in a growing
    numpy buffer."""

    def __init__(self, dtype: st.DataType, capacity: int = 1024,
                 device=None):
        self.dtype = dtype
        self.device = device
        self._np_dtype = col.numpy_dtype(dtype)
        self._buf = np.zeros(max(capacity, 16), self._np_dtype)
        self._n = 0
        self._valid = _Bits()

    def _put(self, value):
        if self._n == len(self._buf):
            self._buf = np.concatenate(
                [self._buf, np.zeros(len(self._buf), self._np_dtype)])
        self._buf[self._n] = value
        self._n += 1

    def append(self, value):
        self._put(value)
        self._valid.append(True)

    def append_null(self):
        self._put(0)
        self._valid.append(False)

    def append_option(self, value):
        if value is None:
            self.append_null()
        else:
            self.append(value)

    def extend(self, values):
        for v in values:
            self.append_option(v)

    def __len__(self):
        return self._n

    def finish(self) -> col.PrimitiveColumn:
        out = col.primitive(self._buf[:self._n], self.dtype,
                            validity=self._valid.finish(), length=self._n,
                            device=resolve_device(self.device))
        self.__init__(self.dtype, device=self.device)
        return out


class BooleanBuilder:
    def __init__(self, device=None):
        self.device = device
        self._vals: List[bool] = []
        self._valid = _Bits()

    def append(self, value: bool):
        self._vals.append(bool(value))
        self._valid.append(True)

    def append_null(self):
        self._vals.append(False)
        self._valid.append(False)

    def append_option(self, value):
        self.append_null() if value is None else self.append(value)

    def __len__(self):
        return len(self._vals)

    def finish(self) -> col.BooleanColumn:
        out = col.boolean(np.array(self._vals, bool),
                          validity=self._valid.finish(),
                          length=len(self._vals),
                          device=resolve_device(self.device))
        self.__init__(self.device)
        return out


class StringBuilder:
    """Utf8 or Binary values into a string view column."""

    def __init__(self, dtype: st.DataType = st.utf8, device=None):
        self.dtype = dtype
        self.device = device
        self._vals: List[Optional[object]] = []

    def append(self, value):
        self._vals.append(value)

    def append_null(self):
        self._vals.append(None)

    append_option = append

    def __len__(self):
        return len(self._vals)

    def finish(self) -> col.StringViewColumn:
        out = col.string_view(self._vals, self.dtype,
                              resolve_device(self.device))
        self.__init__(self.dtype, self.device)
        return out


class StringDictionaryBuilder:
    """Interning dictionary builder: a value seen before costs one key."""

    def __init__(self, key_dtype: st.DataType = st.int32,
                 value_dtype: st.DataType = st.utf8, device=None):
        self.dtype = st.Dictionary(key_dtype, value_dtype)
        self.device = device
        self._intern: Dict[object, int] = {}
        self._values: List[object] = []
        self._keys: List[int] = []
        self._valid = _Bits()

    def append(self, value):
        k = self._intern.get(value)
        if k is None:
            k = self._intern[value] = len(self._values)
            self._values.append(value)
        self._keys.append(k)
        self._valid.append(True)

    def append_null(self):
        self._keys.append(0)
        self._valid.append(False)

    def append_option(self, value):
        self.append_null() if value is None else self.append(value)

    def __len__(self):
        return len(self._keys)

    @property
    def dictionary_size(self) -> int:
        return len(self._values)

    def finish(self) -> col.DictionaryColumn:
        device = resolve_device(self.device)
        words = self._values or [""]
        values = col.string_view(words, self.dtype.value, device)
        keys = col.primitive(np.array(self._keys, np.int32), st.int32,
                             validity=self._valid.finish(),
                             length=len(self._keys), device=device)
        # each value's rank in ascending order, for sorting by the keys
        order = np.argsort(np.array(words, dtype=object))
        ranks = np.zeros(values.capacity, np.int32)
        ranks[order] = np.arange(len(order), dtype=np.int32)
        out = col.DictionaryColumn(keys, values,
                                   torch.from_numpy(ranks).to(device),
                                   self.dtype)
        self.__init__(self.dtype.key, self.dtype.value, self.device)
        return out


class RecordBatchBuilder:
    """Row-at-a-time batch assembly over one builder per field."""

    def __init__(self, schema: st.Schema, device=None):
        self.schema = schema
        self._builders = []
        for f in schema.fields:
            if isinstance(f.dtype, st.Boolean):
                self._builders.append(BooleanBuilder(device))
            elif isinstance(f.dtype, (st.Utf8, st.Binary)):
                self._builders.append(StringBuilder(f.dtype, device))
            elif isinstance(f.dtype, st.Dictionary):
                self._builders.append(StringDictionaryBuilder(
                    f.dtype.key, f.dtype.value, device))
            else:
                self._builders.append(PrimitiveBuilder(f.dtype,
                                                       device=device))

    def append_row(self, row: dict):
        for f, b in zip(self.schema.fields, self._builders):
            b.append_option(row.get(f.name))

    def __len__(self):
        return len(self._builders[0]) if self._builders else 0

    def finish(self) -> bt.RecordBatch:
        return bt.RecordBatch(self.schema,
                              tuple(b.finish() for b in self._builders))
