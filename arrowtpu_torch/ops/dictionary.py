"""Dictionary maintenance: garbage collection and value merging.

Counterpart of `arrowtpu/ops/dictionary.py`:

  * `garbage_collect_dictionary` keeps the values some live, valid key
    references (a scatter-max mask, filtered by `ops.filter_`) and
    renumbers the keys by the mask's exclusive prefix count; the result
    has no value ranks, as in the JAX package;
  * `should_merge_dictionary_values`: merge unless every input shares one
    values column (the same object);
  * `merge_dictionary_values` unions the value sets on the host in
    first-seen order (dictionaries are built on the host) and remaps each
    input's keys by one gather on its device.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import bitmap as bm
from ..core import column as col


def _clipped_keys(d: col.DictionaryColumn, top: int) -> torch.Tensor:
    return d.keys.values.to(torch.int64).clamp(0, max(top - 1, 0))


def garbage_collect_dictionary(d: col.DictionaryColumn
                               ) -> col.DictionaryColumn:
    """Drop the values no live, valid key references and renumber the
    keys."""
    from .filter import filter_

    vcap = d.values.capacity
    keys = _clipped_keys(d, vcap)
    referenced = torch.zeros(vcap, dtype=torch.int32, device=d.device)
    referenced = referenced.scatter_reduce(
        0, keys, d.keys.valid_bool().to(torch.int32), "amax").bool()
    referenced[d.values.length:] = False
    ref = referenced.to(torch.int64)
    new_index = ref.cumsum(0) - ref
    mask = col.BooleanColumn(bm.pack(referenced), None, d.values.length)
    new_keys = dataclasses.replace(
        d.keys, values=_keep_padding(new_index[keys], d.keys))
    return col.DictionaryColumn(new_keys, filter_(d.values, mask), None,
                                d.dtype)


def _keep_padding(values: torch.Tensor, keys: col.PrimitiveColumn
                  ) -> torch.Tensor:
    """New key values in the keys' dtype, zero past their length."""
    out = values.to(keys.values.dtype)
    out[keys.length:] = 0
    return out


def should_merge_dictionary_values(dicts) -> bool:
    """Merge unless all inputs share one values column."""
    first = dicts[0].values
    return not all(d.values is first for d in dicts[1:])


def merge_dictionary_values(dicts):
    """-> (the merged values column, [each input's keys remapped into
    it]): the values' union in first-seen order (a null value once), built
    on the host."""
    merged, where, maps = [], {}, []
    for d in dicts:
        m = []
        for v in d.values.to_pylist():
            k = ("\0n",) if v is None else v
            if k not in where:
                where[k] = len(merged)
                merged.append(v)
            m.append(where[k])
        maps.append(m)
    merged_col = col.from_pylist(merged, dicts[0].dtype.value,
                                 device=dicts[0].device)
    remapped = []
    for d, m in zip(dicts, maps):
        table = torch.tensor(m or [0], dtype=torch.int64, device=d.device)
        keys = _clipped_keys(d, len(m))
        remapped.append(dataclasses.replace(
            d.keys, values=_keep_padding(table[keys], d.keys)))
    return merged_col, remapped
