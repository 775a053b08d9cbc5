"""zip (if / else select), nullif and window shift.

Counterpart of `arrowtpu/ops/zip.py`:

  * `zip_(mask, truthy, falsy)`: a true mask row takes truthy's row, a
    false one falsy's, a null one is null; either value side may be a
    Python scalar.  Single-word values take the JAX package's result type
    (`arity.result_dtype`).  Multi-word values (decimals, held as (n,
    limbs) rows) take the mask over the limb axis, and a scalar beside a
    decimal column (an int or a `decimal.Decimal`) becomes that column's
    limbs at its scale; two decimal columns must share one type.  (The
    JAX package broadcasts the mask over the limbs only for its 64-bit
    limb pairs, so it raises on a decimal.)
  * `nullif(c, cond)`: null where cond is a valid true.
  * `shift(c, offset)`: rows move down by `offset` (up when negative), the
    vacated rows null.
"""

from __future__ import annotations

import dataclasses
import decimal as _pydec

import torch

from .. import schema as st
from ..core import bitmap as bm
from ..core import column as col
from . import arity


def _decimal_operand(x, like: col.PrimitiveColumn) -> torch.Tensor:
    """A zip value beside the decimal column `like`, as (n or 1, limbs)."""
    from . import decimal as dec

    if isinstance(x, col.Column):
        if x.dtype != like.dtype:
            raise st.ComputeError(f"zip: {x.dtype} beside {like.dtype}")
        return x.values
    scale = like.dtype.scale
    if isinstance(x, _pydec.Decimal):
        unscaled = col._unscaled(x, scale)
    elif isinstance(x, int) and not isinstance(x, bool):
        unscaled = x * 10 ** scale
    else:
        raise st.ComputeError(f"zip: {x!r} beside {like.dtype}")
    return dec._scalar_limbs(unscaled, st.decimal_limbs(like.dtype), like)


def zip_(mask: col.BooleanColumn, truthy, falsy) -> col.Column:
    """mask row true -> truthy row, false -> falsy, null mask -> null."""
    t_col = isinstance(truthy, col.Column)
    f_col = isinstance(falsy, col.Column)
    if not (t_col or f_col):
        raise st.ComputeError("zip: need at least one column")
    base = truthy if t_col else falsy
    if not isinstance(base, col.PrimitiveColumn):
        raise st.ComputeError(f"zip: unsupported column {base.dtype}")
    m = mask.values_bool()
    if base.values.dim() == 2:
        if st.decimal_limbs(base.dtype) is None:
            raise st.ComputeError(f"zip: unsupported column {base.dtype}")
        tv, fv = (_decimal_operand(x, base) for x in (truthy, falsy))
        values = torch.where(m[:, None], tv, fv)
        values[base.length:] = 0
        dtype = base.dtype
    else:
        dt = arity.result_dtype(truthy, falsy)
        tv, fv = (arity.operand(x, dt, base.device) for x in (truthy, falsy))
        values = torch.where(m, tv, fv)
        values[base.length:] = 0
        values = arity.narrow_to(values, dt)
        dtype = st.from_torch(dt)
    t_ok = truthy.valid_bool() if t_col and truthy.validity is not None \
        else None
    f_ok = falsy.valid_bool() if f_col and falsy.validity is not None \
        else None
    picked = None
    if t_ok is not None or f_ok is not None:
        picked = torch.where(m, True if t_ok is None else t_ok,
                             True if f_ok is None else f_ok)
    if mask.validity is not None:
        mv = bm.unpack(mask.validity)
        picked = mv if picked is None else picked & mv
    validity = None if picked is None else bm.clip(bm.pack(picked),
                                                   base.length)
    return col.PrimitiveColumn(values, validity, base.length, dtype)


def nullif(c: col.Column, cond: col.BooleanColumn) -> col.Column:
    """Null where `cond` is true and valid."""
    if c.capacity != cond.capacity:
        raise st.ComputeError("nullif: capacity mismatch")
    kill = cond.values
    if cond.validity is not None:
        kill = kill & cond.validity
    keep = ~kill
    validity = bm.clip(keep if c.validity is None else c.validity & keep,
                       c.length)
    if isinstance(c, col.DictionaryColumn):
        return dataclasses.replace(
            c, keys=dataclasses.replace(c.keys, validity=validity))
    return dataclasses.replace(c, validity=validity)


_SIGNED_BITS = {torch.uint16: torch.int16, torch.uint32: torch.int32}


def shift(c: col.PrimitiveColumn, offset: int) -> col.PrimitiveColumn:
    """shift(+n) moves rows down by n, the first n rows null; shift(-n)
    moves them up, the last n null."""
    if offset == 0:
        return c
    cap, n = c.capacity, c.length
    idx = torch.arange(cap, device=c.device) - offset
    in_bounds = (idx >= 0) & (idx < n)
    in_bounds[n:] = False
    src = idx.clamp(0, cap - 1)
    sel = in_bounds[:, None] if c.values.dim() == 2 else in_bounds
    # torch indexes uint16 / uint32 on the card only as their signed bits
    raw = c.values.view(_SIGNED_BITS.get(c.values.dtype, c.values.dtype))
    values = torch.where(sel, raw[src], 0).to(raw.dtype).view(c.values.dtype)
    ok = c.valid_bool()[src] & in_bounds
    return col.PrimitiveColumn(values, bm.pack(ok), n, c.dtype)

