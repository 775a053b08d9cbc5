"""Hash equi-join: open-addressing build and probe with N:M output.

Counterpart of `arrowtpu/ops/join.py`, with the same results:

  * keys: a row takes part when every key column is valid (SQL: a null
    key never matches).  Equality compares the port's key planes
    (rowformat/encode.py); the hash is the JAX package's, over its u32
    planes (rowformat/hashing.py), so the probe sequences are the same.
  * build: an open-addressing table of next_pow2(2 * capacity) int32
    slots, each holding ONE representative build row per distinct key,
    filled by vectorized linear probing: every pending row scatter-mins
    its row id into its candidate slot, winners retire, and a row that
    meets an equal key retires too (its group is reachable through the
    representative).  Beside it, a group index: build rows stably sorted
    by key (rowformat/pack.py), with each row's group start and size in
    that order, so any member row indexes its whole duplicate group.
  * probe: a vectorized chase from each row's hash slot until it meets its
    key (-> the representative) or an empty slot (-> -1).
  * N:M expansion: per-probe match counts, a cumsum, and for output slot j
    its probe row by searchsorted and its duplicate by offset arithmetic;
    both sides materialize with take().

The JAX `lax.while_loop`s are Python loops over the ACTIVE rows: each
round works on the rows still pending only, and reads back once, for the
size of the set that stays (a nonzero).  The JAX loops run every
row each round and drop the inactive ones' scatter out of bounds; here
inactive rows are never in the scatter, so it needs no dump slot.  Both
loops are capped at the table size in rounds, as in the JAX package.

Output capacity is the port's: the output's length rounded up to the
capacity granule, read back once.  `out_capacity`, when given, truncates
the output to round_up(out_capacity) rows and sets `overflow`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from .. import schema as st
from ..config import round_up
from ..core import batch as bt
from ..core import bitmap as bm
from ..core import column as col
from ..rowformat import encode as rf
from ..rowformat import hashing as hsh
from ..rowformat import pack as rp
from .filter import filter_record_batch
from .take import take

_EMPTY = 2**31 - 1  # an empty slot while building (loses every scatter-min)


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def _key_planes_and_valid(columns: Sequence[col.Column]):
    """-> (value planes for equality, u32 hash, bool: every key part valid
    and the row live)."""
    valid = bm.row_mask_bool(columns[0].capacity, columns[0].length,
                             columns[0].device)
    planes = []
    for c in columns:
        if c.validity is not None:
            valid = valid & bm.unpack(c.validity)
        planes.extend(rf.encode_column(c)[1:])  # the sentinel never differs
    h = hsh.hash_planes(rf.hash_planes_of(columns))
    return planes, h, valid


def _planes_eq(planes_a, rows_a, planes_b, rows_b) -> torch.Tensor:
    eq = None
    for pa, pb in zip(planes_a, planes_b):
        e = pa[rows_a] == pb[rows_b]
        eq = e if eq is None else eq & e
    return eq


def _pending(act, off, stay):
    """The rows that stay pending, one probe step further: the round's one
    read-back (the size of the set)."""
    keep = stay.nonzero().squeeze(1)
    return act[keep], off[keep] + 1


@dataclasses.dataclass(frozen=True)
class JoinInfo:
    """duplicates: build keys were not unique (a 0-d bool tensor on the
    device; the N:M output is exact either way).  overflow: the output
    was cut to `out_capacity` rows (a Python bool)."""

    duplicates: torch.Tensor
    overflow: bool


@dataclasses.dataclass(frozen=True)
class HashTable:
    """The built side: representative table and duplicate-group index."""

    slots: torch.Tensor           # (size,) int32 representative row or -1
    planes: Tuple[torch.Tensor, ...]  # build key planes
    duplicates: torch.Tensor      # 0-d bool: build keys not unique
    order: torch.Tensor           # (build_cap,) int32 row ids sorted by key
    grp_start: torch.Tensor       # (build_cap,) int32 group start in order
    grp_size: torch.Tensor        # (build_cap,) int32 group size
    rounds: int                   # linear-probing rounds of the build


def _group_index(planes: List[torch.Tensor], valid: torch.Tensor):
    """Stable sort of the valid rows by key (the others last); per row,
    the start and size of its group of equal keys in that order."""
    cap = valid.shape[0]
    device = valid.device
    order = rp.sort_permutation(planes, cap, None, live=valid)
    pos = torch.arange(cap, dtype=torch.int32, device=device)
    # after the sort the valid rows come first: the pad plane is
    # pos >= n_live, and it splits groups like a key plane
    neq_prev = torch.zeros(cap, dtype=torch.bool, device=device)
    neq_prev[0] = True
    sorted_pad = pos >= valid.sum()
    for p in [sorted_pad] + [p[order] for p in planes]:
        neq_prev[1:] |= p[1:] != p[:-1]
    start = torch.where(neq_prev, pos, 0).cummax(0).values
    # a group ends at the next boundary after its rows (suffix min)
    nxt = torch.full((cap,), cap, dtype=torch.int32, device=device)
    nxt[:-1] = torch.where(neq_prev[1:], pos[1:], cap)
    end = nxt.flip(0).cummin(0).values.flip(0)
    order = order.to(torch.int32)
    grp_start = torch.empty(cap, dtype=torch.int32, device=device)
    grp_size = torch.empty(cap, dtype=torch.int32, device=device)
    grp_start[order] = start
    grp_size[order] = end - start
    return order, grp_start, grp_size


def build_table(key_cols: Sequence[col.Column]) -> HashTable:
    cap = key_cols[0].capacity
    size = _next_pow2(max(2 * cap, 16))  # load factor at most 1/2
    planes, h, valid = _key_planes_and_valid(key_cols)
    device = valid.device
    slots = torch.full((size,), _EMPTY, dtype=torch.int32, device=device)
    # scratch of the round's candidates; EMPTY except where written in it
    cand = torch.full((size,), _EMPTY, dtype=torch.int32, device=device)
    dup = torch.zeros((), dtype=torch.bool, device=device)
    act = valid.nonzero().squeeze(1)  # pending rows
    off = torch.zeros_like(act)
    rounds = 0
    while act.numel() and rounds < size:
        pos = (h[act] + off) & (size - 1)
        rid = act.to(torch.int32)
        # candidates compete in the scratch, and only empty slots take the
        # winner (a smaller row id must not steal a slot won earlier)
        cand.scatter_reduce_(0, pos, rid, "amin")
        occupant = torch.where(slots[pos] == _EMPTY, cand[pos], slots[pos])
        slots[pos] = occupant  # rows of one slot write the same value
        cand[pos] = _EMPTY
        won = occupant == rid
        same_key = ~won & _planes_eq(planes, occupant, planes, rid)
        dup |= same_key.any()
        # equal keys retire too: the group index covers them
        act, off = _pending(act, off, ~(won | same_key))
        rounds += 1
    slots = torch.where(slots == _EMPTY, -1, slots)
    order, grp_start, grp_size = _group_index(planes, valid)
    return HashTable(slots, tuple(planes), dup, order, grp_start, grp_size,
                     rounds)


def probe_table(table: HashTable, key_cols: Sequence[col.Column]
                ) -> Tuple[torch.Tensor, int]:
    """-> ((probe_cap,) int32 representative build row or -1, rounds)."""
    cap = key_cols[0].capacity
    size = table.slots.shape[0]
    planes, h, valid = _key_planes_and_valid(key_cols)
    result = torch.full((cap,), -1, dtype=torch.int32, device=valid.device)
    act = valid.nonzero().squeeze(1)
    off = torch.zeros_like(act)
    rounds = 0
    while act.numel() and rounds < size:
        occupant = table.slots[(h[act] + off) & (size - 1)]
        empty = occupant < 0
        match = ~empty & _planes_eq(table.planes, occupant.clamp(min=0),
                                    planes, act)
        result[act] = torch.where(match, occupant, -1)
        act, off = _pending(act, off, ~(match | empty))
        rounds += 1
    return result, rounds


def _expand_matches(table: HashTable, match: torch.Tensor,
                    probe_live: torch.Tensor, out_cap: Optional[int], *,
                    keep_unmatched: bool):
    """N:M expansion: output slot j -> (probe row, build row or -1).

    counts[i] = the group size of probe row i's match (1 for an unmatched
    live row when keep_unmatched, the LEFT join).  Returns (left index,
    right index, output length, overflow); the indices are int32 columns'
    values over the output capacity."""
    probe_cap = match.shape[0]
    build_cap = table.order.shape[0]
    matched = (match >= 0) & probe_live
    m = match.clamp(0, build_cap - 1)
    counts = torch.where(matched, table.grp_size[m], 0)
    if keep_unmatched:
        counts = torch.where(probe_live & ~matched, 1, counts)
    ends = counts.cumsum(0)
    total = int(ends[-1])  # read-back: the output's length
    out_len = total if out_cap is None else min(total, out_cap)
    rows = round_up(max(out_len, 1)) if out_cap is None else out_cap
    j = torch.arange(rows, dtype=torch.int64, device=match.device)
    pi = torch.searchsorted(ends, j, right=True).clamp_(max=probe_cap - 1)
    k = j - (ends[pi] - counts[pi])
    ok = j < out_len
    sorted_pos = (table.grp_start[m[pi]] + k).clamp_(0, build_cap - 1)
    brow = table.order[sorted_pos]
    left_idx = torch.where(ok, pi, -1).to(torch.int32)
    right_idx = torch.where(ok & matched[pi], brow, -1)
    overflow = out_cap is not None and total > out_cap
    return left_idx, right_idx, out_len, overflow


def _dedup_names(left_names, right_names):
    taken = set(left_names)
    return [n + "_right" if n in taken else n for n in right_names]


def join_matches(left: bt.RecordBatch, right: bt.RecordBatch,
                 right_on: Sequence[str], table: HashTable,
                 match: torch.Tensor, *, how: str = "inner",
                 out_capacity: Optional[int] = None):
    """The join's output from the probe's `match` (inner or left): the
    expansion, then take() on both sides.  -> (batch, JoinInfo)."""
    if how not in ("inner", "left"):
        raise st.ComputeError(f"join: unknown how={how!r}")
    out_cap = None if out_capacity is None else round_up(out_capacity)
    probe_live = bm.row_mask_bool(left.capacity, left.length, left.device)
    left_idx, right_idx, out_len, overflow = _expand_matches(
        table, match, probe_live, out_cap, keep_unmatched=(how == "left"))
    lidx = col.PrimitiveColumn(left_idx, None, out_len, st.int32)
    ridx = col.PrimitiveColumn(right_idx, None, out_len, st.int32)
    left_cols = [take(c, lidx) for c in left.columns]
    right_keep = [n for n in right.schema.names if n not in set(right_on)]
    right_cols = [take(right[n], ridx) for n in right_keep]
    out_names = _dedup_names(left.schema.names, right_keep)
    fields = list(left.schema.fields) + [
        st.Field(nm, c.dtype) for nm, c in zip(out_names, right_cols)]
    return (bt.RecordBatch(st.Schema(tuple(fields)),
                           tuple(left_cols) + tuple(right_cols)),
            JoinInfo(table.duplicates, overflow))


def hash_join(left: bt.RecordBatch, right: bt.RecordBatch,
              on: Sequence[str], *, how: str = "inner",
              right_on: Optional[Sequence[str]] = None,
              out_capacity: Optional[int] = None):
    """General N:M equi-join (build side = right; duplicate build keys give
    one output row per pair).  how in {inner, left, semi, anti}.  Returns
    (batch, JoinInfo).  Semi and anti keep the left rows that do / do not
    match, through the filter."""
    if how not in ("inner", "left", "semi", "anti"):
        raise st.ComputeError(f"join: unknown how={how!r}")
    right_on = list(right_on or on)
    table = build_table([right[k] for k in right_on])
    match, _ = probe_table(table, [left[k] for k in on])
    if how in ("semi", "anti"):
        keep = match >= 0 if how == "semi" else match < 0
        mask = col.boolean(keep, length=left.length)
        return (filter_record_batch(left, mask),
                JoinInfo(table.duplicates, False))
    return join_matches(left, right, right_on, table, match, how=how,
                        out_capacity=out_capacity)
