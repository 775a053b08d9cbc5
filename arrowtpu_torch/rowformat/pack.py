"""Stable sort of rows by order-preserving planes, with the planes packed
into as few int64 sort keys as their ranges allow.

Counterpart of `arrowtpu/rowformat/pack.py` (`sort_by_planes`,
`sort_by_plane_groups`), giving the SAME order: live rows first, then the planes lexicographically ascending,
ties by row index.  `torch.sort(stable=True)` stands in for `lax.sort`.

Packing: each plane's range over the live rows (one read-back for all
planes) gives its bit width; planes are rebased to 0 and concatenated MSB
first into words of at most 63 bits, the first word led by a dead-row
flag.  A word is a concatenation of whole fields, so comparing the words
lexicographically compares the planes lexicographically.  The words are
then sorted least significant first (LSD), each sort stable, so the row
index breaks the remaining ties.  A plane wider than 63 bits is its own
word, sorted raw: its signed order is the plane's order, which is what a
float key (rowformat/encode.py float_key, signed total order) needs.  The
ranges are read back as Python ints, so a range of 2**64 - 1 does not
overflow.  The flagship group-by (key + value planes, about 17 bits) sorts
once; config 3's lexsort (int32 range 200, float64, dictionary of 1000)
packs to three words: flag + int32 (9 bits), the raw float key, the rank
(10 bits); two one-letter string keys (TPC-H Q1's flags: one word plane
of 28-29 bits each, the other planes constant) pack to one word.

`sort_by_plane_groups` sorts by plane groups in turn (a long string key's
prefix, then 16 bytes at a time): the first group sorts the rows, then
each refinement sorts them by [the run rank of everything compared so
far, the next group's planes], stably, so ties resolve group by group and
no sort carries more than a group's planes.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ..core import bitmap as bm

_WORD_BITS = 63  # non-negative int64: signed order == unsigned order


def packed_words(planes, live) -> List[torch.Tensor]:
    """The int64 sort words of `planes` over the live rows, most
    significant first (one read-back: every plane's range)."""
    big = torch.iinfo(torch.int64)
    k = len(planes)
    stats = torch.stack(
        [torch.where(live, p, big.max).min() for p in planes]
        + [torch.where(live, p, big.min).max() for p in planes]
    ).tolist() if k else []
    words: List[torch.Tensor] = []
    word = (~live).to(torch.int64)  # dead rows sort last
    used = 1
    for p, lo, hi in zip(planes, stats[:k], stats[k:]):
        bits = (hi - lo).bit_length() if hi > lo else 0
        if bits == 0:
            continue  # constant over the live rows: decides nothing
        if bits > _WORD_BITS:
            if word is not None:
                words.append(word)
            words.append(torch.where(live, p, lo))
            word, used = None, 0
            continue
        field = torch.where(live, p, lo) - lo
        if word is None:
            word, used = field, bits
        elif used + bits <= _WORD_BITS:
            word, used = (word << bits) | field, used + bits
        else:
            words.append(word)
            word, used = field, bits
    if word is not None:
        words.append(word)
    return words


def sort_permutation(planes: Sequence[torch.Tensor], capacity: int,
                     length: int, live: torch.Tensor = None) -> torch.Tensor:
    """(capacity,) int64 permutation: live rows first, then `planes` (at
    least one) ascending, ties by row index.  Live rows are the rows below
    `length`, or where the (capacity,) bool `live` is set (the rows
    outside it sort last, in row order, and set no plane's range)."""
    if live is None:
        live = bm.row_mask_bool(capacity, length, planes[0].device)
    perm = None
    for w in reversed(packed_words(list(planes), live)):
        if perm is None:
            perm = torch.sort(w, stable=True).indices
        else:
            perm = perm[torch.sort(w[perm], stable=True).indices]
    return perm


def sort_by_planes(planes: Sequence[torch.Tensor], capacity: int, length: int,
                   extras: Sequence[torch.Tensor] = ()
                   ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """-> (sorted planes, sorted extras), both permuted by
    `sort_permutation`."""
    perm = sort_permutation(planes, capacity, length)
    return [p[perm] for p in planes], [e[perm] for e in extras]


def _run_rank(planes: Sequence[torch.Tensor]) -> torch.Tensor:
    """int64 run id of each row of sorted planes: rows share a rank iff
    they are equal on every plane and adjacent."""
    boundary = torch.zeros(planes[0].shape[0], dtype=torch.bool,
                           device=planes[0].device)
    boundary[0] = True
    for p in planes:
        boundary[1:] |= p[1:] != p[:-1]
    return boundary.to(torch.int64).cumsum(0) - 1


def sort_by_plane_groups(groups: Sequence[Sequence[torch.Tensor]],
                         capacity: int, length: int) -> torch.Tensor:
    """(capacity,) int64 permutation ordering the rows by the groups'
    planes lexicographically (group 0 most significant), live rows (those
    below `length`) first, ties by row index: the order of
    `sort_permutation` over all the planes at once."""
    groups = [list(g) for g in groups if len(g)]
    perm = sort_permutation(groups[0], capacity, length)
    if len(groups) == 1:
        return perm
    rank = _run_rank([p[perm] for p in groups[0]])
    for g in groups[1:]:
        planes = [p[perm] for p in g]
        sub = sort_permutation([rank] + planes, capacity, length)
        perm = perm[sub]
        rank = _run_rank([rank[sub]] + [p[sub] for p in planes])
    return perm
