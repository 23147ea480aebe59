"""Segment sums in a fixed order: the deterministic replacement of
`index_add` for the Gauss-Newton assemblies (models/posegraph.py,
models/irls.py).

On the card `index_add` adds float rows with atomics, in whatever order the
threads arrive, so two solves of the same system part in the last bits (a
200-keyframe pose-graph loop by ~4.7e-7). Here the keys are fixed for a
whole solve, so an incidence table is built once: for each key 0..n-1, the
positions of its rows in increasing order, padded to the largest count
with the index of a zero row appended after the rows. Each sum is then one
concatenation, one gather and one sum over the table's second axis: the
same order on every run. Building the table costs one host read (its
width); using it costs none.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Incidence(NamedTuple):
    m: int                 # rows a sum takes; the pad index
    table: torch.Tensor    # [n, width] int64: each key's row positions in order, m pads


def incidence(keys: torch.Tensor, n: int) -> Incidence:
    """The incidence table of `keys` [M] (values in [0, n)): row k lists, in
    increasing order, the positions p with keys[p] == k, then M to the
    width of the largest count."""
    keys = keys.reshape(-1).to(torch.int64)
    dev, m = keys.device, len(keys)
    order = torch.sort(keys, stable=True).indices
    counts = torch.bincount(keys, minlength=n)
    width = int(counts.max()) if m else 0
    sk = keys[order]
    rank = torch.arange(m, device=dev) - (torch.cumsum(counts, 0) - counts)[sk]
    table = torch.full((n, width), m, dtype=torch.int64, device=dev)
    table[sk, rank] = order
    return Incidence(m, table)


def segment_sum(inc: Incidence, *parts: torch.Tensor) -> torch.Tensor:
    """out[k] = the sum of rows[p] over keys[p] == k, [n, ...] (0 for a key
    that never occurs), where rows = the concatenation of `parts` ([M, ...]
    together): each key's rows summed over the table's axis in position
    order, so the sum depends on nothing else."""
    first = parts[0]
    rows = torch.cat([*parts, first.new_zeros((1,) + first.shape[1:])])
    if len(rows) != inc.m + 1:
        raise ValueError(f"segment_sum: {len(rows) - 1} rows for a table of {inc.m}")
    return rows[inc.table].sum(1)
