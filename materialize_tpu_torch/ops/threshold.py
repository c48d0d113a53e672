"""Threshold: keep the records of positive multiplicity (the port of
``materialize_tpu/ops/threshold.py``).

The state is the input's consolidated multiset, one exact-order
``Arrangement`` keyed by every column. Per step the delta is arranged,
each distinct updated row looks up its old multiplicity, and the output
is

    d_out = max(old + d, 0) - max(old, 0)

after which the arranged delta is merged into the state.

The state keeps its stacked sort lanes cached (``lanes2d``) from one
step's merge to the next, and the lookup is one left search plus a
row-equality test (the arrangement holds each row once), where the
reference runs a left and a right search: the same ``old`` for fewer
eager operations on rows some 25 lanes wide (TPC-H Q21).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..arrangement.spine import Arrangement, arrange
from ..ops.consolidate import consolidate_sorted_cached
from ..ops.merge import merge_sorted_cached
from ..ops.search import lex_searchsorted_2d
from ..ops.sort import compact
from ..repr.batch import Batch
from ..repr.schema import Schema


@dataclass
class ThresholdOp:
    """State: one Arrangement keyed by all columns. n_parts = 1."""

    schema: Schema

    def __post_init__(self):
        self.out_schema = self.schema
        self.key = tuple(range(self.schema.arity))
        self.n_parts = 1

    def init_state(self, capacity: int = 256, device=None) -> tuple:
        return (Arrangement.empty(self.schema, self.key, capacity, device=device),)

    def step(self, state: tuple, delta: Batch, out_time: int):
        """Returns (new_state, out_delta, overflow: dict part->flag)."""
        (arr,) = state
        d = arrange(delta, self.key)
        d_lanes = d.sort_lanes_2d()
        a_lanes = arr.sort_lanes_2d()
        cap = arr.capacity
        lo = lex_searchsorted_2d(a_lanes, arr.batch.count, d_lanes, side="left")
        idx = torch.clamp(lo.to(torch.int64), 0, max(cap - 1, 0))
        found = (lo < arr.batch.count) & (a_lanes[idx] == d_lanes).all(dim=1)
        old = torch.where(found, arr.batch.diff[idx], 0)
        dd = torch.where(d.batch.valid_mask(), d.batch.diff, 0)
        out_diff = torch.clamp(old + dd, min=0) - torch.clamp(old, min=0)
        out = d.batch.replace(
            diff=out_diff,
            time=torch.full((d.batch.capacity,), out_time, dtype=torch.int64,
                            device=d.batch.device),
        )
        out = compact(out, out_diff != 0)
        merged, merged_lanes, overflow = merge_sorted_cached(arr.batch, a_lanes, d.batch,
                                                             d_lanes, cap)
        cons, cons_lanes = consolidate_sorted_cached(merged, merged_lanes)
        return (Arrangement(cons, self.key, arr.order, lanes2d=cons_lanes),), out, {0: overflow}
