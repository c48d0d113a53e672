"""TopK: per-group top-k rows by an ordering, with offset and limit (the
port of ``materialize_tpu/ops/topk.py``).

The state is ONE arrangement of the whole input sorted by (group key,
order lanes), so every group's window is a contiguous row range and a
row's output multiplicity falls out of a segmented prefix sum over the
diffs:

    out_mult(row) = clip(prefix + diff, offset, offset + limit)
                  - clip(prefix,        offset, offset + limit)

A step emits the window of every touched group before the state insert
(negated) and after it; unchanged window rows cancel in consolidation,
and a retraction inside a window pulls in the row past its edge. The
insert is ``arrangement/spine.py:insert``, a merge (the merge-path
kernel on the card).

Order lanes are the stored-form lanes of ``ops/lanes.py``: the
reference stores each u64 order lane as ``(u64 ^ 2^63).astype(int64)``,
which IS the port's stored form, so the lanes go into the state columns
as they are. DESC complements them (``~`` commutes with the XOR) and the
null lane is inverted for NULLS LAST.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..arrangement.spine import Arrangement, arrange, insert
from ..repr.batch import Batch
from ..repr.schema import Column, ColumnType, Schema
from .consolidate import consolidate
from .lanes import SIGN, column_lanes, key_lanes, stack_lanes
from .search import lex_searchsorted_2d
from .sort import compact, concat_batches, segment_starts

_NO_LIMIT = 1 << 62


def order_lane_arrays(batch: Batch, order_by) -> list:
    """Stored-form lanes of an ORDER BY spec ((col_index, desc,
    nulls_last) per column): ascending lexicographic order of the lanes
    is the requested row order."""
    lanes = []
    for col_idx, desc, nulls_last in order_by:
        col = batch.schema[col_idx]
        arr = batch.cols[col_idx]
        nulls = batch.nulls[col_idx]
        val_lanes = list(column_lanes(arr, col.ctype))
        if desc:
            val_lanes = [~l for l in val_lanes]
        if col.nullable:
            if nulls is None:
                nulls = torch.zeros(arr.shape, dtype=torch.bool, device=arr.device)
            # u64 0 / 1 in stored form
            lanes.append(torch.where(nulls, SIGN + 1, SIGN) if nulls_last
                         else torch.where(nulls, SIGN, SIGN + 1))
            val_lanes = [torch.where(nulls, SIGN, l) for l in val_lanes]
        lanes.extend(val_lanes)
    return lanes


@dataclass
class TopKOp:
    """State: one Arrangement over the input columns ++ one int64 column
    per order lane, keyed by (group columns, order-lane columns)."""

    input_schema: Schema
    group_key: tuple
    order_by: tuple
    limit: int | None
    offset: int = 0

    def __post_init__(self):
        self.arity = self.input_schema.arity
        self.out_schema = self.input_schema
        self.n_order_lanes = 0
        for col_idx, _, _ in self.order_by:
            col = self.input_schema[col_idx]
            n = 2 if col.ctype is ColumnType.FLOAT64 else 1
            self.n_order_lanes += n + (1 if col.nullable else 0)
        lane_cols = [Column(f"__o{i}__", ColumnType.INT64, False)
                     for i in range(self.n_order_lanes)]
        self.state_schema = Schema(tuple(self.input_schema.columns) + tuple(lane_cols))
        self.state_key = tuple(self.group_key) + tuple(
            range(self.arity, self.arity + self.n_order_lanes)
        )

    def init_state(self, capacity: int = 256, device=None) -> tuple:
        return (Arrangement.empty(self.state_schema, self.state_key, capacity,
                                  device=device),)

    def _to_state(self, delta: Batch) -> Batch:
        lanes = order_lane_arrays(delta, self.order_by)
        return delta.replace(
            cols=tuple(delta.cols) + tuple(lanes),
            nulls=tuple(delta.nulls) + (None,) * self.n_order_lanes,
            schema=self.state_schema,
        )

    def _emit(self, arr: Arrangement, touched: Arrangement, out_time: int,
              negate: bool) -> Batch:
        """Every row's window multiplicity in ``arr``, for the groups
        present in ``touched``; rows (input columns only) with those
        diffs, negated for the emission before the update."""
        b = arr.batch
        cap = b.capacity
        dev = b.device
        glanes = key_lanes(b, self.group_key)
        tb = touched.batch
        t2d = stack_lanes(key_lanes(tb, self.group_key))
        g2d = stack_lanes(glanes)
        lo = lex_searchsorted_2d(t2d, tb.count, g2d, "left")
        hi = lex_searchsorted_2d(t2d, tb.count, g2d, "right")
        member = hi > lo
        valid = b.valid_mask()
        starts = segment_starts(glanes, b.count, cap)
        d = torch.where(valid, b.diff, 0)
        excl = torch.cumsum(d, 0) - d
        # The reference's scatter of each segment's base into a spare-row
        # buffer: here the base is read at the segment's first row.
        j = torch.arange(cap, dtype=torch.int64, device=dev)
        first = torch.cummax(torch.where(starts, j, 0), 0).values
        prefix = excl - excl[first]
        lo_b = self.offset
        hi_b = self.offset + (self.limit if self.limit is not None else _NO_LIMIT)
        mult = (torch.clamp(prefix + d, lo_b, hi_b)
                - torch.clamp(prefix, lo_b, hi_b))
        mult = torch.where(valid & member, mult, 0)
        out = Batch(
            cols=b.cols[: self.arity],
            nulls=b.nulls[: self.arity],
            time=torch.full((cap,), out_time, dtype=torch.int64, device=dev),
            diff=-mult if negate else mult,
            count=b.count,
            schema=self.input_schema,
        )
        return compact(out, out.diff != 0)

    def step(self, state: tuple, delta: Batch, out_time: int):
        """Returns (new_state, output delta, overflow: {part: flag})."""
        (arr,) = state
        sdelta = self._to_state(delta)
        # The sorted delta doubles as the touched-group list (the search
        # tolerates duplicate targets).
        touched = arrange(sdelta, self.state_key)
        new_arr, overflow = insert(arr, sdelta, arr.capacity)
        out_old = self._emit(arr, touched, out_time, negate=True)
        out_new = self._emit(new_arr, touched, out_time, negate=False)
        out = consolidate(concat_batches([out_old, out_new]), include_time=False)
        return (new_arr,), out, {0: overflow}
