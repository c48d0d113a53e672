"""Reduce: incremental GROUP BY (the port of the accumulable and the
hierarchical paths of ``materialize_tpu/ops/reduce.py``).

State part 0 is one exact-order Arrangement keyed by the group columns,
with the accumulators as values:

  [group key cols...] ++ [__rows__] ++ per-aggregate accumulator cols

Per step: (1) evaluate each aggregate's input over the delta and weight
it by the diff, (2) sum the contributions per group (``sum_by_key``),
(3) gather each touched group's old accumulators from the state, (4)
emit the retraction of the old output row and the insertion of the new
one, (5) merge the per-group deltas into the state, summing on key
collision and dropping groups whose ``__rows__`` reaches 0.

Accumulable aggregates: COUNT, SUM_INT, SUM_FLOAT, ANY, ALL. The int64
accumulators are summed per group with one ``index_add_`` (exact in any
order). SUM_FLOAT's float64 sum is not associative, and ``index_add_``
on the card adds in no fixed order, so each group's float sum runs
sequentially in row order from 0.0 (``_run_sums``): the order of the
reference's scatter-add on its CPU backend, so both packages give the
same bits, and two card runs give the same bits. Its cost: one lockstep
pass of a few launches per row of the step's largest group, and one
readback of that group's size per step (a power-law graph's hub makes
pagerank pay its in-degree in passes each evaluation; ROADMAP Queue 2).
Hierarchical ones (MIN, MAX) keep one more part each: the sorted
multiset of (group key, non-NULL value), queried before and after the
step's insert (the group's first row is its MIN, its last row its MAX);
part 0 still runs and its ``__rows__`` decides whether a group is alive.
The basic collection aggregates raise ``NotImplementedError``: they need
read-time finalizers (ROADMAP Queue 1 item 15).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..arrangement.spine import Arrangement, insert, lookup_range
from ..expr import errors as _errors
from ..expr.relation import AggregateExpr, AggregateFunc
from ..expr.scalar import eval_expr
from ..plan.decisions import plan_reduce
from ..repr.batch import Batch
from ..repr.schema import ERR_SCHEMA, Column, ColumnType, Schema, torch_dtype
from .lanes import key_lanes
from .merge import merge_sorted
from .sort import apply_perm, compact, segment_ids, segment_starts, sort_perm


def accum_schema(input_schema: Schema, group_key, aggregates) -> Schema:
    """Schema of the reduce state arrangement."""
    cols = [input_schema[i] for i in group_key]
    cols.append(Column("__rows__", ColumnType.INT64))
    for j, agg in enumerate(aggregates):
        cols.extend(_accum_cols(j, agg))
    return Schema(cols)


def _accum_cols(j: int, agg: AggregateExpr) -> list:
    if agg.func is AggregateFunc.COUNT:
        return [Column(f"__a{j}_count__", ColumnType.INT64)]
    if agg.func is AggregateFunc.SUM_INT:
        return [Column(f"__a{j}_sum__", ColumnType.INT64),
                Column(f"__a{j}_nn__", ColumnType.INT64)]
    if agg.func is AggregateFunc.SUM_FLOAT:
        return [Column(f"__a{j}_sum__", ColumnType.FLOAT64),
                Column(f"__a{j}_nn__", ColumnType.INT64)]
    if agg.func in (AggregateFunc.ANY, AggregateFunc.ALL):
        return [Column(f"__a{j}_cnt__", ColumnType.INT64),
                Column(f"__a{j}_nn__", ColumnType.INT64)]
    raise NotImplementedError(
        f"aggregate {agg.func.value} is not ported (the collection "
        "aggregates need read-time finalizers: ROADMAP Queue 1 item 15)"
    )


# |running sum| beyond this bound is a NUMERIC_OUT_OF_RANGE error (the
# guard band is half the int64 range, so one step's delta cannot lap the
# detector).
_SUM_ERR_BOUND = 1 << 62


def _sum_err_batch(trans: torch.Tensor, out_time: int) -> Batch:
    """One err-stream update row carrying the net count of groups whose
    running sum crossed (+1) or re-entered (-1) the bound this step."""
    dev = trans.device
    return Batch(
        cols=(torch.full((1,), _errors.NUMERIC_OUT_OF_RANGE, dtype=torch.int64,
                         device=dev),),
        nulls=(None,),
        time=torch.full((1,), out_time, dtype=torch.int64, device=dev),
        diff=trans.reshape(1).to(torch.int64),
        count=torch.ones((), dtype=torch.int32, device=dev),
        schema=ERR_SCHEMA,
    )


def output_schema(input_schema: Schema, group_key, aggregates) -> Schema:
    cols = [input_schema[i] for i in group_key]
    for j, agg in enumerate(aggregates):
        c = agg.output_col(input_schema)
        cols.append(Column(f"{c.name}_{j}", c.ctype, c.nullable, c.scale))
    return Schema(cols)


def delta_contributions(batch: Batch, group_key, aggregates, state_schema: Schema,
                        time=None) -> Batch:
    """Map an input delta batch to accumulator-contribution rows (one per
    input row; ``sum_by_key`` groups them). Aggregate-input evaluation
    errors are not collected (as in the reference): they become NULL."""
    cols = [batch.cols[i] for i in group_key]
    nulls = [batch.nulls[i] for i in group_key]
    diff = batch.diff
    cols.append(diff.to(torch.int64))  # __rows__
    nulls.append(None)
    for agg in aggregates:
        ev = eval_expr(agg.expr, batch, time)
        nn = ~ev.null_mask()
        nn_i = nn.to(torch.int64) * diff
        if agg.func is AggregateFunc.COUNT:
            new = [nn_i]
        elif agg.func is AggregateFunc.SUM_INT:
            new = [torch.where(nn, ev.values.to(torch.int64), 0) * diff, nn_i]
        elif agg.func is AggregateFunc.SUM_FLOAT:
            new = [torch.where(nn, ev.values.to(torch.float64), 0.0)
                   * diff.to(torch.float64), nn_i]
        elif agg.func is AggregateFunc.ANY:
            new = [(ev.values & nn).to(torch.int64) * diff, nn_i]
        elif agg.func is AggregateFunc.ALL:
            new = [(~ev.values & nn).to(torch.int64) * diff, nn_i]
        else:
            _accum_cols(0, agg)  # raises, naming the aggregate
        cols.extend(new)
        nulls.extend([None] * len(new))
    return Batch(
        cols=tuple(cols),
        nulls=tuple(nulls),
        time=batch.time,
        # diff 1 per contribution row: accumulators are summed by
        # column on key collision, not multiset-counted.
        diff=batch.valid_mask().to(torch.int64),
        count=batch.count,
        schema=state_schema,
    )


# Device->host readbacks of a float sum's longest run (``_run_sums``).
RUN_READBACKS = 0


def _run_lengths(starts: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Per run's first row (``starts``; rows sorted by run), its row
    count; 0 elsewhere."""
    n = starts.shape[0]
    j = torch.arange(n, dtype=torch.int64, device=starts.device)
    # A run ends before the next start or the first padding row.
    bound = starts | ~valid
    nxt = torch.full_like(j, n)
    nxt[:-1] = torch.where(bound[1:], j[1:], n)
    end = torch.flip(torch.cummin(torch.flip(nxt, (0,)), 0).values, (0,))
    return torch.where(starts, end - j, 0)


def _run_sums(vals: torch.Tensor, starts: torch.Tensor, length: torch.Tensor,
              max_run: int) -> torch.Tensor:
    """Per row, the float sum of its run (rows sorted by run, ``starts``
    marking each run's first valid row, ``length`` its row count),
    added in row order from 0.0: ``((0.0 + v0) + v1) + ...``, the
    reference's scatter-add order. One pass per row of the longest run
    (``max_run``), every run in lockstep: a key holding many rows (a
    skewed graph's hub) costs as many passes."""
    n = vals.shape[0]
    j = torch.arange(n, dtype=torch.int64, device=vals.device)
    acc = torch.zeros_like(vals)
    for k in range(max_run):
        take = length > k
        acc = torch.where(take, acc + vals[torch.clamp(j + k, max=n - 1)], acc)
    lead = torch.cummax(torch.where(starts, j, 0), 0).values
    return acc[lead]


def sum_by_key(batch: Batch, n_key: int, presorted: bool = False,
               max_run: int | None = None) -> Batch:
    """Sort by the first ``n_key`` columns and sum every remaining
    (accumulator) column per key; one row per key survives, diff 1.
    ``presorted`` skips the sort for key-sorted input (a merge of two
    key-sorted runs); ``max_run`` bounds the rows a key can have there
    (else the longest run is read back: one sync, counted in
    ``RUN_READBACKS``).

    The reference's ``.at[seg].add(vals, mode="drop")`` becomes one
    int64 ``index_add_`` of the stacked int64 accumulator columns into a
    buffer with one spare row: padding rows (whose segment id may be -1)
    add into the spare row, which is sliced off. Float64 columns are
    summed in row order (``_run_sums``)."""
    global RUN_READBACKS
    cap = batch.capacity
    lanes = key_lanes(batch, range(n_key))
    if presorted:
        s = batch
    else:
        perm = sort_perm(lanes, batch.count, cap)
        s = apply_perm(batch, perm)
        lanes = [l[perm] for l in lanes]
    starts = segment_starts(lanes, s.count, cap)
    valid = s.valid_mask()
    dest = torch.where(valid, segment_ids(starts), cap)
    acc_cols = list(s.cols[n_key:])
    ints = [i for i, c in enumerate(acc_cols) if c.dtype != torch.float64]
    out_cols = list(acc_cols)
    if ints:
        acc = torch.stack([acc_cols[i] for i in ints], dim=1)
        sums = acc.new_zeros((cap + 1, acc.shape[1]))
        sums.index_add_(0, dest, torch.where(valid[:, None], acc, 0))
        # Each row takes its segment's total; padding rows read the
        # spare row (compact below drops them).
        for i, col in zip(ints, sums[dest].unbind(1)):
            out_cols[i] = col
    floats = [i for i, c in enumerate(acc_cols) if c.dtype == torch.float64]
    if floats:
        length = _run_lengths(starts, valid)
        if max_run is None:
            # The longest run, read back once for every float column.
            RUN_READBACKS += 1
            max_run = int(length.max()) if cap else 0
        for i in floats:
            out_cols[i] = _run_sums(acc_cols[i], starts, length, max_run)
    out = s.replace(
        cols=tuple(s.cols[:n_key]) + tuple(out_cols),
        diff=starts.to(s.diff.dtype),
    )
    return compact(out, starts)


def merge_accum_state(state: Arrangement, groups: Batch, out_capacity: int):
    """Merge per-group accumulator deltas (key-sorted and key-unique: the
    output of ``sum_by_key``) into the state arrangement, summing on key
    collision and dropping dead groups (``__rows__`` == 0). Returns
    (arrangement, overflowed)."""
    n_key = len(state.key)
    merged, overflow = merge_sorted(
        state.batch, key_lanes(state.batch, range(n_key)),
        groups, key_lanes(groups, range(n_key)),
        out_capacity,
    )
    # Both sides are key-unique: a key has at most 2 rows.
    summed = sum_by_key(merged, n_key, presorted=True, max_run=2)
    alive = summed.cols[n_key] != 0  # __rows__ > 0 (cannot go negative)
    return Arrangement(compact(summed, alive), state.key), overflow


def gather_old_accums(state: Arrangement, probe: Batch) -> tuple:
    """For each probe group row, the state's accumulator columns (zeros
    where the group is absent). Returns (gathered_cols, found)."""
    n_key = len(state.key)
    lo, hi = lookup_range(state, key_lanes(probe, range(n_key)))
    found = hi > lo
    # The reference's gather clamps; torch's raises: clamp by hand.
    idx = torch.clamp(lo, 0, max(state.capacity - 1, 0)).to(torch.int64)
    # One row gather per dtype (the float sums sit beside int64 ones).
    cols = state.batch.cols[n_key:]
    gathered = list(cols)
    for dtype in dict.fromkeys(c.dtype for c in cols):
        pos = [i for i, c in enumerate(cols) if c.dtype == dtype]
        acc = torch.stack([cols[i] for i in pos], dim=1)[idx]
        acc = torch.where(found[:, None], acc, torch.zeros_like(acc))
        for i, g in zip(pos, acc.unbind(1)):
            gathered[i] = g
    return gathered, found


def accums_to_output(key_cols, key_nulls, accum_cols, aggregates) -> tuple:
    """Accumulator columns -> (cols, nulls) of the output row per group
    (rows of dead groups are garbage; the caller masks them)."""
    cols = list(key_cols)
    nulls = list(key_nulls)
    i = 1  # accum_cols[0] is __rows__
    for agg in aggregates:
        if agg.func is AggregateFunc.COUNT:
            cols.append(accum_cols[i])
            nulls.append(None)
            i += 1
            continue
        v, nn = accum_cols[i], accum_cols[i + 1]
        if agg.func in (AggregateFunc.SUM_INT, AggregateFunc.SUM_FLOAT):
            cols.append(v)
        elif agg.func is AggregateFunc.ANY:
            cols.append(v > 0)
        elif agg.func is AggregateFunc.ALL:
            cols.append(v == 0)
        else:
            _accum_cols(0, agg)  # raises, naming the aggregate
        nulls.append(nn == 0)
        i += 2
    return cols, nulls


def minmax_state_schema(input_schema: Schema, group_key, agg: AggregateExpr) -> Schema:
    """State schema of one hierarchical (MIN/MAX) aggregate: the sorted
    multiset of (group key, non-NULL input value). NULL inputs never
    enter it, so the value column is non-nullable."""
    cols = [input_schema[i] for i in group_key]
    inner = agg.expr.typ(input_schema)
    cols.append(Column("__v__", inner.ctype, False, inner.scale))
    return Schema(cols)


def minmax_contributions(batch: Batch, group_key, agg: AggregateExpr,
                         state_schema: Schema, time=None) -> Batch:
    """An input delta as (key..., value) multiset updates; rows whose
    value is NULL get diff 0 and vanish in the insert's consolidation."""
    cols = [batch.cols[i] for i in group_key]
    nulls = [batch.nulls[i] for i in group_key]
    ev = eval_expr(agg.expr, batch, time)
    cols.append(ev.values.to(torch_dtype(state_schema[len(group_key)].dtype)))
    nulls.append(None)
    return Batch(
        cols=tuple(cols),
        nulls=tuple(nulls),
        time=batch.time,
        diff=torch.where(ev.null_mask(), 0, batch.diff),
        count=batch.count,
        schema=state_schema,
    )


def minmax_query(state: Arrangement, probe_lanes, is_max: bool):
    """The current MIN (or MAX) per probe group: the state is sorted by
    (key, value), so it is the first (last) row of the group's range.
    Returns (values, absent); absent where the group holds no non-NULL
    value (the SQL result is NULL)."""
    lo, hi = lookup_range(state, probe_lanes)
    found = hi > lo
    idx = torch.clamp(hi - 1 if is_max else lo, 0, max(state.capacity - 1, 0))
    vals = state.batch.cols[len(state.key)][idx.to(torch.int64)]
    return torch.where(found, vals, 0), ~found


def _or_zeros(mask, n: int, device) -> torch.Tensor:
    return mask if mask is not None else torch.zeros(n, dtype=torch.bool, device=device)


@dataclass
class ReduceOp:
    """A Reduce (``ReducePlan`` Accumulable, Distinct or Collation over
    accumulable and hierarchical aggregates). State: part 0 the
    accumulator Arrangement (always present: its ``__rows__`` column
    decides liveness), parts 1.. one sorted multiset per MIN/MAX."""

    input_schema: Schema
    group_key: tuple
    aggregates: tuple

    def __post_init__(self):
        self.n_key = len(self.group_key)
        if any(a.distinct for a in self.aggregates):
            # The reference's optimizer rewrites DISTINCT aggregates into
            # plain reduces before render; the port carries no optimizer.
            raise NotImplementedError(
                "DISTINCT aggregates are not ported (the optimizer's "
                "plan_distinct_aggregates rewrite)"
            )
        self.plan = plan_reduce(self.aggregates)
        if self.plan.basic:
            raise NotImplementedError(
                "the collection aggregates (STRING_AGG, ARRAY_AGG, LIST_AGG) "
                "are not ported: they need read-time finalizers (ROADMAP "
                "Queue 1 item 15)"
            )
        self.acc_aggs = tuple(self.aggregates[j] for j in self.plan.accumulable)
        self.hier_aggs = tuple(self.aggregates[j] for j in self.plan.hierarchical)
        self.state_schema = accum_schema(self.input_schema, self.group_key,
                                         self.acc_aggs)
        self.mm_schemas = tuple(
            minmax_state_schema(self.input_schema, self.group_key, a)
            for a in self.hier_aggs
        )
        self.out_schema = output_schema(self.input_schema, self.group_key,
                                        self.aggregates)
        # Accumulator columns of SUM_INT sums (offsets past the key), the
        # ones the sum-overflow error stream watches.
        self._sum_cols = []
        off = 1
        for j, agg in enumerate(self.acc_aggs):
            if agg.func is AggregateFunc.SUM_INT:
                self._sum_cols.append(off)
            off += len(_accum_cols(j, agg))

    def init_state(self, capacity: int = 256, device=None) -> tuple:
        key = tuple(range(self.n_key))
        return tuple(
            Arrangement.empty(sch, key, capacity, device=device)
            for sch in (self.state_schema,) + self.mm_schemas
        )

    def step(self, state: tuple, delta: Batch, out_time: int, errs=None):
        """Process one delta batch at logical time ``out_time``. With
        ``errs`` (the step's err sink) a SUM_INT reduce appends one
        sum-overflow err row. Returns (new_state, output delta,
        overflow: {part: flag})."""
        acc_state = state[0]
        dev = delta.device
        contrib = delta_contributions(delta, self.group_key, self.acc_aggs,
                                      self.state_schema, out_time)
        groups = sum_by_key(contrib, self.n_key)  # one row per touched group
        gcap = groups.capacity
        gvalid = groups.valid_mask()

        old_accums, _ = gather_old_accums(acc_state, groups)
        new_accums = [o + d for o, d in zip(old_accums, groups.cols[self.n_key:])]
        old_alive = gvalid & (old_accums[0] > 0)
        new_alive = gvalid & (new_accums[0] > 0)

        if errs is not None and self._sum_cols:
            # A group whose |running sum| crosses the bound adds an err
            # row; retracting inputs brings the wrapped sum back and
            # retracts it (int64 addition is a group).
            old = torch.stack([old_accums[c] for c in self._sum_cols], 1)
            new = torch.stack([new_accums[c] for c in self._sum_cols], 1)
            was = (old > _SUM_ERR_BOUND) | (old < -_SUM_ERR_BOUND)
            now = (new > _SUM_ERR_BOUND) | (new < -_SUM_ERR_BOUND)
            trans = torch.where(
                gvalid[:, None], now.to(torch.int64) - was.to(torch.int64), 0
            ).sum()
            errs.append(_sum_err_batch(trans, out_time))

        overflow = {}
        new_state_acc, overflow[0] = merge_accum_state(acc_state, groups,
                                                       acc_state.capacity)

        # Hierarchical parts: query before and after the multiset insert.
        probe = key_lanes(groups, range(self.n_key))
        mm_old, mm_new, new_mm_states = [], [], []
        for p, (agg, sch) in enumerate(zip(self.hier_aggs, self.mm_schemas), start=1):
            is_max = agg.func is AggregateFunc.MAX
            mm_old.append(minmax_query(state[p], probe, is_max))
            contrib_mm = minmax_contributions(delta, self.group_key, agg, sch, out_time)
            new_mm, overflow[p] = insert(state[p], contrib_mm, state[p].capacity)
            mm_new.append(minmax_query(new_mm, probe, is_max))
            new_mm_states.append(new_mm)

        key_cols = groups.cols[: self.n_key]
        key_nulls = groups.nulls[: self.n_key]

        def assemble(accums, mm_vals):
            """Output columns over every aggregate in order."""
            acc_cols, acc_nulls = accums_to_output(key_cols, key_nulls, accums,
                                                   self.acc_aggs)
            cols, nulls = list(key_cols), list(key_nulls)
            acc_i, mm_i = self.n_key, 0
            for agg in self.aggregates:
                if agg.func.is_accumulable:
                    cols.append(acc_cols[acc_i])
                    nulls.append(acc_nulls[acc_i])
                    acc_i += 1
                else:
                    vals, absent = mm_vals[mm_i]
                    cols.append(vals)
                    nulls.append(absent)
                    mm_i += 1
            return cols, nulls

        old_cols, old_nulls = assemble(old_accums, mm_old)
        new_cols, new_nulls = assemble(new_accums, mm_new)

        # Old and new rows are aligned per group, so "output unchanged"
        # is a columnwise comparison (no consolidation sort).
        changed = old_alive != new_alive
        for oc, nc, on, nn in zip(old_cols[self.n_key:], new_cols[self.n_key:],
                                  old_nulls[self.n_key:], new_nulls[self.n_key:]):
            on_m, nn_m = _or_zeros(on, gcap, dev), _or_zeros(nn, gcap, dev)
            changed = changed | (on_m != nn_m) | (~on_m & (oc != nc))

        out_nulls = []
        for on, nn in zip(old_nulls, new_nulls):
            if on is None and nn is None:
                out_nulls.append(None)
            else:
                out_nulls.append(torch.cat([_or_zeros(on, gcap, dev),
                                            _or_zeros(nn, gcap, dev)]))
        out_diff = torch.cat([
            -(old_alive & changed).to(torch.int64),
            (new_alive & changed).to(torch.int64),
        ])
        out = Batch(
            cols=tuple(torch.cat([oc, nc]) for oc, nc in zip(old_cols, new_cols)),
            nulls=tuple(out_nulls),
            time=torch.full((2 * gcap,), out_time, dtype=torch.int64, device=dev),
            diff=out_diff,
            count=torch.full((), 2 * gcap, dtype=torch.int32, device=dev),
            schema=self.out_schema,
        )
        return ((new_state_acc, *new_mm_states), compact(out, out_diff != 0),
                overflow)
