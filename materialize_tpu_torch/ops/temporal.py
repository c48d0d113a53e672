"""Temporal filters: predicates over ``mz_now()`` with scheduled futures
(the port of ``materialize_tpu/ops/temporal.py``).

A predicate like ``mz_now() >= lo AND mz_now() < hi`` makes a row active
during the virtual-time window [lo, hi). The operator emits a row's
insertion at ``max(lo, now)`` and schedules its retraction at ``hi``: it
keeps the future updates in a buffer whose time column holds each one's
release time, and drains what is due as time passes.

Bound canonicalization (render layer):
    mz_now() >= e  ->  lo = e            e >= mz_now()  ->  hi = e + 1
    mz_now() >  e  ->  lo = e + 1        e >  mz_now()  ->  hi = e
    mz_now() <= e  ->  hi = e + 1        e <= mz_now()  ->  lo = e
    mz_now() <  e  ->  hi = e            e <  mz_now()  ->  lo = e + 1
A NULL bound makes the predicate unknown: the row is never active.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..arrangement.spine import Arrangement
from ..expr.scalar import BinaryFunc, CallBinary, MzNow, contains_mz_now, eval_expr
from ..ops.consolidate import consolidate
from ..ops.sort import compact, concat_batches, shrink
from ..repr.batch import Batch
from ..repr.schema import Schema

# Far-future sentinel: "no upper bound" (leaves headroom for the +1 of
# the canonicalization while beyond any real time).
NO_UPPER = 1 << 62

# (bare mz_now() on the left?, comparison) -> (bound, offset added to e)
_BOUNDS = {
    (True, BinaryFunc.GTE): ("lo", 0), (True, BinaryFunc.GT): ("lo", 1),
    (True, BinaryFunc.LTE): ("hi", 1), (True, BinaryFunc.LT): ("hi", 0),
    (False, BinaryFunc.GTE): ("hi", 1), (False, BinaryFunc.GT): ("hi", 0),
    (False, BinaryFunc.LTE): ("lo", 0), (False, BinaryFunc.LT): ("lo", 1),
}


def canonicalize_temporal(predicates) -> tuple:
    """Split temporal predicates into (lo_exprs, hi_exprs) per the table
    above. Only comparisons with a bare ``mz_now()`` on one side are
    supported."""
    bounds: dict = {"lo": [], "hi": []}
    for p in predicates:
        if not isinstance(p, CallBinary):
            raise NotImplementedError(
                f"unsupported temporal predicate {p!r}: mz_now() must appear in a "
                "plain comparison"
            )
        l, r, f = p.left, p.right, p.func
        if isinstance(l, MzNow) and not contains_mz_now(r):
            now_left, e = True, r
        elif isinstance(r, MzNow) and not contains_mz_now(l):
            now_left, e = False, l
        else:
            raise NotImplementedError("temporal predicate needs a bare mz_now() on one side")
        if (now_left, f) not in _BOUNDS:
            raise NotImplementedError(f"temporal comparison {f!r} (use <,<=,>,>=)")
        side, plus = _BOUNDS[(now_left, f)]
        bounds[side].append(e + 1 if plus else e)
    return bounds["lo"], bounds["hi"]


@dataclass
class TemporalFilterOp:
    """State: one Arrangement of scheduled future updates, keyed by all
    columns (the time column holds each update's release time). Per
    step: each input row's window, what is active now emitted, future
    insertions and retractions buffered, everything due drained.
    n_parts = 1."""

    schema: Schema
    lo_exprs: tuple  # lower bounds (the largest wins)
    hi_exprs: tuple  # EXCLUSIVE upper bounds (the smallest wins)

    def __post_init__(self):
        self.out_schema = self.schema
        self.key = tuple(range(self.schema.arity))
        self.n_parts = 1

    def init_state(self, capacity: int = 256, device=None) -> tuple:
        return (Arrangement.empty(self.schema, self.key, capacity, device=device),)

    def _bounds(self, batch: Batch, time: int):
        """Per-row (lo, hi, defined) as int64 virtual times."""
        cap, dev = batch.capacity, batch.device
        defined = torch.ones(cap, dtype=torch.bool, device=dev)

        def fold(exprs, start, pick):
            nonlocal defined
            acc = torch.full((cap,), start, dtype=torch.int64, device=dev)
            for e in exprs:
                ev = eval_expr(e, batch, time)
                defined = defined & ~ev.null_mask()
                acc = pick(acc, ev.values.to(torch.int64))
            return acc

        lo = fold(self.lo_exprs, 0, torch.maximum)
        hi = fold(self.hi_exprs, NO_UPPER, torch.minimum)
        return lo, hi, defined

    def step(self, state: tuple, delta: Batch, out_time: int, out_cap: int | None = None):
        """Returns (new_state, out_delta, state_overflow: dict
        part->flag, out_overflow). ``out_cap`` is the output tier (grown
        by the host on ``out_overflow``: a larger buffer cannot fix an
        output overflow, so the flags are apart)."""
        out_cap = out_cap if out_cap is not None else delta.capacity
        (buf,) = state
        t = int(out_time)
        lo, hi, defined = self._bounds(delta, t)
        nonempty = delta.valid_mask() & defined & (lo < hi)
        # Active now (lo <= t < hi): emitted at t.
        now_out = compact(delta.replace(time=torch.full_like(delta.time, t)),
                          nonempty & (lo <= t) & (t < hi))
        # Future insertion (lo > t): +d scheduled at lo.
        fut_ins = compact(delta.replace(time=lo), nonempty & (lo > t))
        # Future retraction (t < hi, bounded): -d scheduled at hi; a row
        # already dead (hi <= t) contributes nothing.
        fut_ret = compact(delta.replace(time=hi, diff=-delta.diff),
                          nonempty & (hi > t) & (hi < NO_UPPER))
        # The buffer consolidates WITH its time column: distinct release
        # times stay apart, while an insert and its own retraction
        # scheduled at one release time cancel.
        merged = consolidate(concat_batches([buf.batch, fut_ins, fut_ret]), include_time=True)
        merged, ovf1 = shrink(merged, buf.capacity)
        valid = merged.valid_mask()
        due = valid & (merged.time <= t)
        due_out = compact(merged.replace(time=torch.full_like(merged.time, t)), due)
        kept = compact(merged, valid & ~due)
        out, ovf2 = shrink(concat_batches([now_out, due_out]), out_cap)
        return (Arrangement(kept, self.key),), out, {0: ovf1}, ovf2
