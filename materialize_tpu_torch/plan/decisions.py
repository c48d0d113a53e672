"""The plan decisions the port's slices need (the port's copy of part of
``materialize_tpu/plan/decisions.py`` and of ``plan/lir.py:ReducePlan``):
the capacity quantization menu, the ingest modes of the output index and
of operator-state spines, the Reduce, TopK and Threshold plans, the join
implementation and the linear join's stage keys. Capacities must match
the reference's tier for tier, so overflow, rollback and replay land on
the same ticks in both packages."""

from __future__ import annotations

from dataclasses import dataclass

from ..expr import relation as mir
from ..expr.scalar import ColumnRef

# Append-slot ring length (tracks the default compaction cadence).
INGEST_RING_SLOTS = 8

QUANT_MENU_FLOOR = 256

# A join of at least this many inputs renders as a delta join (the
# reference's ``delta_join_min_inputs`` dyncfg default).
DELTA_JOIN_MIN_INPUTS = 3


def quantize_cap(n: int, minimum: int = QUANT_MENU_FLOOR) -> int:
    """Snap a requested capacity up to its pow2 menu rung."""
    cap = max(int(minimum), 1)
    while cap < n:
        cap *= 2
    return cap


def ingest_mode(state_capacity: int, tail_capacity: int = 1024) -> str:
    """Spine hot-path ingest: 'append_slot' (each delta lands in a slot,
    O(delta) per step) once the state tier is at least 8x the ingest
    tier, else 'merge' (every step merges into run 0). The reference's
    'auto' rule; its dyncfg override is not carried over."""
    return "append_slot" if state_capacity >= 8 * tail_capacity else "merge"


def state_ingest_mode(state_capacity: int, tail_capacity: int = 1024) -> str:
    """Ingest for operator-state spines (the delta join's arrangements):
    the same 'auto' rule as the output index, on one device."""
    return ingest_mode(state_capacity, tail_capacity)


@dataclass(frozen=True)
class ReducePlan:
    """How a Reduce executes. ``kind``: Distinct (no aggregates),
    Accumulable (every aggregate folds into per-group accumulators),
    Hierarchical, Basic or Collation (a mix). The positions say which
    aggregates take which path."""

    kind: str
    accumulable: tuple = ()
    hierarchical: tuple = ()
    basic: tuple = ()


def plan_reduce(aggregates) -> ReducePlan:
    """Partition aggregates into accumulable, hierarchical and basic, and
    pick the reduce plan."""
    if not aggregates:
        return ReducePlan("Distinct")
    acc = tuple(j for j, a in enumerate(aggregates) if a.func.is_accumulable)
    hier = tuple(j for j, a in enumerate(aggregates) if a.func.is_hierarchical)
    basic = tuple(j for j, a in enumerate(aggregates) if a.func.is_basic)
    if not hier and not basic:
        return ReducePlan("Accumulable", acc, ())
    if not acc and not basic:
        # The accumulator part still runs (its __rows__ column is the
        # group-liveness authority).
        return ReducePlan("Collation", (), hier)
    if basic and not acc and not hier:
        return ReducePlan("Basic", (), (), basic)
    return ReducePlan("Collation", acc, hier, basic)


def join_implementation(expr: mir.Join) -> str:
    """Resolve ``implementation='auto'``: delta for at least
    ``DELTA_JOIN_MIN_INPUTS`` inputs, linear otherwise."""
    impl = expr.implementation
    if impl == "auto":
        impl = "delta" if len(expr.inputs) >= DELTA_JOIN_MIN_INPUTS else "linear"
    return impl


@dataclass(frozen=True)
class TopKPlan:
    """How a TopK executes. One sorted arrangement serves every kind;
    ``kind`` records whether the input is monotonic (MonotonicTop1,
    MonotonicTopK) or may retract (Basic)."""

    kind: str
    group_key: tuple = ()
    limit: int | None = None
    offset: int = 0


def plan_topk(expr: mir.TopK, input_monotonic: bool) -> TopKPlan:
    if input_monotonic and expr.limit == 1 and not expr.offset:
        kind = "MonotonicTop1"
    elif input_monotonic:
        kind = "MonotonicTopK"
    else:
        kind = "Basic"
    return TopKPlan(kind, tuple(expr.group_key), expr.limit, expr.offset)


@dataclass(frozen=True)
class ThresholdPlan:
    """How a Threshold executes: through an arrangement on all columns
    (the one kind, "Basic")."""

    kind: str = "Basic"


def plan_threshold(expr: mir.Threshold) -> ThresholdPlan:
    return ThresholdPlan()


def join_stage_keys(expr: mir.Join, offsets: list, stage: int):
    """Join keys of the linear-join stage that brings in input
    ``stage``: pairs (accumulated column, column of the input) from the
    equivalence classes with a member on each side. Returns (left key,
    right key, indices of the classes consumed)."""
    lo, hi = offsets[stage], offsets[stage + 1]
    left_key, right_key, consumed = [], [], []
    for ci, cls in enumerate(expr.equivalences):
        cols = []
        for e in cls:
            if not isinstance(e, ColumnRef):
                raise NotImplementedError(
                    "join equivalences must be column references "
                    "(pre-map complex exprs)"
                )
            cols.append(e.index)
        lefts = [c for c in cols if c < lo]
        rights = [c for c in cols if lo <= c < hi]
        if lefts and rights:
            left_key.append(lefts[0])
            right_key.append(rights[0] - lo)
            consumed.append(ci)
            if len(lefts) > 1 or len(rights) > 1:
                raise NotImplementedError(
                    ">2-member equivalence classes need residual filters"
                )
    return tuple(left_key), tuple(right_key), consumed
