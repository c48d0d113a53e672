"""The plan decisions the port's slices need (the port's copy of part of
``materialize_tpu/plan/decisions.py`` and of ``plan/lir.py:ReducePlan``):
the capacity quantization menu, the ingest modes of the output index and
of operator-state spines, the Reduce plan and the join implementation. Capacities must match the reference's tier for tier, so
overflow, rollback and replay land on the same ticks in both packages."""

from __future__ import annotations

from dataclasses import dataclass

from ..expr import relation as mir

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
