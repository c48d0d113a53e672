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


# -- the peek fast path (coord/peek.py serves what this recognizes) ---------


@dataclass(frozen=True)
class PeekPlan:
    """EXPLAIN-visible fast-path peek decision:
    how a SELECT over a peekable (indexed / materialized) relation is
    served without rendering a transient dataflow.

    kind: "scan"   — gather every maintained row (O(result): the scan
                     IS the result);
          "lookup" — equality constraints on ``bound`` columns,
                     row-gathered from the maintained spine (a full-
                     column binding rides the cached hash key lanes +
                     lex_searchsorted_2d; partial bindings run the
                     masked-compaction gather);
          "empty"  — constraints are contradictory or compare against
                     NULL: zero rows, zero dispatches.
    bound: ((base column index, Literal), ...), column-sorted.
    projection: output column -> base column map (None = identity),
    applied host-side on the gathered rows — O(result) work."""

    kind: str
    name: str
    bound: tuple = ()
    projection: "tuple | None" = None

    def describe(self) -> str:
        if self.kind == "empty":
            return (
                f"fast path: empty result over {self.name!r} "
                "(contradictory or NULL equality — zero dispatches)"
            )
        if self.kind == "scan":
            return (
                f"fast path: full index scan of {self.name!r} "
                "(O(result) gather, no dataflow)"
            )
        cols = [c for c, _ in self.bound]
        return (
            f"fast path: index lookup on {self.name!r} bound={cols} "
            "(O(result) gather, no dataflow)"
        )


def _eq_col_literal(pred):
    """`col = literal` (either side), else None."""
    from ..expr.scalar import BinaryFunc, CallBinary, Literal

    if (
        not isinstance(pred, CallBinary)
        or pred.func != BinaryFunc.EQ
    ):
        return None
    a, b = pred.left, pred.right
    if isinstance(a, ColumnRef) and isinstance(b, Literal):
        return a.index, b
    if isinstance(b, ColumnRef) and isinstance(a, Literal):
        return b.index, a
    return None


def _literal_binds(lit, col) -> "str | None":
    """Can this literal's INTERNAL value be compared raw against the
    column's device representation? Literal values are already internal
    (string dictionary codes, scaled decimals, epoch ints — see
    expr/scalar.eval_expr), so same-type comparisons are exact.
    Returns "bind" (probe raw), "empty" (provably no match: an
    out-of-range cross-width integer literal — casting it to the
    column dtype would overflow or wrap), or None (slow path:
    cross-family comparisons like float-vs-int, where XLA promotes
    and a raw compare would change semantics)."""
    from ..repr.schema import ColumnType

    litcol = lit.typ(None)
    if litcol.ctype == col.ctype:
        if col.ctype is ColumnType.DECIMAL and litcol.scale != col.scale:
            return None
        return "bind"
    ints = (ColumnType.INT32, ColumnType.INT64)
    if litcol.ctype in ints and col.ctype in ints:
        if col.ctype is ColumnType.INT32 and not (
            -(1 << 31) <= int(lit.value) < (1 << 31)
        ):
            # No INT32 value equals this literal; the probe cast would
            # overflow (numpy>=2 raises) or wrap (matching wrong rows).
            return "empty"
        return "bind"
    return None


def peek_fast_path(
    expr: mir.RelationExpr, peekable: frozenset
) -> "PeekPlan | None":
    """Recognize an optimized SELECT servable in O(result) from a
    maintained arrangement: a chain of Project/Filter layers over a
    Get of a peekable relation, where every Filter predicate is a
    column-equality against a literal. Returns None (slow path: render
    a transient dataflow) otherwise. Shared by the coordinator's
    sequencing and EXPLAIN ANALYSIS — the printed decision is exactly
    what serves."""
    chain = []
    node = expr
    while isinstance(node, (mir.Project, mir.Filter)):
        chain.append(node)
        node = node.input
    if not isinstance(node, mir.Get) or node.name not in peekable:
        return None
    base_schema = node.schema()
    arity = base_schema.arity
    if arity == 0:
        return None
    colmap = list(range(arity))  # current-level column -> base column
    bound: dict = {}
    empty = False
    for layer in reversed(chain):  # apply bottom-up
        if isinstance(layer, mir.Filter):
            for p in layer.predicates:
                eq = _eq_col_literal(p)
                if eq is None:
                    return None
                ref, lit = eq
                if ref >= len(colmap):
                    return None  # malformed; let the slow path error
                base = colmap[ref]
                if lit.value is None:
                    # `col = NULL` is never true in SQL.
                    empty = True
                    continue
                binds = _literal_binds(lit, base_schema.columns[base])
                if binds is None:
                    return None
                if binds == "empty":
                    empty = True
                    continue
                prev = bound.get(base)
                if prev is not None and prev.value != lit.value:
                    empty = True
                bound[base] = lit
        else:  # Project
            if any(o >= len(colmap) for o in layer.outputs):
                return None
            colmap = [colmap[o] for o in layer.outputs]
    projection = (
        tuple(colmap) if colmap != list(range(arity)) else None
    )
    if empty:
        return PeekPlan("empty", node.name, (), projection)
    if bound:
        return PeekPlan(
            "lookup",
            node.name,
            tuple(sorted(bound.items())),
            projection,
        )
    return PeekPlan("scan", node.name, (), projection)
