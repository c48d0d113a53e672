"""The MIR→LIR plan decisions, shared by EXPLAIN and the render layer
(the port's copy of ``materialize_tpu/plan/decisions.py``).

Single source of truth: render/dataflow.py and ops/reduce.py import these
functions, so the printed physical plan (``EXPLAIN PHYSICAL PLAN``,
plan/lowering.py) is exactly what executes. Capacities must match the
reference's tier for tier, so overflow, rollback and replay land on the
same ticks in both packages.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..expr import relation as mir
from ..expr.scalar import ColumnRef
from .lir import (
    JoinPlan,
    LinearStagePlan,
    ReducePlan,
    ThresholdPlan,
    TopKPlan,
)

# Append-slot ring length: must cover every insert between level-0 folds
# (render/dataflow.py _check_slot_ring), so it tracks the default
# compaction cadence (Dataflow._compact_every).
INGEST_RING_SLOTS = 8

# Capacity-tier quantization: every capacity snaps to this pow2 menu
# (the reference keys its program bank on it; the port keeps the same
# tiers so overflows land on the same ticks). The floor matches
# repr/batch.capacity_tier's default minimum.
QUANT_MENU_FLOOR = 256


def quantize_cap(n: int, minimum: int = QUANT_MENU_FLOOR) -> int:
    """Snap a requested capacity up to its pow2 menu rung."""
    cap = max(int(minimum), 1)
    while cap < n:
        cap *= 2
    return cap


def quantization_menu(
    floor: int = QUANT_MENU_FLOOR, ceiling: int = 1 << 24
) -> tuple:
    """The full rung menu (doc/EXPLAIN surface)."""
    out, cap = [], max(int(floor), 1)
    while cap <= ceiling:
        out.append(cap)
        cap *= 2
    return tuple(out)


def _spmd_gate(mode: str, spmd: bool, spmd_safe) -> str:
    """The SPMD slot gate: under SPMD, append-slot ingest is enabled
    only where a shard-spec prover has verdicted the per-device slot
    cursor shard-local (``spmd_safe`` True); an unproven (None) or
    refuted (False) verdict resolves to merge. The port's
    ``ShardedDataflow`` passes True: each rank's cursor is a host int of
    its own process. Single-device dataflows (spmd=False) are
    unaffected."""
    if spmd and mode == "append_slot" and spmd_safe is not True:
        return "merge"
    return mode


def ingest_mode(
    state_capacity: int,
    tail_capacity: int = 1024,
    spmd: bool = False,
    spmd_safe=None,
) -> str:
    """Spine hot-path ingest decision. 'append_slot': each arranged
    delta lands in a run-0 append slot — O(delta) per step, with the
    level-0 fold absorbing the ring on its amortized cadence. 'merge':
    every step merges into run 0 — O(run0) per step, fine while run 0
    is delta-sized. The ``arrangement_ingest_mode`` dyncfg forces one;
    its 'auto' takes append-slot once the state tier is at least 8x the
    ingest tier."""
    from ..utils.dyncfg import (
        ARRANGEMENT_INGEST_MODE,
        COMPUTE_CONFIGS,
    )

    mode = ARRANGEMENT_INGEST_MODE(COMPUTE_CONFIGS)
    if mode == "auto":
        mode = (
            "append_slot"
            if state_capacity >= 8 * tail_capacity
            else "merge"
        )
    return _spmd_gate(mode, spmd, spmd_safe)


def state_ingest_mode(
    state_capacity: int,
    tail_capacity: int = 1024,
    spmd: bool = False,
    spmd_safe=None,
) -> str:
    """Ingest decision for OPERATOR-STATE spines (the delta join's
    arrangements): the same dyncfg and the same 'auto' rule as the
    output index (ingest_mode)."""
    from ..utils.dyncfg import (
        ARRANGEMENT_INGEST_MODE,
        COMPUTE_CONFIGS,
    )

    mode = ARRANGEMENT_INGEST_MODE(COMPUTE_CONFIGS)
    if mode == "auto":
        mode = (
            "append_slot"
            if state_capacity >= 8 * tail_capacity
            else "merge"
        )
    return _spmd_gate(mode, spmd, spmd_safe)


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
    ``delta_join_min_inputs`` (dyncfg) inputs, linear otherwise."""
    impl = expr.implementation
    if impl == "auto":
        from ..utils.dyncfg import COMPUTE_CONFIGS, DELTA_JOIN_MIN_INPUTS

        impl = (
            "delta"
            if len(expr.inputs) >= DELTA_JOIN_MIN_INPUTS(COMPUTE_CONFIGS)
            else "linear"
        )
    return impl


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


def plan_join(expr: mir.Join) -> JoinPlan:
    impl = join_implementation(expr)
    if impl == "delta":
        from ..ops.delta_join import _plan_pipelines

        arities = [i.schema().arity for i in expr.inputs]
        pipelines, arr_specs = _plan_pipelines(
            len(expr.inputs), arities, expr.equivalences
        )
        return JoinPlan(
            "Delta",
            n_pipelines=len(pipelines),
            arrangements=tuple((j, tuple(k)) for j, k in arr_specs),
        )
    offsets = [0]
    for i in expr.inputs:
        offsets.append(offsets[-1] + i.schema().arity)
    stages = []
    for s in range(1, len(expr.inputs)):
        lk, rk, _ = join_stage_keys(expr, offsets, s)
        stages.append(LinearStagePlan(lk, rk))
    return JoinPlan("Linear", stages=tuple(stages))


def plan_topk(expr: mir.TopK, input_monotonic: bool) -> TopKPlan:
    if input_monotonic and expr.limit == 1 and not expr.offset:
        kind = "MonotonicTop1"
    elif input_monotonic:
        kind = "MonotonicTopK"
    else:
        kind = "Basic"
    return TopKPlan(
        kind, tuple(expr.group_key), expr.limit, expr.offset
    )


def plan_threshold(expr: mir.Threshold) -> ThresholdPlan:
    return ThresholdPlan()


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


# -- physical monotonicity (plan/interpret/physically_monotonic.rs) ----------


def monotonic(expr: mir.RelationExpr, source_monotonic=frozenset()):
    """Can this collection ever retract? Delegates to the monotonicity
    lattice (analysis/monotonic.py), which threads facts through
    Let/LetRec bindings via an environment. Sources are append-only iff
    named in `source_monotonic`; every source is assumed non-negative
    either way."""
    from ..analysis.monotonic import SOURCE_DEFAULT, TOP, analyze

    return analyze(
        expr,
        source_facts={n: TOP for n in source_monotonic},
        default_source=SOURCE_DEFAULT,
    ).append_only
