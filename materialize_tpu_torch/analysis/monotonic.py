"""Monotonicity / non-negativity analysis over MIR.

An abstract-interpretation lattice answering, per collection, the two
questions the planner cares about (reference analogs:
``transform/src/threshold_elision.rs``'s non-negative analysis and the
physical-monotonicity interpreter ``compute-types/src/plan/interpret/
physically_monotonic.rs``):

- ``nonneg``: can the maintained multiset ever hold a row at negative
  multiplicity? If not, a ``Threshold`` over it is the identity
  (threshold elision) — on TPU that elides a whole arrangement (device
  HBM + a sort-merge per step), not just an operator.
- ``append_only``: does the collection ever retract (emit a negative
  diff)? Append-only inputs let reduce/topk planning pick monotone
  fast paths (no retraction repair — TopKPlan::MonotonicTop1/TopK).

``append_only`` implies ``nonneg`` (a collection that never retracts
can never drive a multiplicity negative); ``meet`` is pointwise AND.

Facts flow through ``Let``/``LetRec`` via an environment — the fix for
the unsoundness the ad-hoc closure in threshold_elision had, where
``Get`` of a Let binding was assumed non-negative even when the bound
value contained a ``Negate`` (see tests/test_analysis_typecheck.py's
regression).

The port's copy of ``materialize_tpu/analysis/monotonic.py``: its relative imports reach the port's
``expr/`` and ``repr/``; it differs from the reference only where noted.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

from ..expr import relation as mir


@dataclass(frozen=True)
class Facts:
    """Abstract value for one collection."""

    nonneg: bool
    append_only: bool

    def __post_init__(self):
        if self.append_only and not self.nonneg:
            raise ValueError("append_only implies nonneg")

    def meet(self, other: "Facts") -> "Facts":
        return Facts(
            self.nonneg and other.nonneg,
            self.append_only and other.append_only,
        )


TOP = Facts(nonneg=True, append_only=True)
BOTTOM = Facts(nonneg=False, append_only=False)
# Sources are maintained collections: multiplicities never go negative
# (upsert/append ingestion), but they may retract (deletes).
SOURCE_DEFAULT = Facts(nonneg=True, append_only=False)


def analyze(
    expr: mir.RelationExpr,
    env: Mapping[str, Facts] | None = None,
    source_facts: Mapping[str, Facts] | None = None,
    default_source: Facts = SOURCE_DEFAULT,
) -> Facts:
    """Facts for ``expr``. ``env`` carries Let/LetRec binding facts
    (callers rewriting under binders thread it); ``source_facts``
    overrides per-source knowledge (the controller knows which load
    generators run insert-only)."""
    env = dict(env) if env else {}
    source_facts = source_facts or {}

    def go(e: mir.RelationExpr, env: dict) -> Facts:
        if isinstance(e, mir.Constant):
            nn = all(d >= 0 for _, d in e.rows)
            # A constant emits once and never changes: append-only iff
            # it emits nothing negative.
            return Facts(nn, nn)
        if isinstance(e, mir.Get):
            if e.name in env:
                return env[e.name]
            return source_facts.get(e.name, default_source)
        if isinstance(
            e,
            (mir.Project, mir.Map, mir.Filter, mir.FlatMap,
             mir.ArrangeBy),
        ):
            # Per-row operators scale multiplicities by a non-negative
            # factor (0 or 1; FlatMap by the table-function fan-out):
            # both facts pass through.
            return go(e.input, env)
        if isinstance(e, (mir.Join, mir.Union)):
            f = go(e.inputs[0], env)
            for i in e.inputs[1:]:
                f = f.meet(go(i, env))
            return f
        if isinstance(e, mir.Negate):
            return BOTTOM
        if isinstance(e, mir.Threshold):
            # Output multiplicities are clamped at >= 0 by definition;
            # it retracts only when its input's positive part shrinks,
            # which an append-only input never does.
            return Facts(True, go(e.input, env).append_only)
        if isinstance(e, (mir.Reduce, mir.TopK)):
            # Outputs are proper collections (multiplicity >= 0), but
            # group contents change under updates, so they retract even
            # over append-only input.
            return Facts(True, False)
        if isinstance(e, mir.Let):
            env2 = dict(env)
            env2[e.name] = go(e.value, env)
            return go(e.body, env2)
        if isinstance(e, mir.LetRec):
            # Conservative: recursive bindings start (and stay) at
            # BOTTOM — a sound one-shot approximation; iterating to a
            # fixpoint from TOP could only improve precision.
            env2 = dict(env)
            for n in e.names:
                env2[n] = BOTTOM
            return go(e.body, env2)
        return BOTTOM

    return go(expr, env)
