"""LIR: the physical plan layer between MIR and render (the port's copy
of ``materialize_tpu/plan/lir.py``).

Analog of the reference's ``compute-types`` plan layer
(``compute-types/src/plan.rs:208`` LirRelationExpr, the MIR→LIR lowering
decisions at ``plan/lowering.rs:338``, and the per-operator plan enums:
``ReducePlan`` plan/reduce.rs:130, ``TopKPlan`` plan/top_k.rs:28,
``JoinPlan`` plan/join.rs:46, ``ThresholdPlan`` plan/threshold.rs:34).

The decisions recorded here are the SAME ones the render layer executes
(render/dataflow.py and ops/reduce.py import the decision functions from
this package), so
``EXPLAIN PHYSICAL PLAN`` is the runtime truth, not a parallel guess —
the reference's EXPLAIN-to-runtime traceability (LirId mapping,
compute/src/logging/compute.rs ComputeEvent::LirMapping).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class ReducePlan:
    """How a Reduce executes (plan/reduce.rs:130 analog).

    kind:
      Distinct     — no aggregates: arrangement of group keys.
      Accumulable  — all aggregates fold into per-group accumulators
                     (sums/counts; render/reduce.rs:1357).
      Hierarchical — min/max via a sorted (key, value) multiset per
                     aggregate: retraction repair is a binary search
                     (the reference's 16-ary tournament,
                     render/reduce.rs:850, re-designed).
      Basic        — collection aggregates (string_agg/array_agg/
                     list_agg): sorted (key, value) multiset state +
                     digest accumulator, finalized at the serving edge
                     (render/reduce.rs:369 build_basic_aggregate).
      Collation    — mix of the above, collated into one output row
                     (render/reduce.rs build_collation).
    """

    kind: str
    accumulable: tuple = ()  # aggregate positions
    hierarchical: tuple = ()  # aggregate positions
    basic: tuple = ()  # aggregate positions

    def describe(self) -> str:
        if self.kind in ("Distinct", "Accumulable", "Hierarchical",
                         "Basic"):
            return self.kind
        parts = [
            f"accumulable={list(self.accumulable)}",
            f"hierarchical={list(self.hierarchical)}",
        ]
        if self.basic:
            parts.append(f"basic={list(self.basic)}")
        return f"Collation({', '.join(parts)})"


@dataclass(frozen=True)
class LinearStagePlan:
    """One binary stage of a linear join (linear_join.rs:204)."""

    left_key: tuple
    right_key: tuple


@dataclass(frozen=True)
class JoinPlan:
    """Linear (sequence of binary stages against arrangements) or Delta
    (per-input update pipelines over shared arrangements; delta_join.rs)."""

    kind: str  # "Linear" | "Delta"
    stages: tuple = ()  # Linear: LinearStagePlan per stage
    n_pipelines: int = 0  # Delta
    arrangements: tuple = ()  # Delta: (input, key) specs

    def describe(self) -> str:
        if self.kind == "Linear":
            keys = ", ".join(
                f"[{list(s.left_key)}={list(s.right_key)}]"
                for s in self.stages
            )
            return f"Linear({keys})"
        arrs = ", ".join(
            f"in{j}@{list(k)}" for j, k in self.arrangements
        )
        return f"Delta(pipelines={self.n_pipelines}, arrangements=[{arrs}])"


@dataclass(frozen=True)
class TopKPlan:
    """TopK execution plan (plan/top_k.rs:28 analog).

    The port maintains ONE sorted arrangement with segmented prefix-sum
    multiplicity windows for every variant (ops/topk.py), as the
    reference does —
    the reference's MonotonicTop1/MonotonicTopK/Basic distinction
    collapses at runtime, but the plan still records monotonicity (from
    the physical monotonicity interpreter, plan/interpret analog) since
    a monotonic input needs no retraction repair.
    """

    kind: str  # "MonotonicTop1" | "MonotonicTopK" | "Basic"
    group_key: tuple = ()
    limit: Optional[int] = None
    offset: int = 0

    def describe(self) -> str:
        lim = "" if self.limit is None else f", limit={self.limit}"
        off = "" if not self.offset else f", offset={self.offset}"
        return f"{self.kind}(group={list(self.group_key)}{lim}{off})"


@dataclass(frozen=True)
class ThresholdPlan:
    """Retain records with positive multiplicity, via an arrangement on
    all columns (plan/threshold.rs:34)."""

    kind: str = "Basic"

    def describe(self) -> str:
        return self.kind


@dataclass
class LirNode:
    """One physical operator: op name, its plan decision, and inputs.
    ``lir_id`` numbers nodes in post-order (LirId analog)."""

    lir_id: int
    op: str
    detail: str = ""
    children: list = field(default_factory=list)
