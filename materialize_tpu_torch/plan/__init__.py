"""The physical plan layer (LIR): MIR→LIR lowering and plan decisions
(the port's copy of ``materialize_tpu/plan/``).

Reference analog: the ``compute-types`` crate — ``LirRelationExpr``
(plan.rs:208), plan decisions (plan/lowering.rs:338), and the per-operator
plan enums (ReducePlan/TopKPlan/JoinPlan/ThresholdPlan).
"""

from .decisions import (  # noqa: F401
    INGEST_RING_SLOTS,
    ingest_mode,
    join_implementation,
    join_stage_keys,
    monotonic,
    plan_join,
    plan_reduce,
    plan_threshold,
    plan_topk,
    state_ingest_mode,
)
from .lir import (  # noqa: F401
    JoinPlan,
    LinearStagePlan,
    LirNode,
    ReducePlan,
    ThresholdPlan,
    TopKPlan,
)
from .lowering import explain_lir, lower_mir  # noqa: F401
