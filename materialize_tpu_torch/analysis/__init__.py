"""Static and runtime analyses over MIR/LIR plans and the port's device
state (the port's copy of ``materialize_tpu/analysis/__init__.py``).

- ``typecheck``: bottom-up MIR validation (schema flow, column-ref
  bounds, binding discipline, plan-decision consistency), run between
  optimizer transforms behind the ``optimizer_typecheck`` dyncfg so a
  transform bug is blamed on the transform that introduced it, and on
  every durable plan the coordinator ships.
- ``monotonic``: the non-negativity / append-only lattice over MIR.
- ``provenance`` / ``donation``: which holders (span carry, rollback
  checkpoints, multiversion history, ``IndexSource`` snapshots) share a
  device buffer, the per-view donation verdict, and the use-after-donate
  sanitizer (dyncfg ``buffer_sanitizer``). A leaf is a ``torch.Tensor``
  identified by its storage.
- ``shard_prop``: the sharding report of any dataflow: the trivial one
  of a single-device dataflow, and a ``ShardedDataflow``'s ingest mode,
  cursors (shard-local by construction) and the census of the
  collectives its last step issued.
- ``racecheck``: the happens-before race detector over the control
  plane's declared shared state (dyncfg ``race_detector``).
- ``step_lint``: the counterpart of the reference's ``jaxpr_lint``. One
  real step recorded under a ``TorchDispatchMode`` (every aten operation
  with its dtypes, shapes, devices and bytes, the hand kernel's launches,
  the collectives) is the port's step program; the reference's finding
  kinds, ``op_census``, ``kernel_count`` and ``intermediate_bytes`` read
  it.
- ``host_sync``: AST lint of the per-span hot path's source for host
  syncs and uploads, paired with ``step_lint``'s host reads.
- ``interleave``: the DPOR interleaving explorer over the control
  plane's protocols (imported directly, as in the reference).

The reference's ``shard_prop`` prover (``comm_census``,
``spmd_safety``, ``sharded_step_report`` over a step program) and the
lowering half of ``donation`` wait for a captured CUDA graph to read
(ROADMAP Queue 1 item 3).
"""

from .donation import (  # noqa: F401
    LEDGER,
    UNSOUND_DONATION,
    USE_AFTER_DONATE,
    DonationVerdict,
    UseAfterDonateError,
    dataflow_verdict,
    guard_read,
    record_donated,
    verdict_display,
    view_verdict,
)
from .monotonic import (  # noqa: F401
    BOTTOM,
    SOURCE_DEFAULT,
    TOP,
    Facts,
    analyze,
)
from .provenance import (  # noqa: F401
    PROV_CACHE,
    PROV_CARRY,
    PROV_HOST,
    PROV_SHARED,
    ProvenanceReport,
    scan_dataflow,
    scan_replica,
    scan_view,
)
from .shard_prop import (  # noqa: F401
    dataflow_sharding_report,
    sharding_display,
    single_device_report,
)
from .typecheck import (  # noqa: F401
    TransformTypecheckError,
    TypecheckError,
    typecheck,
    typecheck_lir,
)
from . import racecheck  # noqa: F401
from .racecheck import RaceFinding  # noqa: F401


def report(expr, source_monotonic=frozenset()) -> str:
    """Text summary of every analysis over one MIR plan (the EXPLAIN
    ANALYSIS payload): typecheck verdict, monotonicity facts of the
    output collection, and LIR plan-decision consistency."""
    lines = []
    try:
        sch = typecheck(expr)
        lines.append(
            "typecheck: ok "
            f"(arity={sch.arity}, "
            f"types=[{', '.join(c.ctype.value for c in sch.columns)}])"
        )
    except TypecheckError as e:
        # The downstream passes assume a well-typed tree, so a plan that
        # fails typecheck reports only the verdict.
        lines.append(f"typecheck: FAILED: {e}")
        lines.append("monotonicity: skipped (plan does not typecheck)")
        lines.append("lir: skipped (plan does not typecheck)")
        return "\n".join(lines)
    facts = analyze(
        expr,
        source_facts={
            n: TOP for n in source_monotonic
        },
    )
    lines.append(
        f"monotonicity: nonneg={str(facts.nonneg).lower()} "
        f"append_only={str(facts.append_only).lower()}"
    )
    try:
        typecheck_lir(expr)
        lines.append("lir: ok")
    except TypecheckError as e:
        lines.append(f"lir: FAILED: {e}")
    return "\n".join(lines)
