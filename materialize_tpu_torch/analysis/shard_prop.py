"""The sharding report and its prover over recorded steps (the port of
``materialize_tpu/analysis/shard_prop.py``).

The reference proves, over the jaxpr of its SPMD step program, that
every slot-ring cursor stays shard-local, and counts the program's
collectives. The port's ``ShardedDataflow`` runs one process per rank,
and its counterpart of a step program is a recorded step
(``analysis/step_lint.py``):

- :func:`comm_census` reads the collectives of one record into the
  reference's ``CommCensus`` (sites, kinds, bytes per device), under
  the reference's kind names (``all_to_all`` one per exchanged field
  and one for the counts, ``psum`` for each exchange's overflow flag,
  for the step's flags and for each LetRec evaluation's pending count);
- :func:`spmd_safety` gives every cursor leaf a verdict in the
  reference's shape. A cursor is a host int of its rank's process, so
  its class is shard-local by construction; what the port can fail is
  SPMD's own hazard: every rank must issue the same collectives, in
  kind, order and shape. Ranks that part refute every verdict, which
  then names the first collective where they part;
- :func:`sharded_step_report` records one step of empty inputs on every
  rank (a collective call; the step is undone afterwards) and returns
  the reference's report. EXPLAIN ANALYSIS's ``sharding:`` block and
  ``mz_sharding`` take their census from it.

Rendering passes ``spmd_safe=True`` and runs no prover at construction
(ROADMAP Queue 3). Single-device dataflows report the trivial fact.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field


def _has_slot_cursors(df) -> bool:
    """Whether any spine in the dataflow's carry runs append-slot
    ingest (i.e. carries a slot-ring cursor)."""
    from ..arrangement.spine import Spine

    if df.output.slots:
        return True
    return any(
        isinstance(s, Spine) and s.slots
        for parts in df.states
        for s in parts
    )


def _cursor_leaves(df) -> list:
    """The carry path of every slot-ring cursor, labelled as the
    reference's ``cursor_leaves`` labels its step program's outputs."""
    from ..arrangement.spine import Spine

    out = [
        f"states[{slot}][{p}].cursor"
        for slot, parts in enumerate(df.states)
        for p, s in enumerate(parts)
        if isinstance(s, Spine) and s.slots
    ]
    if df.output.slots:
        out.append("output.cursor")
    return out


def census_of(record) -> dict:
    """The budget shape of a list of (kind, bytes per device)."""
    from collections import Counter

    record = record or []
    return {
        "collectives": len(record),
        "bytes": sum(b for _k, b in record),
        "kinds": dict(Counter(k for k, _b in record)),
    }


# -- the prover over recorded steps ------------------------------------------

REPLICATED = "replicated"
SHARD_LOCAL = "shard-local"
CROSS_WORKER = "cross-worker"


@dataclass(frozen=True)
class CollectiveSite:
    """One collective in a recorded step."""

    path: str  # the call site, "path:line"
    primitive: str  # the reference's kind name
    axes: tuple
    bytes_moved: int  # per-device operand bytes entering the collective
    result_class: str
    shapes: tuple = ()  # the operands' shapes


@dataclass
class CommCensus:
    """The communication census of one recorded step."""

    sites: list = field(default_factory=list)

    def add(self, site: CollectiveSite) -> None:
        self.sites.append(site)

    @property
    def collectives(self) -> int:
        return len(self.sites)

    @property
    def total_bytes(self) -> int:
        return sum(s.bytes_moved for s in self.sites)

    def kinds(self) -> dict:
        return dict(Counter(s.primitive for s in self.sites))

    def to_budget(self) -> dict:
        """Collective count, per-device byte volume, and the per-kind
        breakdown (``census_of``'s shape)."""
        return {
            "collectives": self.collectives,
            "bytes": self.total_bytes,
            "kinds": self.kinds(),
        }


@dataclass(frozen=True)
class ShardSafetyVerdict:
    """SPMD-safety verdict for one carry leaf (a slot-ring cursor)."""

    leaf: str  # carry path, e.g. "output.cursor"
    cls: str
    safe: bool
    blame: tuple = ()
    reason: str = ""


def comm_census(record, axis: str = "workers") -> CommCensus:
    """The collectives of one ``step_lint`` record, in dispatch order:
    an ``all_to_all`` moves data across the worker axis, a ``psum``'s
    result is the same on every rank."""
    from .step_lint import _COLLECTIVES

    census = CommCensus()
    for op in record.ops:
        kind = _COLLECTIVES.get(op.name)
        if kind is None:
            continue
        census.add(CollectiveSite(
            op.site, kind[0], (axis,), op.in_bytes,
            REPLICATED if kind[0] == "psum" else CROSS_WORKER, op.in_shapes))
    return census


def ranks_part(records_by_rank: list, axis: str = "workers") -> str | None:
    """Where the ranks' collectives first differ in kind, order or
    shape, or None where every rank issued the same ones."""
    sites = [comm_census(r, axis).sites for r in records_by_rank]
    for i in range(max(len(s) for s in sites)):
        here = [s[i] if i < len(s) else None for s in sites]
        sig = [(c.primitive, c.shapes) if c else None for c in here]
        if any(x != sig[0] for x in sig[1:]):
            return "; ".join(
                f"rank {r}: collective #{i} "
                + (f"{c.primitive}{list(c.shapes)}@{c.path}" if c else "none")
                for r, c in enumerate(here))
    return None


def spmd_safety(records_by_rank: list, sdf) -> tuple:
    """(census, verdicts): rank 0's census and one verdict per slot-ring
    cursor of ``sdf``. A cursor is shard-local by construction; ranks
    whose collectives part refute every verdict, naming where. No
    cursor (merge ingest) means no verdict, as the reference's."""
    axis = getattr(sdf, "axis_name", "workers")
    census = comm_census(records_by_rank[0], axis)
    parted = ranks_part(records_by_rank, axis)
    verdicts = [
        ShardSafetyVerdict(leaf, SHARD_LOCAL, True) if parted is None else
        ShardSafetyVerdict(
            leaf, CROSS_WORKER, False, (parted,),
            "the ranks' collectives part: an SPMD step must issue the same "
            "collectives on every rank")
        for leaf in _cursor_leaves(sdf)
    ]
    return census, verdicts


def empty_inputs(expr, device) -> dict:
    """An empty batch for every collection ``expr`` reads that no Let or
    LetRec binds: a dataflow's source inputs."""
    import numpy as np

    from ..expr import relation as mir
    from ..repr.batch import Batch
    from ..repr.schema import DIFF_DTYPE, TIME_DTYPE

    out: dict = {}

    def go(e, bound):
        if isinstance(e, mir.Get):
            if e.name not in bound:
                out.setdefault(e.name, e.schema())
            return
        if isinstance(e, mir.Let):
            go(e.value, bound)
            go(e.body, bound | {e.name})
            return
        if isinstance(e, mir.LetRec):
            inner = bound | set(e.names)
            for v in e.values:
                go(v, inner)
            go(e.body, inner)
            return
        for c in e.children():
            go(c, bound)

    go(expr, frozenset())
    return {
        name: Batch.from_numpy(
            sch, [np.zeros(0, dtype=c.dtype) for c in sch.columns],
            np.zeros(0, dtype=TIME_DTYPE), np.zeros(0, dtype=DIFF_DTYPE),
            device=device)
        for name, sch in out.items()
    }


def sharded_step_report(sdf) -> dict:
    """Record one step of empty inputs on every rank of a
    ``ShardedDataflow`` (``record_collectives``, a collective call) and
    return the report every surface reads, under the reference's keys.
    A recording that fails reports unsafe with its error, as the
    reference's trace failure does."""
    head = {"spmd": True, "workers": sdf.num_shards, "axis": sdf.axis_name}
    try:
        records = sdf.record_collectives()
        census, verdicts = spmd_safety(records, sdf)
        parted = ranks_part(records, sdf.axis_name)
    except Exception as e:  # noqa: BLE001 — a failed recording is unproven
        return {**head, "ingest_mode": "merge", "safe": False, "cursors": [],
                "census": {"collectives": 0, "bytes": 0, "kinds": {}},
                "error": f"shard-prop record failed: {e!r}"}
    return {
        **head,
        "ingest_mode": "append_slot" if _has_slot_cursors(sdf) else "merge",
        "safe": parted is None and all(v.safe for v in verdicts),
        "cursors": [
            {"leaf": v.leaf, "class": v.cls, "safe": v.safe, "blame": list(v.blame),
             "reason": v.reason}
            for v in verdicts
        ],
        "census": census.to_budget(),
        "error": None if parted is None or verdicts else
        f"the ranks' collectives part: {parted}",
    }


def single_device_report(df) -> dict:
    """The trivial sharding report of a single-device dataflow."""
    return {
        "spmd": False,
        "workers": 1,
        "axis": None,
        "ingest_mode": (
            "append_slot" if _has_slot_cursors(df) else "merge"
        ),
        "safe": True,
        "cursors": [],
        "census": {"collectives": 0, "bytes": 0, "kinds": {}},
        "error": None,
    }


def dataflow_sharding_report(df) -> dict:
    """The sharding report of any rendered dataflow: a dataflow's own
    ``sharding_report`` where it has one, the trivial report otherwise."""
    rep = getattr(df, "sharding_report", None)
    if callable(rep):
        return rep()
    return single_device_report(df)


def sharding_display(report: dict) -> tuple:
    """(census string, blame string) for one report: the one formatter
    behind EXPLAIN ANALYSIS's sharding block and the mz_sharding rows,
    so the two surfaces cannot disagree."""
    c = report.get("census") or {}
    kinds = c.get("kinds") or {}
    census = (
        f"{c.get('collectives', 0)} collective(s), "
        f"{c.get('bytes', 0)} B"
    )
    if kinds:
        census += (
            " ["
            + ", ".join(
                f"{k}={n}" for k, n in sorted(kinds.items())
            )
            + "]"
        )
    blames = [
        b
        for cur in report.get("cursors", ())
        for b in cur.get("blame", ())
    ]
    if report.get("error"):
        blames.append(report["error"])
    return census, "; ".join(blames)
