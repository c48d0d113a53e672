"""The sharding report (the JAX-free part of
``materialize_tpu/analysis/shard_prop.py``, ``:603-710``).

The reference proves, over the jaxpr of its SPMD step program, that
every slot-ring cursor stays shard-local, and counts the program's
collectives. The port's ``ShardedDataflow`` runs one process per rank:
a cursor is a host int of the rank's own process, shard-local by
construction, so every cursor reports safe; and the census counts the
collectives the last step actually issued, under the reference's kind
names (``all_to_all`` one per exchanged field and one for the counts,
``psum`` for each exchange's overflow flag, for the step's flags and
for each LetRec evaluation's pending count), with bytes per device.
Single-device dataflows report the trivial fact. EXPLAIN ANALYSIS's
``sharding:`` block and ``mz_sharding`` cover every installed dataflow
with ``dataflow_sharding_report``. The jaxpr prover itself has no
counterpart (ROADMAP Queue 1 item 3).
"""

from __future__ import annotations


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


def sharded_step_report(sdf) -> dict:
    """The report of a ``ShardedDataflow``, under the reference's keys."""
    return {
        "spmd": True,
        "workers": sdf.num_shards,
        "axis": sdf.axis_name,
        "ingest_mode": "append_slot" if _has_slot_cursors(sdf) else "merge",
        "safe": True,
        "cursors": [
            {"leaf": leaf, "class": "shard-local", "safe": True, "blame": [],
             "reason": ""}
            for leaf in _cursor_leaves(sdf)
        ],
        "census": census_of(sdf._census),
        "error": None,
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
