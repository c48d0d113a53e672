"""The sharding report of a single-device dataflow (the JAX-free part of
``materialize_tpu/analysis/shard_prop.py``, ``:648-710``).

The reference's shard-spec prover walks the jaxpr of an SPMD step
program; the port has no SPMD path (ROADMAP Queue 1 item 8), so every
installed dataflow reports the trivial single-device fact. EXPLAIN
ANALYSIS's ``sharding:`` block and ``mz_sharding`` cover every installed
dataflow with it, so a missing row never reads as an unproven one.
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
