"""Sharded workloads over a worker mesh: the reference bench's multichip
configuration (``bench.py:1653-1687``, ``mc_index``) and TPC-H Q1 over
the lineitem stream, each a ``ShardedDataflow`` that every rank of the
mesh builds and feeds the same ticks.

``sharded_rank`` is what one spawned rank runs (``parallel.multihost.
spawn_workers``): the named workloads, each driven once, with the
rank's merge-path launches counted over the driven run only (the counts
are zeroed just before it and read just after), the collectives' host
seconds, the census of a step and the peek (strings decoded).
"""

from __future__ import annotations

import time as _time

import numpy as np

from ..expr import relation as mir
from ..render.dataflow import ShardedDataflow
from ..repr.batch import Batch
from ..repr.schema import Column, ColumnType, Schema

MC_SCHEMA = Schema((Column("k", ColumnType.INT64), Column("v", ColumnType.INT64)))
# The reference's multichip layout: a bare-Get index, append-slot ring.
MC_LAYOUT = dict(state_cap=1 << 14, out_levels=3, out_slots=8)
MC_ROWS = 96


def mc_index_ticks(n_ticks: int, seed: int = 42) -> list:
    """The multichip stream as host arrays: per tick (k, v, diffs), 96
    rows, keys 0-1023, values 0-15, diffs from {+1, +1, +1, -1}."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_ticks):
        k = rng.integers(0, 1024, MC_ROWS).astype(np.int64)
        v = rng.integers(0, 16, MC_ROWS).astype(np.int64)
        d = rng.choice(np.asarray([1, 1, 1, -1]), MC_ROWS).astype(np.int64)
        out.append((k, v, d))
    return out


def mc_index_inputs(ticks: list, device, first_time: int = 0) -> list:
    """Step inputs ({"src": batch of capacity 256}) of host ticks."""
    return [
        {"src": Batch.from_numpy(MC_SCHEMA, [k, v], np.full(len(d), first_time + t, np.uint64),
                                 d, capacity=256, device=device)}
        for t, (k, v, d) in enumerate(ticks)
    ]


def mc_index_expr() -> mir.RelationExpr:
    return mir.Get("src", MC_SCHEMA)


def net_rows(rows) -> dict:
    """{value row: net diff} of (col..., time, diff) rows, zeros dropped."""
    acc: dict = {}
    for r in rows:
        acc[r[:-2]] = acc.get(r[:-2], 0) + r[-1]
    return {k: d for k, d in acc.items() if d != 0}


def decoded_rows(rows, schema) -> list:
    """Rows with their STRING columns decoded: each process codes
    strings in its own dictionary, so rows cross processes as text."""
    from ..repr.schema import GLOBAL_DICT

    d = GLOBAL_DICT.snapshot()
    text = [c.ctype is ColumnType.STRING for c in schema.columns]
    return [tuple(d.decode(v) if i < len(text) and text[i] else v for i, v in enumerate(r))
            for r in rows]


def _spans_of(seq: list, size: int) -> list:
    return [seq[i:i + size] for i in range(0, len(seq), size)]


def _drive_spans(torch, sdf, warm: list, spans: list) -> dict:
    """Warm spans (they may grow and replay), then the timed spans, each
    one deferred ``run_steps`` with one flags readback. Returns the
    timed spans' wall ms and collective host seconds and calls, and the
    merge-path launches of the whole run (zeroed just before it)."""
    from ..ops import merge_kernel

    mesh = sdf.mesh
    sync = torch.cuda.synchronize if sdf.device.type == "cuda" else (lambda: None)
    sync()
    merge_kernel.LAUNCHES = 0
    merge_kernel.LAUNCHES_BY_SHAPE.clear()
    for span in warm:
        sdf.run_steps(span, defer_check=True)
        sdf.check_flags()
    sync()
    span_ms, grown = [], len(sdf._grown)
    c_s, c_calls = mesh.seconds, mesh.calls
    for span in spans:
        t0 = _time.perf_counter()
        sdf.run_steps(span, defer_check=True)
        if sdf.check_flags():
            raise RuntimeError(f"{sdf.name}: a timed span overflowed {sdf._grown[grown:]}")
        sync()
        span_ms.append((_time.perf_counter() - t0) * 1e3)
    return {
        "span_ms": span_ms,
        "collective_s": mesh.seconds - c_s,
        "collective_calls": mesh.calls - c_calls,
        "launches": merge_kernel.LAUNCHES,
        "by_shape": sorted(merge_kernel.LAUNCHES_BY_SHAPE.items()),
    }


def run_mc_index(mesh, spans: int = 4, ticks: int = 16, warm: bool = True) -> dict:
    """``mc_index`` as the reference's multichip bench runs it: one warm
    span, then ``spans`` timed spans of ``ticks`` ticks."""
    import torch

    sdf = ShardedDataflow(mc_index_expr(), mesh, name="mc-index", **MC_LAYOUT)
    n_warm = ticks if warm else 0
    host = mc_index_ticks(n_warm + spans * ticks)
    inputs = mc_index_inputs(host, sdf.device)
    run = _drive_spans(torch, sdf, _spans_of(inputs[:n_warm], ticks),
                       _spans_of(inputs[n_warm:], ticks))
    steps = spans * ticks
    return {
        "workers": mesh.world_size, "backend": mesh.backend, "rank": mesh.rank,
        "ticks": len(host), "updates": MC_ROWS * steps,
        "updates_per_s": MC_ROWS * steps / (sum(run["span_ms"]) / 1e3),
        "collective_ms_per_step": run["collective_s"] * 1e3 / steps,
        "collectives_per_step": run["collective_calls"] / steps,
        "report": sdf.sharding_report(),
        "grown": [str(k) for k in sdf._grown],
        "peek": sdf.peek(),
        **run,
    }


def q1_sharded(mesh, sf: float, churn_ticks: int, n_orders_per_tick: int = 1024,
               seed: int = 42) -> dict:
    """TPC-H Q1 over the lineitem stream, sharded: the single-device Q1
    cell's plan, layout and stream (``workloads/tpch.py:q1_config``),
    hydrated in deferred spans of 32 ticks (tiers grow and replay), then
    ``churn_ticks`` churn ticks as one timed span, which may not grow."""
    import torch

    from ..storage.generator.tpch import TpchGenerator
    from .index import CHURN_CAP, rows_per_tick
    from .tpch import Q1_LAYOUT, q1_plan
    from ..repr.batch import capacity_tier

    lay = Q1_LAYOUT
    churn_cap = max(capacity_tier(rows_per_tick(n_orders_per_tick)), CHURN_CAP)
    # The exchange's send slot pre-sized to a rank's share of a churn
    # tick (every row of a rank may go to one owner): churn never grows.
    slot_cap = capacity_tier(-(-churn_cap // mesh.world_size))
    sdf = ShardedDataflow(q1_plan(), mesh, name="q1", state_cap=lay["state_cap"],
                          out_levels=lay["out_levels"], out_slots=0, slot_cap=slot_cap)
    sdf._compact_every, sdf._compact_ratio = lay["ce"], lay["ratio"]
    gen = TpchGenerator(sf=sf, seed=seed)
    t0 = _time.perf_counter()
    hydrate = [{"lineitem": b} for b in gen.snapshot_lineitem_batches(
        batch_orders=896, time=0, device=sdf.device)]
    churn, rows = [], 0
    for i in range(churn_ticks):
        b = gen.churn_lineitem_batch(n_orders_per_tick, tick=i, time=len(hydrate) + i,
                                     capacity=churn_cap, device=sdf.device)
        churn.append({"lineitem": b})
        rows += b._host_count
    gen_s = _time.perf_counter() - t0
    t_h = _time.perf_counter()
    run = _drive_spans(torch, sdf, _spans_of(hydrate, 32), [churn])
    steps = len(hydrate) + churn_ticks
    return {
        "workers": mesh.world_size, "backend": mesh.backend, "rank": mesh.rank,
        "sf": sf, "hydrate_ticks": len(hydrate), "churn_ticks": churn_ticks,
        "churn_updates": rows, "gen_s": gen_s,
        "run_s": _time.perf_counter() - t_h,
        "churn_updates_per_s": rows / (run["span_ms"][0] / 1e3),
        "collective_ms_per_churn_step": run["collective_s"] * 1e3 / churn_ticks,
        "report": sdf.sharding_report(),
        "grown": [str(k) for k in sdf._grown],
        "slot_cap": sdf._ctx.slot_cap,
        "steps": steps,
        "peek": decoded_rows(sdf.peek(), sdf.out_schema),
        "errors": sdf.peek_errors(),
        **run,
    }


def sharded_rank(mesh, parts: tuple) -> dict:
    """One spawned rank's run of ``parts``: ("mc_index", kwargs) and
    ("q1", kwargs) in order."""
    out = {}
    for name, kw in parts:
        if name == "mc_index":
            out[name] = run_mc_index(mesh, **kw)
        elif name == "q1":
            out[name] = q1_sharded(mesh, **kw)
        else:
            raise ValueError(f"unknown sharded workload {name!r}")
    return out
