"""The maintained TPC-H lineitem index: the port's counterpart of the
reference bench's ``config_index``, and the lineitem-stream layout every
lineitem workload shares (``bench.py:_tpch_lineitem_config``).

A bare ``Get lineitem`` dataflow whose output index is a hash-ordered
spine with an append-slot ring and a geometric run ladder sized for the
churn rate: hydrate the lineitem snapshot, then churn orders
(delete + re-insert, Materialize's TPC-H load-generator tick). The run
ladder, slot ring, compaction cadence (``ce``/``ratio``) and churn
capacity are computed exactly as the reference computes them, so both
packages hold the same tiers. ``workloads/tpch.py`` lays TPC-H Q1 and
Q15 over the same stream (Q15 with the supplier table beside it).
"""

from __future__ import annotations

from ..expr import relation as mir
from ..render.dataflow import Dataflow
from ..repr.batch import Batch, capacity_tier
from ..storage.generator.tpch import LINEITEM_SCHEMA, TpchGenerator

CHURN_CAP = 1 << 12


def rows_per_tick(n_orders_per_tick: int) -> int:
    """Churn rows per tick: ~4.5 lineitems per order, deleted and
    re-inserted."""
    return int(n_orders_per_tick * 4.5 * 2)


def build_lineitem_dataflow(expr: mir.RelationExpr, n_orders_per_tick: int,
                            state_cap: int, out_levels: int, ce: int, ratio: int,
                            slots: bool, device=None):
    """A dataflow over the lineitem stream with the reference's layout
    applied. Returns (df, hydrate_batch_orders, churn_capacity)."""
    rpt = rows_per_tick(n_orders_per_tick)
    churn_cap = max(capacity_tier(rpt), CHURN_CAP)
    df = Dataflow(
        expr, state_cap=state_cap,
        out_levels=out_levels, out_slots=(ce if slots else 0), device=device,
    )
    df._compact_every = ce
    df._compact_ratio = ratio
    if out_levels > 2:
        base_cap = max(state_cap, 1 << 21)
        # With slots, run i holds ce * ratio^(i+1) ticks (the slots
        # absorb the first ce).
        shift = 1 if slots else 0
        for ri in range(out_levels - 1):
            df._grow_for(
                ("out", ri),
                target=min(capacity_tier(2 * ce * ratio ** (ri + shift) * rpt), base_cap),
            )
        df._grow_for(("out", out_levels - 1), target=base_cap)
        df.out_delta_cap = churn_cap
        if slots:
            df._grow_for(("out", "tail"), target=churn_cap)
            h_orders = max(896, churn_cap // 9)
        else:
            h_orders = max(896, df.output.runs_b[0].capacity // (ce * 9))
    else:
        h_orders = 896
    return df, h_orders, churn_cap


def build_index_dataflow(n_orders_per_tick: int = 1024, state_cap: int = 1 << 21,
                         out_levels: int = 4, ce: int = 4, ratio: int = 4,
                         slots: bool = True, device=None):
    """The index dataflow with the reference's layout applied. Returns
    (df, hydrate_batch_orders, churn_capacity)."""
    return build_lineitem_dataflow(
        mir.Get("lineitem", LINEITEM_SCHEMA), n_orders_per_tick, state_cap,
        out_levels, ce, ratio, slots, device,
    )


def index_config(sf: float = 0.25, n_orders_per_tick: int = 1024,
                 state_cap: int = 1 << 21, out_levels: int = 4, ce: int = 4,
                 ratio: int = 4, slots: bool = True, seed: int = 42, device=None):
    """Returns (df, hydrate, churn): ``hydrate()`` lists the snapshot's
    step inputs; ``churn(i, t)`` gives tick i's step inputs at logical
    time t and its host row count."""
    return lineitem_config(
        *build_index_dataflow(n_orders_per_tick, state_cap, out_levels, ce, ratio,
                              slots, device),
        sf, n_orders_per_tick, seed,
    )


def lineitem_config(df, h_orders: int, churn_cap: int, sf: float,
                    n_orders_per_tick: int, seed: int = 42, extra_inputs_fn=None):
    """The TPC-H stream of a dataflow built by ``build_lineitem_dataflow``
    (its three results first): returns (df, hydrate, churn) as
    ``index_config`` does. ``extra_inputs_fn(gen)`` gives static side
    tables ({name: batch}), fed on the first hydrate tick; every later
    tick feeds each of them an empty batch (the reference bench's
    ``extra_inputs_fn``)."""
    gen = TpchGenerator(sf=sf, seed=seed)
    extras = extra_inputs_fn(gen) if extra_inputs_fn else {}
    empty = {name: Batch.empty(b.schema, 256, device=df.device)
             for name, b in extras.items()}

    def hydrate():
        out = []
        for k, b in enumerate(gen.snapshot_lineitem_batches(
            batch_orders=h_orders, time=0, device=df.device
        )):
            out.append({"lineitem": b, **(empty if k else extras)})
        return out

    def churn(i: int, t: int):
        b = gen.churn_lineitem_batch(
            n_orders_per_tick, tick=i, time=t, capacity=churn_cap, device=df.device
        )
        return {"lineitem": b, **empty}, b._host_count

    return df, hydrate, churn
