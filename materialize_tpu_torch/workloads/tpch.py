"""TPC-H Q1, Q15 and Q9 as maintained dataflows: the port's counterparts
of the reference bench's ``config_q1``, ``config_q15`` and ``config_q9``
(``bench.py:268-313``) over the lineitem stream of
``workloads/index.py``, and ``apply_tiers``, the port of the bench's
tier pre-sizing (``bench.py:apply_tiers``).

``q1_plan``, ``q15_plan`` and ``q9_plan`` are the optimized plans the
reference renders (``materialize_tpu.transform.optimizer.optimize`` of
its ``q1_mir()``, ``q15_mir()`` and ``q9_mir()``), built directly with
the port's MIR classes; the port does not carry the optimizer. Tests
convert the reference's optimizer output and assert the trees equal, so
a change there shows.
"""

from __future__ import annotations

import numpy as np

from ..arrangement.spine import Spine
from ..expr import relation as mir
from ..expr.relation import AggregateExpr, AggregateFunc
from ..expr.scalar import CallUnary, UnaryFunc, col, lit
from ..plan.decisions import quantize_cap
from ..repr.batch import Batch
from ..repr.schema import ColumnType
from ..storage.generator.tpch import (
    LINEITEM_SCHEMA,
    NATION_SCHEMA,
    ORDERS_SCHEMA,
    PART_SCHEMA,
    PARTSUPP_SCHEMA,
    SUPPLIER_SCHEMA,
)
from .index import build_lineitem_dataflow, lineitem_config, rows_per_tick

# date '1998-12-01' - 90 days, as a day number since 1970-01-01
Q1_CUTOFF = 8035 + 2526 - 90

# The reference bench's Q1 layout: the default state tier, a two-run
# output spine, folds every 8 ticks, no slot ring.
Q1_LAYOUT = dict(state_cap=256, out_levels=2, ce=8, ratio=8, slots=False)


def q1_plan() -> mir.RelationExpr:
    """TPC-H Q1, optimized: GROUP BY (l_returnflag, l_linestatus) over
    ``l_shipdate <= DATE '1998-09-02'`` with sum(l_quantity),
    sum(l_extendedprice), sum(disc_price) (scale 4), sum(charge) (scale
    6) and count(*). The averages derive from the sums and the count at
    read time. The identity-like projects are the optimizer's output,
    kept as it gives them."""
    one = lit(100, ColumnType.DECIMAL, 2)  # 1.00 at scale 2
    i = LINEITEM_SCHEMA.index_of
    # (l_quantity, l_extendedprice, l_discount, l_tax, l_returnflag,
    #  l_linestatus, l_shipdate)
    narrow = [i(n) for n in ("l_quantity", "l_extendedprice", "l_discount", "l_tax",
                             "l_returnflag", "l_linestatus", "l_shipdate")]
    return (
        mir.Get("lineitem", LINEITEM_SCHEMA)
        .project(narrow)
        .filter([col(6).lte(lit(Q1_CUTOFF, ColumnType.DATE))])
        .project(range(7))
        .project(range(6))
        .map([
            col(1) * (one - col(2)),  # disc_price -> col 6, scale 4
            col(6) * (one + col(3)),  # charge -> col 7, scale 6
        ])
        .project([4, 5, 0, 1, 6, 7])
        .reduce(
            (0, 1),
            (
                AggregateExpr(AggregateFunc.SUM_INT, col(2)),  # sum_qty
                AggregateExpr(AggregateFunc.SUM_INT, col(3)),  # sum_base_price
                AggregateExpr(AggregateFunc.SUM_INT, col(4)),  # sum_disc_price
                AggregateExpr(AggregateFunc.SUM_INT, col(5)),  # sum_charge
                AggregateExpr(AggregateFunc.COUNT, lit(True)),  # count(*)
            ),
        )
    )


def build_q1_dataflow(n_orders_per_tick: int = 1024, device=None):
    """The Q1 dataflow in the reference bench's layout. Returns (df,
    hydrate_batch_orders, churn_capacity)."""
    return build_lineitem_dataflow(q1_plan(), n_orders_per_tick, device=device,
                                   **Q1_LAYOUT)


def q1_config(sf: float = 1.0, n_orders_per_tick: int = 1024, seed: int = 42,
              device=None):
    """Returns (df, hydrate, churn) as ``index_config`` does, for Q1 over
    the lineitem stream at scale factor ``sf`` (hydrate batches of 896
    orders; churn batches of ``max(tier(rows_per_tick), 2^12)``)."""
    return lineitem_config(*build_q1_dataflow(n_orders_per_tick, device), sf,
                           n_orders_per_tick, seed)


# Q15's revenue window: [1996-01-01, 1996-04-01) as day numbers.
Q15_LO = 9496
Q15_HI = 9587

# The reference bench's Q15 layout: state tier 1024 (below 8x the ingest
# tier, so the join's spines take merge ingest), a two-run output spine,
# folds every 8 ticks, no slot ring.
Q15_LAYOUT = dict(state_cap=1024, out_levels=2, ce=8, ratio=8, slots=False)


def _not_null(i: int):
    return CallUnary(UnaryFunc.NOT, CallUnary(UnaryFunc.IS_NULL, col(i)))


def q15_plan() -> mir.RelationExpr:
    """TPC-H Q15, optimized: ``cse6`` = revenue per supplier (SUM of
    ``l_extendedprice * (1 - l_discount)``, scale 4) over ``l_shipdate``
    in [Q15_LO, Q15_HI); the body joins cse6, its global MAX (a Reduce
    on the empty key) and the supplier table as a 3-input delta join on
    ``s_suppkey = l_suppkey`` and ``total = max``. Output: (s_suppkey,
    s_name, total_revenue). The identity-like projects are the
    optimizer's output, kept as it gives them."""
    one = lit(100, ColumnType.DECIMAL, 2)  # 1.00
    i = LINEITEM_SCHEMA.index_of
    # (l_suppkey, l_extendedprice, l_discount, l_shipdate)
    narrow = [i(n) for n in ("l_suppkey", "l_extendedprice", "l_discount", "l_shipdate")]
    revenue = (
        mir.Get("lineitem", LINEITEM_SCHEMA)
        .project(narrow)
        .filter([
            col(3).gte(lit(Q15_LO, ColumnType.DATE)),
            col(3).lt(lit(Q15_HI, ColumnType.DATE)),
        ])
        .project(range(4))
        .project(range(3))
        .map([col(1) * (one - col(2))])  # -> col 3, scale 4
        .project([0, 3])
        .reduce((0,), (AggregateExpr(AggregateFunc.SUM_INT, col(1)),))
    )  # (l_suppkey, sum_0)
    cse = mir.Get("cse6", revenue.schema())
    maxrev = cse.project([1]).reduce((), (AggregateExpr(AggregateFunc.MAX, col(0)),))
    # global columns: cse6 [0, 1], max [2], supplier (s_suppkey, s_name) [3, 4]
    joined = mir.Join(
        (
            cse.filter([_not_null(1)]),
            maxrev.filter([_not_null(0)]),
            mir.Get("supplier", SUPPLIER_SCHEMA).project([0, 2]),
        ),
        equivalences=((col(3), col(0)), (col(1), col(2))),
        implementation="delta",
    )
    return mir.Let("cse6", revenue, joined.project([3, 4, 0, 1, 2]).project([0, 1, 3]))


def build_q15_dataflow(n_orders_per_tick: int = 1024, device=None):
    """The Q15 dataflow in the reference bench's layout. Returns (df,
    hydrate_batch_orders, churn_capacity)."""
    return build_lineitem_dataflow(q15_plan(), n_orders_per_tick, device=device,
                                   **Q15_LAYOUT)


def q15_config(sf: float = 1.0, n_orders_per_tick: int = 1024, seed: int = 42,
               device=None):
    """Returns (df, hydrate, churn) as ``q1_config`` does, for Q15: the
    supplier table rides the first hydrate tick, and every later tick
    feeds it an empty batch."""
    return lineitem_config(
        *build_q15_dataflow(n_orders_per_tick, device), sf, n_orders_per_tick, seed,
        extra_inputs_fn=lambda gen: {"supplier": gen.table_batch("supplier",
                                                                 device=device)},
    )


# The reference bench's Q9 layout: state tier 2^16 (8x the ingest tier,
# so the join's ten spines take append-slot ingest: a ring of 8 slots
# each), a two-run output spine, folds every 8 ticks.
Q9_LAYOUT = dict(state_cap=1 << 16, out_levels=2, ce=8, ratio=8, slots=False)

# The static tables Q9 joins beside the lineitem stream.
Q9_TABLES = ("part", "supplier", "partsupp", "nation", "orders")


def q9_plan() -> mir.RelationExpr:
    """TPC-H Q9 (product type profit), optimized: a 6-input delta join
    of lineitem (l_orderkey, l_partkey, l_suppkey, l_quantity,
    l_extendedprice, l_discount), part (p_partkey), supplier
    (s_suppkey, s_nationkey), partsupp, orders (o_orderkey,
    o_orderdate) and nation (n_nationkey, n_name), then
    ``amount = l_extendedprice * (1 - l_discount) - ps_supplycost *
    l_quantity`` (scale 4) summed by (n_name, EXTRACT(YEAR FROM
    o_orderdate)). As the reference writes it, without ``p_name LIKE
    '%green%'``."""
    one = lit(100, ColumnType.DECIMAL, 2)  # 1.00
    # global columns: lineitem [0, 6), part 6, supplier 7-8, partsupp
    # 9-11, orders 12-13, nation 14-15
    joined = mir.Join(
        (
            mir.Get("lineitem", LINEITEM_SCHEMA).project([0, 1, 2, 4, 5, 6]),
            mir.Get("part", PART_SCHEMA).project([0]),
            mir.Get("supplier", SUPPLIER_SCHEMA).project([0, 1]),
            mir.Get("partsupp", PARTSUPP_SCHEMA),
            mir.Get("orders", ORDERS_SCHEMA).project([0, 4]),
            mir.Get("nation", NATION_SCHEMA).project([0, 2]),
        ),
        equivalences=(
            (col(2), col(7), col(10)),  # l_suppkey = s_suppkey = ps_suppkey
            (col(1), col(6), col(9)),  # l_partkey = p_partkey = ps_partkey
            (col(0), col(12)),  # l_orderkey = o_orderkey
            (col(8), col(14)),  # s_nationkey = n_nationkey
        ),
        implementation="delta",
    )
    # (l_quantity, l_extendedprice, l_discount, ps_supplycost,
    #  o_orderdate, n_name)
    return (
        joined.project([3, 4, 5, 11, 13, 15])
        .map([
            col(1) * (one - col(2)) - col(3) * col(0),  # amount -> col 6
            CallUnary(UnaryFunc.EXTRACT_YEAR, col(4)),  # o_year -> col 7
        ])
        .project([5, 7, 6])
        .reduce((0, 1), (AggregateExpr(AggregateFunc.SUM_INT, col(2)),))
    )


def build_q9_dataflow(n_orders_per_tick: int = 1024, device=None):
    """The Q9 dataflow in the reference bench's layout. Returns (df,
    hydrate_batch_orders, churn_capacity)."""
    return build_lineitem_dataflow(q9_plan(), n_orders_per_tick, device=device,
                                   **Q9_LAYOUT)


def q9_tables(gen, device=None) -> dict:
    """Q9's static inputs as insert batches: part, supplier, partsupp,
    nation and every order (``bench.py:config_q9``: the orders table
    rides the first tick; only lineitem churns)."""
    okeys = np.arange(1, gen.n_orders + 1, dtype=np.int64)
    n = len(okeys)
    out = {name: gen.table_batch(name, device=device)
           for name in ("part", "supplier", "partsupp", "nation")}
    out["orders"] = Batch.from_numpy(ORDERS_SCHEMA, gen.orders_rows(okeys),
                                     np.zeros(n, np.uint64), np.ones(n, np.int64),
                                     device=device)
    return out


def q9_config(sf: float = 1.0, n_orders_per_tick: int = 1024, seed: int = 42,
              device=None, hydrate_orders: int | None = None):
    """Returns (df, hydrate, churn) as ``q1_config`` does, for Q9: the
    five static tables ride the first hydrate tick, and every later tick
    feeds them empty batches. ``hydrate_orders`` overrides the bench's
    896 orders a hydrate tick. ``apply_tiers(df, q9_tiers(...))``
    pre-sizes the tiers before hydration."""
    df, h_orders, churn_cap = build_q9_dataflow(n_orders_per_tick, device)
    return lineitem_config(
        df, hydrate_orders or h_orders, churn_cap, sf, n_orders_per_tick, seed,
        extra_inputs_fn=lambda gen: q9_tables(gen, device),
    )


def _spine_table(sp: Spine) -> str:
    """The TPC-H table a join spine arranges, by its columns' prefix."""
    prefix = sp.schema[0].name.split("_")[0]
    return {"l": "lineitem", "p": "part", "s": "supplier", "ps": "partsupp",
            "o": "orders", "n": "nation"}[prefix]


def q9_tiers(df, gen, hydrate_orders: int, n_orders_per_tick: int,
             churn_ticks: int) -> dict:
    """The tiers a Q9 run of ``gen``'s data needs, in ``apply_tiers``'s
    form, from the table sizes and the fold schedule:

    - each join spine's base and run 0 hold its whole table (lineitem:
      every snapshot row plus ``churn_ticks`` churn ticks; run 0 folds
      into the base only every ``ce * ratio`` ticks, so it may hold most
      of the snapshot);
    - its slots, where it has a ring, hold one tick: a hydrate or churn
      tick of lineitem, the whole table for the static ones (they ride
      the first tick);
    - the join tier holds one tick's lineitem rows (every probe of a
      tick's lineitem rows matches at most one row of each other input,
      and a static table's delta matches at most the tick's lineitem
      rows);
    - the output's base holds its run 0 and every group.

    A churn tick's rows are ``rows_per_tick``'s estimate: a tick beyond
    it overflows, rolls back and replays as ever."""
    n_lines = gen.lines_per_order(np.arange(1, gen.n_orders + 1))
    starts = np.arange(0, gen.n_orders, hydrate_orders)
    churn_li = rows_per_tick(n_orders_per_tick)
    tick_li = max(int(np.add.reduceat(n_lines, starts).max()), churn_li)
    rows = {"lineitem": int(n_lines.sum()) + churn_ticks * churn_li,
            "part": gen.n_part, "supplier": gen.n_supplier, "partsupp": 4 * gen.n_part,
            "nation": 25, "orders": gen.n_orders}
    grow = []
    for slot, parts in enumerate(df.states):
        for p, sp in enumerate(parts):
            if not isinstance(sp, Spine):
                continue
            table = _spine_table(sp)
            n = rows[table]
            grow += [[("state", slot, (p, ri)), n] for ri in range(sp.levels)]
            if sp.slots:
                grow.append([("state", slot, (p, "tail")),
                             tick_li if table == "lineitem" else n])
    out0 = df.output.runs_b[0].capacity
    grow.append([("out", df.output.levels - 1), out0 + 175])  # 25 nations x 7 years
    return {"grow": [[k, quantize_cap(n)] for k, n in grow],
            "join_caps": [quantize_cap(tick_li)] * len(df._ctx.join_caps),
            "out_delta_cap": df.out_delta_cap, "slot_cap": 256, "letrec_caps": []}


def _tier_capacity(df, key) -> int:
    """The capacity behind a tier key (``bench.py:_tier_capacity``)."""
    if key[0] == "state":
        part = key[2]
        s = df.states[key[1]][part[0] if isinstance(part, tuple) else part]
        if isinstance(s, Spine):
            if part[1] == "tail" and s.slots:
                return s.slots[0].capacity
            return s.runs_b[0 if part[1] == "tail" else part[1]].capacity
        return s.capacity
    if key[0] == "out":
        if key[1] == "tail":
            return (df.output.slots or df.output.runs_b)[0].capacity
        return df.output.runs_b[key[1]].capacity
    if key[0] == "errout":
        return df.err_output.capacity
    raise ValueError(f"unknown tier key {key}")


def set_join_tiers(df, rows: int) -> None:
    """Set every join site's output tier to hold ``rows`` rows. A join
    tier carries no rows from one tick to the next, so, unlike a state
    tier, it may be lowered between ticks: after a hydration in larger
    ticks, back to a churn tick's rows (``rows_per_tick``). A tick
    beyond it overflows, rolls back and replays as ever."""
    df._ctx.join_caps[:] = [quantize_cap(rows)] * len(df._ctx.join_caps)


def apply_tiers(df, tiers: dict) -> None:
    """Grow a dataflow's tiers to ``tiers`` before it runs (the port of
    ``bench.py:apply_tiers``; the same dict drives both packages): each
    ``grow`` entry ``[key, capacity]`` grows that run, slot ring or
    arrangement in one step (never shrinks it); the join, LetRec and
    output delta tiers are raised to theirs. Overflow, rollback and
    replay stay live beyond them. The exchange tier (``slot_cap``) has
    no counterpart on one device."""
    for key, want in tiers["grow"]:
        key = tuple(tuple(k) if isinstance(k, list) else k for k in key)
        if _tier_capacity(df, key) < want:
            df._grow_for(key, target=want)
    df.out_delta_cap = max(df.out_delta_cap, tiers["out_delta_cap"])
    for caps, want in ((df._ctx.join_caps, tiers["join_caps"]),
                       (df._ctx.letrec_caps, tiers.get("letrec_caps", []))):
        for i, c in enumerate(want):
            caps[i] = max(caps[i], quantize_cap(c))
