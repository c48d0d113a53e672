"""TPC-H Q1, Q15, Q9 and Q21 as maintained dataflows: the port's
counterparts of the reference bench's ``config_q1``, ``config_q15`` and
``config_q9`` (``bench.py:268-313``), and Q21 in Q9's layout, over the
lineitem stream of ``workloads/index.py``, and ``apply_tiers``, the
port of the bench's tier pre-sizing (``bench.py:apply_tiers``).

``q1_plan``, ``q15_plan`` and ``q9_plan`` are the optimized plans the
reference renders (``materialize_tpu.transform.optimizer.optimize`` of
its ``q1_mir()``, ``q15_mir()`` and ``q9_mir()``), and ``q21_plan`` its
optimizer's plan of the Q21 text (``Q21_SQL``), built by hand with the
port's MIR classes. Tests convert the reference's optimizer output and
assert the trees equal, so a change there shows. TPC-H Q7 is planned
from its text (``Q7_SQL``) by the port's own SQL frontend and optimizer
(``sql/plan.py``, ``transform/optimizer.py``): ``q7_expr``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..arrangement.spine import Spine
from ..expr import relation as mir
from ..expr.relation import AggregateExpr, AggregateFunc
from ..expr.scalar import BinaryFunc, CallBinary, CallUnary, UnaryFunc, col, lit
from ..plan.decisions import quantize_cap
from ..repr.batch import Batch
from ..repr.schema import GLOBAL_DICT, ColumnType
from ..sql.catalog import Catalog, CatalogItem
from ..sql.plan import plan_statement
from ..storage.generator.tpch import (
    CUSTOMER_SCHEMA,
    LINEITEM_SCHEMA,
    NATION_SCHEMA,
    ORDERS_SCHEMA,
    PART_SCHEMA,
    PARTSUPP_SCHEMA,
    REGION_SCHEMA,
    SUPPLIER_SCHEMA,
)
from ..transform.optimizer import optimize
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


def _static_tables(gen, names, device=None) -> dict:
    """The named static tables as insert batches; ``orders`` holds every
    order (``bench.py:config_q9``: the orders table rides the first
    tick; only lineitem churns)."""
    out = {}
    for name in names:
        if name == "orders":
            okeys = np.arange(1, gen.n_orders + 1, dtype=np.int64)
            n = len(okeys)
            out[name] = Batch.from_numpy(ORDERS_SCHEMA, gen.orders_rows(okeys),
                                         np.zeros(n, np.uint64), np.ones(n, np.int64),
                                         device=device)
        else:
            out[name] = gen.table_batch(name, device=device)
    return out


def q9_tables(gen, device=None) -> dict:
    """Q9's static inputs as insert batches: part, supplier, partsupp,
    nation and every order."""
    return _static_tables(gen, Q9_TABLES, device)


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
            "o": "orders", "c": "customer", "n": "nation"}[prefix]


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


# TPC-H Q21 (clause 2.4.21) as written, with 'F' and 'SAUDI ARABIA', less
# ORDER BY and LIMIT (a maintained view of <= 1 row per supplier is
# ordered and cut at read time).
Q21_SQL = """select s_name, count(*) as numwait
from supplier, lineitem l1, orders, nation
where s_suppkey = l1.l_suppkey
  and o_orderkey = l1.l_orderkey
  and o_orderstatus = 'F'
  and l1.l_receiptdate > l1.l_commitdate
  and exists (select * from lineitem l2 where l2.l_orderkey = l1.l_orderkey
              and l2.l_suppkey <> l1.l_suppkey)
  and not exists (select * from lineitem l3 where l3.l_orderkey = l1.l_orderkey
                  and l3.l_suppkey <> l1.l_suppkey
                  and l3.l_receiptdate > l3.l_commitdate)
  and s_nationkey = n_nationkey
  and n_name = 'SAUDI ARABIA'
group by s_name"""

# The static tables Q21 joins beside the lineitem stream.
Q21_TABLES = ("supplier", "nation", "orders")


def _semijoin_keys(outer: mir.RelationExpr, inner: mir.RelationExpr) -> mir.RelationExpr:
    """The distinct (l_orderkey, l_suppkey) of ``outer`` (a 25-column
    cse3-shaped collection) that have a row of ``inner`` (lineitem-shaped)
    of the same order and another supplier: the decorrelated subquery
    of an EXISTS or NOT EXISTS."""
    keys = outer.project([3, 5]).distinct()
    joined = mir.Join((keys, inner), equivalences=((col(0), col(2)),),
                      implementation="linear")
    return (
        joined.project([0, 1, 4])
        .filter([CallBinary(BinaryFunc.NEQ, col(2), col(1))])
        .project([0, 1, 2])
        .project([0, 1])
        .distinct()
    )


def _semijoin(outer_name: str, outer_schema, inner: mir.RelationExpr) -> mir.RelationExpr:
    """The rows of ``Get outer_name`` whose (l_orderkey, l_suppkey) is in
    ``_semijoin_keys``: a linear join on both, projected back."""
    outer = mir.Get(outer_name, outer_schema)
    return mir.Join(
        (outer, _semijoin_keys(outer, inner)),
        equivalences=((col(3), col(25)), (col(5), col(26))),
        implementation="linear",
    ).project(range(25))


def q21_plan(dictionary=GLOBAL_DICT) -> mir.RelationExpr:
    """TPC-H Q21 (suppliers who kept orders waiting), optimized:

    - ``cse0``: the late lineitems (``l_receiptdate > l_commitdate``);
    - ``cse3``: a 4-input delta join of the 'F' orders, cse0, supplier
      and the nation 'SAUDI ARABIA', as (supplier, lineitem, orders,
      nation) columns;
    - ``cse13``: the EXISTS, a semijoin of cse3 with the keys of another
      supplier's lineitem of the same order;
    - the body: the NOT EXISTS as an antijoin,
      ``Threshold(Union(cse13, Negate(semijoin of cse13 with cse0)))``,
      then ``count(*)`` by ``s_name``.

    The string literals are codes of ``dictionary``, the one that codes
    the data (the port's own by default)."""
    def string(s: str):
        return lit(dictionary.encode(s), ColumnType.STRING)

    li = mir.Get("lineitem", LINEITEM_SCHEMA)
    late = li.filter([col(12).gt(col(11))])
    cse0 = mir.Get("cse0", LINEITEM_SCHEMA)
    # global columns: orders [0, 6), cse0 [6, 19), supplier [19, 22),
    # nation [22, 25)
    joined = mir.Join(
        (
            mir.Get("orders", ORDERS_SCHEMA).filter([col(2).eq(string("F"))]),
            cse0,
            mir.Get("supplier", SUPPLIER_SCHEMA),
            mir.Get("nation", NATION_SCHEMA).filter([col(2).eq(string("SAUDI ARABIA"))]),
        ),
        equivalences=(
            (col(19), col(8)),  # s_suppkey = l_suppkey
            (col(6), col(0)),  # l_orderkey = o_orderkey
            (col(20), col(22)),  # s_nationkey = n_nationkey
        ),
        implementation="delta",
    )
    cse3_value = joined.project([19, 20, 21, *range(6, 19), *range(6), 22, 23, 24])
    cse3_schema = cse3_value.schema()
    cse13_value = _semijoin("cse3", cse3_schema, li)
    cse13 = mir.Get("cse13", cse13_value.schema())
    body = (
        mir.Union((cse13, mir.Negate(_semijoin("cse13", cse13_value.schema(), cse0))))
        .threshold()
        .project([2])
        .reduce((0,), (AggregateExpr(AggregateFunc.COUNT, lit(True)),))
    )
    return mir.Let("cse0", late,
                   mir.Let("cse3", cse3_value, mir.Let("cse13", cse13_value, body)))


def build_q21_dataflow(n_orders_per_tick: int = 1024, device=None):
    """The Q21 dataflow in Q9's layout. Returns (df, hydrate_batch_orders,
    churn_capacity)."""
    return build_lineitem_dataflow(q21_plan(), n_orders_per_tick, device=device,
                                   **Q9_LAYOUT)


def q21_tables(gen, device=None) -> dict:
    """Q21's static inputs as insert batches: supplier, nation and every
    order (they ride the first tick, as Q9's do)."""
    return _static_tables(gen, Q21_TABLES, device)


def q21_config(sf: float = 1.0, n_orders_per_tick: int = 1024, seed: int = 42,
               device=None, hydrate_orders: int | None = None):
    """Returns (df, hydrate, churn) as ``q9_config`` does, for Q21 over
    Q9's stream and layout: supplier, nation and all orders ride the
    first hydrate tick, only lineitem hydrates and churns.
    ``apply_tiers(df, q21_tiers(...))`` pre-sizes the tiers from the
    hydrate inputs."""
    df, h_orders, churn_cap = build_q21_dataflow(n_orders_per_tick, device)
    return lineitem_config(
        df, hydrate_orders or h_orders, churn_cap, sf, n_orders_per_tick, seed,
        extra_inputs_fn=lambda gen: q21_tables(gen, device),
    )


def _q21_counts(h_inputs: list, dictionary) -> dict:
    """Row counts of Q21's collections over the hydrate inputs (one
    readback): every lineitem row, the late ones (cse0), the 'F' orders,
    cse3's rows (late, of an 'F' order, from a Saudi supplier), the
    suppliers, the largest tick's lineitem rows, and two per-tick
    maxima: the late rows (``late_tick``) and, for the semijoins, the
    larger of cse3's rows and its keys' lines (``semi_tick``: each key
    (l_orderkey, l_suppkey) of the tick's cse3 meets the tick's rows of
    its order; a hydrate tick holds each of its orders whole). The
    strings are codes of ``dictionary``."""
    first = h_inputs[0]
    orders, supplier, nation = first["orders"], first["supplier"], first["nation"]
    dev = orders.device
    o_key, o_status = orders.cols[0], orders.cols[2]
    o_valid = orders.valid_mask()
    is_f = torch.zeros(int(o_key.max()) + 2, dtype=torch.bool, device=dev)
    is_f[o_key] = o_valid & (o_status == dictionary.encode("F"))
    n_valid = nation.valid_mask() & (nation.cols[2] == dictionary.encode("SAUDI ARABIA"))
    saudi_nations = nation.cols[0][n_valid]
    s_key = supplier.cols[0]
    is_saudi = torch.zeros(int(s_key.max()) + 2, dtype=torch.bool, device=dev)
    is_saudi[s_key] = supplier.valid_mask() & torch.isin(supplier.cols[1], saudi_nations)
    width = is_saudi.shape[0]
    per_tick = []
    for inp in h_inputs:
        b = inp["lineitem"]
        valid = b.valid_mask()
        okey = torch.clamp(b.cols[0], 0, is_f.shape[0] - 1)
        skey = torch.clamp(b.cols[2], 0, width - 1)
        late = valid & (b.cols[12] > b.cols[11])
        cse3 = late & is_f[okey] & is_saudi[skey]
        orders_t, lines = torch.unique(okey[valid], return_counts=True)
        keys = torch.unique(okey[cse3] * width + skey[cse3])
        key_lines = lines[torch.searchsorted(orders_t, torch.div(keys, width,
                                                                 rounding_mode="floor"))]
        per_tick.append(torch.stack([late.sum(), cse3.sum(), key_lines.sum()]))
    ticks = torch.stack(per_tick)
    (late_n, cse3_n, _), (late_t, cse3_t, lines_t) = ticks.sum(0).tolist(), \
        ticks.max(0).values.tolist()
    return {"lineitem": sum(inp["lineitem"]._host_count for inp in h_inputs),
            "late": int(late_n), "orders_f": int(is_f.sum()), "cse3": int(cse3_n),
            "supplier": supplier._host_count,
            "tick_lineitem": max(inp["lineitem"]._host_count for inp in h_inputs),
            "late_tick": int(late_t), "semi_tick": int(max(cse3_t, lines_t))}


def _q21_collection(sp: Spine) -> str:
    """What a Q21 join spine arranges, by its schema: a table, cse3 or
    cse13 (25 columns), the distinct keys (2), or lineitem-shaped rows
    (13: all of lineitem or cse0, told apart by the caller)."""
    if sp.schema.arity == 25:
        return "cse3"
    if sp.schema.arity == 2:
        return "keys"
    return _spine_table(sp)


def _q21_lineitem_stage(df) -> int:
    """The state slot of the EXISTS's inner stage, (distinct keys) ⋈
    lineitem. The NOT EXISTS's inner stage, (distinct keys) ⋈ cse0, has
    the same shape; ``cse13``'s value renders before the body, so the
    EXISTS's takes the lower slot."""
    return min(slot for slot, parts in enumerate(df.states)
               if len(parts) == 2 and all(isinstance(p, Spine) for p in parts)
               and (parts[0].schema.arity, parts[1].schema.arity) == (2, 13))


def q21_tiers(df, h_inputs: list, n_orders_per_tick: int, churn_ticks: int,
              dictionary=GLOBAL_DICT) -> dict:
    """The tiers a Q21 run needs, in ``apply_tiers``'s form, from the
    collections' sizes over the hydrate inputs (``_q21_counts``) and the
    fold schedule, as ``q9_tiers`` sizes Q9's:

    - each join spine's base and run 0 hold its whole collection (a
      lineitem-fed one: its snapshot rows plus ``churn_ticks`` churn
      ticks): the 'F' orders, the suppliers, the nations, all of
      lineitem for the EXISTS's inner stage (the only stage whose right
      input is ``Get lineitem``), cse0 for every other lineitem-shaped
      spine, and cse3's rows for the 25-column spines and the distinct
      keys;
    - its slots hold one tick: a hydrate or churn tick's lineitem rows,
      the whole table for the static ones;
    - each Reduce's and the Threshold's arrangement hold cse3's rows
      (the distinct keys, the antijoin's multiset; the count by s_name
      holds fewer);
    - the join tiers hold one tick's matches of one run: the delta
      join's (site 0), a tick's late rows (each meets one order, one
      supplier, one nation); the four linear stages' (sites 1-4, the
      EXISTS's then the NOT EXISTS's inner and outer stage), a tick's
      ``semi_tick`` (a tick's cse3 rows meet one key each, its keys the
      lines of their orders). Sizing them by a tick's lineitem rows, as
      Q9's, ran the card out of memory at SF 1: a stage's output holds
      (runs + slots) x 2 tiers of 25-column rows;
    - the output's base holds its run 0 and a row per supplier.

    ``dictionary`` codes the inputs' strings, as ``q21_plan``'s."""
    c = _q21_counts(h_inputs, dictionary)
    churn_li = rows_per_tick(n_orders_per_tick)
    tick_li = max(c["tick_lineitem"], churn_li)
    grown = churn_ticks * churn_li
    rows = {"lineitem": c["lineitem"] + grown, "late": c["late"] + grown,
            "orders": c["orders_f"], "supplier": c["supplier"], "nation": 25,
            "cse3": c["cse3"] + grown, "keys": c["cse3"] + grown}
    lineitem_slot = _q21_lineitem_stage(df)
    grow = []
    for slot, parts in enumerate(df.states):
        for p, sp in enumerate(parts):
            if not isinstance(sp, Spine):
                grow.append([("state", slot, p), rows["cse3"]])
                continue
            what = _q21_collection(sp)
            if what == "lineitem" and (slot, p) != (lineitem_slot, 1):
                what = "late"
            n = rows[what]
            grow += [[("state", slot, (p, ri)), n] for ri in range(sp.levels)]
            if sp.slots:
                static = what in ("orders", "supplier", "nation")
                grow.append([("state", slot, (p, "tail")), n if static else tick_li])
    out0 = df.output.runs_b[0].capacity
    grow.append([("out", df.output.levels - 1), out0 + c["supplier"]])
    n_sites = len(df._ctx.join_caps)
    return {"grow": [[k, quantize_cap(n)] for k, n in grow],
            "join_caps": [quantize_cap(c["late_tick"])]
            + [quantize_cap(c["semi_tick"])] * (n_sites - 1),
            "out_delta_cap": df.out_delta_cap, "slot_cap": 256, "letrec_caps": []}


# TPC-H Q7 (clause 2.4.7) as written, with 'FRANCE' and 'GERMANY', less
# ORDER BY (a maintained view is ordered at read time).
Q7_SQL = """SELECT supp_nation, cust_nation, l_year, sum(volume) AS revenue
FROM (
  SELECT n1.n_name AS supp_nation, n2.n_name AS cust_nation,
         extract(year FROM l_shipdate) AS l_year,
         l_extendedprice * (1 - l_discount) AS volume
  FROM supplier, lineitem, orders, customer, nation n1, nation n2
  WHERE s_suppkey = l_suppkey AND o_orderkey = l_orderkey AND c_custkey = o_custkey
    AND s_nationkey = n1.n_nationkey AND c_nationkey = n2.n_nationkey
    AND ((n1.n_name = 'FRANCE' AND n2.n_name = 'GERMANY')
      OR (n1.n_name = 'GERMANY' AND n2.n_name = 'FRANCE'))
    AND l_shipdate BETWEEN DATE '1995-01-01' AND DATE '1996-12-31'
) AS shipping
GROUP BY supp_nation, cust_nation, l_year"""


# The static tables Q7 joins beside the lineitem stream.
Q7_TABLES = ("supplier", "nation", "customer", "orders")

# Q7's ship-date window: [1995-01-01, 1996-12-31] as day numbers.
Q7_LO = 9131
Q7_HI = 9861


def tpch_catalog() -> Catalog:
    """A planning catalog of the eight TPC-H tables the generator makes,
    each a source."""
    cat = Catalog()
    for name, schema in (("lineitem", LINEITEM_SCHEMA), ("orders", ORDERS_SCHEMA),
                         ("part", PART_SCHEMA), ("partsupp", PARTSUPP_SCHEMA),
                         ("supplier", SUPPLIER_SCHEMA), ("customer", CUSTOMER_SCHEMA),
                         ("nation", NATION_SCHEMA), ("region", REGION_SCHEMA)):
        cat.create(CatalogItem(name, "source", schema))
    return cat


def q7_expr(dictionary=GLOBAL_DICT) -> mir.RelationExpr:
    """TPC-H Q7 planned from ``Q7_SQL`` by the port's frontend and
    optimizer: a 6-input delta join of the lineitems shipped in
    [Q7_LO, Q7_HI] (the BETWEEN, one AND), supplier, orders, customer and
    nation twice, then the OR of the two nation pairs, ``EXTRACT(YEAR
    FROM l_shipdate)`` and the volume (scale 4) summed by (supp_nation,
    cust_nation, l_year). The string literals are codes of
    ``dictionary``, the one that codes the data."""
    return optimize(plan_statement(Q7_SQL, tpch_catalog(), dictionary).expr)


def build_q7_dataflow(n_orders_per_tick: int = 1024, device=None):
    """The Q7 dataflow in Q9's layout. Returns (df, hydrate_batch_orders,
    churn_capacity)."""
    return build_lineitem_dataflow(q7_expr(), n_orders_per_tick, device=device, **Q9_LAYOUT)


def q7_tables(gen, device=None) -> dict:
    """Q7's static inputs as insert batches: supplier, nation, customer
    and every order (they ride the first tick, as Q9's do)."""
    return _static_tables(gen, Q7_TABLES, device)


def q7_stagger(h_inputs: list) -> list:
    """Q7's hydrate inputs with its static tables fed in the order the
    delta join can absorb a tick at a time: nation and supplier on a
    tick of their own, then customer, then the lineitem ticks, every
    order with the first. Fed on one tick, customer's pipeline meets
    every order in one probe (the join tier of a whole orders table: at
    SF 1 its six pipelines' outputs overran the card's 80 GB), and
    nation's meets every customer. In this order each static table's
    pipeline meets an empty input (customer's meets no order, orders'
    meets the first tick's lineitems), so every hydrate tick fits a
    tick's lineitem rows (or the suppliers nation meets)."""
    first = h_inputs[0]
    empty = {n: Batch.empty(b.schema, b.capacity, device=b.device) for n, b in first.items()}
    tick0 = {**empty, "nation": first["nation"], "supplier": first["supplier"]}
    tick1 = {**empty, "customer": first["customer"]}
    rest = {**first, "nation": empty["nation"], "supplier": empty["supplier"],
            "customer": empty["customer"]}
    return [tick0, tick1, rest, *h_inputs[1:]]


def q7_config(sf: float = 1.0, n_orders_per_tick: int = 1024, seed: int = 42,
              device=None, hydrate_orders: int | None = None):
    """Returns (df, hydrate, churn) as ``q9_config`` does, for Q7 over
    Q9's stream and layout: nation and supplier ride the first hydrate
    tick, customer the second, every order the third with the first
    lineitem tick (``q7_stagger``); only lineitem hydrates and churns.
    ``apply_tiers(df, q7_tiers(...))`` pre-sizes the tiers from the
    hydrate inputs."""
    df, h_orders, churn_cap = build_q7_dataflow(n_orders_per_tick, device)
    df, hydrate, churn = lineitem_config(
        df, hydrate_orders or h_orders, churn_cap, sf, n_orders_per_tick, seed,
        extra_inputs_fn=lambda gen: q7_tables(gen, device),
    )
    return df, lambda: q7_stagger(hydrate()), churn


def _q7_counts(h_inputs: list) -> dict:
    """Row counts over Q7's hydrate inputs (one readback): the orders,
    customers and suppliers (whichever tick carries them), every
    lineitem row in the ship-date window and the most of one tick."""
    per_tick = []
    for inp in h_inputs:
        b = inp["lineitem"]
        ship = b.cols[LINEITEM_SCHEMA.index_of("l_shipdate")]
        per_tick.append((b.valid_mask() & (ship >= Q7_LO) & (ship <= Q7_HI)).sum())
    window = torch.stack(per_tick)
    total, most = window.sum().item(), window.max().item()

    def rows(name):
        return sum(inp[name]._host_count for inp in h_inputs)

    return {"orders": rows("orders"), "customer": rows("customer"),
            "supplier": rows("supplier"), "window": int(total), "window_tick": int(most)}


def q7_tiers(df, h_inputs: list, n_orders_per_tick: int, churn_ticks: int) -> dict:
    """The tiers a Q7 run needs, in ``apply_tiers``'s form, from the
    collections' sizes over the hydrate inputs (``_q7_counts``) and the
    fold schedule, as ``q21_tiers`` sizes Q21's:

    - each join spine's base and run 0 hold its whole collection: the
      lineitems in the ship-date window (the join input is the Filter:
      about two of the seven years) plus ``churn_ticks`` churn ticks of
      lineitem, or its whole static table;
    - its slots hold one tick: a hydrate or churn tick's lineitem rows in
      the window, the whole table for the static ones;
    - the join tier (one site) holds a tick's matches of one run: a
      tick's window rows (each meets one row of every other input), or
      the suppliers that nation's pipeline meets on the first tick
      (``q7_stagger``'s order; with every table on one tick it would
      need the whole orders table);
    - the output's base holds its run 0 and every group (two nation
      pairs, two years).

    A tick beyond its estimate overflows, rolls back and replays."""
    c = _q7_counts(h_inputs)
    churn_li = rows_per_tick(n_orders_per_tick)
    window_tick = max(c["window_tick"], churn_li)
    rows = {"lineitem": c["window"] + churn_ticks * churn_li, "orders": c["orders"],
            "customer": c["customer"], "supplier": c["supplier"], "nation": 25}
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
                             window_tick if table == "lineitem" else n])
    out0 = df.output.runs_b[0].capacity
    grow.append([("out", df.output.levels - 1), out0 + 4])
    return {"grow": [[k, quantize_cap(n)] for k, n in grow],
            "join_caps": [quantize_cap(max(c["supplier"], window_tick))]
            * len(df._ctx.join_caps),
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
