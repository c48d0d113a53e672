"""TPC-H Q1 and Q15 as maintained dataflows: the port's counterparts of
the reference bench's ``config_q1`` and ``config_q15``
(``bench.py:268-288``) over the lineitem stream of
``workloads/index.py``.

``q1_plan`` and ``q15_plan`` are the optimized plans the reference
renders (``materialize_tpu.transform.optimizer.optimize`` of its
``q1_mir()`` and ``q15_mir()``), built directly with the port's MIR
classes; the port does not carry the optimizer. Tests convert the
reference's optimizer output and assert the trees equal, so a change
there shows.
"""

from __future__ import annotations

from ..expr import relation as mir
from ..expr.relation import AggregateExpr, AggregateFunc
from ..expr.scalar import CallUnary, UnaryFunc, col, lit
from ..repr.schema import ColumnType
from ..storage.generator.tpch import LINEITEM_SCHEMA, SUPPLIER_SCHEMA
from .index import build_lineitem_dataflow, lineitem_config

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
