"""TPC-H Q1 as a maintained dataflow: the port's counterpart of the
reference bench's ``config_q1`` (``bench.py:268-274``) over the lineitem
stream of ``workloads/index.py``.

``q1_plan`` is the optimized plan the reference renders
(``materialize_tpu.transform.optimizer.optimize(q1_mir())``), built
directly with the port's MIR classes; the port does not carry the
optimizer. A test converts the reference's optimizer output and asserts
the two trees equal, so a change there shows.
"""

from __future__ import annotations

from ..expr import relation as mir
from ..expr.relation import AggregateExpr, AggregateFunc
from ..expr.scalar import col, lit
from ..repr.schema import ColumnType
from ..storage.generator.tpch import LINEITEM_SCHEMA
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
