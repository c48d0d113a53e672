"""Port parity for TPC-H served through the serving stack.

The script of the card's ``serve`` phase at SF 0.003 with CHURN ORDERS 4,
through a reference cluster and a port cluster (the port's replica on
the CPU), statement by statement: Q1's full text (clause 2.4.1, less
ORDER BY) as a materialized view, ``order_lines`` with its index, the
fast-path point lookups (hits and misses), and churn ticks. Then the
port's coordinator boots from the data directory the reference wrote
(its catalog, the generator's shards, Q1's sink shard) and answers the
same reads; and the served Q1 equals a numpy oracle over the generator.
"""

from __future__ import annotations

import decimal

import numpy as np
import pytest

from tests.torch_serving import (  # noqa: F401
    boot_and_read, deadline, one_torch_thread, run_script,
)

Q1_SQL = """SELECT l_returnflag, l_linestatus,
  sum(l_quantity) AS sum_qty, sum(l_extendedprice) AS sum_base_price,
  sum(l_extendedprice * (1 - l_discount)) AS sum_disc_price,
  sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) AS sum_charge,
  avg(l_quantity) AS avg_qty, avg(l_extendedprice) AS avg_price,
  avg(l_discount) AS avg_disc, count(*) AS count_order
FROM lineitem
WHERE l_shipdate <= DATE '1998-12-01' - INTERVAL '90' DAY
GROUP BY l_returnflag, l_linestatus"""

ORDER_LINES_SQL = (
    "CREATE VIEW order_lines AS SELECT l_orderkey, count(*) AS lines, "
    "sum(l_quantity) AS qty FROM lineitem GROUP BY l_orderkey"
)

SF, CHURN, TICKS = 0.003, 4, 4
# Order keys: hits across the range, the last key, and misses.
LOOKUPS = [1, 7, 33, 4097, 4500, 0, 99999]

SCRIPT = [
    f"CREATE SOURCE tpch FROM LOAD GENERATOR TPCH (SCALE FACTOR {SF}, CHURN ORDERS {CHURN})",
    "CREATE MATERIALIZED VIEW q1 AS " + Q1_SQL,
    ORDER_LINES_SQL,
    "CREATE INDEX order_lines_idx ON order_lines (l_orderkey)",
    "SELECT * FROM q1",
    *[f"SELECT * FROM order_lines WHERE l_orderkey = {k}" for k in LOOKUPS],
    ("tick", "tpch", TICKS),
    "SELECT lines, qty FROM order_lines WHERE l_orderkey = 2",
    *[f"SELECT * FROM order_lines WHERE l_orderkey = {k}" for k in LOOKUPS],
]
READS = ["SELECT * FROM q1", "SELECT * FROM order_lines WHERE l_orderkey = 3"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    roots = {pkg: str(tmp_path_factory.mktemp(pkg)) for pkg in ("ref", "port")}
    return roots, {pkg: run_script(pkg, roots[pkg], SCRIPT, READS) for pkg in roots}


def q1_oracle(sf: float, churn: int, ticks: int) -> list:
    """TPC-H Q1 over the generator's lineitem after ``ticks`` churn
    ticks, in numpy and Python decimals (not through persist). Each
    average is its scale-2 sum over the count rounded down to scale 2,
    as the engine divides decimals."""
    from materialize_tpu_torch.repr.schema import GLOBAL_DICT
    from materialize_tpu_torch.storage.generator.tpch import LINEITEM_SCHEMA, TpchGenerator

    gen = TpchGenerator(sf=sf, seed=1)
    parts = list(gen.snapshot_lineitem_parts())
    parts += [gen.churn_lineitem_part(min(churn, gen.n_orders), t)[:2]
              for t in range(1, ticks + 1)]
    names = LINEITEM_SCHEMA.names
    cols = {n: np.concatenate([p[0][i] for p in parts]) for i, n in enumerate(names)}
    diff = np.concatenate([p[1] for p in parts])
    cutoff = (np.datetime64("1998-12-01") - np.timedelta64(90, "D")
              - np.datetime64("1970-01-01")).astype(int)
    keep = cols["l_shipdate"] <= cutoff
    acc: dict = {}
    D = decimal.Decimal
    for i in np.flatnonzero(keep):
        key = (GLOBAL_DICT.decode(cols["l_returnflag"][i]),
               GLOBAL_DICT.decode(cols["l_linestatus"][i]))
        q, p, dis, tax = (int(cols[c][i]) for c in
                          ("l_quantity", "l_extendedprice", "l_discount", "l_tax"))
        d = int(diff[i])
        a = acc.setdefault(key, [0, 0, 0, 0, 0, 0])
        a[0] += d * q
        a[1] += d * p
        a[2] += d * p * (100 - dis)
        a[3] += d * p * (100 - dis) * (100 + tax)
        a[4] += d * dis
        a[5] += d
    rows = []
    for (rf, ls), (q, p, dp, ch, dis, n) in acc.items():
        if n == 0:
            continue
        rows.append((rf, ls, D(q) / 100, D(p) / 100, D(dp) / 10**4, D(ch) / 10**6,
                     D(q // n) / 100, D(p // n) / 100, D(dis // n) / 100, n))
    return sorted(rows)


def test_tpch_script_statement_by_statement(runs):
    _roots, res = runs
    (ref, _), (port, _) = res["ref"], res["port"]
    assert len(ref) == len(port) == len(SCRIPT)
    for stmt, r, p in zip(SCRIPT, ref, port):
        assert p == r, stmt
    q1 = port[SCRIPT.index("SELECT * FROM q1")]
    assert q1[0] == "rows" and len(q1[1]) == 4
    lookups = [o for s, o in zip(SCRIPT, port) if isinstance(s, str) and "l_orderkey =" in s]
    assert sum(bool(o[1]) for o in lookups) == 11  # the misses are empty
    assert all(o[0] == "rows" for o in lookups)


def test_port_boots_from_the_reference_tpch_directory(runs):
    roots, res = runs
    recovery, got = boot_and_read(roots["ref"], READS)
    assert recovery["replay_failures"] == 0 and recovery["catalog_replayed"] == 4
    assert got == res["ref"][1] == res["port"][1]


def test_served_q1_equals_the_numpy_oracle(runs):
    _roots, res = runs
    q1 = res["port"][1][0]
    assert sorted(q1[1]) == q1_oracle(SF, CHURN, TICKS)
