"""Plain reference of the maintained view of the configuration
``tpch-sf1-q1-no-avg-disc``, TPC-H Q1 (the pricing summary report)
without its ``avg_disc`` column:

    SELECT l_returnflag, l_linestatus, sum(l_quantity),
           sum(l_extendedprice), sum(l_extendedprice * (1 - l_discount)),
           sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)), count(*)
    FROM lineitem WHERE l_shipdate <= DATE '1998-12-01' - INTERVAL '90' DAY
    GROUP BY l_returnflag, l_linestatus

over decimals of scale 2 carried as integers: the products are exact,
at scales 4 and 6. A group is one row; a tick retracts each changed
group's old row and inserts its new one at the tick's time. Q1's
``avg_qty`` and ``avg_price`` derive from these sums and the count at
read time; its ``avg_disc`` needs ``sum(l_discount)``, which this view
does not hold. Numpy and Python integers alone; it imports nothing of
the program."""

from __future__ import annotations

import datetime

import numpy as np

from ..gen.tpch import COL

NEEDS_STATE = True
CUTOFF = (datetime.date(1998, 12, 1) - datetime.date(1970, 1, 1)).days - 90
INT64_MAX = (1 << 63) - 1


def sums(cols, diffs) -> dict:
    """{(returnflag, linestatus): [sum_qty, sum_base_price,
    sum_disc_price, sum_charge, count]} of rows with multiplicities
    ``diffs``, exact."""
    keep = np.asarray(cols[COL["l_shipdate"]]).astype(np.int64) <= CUTOFF
    d = np.asarray(diffs, np.int64)[keep]
    qty = np.asarray(cols[COL["l_quantity"]], np.int64)[keep]
    ext = np.asarray(cols[COL["l_extendedprice"]], np.int64)[keep]
    disc = np.asarray(cols[COL["l_discount"]], np.int64)[keep]
    tax = np.asarray(cols[COL["l_tax"]], np.int64)[keep]
    flag = np.asarray(cols[COL["l_returnflag"]], np.int64)[keep]
    status = np.asarray(cols[COL["l_linestatus"]], np.int64)[keep]
    disc_price = ext * (100 - disc)  # scale 4
    charge = disc_price * (100 + tax)  # scale 6
    vals = np.stack([qty, ext, disc_price, charge, np.ones_like(qty)], 1) * d[:, None]
    out: dict = {}
    for f in np.unique(flag):
        in_f = flag == f
        for st in np.unique(status[in_f]):
            group = in_f & (status == st)
            out[(int(f), int(st))] = [int(x) for x in vals[group].sum(axis=0)]
    return out


def add(total: dict, part: dict) -> dict:
    out = {k: list(v) for k, v in total.items()}
    for k, v in part.items():
        cur = out.setdefault(k, [0] * 5)
        for i, x in enumerate(v):
            cur[i] += x
    return out


def state(stream) -> dict:
    """Q1's groups over the stream's current table, summed in blocks."""
    total: dict = {}
    for cols in stream.table():
        total = add(total, sums(cols, np.ones(len(cols[0]), np.int64)))
    for k, v in total.items():
        if any(abs(x) > INT64_MAX for x in v):
            raise OverflowError(f"Q1 group {k} leaves int64: the reference expects an error")
    return total


def _row(key, vals, *extra) -> list:
    return [key[0], key[1], *vals, *extra]


def rows(_stream, total: dict):
    """Q1's rows: one per group whose count is not 0."""
    live = [_row(k, v) for k, v in sorted(total.items()) if v[4] != 0]
    yield np.asarray(live, np.int64).reshape(len(live), 7), np.ones(len(live), np.int64)


def delta(total: dict, item: dict, as_of: int):
    """One tick's change to Q1 at time ``as_of`` (the tick's rows are
    ``item["lineitem"]``): for each group whose aggregates change, its
    old row retracted and its new one inserted. Returns ((rows with the
    time last, diffs), the next state)."""
    cols, diffs = item["lineitem"]
    after = add(total, sums(cols, diffs))
    out, signs = [], []
    for k in sorted(after):
        old, new = total.get(k, [0] * 5), after[k]
        if old == new:
            continue
        if old[4] != 0:
            out.append(_row(k, old, as_of))
            signs.append(-1)
        if new[4] != 0:
            out.append(_row(k, new, as_of))
            signs.append(1)
    mat = np.asarray(out, np.int64).reshape(len(out), 8)
    return (mat, np.asarray(signs, np.int64)), after
