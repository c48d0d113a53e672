"""TPC-H ``lineitem`` under order churn, in numpy alone: the source
``tpch`` that a configuration names with ``"stream": "tpch"``.

The benchmark's own copy of the row arithmetic of the port's TPC-H
generator (``materialize_tpu_torch/storage/generator/tpch.py``:
``lineitems_for_orders``, ``_churn_keys`` and the version bookkeeping
of ``churn_lineitem_part``), frozen here so that a change to the
program cannot change the load. It gives the same multiset of rows for
the same seed; it has no presort, no lanes and no ``Batch``: a source
hands rows in the order it makes them.

Every field of every row is a pure function of (seed, order key,
version, line number, field tag). The snapshot is version 0 of every
order; churn tick ``t`` picks ``orders_per_tick`` orders, deletes the
rows of their current version and inserts version ``1000 + t``, as
TPC-H's refresh functions (and Materialize's ``LOAD GENERATOR TPCH``)
change orders. Dates are day numbers since 1970-01-01; the two string
columns carry the codes the caller gives for ``R``/``A``/``N`` and
``F``/``O``.
"""

from __future__ import annotations

import numpy as np

EPOCH_1992 = 8035  # days from 1970-01-01 to 1992-01-01
DATE_RANGE = 2526  # days spanned by TPC-H dates (1992-01-01..1998-12-01)
TODAY = EPOCH_1992 + DATE_RANGE - 151
FIRST_CHURN_VERSION = 1000

# The lineitem columns in schema order, with their host dtypes.
COLUMNS = (
    ("l_orderkey", np.int64), ("l_partkey", np.int64), ("l_suppkey", np.int64),
    ("l_linenumber", np.int32), ("l_quantity", np.int64),
    ("l_extendedprice", np.int64), ("l_discount", np.int64), ("l_tax", np.int64),
    ("l_returnflag", np.int64), ("l_linestatus", np.int64),
    ("l_shipdate", np.int32), ("l_commitdate", np.int32), ("l_receiptdate", np.int32),
)
COL = {name: i for i, (name, _) in enumerate(COLUMNS)}
RETURNFLAGS = ("R", "A", "N")
LINESTATUSES = ("F", "O")

# -- what the harness reads of a source ------------------------------------
# Each input the source feeds: its columns with their host dtypes, and the
# program's schema for it as ``module:attribute``.
INPUTS = {"lineitem": COLUMNS}
SCHEMAS = {"lineitem": "materialize_tpu_torch.storage.generator.tpch:LINEITEM_SCHEMA"}
# The strings the program's dictionary encodes; their codes, in this
# order, are what ``stream`` takes.
STRINGS = RETURNFLAGS + LINESTATUSES

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)


def mix64(*vals) -> np.ndarray:
    """Counter-based splitmix64-style hash of broadcast keys."""
    with np.errstate(over="ignore"):
        h = _GOLDEN
        for v in vals:
            v = np.asarray(v, dtype=np.uint64)
            z = (h ^ v) + _GOLDEN
            z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
            z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
            h = z ^ (z >> np.uint64(31))
    return h


def draw(lo: int, hi: int, *keys) -> np.ndarray:
    """Uniform ints in [lo, hi), elementwise over broadcast keys."""
    return (mix64(*keys) % np.uint64(hi - lo)).astype(np.int64) + lo


class LineitemStream:
    """The lineitem table of one seed and scale factor, and the churn
    that changes it, tick by tick. ``version[k]`` is order ``k``'s
    current version; ``churn`` and ``advance`` move it."""

    def __init__(self, sf: float, seed: int, flag_codes, status_codes):
        self.sf = sf
        self.seed = int(seed)
        self.n_orders = max(int(1_500_000 * sf), 16)
        self.n_part = max(int(200_000 * sf), 8)
        self.n_supplier = max(int(10_000 * sf), 4)
        self.flag_codes = np.asarray(flag_codes, dtype=np.int64)
        self.status_codes = np.asarray(status_codes, dtype=np.int64)
        self.version = np.zeros(self.n_orders + 1, dtype=np.int64)
        self.ticks = 0  # churn ticks applied to ``version``

    def _sd(self, versions) -> np.ndarray:
        return np.uint64(self.seed * 1_000_003) + np.asarray(versions, dtype=np.uint64)

    def lines_per_order(self, keys: np.ndarray, versions) -> np.ndarray:
        """How many lineitems (1..7) each order has at its version."""
        return draw(1, 8, self._sd(versions), np.asarray(keys, dtype=np.uint64), 11)

    def lineitems(self, keys: np.ndarray, versions) -> list:
        """The lineitem columns of orders ``keys``, each at its version
        (an array beside ``keys``, or one version for all)."""
        keys = np.asarray(keys, dtype=np.int64)
        versions = np.broadcast_to(np.asarray(versions, dtype=np.int64), keys.shape)
        n_lines = self.lines_per_order(keys, versions)
        okeys = np.repeat(keys, n_lines)
        sd = np.repeat(self._sd(versions), n_lines)
        n = len(okeys)
        linenumber = (
            np.arange(n) - np.repeat(np.cumsum(n_lines) - n_lines, n_lines)
        ).astype(np.int32) + 1
        u = okeys.astype(np.uint64)
        li = linenumber.astype(np.uint64)
        partkey = draw(1, self.n_part + 1, sd, u, li, 1)
        suppkey = draw(1, self.n_supplier + 1, sd, u, li, 2)
        quantity = draw(1, 51, sd, u, li, 3) * 100
        retail = 90_000 + (partkey * 100) % 200_000 + (partkey % 1000) * 100
        extendedprice = (quantity // 100) * retail
        discount = draw(0, 11, sd, u, li, 4)
        tax = draw(0, 9, sd, u, li, 5)
        orderdate = EPOCH_1992 + ((okeys * 2654435761) % (DATE_RANGE - 151))
        shipdate = orderdate + draw(1, 122, sd, u, li, 6)
        commitdate = orderdate + draw(30, 91, sd, u, li, 7)
        receiptdate = shipdate + draw(1, 31, sd, u, li, 8)
        returnflag = np.where(
            receiptdate <= TODAY,
            self.flag_codes[draw(0, 2, sd, u, li, 9)],
            self.flag_codes[2],
        )
        linestatus = np.where(shipdate > TODAY, self.status_codes[1], self.status_codes[0])
        return [
            okeys, partkey, suppkey, linenumber, quantity, extendedprice, discount, tax,
            returnflag.astype(np.int64), linestatus.astype(np.int64),
            shipdate.astype(np.int32), commitdate.astype(np.int32),
            receiptdate.astype(np.int32),
        ]

    # -- the snapshot --------------------------------------------------------
    def snapshot_batches(self, batch_orders: int) -> int:
        return -(-self.n_orders // batch_orders)

    def snapshot_batch(self, index: int, batch_orders: int) -> list:
        """Insert-only batch ``index`` of the snapshot: orders
        ``[1 + index * batch_orders, ...)`` at version 0."""
        start = 1 + index * batch_orders
        keys = np.arange(start, min(start + batch_orders, self.n_orders + 1), dtype=np.int64)
        return self.lineitems(keys, 0)

    # -- churn -----------------------------------------------------------------
    def churn_keys(self, orders_per_tick: int, tick: int) -> np.ndarray:
        """The sorted order keys that churn tick ``tick`` replaces (the
        port's draw over ``arange(1, n + 1)``: ``choice`` over an array
        takes the same indices as over its length)."""
        rng = np.random.default_rng(self.seed * 31 + tick)
        return np.sort(rng.choice(self.n_orders, size=orders_per_tick, replace=False) + 1)

    def advance(self, orders_per_tick: int, tick: int) -> np.ndarray:
        """Apply tick ``tick``'s version bookkeeping without making its
        rows; returns its keys. Ticks apply in order from 0."""
        if tick != self.ticks:
            raise ValueError(f"tick {tick} applied out of order (next is {self.ticks})")
        keys = self.churn_keys(orders_per_tick, tick)
        self.version[keys] = FIRST_CHURN_VERSION + tick
        self.ticks += 1
        return keys

    def churn(self, orders_per_tick: int, tick: int):
        """Tick ``tick`` as (columns, diffs): the current version of its
        orders' rows deleted, version ``1000 + tick`` inserted."""
        keys = self.churn_keys(orders_per_tick, tick)
        old = self.lineitems(keys, self.version[keys])
        self.advance(orders_per_tick, tick)
        new = self.lineitems(keys, FIRST_CHURN_VERSION + tick)
        cols = [np.concatenate([o, nw]) for o, nw in zip(old, new)]
        diffs = np.concatenate([
            np.full(len(old[0]), -1, np.int64), np.ones(len(new[0]), np.int64),
        ])
        return cols, diffs

    # -- items as the harness hands them: {input: (columns, diffs)} ------------
    def snapshot_item(self, index: int, batch_orders: int) -> dict:
        """Snapshot batch ``index``, insert-only (diffs ``None``)."""
        return {"lineitem": (self.snapshot_batch(index, batch_orders), None)}

    def tick(self, orders_per_tick: int, tick: int) -> dict:
        """Churn tick ``tick``."""
        return {"lineitem": self.churn(orders_per_tick, tick)}

    def table(self, chunk_orders: int = 1 << 13):
        """Yield the columns of the whole table at the current versions,
        in chunks of orders (every row has diff +1)."""
        for start in range(1, self.n_orders + 1, chunk_orders):
            keys = np.arange(start, min(start + chunk_orders, self.n_orders + 1), dtype=np.int64)
            yield self.lineitems(keys, self.version[keys])


def stream(sf: float, seed: int, codes) -> LineitemStream:
    """The source at scale factor ``sf`` for ``seed``; ``codes`` are the
    program's codes of ``STRINGS``."""
    codes = list(codes)
    return LineitemStream(sf, seed, codes[:len(RETURNFLAGS)], codes[len(RETURNFLAGS):])


def max_tick_rows(orders_per_tick: int) -> int:
    """The most rows a churn tick can hold: 7 lines an order, deleted and
    inserted."""
    return orders_per_tick * 7 * 2


def max_rows(orders_per_tick: int, batch_orders: int) -> int:
    """The most rows of one input an item holds: a churn tick of
    ``orders_per_tick`` or a snapshot batch of ``batch_orders``."""
    return max(max_tick_rows(orders_per_tick), 7 * batch_orders)
