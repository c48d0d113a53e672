"""TPC-H load generator (the port's copy of
``materialize_tpu/storage/generator/tpch.py``: lineitem, orders, part,
supplier, partsupp, customer, nation and region).

Deterministic and host-side: every field of every row is a pure
function of (seed, version, orderkey, linenumber, field tag), as in
Materialize's ``LOAD GENERATOR TPCH`` tick mode (delete an order's
lineitems and re-insert a new version). Batches are presorted on the
host into the device hash order (``presort_hash``) and stamped
``hash_consolidated``, so ingest skips the device sort. They are built
as numpy and put on the device by ``Batch.from_numpy(..., device=)``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ...ops.lanes import hash_pair_host, host_lane_encode
from ...repr.batch import Batch
from ...repr.schema import GLOBAL_DICT, Column, ColumnType, Schema


def presort_hash(schema: Schema, cols, diffs):
    """Sort rows by the device hash order (hash pair of the row lanes)
    and merge duplicate content (diffs summed, zeros dropped). Returns
    (cols, diffs, n)."""
    lanes = []
    for col, c in zip(cols, schema.columns):
        lanes.extend(host_lane_encode(col, c, None))
    h1, h2 = hash_pair_host(lanes)
    order = np.lexsort((h2, h1))
    cols = [np.asarray(c)[order] for c in cols]
    diffs = np.asarray(diffs)[order]
    h1, h2 = h1[order], h2[order]
    n = len(diffs)
    if n:
        same = np.ones(n, dtype=bool)
        same[0] = False
        same[1:] &= (h1[1:] == h1[:-1]) & (h2[1:] == h2[:-1])
        for c in cols:
            same[1:] &= c[1:] == c[:-1]
        if same.any():
            seg = np.cumsum(~same) - 1
            sums = np.zeros(seg[-1] + 1, dtype=diffs.dtype)
            np.add.at(sums, seg, diffs)
            keep = ~same & (sums[seg] != 0)
            cols = [c[keep] for c in cols]
            diffs = sums[seg][keep]
    keep = diffs != 0
    if not keep.all():
        cols = [c[keep] for c in cols]
        diffs = diffs[keep]
    return cols, diffs, len(diffs)


_EPOCH_1992 = 8035  # days from 1970-01-01 to 1992-01-01
_DATE_RANGE = 2526  # days spanned by TPC-H dates (1992-01-01..1998-12-01)

LINEITEM_SCHEMA = Schema(
    [
        Column("l_orderkey", ColumnType.INT64),
        Column("l_partkey", ColumnType.INT64),
        Column("l_suppkey", ColumnType.INT64),
        Column("l_linenumber", ColumnType.INT32),
        Column("l_quantity", ColumnType.DECIMAL, scale=2),
        Column("l_extendedprice", ColumnType.DECIMAL, scale=2),
        Column("l_discount", ColumnType.DECIMAL, scale=2),
        Column("l_tax", ColumnType.DECIMAL, scale=2),
        Column("l_returnflag", ColumnType.STRING),
        Column("l_linestatus", ColumnType.STRING),
        Column("l_shipdate", ColumnType.DATE),
        Column("l_commitdate", ColumnType.DATE),
        Column("l_receiptdate", ColumnType.DATE),
    ]
)


ORDERS_SCHEMA = Schema(
    [
        Column("o_orderkey", ColumnType.INT64),
        Column("o_custkey", ColumnType.INT64),
        Column("o_orderstatus", ColumnType.STRING),
        Column("o_totalprice", ColumnType.DECIMAL, scale=2),
        Column("o_orderdate", ColumnType.DATE),
        Column("o_orderpriority", ColumnType.STRING),
    ]
)

SUPPLIER_SCHEMA = Schema(
    [
        Column("s_suppkey", ColumnType.INT64),
        Column("s_nationkey", ColumnType.INT64),
        Column("s_name", ColumnType.STRING),
    ]
)

PART_SCHEMA = Schema(
    [
        Column("p_partkey", ColumnType.INT64),
        Column("p_name", ColumnType.STRING),
        Column("p_retailprice", ColumnType.DECIMAL, scale=2),
    ]
)

PARTSUPP_SCHEMA = Schema(
    [
        Column("ps_partkey", ColumnType.INT64),
        Column("ps_suppkey", ColumnType.INT64),
        Column("ps_supplycost", ColumnType.DECIMAL, scale=2),
    ]
)

CUSTOMER_SCHEMA = Schema(
    [
        Column("c_custkey", ColumnType.INT64),
        Column("c_nationkey", ColumnType.INT64),
        Column("c_name", ColumnType.STRING),
    ]
)

NATION_SCHEMA = Schema(
    [
        Column("n_nationkey", ColumnType.INT64),
        Column("n_regionkey", ColumnType.INT64),
        Column("n_name", ColumnType.STRING),
    ]
)

REGION_SCHEMA = Schema(
    [
        Column("r_regionkey", ColumnType.INT64),
        Column("r_name", ColumnType.STRING),
    ]
)

_NATIONS = [
    "ALGERIA", "ARGENTINA", "BRAZIL", "CANADA", "EGYPT", "ETHIOPIA",
    "FRANCE", "GERMANY", "INDIA", "INDONESIA", "IRAN", "IRAQ", "JAPAN",
    "JORDAN", "KENYA", "MOROCCO", "MOZAMBIQUE", "PERU", "CHINA",
    "ROMANIA", "SAUDI ARABIA", "VIETNAM", "RUSSIA", "UNITED KINGDOM",
    "UNITED STATES",
]
_REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
_NATION_REGION = [0, 1, 1, 1, 4, 0, 3, 3, 2, 2, 4, 4, 2, 4, 0, 0, 0, 1,
                  2, 3, 4, 2, 3, 3, 1]


@dataclass
class TpchGenerator:
    """Deterministic TPC-H generator at a scale factor: 1.5M * sf orders
    with 1..7 (average 4) lineitems each, 200k * sf parts (4 partsupp
    rows each), 10k * sf suppliers, 25 nations; customer keys are drawn
    from 150k * sf."""

    sf: float = 0.01
    seed: int = 1

    def __post_init__(self):
        self.n_orders = max(int(1_500_000 * self.sf), 16)
        self.n_part = max(int(200_000 * self.sf), 8)
        self.n_supplier = max(int(10_000 * self.sf), 4)
        self.n_customer = max(int(150_000 * self.sf), 8)
        self._order_version: dict = {}
        self._code_epoch = None

    def _coded(self, attr: str, strings) -> np.ndarray:
        """The dictionary codes of ``strings``, coded again after a
        rebalance relabels the dictionary (the reference codes them once,
        so a rebalance in its process leaves it writing stale codes)."""
        if self._code_epoch != GLOBAL_DICT.epoch:
            self._code_epoch = GLOBAL_DICT.epoch
            self._codes = {}
        if attr not in self._codes:
            self._codes[attr] = GLOBAL_DICT.encode_many(strings)
        return self._codes[attr]

    @property
    def _flag_codes(self) -> np.ndarray:
        return self._coded("flag", ["R", "A", "N"])

    @property
    def _status_codes(self) -> np.ndarray:
        return self._coded("status", ["F", "O"])

    @property
    def _prio_codes(self) -> np.ndarray:
        return self._coded(
            "prio", ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"])

    def _mix64(self, *vals):
        """Counter-based splitmix64-style hash of broadcast keys."""
        with np.errstate(over="ignore"):
            h = np.uint64(0x9E3779B97F4A7C15)
            for v in vals:
                v = np.asarray(v, dtype=np.uint64)
                z = (h ^ v) + np.uint64(0x9E3779B97F4A7C15)
                z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
                z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
                h = z ^ (z >> np.uint64(31))
        return h

    def _draw(self, lo: int, hi: int, *keys) -> np.ndarray:
        """Uniform ints in [lo, hi), elementwise over broadcast keys."""
        return (self._mix64(*keys) % np.uint64(hi - lo)).astype(np.int64) + lo

    def lines_per_order(self, orderkeys: np.ndarray, version: int = 0) -> np.ndarray:
        """How many lineitems (1..7) each order has at ``version``."""
        sd = np.uint64(self.seed * 1_000_003 + version)
        return self._draw(1, 8, sd, np.asarray(orderkeys, dtype=np.uint64), 11)

    def lineitems_for_orders(self, orderkeys: np.ndarray, version: int = 0) -> list:
        """Lineitem columns for the given order keys at ``version`` (0 =
        snapshot; churn tick t writes version 1000 + t)."""
        sd = np.uint64(self.seed * 1_000_003 + version)
        n_lines = self.lines_per_order(orderkeys, version)
        okeys = np.repeat(orderkeys, n_lines)
        n = len(okeys)
        linenumber = (
            np.arange(n) - np.repeat(np.cumsum(n_lines) - n_lines, n_lines)
        ).astype(np.int32) + 1
        u = okeys.astype(np.uint64)
        li = linenumber.astype(np.uint64)
        partkey = self._draw(1, self.n_part + 1, sd, u, li, 1)
        suppkey = self._draw(1, self.n_supplier + 1, sd, u, li, 2)
        quantity = self._draw(1, 51, sd, u, li, 3) * 100
        retail = 90_000 + (partkey * 100) % 200_000 + (partkey % 1000) * 100
        extendedprice = (quantity // 100) * retail
        discount = self._draw(0, 11, sd, u, li, 4)
        tax = self._draw(0, 9, sd, u, li, 5)
        orderdate = _EPOCH_1992 + (
            (okeys * 2654435761) % (_DATE_RANGE - 151)
        ).astype(np.int64)
        shipdate = orderdate + self._draw(1, 122, sd, u, li, 6)
        commitdate = orderdate + self._draw(30, 91, sd, u, li, 7)
        receiptdate = shipdate + self._draw(1, 31, sd, u, li, 8)
        today = _EPOCH_1992 + _DATE_RANGE - 151
        returnflag = np.where(
            receiptdate <= today,
            self._flag_codes[self._draw(0, 2, sd, u, li, 9)],
            self._flag_codes[2],
        ).astype(np.int64)
        linestatus = np.where(
            shipdate > today, self._status_codes[1], self._status_codes[0]
        ).astype(np.int64)
        return [
            okeys,
            partkey,
            suppkey,
            linenumber,
            quantity.astype(np.int64),
            extendedprice.astype(np.int64),
            discount.astype(np.int64),
            tax.astype(np.int64),
            returnflag,
            linestatus,
            shipdate.astype(np.int32),
            commitdate.astype(np.int32),
            receiptdate.astype(np.int32),
        ]

    def orders_rows(self, orderkeys: np.ndarray) -> list:
        """Orders columns for the given order keys (field tags 21-24 of
        the snapshot stream; the order date is the one its lineitems
        derive their dates from)."""
        sd = np.uint64(self.seed * 1_000_003)
        u = np.asarray(orderkeys, dtype=np.uint64)
        custkey = self._draw(1, self.n_customer + 1, sd, u, 21)
        status = self._status_codes[self._draw(0, 2, sd, u, 22)].astype(np.int64)
        totalprice = self._draw(1_000_00, 500_000_00, sd, u, 23)
        orderdate = _EPOCH_1992 + (
            (orderkeys * 2654435761) % (_DATE_RANGE - 151)
        ).astype(np.int64)
        prio = self._prio_codes[self._draw(0, 5, sd, u, 24)].astype(np.int64)
        return [
            orderkeys,
            custkey,
            status,
            totalprice.astype(np.int64),
            orderdate.astype(np.int32),
            prio,
        ]

    # -- static dimension tables -------------------------------------------
    def supplier_table(self) -> list:
        """Supplier columns: keys 1..n_supplier, a nation drawn from the
        ``seed + 7`` stream, names ``Supplier#%09d`` as order-preserving
        dictionary codes."""
        rng = np.random.default_rng(self.seed + 7)
        keys = np.arange(1, self.n_supplier + 1)
        nation = rng.integers(0, 25, size=len(keys))
        names = GLOBAL_DICT.encode_many([f"Supplier#{k:09d}" for k in keys])
        return [keys, nation.astype(np.int64), names]

    def part_table(self) -> list:
        """Part columns: keys 1..n_part, names ``part {k % 92}``, the
        retail price lineitem's extended price derives from."""
        keys = np.arange(1, self.n_part + 1)
        names = GLOBAL_DICT.encode_many([f"part {k % 92}" for k in keys])
        retail = (90_000 + (keys * 100) % 200_000 + (keys % 1000) * 100).astype(np.int64)
        return [keys, names, retail]

    def partsupp_table(self) -> list:
        """Partsupp columns: four suppliers per part, spread a quarter of
        the supplier range apart, costs from the ``seed + 11`` stream."""
        rng = np.random.default_rng(self.seed + 11)
        pkeys = np.repeat(np.arange(1, self.n_part + 1), 4)
        skeys = (
            (pkeys + np.tile(np.arange(4), self.n_part) * (self.n_supplier // 4 + 1))
            % self.n_supplier
        ) + 1
        cost = rng.integers(100, 1000_00, size=len(pkeys)).astype(np.int64)
        return [pkeys, skeys, cost]

    def customer_table(self) -> list:
        """Customer columns: keys 1..n_customer, a nation drawn from the
        ``seed + 13`` stream, names ``Customer#%09d``."""
        rng = np.random.default_rng(self.seed + 13)
        keys = np.arange(1, self.n_customer + 1)
        nation = rng.integers(0, 25, size=len(keys))
        names = GLOBAL_DICT.encode_many([f"Customer#{k:09d}" for k in keys])
        return [keys, nation.astype(np.int64), names]

    def nation_table(self) -> list:
        """The 25 TPC-H nations with their regions."""
        return [
            np.arange(25, dtype=np.int64),
            np.asarray(_NATION_REGION, dtype=np.int64),
            GLOBAL_DICT.encode_many(_NATIONS),
        ]

    def region_table(self) -> list:
        """The 5 TPC-H regions."""
        return [np.arange(5, dtype=np.int64), GLOBAL_DICT.encode_many(_REGIONS)]

    def table_batch(self, name: str, time: int = 0, device=None) -> Batch:
        """A static table as one insert batch (the dimension snapshot)."""
        schema, make = {
            "supplier": (SUPPLIER_SCHEMA, self.supplier_table),
            "part": (PART_SCHEMA, self.part_table),
            "partsupp": (PARTSUPP_SCHEMA, self.partsupp_table),
            "customer": (CUSTOMER_SCHEMA, self.customer_table),
            "nation": (NATION_SCHEMA, self.nation_table),
            "region": (REGION_SCHEMA, self.region_table),
        }[name]
        cols = make()
        n = len(cols[0])
        return Batch.from_numpy(schema, cols, np.full(n, time, np.uint64),
                                np.ones(n, np.int64), device=device)

    def snapshot_lineitem_parts(self, batch_orders: int = 4096):
        """Yield (cols, diffs) numpy parts covering the snapshot, each
        presorted in the device hash order."""
        for start in range(1, self.n_orders + 1, batch_orders):
            keys = np.arange(start, min(start + batch_orders, self.n_orders + 1))
            cols = self.lineitems_for_orders(keys)
            cols, diffs, _ = presort_hash(
                LINEITEM_SCHEMA, cols, np.ones(len(cols[0]), np.int64)
            )
            yield cols, diffs

    def snapshot_lineitem_batches(self, batch_orders: int = 4096, time: int = 0,
                                  capacity: int | None = None, device=None):
        """Yield device Batches of lineitem inserts covering the snapshot."""
        for cols, diffs in self.snapshot_lineitem_parts(batch_orders):
            yield Batch.from_numpy(
                LINEITEM_SCHEMA, cols, np.full(len(diffs), time, np.uint64),
                diffs, capacity=capacity, hints=("hash_consolidated",),
                device=device,
            )

    def _churn_keys(self, n_orders: int, tick: int) -> np.ndarray:
        """The sorted order keys that churn tick ``tick`` replaces."""
        rng = np.random.default_rng(self.seed * 31 + tick)
        return np.sort(
            rng.choice(np.arange(1, self.n_orders + 1), size=n_orders, replace=False)
        )

    def replay_churn_versions(self, n_orders: int, upto: int) -> None:
        """Set each order's current version as churn ticks ``1..upto-1``
        left it, without generating their rows: a source restarted at
        frontier ``upto`` then retracts exactly the rows it inserted
        before."""
        for tick in range(1, upto):
            for k in self._churn_keys(n_orders, tick).tolist():
                self._order_version[k] = 1000 + tick

    def churn_lineitem_part(self, n_orders: int, tick: int):
        """One tick of order churn as numpy (cols, diffs): delete the
        current version of ``n_orders`` orders' lineitems (exactly the
        rows inserted for them before) and insert version 1000 + tick."""
        keys = self._churn_keys(n_orders, tick)
        new_version = 1000 + tick
        by_version: dict = {}
        for k in keys:
            v = self._order_version.get(int(k), 0)
            by_version.setdefault(v, []).append(int(k))
        old_parts = [
            self.lineitems_for_orders(np.asarray(sorted(ks), dtype=keys.dtype), version=v)
            for v, ks in sorted(by_version.items())
        ]
        old = [np.concatenate(cols) for cols in zip(*old_parts)]
        new = self.lineitems_for_orders(keys, version=new_version)
        for k in keys:
            self._order_version[int(k)] = new_version
        cols = [np.concatenate([o, nw]) for o, nw in zip(old, new)]
        diffs = np.concatenate(
            [np.full(len(old[0]), -1, np.int64), np.ones(len(new[0]), np.int64)]
        )
        cols, diffs, _ = presort_hash(LINEITEM_SCHEMA, cols, diffs)
        return cols, diffs

    def churn_lineitem_batch(self, n_orders: int, tick: int, time: int,
                             capacity: int | None = None, device=None) -> Batch:
        """One churn tick as a device Batch at logical ``time``."""
        cols, diffs = self.churn_lineitem_part(n_orders, tick)
        return Batch.from_numpy(
            LINEITEM_SCHEMA, cols, np.full(len(diffs), time, np.uint64), diffs,
            capacity=capacity, hints=("hash_consolidated",), device=device,
        )
