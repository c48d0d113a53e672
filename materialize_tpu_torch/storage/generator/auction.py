"""The auction load generator (the port's copy of
``materialize_tpu/storage/generator/auction.py``): the five-table
auction schema (organizations, users, accounts, auctions, bids) of
Materialize's ``LOAD GENERATOR AUCTION``, deterministic and host-side.

Per tick, ``auctions_per_tick`` new auctions of ``bids_per_auction``
bids each; in churn mode (``retract_after``) the bids of the auctions
opened that many ticks earlier are retracted. Every draw comes from one
``np.random.default_rng(seed)`` in the reference's order, so both
packages give equal bids for equal seeds. String columns are codes of
each package's own dictionary: compare them decoded.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ...repr.batch import Batch
from ...repr.schema import GLOBAL_DICT, Column, ColumnType, Schema

ORGANIZATIONS_SCHEMA = Schema([
    Column("id", ColumnType.INT64),
    Column("name", ColumnType.STRING),
])

USERS_SCHEMA = Schema([
    Column("id", ColumnType.INT64),
    Column("org_id", ColumnType.INT64),
    Column("name", ColumnType.STRING),
])

ACCOUNTS_SCHEMA = Schema([
    Column("id", ColumnType.INT64),
    Column("org_id", ColumnType.INT64),
    Column("balance", ColumnType.INT64),
])

AUCTIONS_SCHEMA = Schema([
    Column("id", ColumnType.INT64),
    Column("seller", ColumnType.INT64),
    Column("item", ColumnType.STRING),
    Column("end_time", ColumnType.TIMESTAMP),
])

BIDS_SCHEMA = Schema([
    Column("id", ColumnType.INT64),
    Column("buyer", ColumnType.INT64),
    Column("auction_id", ColumnType.INT64),
    Column("amount", ColumnType.INT64),
    Column("bid_time", ColumnType.TIMESTAMP),
])

_ITEMS = (
    "Signed Memorabilia",
    "City Bar Crawl",
    "Best Pizza in Town",
    "Gift Basket",
    "Custom Art",
)

_COMPANIES = ("Cavern", "Squab", "Pelican", "Buoy", "Quid")


def _mk_batch(schema: Schema, cols, time: int, device, diffs=None) -> Batch:
    n = len(cols[0]) if cols else 0
    if diffs is None:
        diffs = np.ones(n, np.int64)
    return Batch.from_numpy(schema, cols, np.full(n, time, np.uint64),
                            np.asarray(diffs), device=device)


@dataclass
class AuctionGenerator:
    """Deterministic auction stream; batches land on ``device``
    (default ``"cuda"``)."""

    seed: int = 0
    n_users: int = 128
    auctions_per_tick: int = 8
    bids_per_auction: int = 8
    retract_after: int | None = 4  # None: insert-only
    device: object = None
    _live_bids: dict = field(default_factory=dict, init=False, repr=False)

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self._next_auction = 0
        self._next_bid = 0

    def snapshot(self, time: int = 0) -> dict:
        """The static side tables."""
        dev = self.device
        org_ids = np.arange(len(_COMPANIES), dtype=np.int64)
        orgs = _mk_batch(ORGANIZATIONS_SCHEMA,
                         [org_ids, GLOBAL_DICT.encode_many(_COMPANIES)], time, dev)
        uid = np.arange(self.n_users, dtype=np.int64)
        users = _mk_batch(
            USERS_SCHEMA,
            [uid, uid % len(_COMPANIES),
             GLOBAL_DICT.encode_many([f"user {i}" for i in uid])],
            time, dev,
        )
        accounts = _mk_batch(ACCOUNTS_SCHEMA,
                             [uid, uid % len(_COMPANIES), (uid * 97) % 10_000], time, dev)
        return {"organizations": orgs, "users": users, "accounts": accounts}

    def tick(self, tick: int, time: int) -> dict:
        """One tick of auction and bid traffic: {auctions, bids}."""
        rng = self._rng
        dev = self.device
        na = self.auctions_per_tick
        a_ids = self._next_auction + np.arange(na, dtype=np.int64)
        self._next_auction += na
        sellers = rng.integers(0, self.n_users, na).astype(np.int64)
        items = GLOBAL_DICT.encode_many(
            [_ITEMS[i] for i in rng.integers(0, len(_ITEMS), na)]
        )
        end_times = (np.int64(time) + 10 + rng.integers(0, 10, na)).astype(np.int64)
        auctions = _mk_batch(AUCTIONS_SCHEMA, [a_ids, sellers, items, end_times],
                             time, dev)

        nb = na * self.bids_per_auction
        b_ids = self._next_bid + np.arange(nb, dtype=np.int64)
        self._next_bid += nb
        buyers = rng.integers(0, self.n_users, nb).astype(np.int64)
        b_auction = np.repeat(a_ids, self.bids_per_auction)
        amounts = rng.integers(1, 100, nb).astype(np.int64)
        bid_times = np.full(nb, time, dtype=np.int64)
        bid_cols = [b_ids, buyers, b_auction, amounts, bid_times]

        diffs = [np.ones(nb, np.int64)]
        cols = [list(bid_cols)]
        if self.retract_after is not None:
            self._live_bids[tick] = bid_cols
            old_cols = self._live_bids.pop(tick - self.retract_after, None)
            if old_cols is not None:
                cols.append(old_cols)
                diffs.append(-np.ones(len(old_cols[0]), np.int64))
        bids = _mk_batch(
            BIDS_SCHEMA,
            [np.concatenate([c[i] for c in cols]) for i in range(5)],
            time, dev, np.concatenate(diffs),
        )
        return {"auctions": auctions, "bids": bids}
