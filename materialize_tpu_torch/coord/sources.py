"""Storage runtime: load-generator sources feeding shards.

Analog of the reference's source pipeline (``storage/src/source/
source_reader_pipeline.rs:165`` + the load generators in ``storage/src/
source/generator/{tpch,auction,counter}.rs``): a source is a set of
*subsources* (one per relation, e.g. TPCH's lineitem/orders/...), each
bound to its own shard; a runner thread appends one update chunk per
tick, advancing every subsource's upper in lockstep so downstream
frontiers progress even when a tick touches only some relations.

Restart/resume is deterministic reclocking: the tick counter IS the
virtual timestamp, so a restarted runner continues at ``tick = upper``
and regenerates byte-identical churn (generators are seeded per tick) —
the remap-collection idea of ``source/reclock.rs`` collapsed onto the
identity binding.
"""

from __future__ import annotations

import threading
import time as _time

import numpy as np

from ..repr.batch import Batch
from ..repr.schema import Column, ColumnType, Schema
from ..storage.generator.auction import (
    ACCOUNTS_SCHEMA,
    AUCTIONS_SCHEMA,
    BIDS_SCHEMA,
    ORGANIZATIONS_SCHEMA,
    USERS_SCHEMA,
    AuctionGenerator,
)
from ..storage.generator.tpch import (
    CUSTOMER_SCHEMA,
    LINEITEM_SCHEMA,
    NATION_SCHEMA,
    ORDERS_SCHEMA,
    PART_SCHEMA,
    PARTSUPP_SCHEMA,
    REGION_SCHEMA,
    SUPPLIER_SCHEMA,
    TpchGenerator,
)
from ..storage.persist import PersistClient, WriteHandle

COUNTER_SCHEMA = Schema([Column("counter", ColumnType.INT64)])

# Sources run beside the coordinator and write persist shards: their
# batches are host staging that ``GeneratorSource._append_batch`` reads
# straight back into parts. The card sees the rows only when a replica
# decodes the shard.
_HOST = "cpu"


class GeneratorAdapter:
    """Uniform generator interface: subsource schemas, a snapshot (t=0),
    and per-tick update batches."""

    subsources: dict

    def snapshot(self) -> dict:
        return {}

    def tick(self, tick: int, time: int) -> dict:
        return {}


class TpchAdapter(GeneratorAdapter):
    def __init__(self, options: dict):
        sf = float(options.get("scale_factor", 0.01))
        seed = int(options.get("seed", 1))
        self.churn_orders = int(options.get("churn_orders", 16))
        self.gen = TpchGenerator(sf=sf, seed=seed)
        self.subsources = {
            "lineitem": LINEITEM_SCHEMA,
            "orders": ORDERS_SCHEMA,
            "supplier": SUPPLIER_SCHEMA,
            "part": PART_SCHEMA,
            "partsupp": PARTSUPP_SCHEMA,
            "customer": CUSTOMER_SCHEMA,
            "nation": NATION_SCHEMA,
            "region": REGION_SCHEMA,
        }

    def snapshot(self) -> dict:
        out = {
            name: self.gen.table_batch(name, time=0, device=_HOST)
            for name in (
                "supplier", "part", "partsupp", "customer", "nation",
                "region",
            )
        }
        li = list(self.gen.snapshot_lineitem_batches(time=0, device=_HOST))
        out["lineitem"] = li
        keys = np.arange(1, self.gen.n_orders + 1)
        ocols = self.gen.orders_rows(keys)
        out["orders"] = Batch.from_numpy(
            ORDERS_SCHEMA,
            ocols,
            np.zeros(len(ocols[0]), np.uint64),
            np.ones(len(ocols[0]), np.int64),
            device=_HOST,
        )
        return out

    def tick(self, tick: int, time: int) -> dict:
        return {
            "lineitem": self.gen.churn_lineitem_batch(
                min(self.churn_orders, self.gen.n_orders), tick, time,
                device=_HOST,
            )
        }


class AuctionAdapter(GeneratorAdapter):
    def __init__(self, options: dict):
        self.gen = AuctionGenerator(
            n_users=int(options.get("users", 128)),
            auctions_per_tick=int(options.get("auctions_per_tick", 4)),
            bids_per_auction=int(options.get("bids_per_auction", 4)),
            seed=int(options.get("seed", 1)),
            retract_after=options.get("retract_after"),
            device=_HOST,
        )
        self.subsources = {
            "organizations": ORGANIZATIONS_SCHEMA,
            "users": USERS_SCHEMA,
            "accounts": ACCOUNTS_SCHEMA,
            "auctions": AUCTIONS_SCHEMA,
            "bids": BIDS_SCHEMA,
        }

    def snapshot(self) -> dict:
        return self.gen.snapshot(time=0)

    def tick(self, tick: int, time: int) -> dict:
        return self.gen.tick(tick, time)

    def recover(self, upto: int) -> None:
        """Replay ticks to rebuild id counters and the live-bid window
        after a restart (deterministic generator)."""
        for i in range(1, upto):
            self.gen.tick(i, i)


class CounterAdapter(GeneratorAdapter):
    """The reference's COUNTER generator: appends one incrementing value
    per tick; with max_cardinality the oldest is retracted."""

    def __init__(self, options: dict):
        self.max_cardinality = options.get("max_cardinality")
        self.subsources = {"counter": COUNTER_SCHEMA}

    def snapshot(self) -> dict:
        return {
            "counter": Batch.from_numpy(
                COUNTER_SCHEMA,
                [np.array([0], np.int64)],
                np.zeros(1, np.uint64),
                np.ones(1, np.int64),
                device=_HOST,
            )
        }

    def tick(self, tick: int, time: int) -> dict:
        vals = [tick]
        diffs = [1]
        if (
            self.max_cardinality is not None
            and tick >= int(self.max_cardinality)
        ):
            vals.append(tick - int(self.max_cardinality))
            diffs.append(-1)
        return {
            "counter": Batch.from_numpy(
                COUNTER_SCHEMA,
                [np.array(vals, np.int64)],
                np.full(len(vals), time, np.uint64),
                np.array(diffs, np.int64),
                device=_HOST,
            )
        }


class UpsertState:
    """ENVELOPE UPSERT: key -> latest value, converting a raw
    (key, value) stream into retract/insert update pairs; a NULL value
    is a tombstone (delete). The reference backs this state with RocksDB
    on the storage host (storage/src/upsert.rs:26,506-530) — the analog
    here is host-resident state beside the ingestion pipeline (the
    DEVICE never sees raw upserts, only differential updates, exactly
    like compute behind the reference's storage layer)."""

    def __init__(self):
        self.state: dict = {}

    def apply(self, pairs: list) -> list:
        """pairs: [(key_tuple, value_tuple | None)] in stream order ->
        [(row_tuple, diff)] updates."""
        out = []
        for key, value in pairs:
            old = self.state.get(key)
            if old is not None:
                out.append((key + old, -1))
            if value is None:
                self.state.pop(key, None)
            else:
                self.state[key] = value
                out.append((key + value, +1))
        return out


class KeyValueAdapter(GeneratorAdapter):
    """The reference's KEY VALUE load generator (source/generator/
    key_value.rs): a keyed stream with repeated updates per key —
    exercised with ENVELOPE UPSERT. Subsource rows: (key, partition,
    value)."""

    SCHEMA = Schema(
        [
            Column("key", ColumnType.INT64),
            Column("partition", ColumnType.INT64),
            Column("value", ColumnType.INT64),
        ]
    )

    def __init__(self, options: dict):
        self.n_keys = int(options.get("keys", 16))
        self.partitions = int(options.get("partitions", 2))
        self.updates_per_tick = int(options.get("updates_per_tick", 8))
        self.seed = int(options.get("seed", 1))
        envelope = str(options.get("envelope", "upsert")).lower()
        if envelope not in ("upsert", "none"):
            raise ValueError(f"unsupported envelope {envelope!r}")
        self.envelope = envelope
        self.upsert = UpsertState() if envelope == "upsert" else None
        self.subsources = {"key_value": self.SCHEMA}

    def _emit(self, raw_pairs: list, time: int) -> dict:
        if self.upsert is not None:
            updates = self.upsert.apply(raw_pairs)
        else:
            updates = [
                (k + v, 1) for k, v in raw_pairs if v is not None
            ]
        if not updates:
            return {}
        rows = np.array([u[0] for u in updates], np.int64)
        diffs = np.array([u[1] for u in updates], np.int64)
        return {
            "key_value": Batch.from_numpy(
                self.SCHEMA,
                [rows[:, 0], rows[:, 1], rows[:, 2]],
                np.full(len(diffs), time, np.uint64),
                diffs,
                device=_HOST,
            )
        }

    def _pairs(self, tick: int) -> list:
        rng = np.random.default_rng(self.seed * 7919 + tick)
        keys = rng.integers(0, self.n_keys, self.updates_per_tick)
        vals = rng.integers(0, 1 << 31, self.updates_per_tick)
        # Occasionally delete a key (tombstone).
        dels = rng.random(self.updates_per_tick) < 0.1
        out = []
        for k, v, d in zip(keys, vals, dels):
            key = (int(k), int(k) % self.partitions)
            out.append((key, None if d else (int(v),)))
        return out

    def snapshot(self) -> dict:
        return self._emit(self._pairs(0), 0)

    def tick(self, tick: int, time: int) -> dict:
        return self._emit(self._pairs(tick), time)

    def recover(self, upto: int) -> None:
        """Rebuild the upsert state after a restart by replaying the
        deterministic (seeded per tick) raw stream up to the durable
        frontier — the RocksDB-state rehydration analog."""
        for i in range(upto):
            if self.upsert is not None:
                self.upsert.apply(self._pairs(i))


class DatumsAdapter(GeneratorAdapter):
    """The reference's DATUMS generator (source/generator/datums.rs):
    one row exercising every device-representable type."""

    SCHEMA = Schema(
        [
            Column("b", ColumnType.BOOL),
            Column("i32", ColumnType.INT32),
            Column("i64", ColumnType.INT64),
            Column("f", ColumnType.FLOAT64),
            Column("d", ColumnType.DATE),
            Column("ts", ColumnType.TIMESTAMP),
            Column("dec", ColumnType.DECIMAL, scale=2),
            Column("s", ColumnType.STRING),
            Column("n", ColumnType.INT64, nullable=True),
        ]
    )

    def __init__(self, options: dict):
        self.subsources = {"datums": self.SCHEMA}

    def snapshot(self) -> dict:
        from ..repr.schema import GLOBAL_DICT

        cols = [
            np.array([True, False]),
            np.array([-1, 2], np.int32),
            np.array([-(2**40), 2**40], np.int64),
            np.array([-1.5, 2.25]),
            np.array([0, 19000], np.int32),
            np.array([0, 1_600_000_000_000], np.int64),
            np.array([-123, 4567], np.int64),  # -1.23, 45.67
            GLOBAL_DICT.encode_many(["", "hello"]),
            np.array([0, 7], np.int64),
        ]
        return {
            "datums": Batch.from_numpy(
                self.SCHEMA,
                cols,
                np.zeros(2, np.uint64),
                np.ones(2, np.int64),
                nulls=[None] * 8 + [np.array([True, False])],
                device=_HOST,
            )
        }


def KafkaAdapter(options: dict):
    """Broker-backed sources (the reference's storage/kafka/) are not
    ported."""
    raise NotImplementedError(
        "KAFKA sources are not ported (ROADMAP Queue 1 item 16)"
    )


GENERATORS = {
    "tpch": TpchAdapter,
    "auction": AuctionAdapter,
    "counter": CounterAdapter,
    "key_value": KeyValueAdapter,
    "datums": DatumsAdapter,
    "kafka": KafkaAdapter,
}


class GeneratorSource:
    """A running source: one writer per subsource shard, ticking on a
    thread (or manually via tick_once for deterministic tests)."""

    def __init__(
        self,
        client: PersistClient,
        name: str,
        generator: str,
        options: dict,
        shard_prefix: str,
        tick_interval: float | None = 0.05,
    ):
        if generator not in GENERATORS:
            raise ValueError(
                f"unknown load generator {generator!r} "
                f"(have: {sorted(GENERATORS)})"
            )
        self.name = name
        # SQL option keys are space-separated words (SCALE FACTOR 0.1).
        options = {
            str(k).lower().replace(" ", "_"): v for k, v in options.items()
        }
        self.adapter = GENERATORS[generator](options)
        self.shards = {
            sub: f"{shard_prefix}_{sub}" for sub in self.adapter.subsources
        }
        self.writers: dict[str, WriteHandle] = {
            sub: client.open_writer(self.shards[sub], schema)
            for sub, schema in self.adapter.subsources.items()
        }
        self.tick_interval = tick_interval
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # Ingest-loop health (the freshness plane's mz_source_statuses
        # source): running / stalled (a tick raised; the loop retries
        # next interval) / stopped, with the transition wallclock and
        # the last error text.
        self.status = "running"
        self.status_at = _time.time()
        self.last_error = ""
        # Resume: the virtual time is the min subsource upper (all move
        # in lockstep; min is safe after a partial crash).
        self.t = min(w.upper for w in self.writers.values())
        if self.t == 0:
            self._append_all(self.adapter.snapshot(), 0)
            self.t = 1
        elif hasattr(self.adapter, "recover_from_shards"):
            # External sources (kafka) resume from their own durable
            # output: the __remap subsource binds consumed offsets, and
            # envelope state rehydrates from the emitted collection
            # (the persist-rehydration model, not a state sidecar).
            snapshots = {}
            for sub, shard in self.shards.items():
                reader = client.open_reader(shard, f"src-recover-{sub}")
                try:
                    _sch, cols, nulls, _t, diff = reader.snapshot(
                        self.t - 1
                    )
                finally:
                    reader.expire()
                from ..repr.schema import decode_result_rows

                rows = decode_result_rows(
                    self.adapter.subsources[sub], cols, nulls, _t, diff
                )
                snapshots[sub] = [
                    (r[:-2], r[-1]) for r in rows
                ]
            self.adapter.recover_from_shards(snapshots, self.t)
        elif hasattr(self.adapter, "recover"):
            # Stateful generators rebuild internal state by replaying
            # their deterministic stream to the durable frontier.
            self.adapter.recover(self.t)

    # -- ticking ------------------------------------------------------------
    def _append_batch(self, w: WriteHandle, b, lower: int, upper: int):
        batches = b if isinstance(b, list) else [b]
        cols_parts = [x.to_columns() for x in batches]
        n_cols = len(batches[0].schema.columns)
        cols = [
            np.concatenate([p[i] for p in cols_parts])
            for i in range(n_cols)
        ]
        diff = np.concatenate([p[-1] for p in cols_parts])
        nulls = []
        for i in range(n_cols):
            masks = [
                np.asarray(x.nulls[i])[: len(p[0])]
                if x.nulls[i] is not None
                else None
                for x, p in zip(batches, cols_parts)
            ]
            if all(m is None for m in masks):
                nulls.append(None)
            else:
                nulls.append(
                    np.concatenate(
                        [
                            m
                            if m is not None
                            else np.zeros(len(p[0]), np.bool_)
                            for m, p in zip(masks, cols_parts)
                        ]
                    )
                )
        time = np.full(len(diff), lower, np.uint64)
        w.compare_and_append(cols, nulls, time, diff, lower, upper)

    def _append_all(self, batches: dict, t: int) -> None:
        for sub, w in self.writers.items():
            if w.upper > t:
                continue  # already durable (resume after partial crash)
            b = batches.get(sub)
            if b is None:
                w.compare_and_append(
                    [
                        np.zeros(0, c.dtype)
                        for c in self.adapter.subsources[sub].columns
                    ],
                    [None] * len(self.adapter.subsources[sub].columns),
                    np.zeros(0, np.uint64),
                    np.zeros(0, np.int64),
                    t,
                    t + 1,
                )
            else:
                self._append_batch(w, b, t, t + 1)

    def _set_status(self, status: str, error: str = "") -> None:
        if status != self.status or error != self.last_error:
            self.status = status
            self.status_at = _time.time()
            self.last_error = error

    def tick_once(self) -> int:
        """Advance every subsource by one tick; returns the new frontier."""
        t = self.t
        self._append_all(self.adapter.tick(t, t), t)
        self.t = t + 1
        return self.t

    def start(self) -> None:
        if self.tick_interval is None or self._thread is not None:
            return

        def run():
            while not self._stop.is_set():
                try:
                    self.tick_once()
                except Exception as e:
                    # A failing tick stalls the source, it does not
                    # kill the runner: the generator retries next
                    # interval against fresh durable state, and
                    # mz_source_statuses shows the stall + error.
                    self._set_status("stalled", repr(e))
                else:
                    if self.status == "stalled":
                        self._set_status("running")
                _time.sleep(self.tick_interval)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        self._set_status("stopped")
