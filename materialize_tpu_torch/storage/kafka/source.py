"""Broker-backed source: fetch -> decode -> envelope -> update batches.

Analog of the reference's Kafka source pipeline
(storage/src/source/kafka.rs + source_reader_pipeline.rs:165 +
reclocking per source/reclock.rs): each tick consumes every partition
up to its current end offset, decodes records, applies the envelope,
and emits update batches. The offset<->tick binding (the remap
collection) is itself a durable SUBSOURCE ``__remap`` with schema
(partition, end_offset): each tick retracts the old binding row and
asserts the new one, so on restart the adapter reads the remap shard's
latest snapshot and resumes from exactly the offsets the durable data
reflects — re-fetching nothing, re-emitting nothing (the data shard's
upper check skips re-appends of already-durable ticks anyway).

Envelopes (storage/src/upsert.rs + the debezium decode path):
- NONE: every record is an insert (+1)
- UPSERT: key bytes -> latest value; a NULL value is a delete;
  state is rebuilt on restart from the emitted collection itself
  (the key columns are a prefix of the row), the persist-rehydration
  model rather than the reference's RocksDB sidecar
- DEBEZIUM: value {"before": ..., "after": ...}: retract before,
  insert after

The port's copy of ``materialize_tpu/storage/kafka/source.py``: the
same offsets bind to the same ticks (``MAX_RECORDS_PER_TICK``), and
the update batches are built on the host, as every port source's.
"""

from __future__ import annotations

import time as _time

import numpy as np

from ...repr.schema import Column, ColumnType, Schema
from .broker import FileBroker
from .decode import DecodeError, make_decoder

REMAP_SCHEMA = Schema(
    [
        Column("partition", ColumnType.INT64),
        Column("end_offset", ColumnType.INT64),
    ]
)

MAX_RECORDS_PER_TICK = 100_000


class KafkaSourceAdapter:
    """GeneratorAdapter-shaped adapter reading a broker topic.

    Options (CREATE SOURCE ... FROM KAFKA, parsed upstream):
      broker:   FileBroker root path (or a Broker instance in-process)
      topic:    topic name
      format:   json | csv | text | bytes | avro
      envelope: none | upsert | debezium       (default none)
      key_format / key_columns: for UPSERT, how the key maps to the
                leading columns (default: json over the first column)
      registry: schema-registry json path (avro)
    """

    def __init__(self, options: dict, schema: Schema):
        broker = options.get("broker")
        if broker is None:
            raise ValueError("KAFKA source requires BROKER")
        self.broker = (
            broker
            if hasattr(broker, "fetch")
            else FileBroker(str(broker))
        )
        self.topic = options.get("topic")
        if not self.topic:
            raise ValueError("KAFKA source requires TOPIC")
        if self.topic not in self.broker.topics():
            raise ValueError(f"unknown topic {self.topic!r}")
        self.value_schema = schema
        fmt = str(options.get("format", "json"))
        self.decoder = make_decoder(
            fmt, schema, options.get("registry")
        )
        self.envelope = str(options.get("envelope", "none")).lower()
        if self.envelope not in ("none", "upsert", "debezium"):
            raise ValueError(f"unknown envelope {self.envelope!r}")
        nparts = self.broker.partitions(self.topic)
        self.offsets = [0] * nparts
        self.name = options.get("_name", self.topic)
        # progress subsource name mirrors the reference's <source>_progress
        # collections (offset->time bindings, source/reclock.rs)
        self.progress_name = f"{self.name}_progress"
        self.subsources = {
            self.name: schema,
            self.progress_name: REMAP_SCHEMA,
        }
        if self.envelope == "upsert":
            nkey = int(options.get("key_columns", 1))
            self.key_arity = nkey
            self._state: dict[tuple, tuple] = {}
        # DEBEZIUM values are {"before":{...}|null, "after":{...}|null}
        # decoded field-wise with the value decoder.

    # -- envelope machinery -------------------------------------------------
    def _apply_envelope(self, records) -> list:
        """decoded records -> [(row_tuple, diff)]"""
        out = []
        for rec, row in records:
            if self.envelope == "none":
                out.append((tuple(row), 1))
            elif self.envelope == "upsert":
                key = tuple(row[: self.key_arity]) if row is not None \
                    else self._key_from_bytes(rec.key)
                old = self._state.get(key)
                if rec.value is None or row is None:  # delete
                    if old is not None:
                        out.append((old, -1))
                        del self._state[key]
                else:
                    new = tuple(row)
                    if old == new:
                        continue
                    if old is not None:
                        out.append((old, -1))
                    self._state[key] = new
                    out.append((new, 1))
                # (dedup of equal old/new matches upsert.rs semantics)
            else:  # debezium
                before, after = row  # _decode_debezium returns the pair
                if before is not None:
                    out.append((tuple(before), -1))
                if after is not None:
                    out.append((tuple(after), 1))
        return out

    def _key_from_bytes(self, key: bytes | None) -> tuple:
        import json as _json

        if key is None:
            return (None,) * self.key_arity
        try:
            v = _json.loads(key)
        except Exception:
            v = key.decode(errors="replace")
        if isinstance(v, list):
            return tuple(v[: self.key_arity])
        return (v,) + (None,) * (self.key_arity - 1)

    def _decode_record(self, rec):
        if self.envelope == "debezium":
            import json as _json

            try:
                obj = _json.loads(rec.value)
            except Exception as e:
                raise DecodeError(f"bad debezium value: {e}") from e
            payload = obj.get("payload", obj)
            fields = self.decoder.fields

            def side(x):
                if x is None:
                    return None
                return [f(x.get(name)) for name, f in fields]

            return (side(payload.get("before")),
                    side(payload.get("after")))
        if rec.value is None:
            return None  # upsert tombstone
        return self.decoder.decode(rec.value)

    # -- GeneratorAdapter interface -----------------------------------------
    def snapshot(self) -> dict:
        return self.tick(0, 0)

    def tick(self, tick: int, time: int) -> dict:
        t0 = _time.perf_counter()
        decoded = []
        remap_updates = []  # (row, diff)
        budget = MAX_RECORDS_PER_TICK
        for p in range(len(self.offsets)):
            start = self.offsets[p]
            end = self.broker.end_offset(self.topic, p)
            end = min(end, start + budget)
            if end <= start:
                continue
            recs = self.broker.fetch(self.topic, p, start, end - start)
            for rec in recs:
                decoded.append((rec, self._decode_record(rec)))
            remap_updates.append(((p, start), -1))
            remap_updates.append(((p, end), 1))
            self.offsets[p] = end
            budget -= end - start
        out = {}
        updates = self._apply_envelope(decoded)
        if updates:
            out[self.name] = _rows_to_batch(
                self.value_schema, updates, time
            )
        if remap_updates:
            # drop the (p, 0) retraction of a partition's first binding:
            # it was never asserted
            remap_updates = [
                (r, d)
                for r, d in remap_updates
                if not (d == -1 and r[1] == 0)
            ]
            out[self.progress_name] = _rows_to_batch(
                REMAP_SCHEMA, remap_updates, time
            )
        if decoded:
            _count_decoded(len(decoded), _time.perf_counter() - t0)
        return out

    # -- recovery -----------------------------------------------------------
    def recover_from_shards(self, snapshots: dict, upto: int) -> None:
        """Resume: offsets from the __remap snapshot; upsert state from
        the emitted collection itself (persist-rehydration model)."""
        remap = snapshots.get(self.progress_name, [])
        acc: dict = {}
        for row, d in remap:
            acc[tuple(row)] = acc.get(tuple(row), 0) + d
        for (p, end), d in acc.items():
            if d > 0:
                self.offsets[int(p)] = max(
                    self.offsets[int(p)], int(end)
                )
        if self.envelope == "upsert":
            state: dict = {}
            rows = snapshots.get(self.name, [])
            cnt: dict = {}
            for row, d in rows:
                cnt[tuple(row)] = cnt.get(tuple(row), 0) + d
            for row, d in cnt.items():
                if d > 0:
                    state[row[: self.key_arity]] = row
            self._state = state


def _count_decoded(records: int, seconds: float) -> None:
    """The process's Kafka ingest on its /metrics: records fetched and
    the host seconds of the ticks that fetched them (fetch, decode,
    envelope and batch building)."""
    from ...utils.metrics import REGISTRY

    REGISTRY.get_or_create(
        "counter", "mz_kafka_source_records_total",
        "records the Kafka sources of this process fetched and decoded",
    ).inc(records)
    REGISTRY.get_or_create(
        "counter", "mz_kafka_source_decode_seconds_total",
        "host seconds of the Kafka source ticks that fetched records: "
        "fetch, decode, envelope and update batches",
    ).inc(seconds)


def _rows_to_batch(schema: Schema, updates: list, time: int):
    """[(row_user_values, diff)] -> host Batch in the insert encode path's
    values: STRING through ``GLOBAL_DICT`` (new strings coded in the
    order they first appear, as a value-by-value loop codes them),
    DECIMAL scaled to the column's integer (exact for ``Decimal``, the
    reference's float rounding otherwise), NULLs masked as 0. Built a
    column at a time; the batch lives on the host, as every source's."""
    import decimal

    from ...coord.sources import _HOST
    from ...repr.batch import Batch
    from ...repr.schema import GLOBAL_DICT

    n = len(updates)
    rows = [u[0] for u in updates]
    diffs = np.fromiter((u[1] for u in updates), np.int64, n)
    cols, nulls = [], []
    for j, col in enumerate(schema.columns):
        vals = [r[j] for r in rows]
        mask = np.fromiter((v is None for v in vals), bool, n)
        if mask.any():
            vals = [0 if v is None else v for v in vals]
            nulls.append(mask)
        else:
            nulls.append(None)
        if col.ctype is ColumnType.STRING:
            strs = [str(v) for v in vals]
            code = {s: GLOBAL_DICT.encode(s) for s in dict.fromkeys(
                s for s, null in zip(strs, mask) if not null)}
            code[None] = 0
            arr = np.fromiter(
                (code[None if null else s] for s, null in zip(strs, mask)),
                np.int64, n)
        elif col.ctype is ColumnType.DECIMAL:
            arr = np.fromiter(
                (int((v * 10**col.scale).to_integral_value())
                 if isinstance(v, decimal.Decimal)
                 else round(float(v) * 10**col.scale)
                 for v in vals), np.int64, n)
        elif col.ctype is ColumnType.BOOL:
            arr = np.fromiter((bool(v) for v in vals), bool, n)
        else:
            arr = np.asarray(vals, dtype=col.dtype)
        cols.append(arr.astype(col.dtype, copy=False))
    return Batch.from_numpy(
        schema,
        cols,
        time=np.full(n, time, np.uint64),
        diff=diffs,
        nulls=nulls,
        device=_HOST,
    )
