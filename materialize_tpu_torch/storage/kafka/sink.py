"""Exactly-once broker sink: shard tail -> encoded records.

Analog of the reference's Kafka sink (storage/src/sink/kafka.rs):
exactly-once via a PROGRESS TOPIC — each emission transactionally
appends the data records and a progress record carrying the new upper;
on restart the sink reads the last progress record and resumes from
that frontier, so every update is published exactly once even across
crashes. Here the transaction is the broker's atomic multi-topic
append (FileBroker.append_txn), standing in for Kafka transactions.

Envelope DEBEZIUM publishes {"before": ..., "after": ...} pairs per
changed row (consolidated per key within a timestamp); ENVELOPE NONE
(the reference's ENVELOPE DEBEZIUM-free JSON sinks) publishes
{"row": ..., "diff": n} update records.

The port's copy of ``materialize_tpu/storage/kafka/sink.py``: record
bytes equal to the reference's for the same updates.
"""

from __future__ import annotations

import json
import threading
import time as _time

from ...repr.schema import Schema
from .broker import Broker, Record
from .decode import make_encoder


class KafkaSink:
    """Tails a shard (an MV/table output) and publishes its updates."""

    def __init__(
        self,
        client,
        shard: str,
        schema: Schema,
        broker: Broker,
        topic: str,
        fmt: str = "json",
        envelope: str = "none",
        registry: str | None = None,
        key_columns: int = 0,
        sink_id: str = "sink",
    ):
        self.client = client
        self.schema = schema
        self.broker = broker
        self.topic = topic
        self.progress_topic = f"__progress_{sink_id}"
        self.envelope = envelope.lower()
        self.encoder = make_encoder(fmt, schema, registry)
        self.key_columns = key_columns
        broker.create_topic(topic, 1)
        broker.create_topic(self.progress_topic, 1)
        self.reader = client.open_reader(shard, f"sink-{sink_id}")
        # resume frontier: last committed progress record
        self.frontier = 0
        end = broker.end_offset(self.progress_topic, 0)
        if end > 0:
            last = broker.fetch(self.progress_topic, 0, end - 1, 1)[0]
            self.frontier = json.loads(last.value)["frontier"]
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _encode_update(self, row: tuple, t: int, diff: int) -> list:
        if self.envelope == "debezium":
            body = {
                "payload": {
                    "before": None if diff > 0 else self._obj(row),
                    "after": self._obj(row) if diff > 0 else None,
                    "ts": t,
                }
            }
            return [
                Record(None, json.dumps(body).encode(), timestamp=t)
            ] * abs(diff)
        recs = []
        for _ in range(abs(diff)):
            body = self.encoder.encode(row)
            # ENVELOPE NONE json carries the diff alongside
            if self.envelope == "none":
                obj = json.loads(body)
                body = json.dumps(
                    {"row": obj, "diff": 1 if diff > 0 else -1, "ts": t},
                    sort_keys=True,
                ).encode()
            recs.append(Record(None, body, timestamp=t))
        return recs

    def _obj(self, row: tuple) -> dict:
        import decimal

        return {
            c.name: (float(v) if isinstance(v, decimal.Decimal) else v)
            for c, v in zip(self.schema.columns, row)
        }

    def step(self, timeout: float = 1.0) -> bool:
        """Publish updates in [frontier, shard upper); returns False if
        the shard has not advanced."""
        got = self.reader.listen_next(self.frontier, timeout)
        if got is None:
            return False
        (_sch, cols, nulls, time_, diff), new_upper = got
        from ...repr.schema import decode_result_rows

        rows = decode_result_rows(self.schema, cols, nulls, time_, diff)
        records = []
        for r in rows:
            *vals, t, d = r
            if t < self.frontier:
                continue  # already published (progress says so)
            records.extend(self._encode_update(tuple(vals), t, d))
        progress = Record(
            None,
            json.dumps({"frontier": new_upper}).encode(),
        )
        appends = []
        if records:
            appends.append((self.topic, 0, records))
        # progress entry LAST: see FileBroker.append_txn ordering note
        appends.append((self.progress_topic, 0, [progress]))
        self.broker.append_txn(appends)
        self.frontier = new_upper
        return True

    def run_until(self, frontier: int, timeout: float = 30.0) -> None:
        deadline = _time.time() + timeout
        while self.frontier < frontier:
            if not self.step(timeout=0.5) and _time.time() > deadline:
                raise TimeoutError(
                    f"sink stalled below frontier {frontier}"
                )

    def start(self, interval: float = 0.05) -> None:
        if self._thread is not None:
            return

        def run():
            while not self._stop.is_set():
                if not self.step(timeout=0.2):
                    _time.sleep(interval)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        try:
            self.reader.expire()
        except Exception:
            pass
