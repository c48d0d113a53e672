"""Minimal partitioned-log broker: the librdkafka-shaped hole.

Interface is the subset of Kafka semantics the source/sink pipeline
needs (storage/src/source/kafka.rs consumes per-partition offset
streams; storage/src/sink/kafka.rs produces with transactional
batches + a progress topic):

- topics with a fixed partition count
- append(topic, partition, records) -> base offset
- fetch(topic, partition, offset, max) -> records from offset
- end_offset(topic, partition)
- append_txn: atomic multi-topic append (the stand-in for Kafka
  transactions backing exactly-once sinks)

``FileBroker`` stores one directory per topic and one segment file per
partition; records are length-prefixed (key, value, timestamp) tuples
with a CRC; an fsync'd offset index makes appends crash-atomic
(truncated tails are discarded on open). Multiple processes may read
while one writes per partition (the Kafka model).

The port's copy of ``materialize_tpu/storage/kafka/broker.py``: the
on-disk layout is the reference's, so either package reads a topic the
other wrote.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import zlib
from dataclasses import dataclass


@dataclass(frozen=True)
class Record:
    key: bytes | None
    value: bytes | None
    offset: int = -1
    timestamp: int = 0  # ms


_HDR = struct.Struct("!iiqI")  # key_len(-1=None), val_len(-1=None), ts, crc


def _enc_record(r: Record) -> bytes:
    k = b"" if r.key is None else r.key
    v = b"" if r.value is None else r.value
    crc = zlib.crc32(k) ^ zlib.crc32(v)
    return (
        _HDR.pack(
            -1 if r.key is None else len(k),
            -1 if r.value is None else len(v),
            r.timestamp,
            crc,
        )
        + k
        + v
    )


class Broker:
    """Partitioned-log interface."""

    def create_topic(self, topic: str, partitions: int = 1) -> None:
        raise NotImplementedError

    def topics(self) -> dict:
        raise NotImplementedError

    def partitions(self, topic: str) -> int:
        return self.topics()[topic]

    def append(self, topic: str, partition: int, records: list) -> int:
        raise NotImplementedError

    def fetch(
        self, topic: str, partition: int, offset: int, max_records: int
    ) -> list:
        raise NotImplementedError

    def end_offset(self, topic: str, partition: int) -> int:
        raise NotImplementedError

    def append_txn(self, appends: list) -> None:
        """Atomically append [(topic, partition, records), ...]: either
        every batch becomes visible or none (Kafka-transaction analog
        for the exactly-once sink)."""
        raise NotImplementedError


class MemBroker(Broker):
    def __init__(self):
        self._topics: dict[str, list[list[Record]]] = {}
        self._lock = threading.Lock()

    def create_topic(self, topic: str, partitions: int = 1) -> None:
        with self._lock:
            if topic not in self._topics:
                self._topics[topic] = [[] for _ in range(partitions)]

    def topics(self) -> dict:
        with self._lock:
            return {t: len(ps) for t, ps in self._topics.items()}

    def append(self, topic: str, partition: int, records: list) -> int:
        with self._lock:
            log = self._topics[topic][partition]
            base = len(log)
            for i, r in enumerate(records):
                log.append(
                    Record(r.key, r.value, base + i, r.timestamp)
                )
            return base

    def fetch(self, topic, partition, offset, max_records):
        with self._lock:
            log = self._topics[topic][partition]
            return list(log[offset : offset + max_records])

    def end_offset(self, topic, partition):
        with self._lock:
            return len(self._topics[topic][partition])

    def append_txn(self, appends):
        with self._lock:
            for topic, partition, records in appends:
                log = self._topics[topic][partition]
                base = len(log)
                for i, r in enumerate(records):
                    log.append(
                        Record(r.key, r.value, base + i, r.timestamp)
                    )


class FileBroker(Broker):
    """Durable file-backed broker.

    Layout: root/<topic>/meta.json {partitions}; root/<topic>/p<N>.log
    (record segments) and p<N>.idx (fsync'd little index: one
    '<offset> <byte_pos>\\n' line per COMMITTED record batch). A crash
    mid-append leaves log bytes past the last committed index entry;
    they are ignored and overwritten. append_txn commits one combined
    index update after all segment writes, ordered so that a crash
    leaves either no visible records or all of them.
    """

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._lock = threading.Lock()
        # (topic, partition) -> [end_offset, end_pos]
        self._ends: dict = {}
        self._replay_journal()

    # -- transaction journal -------------------------------------------------
    def _journal_path(self) -> str:
        return os.path.join(self.root, "txn.journal")

    def _replay_journal(self) -> None:
        """Apply committed-but-unindexed transaction entries: the
        journal fsync is the atomic commit point for append_txn; index
        files are recovered from it after a crash."""
        try:
            with open(self._journal_path()) as f:
                lines = f.readlines()
        except FileNotFoundError:
            return
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                entries = json.loads(line)["entries"]
            except (json.JSONDecodeError, KeyError):
                continue  # torn tail write: uncommitted, ignore
            for topic, p, end_off, end_pos in entries:
                cur = 0
                try:
                    with open(self._idx(topic, p)) as f:
                        for ln in f:
                            ln = ln.strip()
                            if ln:
                                cur = int(ln.split()[0])
                except FileNotFoundError:
                    continue
                if cur < end_off:
                    with open(self._idx(topic, p), "a") as f:
                        f.write(f"{end_off} {end_pos}\n")
                        f.flush()
                        os.fsync(f.fileno())

    # -- layout ------------------------------------------------------------
    def _tdir(self, topic: str) -> str:
        return os.path.join(self.root, topic)

    def _seg(self, topic: str, p: int) -> str:
        return os.path.join(self._tdir(topic), f"p{p}.log")

    def _idx(self, topic: str, p: int) -> str:
        return os.path.join(self._tdir(topic), f"p{p}.idx")

    def create_topic(self, topic: str, partitions: int = 1) -> None:
        with self._lock:
            d = self._tdir(topic)
            os.makedirs(d, exist_ok=True)
            meta = os.path.join(d, "meta.json")
            if not os.path.exists(meta):
                tmp = meta + ".tmp"
                with open(tmp, "w") as f:
                    json.dump({"partitions": partitions}, f)
                os.replace(tmp, meta)
            for p in range(partitions):
                for path in (self._seg(topic, p), self._idx(topic, p)):
                    if not os.path.exists(path):
                        open(path, "ab").close()

    def topics(self) -> dict:
        out = {}
        if not os.path.isdir(self.root):
            return out
        for t in sorted(os.listdir(self.root)):
            meta = os.path.join(self.root, t, "meta.json")
            if os.path.exists(meta):
                with open(meta) as f:
                    out[t] = json.load(f)["partitions"]
        return out

    def _load_end(self, topic: str, p: int):
        key = (topic, p)
        if key in self._ends:
            return self._ends[key]
        end_off, end_pos = 0, 0
        try:
            with open(self._idx(topic, p)) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        a, b = line.split()
                        end_off, end_pos = int(a), int(b)
        except FileNotFoundError:
            pass
        self._ends[key] = [end_off, end_pos]
        return self._ends[key]

    # -- write -------------------------------------------------------------
    def append(self, topic, partition, records) -> int:
        with self._lock:
            return self._append_locked(topic, partition, records)

    def _append_locked(self, topic, partition, records) -> int:
        end = self._load_end(topic, partition)
        base = end[0]
        payload = b"".join(_enc_record(r) for r in records)
        with open(self._seg(topic, partition), "r+b") as f:
            f.seek(end[1])
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        end[0] += len(records)
        end[1] += len(payload)
        with open(self._idx(topic, partition), "a") as f:
            f.write(f"{end[0]} {end[1]}\n")
            f.flush()
            os.fsync(f.fileno())
        return base

    def append_txn(self, appends) -> None:
        with self._lock:
            # 1. write all segment bytes (invisible until indexed)
            staged = []
            for topic, partition, records in appends:
                end = self._load_end(topic, partition)
                payload = b"".join(_enc_record(r) for r in records)
                with open(self._seg(topic, partition), "r+b") as f:
                    f.seek(end[1])
                    f.write(payload)
                    f.flush()
                    os.fsync(f.fileno())
                staged.append(
                    (topic, partition, end, len(records), len(payload))
                )
            # 2. the journal fsync is the ATOMIC COMMIT POINT for the
            # whole transaction (Kafka-transaction analog): either the
            # line is durable and recovery indexes every batch, or it
            # is absent/torn and none become visible
            entries = [
                [topic, partition, end[0] + nrec, end[1] + nbytes]
                for topic, partition, end, nrec, nbytes in staged
            ]
            with open(self._journal_path(), "a") as f:
                f.write(json.dumps({"entries": entries}) + "\n")
                f.flush()
                os.fsync(f.fileno())
            # 3. apply to index files (recovery replays these from the
            # journal after a crash)
            for topic, partition, end, nrec, nbytes in staged:
                end[0] += nrec
                end[1] += nbytes
                with open(self._idx(topic, partition), "a") as f:
                    f.write(f"{end[0]} {end[1]}\n")
                    f.flush()
                    os.fsync(f.fileno())

    # -- read --------------------------------------------------------------
    def fetch(self, topic, partition, offset, max_records):
        # Readers re-scan the index (cheap text file) so cross-process
        # reads see committed appends.
        end_off, end_pos = 0, 0
        entries = []
        try:
            with open(self._idx(topic, partition)) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        a, b = line.split()
                        entries.append((int(a), int(b)))
        except FileNotFoundError:
            return []
        if entries:
            end_off, end_pos = entries[-1]
        if offset >= end_off:
            return []
        out = []
        with open(self._seg(topic, partition), "rb") as f:
            # scan from the latest index entry at or before `offset`
            start_pos, start_off = 0, 0
            for eoff, epos in entries:
                if eoff <= offset:
                    start_off, start_pos = eoff, epos
                else:
                    break
            f.seek(start_pos)
            cur = start_off
            while cur < end_off and len(out) < max_records:
                hdr = f.read(_HDR.size)
                if len(hdr) < _HDR.size:
                    break
                klen, vlen, ts, crc = _HDR.unpack(hdr)
                k = f.read(max(klen, 0)) if klen != 0 else b""
                v = f.read(max(vlen, 0)) if vlen != 0 else b""
                if zlib.crc32(k) ^ zlib.crc32(v) != crc:
                    raise IOError(
                        f"corrupt record at {topic}/p{partition} "
                        f"offset {cur}"
                    )
                if cur >= offset:
                    out.append(
                        Record(
                            None if klen == -1 else k,
                            None if vlen == -1 else v,
                            cur,
                            ts,
                        )
                    )
                cur += 1
        return out

    def end_offset(self, topic, partition):
        # uncached for readers: see committed cross-process appends
        end_off = 0
        try:
            with open(self._idx(topic, partition)) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        end_off = int(line.split()[0])
        except FileNotFoundError:
            pass
        return end_off
