"""Timestamp oracle: strictly-monotone read/write timestamps.

Analog of ``timestamp-oracle/src/lib.rs:46``: per timeline, hands out
``write_ts`` (strictly increasing; one per group commit) and ``read_ts``
(the latest applied write), durably — a restarted coordinator can never
hand out a timestamp that goes backwards. Backed by the same Consensus
substrate as persist (the reference backs its oracle with Postgres/CRDB).
"""

from __future__ import annotations

import json

from ..storage.persist.location import Consensus, VersionedData


class TimestampOracle:
    def __init__(self, consensus: Consensus, timeline: str = "epoch_ms"):
        self.consensus = consensus
        self.key = f"oracle/{timeline}"
        head = self.consensus.head(self.key)
        if head is None:
            init = json.dumps({"read": 0, "write": 0}).encode()
            self.consensus.compare_and_set(
                self.key, None, VersionedData(0, init)
            )

    def _load(self):
        head = self.consensus.head(self.key)
        return head.seqno, json.loads(head.data)

    def _cas(self, f):
        while True:
            seqno, st = self._load()
            new = f(dict(st))
            if new is None:
                return st
            if self.consensus.compare_and_set(
                self.key,
                seqno,
                VersionedData(seqno + 1, json.dumps(new).encode()),
            ):
                return new

    def write_ts(self, at_least: int = 0) -> int:
        """Allocate the next write timestamp: strictly greater than every
        previously allocated write or applied read timestamp."""

        def f(st):
            st["write"] = max(st["write"] + 1, st["read"] + 1, at_least)
            return st

        return self._cas(f)["write"]

    def peek_write_ts(self) -> int:
        return self._load()[1]["write"]

    def read_ts(self) -> int:
        """The linearizable read timestamp: everything <= this is applied."""
        return self._load()[1]["read"]

    def apply_write(self, ts: int) -> None:
        """Mark a write timestamp applied: read_ts advances to it."""

        def f(st):
            if st["read"] >= ts:
                return None
            st["read"] = max(st["read"], ts)
            st["write"] = max(st["write"], ts)
            return st

        self._cas(f)
