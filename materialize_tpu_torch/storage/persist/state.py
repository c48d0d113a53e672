"""Shard state: the durable description of one time-varying collection.

Analog of ``persist-client/src/internal/state.rs``: a shard is a totally
ordered sequence of immutable batches of ``(data, time, diff)`` updates,
described by ``[lower, upper)`` time bounds, plus the read frontier
``since`` (readers may ask for any ``as_of >= since``) and the write
frontier ``upper`` (the next append must start exactly there). State is
serialized to JSON and advanced only through consensus compare-and-set
(machine.py), so transitions are totally ordered.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field, replace


@dataclass(frozen=True)
class HollowBatch:
    """A batch by reference: blob part keys + time bounds + row count
    (``persist-client/src/internal/state.rs`` HollowBatch analog)."""

    lower: int
    upper: int
    keys: tuple[str, ...]
    n_updates: int
    # Encoded part bytes (sum over keys). Durable so tiering can split
    # hot/cold bytes without fetching cold parts; 0 on states written
    # before this field existed.
    n_bytes: int = 0

    def to_json(self):
        return {
            "lower": self.lower,
            "upper": self.upper,
            "keys": list(self.keys),
            "n": self.n_updates,
            "bytes": self.n_bytes,
        }

    @staticmethod
    def from_json(d) -> "HollowBatch":
        return HollowBatch(
            d["lower"], d["upper"], tuple(d["keys"]), d["n"],
            d.get("bytes", 0),
        )


@dataclass(frozen=True)
class ShardState:
    shard: str
    seqno: int = 0
    since: int = 0
    upper: int = 0
    # Contiguous: batches[i].upper == batches[i+1].lower; empty time
    # ranges are represented as batches with no keys.
    batches: tuple[HollowBatch, ...] = ()
    # Fencing token: only the writer holding the current epoch may
    # append (persist writer fencing / txn-wal fencing analog).
    writer_epoch: int = 0
    # Opaque per-reader since holds: reader id -> frontier. The shard
    # since is the min of these (read holds, coord/read_policy.rs analog).
    reader_holds: tuple[tuple[str, int], ...] = ()
    # Compaction lease (internal/compact.rs + the epoch fencing
    # discipline): at most one compactor holds the lease per shard;
    # the epoch is the fencing token a swap-in must present, so a
    # compactor that lost its lease (expiry + handoff) cannot swap a
    # stale merge over batches a successor already replaced.
    compactor_epoch: int = 0
    compactor_holder: str = ""
    # Wall-clock lease deadline (seconds, time.time domain). A crashed
    # compactor's lease is reclaimable once this passes.
    lease_expires: float = 0.0

    def to_bytes(self) -> bytes:
        return json.dumps(
            {
                "shard": self.shard,
                "seqno": self.seqno,
                "since": self.since,
                "upper": self.upper,
                "batches": [b.to_json() for b in self.batches],
                "writer_epoch": self.writer_epoch,
                "reader_holds": list(map(list, self.reader_holds)),
                "compactor_epoch": self.compactor_epoch,
                "compactor_holder": self.compactor_holder,
                "lease_expires": self.lease_expires,
            }
        ).encode()

    @staticmethod
    def from_bytes(data: bytes) -> "ShardState":
        d = json.loads(data)
        return ShardState(
            shard=d["shard"],
            seqno=d["seqno"],
            since=d["since"],
            upper=d["upper"],
            batches=tuple(HollowBatch.from_json(b) for b in d["batches"]),
            writer_epoch=d["writer_epoch"],
            reader_holds=tuple(
                (r, f) for r, f in d.get("reader_holds", [])
            ),
            compactor_epoch=d.get("compactor_epoch", 0),
            compactor_holder=d.get("compactor_holder", ""),
            lease_expires=d.get("lease_expires", 0.0),
        )

    def referenced_keys(self) -> set[str]:
        out: set[str] = set()
        for b in self.batches:
            out.update(b.keys)
        return out
