"""persist-analog: the durable storage engine.

A shard is a durable time-varying collection (persist-client/src/lib.rs:60):
immutable columnar batch parts in a Blob store, described by a small state
machine advanced via Consensus compare-and-set. See location.py, codec.py,
state.py, machine.py, client.py, operators.py. The durable format is the
reference's, so each package reads the shards the other wrote. The
background compactor (compactor.py) waits for ROADMAP Queue 1 item 6b.
"""

from .client import PartCache, PersistClient, ReadHandle, WriteHandle
from .codec import decode_part, encode_part, part_stats
from .location import (
    Blob,
    Consensus,
    ExternalDurabilityError,
    FileBlob,
    MemBlob,
    MemConsensus,
    SqliteConsensus,
    UnreliableBlob,
    VersionedData,
)
from .machine import (
    CompactionRace,
    CompactorFenced,
    Fenced,
    Machine,
    UpperMismatch,
)
from .operators import (IndexSource, MaintainedView, ShardSource,
                        updates_to_batch)
from .pubsub import PUBSUB, ShardPubSub
from .state import HollowBatch, ShardState

__all__ = [
    "PartCache", "PersistClient", "ReadHandle", "WriteHandle",
    "decode_part", "encode_part", "part_stats",
    "Blob", "Consensus", "ExternalDurabilityError", "FileBlob", "MemBlob",
    "MemConsensus", "SqliteConsensus", "UnreliableBlob", "VersionedData",
    "CompactionRace", "CompactorFenced", "Fenced", "Machine",
    "UpperMismatch",
    "IndexSource", "MaintainedView", "ShardSource", "updates_to_batch",
    "PUBSUB", "ShardPubSub",
    "HollowBatch", "ShardState",
]
