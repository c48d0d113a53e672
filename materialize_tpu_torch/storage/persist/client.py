"""Persist client: shard handles over (Blob, Consensus).

Analog of ``persist-client/src/lib.rs`` + ``read.rs``/``write.rs``:
``PersistClient.open(shard)`` yields a ``WriteHandle`` (compare-and-append
of update batches) and a ``ReadHandle`` (snapshot at an ``as_of`` and
``listen`` for updates beyond it). All updates are host columnar
``(cols, nulls, time, diff)``; the dataflow bridges (operators.py) turn
these into device batches.
"""

from __future__ import annotations

import itertools
import threading
import time as _time

import numpy as np

from ...repr.batch import Batch
from ...repr.schema import Schema
from .codec import concat_update_parts, decode_part, encode_part
from .location import (
    Blob,
    Consensus,
    ExternalDurabilityError,
    retry_external as _retry,
)
from .machine import CompactionRace, Fenced, Machine, UpperMismatch
from .pubsub import PUBSUB


class PartCache:
    """The hot tier of batch-part tiering: decoded parts
    kept host-resident so hot recent spans never touch blob on read,
    while cold parts live blob-only and lazily rehydrate on first
    read. LRU over encoded-size accounting against the
    ``part_hot_bytes`` budget; the ``part_tiering`` dyncfg picks
    auto (budgeted) / all_hot (never evict) / all_cold (never cache).

    Cached arrays are shared: readers must mask-copy (they already do
    — ``snapshot``/``fetch`` build new arrays), never mutate. One cache
    per PersistClient, so a client's shard namespace is its cache
    namespace (two tests reusing shard names on fresh blobs cannot
    cross-contaminate)."""

    def __init__(self):
        self._lock = threading.Lock()
        # key -> (schema, cols, nulls, time, diff, encoded_bytes);
        # dict order is the LRU order (move-to-end on hit).
        self._parts: dict[str, tuple] = {}
        self.hot_bytes = 0
        self.hits = 0
        self.misses = 0
        self.rehydrations = 0
        self.evictions = 0
        # Cached columns hold string CODES remapped through the live
        # GLOBAL_DICT at decode time (codec.decode_part); a dictionary
        # rebalance relabels every code, so a changed dict epoch is
        # total invalidation (repr/schema.py epoch contract) — stale
        # hot parts would decode to the WRONG strings.
        from ...repr.schema import GLOBAL_DICT

        self._dict_epoch = GLOBAL_DICT.epoch

    def _check_epoch_locked(self) -> None:
        from ...repr.schema import GLOBAL_DICT

        epoch = GLOBAL_DICT.epoch
        if epoch != self._dict_epoch:
            self._parts.clear()
            self.hot_bytes = 0
            self._dict_epoch = epoch

    @staticmethod
    def _config():
        from ...utils.dyncfg import (
            COMPUTE_CONFIGS,
            PART_HOT_BYTES,
            PART_TIERING,
        )

        return PART_TIERING(COMPUTE_CONFIGS), PART_HOT_BYTES(
            COMPUTE_CONFIGS
        )

    def put(
        self, key, schema, cols, nulls, time, diff, nbytes,
        rehydrated: bool = False,
        dict_epoch: int | None = None,
    ) -> None:
        mode, budget = self._config()
        if mode == "all_cold":
            return
        with self._lock:
            self._check_epoch_locked()
            if (
                dict_epoch is not None
                and dict_epoch != self._dict_epoch
            ):
                # Decoded under a pre-rebalance labeling that a
                # concurrent rebalance just retired: caching it would
                # serve wrong strings. Drop; the next read re-decodes.
                return
            if rehydrated:
                self.rehydrations += 1
            if key in self._parts:
                self.hot_bytes -= self._parts.pop(key)[5]
            self._parts[key] = (schema, cols, nulls, time, diff, nbytes)
            self.hot_bytes += nbytes
            if mode == "auto":
                while self.hot_bytes > budget and len(self._parts) > 1:
                    _k, ent = next(iter(self._parts.items()))
                    del self._parts[_k]
                    self.hot_bytes -= ent[5]
                    self.evictions += 1

    def get(self, key):
        with self._lock:
            self._check_epoch_locked()
            ent = self._parts.pop(key, None)
            if ent is None:
                self.misses += 1
                return None
            self._parts[key] = ent  # move to MRU end
            self.hits += 1
            return ent

    def evict_keys(self, keys) -> None:
        with self._lock:
            for k in keys:
                ent = self._parts.pop(k, None)
                if ent is not None:
                    self.hot_bytes -= ent[5]

    def hot_bytes_for(self, keys) -> int:
        """Encoded bytes of the given part keys currently hot."""
        with self._lock:
            return sum(
                self._parts[k][5] for k in keys if k in self._parts
            )

    def stats(self) -> dict:
        with self._lock:
            return {
                "hot_bytes": self.hot_bytes,
                "parts": len(self._parts),
                "hits": self.hits,
                "misses": self.misses,
                "rehydrations": self.rehydrations,
                "evictions": self.evictions,
            }


class WriteHandle:
    def __init__(
        self, machine: Machine, schema: Schema,
        auto_compaction: bool = False,
    ):
        self.machine = machine
        self.schema = schema
        self.epoch = machine.register_writer()
        self.auto_compaction = auto_compaction
        self._part_seq = 0

    @property
    def upper(self) -> int:
        return self.machine.state.upper

    def compare_and_append(
        self,
        cols,
        nulls,
        time,
        diff,
        lower: int,
        upper: int,
    ) -> None:
        """Durably append updates with times in [lower, upper); raises
        UpperMismatch if the shard upper moved, Fenced if a newer writer
        registered. An empty update set still advances the upper."""
        time = np.asarray(time, np.uint64)
        diff = np.asarray(diff, np.int64)
        n = len(diff)
        nbytes = 0
        if n:
            assert time.min() >= lower and time.max() < upper, (
                "updates outside [lower, upper)"
            )
            key, nbytes = self._write_part(cols, nulls, time, diff)
            keys = (key,)
        else:
            keys = ()
        self.machine.compare_and_append(
            keys, lower, upper, n, self.epoch, n_bytes=nbytes
        )
        if self.auto_compaction:
            self._maybe_request_compaction()

    def _maybe_request_compaction(self) -> None:
        """The writer's entire compaction duty: when the
        post-append spine passes the threshold, either request the
        background service (O(1) enqueue — the tick path never merges,
        never blob-writes) or, under compaction_mode=inline, do the
        old on-path merge (kept as the measurable baseline)."""
        from ...utils.dyncfg import (
            ARRANGEMENT_COMPACTION_BATCHES,
            COMPACTION_MODE,
            COMPUTE_CONFIGS,
        )

        mode = COMPACTION_MODE(COMPUTE_CONFIGS)
        if mode == "off":
            return
        threshold = ARRANGEMENT_COMPACTION_BATCHES(COMPUTE_CONFIGS)
        # The just-CaS'd cached state: no consensus read on this path.
        if len(self.machine.state.batches) <= threshold:
            return
        if mode == "inline":
            self.machine.maybe_compact(max_batches=threshold, ctx="inline")
        else:
            from .compactor import compaction_service

            compaction_service().request(self.machine)

    def append_batch(self, batch: Batch, lower: int, upper: int) -> None:
        """Append a device Batch's valid rows."""
        cols = batch.to_columns()
        data_cols, time, diff = cols[:-2], cols[-2], cols[-1]
        n = len(diff)
        nulls = [
            None if nl is None else nl[:n].cpu().numpy() for nl in batch.nulls
        ]
        self.compare_and_append(data_cols, nulls, time, diff, lower, upper)

    def _write_part(self, cols, nulls, time, diff) -> tuple[str, int]:
        cols = [np.asarray(c) for c in cols]
        nulls = (
            [None if nl is None else np.asarray(nl, bool) for nl in nulls]
            if nulls
            else [None] * len(cols)
        )
        from ...repr.schema import GLOBAL_DICT

        dict_epoch = GLOBAL_DICT.epoch
        data = encode_part(self.schema, cols, nulls, time, diff)
        self._part_seq += 1
        key = (
            f"{self.machine.shard}/part-e{self.epoch}-{self._part_seq}"
        )
        _retry(lambda: self.machine.blob.set(key, data))
        # Write-through to the hot tier: the freshest span is exactly
        # what readers fetch next, so it must never pay a rehydration.
        cache = getattr(self.machine, "part_cache", None)
        if cache is not None:
            cache.put(
                key, self.schema, cols, nulls, time, diff, len(data),
                dict_epoch=dict_epoch,
            )
        return key, len(data)


class ReadHandle:
    def __init__(self, machine: Machine, reader_id: str):
        self.machine = machine
        self.reader_id = reader_id
        self.since = machine.register_reader(reader_id)
        # Times a read observed a mid-flight compaction swap and
        # retried (chaos asserts the race actually happened).
        self.race_retries = 0

    @property
    def upper(self) -> int:
        return self.machine.reload().upper

    def downgrade_since(self, new_since: int) -> None:
        self.since = max(self.since, new_since)
        self.machine.downgrade_since(self.reader_id, new_since)

    def expire(self) -> None:
        self.machine.expire_reader(self.reader_id)

    def _read_parts(self, batches):
        """Fetch parts, hot tier first. A part key that is GONE from
        blob was swapped out by a concurrent compaction between our
        state load and this fetch: raise CompactionRace — the caller
        reloads and re-reads (the merged part has identical content),
        and ONLY that exception retries (a decode failure is a real
        codec bug and must surface, operators.py AsOfError note)."""
        schema = None
        out = []
        cache = getattr(self.machine, "part_cache", None)
        for b in batches:
            for k in b.keys:
                ent = cache.get(k) if cache is not None else None
                if ent is not None:
                    sch, cols, nulls, time, diff = ent[:5]
                else:
                    data = _retry(lambda k=k: self.machine.blob.get(k))
                    if data is None:
                        raise CompactionRace(
                            f"part {k} swapped out by a concurrent "
                            "compaction"
                        )
                    from ...repr.schema import GLOBAL_DICT

                    dict_epoch = GLOBAL_DICT.epoch
                    sch, cols, nulls, time, diff = decode_part(data)
                    if cache is not None:
                        # Cold part's first read: rehydrate into the
                        # hot tier (counted; doc/perf.md cost model).
                        cache.put(
                            k, sch, cols, nulls, time, diff, len(data),
                            rehydrated=True,
                            dict_epoch=dict_epoch,
                        )
                schema = schema or sch
                out.append((cols, nulls, time, diff))
        return schema, out

    def snapshot(self, as_of: int):
        """All updates with time <= as_of, times forwarded to as_of —
        the definite collection at as_of (ASOF semantics,
        doc/developer/overview.md:114-120). Requires since <= as_of <
        upper (once readable, reads are repeatable). A read racing a
        just-swapped part retries here against the reloaded state —
        compaction never changes content, so the retry is sound and
        bounded (each retry observes a strictly newer seqno)."""
        for attempt in range(8):
            st = self.machine.reload()
            if as_of >= st.upper:
                raise ValueError(
                    f"as_of {as_of} outside [since {st.since}, "
                    f"upper {st.upper})"
                )
            if as_of < st.since:
                # Transient when racing a since downgrade mid-hydration
                # (the replica re-picks as_of); permanent for a user
                # timestamp (AsOfError guards that path earlier).
                raise CompactionRace(
                    f"as_of {as_of} outside [since {st.since}, "
                    f"upper {st.upper})"
                )
            try:
                # Batches entirely above as_of cannot contribute: skip
                # the fetch.
                schema, parts = self._read_parts(
                    [b for b in st.batches if b.lower <= as_of]
                )
                break
            except CompactionRace:
                self.race_retries += 1
                if attempt == 7:
                    raise
        sel = []
        for cols, nulls, time, diff in parts:
            m = time <= np.uint64(as_of)
            if not m.any():
                continue
            sel.append(
                (
                    [c[m] for c in cols],
                    [None if nl is None else nl[m] for nl in nulls],
                    np.full(int(m.sum()), as_of, np.uint64),
                    diff[m],
                )
            )
        arity = len(sel[0][0]) if sel else 0
        cols, nulls, time, diff = concat_update_parts(sel, arity)
        return schema, cols, nulls, time, diff

    def wait_for_upper(self, frontier: int, timeout: float = 5.0):
        """Block until the shard upper passes ``frontier``; returns the
        new upper or None on timeout. The polling analog of persist
        PubSub-notified Listen (persist-client/src/rpc.rs); the
        coordinator swaps in push notification when in-process."""
        deadline = _time.monotonic() + timeout
        while True:
            st = self.machine.reload()
            if st.upper > frontier:
                return st.upper
            remaining = deadline - _time.monotonic()
            if remaining <= 0:
                return None
            # In-process writers publish on every CaS (machine._apply
            # -> pubsub), so this wakes immediately; the short cap is
            # the poll floor for cross-process writers, who only share
            # consensus.
            PUBSUB.wait(self.machine.shard, min(remaining, 0.002))

    def fetch(self, lo: int, hi: int):
        """Updates with lo <= time < hi. Caller must ensure hi <= upper
        (completeness) and lo >= since (not compacted away). Retries
        the part fetch when racing a compaction swap, like snapshot."""
        for attempt in range(8):
            st = self.machine.reload()
            assert hi <= st.upper, f"fetch hi {hi} beyond upper {st.upper}"
            assert lo >= st.since or lo >= hi, (
                f"fetch lo {lo} below since {st.since}"
            )
            batches = [
                b for b in st.batches if b.upper > lo and b.lower < hi
            ]
            try:
                schema, parts = self._read_parts(batches)
                break
            except CompactionRace:
                self.race_retries += 1
                if attempt == 7:
                    raise
        sel = []
        for cols, nulls, time, diff in parts:
            m = (time >= np.uint64(lo)) & (time < np.uint64(hi))
            sel.append(
                (
                    [c[m] for c in cols],
                    [None if nl is None else nl[m] for nl in nulls],
                    time[m],
                    diff[m],
                )
            )
        arity = len(sel[0][0]) if sel else 0
        cols, nulls, time, diff = concat_update_parts(sel, arity)
        return schema, cols, nulls, time, diff

    def listen_next(self, frontier: int, timeout: float = 5.0):
        """Block for the upper to pass ``frontier``; returns (updates in
        [frontier, new_upper), new_upper) or None on timeout."""
        upper = self.wait_for_upper(frontier, timeout)
        if upper is None:
            return None
        return self.fetch(frontier, upper), upper


class PersistClient:
    """Entry point: open shards by name over one (Blob, Consensus) pair.

    ``auto_compaction=True`` (the production deployments: environmentd's
    coordinator client, replica workers) makes every writer request
    background compaction when its append grows the spine past the
    threshold — per the ``compaction_mode`` dyncfg. Bare clients (unit
    tests, tools) keep the manual ``maybe_compact`` discipline."""

    def __init__(
        self, blob: Blob, consensus: Consensus,
        auto_compaction: bool = False,
    ):
        self.blob = blob
        self.consensus = consensus
        self.auto_compaction = auto_compaction
        self.part_cache = PartCache()
        self._machines: dict[str, Machine] = {}
        self._reader_seq = itertools.count()

    def machine(self, shard: str) -> Machine:
        if shard not in self._machines:
            m = Machine(shard, self.blob, self.consensus)
            m.part_cache = self.part_cache
            self._machines[shard] = m
        return self._machines[shard]

    def tier_split(self, shard: str) -> tuple[int, int]:
        """(hot_bytes, cold_bytes) for one shard's referenced parts —
        the mz_arrangement_sizes tier accounting. Uses the cached state
        (no consensus read: this sits on the frontier-report path)."""
        m = self._machines.get(shard)
        if m is None:
            return 0, 0
        st = m.state
        total = sum(b.n_bytes for b in st.batches)
        hot = self.part_cache.hot_bytes_for(st.referenced_keys())
        return hot, max(0, total - hot)

    def open_writer(self, shard: str, schema: Schema) -> WriteHandle:
        return WriteHandle(
            self.machine(shard), schema,
            auto_compaction=self.auto_compaction,
        )

    def open_reader(self, shard: str, reader_id: str | None = None) -> ReadHandle:
        rid = reader_id or f"r{next(self._reader_seq)}-{id(self):x}"
        return ReadHandle(self.machine(shard), rid)
