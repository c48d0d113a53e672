"""The shard state machine: all transitions via consensus CaS.

Analog of ``persist-client/src/internal/machine.rs:61`` (``Machine``):
every mutation loads the head state, computes the successor state, and
compare-and-sets it at ``seqno + 1``; on CaS loss it reloads and
re-evaluates (some operations then become no-ops or errors, e.g. an
append whose expected upper no longer matches). Compaction and GC are
the background duties (``internal/compact.rs``, ``internal/gc.rs``).
"""

from __future__ import annotations

import threading
import time as _time
from dataclasses import replace

import numpy as np

from .codec import concat_update_parts, decode_part, encode_part
from .location import (
    Blob,
    Consensus,
    ExternalDurabilityError,
    VersionedData,
    retry_external,
)
from .pubsub import PUBSUB
from .state import HollowBatch, ShardState


class Fenced(RuntimeError):
    """A newer writer registered; this handle must not write again."""


class UpperMismatch(RuntimeError):
    """compare_and_append expected a different shard upper."""

    def __init__(self, expected: int, actual: int):
        super().__init__(f"expected upper {expected}, shard at {actual}")
        self.expected = expected
        self.actual = actual


class CompactionRace(ValueError):
    """A read raced a concurrent compaction: the part it was fetching
    was swapped out, or the since it validated against moved. Transient
    by construction — reloading the state and re-reading always
    succeeds (compaction never changes content, only representation) —
    so retry loops catch exactly this, not blanket ValueError, and a
    real codec/caller bug surfaces immediately. Subclasses ValueError
    because a snapshot below since has always raised ValueError and
    callers pin that contract."""


class CompactorFenced(RuntimeError):
    """The compaction lease moved: this holder's epoch is stale, its
    renew/swap must not land (lease-expiry handoff fencing)."""


class Machine:
    def __init__(self, shard: str, blob: Blob, consensus: Consensus):
        self.shard = shard
        self.blob = blob
        self.consensus = consensus
        self._last_merge_bytes = (0, 0)  # (input, output) of last merge
        self._state_lock = threading.Lock()
        self._state = self._load_or_init()

    # -- state plumbing ----------------------------------------------------
    def _load_or_init(self) -> ShardState:
        head = self.consensus.head(self.shard)
        if head is not None:
            return ShardState.from_bytes(head.data)
        init = ShardState(shard=self.shard)
        if self.consensus.compare_and_set(
            self.shard, None, VersionedData(0, init.to_bytes())
        ):
            return init
        return ShardState.from_bytes(self.consensus.head(self.shard).data)

    def reload(self) -> ShardState:
        head = self.consensus.head(self.shard)
        assert head is not None
        return self._install(ShardState.from_bytes(head.data))

    def _install(self, st: ShardState) -> ShardState:
        """Cache ``st`` unless a newer state is cached already, and
        return the cached state. Threads share a shard's Machine (a
        table's writer and its SUBSCRIBE tail): a reload that read the
        head before another thread's CaS landed must not put the older
        state back, or the writer appends at a stale upper."""
        with self._state_lock:
            if st.seqno >= self._state.seqno:
                self._state = st
            return self._state

    @property
    def state(self) -> ShardState:
        return self._state

    def _apply(self, f):
        """CaS loop: state -> (new_state | None, result). None = no-op.
        Reloads the head each attempt: transition errors (Fenced,
        UpperMismatch) must be judged against the current state, not a
        stale cache — a fenced writer with a stale cache would otherwise
        see UpperMismatch instead of Fenced."""
        while True:
            st = self.reload()
            new, result = f(st)
            if new is None:
                return result
            new = replace(new, seqno=st.seqno + 1)
            if self.consensus.compare_and_set(
                self.shard, st.seqno, VersionedData(new.seqno, new.to_bytes())
            ):
                self._install(new)
                # Push notification (pubsub.py): wake in-process
                # waiters (wait_for_upper, compactor listeners) the
                # moment the CaS lands.
                PUBSUB.publish(self.shard, new.seqno)
                return result
            self.reload()

    # -- transitions -------------------------------------------------------
    def register_writer(self) -> int:
        """Claim the write epoch, fencing all previous writers
        (``ComputeCommand::Hello{nonce}`` / persist writer-fencing analog)."""

        def f(st):
            epoch = st.writer_epoch + 1
            return replace(st, writer_epoch=epoch), epoch

        return self._apply(f)

    def compare_and_append(
        self,
        keys: tuple[str, ...],
        lower: int,
        upper: int,
        n_updates: int,
        epoch: int,
        n_bytes: int = 0,
    ) -> None:
        """Append a batch [lower, upper) iff lower == shard upper and the
        caller still holds the current write epoch."""
        assert upper > lower, (lower, upper)

        def f(st):
            if epoch != st.writer_epoch:
                raise Fenced(
                    f"epoch {epoch} fenced by {st.writer_epoch}"
                )
            if lower != st.upper:
                raise UpperMismatch(lower, st.upper)
            batch = HollowBatch(
                lower, upper, tuple(keys), n_updates, n_bytes
            )
            return (
                replace(st, upper=upper, batches=st.batches + (batch,)),
                None,
            )

        self._apply(f)

    def register_reader(self, reader_id: str) -> int:
        """Install a read hold at the current since; returns that since."""

        def f(st):
            holds = dict(st.reader_holds)
            if reader_id in holds:
                return None, holds[reader_id]
            holds[reader_id] = st.since
            return (
                replace(st, reader_holds=tuple(sorted(holds.items()))),
                st.since,
            )

        return self._apply(f)

    def downgrade_since(self, reader_id: str, new_since: int) -> int:
        """Advance one reader's hold; shard since = min over holds.
        Returns the resulting shard since."""

        def f(st):
            holds = dict(st.reader_holds)
            cur = holds.get(reader_id, st.since)
            holds[reader_id] = max(cur, new_since)
            since = min(holds.values()) if holds else max(
                st.since, new_since
            )
            since = max(since, st.since)
            return (
                replace(
                    st,
                    since=since,
                    reader_holds=tuple(sorted(holds.items())),
                ),
                since,
            )

        return self._apply(f)

    def expire_reader(self, reader_id: str) -> None:
        def f(st):
            holds = dict(st.reader_holds)
            if reader_id not in holds:
                return None, None
            del holds[reader_id]
            since = min(holds.values()) if holds else st.since
            return (
                replace(
                    st,
                    since=max(st.since, since),
                    reader_holds=tuple(sorted(holds.items())),
                ),
                None,
            )

        self._apply(f)

    # -- compaction leases -------------------------------------------------
    def acquire_compaction_lease(
        self, holder: str, duration_s: float, now: float | None = None
    ) -> int | None:
        """Claim (or re-claim / take over) the shard's compaction lease.
        Succeeds when the lease is free, expired, or already held by
        ``holder``; bumps the compactor epoch — the fencing token every
        later renew/swap must present — and returns it. Returns None
        while a live lease is held by someone else (back off; the
        holder or its expiry will free it). ``now`` is injectable so
        the interleave explorer can drive virtual time."""

        def f(st):
            t = _time.time() if now is None else now
            held = (
                st.compactor_holder
                and st.compactor_holder != holder
                and st.lease_expires > t
            )
            if held:
                return None, None
            return (
                replace(
                    st,
                    compactor_epoch=st.compactor_epoch + 1,
                    compactor_holder=holder,
                    lease_expires=t + duration_s,
                ),
                st.compactor_epoch + 1,
            )

        return self._apply(f)

    def renew_compaction_lease(
        self, epoch: int, duration_s: float, now: float | None = None
    ) -> bool:
        """Extend the lease deadline iff ``epoch`` is still current.
        A False return means the lease moved (expiry + handoff): the
        caller is fenced and must abandon its merge — its swap would
        be rejected anyway, this just saves the work."""

        def f(st):
            if epoch != st.compactor_epoch:
                return None, False
            t = _time.time() if now is None else now
            return replace(st, lease_expires=t + duration_s), True

        return self._apply(f)

    def release_compaction_lease(self, epoch: int) -> None:
        def f(st):
            if epoch != st.compactor_epoch:
                return None, None
            return (
                replace(st, compactor_holder="", lease_expires=0.0),
                None,
            )

        self._apply(f)

    def swap_compacted(
        self,
        prefix: tuple[HollowBatch, ...],
        merged_key: str,
        n: int,
        n_bytes: int,
        epoch: int | None = None,
    ) -> int:
        """Swap ``prefix`` (the exact batches that were merged) for one
        merged batch. Returns the number of replaced parts, 0 when the
        swap lost a race (prefix no longer present — a concurrent
        compaction already replaced some of it; the caller discards its
        merge). With ``epoch`` set, the swap additionally requires the
        compaction lease epoch to still match: a compactor that lost
        its lease mid-merge raises CompactorFenced instead of swapping
        a stale merge over its successor's work."""
        if not prefix:
            return 0
        lower = prefix[0].lower
        upper = prefix[-1].upper
        old_n = sum(len(b.keys) for b in prefix)

        def f(cur):
            if epoch is not None and epoch != cur.compactor_epoch:
                raise CompactorFenced(
                    f"lease epoch {epoch} fenced by {cur.compactor_epoch}"
                )
            if cur.batches[: len(prefix)] != prefix:
                return None, 0  # lost the race; discard our merge
            keep = cur.batches[len(prefix):]
            batch = HollowBatch(
                lower, upper, (merged_key,) if n else (), n,
                n_bytes if n else 0,
            )
            return replace(cur, batches=(batch,) + keep), old_n

        return self._apply(f)

    # -- background duties -------------------------------------------------
    def maybe_compact(self, max_batches: int = 8, ctx: str = "inline") -> int:
        """Merge all current batches into one when the spine grows past
        ``max_batches``: reads parts, forwards times to ``since`` (logical
        compaction), consolidates, writes one merged part, swaps it in,
        then deletes the replaced parts. Returns #parts replaced.

        ``ctx`` attributes the merge work ("inline" = on the caller's
        — i.e. the writer's tick — path, "background" = the detached
        compactor's worker thread) in the counted compaction stats
        (compactor.STATS): the compactor-smoke gate asserts the tick
        path did ZERO of this under compaction_mode=background.

        Concurrency: the swap requires the EXACT batch prefix that was
        merged to still be present (identity on the HollowBatch tuple) —
        a racing compaction that replaced any of those batches makes this
        one a no-op (its merged part is discarded), so no appended or
        concurrently-compacted data can be dropped."""
        st = self.reload()
        if len(st.batches) <= max_batches:
            return 0
        prefix = st.batches
        merged_key, n, old_keys = self._merge_parts(st, ctx=ctx)
        replaced = self.swap_compacted(
            prefix, merged_key, n, self._last_merge_bytes[1]
        )
        from .compactor import STATS

        STATS.record_merge(
            self.shard, ctx, replaced,
            self._last_merge_bytes[0], self._last_merge_bytes[1],
        )
        # Best-effort blob cleanup: state is already durable; a failed
        # delete leaks a part but never corrupts (internal/gc.rs model).
        doomed = old_keys if replaced else ([merged_key] if n else [])
        self._delete_parts(doomed)
        return replaced

    def _delete_parts(self, keys) -> None:
        cache = getattr(self, "part_cache", None)
        if cache is not None:
            cache.evict_keys(keys)
        for k in keys:
            try:
                retry_external(lambda k=k: self.blob.delete(k))
            except ExternalDurabilityError:
                pass

    def _merge_parts(self, st: ShardState, ctx: str = "inline"):
        """Read every part, forward times to since, consolidate, write
        one part. Host-side numpy work (a background task in the
        reference's compaction pool, internal/compact.rs). Leaves
        (input_bytes, output_bytes) in ``self._last_merge_bytes``."""
        schema = None
        parts = []
        old_keys = []
        in_bytes = 0
        self._last_merge_bytes = (0, 0)
        from ...repr.schema import GLOBAL_DICT

        dict_epoch = GLOBAL_DICT.epoch
        for b in st.batches:
            for k in b.keys:
                old_keys.append(k)
                data = retry_external(lambda k=k: self.blob.get(k))
                assert data is not None, f"missing blob part {k}"
                in_bytes += len(data)
                sch, cols, nulls, time, diff = decode_part(data)
                schema = schema or sch
                parts.append((cols, nulls, time, diff))
        if schema is None:
            self._last_merge_bytes = (in_bytes, 0)
            return "", 0, old_keys
        cols, nulls, time, diff = concat_update_parts(
            parts, len(schema.columns)
        )
        # Logical compaction: forward every time to the since frontier.
        time = np.maximum(time, np.uint64(st.since))
        # Consolidate: sum diffs of identical (row, time); drop zeros.
        # Native C++ kernel; float keys grouped by bit pattern (any total
        # order works for grouping), null masks as extra key columns.
        from ... import native

        def as_key(c):
            if c.dtype == np.int64:
                return c
            if c.dtype == np.float64:
                # Normalize -0.0 to +0.0 so a retraction computed with the
                # other zero's bit pattern still cancels; NaNs group by
                # bit pattern, which is stricter than float equality (a
                # NaN never equals itself) and thus still cancels exact
                # re-derivations.
                return np.where(c == 0.0, 0.0, c).view(np.int64)
            return c.astype(np.int64)

        key_cols = [as_key(c) for c in cols]
        key_cols += [
            (
                nl if nl is not None else np.zeros(len(time), np.bool_)
            ).astype(np.int64)
            for nl in nulls
        ]
        key_cols.append(time.astype(np.int64))
        sel, diff = native.consolidate_i64(key_cols, diff)
        cols = [c[sel] for c in cols]
        nulls = [nl[sel] if nl is not None else None for nl in nulls]
        time = time[sel]
        n = len(time)
        if n == 0:
            self._last_merge_bytes = (in_bytes, 0)
            return "", 0, old_keys
        merged_key = f"{self.shard}/compact-{st.seqno}-{st.upper}"
        # Retried like every durability-layer write (the
        # chaos storms run compaction under UnreliableBlob, and an
        # injected transient failure must not abort a compaction the
        # part reads already survived).
        data = encode_part(schema, cols, nulls, time, diff)
        retry_external(lambda: self.blob.set(merged_key, data))
        self._last_merge_bytes = (in_bytes, len(data))
        # Write-through: the merged part replaces hot parts, so it is
        # hot itself (a lost swap race evicts it via _delete_parts).
        cache = getattr(self, "part_cache", None)
        if cache is not None:
            cache.put(
                merged_key, schema, cols, nulls, time, diff, len(data),
                dict_epoch=dict_epoch,
            )
        from .compactor import STATS

        STATS.record_blob_write(self.shard, ctx, len(data))
        return merged_key, n, old_keys

    def gc_consensus(self, keep_last: int = 1) -> None:
        """Truncate consensus history below the head (state GC,
        ``internal/gc.rs``): old seqnos are only needed for debugging."""
        head = self.consensus.head(self.shard)
        if head is not None and head.seqno >= keep_last:
            self.consensus.truncate(
                self.shard, head.seqno - keep_last + 1
            )
