"""The detached compaction plane: leased, off-path spine maintenance.

Analog of ``persist-client/src/internal/compact.rs`` run the way the
reference deploys it (PAPER.md: persist's compactor service): the
writer's tick path only *requests* compaction — an O(1) enqueue when
the spine passes ``arrangement_compaction_batches`` — and a worker
thread does the reads/merge/blob-write/swap off the serving path.

Safety is lease + epoch fencing (the fencing discipline applied to
compaction): a compactor must hold the shard's compaction lease
(``Machine.acquire_compaction_lease``), renew it before the swap, and
present its lease epoch at the swap — a compactor that stalled past its
lease (SIGKILL, GC pause) is fenced out by the successor's epoch bump,
so its stale merge can never overwrite the successor's work. A crashed
compactor leaves at most a held-until-expiry lease and an orphan blob
part; neither affects readable content.

Everything is COUNTED (``STATS``): merges and merged-part blob writes
are attributed to the context that performed them ("inline" = the
writer's tick path, "background" = this service), which is what the
``compactor-smoke`` CI gate and the acceptance criterion assert —
zero tick-path compaction work under ``compaction_mode=background``,
by counter, not by inspection.
"""

from __future__ import annotations

import os
import threading
import time as _time
from collections import deque

from .machine import CompactorFenced, Machine
from .pubsub import PUBSUB


class CompactorCrash(RuntimeError):
    """Injected mid-merge crash (chaos hook): the worker dies leaving
    its lease held and possibly an orphan merged part — exactly the
    durable residue of a SIGKILL at that point."""


class CompactionStats:
    """Process-global counted compaction activity, per shard. Served by
    ``mz_compactions``; replicas piggyback their rows to the controller
    on Frontiers like every other introspection source."""

    FIELDS = (
        "requests",
        "merges_inline",
        "merges_background",
        "merges_lost",
        "blob_writes_inline",
        "blob_writes_background",
        "input_bytes",
        "output_bytes",
        "off_path_s",
        "lease_epoch",
        "fenced",
        "crashes",
    )

    def __init__(self):
        self._lock = threading.Lock()
        self._shards: dict[str, dict] = {}
        self.dirty: set[str] = set()

    def _s(self, shard: str) -> dict:
        s = self._shards.get(shard)
        if s is None:
            s = self._shards[shard] = {f: 0 for f in self.FIELDS}
        self.dirty.add(shard)
        return s

    def record_request(self, shard: str) -> None:
        with self._lock:
            self._s(shard)["requests"] += 1

    def record_merge(
        self, shard: str, ctx: str, replaced: int,
        in_bytes: int, out_bytes: int,
    ) -> None:
        with self._lock:
            s = self._s(shard)
            if replaced:
                s[f"merges_{ctx}"] += 1
                s["input_bytes"] += in_bytes
                s["output_bytes"] += out_bytes
            else:
                s["merges_lost"] += 1

    def record_blob_write(self, shard: str, ctx: str, nbytes: int) -> None:
        with self._lock:
            self._s(shard)[f"blob_writes_{ctx}"] += 1

    def record_offpath(
        self, shard: str, seconds: float, lease_epoch: int
    ) -> None:
        with self._lock:
            s = self._s(shard)
            s["off_path_s"] += seconds
            s["lease_epoch"] = max(s["lease_epoch"], lease_epoch)

    def record_fenced(self, shard: str) -> None:
        with self._lock:
            self._s(shard)["fenced"] += 1

    def record_crash(self, shard: str) -> None:
        with self._lock:
            self._s(shard)["crashes"] += 1

    def rows(self) -> dict[str, dict]:
        with self._lock:
            return {sh: dict(s) for sh, s in self._shards.items()}

    def take_dirty(self) -> dict[str, dict]:
        """Rows changed since the last take (the Frontiers-piggyback
        shipping discipline: only deltas cross the CTP)."""
        with self._lock:
            out = {
                sh: dict(self._shards[sh])
                for sh in self.dirty
                if sh in self._shards
            }
            self.dirty.clear()
            return out

    def totals(self) -> dict:
        with self._lock:
            tot = {f: 0 for f in self.FIELDS}
            for s in self._shards.values():
                for f in self.FIELDS:
                    tot[f] = (
                        max(tot[f], s[f])
                        if f == "lease_epoch"
                        else tot[f] + s[f]
                    )
            return tot

    def reset(self) -> None:
        with self._lock:
            self._shards.clear()
            self.dirty.clear()


STATS = CompactionStats()


class CompactionService:
    """One worker thread draining a deduplicated per-shard request
    queue. ``request`` is the only thing the tick path calls — it never
    blocks on merge work. Multiple services (processes) may target the
    same shard; the lease serializes them and epoch fencing makes the
    loser harmless."""

    def __init__(
        self,
        holder: str | None = None,
        lease_s: float | None = None,
    ):
        self.holder = holder or f"compactor-{os.getpid()}-{id(self):x}"
        self._lease_s = lease_s
        self._cv = threading.Condition()
        self._queue: deque[Machine] = deque()
        self._queued: set[str] = set()
        self._busy = 0
        self._thread: threading.Thread | None = None
        self._stopped = False
        # Chaos hook: consume-once crash injection point, "merge" or
        # "renew" — the worker raises CompactorCrash there, leaving the
        # lease held (the durable residue of a SIGKILL at that write).
        self.crash_next: str | None = None

    # -- tick-path API -----------------------------------------------------
    def request(self, machine: Machine) -> bool:
        """Enqueue one shard for background compaction. O(1), never
        merges, never touches blob: the entire tick-path cost of
        compaction under compaction_mode=background."""
        STATS.record_request(machine.shard)
        with self._cv:
            if self._stopped or machine.shard in self._queued:
                return False
            self._queued.add(machine.shard)
            self._queue.append(machine)
            self._ensure_thread()
            self._cv.notify()
            return True

    # -- worker ------------------------------------------------------------
    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._loop, name="persist-compactor", daemon=True
            )
            self._thread.start()

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._stopped:
                    self._cv.wait(0.5)
                if self._stopped and not self._queue:
                    return
                machine = self._queue.popleft()
                self._queued.discard(machine.shard)
                self._busy += 1
            try:
                self.compact_shard(machine)
            except CompactorCrash:
                STATS.record_crash(machine.shard)
            except Exception:
                pass  # background duty: never take the process down
            finally:
                with self._cv:
                    self._busy -= 1
                    self._cv.notify_all()

    def _config(self):
        from ...utils.dyncfg import (
            ARRANGEMENT_COMPACTION_BATCHES,
            COMPACTION_LEASE_S,
            COMPUTE_CONFIGS,
        )

        lease = (
            self._lease_s
            if self._lease_s is not None
            else COMPACTION_LEASE_S(COMPUTE_CONFIGS)
        )
        return ARRANGEMENT_COMPACTION_BATCHES(COMPUTE_CONFIGS), lease

    def compact_shard(
        self, machine: Machine, max_batches: int | None = None
    ) -> dict:
        """One leased compaction attempt: acquire → merge → renew →
        fenced swap → publish → delete replaced parts → GC consensus →
        release. Returns a report dict (tests + chaos assertions)."""
        threshold, lease_s = self._config()
        if max_batches is None:
            max_batches = threshold
        t0 = _time.monotonic()
        lease = machine.acquire_compaction_lease(self.holder, lease_s)
        if lease is None:
            return {"skipped": "lease-held"}
        held_by_crash = False
        try:
            st = machine.reload()
            if len(st.batches) <= max_batches:
                return {"skipped": "below-threshold"}
            prefix = st.batches
            merged_key, n, old_keys = machine._merge_parts(
                st, ctx="background"
            )
            in_bytes, out_bytes = machine._last_merge_bytes
            if self.crash_next == "merge":
                self.crash_next = None
                held_by_crash = True
                raise CompactorCrash("injected crash after merge")
            # Renew before the durable swap: a lost lease means a
            # successor took over — abandon rather than fight it.
            if not machine.renew_compaction_lease(lease, lease_s):
                STATS.record_fenced(machine.shard)
                machine._delete_parts([merged_key] if n else [])
                return {"fenced": "renew"}
            if self.crash_next == "renew":
                self.crash_next = None
                held_by_crash = True
                raise CompactorCrash("injected crash after renew")
            try:
                replaced = machine.swap_compacted(
                    prefix, merged_key, n, out_bytes, epoch=lease
                )
            except CompactorFenced:
                STATS.record_fenced(machine.shard)
                machine._delete_parts([merged_key] if n else [])
                return {"fenced": "swap"}
            STATS.record_merge(
                machine.shard, "background", replaced, in_bytes, out_bytes
            )
            # Announce the swap: writers learn their request completed,
            # readers with in-flight fetches re-resolve parts via the
            # CompactionRace retry against the new state.
            PUBSUB.publish(
                machine.shard, machine.state.seqno, kind="compaction"
            )
            doomed = old_keys if replaced else ([merged_key] if n else [])
            machine._delete_parts(doomed)
            machine.gc_consensus()
            return {
                "replaced": replaced,
                "merged_key": merged_key,
                "lease_epoch": lease,
                "in_bytes": in_bytes,
                "out_bytes": out_bytes,
            }
        finally:
            STATS.record_offpath(
                machine.shard, _time.monotonic() - t0, lease
            )
            if not held_by_crash:
                machine.release_compaction_lease(lease)

    # -- lifecycle ---------------------------------------------------------
    def drain(self, timeout: float = 30.0) -> bool:
        """Block until the queue is empty and the worker idle (tests,
        gates, bench — never the tick path)."""
        deadline = _time.monotonic() + timeout
        with self._cv:
            while self._queue or self._busy:
                remaining = deadline - _time.monotonic()
                if remaining <= 0:
                    return False
                self._cv.wait(min(remaining, 0.1))
            return True

    def stop(self) -> None:
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=5.0)


_SERVICE: CompactionService | None = None
_SERVICE_LOCK = threading.Lock()


def compaction_service() -> CompactionService:
    """The process's shared background compactor (started lazily on the
    first request; daemon thread)."""
    global _SERVICE
    with _SERVICE_LOCK:
        if _SERVICE is None or _SERVICE._stopped:
            _SERVICE = CompactionService()
        return _SERVICE


def reset_compaction_service() -> None:
    """Stop the shared service (environment shutdown / test isolation)."""
    global _SERVICE
    with _SERVICE_LOCK:
        svc, _SERVICE = _SERVICE, None
    if svc is not None:
        svc.stop()
