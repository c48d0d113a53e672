"""Compile ledger: every native build or load becomes a record (the
port's copy of ``materialize_tpu/utils/compile_ledger.py``).

The reference records every XLA compile of its jitted programs. Eager
torch compiles no program per dataflow: its kernels are prebuilt, and
the port has no per-dataflow program to record until it captures CUDA
graphs (ROADMAP Queue 2 item 6). What the port does compile is its
native libraries, each built at first use in a process:

- ``csrc/merge_path.cu`` by ``nvcc`` (``ops/merge_kernel.py:build``);
- ``native/mtnative.cpp`` by ``g++`` (``native/__init__.py:lib``).

Each build or load records ``(kind, library name, source fingerprint,
flags, seconds, cache)`` into a bounded per-process ring, where
``cache`` is ``miss`` when the library was built in this call and
``hit`` when an earlier build under ``_build/`` (same source and flags)
was loaded.

Replica processes piggyback their records on Frontiers responses; the
controller ingests them, deduplicating by pid so in-process replicas
(which share this ledger) never double-report. Surfaces: the
``mz_compile_log`` introspection relation and the ``mz_compile_*``
/metrics families.
"""

from __future__ import annotations

import hashlib
import os
import time as _time
from collections import deque
from dataclasses import dataclass, field

from . import lockcheck


@dataclass
class CompileRecord:
    kind: str  # nvcc | g++
    name: str  # the library built or loaded
    fingerprint: str  # digest of the library's source and flags
    tier: str  # the build's flags (the reference's tier vector)
    seconds: float
    # "miss" (built by this call) | "hit" (an earlier build loaded)
    cache: str
    when: float = 0.0  # wall-clock stamp
    pid: int = 0
    process: str = ""
    attrs: dict = field(default_factory=dict)

    def to_wire(self) -> tuple:
        return (
            self.kind, self.name, self.fingerprint, self.tier,
            self.seconds, self.cache, self.when, self.pid,
            self.process, dict(self.attrs),
        )

    @classmethod
    def from_wire(cls, t: tuple) -> "CompileRecord":
        return cls(*t[:9], attrs=t[9])


class CompileLedger:
    # Hit/miss memory: one entry per distinct (kind, fingerprint, tier)
    # recorded, bounded (oldest keys evict first).
    SEEN_CAP = 32768

    def __init__(self, capacity: int = 4096):
        from .lockcheck import tracked_lock

        self._lock = tracked_lock("compile.ledger")
        self._buf: deque[CompileRecord] = deque(maxlen=capacity)
        self._ingested: deque[CompileRecord] = deque(maxlen=capacity)
        self._seen: dict = {}  # insertion-ordered: FIFO eviction
        self._ship: deque | None = None
        self._metrics = None

    def _metric_handles(self):
        if self._metrics is None:
            from .metrics import REGISTRY

            self._metrics = (
                REGISTRY.get_or_create(
                    "counter", "mz_compile_total",
                    "native library builds and loads observed by the "
                    "ledger",
                ),
                REGISTRY.get_or_create(
                    "counter", "mz_compile_misses_total",
                    "native library builds (no earlier build to load)",
                ),
                REGISTRY.get_or_create(
                    "counter", "mz_compile_hits_total",
                    "native library loads of an earlier build",
                ),
                REGISTRY.get_or_create(
                    "histogram", "mz_compile_seconds",
                    "wall seconds per observed build or load",
                    buckets=(
                        0.01, 0.05, 0.1, 0.5, 1, 5, 10, 30, 60, 120,
                        300,
                    ),
                ),
            )
        return self._metrics

    # -- recording ------------------------------------------------------------
    def record(
        self,
        kind: str,
        name: str,
        fingerprint: str,
        tier: str,
        seconds: float,
        cache: str | None = None,
        **attrs,
    ) -> CompileRecord:
        key = (kind, fingerprint, tier)
        with self._lock:
            lockcheck.shared_write("compile_ledger.seen")
            if cache is None:
                cache = "hit" if key in self._seen else "miss"
            self._seen[key] = True
            while len(self._seen) > self.SEEN_CAP:
                self._seen.pop(next(iter(self._seen)))
            rec = CompileRecord(
                kind, name, fingerprint, tier, seconds, cache,
                when=_time.time(), pid=os.getpid(),
                process=f"pid{os.getpid()}", attrs=attrs,
            )
            self._buf.append(rec)
            if self._ship is not None:
                self._ship.append(rec)
        total, misses, hits, hist = self._metric_handles()
        total.inc()
        (misses if cache == "miss" else hits).inc()
        hist.observe(seconds)
        return rec

    # -- cross-process shipping (Frontiers piggyback) ------------------------
    def enable_ship(self, capacity: int = 4096) -> None:
        with self._lock:
            if self._ship is None:
                self._ship = deque(maxlen=capacity)
                # Builds that happened before shipping was on (the
                # replica's boot) ship too.
                self._ship.extend(self._buf)

    def drain_shippable(self) -> list[tuple]:
        if self._ship is None or not self._ship:
            return []
        with self._lock:
            out = [r.to_wire() for r in self._ship]
            self._ship.clear()
        return out

    def ingest(self, wire_records: list, process: str = "") -> None:
        me = os.getpid()
        with self._lock:
            for t in wire_records:
                rec = CompileRecord.from_wire(t)
                if rec.pid == me:
                    continue  # in-process replica: already in _buf
                if process:
                    rec.process = process
                self._ingested.append(rec)

    # -- introspection --------------------------------------------------------
    def records(self) -> list[CompileRecord]:
        with self._lock:
            return list(self._buf) + list(self._ingested)

    def summary(self, names: set | None = None) -> dict:
        """Totals, optionally scoped to library ``names``."""
        recs = self.records()
        if names is not None:
            recs = [r for r in recs if r.name in names]
        out = {
            "compiles": len(recs),
            "misses": sum(1 for r in recs if r.cache == "miss"),
            "hits": sum(1 for r in recs if r.cache == "hit"),
            "seconds": round(sum(r.seconds for r in recs), 3),
            "hit_seconds": round(
                sum(r.seconds for r in recs if r.cache == "hit"), 3
            ),
            "by_kind": {},
        }
        for r in recs:
            k = out["by_kind"].setdefault(
                r.kind, {"compiles": 0, "seconds": 0.0}
            )
            k["compiles"] += 1
            k["seconds"] = round(k["seconds"] + r.seconds, 3)
        return out

    def clear(self) -> None:
        with self._lock:
            lockcheck.shared_write("compile_ledger.seen")
            self._buf.clear()
            self._ingested.clear()
            self._seen.clear()
            if self._ship is not None:
                self._ship.clear()


LEDGER = CompileLedger()


def source_fingerprint(source: bytes, flags: list) -> str:
    """The digest that names a native library's build: its source and
    compiler flags (the ``_build/`` file name carries the same digest)."""
    return hashlib.sha256(source + " ".join(flags).encode()).hexdigest()[:16]


def expr_fingerprint(obj) -> str:
    """Stable short fingerprint of an expression (pickled MIR)."""
    import pickle

    try:
        payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    except Exception:
        payload = repr(obj).encode()
    return hashlib.blake2b(payload, digest_size=8).hexdigest()
