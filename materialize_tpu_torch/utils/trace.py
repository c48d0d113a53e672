"""Tracing: per-statement trace trees across processes.

Analog of the reference's tracing stack (tracing + OpenTelemetry with
runtime-settable filters, SURVEY.md §5): spans record (trace_id,
span_id, parent_id, process, name, start, duration, attributes) into a
bounded per-process ring buffer queryable as the ``mz_trace_spans``
introspection relation; a dynamic level filter mirrors the
``log_filter`` system var (the ``trace_level`` dyncfg).

Cross-process propagation follows the reference's
OpenTelemetryContext-riding-commands pattern: the front end (pgwire /
HTTP) MINTS a trace_id per statement and opens the root span; the
coordinator and controller open child spans on the same thread
(thread-local context stack); CTP commands carry ``{"t": trace_id,
"s": span_id}`` so the replica can :meth:`Tracer.adopt` the remote
parent; and completed replica spans ship back PIGGYBACKED on Frontiers
responses (the verdict pattern — shipped only when present, so
steady state with tracing off pays nothing). The controller ingests
shipped spans into this process's tracer, so one ``mz_trace_spans``
query shows ONE coherent tree per statement across every process.

Span ids embed the process id (``(pid << 40) | counter``) so ids from
different processes never collide in a merged tree; ingest drops
records whose pid equals ours (an in-process replica shares this
tracer — its spans are already in the ring).

The recorder is pure host bookkeeping — no device reads, no syncs —
and is registered with the host-sync linter (analysis/host_sync.py) so
a d2h sync can never sneak into the hot recording path.
"""

from __future__ import annotations

import itertools
import os
import threading
import time as _time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field

LEVELS = {"off": 0, "error": 1, "info": 2, "debug": 3}

# Span-id layout: the low 40 bits count, the bits above carry the pid.
_PID_SHIFT = 40


@dataclass
class SpanRecord:
    span_id: int
    parent_id: int | None
    name: str
    start: float
    duration: float
    level: str
    attrs: dict = field(default_factory=dict)
    trace_id: int = 0  # 0 = recorded outside any statement trace
    process: str = ""  # "" = this process (filled on ingest)
    pid: int = 0

    def to_wire(self) -> tuple:
        """Compact tuple for the Frontiers piggyback (attrs must be
        plain scalars/strings — enforced at record time by usage)."""
        return (
            self.span_id, self.parent_id, self.name, self.start,
            self.duration, self.level, dict(self.attrs), self.trace_id,
            self.process, self.pid,
        )

    @classmethod
    def from_wire(cls, t: tuple) -> "SpanRecord":
        (sid, parent, name, start, dur, level, attrs, trace_id,
         process, pid) = t
        return cls(
            sid, parent, name, start, dur, level, attrs, trace_id,
            process, pid,
        )


class Tracer:
    """Per-process span recorder with cross-process context handoff."""

    def __init__(self, capacity: int = 4096, process: str = ""):
        self.process = process or f"pid{os.getpid()}"
        self._pid = os.getpid()
        self._base = (self._pid & 0x3FFFFF) << _PID_SHIFT
        self._ids = itertools.count(1)
        self._level = LEVELS["info"]
        self._local = threading.local()
        self._lock = threading.Lock()
        self._buf: deque[SpanRecord] = deque(maxlen=capacity)
        # Ingested remote spans (piggybacked off Frontiers) live in
        # their own ring: clear() of local spans keeps remote history
        # and vice versa is not needed.
        self._ingested: deque[SpanRecord] = deque(maxlen=capacity)
        # Ship queue: records pending piggyback to a controller.
        # Bounded — an unreported replica must not grow without bound.
        self._ship: deque[SpanRecord] | None = None

    # -- dynamic filter (log_filter / trace_level dyncfg analog) ------------
    def set_level(self, level: str) -> None:
        self._level = LEVELS[level]

    @property
    def level(self) -> str:
        for k, v in LEVELS.items():
            if v == self._level:
                return k
        return "info"

    def enabled(self, level: str = "info") -> bool:
        return LEVELS[level] <= self._level

    # -- id minting ----------------------------------------------------------
    def _next_id(self) -> int:
        if os.getpid() != self._pid:
            # Forked child (subprocess replicas exec fresh interpreters,
            # but be safe): re-base so ids stay collision-free.
            self._pid = os.getpid()
            self._base = (self._pid & 0x3FFFFF) << _PID_SHIFT
            self.process = f"pid{self._pid}"
        return self._base | next(self._ids)

    def new_trace(self) -> int:
        """Mint a fresh statement trace id."""
        return self._next_id()

    # -- thread-local context stack ------------------------------------------
    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = []
            self._local.stack = st
        return st

    def current_span(self) -> int | None:
        """For protocol propagation: ship this with commands."""
        st = self._stack()
        return st[-1][1] if st else None

    def current_trace(self) -> int:
        st = self._stack()
        return st[-1][0] if st else 0

    def context(self) -> dict | None:
        """The wire form of the current context (rides CTP commands),
        or None when no span is open on this thread."""
        st = self._stack()
        if not st:
            return None
        trace_id, span_id = st[-1]
        return {"t": trace_id, "s": span_id}

    # -- span API ------------------------------------------------------------
    @contextmanager
    def span(self, name: str, level: str = "info", root: bool = False,
             **attrs):
        """Open a child span of the current thread context (or a fresh
        ROOT span minting a new trace_id when ``root=True`` or no
        context is open and the caller asks for one). Yields the span
        id, or None when filtered by level."""
        if LEVELS[level] > self._level:
            yield None
            return
        st = self._stack()
        if root:
            trace_id, parent = self.new_trace(), None
        elif st:
            trace_id, parent = st[-1]
        else:
            trace_id, parent = 0, None  # untraced orphan span
        span_id = self._next_id()
        st.append((trace_id, span_id))
        start = _time.perf_counter()
        wall = _time.time()
        try:
            yield span_id
        finally:
            dur = _time.perf_counter() - start
            st.pop()
            self._append(
                SpanRecord(
                    span_id, parent, name, wall, dur, level, attrs,
                    trace_id, self.process, self._pid,
                )
            )

    @contextmanager
    def statement(self, name: str, **attrs):
        """The front-end entry point: mint a trace and open its root
        span (one per SQL statement — pgwire/HTTP drive this)."""
        with self.span(name, root=True, **attrs) as sid:
            yield sid

    def record(
        self,
        name: str,
        start: float,
        duration: float,
        level: str = "info",
        parent: int | None = None,
        **attrs,
    ) -> int | None:
        """Retroactive span record (the pipelined span commit knows its
        timings only after the boundary readback). Parent defaults to
        the current thread context. Pure host bookkeeping."""
        if LEVELS[level] > self._level:
            return None
        st = self._stack()
        trace_id = st[-1][0] if st else 0
        if parent is None and st:
            parent = st[-1][1]
        span_id = self._next_id()
        self._append(
            SpanRecord(
                span_id, parent, name, start, duration, level, attrs,
                trace_id, self.process, self._pid,
            )
        )
        return span_id

    def _append(self, rec: SpanRecord) -> None:
        with self._lock:
            self._buf.append(rec)
            if self._ship is not None:
                self._ship.append(rec)

    @contextmanager
    def adopt(self, ctx: dict | None):
        """Adopt a PROPAGATED remote context as this thread's parent
        (the replica side of command propagation). ``None`` is a
        no-op pass-through."""
        if not ctx:
            yield
            return
        st = self._stack()
        st.append((int(ctx.get("t") or 0), int(ctx.get("s") or 0)))
        try:
            yield
        finally:
            st.pop()

    @contextmanager
    def remote_parent(self, parent_id: int | None):
        """Back-compat adoption by bare span id (no trace id)."""
        with self.adopt(
            None if parent_id is None else {"t": 0, "s": parent_id}
        ):
            yield

    # -- cross-process shipping (Frontiers piggyback) ------------------------
    def enable_ship(self, capacity: int = 4096) -> None:
        """Start queueing completed spans for piggyback (replica side)."""
        with self._lock:
            if self._ship is None:
                self._ship = deque(maxlen=capacity)

    def drain_shippable(self) -> list[tuple]:
        """Completed spans pending piggyback, as wire tuples (empty
        when shipping is off or nothing happened — the common case)."""
        if self._ship is None or not self._ship:
            return []
        with self._lock:
            out = [r.to_wire() for r in self._ship]
            self._ship.clear()
        return out

    def ingest(self, wire_records: list, process: str = "") -> None:
        """Absorb piggybacked spans from another process. Records from
        OUR pid are dropped (an in-process replica shares this tracer;
        its spans already sit in the local ring)."""
        me = os.getpid()
        with self._lock:
            for t in wire_records:
                rec = SpanRecord.from_wire(t)
                if rec.pid == me:
                    continue
                if process and (
                    not rec.process or rec.process.startswith("pid")
                ):
                    rec.process = process
                self._ingested.append(rec)

    # -- introspection --------------------------------------------------------
    def records(self, name_prefix: str = "") -> list[SpanRecord]:
        with self._lock:
            if not name_prefix:
                # list(deque) runs at C speed — keeps the critical
                # section short under writer pressure.
                return list(self._buf) + list(self._ingested)
            out = [
                r for r in self._buf if r.name.startswith(name_prefix)
            ]
            out.extend(
                r
                for r in self._ingested
                if r.name.startswith(name_prefix)
            )
        return out

    def trace_tree(self, trace_id: int) -> list[SpanRecord]:
        """All spans of one statement trace, roots first."""
        recs = [r for r in self.records() if r.trace_id == trace_id]
        recs.sort(key=lambda r: (r.parent_id is not None, r.start))
        return recs

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self._ingested.clear()
            if self._ship is not None:
                self._ship.clear()


TRACER = Tracer()
