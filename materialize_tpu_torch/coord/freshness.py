"""Freshness plane: wallclock lag histories and data-plane statuses.

An IVM platform's core observable is not statement latency but
*freshness*: how far each maintained view's committed frontier trails
the wallclock. Timestamps here are virtual ticks (the source tick
counter IS the timestamp), so the honest, measurable lag definition is

    wallclock_lag_ms = (span-commit wallclock)
                     - (arrival wallclock of the newest input tick
                        covered by the committed span)

— the maintenance delay the view adds on top of ingest, measured on
one clock (``time.monotonic``). :func:`lag_ms` is THE definition;
every lag number in the system (span commits in
``storage/persist/operators.py`` and ``render/span_exec.py``, SUBSCRIBE
delivery lag in ``coord/subscribe.py``) routes through it — one
definition, one clock.

The :class:`FreshnessRecorder` mirrors the tracer's shape
(``utils/trace.py``): a bounded process-global ring, a ship queue for
the Frontiers piggyback (subprocess replicas), and pid-deduped ingest
on the controller side (in-process replicas share the ring, so their
shipped records are dropped instead of double-counted). Recording is
pure host bookkeeping: it reads no tensor, so it never waits on the
device on the span hot path.

Surfaces: ``mz_wallclock_lag_history`` / ``mz_wallclock_lag_summary``
(windowed quantile rollup), ``mz_freshness_events`` (SLO breaches and
hydration stalls, the ``freshness_slo_ms`` dyncfg),
``mz_wallclock_lag_seconds`` + ``mz_freshness_breaches_total`` in
``/metrics``, the ``/api/readyz`` probe, EXPLAIN ANALYSIS's
``freshness:`` block, and ``controller.least_lagged_replica`` (the
signal ROADMAP item 5's peek routing consumes).

:class:`StatusBoard` is the per-(dataflow, replica) hydration status
machine (pending -> hydrating -> hydrated -> stalled, with timestamps,
attempt counts, and last error) the controller maintains from replica
reports and its own install-wait deadline — ``mz_hydration_statuses``
and the readiness probe read it.
"""

from __future__ import annotations

import os
import time as _time
from collections import deque
from dataclasses import dataclass

from ..utils import lockcheck as _lockcheck
from ..utils.locks import tracked_lock

# Bounded rings: the history holds the newest HISTORY_CAPACITY commit
# observations process-wide; each (dataflow, replica) keeps a
# WINDOW_PER_KEY-sample quantile window. Memory never grows with the
# number of spans processed (asserted under churn in
# tests/test_freshness.py).
HISTORY_CAPACITY = 4096
WINDOW_PER_KEY = 512
EVENTS_CAPACITY = 256

# "swapping": an async-compiled dataflow is mid hot-swap —
# the generic merge-mode program served until a span boundary, and the
# specialized rebuild is hydrating from durable shards. Readiness
# probes treat it like hydrating (health() also accepts frontier > 0,
# so a swap never flips a serving dataflow unready).
HYDRATION_STATUSES = (
    "pending", "hydrating", "hydrated", "stalled", "swapping"
)


def lag_ms(since: float, now: float | None = None) -> float:
    """THE lag definition: milliseconds elapsed on the monotonic clock
    since ``since``, clamped at zero. Every lag number in the system
    (span-commit maintenance lag, SUBSCRIBE delivery lag) is computed
    by this function — one definition, one clock."""
    if now is None:
        now = _time.monotonic()
    return max((now - since) * 1000.0, 0.0)


def quantile(sorted_vals, q: float) -> float:
    """Nearest-rank quantile over an ascending-sorted sequence (the
    rollup's pinned semantics, recomputed brute-force in tests):
    empty -> 0.0, q<=0 -> first, q>=1 -> last."""
    n = len(sorted_vals)
    if n == 0:
        return 0.0
    if q <= 0.0:
        return float(sorted_vals[0])
    if q >= 1.0:
        return float(sorted_vals[-1])
    import math

    return float(sorted_vals[min(n - 1, math.ceil(q * n) - 1)])


@dataclass
class LagRecord:
    """One committed-span-boundary observation."""

    dataflow: str
    replica: str
    frontier: int
    lag_ms: float
    at: float  # wallclock (epoch seconds) of the commit
    pid: int = 0

    def to_wire(self) -> tuple:
        return (
            self.dataflow, self.replica, self.frontier,
            self.lag_ms, self.at, self.pid,
        )

    @classmethod
    def from_wire(cls, t) -> "LagRecord":
        return cls(
            str(t[0]), str(t[1]), int(t[2]), float(t[3]),
            float(t[4]), int(t[5]),
        )


# -- lazy metric families (the subscribe.py pattern: registration on
# first observation, not import) -------------------------------------------
_LAG_HIST = None
_BREACH_COUNTER = None
_STALL_COUNTER = None


def _lag_hist():
    global _LAG_HIST
    if _LAG_HIST is None:
        from ..utils.metrics import REGISTRY

        _LAG_HIST = REGISTRY.get_or_create(
            "histogram", "mz_wallclock_lag_seconds",
            "wallclock lag of committed span boundaries (seconds)",
        )
    return _LAG_HIST


def breaches_total():
    global _BREACH_COUNTER
    if _BREACH_COUNTER is None:
        from ..utils.metrics import REGISTRY

        _BREACH_COUNTER = REGISTRY.get_or_create(
            "counter", "mz_freshness_breaches_total",
            "lag observations exceeding the freshness_slo_ms SLO",
        )
    return _BREACH_COUNTER


def hydration_stalls_total():
    global _STALL_COUNTER
    if _STALL_COUNTER is None:
        from ..utils.metrics import REGISTRY

        _STALL_COUNTER = REGISTRY.get_or_create(
            "counter", "mz_hydration_stalls_total",
            "dataflow hydrations that exceeded the install-wait budget",
        )
    return _STALL_COUNTER


def _slo_ms() -> float:
    from ..utils.dyncfg import COMPUTE_CONFIGS, FRESHNESS_SLO_MS

    try:
        return float(FRESHNESS_SLO_MS(COMPUTE_CONFIGS))
    except (TypeError, ValueError):
        return 0.0


class FreshnessRecorder:
    """Process-global lag recorder: bounded history ring, per-key
    quantile windows, SLO breach events, and the ship/ingest pair for
    the Frontiers piggyback (pid-deduped, like the tracer)."""

    def __init__(self, capacity: int = HISTORY_CAPACITY):
        self._lock = tracked_lock("freshness.recorder")
        self._buf: deque = deque(maxlen=capacity)
        # (dataflow, replica) -> bounded deque of lag_ms samples.
        self._windows: dict = {}
        # (dataflow, replica) -> (frontier, lag_ms, at).
        self._latest: dict = {}
        self._events: deque = deque(maxlen=EVENTS_CAPACITY)
        self._in_breach: set = set()
        self._ship: deque | None = None

    # -- recording (the span hot path: pure host bookkeeping) ---------------
    def record(
        self,
        dataflow: str,
        replica: str,
        frontier: int,
        lag: float,
        at: float | None = None,
    ) -> None:
        """One committed span boundary: (dataflow, replica, frontier,
        wallclock_lag_ms). Host-only work — deque appends, a histogram
        bucket walk, and the SLO comparison."""
        if at is None:
            at = _time.time()
        rec = LagRecord(
            dataflow, replica, int(frontier), float(lag), at,
            os.getpid(),
        )
        with self._lock:
            _lockcheck.shared_write("freshness.lag_rings")
            self._buf.append(rec)
            key = (dataflow, replica)
            win = self._windows.get(key)
            if win is None:
                win = self._windows[key] = deque(maxlen=WINDOW_PER_KEY)
            win.append(rec.lag_ms)
            self._latest[key] = (rec.frontier, rec.lag_ms, rec.at)
            if self._ship is not None:
                self._ship.append(rec)
        _lag_hist().observe(rec.lag_ms / 1000.0)
        self._check_slo(rec)

    def _check_slo(self, rec: LagRecord) -> None:
        """The freshness_slo_ms dyncfg (0 disables): every breached
        sample counts in mz_freshness_breaches_total; breach ONSETS
        (first breached sample after a healthy one) append to the
        bounded mz_freshness_events ring."""
        slo = _slo_ms()
        key = (rec.dataflow, rec.replica)
        if slo <= 0.0:
            with self._lock:
                self._in_breach.discard(key)
            return
        if rec.lag_ms > slo:
            breaches_total().inc()
            with self._lock:
                onset = key not in self._in_breach
                self._in_breach.add(key)
                if onset:
                    self._events.append(
                        (rec.dataflow, rec.replica, "slo_breach",
                         rec.lag_ms, rec.at)
                    )
        else:
            with self._lock:
                self._in_breach.discard(key)

    def record_event(
        self,
        obj: str,
        replica: str,
        kind: str,
        lag: float = 0.0,
        at: float | None = None,
    ) -> None:
        """A non-lag freshness event (hydration stall, ...)."""
        if at is None:
            at = _time.time()
        with self._lock:
            _lockcheck.shared_write("freshness.lag_rings")
            self._events.append((obj, replica, kind, float(lag), at))

    # -- ship / ingest (the Frontiers piggyback) ----------------------------
    def enable_ship(self, capacity: int = 4096) -> None:
        with self._lock:
            if self._ship is None:
                self._ship = deque(maxlen=capacity)

    def drain_shippable(self) -> list:
        with self._lock:
            _lockcheck.shared_write("freshness.lag_rings")
            if not self._ship:
                return []
            out, self._ship = list(self._ship), deque(
                maxlen=self._ship.maxlen
            )
        return [r.to_wire() for r in out]

    def ingest(self, wire_records, process: str = "") -> None:
        """Merge shipped records from another process. Records from
        THIS pid are dropped (an in-process replica shares the ring;
        its records are already here)."""
        me = os.getpid()
        for w in wire_records:
            rec = LagRecord.from_wire(w)
            if rec.pid == me:
                continue
            with self._lock:
                _lockcheck.shared_write("freshness.lag_rings")
                self._buf.append(rec)
                key = (rec.dataflow, rec.replica)
                win = self._windows.get(key)
                if win is None:
                    win = self._windows[key] = deque(
                        maxlen=WINDOW_PER_KEY
                    )
                win.append(rec.lag_ms)
                latest = self._latest.get(key)
                if latest is None or rec.at >= latest[2]:
                    self._latest[key] = (
                        rec.frontier, rec.lag_ms, rec.at
                    )
            _lag_hist().observe(rec.lag_ms / 1000.0)
            self._check_slo(rec)

    # -- read surfaces ------------------------------------------------------
    def history_rows(self) -> list:
        """Newest-last (dataflow, replica, frontier, lag_ms, at)."""
        with self._lock:
            _lockcheck.shared_read("freshness.lag_rings")
            return [
                (r.dataflow, r.replica, r.frontier, r.lag_ms, r.at)
                for r in self._buf
            ]

    def summary(self) -> dict:
        """(dataflow, replica) -> windowed quantile rollup. Quantiles
        are nearest-rank over the per-key window (pinned semantics:
        :func:`quantile`)."""
        with self._lock:
            _lockcheck.shared_read("freshness.lag_rings")
            windows = {k: list(v) for k, v in self._windows.items()}
            latest = dict(self._latest)
        out = {}
        for key, vals in windows.items():
            svals = sorted(vals)
            frontier, last, at = latest.get(key, (0, 0.0, 0.0))
            out[key] = {
                "samples": len(svals),
                "p50_ms": quantile(svals, 0.50),
                "p90_ms": quantile(svals, 0.90),
                "p99_ms": quantile(svals, 0.99),
                "max_ms": float(svals[-1]) if svals else 0.0,
                "last_ms": last,
                "frontier": frontier,
                "at": at,
            }
        return out

    def latest(self, dataflow: str) -> dict:
        """replica -> (frontier, lag_ms, at) for one dataflow."""
        with self._lock:
            _lockcheck.shared_read("freshness.lag_rings")
            return {
                r: v
                for (df, r), v in self._latest.items()
                if df == dataflow
            }

    def events_rows(self) -> list:
        """Newest-last (object, replica, kind, lag_ms, at)."""
        with self._lock:
            _lockcheck.shared_read("freshness.lag_rings")
            return list(self._events)

    def breaching(self) -> set:
        """The (dataflow, replica) keys currently IN breach — past
        onset, not yet recovered. The autoscaler's scale-up signal
        (coord/autoscaler.py): a sustained non-empty set means the
        deployment is not keeping its freshness_slo_ms."""
        with self._lock:
            _lockcheck.shared_read("freshness.lag_rings")
            return set(self._in_breach)

    def forget(self, dataflow: str) -> None:
        """Drop per-key state for a dropped dataflow (the bounded
        history ring ages its records out naturally)."""
        with self._lock:
            for key in [k for k in self._windows if k[0] == dataflow]:
                self._windows.pop(key, None)
                self._latest.pop(key, None)
                self._in_breach.discard(key)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self._windows.clear()
            self._latest.clear()
            self._events.clear()
            self._in_breach.clear()
            if self._ship is not None:
                self._ship.clear()


FRESHNESS = FreshnessRecorder()


def status_entry(
    status: str,
    attempts: int = 0,
    error: str = "",
    at: float | None = None,
) -> dict:
    assert status in HYDRATION_STATUSES, status
    return {
        "status": status,
        "at": at if at is not None else _time.time(),
        "attempts": int(attempts),
        "error": str(error or ""),
    }


class StatusBoard:
    """Keyed status machine with bounded transition history: the
    controller's (dataflow, replica) hydration board. Thread-safe on
    its own lock so the absorber thread, wait_installed, and
    introspection snapshots never contend on controller._lock."""

    def __init__(self, history: int = 16):
        self._lock = tracked_lock("freshness.status_board")
        self._entries: dict = {}
        self._history_len = history

    def seed(self, key, status: str = "pending") -> None:
        """Install-time seeding: only writes when the key is absent or
        a NEW install supersedes a terminal state (a re-created
        dataflow starts pending again)."""
        with self._lock:
            if key not in self._entries:
                e = status_entry(status)
                e["history"] = deque(
                    [(status, e["at"])], maxlen=self._history_len
                )
                self._entries[key] = e

    def transition(
        self,
        key,
        status: str,
        attempts: int | None = None,
        error: str | None = None,
        at: float | None = None,
    ) -> None:
        e = status_entry(
            status,
            attempts=attempts if attempts is not None else 0,
            error=error or "",
            at=at,
        )
        with self._lock:
            prev = self._entries.get(key)
            if prev is not None:
                if attempts is None:
                    e["attempts"] = prev["attempts"]
                if error is None:
                    e["error"] = prev["error"]
                hist = prev["history"]
            else:
                hist = deque(maxlen=self._history_len)
            if not hist or hist[-1][0] != status:
                hist.append((status, e["at"]))
            e["history"] = hist
            self._entries[key] = e

    def apply(self, key, entry: dict) -> None:
        """Absorb a replica-reported entry verbatim (the replica's
        clock/attempts/error are authoritative for its own builds)."""
        self.transition(
            key,
            entry.get("status", "pending"),
            attempts=int(entry.get("attempts", 0)),
            error=str(entry.get("error", "")),
            at=float(entry.get("at", 0.0)) or None,
        )

    def get(self, key) -> dict | None:
        with self._lock:
            e = self._entries.get(key)
            return None if e is None else dict(e)

    def status(self, key) -> str | None:
        with self._lock:
            e = self._entries.get(key)
            return None if e is None else e["status"]

    def rows(self) -> list:
        """(key..., status, since, attempts, error) sorted by key."""
        with self._lock:
            items = sorted(self._entries.items())
        return [
            (
                key, e["status"], e["at"], e["attempts"], e["error"],
                list(e["history"]),
            )
            for key, e in items
        ]

    def forget_dataflow(self, dataflow: str) -> None:
        with self._lock:
            for key in [
                k for k in self._entries if k[0] == dataflow
            ]:
                self._entries.pop(key, None)

    def forget_replica(self, replica: str) -> None:
        with self._lock:
            for key in [
                k for k in self._entries if k[1] == replica
            ]:
                self._entries.pop(key, None)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
