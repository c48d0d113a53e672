"""Freshness plane, the part the serving path needs: the hydration status
machine.

:class:`StatusBoard` is the per-(dataflow, replica) hydration status
machine (pending -> hydrating -> hydrated -> stalled, with timestamps,
attempt counts, and last error) the controller maintains from replica
reports and its own install-wait deadline; the DDL path waits on it.

The rest of the reference's freshness plane (the lag recorder and its
histories, SLO breach events, ``mz_wallclock_lag_*``, readiness probes)
waits for ROADMAP Queue 1 item 6b; until then the port records no lag
and routes reads without lag data.
"""

from __future__ import annotations

import time as _time
from collections import deque

from ..utils.locks import tracked_lock

HYDRATION_STATUSES = (
    "pending", "hydrating", "hydrated", "stalled", "swapping"
)


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
