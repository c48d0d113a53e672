"""Unified retry/timeout/backoff policy (the ore::retry analog).

One module owns every control-plane wait: the reconnect backoff, the
durability-layer retry, hydration build retries, install/frontier poll
loops, and peek budgets. Before the unified policies these were scattered ad-hoc
constants (``backoff = 0.05`` in the replica client, ``timeout=5.0``
socket connects, 30s install waits, 2–5ms poll sleeps); now each
*surface* resolves a :class:`RetryPolicy` through a dyncfg spec string,
so operators can retune a single surface at runtime::

    SET retry_policy_reconnect = 'base=10ms,max=500ms,mult=2,jitter=0.2'

A policy spec is ``key=value`` pairs separated by commas. Durations
accept ``ms``/``s`` suffixes (bare numbers are seconds):

    base    initial backoff                 (default 50ms)
    max     backoff ceiling                 (default 2s)
    mult    backoff multiplier              (default 2.0; 1 = fixed poll)
    jitter  +/- fraction of each sleep      (default 0.2)
    attempts  max attempts, 0 = unbounded   (default 0)
    budget    total wall-clock budget, 0 = unbounded (default 0).
              Surfaces that replaced a legacy hard cap treat 0 as
              that cap instead, never as an infinite wait: peek
              180s, install_wait/frontier_wait 30s, shutdown 5s.

Jitter is deterministic per :class:`RetryStream` when a seed is given
(the chaos harness replays fault schedules exactly); without a seed it
draws from a process-global PRNG, which breaks retry synchronization
between active-active replicas (the epoch ping-pong the jitter exists
to break).
"""

from __future__ import annotations

import random
import threading
import time as _time
from dataclasses import dataclass

from .dyncfg import COMPUTE_CONFIGS, Config


def _dur(s: str) -> float:
    s = s.strip().lower()
    if s.endswith("ms"):
        return float(s[:-2]) / 1000.0
    if s.endswith("s"):
        return float(s[:-1])
    return float(s)


@dataclass(frozen=True)
class RetryPolicy:
    """Backoff shape + budget for one retry surface."""

    base: float = 0.05
    max: float = 2.0
    mult: float = 2.0
    jitter: float = 0.2
    attempts: int = 0  # 0 = unbounded
    budget: float = 0.0  # seconds; 0 = unbounded

    _KEYS = frozenset(
        ("base", "max", "mult", "jitter", "attempts", "budget")
    )

    @classmethod
    def parse(cls, spec: str) -> "RetryPolicy":
        kv = {}
        for part in str(spec).split(","):
            part = part.strip()
            if not part:
                continue
            k, _, v = part.partition("=")
            kv[k.strip()] = v.strip()
        unknown = set(kv) - cls._KEYS
        if unknown:
            raise ValueError(
                f"unknown retry-policy key(s) {sorted(unknown)}; "
                f"valid: {sorted(cls._KEYS)}"
            )
        return cls(
            base=_dur(kv.get("base", "50ms")),
            max=_dur(kv.get("max", "2s")),
            mult=float(kv.get("mult", 2.0)),
            jitter=float(kv.get("jitter", 0.2)),
            attempts=int(kv.get("attempts", 0)),
            budget=_dur(kv.get("budget", "0")),
        )

    def stream(self, seed: int | None = None) -> "RetryStream":
        return RetryStream(self, seed=seed)

    def deadline(self, now: float | None = None) -> float:
        """Absolute monotonic deadline for this policy's budget
        (+inf when unbounded)."""
        if self.budget <= 0:
            return float("inf")
        return (_time.monotonic() if now is None else now) + self.budget

    def retry(self, f, retryable: tuple = (Exception,),
              seed: int | None = None):
        """Call ``f`` until it succeeds or the policy is exhausted;
        re-raises the last retryable error on exhaustion."""
        stream = self.stream(seed=seed)
        while True:
            try:
                return f()
            except retryable:
                if not stream.sleep():
                    raise


class RetryStream:
    """One retry sequence: tracks attempts, budget, and the jittered
    backoff. ``sleep()`` returns False when the policy is exhausted
    (the caller gives up); ``next_sleep()`` exposes the duration
    without sleeping for select-style waits."""

    def __init__(self, policy: RetryPolicy, seed: int | None = None):
        self.policy = policy
        self.attempt = 0
        self._backoff = policy.base
        self._deadline = policy.deadline()
        self._rng = random.Random(seed) if seed is not None else _RNG

    def expired(self) -> bool:
        if self.policy.attempts and self.attempt >= self.policy.attempts:
            return True
        return _time.monotonic() >= self._deadline

    def _jittered(self) -> float:
        d = self._backoff
        j = self.policy.jitter
        if j:
            d *= 1.0 + self._rng.uniform(-j, j)
        return d

    def next_sleep(self) -> float:
        remaining = self._deadline - _time.monotonic()
        return max(min(self._jittered(), remaining), 0.0)

    def next_sleep_unbounded(self) -> float:
        """Jittered backoff with attempts/budget IGNORED — for
        surfaces that must never give up (the reconnect loop keeps
        trying at the backoff ceiling forever; a 0.0 sleep from an
        expired budget would busy-spin it at full CPU)."""
        return max(self._jittered(), 0.0)

    def advance(self) -> None:
        self.attempt += 1
        self._backoff = min(
            self._backoff * self.policy.mult, self.policy.max
        )

    def sleep(self) -> bool:
        """One jittered backoff sleep. Returns False (without
        sleeping) when attempts or budget are exhausted."""
        self.advance()
        if self.expired():
            return False
        d = self.next_sleep()
        if d > 0:
            _time.sleep(d)
        return True

    def reset(self) -> None:
        """Back to the initial backoff (a successful session resets
        the reconnect stream)."""
        self.attempt = 0
        self._backoff = self.policy.base


class _SeededGlobal:
    """Process-global jitter source (thread-safe)."""

    def __init__(self):
        self._rng = random.Random()
        self._lock = threading.Lock()

    def uniform(self, a: float, b: float) -> float:
        with self._lock:
            return self._rng.uniform(a, b)


_RNG = _SeededGlobal()


# -- per-surface dyncfg specs -------------------------------------------------
#
# Each surface is ONE string config so SET/SHOW work on it whole. The
# defaults reproduce the constants they replaced (documented per
# surface) — consolidation first, retuning second.

RETRY_RECONNECT = Config(
    "retry_policy_reconnect",
    "base=50ms,max=2s,mult=2,jitter=0.2",
    "controller -> replica reconnect backoff (was the hardcoded "
    "0.05 -> 2.0 doubling loop in ReplicaClient)",
).register(COMPUTE_CONFIGS)

RETRY_DURABILITY = Config(
    "retry_policy_durability",
    "base=10ms,max=2s,mult=2,jitter=0.2,attempts=8",
    "blob/consensus transient-failure retry (was retry_external's "
    "8 attempts at 10ms doubling)",
).register(COMPUTE_CONFIGS)

RETRY_HYDRATION = Config(
    "retry_policy_hydration",
    "base=10ms,max=500ms,mult=2,jitter=0.2,attempts=5",
    "replica dataflow build/hydration retry against transient "
    "SinkConflict/Fenced/compaction races (was 5 attempts at 10ms)",
).register(COMPUTE_CONFIGS)

RETRY_INSTALL_WAIT = Config(
    "retry_policy_install_wait",
    "base=5ms,max=5ms,mult=1,jitter=0,budget=30s",
    "coordinator wait for a replica install ack (was a 5ms poll with "
    "a 30s budget)",
).register(COMPUTE_CONFIGS)

RETRY_FRONTIER_WAIT = Config(
    "retry_policy_frontier_wait",
    "base=5ms,max=5ms,mult=1,jitter=0,budget=30s",
    "controller frontier-advance poll (was a 5ms poll with a 30s "
    "default budget; explicit caller timeouts still override the "
    "budget)",
).register(COMPUTE_CONFIGS)

RETRY_PEEK = Config(
    "retry_policy_peek",
    "budget=180s",
    "peek/batched-gather response budget; on exhaustion the read is "
    "shed with the retryable ServerBusy signal (SQLSTATE 53400 / "
    "HTTP 503), never a generic error",
).register(COMPUTE_CONFIGS)

RETRY_SHUTDOWN = Config(
    "retry_policy_shutdown",
    "budget=5s",
    "per-replica graceful-exit budget before Environment.shutdown "
    "escalates terminate -> kill",
).register(COMPUTE_CONFIGS)

RETRY_FAILOVER = Config(
    "retry_policy_failover",
    "base=1s,max=1s,mult=1,jitter=0,attempts=3,budget=10s",
    "routed-read failover: `base` is the per-target stall "
    "budget before an unanswered routed peek re-dispatches to the "
    "next least-lagged candidate (disconnects re-dispatch "
    "immediately, not on this timer); `attempts` caps how many "
    "routed targets are tried before the terminal one-shot broadcast "
    "fallback; `budget` bounds drain_replica's wait for in-flight "
    "reads to move off a draining replica",
).register(COMPUTE_CONFIGS)

_SURFACES = {
    "reconnect": RETRY_RECONNECT,
    "durability": RETRY_DURABILITY,
    "hydration": RETRY_HYDRATION,
    "install_wait": RETRY_INSTALL_WAIT,
    "frontier_wait": RETRY_FRONTIER_WAIT,
    "peek": RETRY_PEEK,
    "shutdown": RETRY_SHUTDOWN,
    "failover": RETRY_FAILOVER,
}

_PARSE_CACHE: dict[str, RetryPolicy] = {}


def policy(surface: str) -> RetryPolicy:
    """The current policy for one surface, resolved through dyncfg
    (parse results memoized by spec string — the hot poll loops read
    this per wait, not per sleep). A malformed spec falls back to the
    surface's registered default: SET validates specs up front, but a
    bad record already in a durable catalog must degrade to defaults,
    not raise inside a reconnect daemon thread on every boot."""
    cfg = _SURFACES[surface]
    spec = str(cfg(COMPUTE_CONFIGS))
    got = _PARSE_CACHE.get(spec)
    if got is None:
        try:
            got = RetryPolicy.parse(spec)
        except ValueError:
            got = RetryPolicy.parse(cfg.default)
        _PARSE_CACHE[spec] = got
    return got


# -- recovery metrics ---------------------------------------------------------
#
# Counters every retry surface and the recovery paths feed; surfaced
# through /metrics, the mz_recovery introspection relation, and
# EXPLAIN ANALYSIS's `recovery:` block. Get-or-create: multiple
# controllers in one process (tests) share the process counters.

def _counter(name: str, help_: str):
    from .metrics import REGISTRY

    got = REGISTRY.get(name)
    if got is None:
        got = REGISTRY.counter(name, help_)
    return got


def _gauge(name: str, help_: str):
    from .metrics import REGISTRY

    got = REGISTRY.get(name)
    if got is None:
        got = REGISTRY.gauge(name, help_)
    return got


def reconnects_total():
    return _counter(
        "mz_controller_reconnects_total",
        "replica sessions re-established after a connection loss",
    )


def fenced_epochs_total():
    return _counter(
        "mz_fenced_epochs_total",
        "HelloReject responses observed (a newer controller owns the "
        "replica's epoch)",
    )


def recovery_seconds():
    return _gauge(
        "mz_recovery_seconds",
        "wall-clock seconds the last coordinator bootstrap spent "
        "replaying the durable catalog",
    )


def catalog_replayed_total():
    return _counter(
        "mz_catalog_replayed_total",
        "durable catalog records replayed across coordinator boots "
        "in this process",
    )
