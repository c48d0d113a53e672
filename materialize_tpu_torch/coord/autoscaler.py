"""SLO-driven replica autoscaler: the freshness plane's
control loop.

Closes the loop nothing consumed before: the freshness recorder
(coord/freshness.py) already measures per-(dataflow, replica) wallclock
lag against ``freshness_slo_ms`` and tracks which keys are IN breach;
this module turns a *sustained* breach into a spawned replica (which
hydrates from the durable shards and becomes a routing
candidate once the hydration board flips) and sustained lag *headroom*
(every key's latest lag under ``headroom * slo``) into a drain of the
most-lagged replica — within a ``min``/``max`` band, with cooldown
hysteresis so an oscillating workload cannot flap the fleet.

The policy is ONE dyncfg spec string (``autoscale_policy``, retry-policy
style) so SET/SHOW work on it whole; empty disables. Every decision —
taken or held — is explainable: actions append to the process-global
:data:`AUTOSCALE` ledger (the ``mz_autoscale_events`` relation) with
the triggering evidence inline, and holds (band edge, cooldown) are
counted.

The scaler itself is mechanism-free: it ranks and decides, while the
actual spawn/drain callables come from whoever owns replica processes
(server/environmentd.py wires ``Environment.add_replica`` /
``Environment.drop_replica``). ``step(now)`` is the whole brain and
takes an explicit clock so tests drive oscillating-load fixtures
deterministically without threads.
"""

from __future__ import annotations

import threading
import time as _time
from dataclasses import dataclass

from collections import deque

from ..utils import lockcheck as _lockcheck
from ..utils.locks import tracked_lock
from ..utils.retry import _dur

LEDGER_CAPACITY = 256


# -- /metrics (lazy registration: module may be imported many times) ---------


def _counter(name: str, help_: str):
    from ..utils.metrics import REGISTRY

    got = REGISTRY.get(name)
    if got is None:
        got = REGISTRY.counter(name, help_)
    return got


def spawns_total():
    return _counter(
        "mz_autoscale_spawns_total",
        "replicas spawned by the autoscaler (sustained SLO breach)",
    )


def drains_total():
    return _counter(
        "mz_autoscale_drains_total",
        "replicas drained by the autoscaler (sustained lag headroom)",
    )


def holds_total():
    return _counter(
        "mz_autoscale_holds_total",
        "autoscale decisions suppressed at the band edge or inside "
        "the cooldown window (the hysteresis at work)",
    )


@dataclass(frozen=True)
class AutoscalePolicy:
    """Parsed ``autoscale_policy`` spec: the replica band, the sustain
    windows that separate signal from noise, and the cooldown that
    separates consecutive actions."""

    min_replicas: int = 1
    max_replicas: int = 3
    up_sustain: float = 2.0  # seconds of continuous breach -> spawn
    down_sustain: float = 10.0  # seconds of headroom -> drain
    cooldown: float = 5.0  # seconds between any two actions
    headroom: float = 0.25  # "idle" = every latest lag <= headroom*slo
    interval: float = 0.25  # evaluation cadence

    _KEYS = frozenset(
        (
            "min", "max", "up_sustain", "down_sustain", "cooldown",
            "headroom", "interval",
        )
    )

    @classmethod
    def parse(cls, spec: str) -> "AutoscalePolicy | None":
        """None for the empty spec (autoscaling disabled); raises
        ValueError on malformed input (SET validates up front)."""
        spec = str(spec).strip()
        if not spec:
            return None
        kv = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            k, _, v = part.partition("=")
            kv[k.strip()] = v.strip()
        unknown = set(kv) - cls._KEYS
        if unknown:
            raise ValueError(
                f"unknown autoscale-policy key(s) {sorted(unknown)}; "
                f"valid: {sorted(cls._KEYS)}"
            )
        pol = cls(
            min_replicas=int(kv.get("min", 1)),
            max_replicas=int(kv.get("max", 3)),
            up_sustain=_dur(kv.get("up_sustain", "2s")),
            down_sustain=_dur(kv.get("down_sustain", "10s")),
            cooldown=_dur(kv.get("cooldown", "5s")),
            headroom=float(kv.get("headroom", 0.25)),
            interval=_dur(kv.get("interval", "250ms")),
        )
        if pol.min_replicas < 1:
            raise ValueError("autoscale min must be >= 1")
        if pol.max_replicas < pol.min_replicas:
            raise ValueError("autoscale max must be >= min")
        if not (0.0 < pol.headroom <= 1.0):
            raise ValueError("autoscale headroom must be in (0, 1]")
        return pol


class AutoscaleLedger:
    """Process-global bounded decision ring: every scale action with
    its triggering evidence, newest-last — the ``mz_autoscale_events``
    relation's source. Like the freshness recorder, process-global so
    a bare Coordinator (no Environment) still serves the relation."""

    def __init__(self, capacity: int = LEDGER_CAPACITY):
        self._lock = tracked_lock("autoscale.ledger")
        self._events: deque = deque(maxlen=capacity)

    def record(
        self,
        action: str,
        replica: str,
        reason: str,
        evidence: dict,
        at: float | None = None,
    ) -> None:
        if at is None:
            at = _time.time()
        ev = ";".join(
            f"{k}={evidence[k]}" for k in sorted(evidence)
        )
        with self._lock:
            _lockcheck.shared_write("autoscale.events")
            self._events.append(
                (float(at), str(action), str(replica), str(reason), ev)
            )

    def rows(self) -> list:
        """Newest-last (at, action, replica, reason, evidence)."""
        with self._lock:
            _lockcheck.shared_read("autoscale.events")
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            _lockcheck.shared_write("autoscale.events")
            self._events.clear()


AUTOSCALE = AutoscaleLedger()


class Autoscaler:
    """The policy thread: evaluate -> (maybe) act, forever.

    ``spawn_fn() -> replica_name`` and ``drain_fn(replica_name)`` are
    the mechanism (Environment.add_replica / drop_replica, which
    serialize under the environment's scale lock against rolling
    restarts — the interleave model ``autoscale-vs-restart`` pins why).
    The policy is re-read from dyncfg every tick, so ``SET
    autoscale_policy`` enables/retunes/disables a live deployment."""

    def __init__(self, controller, spawn_fn, drain_fn):
        self.controller = controller
        self._spawn = spawn_fn
        self._drain = drain_fn
        self._up_since: float | None = None
        self._down_since: float | None = None
        self._last_action_at: float | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.stats = {"ticks": 0, "spawns": 0, "drains": 0, "holds": 0}

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "Autoscaler":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="autoscaler"
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()

    def _loop(self) -> None:
        while not self._stop.is_set():
            pol = self.policy()
            try:
                self.step()
            except Exception:
                # A failed spawn/drain (process limits, a chaos fault)
                # must not kill the policy thread; the next tick
                # re-evaluates from live state.
                pass
            self._stop.wait(pol.interval if pol else 0.25)

    def policy(self) -> AutoscalePolicy | None:
        from ..utils.dyncfg import AUTOSCALE_POLICY, COMPUTE_CONFIGS

        try:
            return AutoscalePolicy.parse(AUTOSCALE_POLICY(COMPUTE_CONFIGS))
        except ValueError:
            # A malformed spec already in a durable catalog degrades
            # to disabled, never raises in the policy thread.
            return None

    # -- the brain ----------------------------------------------------------
    def _signals(self, pol: AutoscalePolicy) -> dict:
        from .freshness import FRESHNESS, _slo_ms

        states = self.controller.replica_states()
        active = [s["name"] for s in states if s["state"] == "active"]
        breaching = FRESHNESS.breaching()
        slo = _slo_ms()
        summary = FRESHNESS.summary()
        live_keys = {
            k: s for k, s in summary.items() if k[1] in active
        }
        # Headroom needs evidence of health, not absence of data: an
        # SLO, at least one lag sample, no breach, and every latest
        # lag comfortably under headroom * slo.
        headroom_ok = bool(
            slo > 0.0
            and live_keys
            and not breaching
            and all(
                s["last_ms"] <= slo * pol.headroom
                for s in live_keys.values()
            )
        )
        per_replica: dict[str, float] = {}
        for (df, r), s in live_keys.items():
            per_replica[r] = max(
                per_replica.get(r, 0.0), s["last_ms"]
            )
        victim = (
            max(active, key=lambda r: (per_replica.get(r, -1.0), r))
            if active
            else None
        )
        return {
            "replicas": len(active),
            "breaching": sorted(breaching),
            "headroom_ok": headroom_ok,
            "slo_ms": slo,
            "most_lagged": victim,
            "worst_lag_ms": max(per_replica.values(), default=0.0),
        }

    def step(self, now: float | None = None) -> dict | None:
        """One evaluation tick. Returns the action taken as a dict
        (``{"action", "replica", "evidence"}``), or None. Explicit
        ``now`` makes oscillation/hysteresis tests clock-driven."""
        pol = self.policy()
        if pol is None:
            self._up_since = self._down_since = None
            return None
        if now is None:
            now = _time.monotonic()
        self.stats["ticks"] += 1
        sig = self._signals(pol)
        if sig["breaching"]:
            self._up_since = (
                now if self._up_since is None else self._up_since
            )
            self._down_since = None
        elif sig["headroom_ok"]:
            self._down_since = (
                now if self._down_since is None else self._down_since
            )
            self._up_since = None
        else:
            # Neither clearly unhealthy nor clearly idle: both sustain
            # clocks reset — THE anti-flap rule. An oscillating load
            # that keeps crossing the SLO line never accumulates a
            # full sustain window on either side.
            self._up_since = self._down_since = None
        in_cooldown = (
            self._last_action_at is not None
            and now - self._last_action_at < pol.cooldown
        )
        if (
            self._up_since is not None
            and now - self._up_since >= pol.up_sustain
        ):
            if in_cooldown or sig["replicas"] >= pol.max_replicas:
                self.stats["holds"] += 1
                holds_total().inc()
                return None
            evidence = {
                "breaching": ",".join(
                    f"{df}@{r}" for df, r in sig["breaching"]
                ),
                "sustained_s": round(now - self._up_since, 3),
                "replicas": sig["replicas"],
                "band": f"{pol.min_replicas}-{pol.max_replicas}",
                "slo_ms": sig["slo_ms"],
            }
            rid = self._spawn()
            self._last_action_at = now
            self._up_since = None
            self.stats["spawns"] += 1
            spawns_total().inc()
            AUTOSCALE.record(
                "scale_up", rid, "sustained slo breach", evidence
            )
            return {
                "action": "scale_up", "replica": rid,
                "evidence": evidence,
            }
        if (
            self._down_since is not None
            and now - self._down_since >= pol.down_sustain
        ):
            if in_cooldown or sig["replicas"] <= pol.min_replicas:
                self.stats["holds"] += 1
                holds_total().inc()
                return None
            victim = sig["most_lagged"]
            if victim is None:
                return None
            evidence = {
                "sustained_s": round(now - self._down_since, 3),
                "replicas": sig["replicas"],
                "band": f"{pol.min_replicas}-{pol.max_replicas}",
                "slo_ms": sig["slo_ms"],
                "worst_lag_ms": round(sig["worst_lag_ms"], 3),
                "headroom": pol.headroom,
            }
            self._drain(victim)
            self._last_action_at = now
            self._down_since = None
            self.stats["drains"] += 1
            drains_total().inc()
            AUTOSCALE.record(
                "scale_down", victim, "sustained lag headroom",
                evidence,
            )
            return {
                "action": "scale_down", "replica": victim,
                "evidence": evidence,
            }
        return None
