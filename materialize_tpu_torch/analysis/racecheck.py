"""Happens-before race detector over the control plane's shared state.

The coordination layer's threads — session threads, the response
absorber, the peek flusher + resolver pool, replica reader/worker
loops, the subscribe tails, the compile worker — share a declared set
of mutable structures: the controller's observed-state maps, the hub's
session tables, the freshness recorder's rings, the compile ledger's
``_seen`` memory, the dyncfg value store. The lock-order sanitizer
(utils/lockcheck.py) proves the locks themselves compose; THIS pass
proves the shared state is actually *under* them.

Mechanics (FastTrack-style, epochs over vector clocks):

- every thread carries a vector clock; acquiring a tracked lock joins
  the lock's clock into the thread's, releasing publishes the thread's
  clock into the lock's and advances the thread — the classic
  happens-before edges. ``threading.Thread.start``/``join`` are
  wrapped while the detector is enabled so fork/join edges exist too.
- declared shared state is instrumented at its access sites with
  ``lockcheck.shared_read(name)`` / ``shared_write(name)`` (one
  module-global load when the detector is off). Each access records an
  epoch ``(thread, clock)``; a later access by another thread whose
  vector clock has not absorbed that epoch is an UNSYNCHRONIZED pair —
  reported with both stack chains, never raised (same discipline as
  lockcheck: the assertion at the end reads the ledger).

Known under-approximations (documented, deliberate): lock clocks are
keyed by tracked-lock NAME, so two same-named lock instances merge
(extra happens-before edges — may miss a race, never fabricates one);
``queue.Queue`` / ``threading.Event`` hand-offs are not modeled, so
state published through them must be lock-guarded or suppressed.

Enabled via the ``race_detector`` dyncfg (``maybe_enable_from_dyncfg``;
the port's race tests turn it on in their fixtures), default OFF in
production (one pointer check per access).

The port's copy of ``materialize_tpu/analysis/racecheck.py``: the
detector is the reference's, the declared shared-state registry names
the same variables, and the port's control-plane modules carry the
reference's ``shared_read``/``shared_write`` annotations at the
counterpart of every site. The detector runs in CPU tests only; it
instruments host threads.
"""

from __future__ import annotations

import itertools
import sys
import threading
from dataclasses import dataclass, field

from ..utils import lockcheck

_ENABLED = False
_MAX_FINDINGS = 200

# Leaf lock guarding the detector's own state (never tracked).
_state_lock = threading.Lock()
_vars: dict = {}          # shared-state name -> _VarState
_lock_clocks: dict = {}   # tracked-lock name -> vector clock (dict)
_findings: list = []
_finding_keys: set = set()
_suppressed: set = set()
_registry: dict = {}      # declared shared-state name -> doc string
_epoch = 0                # bumped by clear(): invalidates thread state
_tid_counter = itertools.count(1)
_tls = threading.local()

_orig_thread_start = None
_orig_thread_join = None


@dataclass
class RaceFinding:
    """One unsynchronized access pair on a declared shared variable."""

    name: str        # shared-state name
    kind: str        # "write-write" | "read-write" | "write-read"
    a_thread: str    # earlier access
    a_where: str     # stack chain of the earlier access
    b_thread: str    # current access
    b_where: str     # stack chain of the current access

    def __str__(self):
        return (
            f"[race:{self.kind}] {self.name}: {self.a_thread} at "
            f"{self.a_where} vs {self.b_thread} at {self.b_where} "
            "with no happens-before edge (no common lock, fork/join, "
            "or release/acquire chain orders them)"
        )


@dataclass
class _Access:
    tid: int
    clock: int
    thread_name: str
    where: str


@dataclass
class _VarState:
    write: _Access | None = None
    reads: dict = field(default_factory=dict)  # tid -> _Access


class _ThreadState:
    __slots__ = ("tid", "vc", "name", "epoch")

    def __init__(self, tid: int, vc: dict, name: str, epoch: int):
        self.tid = tid
        self.vc = vc
        self.name = name
        self.epoch = epoch


# -- lifecycle ----------------------------------------------------------------


def enable(reset: bool = True) -> None:
    """Turn the detector on and install the lockcheck + threading
    hooks. Idempotent."""
    global _ENABLED
    if reset:
        clear()
    _wrap_threading()
    _ENABLED = True
    lockcheck.set_racecheck(sys.modules[__name__])


def disable() -> None:
    global _ENABLED
    _ENABLED = False
    lockcheck.set_racecheck(None)


def enabled() -> bool:
    return _ENABLED


def detector_configured() -> bool:
    """The ``race_detector`` dyncfg (same consult discipline as
    donation.sanitizer_enabled)."""
    from ..utils.dyncfg import COMPUTE_CONFIGS, RACE_DETECTOR

    return bool(RACE_DETECTOR(COMPUTE_CONFIGS))


def maybe_enable_from_dyncfg(reset: bool = False) -> bool:
    """Enable the detector iff the ``race_detector`` dyncfg says so —
    the entry point for the analysis pytest lane and the race-free
    gate, so the dyncfg is the single switch."""
    if detector_configured():
        if not _ENABLED:
            enable(reset=reset)
        return True
    if _ENABLED:
        disable()
    return False


def clear() -> None:
    global _epoch
    with _state_lock:
        _vars.clear()
        _lock_clocks.clear()
        del _findings[:]
        _finding_keys.clear()
        _epoch += 1


def findings() -> list:
    with _state_lock:
        return list(_findings)


def suppress(name: str) -> None:
    """Mark a shared-state name as known-benign (e.g. a monotonic
    ratchet read lock-free by design). Suppressed accesses are not
    checked or recorded."""
    _suppressed.add(name)


def unsuppress(name: str) -> None:
    _suppressed.discard(name)


def suppressed() -> set:
    return set(_suppressed)


def declare_shared(name: str, doc: str = "") -> str:
    """Register a shared-state name in the declared registry (shown by
    ``registry()``). Returns
    the name so owners can do ``NAME = declare_shared(...)``."""
    _registry[name] = doc
    return name


def registry() -> dict:
    return dict(_registry)


# -- the declared shared-state set -------------------------------------------
# Central declarations for state owned by modules that must stay
# import-light (they instrument through lockcheck.shared_* and never
# import this module). Owners that CAN import analysis declare inline.

declare_shared(
    "controller.replicas",
    "ComputeController.replicas map (add/drop vs broadcast/routing)",
)
declare_shared(
    "controller.observed",
    "controller frontier/verdict/stats maps mutated by the absorber",
)
declare_shared(
    "controller.peek_events",
    "peek_id -> Event map between session threads and the absorber",
)
declare_shared(
    "controller.replica_stats",
    "ReplicaClient session/fence counters vs recovery_snapshot",
)
declare_shared(
    "subscribe.sessions",
    "hub session table (admission vs close vs introspection)",
)
declare_shared(
    "freshness.lag_rings",
    "FRESHNESS commit-lag history + quantile windows",
)
declare_shared(
    "compile_ledger.seen",
    "compile ledger hit/miss memory (every jit site, any thread)",
)
declare_shared(
    "dyncfg.values",
    "dyncfg override store (SET/update vs every hot-path read)",
)


# -- thread state -------------------------------------------------------------


def _ts() -> _ThreadState:
    ts = getattr(_tls, "ts", None)
    if ts is not None and ts.epoch == _epoch:
        return ts
    tid = next(_tid_counter)
    cur = threading.current_thread()
    vc: dict = {}
    inherited = getattr(cur, "_rc_parent_vc", None)
    if inherited is not None and inherited[0] == _epoch:
        vc.update(inherited[1])
    vc[tid] = 1
    ts = _ThreadState(tid, vc, cur.name, _epoch)
    _tls.ts = ts
    return ts


def _snapshot_vc() -> tuple:
    ts = _ts()
    return (_epoch, dict(ts.vc))


def _merge_vc(vc: dict, other: dict) -> None:
    for tid, c in other.items():
        if c > vc.get(tid, 0):
            vc[tid] = c


def _wrap_threading() -> None:
    """Fork/join happens-before edges: a started thread inherits its
    parent's clock snapshot; a join absorbs the child's final clock.
    Installed once, permanently (each wrapper is a no-op while the
    detector is off)."""
    global _orig_thread_start, _orig_thread_join
    if _orig_thread_start is not None:
        return
    _orig_thread_start = threading.Thread.start
    _orig_thread_join = threading.Thread.join

    def start(self):
        if _ENABLED:
            self._rc_parent_vc = _snapshot_vc()
            if not getattr(self, "_rc_wrapped", False):
                self._rc_wrapped = True
                orig_run = self.run

                def run(*a, **k):
                    try:
                        return orig_run(*a, **k)
                    finally:
                        if _ENABLED:
                            self._rc_final_vc = _snapshot_vc()

                self.run = run
        return _orig_thread_start(self)

    def join(self, timeout=None):
        r = _orig_thread_join(self, timeout)
        if _ENABLED and not self.is_alive():
            fin = getattr(self, "_rc_final_vc", None)
            if fin is not None and fin[0] == _epoch:
                _merge_vc(_ts().vc, fin[1])
        return r

    threading.Thread.start = start
    threading.Thread.join = join


# -- lock events (called from lockcheck's tracked wrappers) ------------------


def on_acquire(lock_name: str) -> None:
    if not _ENABLED:
        return
    ts = _ts()
    with _state_lock:
        lc = _lock_clocks.get(lock_name)
        if lc:
            _merge_vc(ts.vc, lc)


def on_release(lock_name: str) -> None:
    if not _ENABLED:
        return
    ts = _ts()
    with _state_lock:
        _lock_clocks[lock_name] = dict(ts.vc)
    ts.vc[ts.tid] = ts.vc.get(ts.tid, 0) + 1


# -- shared-state events ------------------------------------------------------


_STACK_SKIP_FILES = frozenset(
    ("racecheck.py", "lockcheck.py", "threading.py")
)


def _stack(skip: int = 2, depth: int = 4) -> str:
    try:
        f = sys._getframe(skip)
    except ValueError:
        return "?"
    out: list = []
    while f is not None and len(out) < depth:
        base = f.f_code.co_filename.rsplit("/", 1)[-1]
        if base not in _STACK_SKIP_FILES:
            out.append(f"{base}:{f.f_lineno}")
        f = f.f_back
    return " < ".join(out) if out else "?"


def _report(kind: str, name: str, prior: _Access, ts, where: str) -> None:
    # Caller holds _state_lock. Dedup on the site pair: one finding per
    # distinct racy pair of code locations, not one per execution.
    key = (name, kind, prior.where, where)
    if key in _finding_keys or len(_findings) >= _MAX_FINDINGS:
        return
    _finding_keys.add(key)
    _findings.append(
        RaceFinding(
            name=name,
            kind=kind,
            a_thread=prior.thread_name,
            a_where=prior.where,
            b_thread=ts.name,
            b_where=where,
        )
    )


def _hb(acc: _Access, vc: dict) -> bool:
    """Did ``acc`` happen-before the thread owning ``vc``?"""
    return acc.clock <= vc.get(acc.tid, 0)


def on_read(name: str) -> None:
    if not _ENABLED or name in _suppressed:
        return
    ts = _ts()
    where = _stack()
    with _state_lock:
        st = _vars.get(name)
        if st is None:
            st = _vars[name] = _VarState()
        w = st.write
        if w is not None and w.tid != ts.tid and not _hb(w, ts.vc):
            _report("write-read", name, w, ts, where)
        st.reads[ts.tid] = _Access(
            ts.tid, ts.vc.get(ts.tid, 0), ts.name, where
        )


def on_write(name: str) -> None:
    if not _ENABLED or name in _suppressed:
        return
    ts = _ts()
    where = _stack()
    with _state_lock:
        st = _vars.get(name)
        if st is None:
            st = _vars[name] = _VarState()
        w = st.write
        if w is not None and w.tid != ts.tid and not _hb(w, ts.vc):
            _report("write-write", name, w, ts, where)
        for r in st.reads.values():
            if r.tid != ts.tid and not _hb(r, ts.vc):
                _report("read-write", name, r, ts, where)
        st.write = _Access(
            ts.tid, ts.vc.get(ts.tid, 0), ts.name, where
        )
        st.reads = {}
