"""Lock-order sanitizer over the coordination-plane locks (the port's
copy of ``materialize_tpu/utils/lockcheck.py``).

The coord layer holds a small zoo of locks — the coordinator's
sequencing RLock, the controller's state lock, the PeekBatcher's queue
lock, the replica's remap lock, the dyncfg/metrics registry locks —
acquired from many threads (session threads, the response absorber,
the peek flusher, replica worker loops). Two hazards this sanitizer
catches at test time, before they deadlock a production serving loop:

1. **Order cycles**: thread A acquires X then Y while thread B
   acquires Y then X. The sanitizer records every observed
   acquisition edge (X held while Y acquired ⇒ X→Y) into one global
   order graph; an acquisition that would close a cycle is recorded
   as a finding with both paths named.
2. **Sequencing lock across a device dispatch**: a dispatch (a span of
   eager kernels, or a kernel library's first build, seconds cold)
   while holding a lock marked ``sequencing`` starves every other
   session — the exact
   regression `Coordinator._unlocked` exists to prevent. Dispatch
   sites call :func:`device_dispatch`; intentionally-held sites (the
   coordinator's tiny introspection-constant step) wrap themselves in
   :func:`allow_dispatch`.

Recording is OFF by default (one module-bool check per acquire — the
wrappers cost nothing in production); tests enable it, drive the
ordinary serving/span paths, and assert zero findings. Findings are RECORDED,
never raised: a sanitizer must not turn a would-be deadlock into a
crash mid-test — the assertion at the end reads the ledger.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

# Module-level switch: read unsynchronized on the hot acquire path (a
# torn read just misses one edge during enable/disable — benign).
_ENABLED = False

# The happens-before race detector (analysis/racecheck.py) layers on
# these hook slots: one module-global read per acquire/release/shared-
# access when it is off (None), so production pays nothing. The
# detector installs itself via set_racecheck() on enable.
_RACECHECK = None

# The order graph + findings, guarded by a LEAF lock that is itself
# never tracked (no recursion, no ordering constraints against it).
_graph_lock = threading.Lock()
_edges: dict = {}  # name -> set(names acquired while name held)
_edge_example: dict = {}  # (a, b) -> where string
_findings: list = []
_state = threading.local()  # per-thread held-lock stack
# Epoch versioning for the per-thread held stacks: a lock acquired
# while recording was on but released while it was OFF never runs
# _record_release, leaking a phantom held entry into the thread's
# stack. clear() bumps the epoch, so every thread's stale stack is
# discarded at its next acquisition instead of poisoning the next
# enable() window with spurious nesting.
_epoch = 0


@dataclass
class LockFinding:
    kind: str  # "lock-cycle" | "dispatch-under-lock"
    message: str

    def __str__(self):
        return f"[{self.kind}] {self.message}"


def enable(reset: bool = True) -> None:
    global _ENABLED
    if reset:
        clear()
    _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False


def enabled() -> bool:
    return _ENABLED


def clear() -> None:
    global _epoch
    with _graph_lock:
        _edges.clear()
        _edge_example.clear()
        del _findings[:]
        _epoch += 1


def findings() -> list:
    with _graph_lock:
        return list(_findings)


def edges() -> dict:
    with _graph_lock:
        return {k: set(v) for k, v in _edges.items()}


def _held() -> list:
    h = getattr(_state, "held", None)
    if h is None or getattr(_state, "epoch", -1) != _epoch:
        h = []
        _state.held = h
        _state.epoch = _epoch
    return h


def _path(src: str, dst: str) -> list | None:
    """A path src -> ... -> dst in the observed-order graph (DFS)."""
    stack = [(src, [src])]
    seen = {src}
    while stack:
        node, path = stack.pop()
        if node == dst:
            return path
        for nxt in _edges.get(node, ()):
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


def _record_acquire(name: str) -> None:
    held = _held()
    for i, entry in enumerate(held):
        if entry[0] == name:
            entry[1] += 1  # RLock re-entry: no new ordering fact
            return
    for hname, _depth in held:
        with _graph_lock:
            if name in _edges.get(hname, ()):
                continue
            cycle = _path(name, hname)
            if cycle is not None:
                _findings.append(
                    LockFinding(
                        "lock-cycle",
                        f"acquiring {name!r} while holding {hname!r} "
                        f"closes the cycle {' -> '.join(cycle)} -> "
                        f"{name} (reverse order first seen at "
                        f"{_edge_example.get((cycle[0], cycle[1]), '?')}"
                        ") — two threads interleaving these orders "
                        "deadlock",
                    )
                )
            _edges.setdefault(hname, set()).add(name)
            _edge_example[(hname, name)] = _caller()
    held.append([name, 1])


def _record_release(name: str) -> None:
    held = _held()
    for i in range(len(held) - 1, -1, -1):
        if held[i][0] == name:
            held[i][1] -= 1
            if held[i][1] <= 0:
                del held[i]
            return


def _caller() -> str:
    import inspect

    for fr in inspect.stack()[2:8]:
        fn = fr.filename
        if "lockcheck" not in fn and "threading" not in fn:
            return f"{fn.rsplit('/', 1)[-1]}:{fr.lineno}"
    return "?"


def held_names() -> tuple:
    return tuple(n for n, _ in _held())


# -- race-detector hook slots -------------------------------------------------


def set_racecheck(hooks) -> None:
    """Install (or remove, with None) the happens-before race detector.
    ``hooks`` is any object with on_acquire/on_release/on_read/on_write
    (analysis/racecheck installs its own module)."""
    global _RACECHECK
    _RACECHECK = hooks


def shared_read(name: str) -> None:
    """Instrumentation shim for a READ of declared shared state. One
    global load + None check when the race detector is off."""
    rc = _RACECHECK
    if rc is not None:
        rc.on_read(name)


def shared_write(name: str) -> None:
    """Instrumentation shim for a WRITE of declared shared state."""
    rc = _RACECHECK
    if rc is not None:
        rc.on_write(name)


def registered_names() -> set:
    """Every tracked-lock name ever constructed in this process — the
    tracked-object registry an interleaving explorer keys its
    independence relation on and the race detector uses to seed lock
    clocks."""
    with _graph_lock:
        return set(_REGISTRY)


# -- tracked lock wrappers ---------------------------------------------------


class TrackedLock:
    """A threading.Lock with acquisition-order recording. Drop-in:
    context manager, acquire/release with the stdlib signatures, and
    ``locked()``. ``sequencing=True`` marks the lock for the
    dispatch-under-lock rule."""

    _factory = staticmethod(threading.Lock)

    def __init__(self, name: str, sequencing: bool = False):
        self.name = name
        self.sequencing = sequencing
        if sequencing:
            _SEQUENCING_NAMES.add(name)
        with _graph_lock:
            _REGISTRY.add(name)
        self._lock = self._factory()

    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._lock.acquire(blocking, timeout)
        if got:
            if _ENABLED:
                _record_acquire(self.name)
            rc = _RACECHECK
            if rc is not None:
                rc.on_acquire(self.name)
        return got

    def release(self) -> None:
        # The race detector snapshots the releasing thread's vector
        # clock while the lock is STILL held (the release publishes
        # everything this thread did under it).
        rc = _RACECHECK
        if rc is not None:
            rc.on_release(self.name)
        if _ENABLED:
            _record_release(self.name)
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class TrackedRLock(TrackedLock):
    _factory = staticmethod(threading.RLock)

    def _is_owned(self) -> bool:
        # The coordinator's _unlocked() helper asks the RLock whether
        # THIS thread holds it before releasing around a blocking wait.
        return self._lock._is_owned()

    def locked(self) -> bool:  # RLock has no .locked() before 3.12
        return self._lock._is_owned()


def tracked_lock(name: str, sequencing: bool = False) -> TrackedLock:
    return TrackedLock(name, sequencing)


def tracked_rlock(name: str, sequencing: bool = False) -> TrackedRLock:
    return TrackedRLock(name, sequencing)


# -- the dispatch-under-sequencing-lock rule ---------------------------------


def allow_dispatch(why: str):
    """Context manager sanctioning a device dispatch under a
    sequencing lock (e.g. the coordinator's introspection-constant
    step: a handful of rows, no source waits, bounded work)."""
    import contextlib

    @contextlib.contextmanager
    def cm():
        prev = getattr(_state, "dispatch_ok", 0)
        _state.dispatch_ok = prev + 1
        try:
            yield
        finally:
            _state.dispatch_ok = prev

    return cm()


def device_dispatch(where: str) -> None:
    """Called from render-layer dispatch sites: records a finding when
    a sequencing-marked lock is held by this thread (unless inside
    allow_dispatch). No-op (one bool check) when disabled."""
    if not _ENABLED or getattr(_state, "dispatch_ok", 0):
        return
    seq = [
        n
        for n, _ in _held()
        if n in _SEQUENCING_NAMES
    ]
    if seq:
        with _graph_lock:
            _findings.append(
                LockFinding(
                    "dispatch-under-lock",
                    f"device dispatch at {where} while holding "
                    f"sequencing lock(s) {seq}: a slow dispatch here "
                    "stalls every other session on the lock — release "
                    "it around the dispatch (Coordinator._unlocked) "
                    "or sanction a bounded site with "
                    "lockcheck.allow_dispatch(<why>)",
                )
            )


# Names the dispatch rule treats as sequencing locks: seeded with the
# known coordinator lock (deterministic even before any Coordinator is
# constructed) and extended by every tracked lock built with
# sequencing=True.
_SEQUENCING_NAMES = {"coord.sequencing"}

# Every tracked-lock name ever constructed (see registered_names()).
_REGISTRY: set = set()
