"""Interleaving explorer: exhaustive schedule enumeration for the
control-plane protocols.

The chaos harness (testing/chaos.py) checks the coordination
invariants *probabilistically* — it found the cross-thread
``socket.close`` deferral wedge roughly one storm in three. This
module checks them *exhaustively*: the protocol state machines run as
cooperative tasks under a virtual scheduler that enumerates every
inequivalent interleaving, asserts the harness's invariants at every
terminal state, branches a crash at every durable-write boundary, and
prints a minimal schedule trace on violation. Pay the exploration cost
once, offline, instead of hoping the chaos dice land on the bad
schedule.

Execution model (announce-then-execute):

- a **task** is a generator. Each ``yield Op(obj, kind, ...)``
  ANNOUNCES the task's next visible operation; when the scheduler
  picks the task, it advances the generator one step, which EXECUTES
  the announced operation (the code between that yield and the next)
  atomically. Real protocol code runs inside the step bodies —
  ``_NonceSource`` nonce management, ``ctp.hard_close`` teardown, the
  catalog append/retract discipline — with sockets and persist writes
  replaced by schedulable effect points.
- ``Op.ready`` (optional nullary predicate) models blocking: the task
  is disabled until it returns True. Convention: the predicate must
  only read state covered by the op's ``obj`` — that keeps the
  dependence relation sound.
- ``Op.crash_point=True`` marks a durable-write boundary: for every
  complete schedule, the explorer re-runs each distinct prefix ending
  at such a step, drops the rest of the schedule on the floor, runs
  ``model.on_crash()`` (the recovery/replay logic), and asserts
  ``model.invariant(crashed=True)``.

Partial-order reduction: stateless DPOR (Flanagan–Godefroid). Two ops
are dependent iff they touch the same ``obj`` and at least one is a
write. The ``obj`` vocabulary is keyed on the lockcheck tracked-object
registry (``lockcheck.registered_names()``): models name their
scheduling objects after the real tracked locks ("coord.sequencing",
"controller.state", ...) so the independence relation the explorer
exploits is exactly the lock structure the sanitizer certifies.

Terminal-state rules: a terminal state with a blocked non-daemon task
is a **wedge** violation (this is how the pre-``hard_close`` teardown
is found — see ``WedgeModel``); otherwise ``model.invariant()`` runs.
Violations are collected (never raised) with a greedily minimized
schedule; ``Violation.to_trace()`` emits the JSON the chaos harness
replays wall-clock (``run_chaos(replay_trace=...)``).

The port of ``materialize_tpu/analysis/interleave.py`` as it stands: the
explorer is host Python and reads no program, and each model runs the
port's own control-plane code (``coord/controller._NonceSource``,
``coord/protocol.hard_close``, ``storage/persist``'s ``MemBlob``,
``MemConsensus``, ``PersistClient`` and ``machine.CompactorFenced``) and
the port's lock registry (``utils/lockcheck.registered_names``). Its
traces feed the port's chaos harness
(``testing/chaos.py:fault_plan_from_trace``, ``run_chaos(replay_trace=)``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..utils import lockcheck


class Op:
    """One announced operation on a scheduling object.

    ``obj``: the shared object's name (use the lockcheck tracked-lock
    name when the real code guards this state with a tracked lock).
    ``kind``: "read" or "write" — two reads commute, everything else
    on the same obj is dependent. ``ready``: optional nullary
    predicate; the task is blocked until it returns True (it must read
    only state covered by ``obj``). ``crash_point``: durable-write
    boundary — the explorer branches a crash immediately after this
    step. ``chaos``: optional chaos-harness action tag
    ("kill_conns" | "kill_replica" | ("partition", n) | "ddl") used by
    the wall-clock replay bridge.
    """

    __slots__ = ("obj", "kind", "label", "ready", "crash_point", "chaos")

    def __init__(
        self,
        obj: str,
        kind: str = "write",
        label: str = "",
        ready=None,
        crash_point: bool = False,
        chaos=None,
    ):
        if kind not in ("read", "write"):
            raise ValueError(f"Op kind must be read|write, got {kind!r}")
        self.obj = obj
        self.kind = kind
        self.label = label or f"{kind}({obj})"
        self.ready = ready
        self.crash_point = crash_point
        self.chaos = chaos

    def describe(self) -> dict:
        return {
            "obj": self.obj,
            "kind": self.kind,
            "label": self.label,
            "crash_point": self.crash_point,
            "chaos": self.chaos,
        }


def _dependent(a: Op, b: Op) -> bool:
    return a.obj == b.obj and not (a.kind == "read" and b.kind == "read")


@dataclass
class Violation:
    """One invariant/wedge/crash-recovery failure with its (minimized)
    reproduction schedule."""

    model: str
    message: str
    schedule: list            # task names, in execution order
    steps: list               # Op.describe() + task, per executed step
    crash_after: int | None   # crash branch: index of last executed step
    kind: str                 # "invariant" | "wedge" | "crash" | "fault"

    def to_trace(self) -> dict:
        """The JSON schedule trace the chaos harness replays
        wall-clock (testing/chaos.py ``--replay-trace``)."""
        return {
            "model": self.model,
            "kind": self.kind,
            "message": self.message,
            "schedule": list(self.schedule),
            "crash_after": self.crash_after,
            "steps": [
                dict(s, task=t)
                for t, s in zip(self.schedule, self.steps)
            ],
        }

    def format(self) -> str:
        lines = [
            f"violation[{self.kind}] in model {self.model!r}: "
            f"{self.message}",
            "minimal schedule:",
        ]
        for i, (t, s) in enumerate(zip(self.schedule, self.steps)):
            mark = " <-- CRASH HERE" if self.crash_after == i else ""
            lines.append(
                f"  {i:3d}. {t:<12s} {s['label']}"
                f"  [{s['kind']} {s['obj']}]{mark}"
            )
        if self.crash_after is not None and self.crash_after >= len(
            self.steps
        ):
            lines.append(f"  (crash after step {self.crash_after})")
        return "\n".join(lines)

    def __str__(self):
        return self.format()


@dataclass
class ExploreResult:
    model: str
    schedules: int = 0        # complete schedules enumerated
    terminals: int = 0        # terminal states checked
    crash_branches: int = 0   # distinct crash prefixes checked
    steps: int = 0            # total executed steps across all runs
    truncated: bool = False   # hit max_schedules before exhausting
    violations: list = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations and not self.truncated

    def summary(self) -> str:
        return (
            f"model={self.model} schedules={self.schedules} "
            f"terminals={self.terminals} "
            f"crash_branches={self.crash_branches} steps={self.steps} "
            f"violations={len(self.violations)}"
            + (" TRUNCATED" if self.truncated else "")
        )


class _Task:
    __slots__ = ("name", "gen", "pending", "done", "daemon")

    def __init__(self, name, gen, daemon):
        self.name = name
        self.gen = gen
        self.daemon = daemon
        self.done = False
        self.pending = None


class _Node:
    """One depth of the DPOR search tree: the enabled set observed
    there, the choices scheduled for exploration (backtrack), and the
    choices already explored (done)."""

    __slots__ = ("enabled", "backtrack", "done")

    def __init__(self, enabled):
        self.enabled = list(enabled)
        self.backtrack = set()
        self.done = set()


class _Outcome:
    __slots__ = (
        "status", "choices", "steps", "violation", "vkind", "blocked",
    )

    def __init__(self, status, choices, steps, violation, vkind, blocked):
        self.status = status        # "terminal" | "crashed" | "illegal"
        self.choices = choices
        self.steps = steps          # [(task_name, Op)]
        self.violation = violation  # message or None
        self.vkind = vkind
        self.blocked = blocked


def _spawn(model):
    tasks = {}
    order = []
    daemons = set(getattr(model, "daemons", ()) or ())
    for name, gen in model.tasks():
        t = _Task(name, gen, name in daemons)
        try:
            t.pending = next(gen)
        except StopIteration:
            t.done = True
        tasks[name] = t
        order.append(name)
    return tasks, order


def _enabled(tasks, order):
    out = []
    for name in order:
        t = tasks[name]
        if t.done:
            continue
        op = t.pending
        if op.ready is None or op.ready():
            out.append(name)
    return out


def _run(factory, forced, nodes=None, crash_after=None, max_steps=10000):
    """Replay ``forced`` choices from a fresh model, then extend
    greedily to a terminal state (or stop after ``crash_after`` steps
    and run the crash-recovery check). Fills ``nodes`` (the DPOR tree)
    when given."""
    model = factory()
    tasks, order = _spawn(model)
    steps = []
    choices = []
    i = 0
    while True:
        if crash_after is not None and i > crash_after:
            break
        en = _enabled(tasks, order)
        if not en:
            break
        if i < len(forced):
            c = forced[i]
            if c not in en:
                return _Outcome("illegal", choices, steps, None, None, [])
        else:
            c = en[0]
        if nodes is not None:
            if i == len(nodes):
                nodes.append(_Node(en))
            node = nodes[i]
            node.backtrack.add(c)
            node.done.add(c)
        t = tasks[c]
        steps.append((c, t.pending))
        choices.append(c)
        try:
            t.pending = next(t.gen)
        except StopIteration:
            t.done = True
            t.pending = None
        except AssertionError as e:
            # A task body tripped a mid-schedule assertion — report it
            # as a violation at this prefix, not a crash of the tool.
            return _Outcome(
                "terminal", choices, steps, str(e), "fault", []
            )
        i += 1
        if i >= max_steps:
            return _Outcome(
                "terminal", choices, steps,
                f"schedule exceeded {max_steps} steps (livelock?)",
                "fault", [],
            )

    if crash_after is not None:
        on_crash = getattr(model, "on_crash", None)
        if on_crash is not None:
            on_crash()
        violation = None
        try:
            model.invariant(crashed=True)
        except AssertionError as e:
            violation = str(e)
        return _Outcome(
            "crashed", choices, steps, violation, "crash", []
        )

    blocked = [
        n for n in order if not tasks[n].done and not tasks[n].daemon
    ]
    if blocked:
        waits = ", ".join(
            f"{n} waiting on {tasks[n].pending.label!r} "
            f"[{tasks[n].pending.obj}]"
            for n in blocked
        )
        return _Outcome(
            "terminal", choices, steps,
            f"wedge: {waits} — blocked forever at a terminal state "
            "(no enabled task can ever make it ready)",
            "wedge", blocked,
        )
    violation = None
    try:
        model.invariant(crashed=False)
    except AssertionError as e:
        violation = str(e)
    return _Outcome(
        "terminal", choices, steps, violation,
        "invariant" if violation else None, [],
    )


def _switches(choices) -> int:
    return sum(
        1 for a, b in zip(choices, choices[1:]) if a != b
    )


def _still_violates(factory, choices, crash_after, vkind) -> bool:
    out = _run(factory, choices, None, crash_after=crash_after)
    if out.status == "illegal" or out.violation is None:
        return False
    if crash_after is not None and len(out.choices) <= crash_after:
        return False
    return True


def _minimize(factory, choices, crash_after, vkind):
    """Greedy adjacent-swap reduction of context switches while the
    violation persists — the 'minimal schedule trace' shown to the
    developer is the least-preempting reproduction, which is the one a
    human can actually follow."""
    cur = list(choices)
    improved = True
    while improved:
        improved = False
        for i in range(len(cur) - 1):
            if cur[i] == cur[i + 1]:
                continue
            cand = cur[:i] + [cur[i + 1], cur[i]] + cur[i + 2:]
            if _switches(cand) < _switches(cur) and _still_violates(
                factory, cand, crash_after, vkind
            ):
                cur = cand
                improved = True
                break
    return cur


def _record_violation(result, factory, out, crash_after):
    choices = _minimize(factory, out.choices, crash_after, out.vkind)
    replay = _run(factory, choices, None, crash_after=crash_after)
    if replay.violation is None:  # minimization raced a fluke — keep raw
        choices, replay = out.choices, out
    result.violations.append(
        Violation(
            model=result.model,
            message=replay.violation,
            schedule=list(replay.choices),
            steps=[op.describe() for _, op in replay.steps],
            crash_after=crash_after,
            kind=replay.vkind,
        )
    )


def explore(
    factory,
    crash: bool = True,
    max_schedules: int = 200000,
    max_violations: int = 10,
) -> ExploreResult:
    """Exhaustively enumerate inequivalent schedules of
    ``factory()``'s tasks (stateless DPOR), checking invariants at
    every terminal state and (optionally) every crash branch.

    ``factory`` must build a FRESH model each call: an object with
    ``name``, ``tasks() -> [(task_name, generator)]``,
    ``invariant(crashed=False)`` raising AssertionError on violation,
    and optionally ``on_crash()`` (recovery replay) and ``daemons``
    (task names allowed to be blocked at terminal states).
    """
    result = ExploreResult(model=getattr(factory(), "name", "?"))
    nodes: list = []
    forced: list = []
    seen_crash: set = set()
    while True:
        out = _run(factory, forced, nodes)
        if out.status == "illegal":
            raise RuntimeError(
                f"model {result.model!r} is non-deterministic: replaying "
                f"choices {out.choices + forced[len(out.choices):][:1]} "
                "hit a step where the forced task was not enabled — "
                "model state must be a pure function of the schedule"
            )
        result.schedules += 1
        result.terminals += 1
        result.steps += len(out.steps)
        if out.violation is not None:
            if len(result.violations) < max_violations:
                _record_violation(result, factory, out, None)
        elif crash:
            for k, (_t, op) in enumerate(out.steps):
                if not op.crash_point:
                    continue
                key = tuple(out.choices[: k + 1])
                if key in seen_crash:
                    continue
                seen_crash.add(key)
                cout = _run(factory, out.choices, None, crash_after=k)
                result.crash_branches += 1
                result.steps += len(cout.steps)
                if cout.violation is not None and (
                    len(result.violations) < max_violations
                ):
                    _record_violation(result, factory, cout, k)

        # Flanagan–Godefroid backtrack-point update: for each step,
        # the LAST earlier dependent step by a different task gets the
        # later task added to its backtrack set (or its whole enabled
        # set, when the later task was not enabled there).
        for idx in range(len(out.steps)):
            p, op_i = out.steps[idx]
            for j in range(idx - 1, -1, -1):
                q, op_j = out.steps[j]
                if q != p and _dependent(op_i, op_j):
                    node = nodes[j]
                    if p in node.enabled:
                        node.backtrack.add(p)
                    else:
                        node.backtrack.update(node.enabled)
                    break

        while nodes and not (nodes[-1].backtrack - nodes[-1].done):
            nodes.pop()
        if not nodes:
            break
        if result.schedules >= max_schedules:
            result.truncated = True
            break
        depth = len(nodes) - 1
        nxt = min(nodes[-1].backtrack - nodes[-1].done)
        forced = out.choices[:depth] + [nxt]
    return result


# ---------------------------------------------------------------------------
# Protocol models. Each wires REAL control-plane code (the nonce
# source, hard_close, the append-then-retract discipline, the
# wait_installed decision rules) into schedulable task bodies. Object
# names reuse the lockcheck tracked-lock vocabulary where the real
# state is guarded by that lock.
# ---------------------------------------------------------------------------


class FencingModel:
    """The epoch/fencing handshake: N controller generations race
    to fence one replica. Runs the real ``_NonceSource``
    (coord/controller.py) for nonce issue + reject fast-forward; the
    replica-side accept rule and worker-loop epoch check mirror
    coord/replica.py (reject ``nonce <= epoch``; a worker stops
    applying the moment ``epoch != session nonce``).

    Invariants (the chaos harness's, made exhaustive): applied-command
    epochs are monotone (once a newer generation's command lands, no
    older generation's command ever lands after it — single-writer),
    nothing is double-applied, every controller either completes or
    was fenced by a strictly newer epoch.
    """

    name = "fencing"
    daemons = ()

    def __init__(self, controllers: int = 2, commands: int = 2):
        from ..coord.controller import _NonceSource

        self.src = _NonceSource()
        self.epoch = -1            # replica's fencing epoch (starts -1)
        self.applied = []          # (epoch, ctrl, cmd_idx)
        self.fenced = 0            # HelloRejects served
        self.completed = set()
        self.gave_up = set()
        self._n = controllers
        self._k = commands

    def tasks(self):
        return [
            (f"ctrl{i}", self._controller(f"ctrl{i}"))
            for i in range(self._n)
        ]

    def _controller(self, me):
        for _attempt in range(2):
            nonce = self.src.next()
            yield Op("replica.epoch", "write", f"{me}:hello({nonce})")
            if nonce <= self.epoch:
                # HelloReject{epoch} -> fast-forward (real method)
                self.fenced += 1
                self.src.bump_past(self.epoch)
                continue
            self.epoch = nonce
            session = nonce
            ok = True
            for k in range(self._k):
                # The worker-loop epoch check and the apply are ONE
                # atomic step: in the real replica both happen in the
                # worker thread under the replica state lock
                # (replica.py _worker_loop — it exits the moment
                # ``self.epoch != nonce``).
                yield Op("replica.epoch", "write", f"{me}:apply({k})")
                if self.epoch != session:
                    ok = False  # worker loop exited (replica.py)
                    break
                self.applied.append((session, me, k))
            if ok:
                self.completed.add(me)
            return
        self.gave_up.add(me)

    def invariant(self, crashed: bool = False) -> None:
        epochs = [e for e, _, _ in self.applied]
        assert epochs == sorted(epochs), (
            "fencing violated: a fenced generation applied a command "
            f"AFTER its successor — apply log {self.applied}"
        )
        assert len({(c, k) for _, c, k in self.applied}) == len(
            self.applied
        ), f"double-apply in {self.applied}"
        for e, _c, _k in self.applied:
            assert e <= self.epoch, (
                f"apply at epoch {e} above replica epoch {self.epoch}"
            )
        assert self.epoch >= 1, "no generation ever fenced the replica"


class SetCrashModel:
    """The catalog ``SET`` append-then-retract crash window
    (coord/coordinator.py SetVarPlan): a SET durably appends the NEW
    record BEFORE retracting the prior one, so a crash between the two
    writes leaves both live and boot-time replay (newest id wins)
    retracts the orphan. ``retract_first=True`` models the tempting
    wrong order — retract-then-append — whose crash window LOSES the
    variable; the explorer must find that violation
    (tests/test_torch_interleave.py pins it).

    Two SET sessions serialize on "coord.sequencing" (the real
    coordinator RLock's tracked name); every catalog append is a
    durable-write crash point.
    """

    name = "set-crash-window"
    daemons = ()
    VAR = "mz_timestamp_interval"

    def __init__(self, retract_first: bool = False):
        self.retract_first = retract_first
        self.log = []          # (record_id, value, diff) — durable shard
        self.next_id = 1
        self.seq_owner = None  # "coord.sequencing" holder
        self.recovered = None  # set by on_crash
        self.initial = "1s"
        self.values = ["500ms", "250ms"]
        self.log.append((0, self.initial, +1))

    def tasks(self):
        return [
            (f"set{i}", self._setter(f"set{i}", v))
            for i, v in enumerate(self.values)
        ]

    def _live(self):
        acc = {}
        for rid, val, diff in self.log:
            cur = acc.get(rid, (val, 0))
            acc[rid] = (val, cur[1] + diff)
        return sorted(
            (rid, val) for rid, (val, n) in acc.items() if n > 0
        )

    def _setter(self, me, value):
        yield Op(
            "coord.sequencing", "write", f"{me}:lock",
            ready=lambda: self.seq_owner is None,
        )
        self.seq_owner = me
        prior = self._live()[-1] if self._live() else None
        if self.retract_first:
            if prior is not None:
                yield Op(
                    "catalog.log", "write",
                    f"{me}:retract(#{prior[0]})", crash_point=True,
                )
                self.log.append((prior[0], prior[1], -1))
            yield Op(
                "catalog.log", "write", f"{me}:append({value})",
                crash_point=True,
            )
            self.log.append((self.next_id, value, +1))
            self.next_id += 1
        else:
            yield Op(
                "catalog.log", "write", f"{me}:append({value})",
                crash_point=True,
            )
            self.log.append((self.next_id, value, +1))
            self.next_id += 1
            if prior is not None:
                yield Op(
                    "catalog.log", "write",
                    f"{me}:retract(#{prior[0]})", crash_point=True,
                )
                self.log.append((prior[0], prior[1], -1))
        yield Op("coord.sequencing", "write", f"{me}:unlock")
        self.seq_owner = None

    def on_crash(self) -> None:
        # Boot replay (coordinator._bootstrap + _catalog_live_records):
        # newest id wins, older live duplicates get retracted.
        live = self._live()
        if len(live) > 1:
            for rid, val in live[:-1]:
                self.log.append((rid, val, -1))
            live = live[-1:]
        self.recovered = live[-1][1] if live else None

    def invariant(self, crashed: bool = False) -> None:
        if crashed:
            valid = {self.initial, *self.values}
            assert self.recovered is not None, (
                f"catalog SET lost {self.VAR!r}: crash in the "
                "retract→append window left ZERO live records — the "
                "variable vanished across restart (this is why the "
                "real coordinator appends the new record FIRST)"
            )
            assert self.recovered in valid, (
                f"recovered {self.recovered!r} not in {valid}"
            )
            assert len(self._live()) == 1, (
                f"replay left {len(self._live())} live records"
            )
        else:
            live = self._live()
            assert len(live) == 1, (
                f"{len(live)} live records after serialized SETs"
            )
            assert live[0][1] in self.values


class _ModelSocket:
    """A socket effect-point modeling CPython's ``_io_refs`` close
    deferral: while a sibling thread is blocked in ``recv``, a bare
    ``close()`` only queues the close (the fd stays open, the reader
    never wakes); ``shutdown(SHUT_RDWR)`` takes effect immediately and
    wakes the reader with EOF. Duck-types just enough for the REAL
    ``ctp.hard_close`` to run against it."""

    def __init__(self):
        self.shut = False
        self.close_requested = False
        self.reader_blocked = False

    def shutdown(self, _how) -> None:
        self.shut = True

    def close(self) -> None:
        self.close_requested = True
        # the actual fd close defers while a reader holds _io_refs;
        # only shutdown() unblocks a concurrent recv.

    def readable_event(self) -> bool:
        return self.shut


class WedgeModel:
    """The chaos-harness wedge, re-derived exhaustively: a
    fenced replica session's teardown races the session's reader
    thread blocked in ``recv``. With ``hard_close=False`` the teardown
    is the pre-fix bare ``sock.close()`` — the explorer must FIND the
    wedge (reader blocked forever at a terminal state) with a minimal
    trace. With ``hard_close=True`` the teardown runs the REAL
    ``ctp.hard_close`` (coord/protocol.py) against the model socket
    and every schedule passes."""

    name = "close-wedge"
    daemons = ()

    def __init__(self, hard_close: bool = True):
        self.hard_close = hard_close
        self.sock = _ModelSocket()
        self.reader_done = False

    def tasks(self):
        return [
            ("reader", self._reader()),
            ("fencer", self._fencer()),
        ]

    def _reader(self):
        self.sock.reader_blocked = True
        yield Op(
            "session.sock", "read", "recv()",
            ready=self.sock.readable_event,
        )
        # woke with EOF/ECONNRESET — session reader exits cleanly
        self.sock.reader_blocked = False
        self.reader_done = True

    def _fencer(self):
        yield Op("session.sock", "write", "fence: teardown stale session")
        if self.hard_close:
            from ..coord import protocol as ctp

            ctp.hard_close(self.sock)
        else:
            # the pre-hard_close teardown
            self.sock.close()

    def invariant(self, crashed: bool = False) -> None:
        # the wedge itself is caught by the explorer's blocked-task
        # rule before invariant() runs; reaching here means the reader
        # finished.
        assert self.reader_done


class ReconcileModel:
    """Counted reconciliation + ``wait_installed``: a reconnecting
    controller receives the replica's installed-dataflow list in
    HelloOk, skips re-rendering anything already installed
    (rebuilds==0 across restart), and a concurrent DDL lands its new
    dataflow exactly once — through reconciliation or broadcast, never
    both. Pending-set bookkeeping lives under "controller.state" (the
    real tracked lock)."""

    name = "reconcile"
    daemons = ()

    def __init__(self):
        self.installed = {"mv1"}    # already on the replica (survived)
        self.catalog = {"mv1"}      # coordinator's catalog at reconnect
        self.renders = []           # (dataflow, via)
        self.pending = set()        # claimed under controller.state
        self.hello_done = False
        self.acks = {}

    def tasks(self):
        return [
            ("controller", self._controller()),
            ("ddl", self._ddl()),
            ("replica", self._replica()),
        ]

    def _claim(self, df):
        if df in self.pending or any(
            r == df for r, _ in self.renders
        ):
            return False
        self.pending.add(df)
        return True

    def _controller(self):
        yield Op("replica.epoch", "write", "hello")
        installed = set(self.installed)  # HelloOk carries the list
        self.hello_done = True
        yield Op("controller.state", "write", "reconcile")
        for df in sorted(self.catalog):
            if df in installed:
                continue  # counted reconciliation: no re-render
            if self._claim(df):
                yield Op("replica.applied", "write", f"render({df})")
                self.renders.append((df, "reconcile"))
                self.installed.add(df)

    def _ddl(self):
        yield Op("controller.state", "write", "ddl: create mv2")
        self.catalog.add("mv2")
        if self._claim("mv2"):
            yield Op("replica.applied", "write", "render(mv2)")
            self.renders.append(("mv2", "broadcast"))
            self.installed.add("mv2")

    def _replica(self):
        yield Op(
            "replica.applied", "read", "ack",
            ready=lambda: bool(self.renders),
        )
        for df, _via in self.renders:
            self.acks[df] = "ok"

    def invariant(self, crashed: bool = False) -> None:
        rendered = [df for df, _ in self.renders]
        assert len(rendered) == len(set(rendered)), (
            f"double-render: {self.renders} — a dataflow was installed "
            "through BOTH reconciliation and the DDL broadcast"
        )
        assert "mv1" not in rendered, (
            "rebuilds!=0: mv1 survived on the replica but was "
            "re-rendered during reconciliation"
        )
        assert self.installed >= self.catalog, (
            f"catalog {self.catalog} not fully installed "
            f"{self.installed}"
        )


class BatcherModel:
    """PeekBatcher flush vs shed: submitters append to the bounded
    queue under "controller.peeks" while the flusher drains batches;
    over capacity, the oldest entry is shed with ServerBusy. Invariant
    (the chaos harness's serving check): every submitted peek resolves
    exactly once — a result or a ServerBusy, never neither or both."""

    name = "peek-batcher"
    # the real flusher is a daemon loop: blocked-on-empty-queue at a
    # terminal state is its normal idle, not a wedge
    daemons = ("flusher",)

    def __init__(self, submitters: int = 3, cap: int = 2):
        self.cap = cap
        self.queue = []
        self.resolved = {}  # peek_id -> "ok" | "busy"
        self._n = submitters

    def tasks(self):
        out = [
            (f"peek{i}", self._submit(f"peek{i}"))
            for i in range(self._n)
        ]
        out.append(("flusher", self._flush()))
        return out

    def _submit(self, pid):
        yield Op("controller.peeks", "write", f"{pid}:enqueue")
        self.queue.append(pid)
        if len(self.queue) > self.cap:
            shed = self.queue.pop(0)
            self._resolve(shed, "busy")

    def _resolve(self, pid, how):
        assert pid not in self.resolved, (
            f"peek {pid} resolved twice ({self.resolved[pid]} then "
            f"{how})"
        )
        self.resolved[pid] = how

    def _flush(self):
        for _round in range(self._n):
            yield Op(
                "controller.peeks", "write", "flush",
                ready=lambda: bool(self.queue),
            )
            batch, self.queue = self.queue, []
            for pid in batch:
                self._resolve(pid, "ok")

    def invariant(self, crashed: bool = False) -> None:
        submitted = {f"peek{i}" for i in range(self._n)}
        lost = submitted - set(self.resolved) - set(self.queue)
        assert not lost, f"peeks lost without resolution: {lost}"
        assert set(self.resolved) | set(self.queue) == submitted


class HubModel:
    """Subscribe-hub drop-exactly-once: a session's close races the
    tail-retirement sweep (``close_session`` vs ``close_for``), both
    of which must settle on ONE drop. ``locked=True`` (the shipped
    code) performs check-and-pop atomically under
    "coord.subscribe_hub"; ``locked=False`` splits the existence check
    and the pop across a yield — the explorer must find the
    double-drop."""

    name = "subscribe-drop"
    daemons = ()

    def __init__(self, locked: bool = True):
        self.locked = locked
        self.sessions = {"s1": object()}
        self.drops = []

    def tasks(self):
        return [
            ("closer", self._drop("closer")),
            ("retirer", self._drop("retirer")),
        ]

    def _drop(self, me):
        if self.locked:
            yield Op("coord.subscribe_hub", "write", f"{me}:close(s1)")
            if self.sessions.pop("s1", None) is not None:
                self.drops.append(me)
        else:
            yield Op("coord.subscribe_hub", "read", f"{me}:check(s1)")
            present = "s1" in self.sessions
            if present:
                yield Op("coord.subscribe_hub", "write", f"{me}:pop(s1)")
                self.sessions.pop("s1", None)
                self.drops.append(me)

    def invariant(self, crashed: bool = False) -> None:
        assert len(self.drops) == 1, (
            f"drop-exactly-once violated: session dropped by "
            f"{self.drops or 'nobody'}"
        )
        assert not self.sessions, "session leaked past both closers"


class DrainModel:
    """Routed-read failover exactly-once: a replica DRAIN
    races an in-flight peek that was routed to that replica. The drain
    re-dispatches the peek to the next candidate, but the drained
    replica's answer may already be in the response queue — the
    straggler and the failover target's answer then race to resolve
    the same waiter. ``dedup=True`` (the shipped controller) makes the
    check-and-resolve atomic under "controller.peek_events" (first
    response wins, second is dropped); ``dedup=False`` splits the
    resolved-check and the resolution across a yield — the explorer
    must find the double-resolve."""

    name = "replica-drain-peek"
    # replicas idle at terminal states when never dispatched to
    daemons = ("r0", "r1")

    def __init__(self, dedup: bool = True):
        self.dedup = dedup
        self.dispatched = {"r0"}  # p1 routed to r0 before the drain
        self.draining: set = set()
        self.resolved: dict = {}
        self.resolutions = []  # (peek, replica) — must end length 1

    def tasks(self):
        return [
            ("drainer", self._drain()),
            ("r0", self._answer("r0")),
            ("r1", self._answer("r1")),
        ]

    def _drain(self):
        yield Op("controller.state", "write", "drain:mark(r0)")
        self.draining.add("r0")
        # Failover re-dispatch: atomic with the resolved-check (the
        # real _failover_peek commits the hop under the controller
        # lock and skips peeks that already resolved).
        yield Op("controller.peek_events", "write", "drain:failover(p1)")
        if "p1" not in self.resolved:
            self.dispatched.add("r1")

    def _answer(self, me):
        # The absorber processes this replica's answer to p1 once the
        # peek was ever dispatched to it (stragglers included: a
        # drained replica's response can arrive after the failover).
        yield Op(
            "controller.peek_events", "read", f"{me}:response(p1)",
            ready=lambda: me in self.dispatched,
        )
        if self.dedup:
            yield Op(
                "controller.peek_events", "write", f"{me}:resolve(p1)"
            )
            if "p1" not in self.resolved:
                self.resolved["p1"] = me
                self.resolutions.append(("p1", me))
        else:
            # The tempting wrong shape: check outside the lock, then
            # resolve — both replicas pass the check, both resolve.
            yield Op(
                "controller.peek_events", "read", f"{me}:check(p1)"
            )
            pending = "p1" not in self.resolved
            if pending:
                yield Op(
                    "controller.peek_events", "write",
                    f"{me}:resolve(p1)",
                )
                self.resolved["p1"] = me
                self.resolutions.append(("p1", me))

    def invariant(self, crashed: bool = False) -> None:
        assert len(self.resolutions) == 1, (
            "routed-peek exactly-once violated: p1 resolved by "
            f"{[r for _, r in self.resolutions] or 'NOBODY'} — a "
            "drain must neither lose the waiter nor let the drained "
            "replica's straggler answer double-resolve it"
        )


class ScaleBandModel:
    """Autoscaler action racing a rolling restart: both
    mutate the replica set, and the serving invariants are *at every
    instant* — replica count stays inside [min,max] and at least one
    serving replica exists. ``locked=True`` (the shipped environment)
    serializes both actions on "environment.scale" (the real tracked
    lock) with the restart's abort-if-no-other-serving precondition;
    ``locked=False`` lets the autoscaler's read-count-then-act span
    the restart's stop/respawn window — the explorer must find the
    band overflow (``action="spawn"``: count > max after the restart
    respawns) or the zero-serving instant (``action="drain"``: the
    drain lands while the restarted replica is down)."""

    name = "autoscale-band"
    daemons = ()

    def __init__(
        self,
        locked: bool = True,
        action: str = "spawn",
        first: str = "restarter",
    ):
        assert action in ("spawn", "drain")
        self.locked = locked
        self.action = action
        # Which task the scheduler tries first. A blocked lock acquire
        # is not an enabled op, so DPOR cannot backtrack into the
        # other acquisition order on its own — callers cover both
        # orders explicitly (tests do), including the restart's
        # abort-when-no-other-serving path.
        self.first = first
        self.replicas = {"r0": "serving", "r1": "serving"}
        self.min_replicas = 1
        self.max_replicas = 2
        self.scale_owner = None
        self.aborted = False
        self.min_live = len(self.replicas)
        self.max_count = len(self.replicas)

    def _note(self) -> None:
        self.min_live = min(self.min_live, len(self.replicas))
        self.max_count = max(self.max_count, len(self.replicas))

    def tasks(self):
        out = [
            ("restarter", self._restart()),
            ("autoscaler", self._autoscale()),
        ]
        if self.first == "autoscaler":
            out.reverse()
        return out

    def _restart(self):
        if self.locked:
            yield Op(
                "environment.scale", "write", "restart:lock",
                ready=lambda: self.scale_owner is None,
            )
            self.scale_owner = "restarter"
        # CHECKED precondition (the real rolling_restart): some OTHER
        # replica serves, else abort — never a blind stop.
        yield Op("controller.state", "read", "restart:precondition")
        if len(self.replicas) - (1 if "r0" in self.replicas else 0) < 1:
            self.aborted = True
            if self.locked:
                yield Op("environment.scale", "write", "restart:unlock")
                self.scale_owner = None
            return
        yield Op("controller.state", "write", "restart:stop(r0)")
        self.replicas.pop("r0", None)
        self._note()
        yield Op("controller.state", "write", "restart:respawn(r0)")
        self.replicas["r0"] = "serving"
        self._note()
        if self.locked:
            yield Op("environment.scale", "write", "restart:unlock")
            self.scale_owner = None

    def _autoscale(self):
        if self.locked:
            yield Op(
                "environment.scale", "write", "scale:lock",
                ready=lambda: self.scale_owner is None,
            )
            self.scale_owner = "autoscaler"
        yield Op("controller.state", "read", "scale:signals")
        count = len(self.replicas)
        if self.action == "spawn":
            decide = "spawn" if count < self.max_replicas else "hold"
        else:
            decide = "drain" if count > self.min_replicas else "hold"
        if decide == "spawn":
            yield Op("controller.state", "write", "scale:spawn(r2)")
            self.replicas["r2"] = "serving"
            self._note()
        elif decide == "drain":
            victim = "r1" if "r1" in self.replicas else None
            yield Op("controller.state", "write", f"scale:drop({victim})")
            if victim is not None:
                self.replicas.pop(victim, None)
            self._note()
        if self.locked:
            yield Op("environment.scale", "write", "scale:unlock")
            self.scale_owner = None

    def invariant(self, crashed: bool = False) -> None:
        assert self.max_count <= self.max_replicas, (
            f"autoscale band violated: replica count reached "
            f"{self.max_count} > max {self.max_replicas} — the spawn "
            "decision's count read went stale across the restart's "
            "stop/respawn window"
        )
        assert self.min_live >= 1, (
            "zero serving replicas at some instant: the autoscaler's "
            "drain landed while the rolling restart had its replica "
            "down"
        )
        if not self.aborted:
            assert "r0" in self.replicas, "restart never respawned r0"


class CompactorLeaseSwapModel:
    """The compaction lease protocol, explored exhaustively
    over the REAL persist Machine (MemBlob + MemConsensus, virtual
    lease clock): a writer appending mid-compaction, compactor A
    running acquire → merge → renew → fenced swap → delete/release, a
    rival compactor B trying to take the lease, a reader snapshotting
    the newest tick, and a clock step that expires every live lease.
    Crash branches land at the lease-renew and part-swap durable
    writes (the two writes whose residue — held lease + orphan merged
    part — a successor must tolerate).

    Invariants at every terminal AND crash state: the reader saw the
    exact per-tick oracle multiset; the durable shard equals the
    oracle at upper-1; every state-referenced part key is present in
    blob (a swap can never publish a batch whose parts a racing
    delete removed); after a crash the recovery compactor (virtual
    time far past expiry) always takes over the lease.
    """

    name = "compactor-lease-swap"
    daemons = ()

    def __init__(
        self, lease_s: float = 10.0, delete_before_swap: bool = False
    ):
        from ..repr.schema import Column, ColumnType, Schema
        from ..storage.persist import MemBlob, MemConsensus, PersistClient

        self.lease_s = lease_s
        # The tempting wrong order — delete the replaced parts BEFORE
        # the swap CaS. Its window: an append lands between merge and
        # swap, the swap loses the prefix race, and the state still
        # references the deleted parts. The explorer must find it
        # (tests/test_torch_interleave.py pins the violation).
        self.delete_before_swap = delete_before_swap
        self.client = PersistClient(MemBlob(), MemConsensus())
        self.writer = self.client.open_writer(
            "il",
            Schema(
                [
                    Column("k", ColumnType.INT64),
                    Column("v", ColumnType.INT64),
                ]
            ),
        )
        self.machine = self.writer.machine
        self.reader = self.client.open_reader("il", "model-reader")
        self.now = 0.0          # virtual lease clock (injected `now`)
        self.oracle: dict = {}
        self.oracle_at: dict = {}
        self.fenced = 0
        self.swapped = 0
        self.lost = 0
        self.rival_lease = None
        self.bad = None
        self.recovered = False
        for t in (0, 1):
            self._append(t)

    def _append(self, t: int) -> None:
        upd = [(t % 3, t, 1), (7, 7, 1)]
        ks = np.array([u[0] for u in upd], np.int64)
        vs = np.array([u[1] for u in upd], np.int64)
        self.writer.compare_and_append(
            [ks, vs],
            [None, None],
            np.full(len(upd), t, np.uint64),
            np.ones(len(upd), np.int64),
            t,
            t + 1,
        )
        for k, v, d in upd:
            self.oracle[(k, v)] = self.oracle.get((k, v), 0) + d
        self.oracle_at[t] = dict(self.oracle)

    @staticmethod
    def _ms(cols, diff) -> dict:
        ms: dict = {}
        for i in range(len(diff)):
            key = (int(cols[0][i]), int(cols[1][i]))
            c = ms.get(key, 0) + int(diff[i])
            if c:
                ms[key] = c
            else:
                ms.pop(key, None)
        return ms

    def tasks(self):
        return [
            ("writer", self._writer()),
            ("cmp-a", self._compactor()),
            ("cmp-b", self._rival()),
            ("reader", self._reader()),
            ("clock", self._clock()),
        ]

    def _writer(self):
        # An append racing the compactor's merge→swap window: the
        # swap's exact-prefix check makes it lose cleanly (lost += 1),
        # never drop the append.
        yield Op("persist.shard", "write", "writer:append(t=2)")
        self._append(2)

    def _compactor(self):
        from ..storage.persist.machine import CompactorFenced

        m = self.machine
        yield Op("persist.shard", "write", "cmp-a:acquire+merge")
        lease = m.acquire_compaction_lease(
            "cmp-a", self.lease_s, now=self.now
        )
        if lease is None:
            return  # rival holds a live lease: back off
        st = m.reload()
        if len(st.batches) < 2:
            m.release_compaction_lease(lease)
            return
        prefix = st.batches
        merged_key, n, old_keys = m._merge_parts(st, ctx="background")
        out_bytes = m._last_merge_bytes[1]
        yield Op(
            "persist.shard", "write", "cmp-a:renew-lease",
            crash_point=True,
        )
        if not m.renew_compaction_lease(lease, self.lease_s, now=self.now):
            self.fenced += 1
            m._delete_parts([merged_key] if n else [])
            return
        yield Op(
            "persist.shard", "write", "cmp-a:swap-compacted",
            crash_point=True,
        )
        if self.delete_before_swap:
            m._delete_parts(list(old_keys))
        try:
            replaced = m.swap_compacted(
                prefix, merged_key, n, out_bytes, epoch=lease
            )
        except CompactorFenced:
            self.fenced += 1
            m._delete_parts([merged_key] if n else [])
            return
        yield Op("persist.shard", "write", "cmp-a:delete+release")
        if replaced:
            self.swapped += 1
            m._delete_parts(old_keys)
        else:
            self.lost += 1
            m._delete_parts([merged_key] if n else [])
        m.release_compaction_lease(lease)

    def _rival(self):
        # A second compactor claiming the lease and then going silent
        # (SIGKILL analog): when it lands before cmp-a's renew/swap,
        # the epoch bump must fence cmp-a's merge out.
        yield Op("persist.shard", "write", "cmp-b:acquire")
        self.rival_lease = self.machine.acquire_compaction_lease(
            "cmp-b", self.lease_s, now=self.now
        )

    def _clock(self):
        # Virtual time jumps past every lease deadline: acquires after
        # this step treat any held lease as expired (takeover path).
        yield Op("persist.shard", "write", "clock:expire-leases")
        self.now += self.lease_s + 1.0

    def _reader(self):
        yield Op("persist.shard", "read", "reader:snapshot")
        st = self.machine.reload()
        as_of = st.upper - 1
        try:
            _, cols, _, _, diff = self.reader.snapshot(as_of)
        except ValueError as e:
            # CompactionRace that never heals = the state references
            # parts someone deleted; surface it via the invariant.
            self.bad = f"reader snapshot({as_of}) failed: {e}"
            return
        got = self._ms(cols, diff)
        if got != self.oracle_at[as_of]:
            self.bad = (
                f"reader snapshot({as_of}) = {got} != oracle "
                f"{self.oracle_at[as_of]}"
            )

    def on_crash(self) -> None:
        # Recovery: a successor compactor far past every lease expiry
        # must be able to take over whatever residue the crash left
        # (held lease, orphan merged part) and compact the shard.
        m = self.machine
        self.now += 1000.0
        lease = m.acquire_compaction_lease(
            "recovery", self.lease_s, now=self.now
        )
        assert lease is not None, (
            "recovery compactor could not acquire the lease after "
            "expiry — takeover is wedged"
        )
        st = m.reload()
        try:
            if len(st.batches) >= 2:
                prefix = st.batches
                merged_key, n, old_keys = m._merge_parts(
                    st, ctx="background"
                )
                if m.renew_compaction_lease(
                    lease, self.lease_s, now=self.now
                ):
                    replaced = m.swap_compacted(
                        prefix, merged_key, n,
                        m._last_merge_bytes[1], epoch=lease,
                    )
                    m._delete_parts(
                        old_keys if replaced
                        else ([merged_key] if n else [])
                    )
        except AssertionError:
            # A referenced part is already gone (the planted
            # delete-before-swap bug): leave the spine for the
            # invariant's dangling-reference check to report.
            pass
        m.release_compaction_lease(lease)
        self.recovered = True

    def invariant(self, crashed: bool = False) -> None:
        assert self.bad is None, self.bad
        st = self.machine.reload()
        # A published batch's parts must exist: swap-then-delete
        # ordering, and a fenced merge's cleanup can only delete its
        # own orphan.
        for k in sorted(st.referenced_keys()):
            assert self.machine.blob.get(k) is not None, (
                f"state references missing blob part {k!r}"
            )
        as_of = st.upper - 1
        _, cols, _, _, diff = self.client.open_reader("il").snapshot(
            as_of
        )
        got = self._ms(cols, diff)
        assert got == self.oracle_at[as_of], (
            f"durable shard at {as_of} = {got} != oracle "
            f"{self.oracle_at[as_of]} (swapped={self.swapped} "
            f"lost={self.lost} fenced={self.fenced})"
        )
        if crashed:
            assert self.recovered, "on_crash recovery did not run"


#: Named model factories for the CLI gate / chaos bridge. Values are
#: callables(**kwargs) -> fresh model.
MODELS = {
    "fencing": FencingModel,
    "set-crash-window": SetCrashModel,
    "close-wedge": WedgeModel,
    "reconcile": ReconcileModel,
    "peek-batcher": BatcherModel,
    "subscribe-drop": HubModel,
    "replica-drain-peek": DrainModel,
    "autoscale-band": ScaleBandModel,
    "compactor-lease-swap": CompactorLeaseSwapModel,
}


def registry_objects() -> set:
    """The scheduling-object vocabulary currently certified by the
    lock sanitizer — models SHOULD draw obj names from here when the
    real state is lock-guarded (keeps DPOR independence aligned with
    the certified lock structure)."""
    return lockcheck.registered_names()
