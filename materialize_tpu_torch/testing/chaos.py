"""Chaos harness: seeded fault injection over the crash-recovery spine.

The attack half of crash recovery. The recovery machinery (durable catalog +
restart replay, replica reconnection + nonce fencing, persist
compare-and-append) is only production-credible if it survives faults
injected ON PURPOSE, with exact oracles — not "it usually comes back".
This module composes three fault injectors:

- **UnreliableBlob** (storage/persist/location.py): a deterministic
  fraction of blob operations fail; every durable path must retry
  through ``retry_policy_durability`` and an acked write must never
  depend on a failed operation.
- **ChaosProxy**: a TCP proxy between controller and replica that
  drops connections, delays frames, and partitions the link on a
  seeded schedule — the CTP fault injector (the reference tests the
  same surface with toxiproxy-style partitions).
- **process kills**: subprocess replicas are SIGKILLed mid-span /
  mid-ingest / mid-DDL and respawned on the same port; the controller
  reconnects, replays history, and the replica re-hydrates from
  persist.

``ChaosDriver`` runs a retraction-storm + late-data workload against a
host-side oracle and checks EXACT invariants at the end (after
healing):

1. the maintained view's peeked result == the oracle multiset
   (zero lost acknowledged writes AND zero double-applied deltas — a
   multiset can only match exactly if neither happened);
2. the durable sink shard holds the same multiset (what a fresh
   replica would resume from);
3. ``rebuilds == 0`` for every dataflow whose description never
   changed (reconciliation as a counted invariant, via the replica
   recovery counters surfaced in mz_recovery).

Faults are scheduled by a seeded RNG so a failing run replays.

The port's copy of ``materialize_tpu/testing/chaos.py``. Everything
here runs on the host; what reaches the card is the replica it drives,
on the device each entry point is given (``device=``, default
``"cuda"``; ``--device`` for a replica process and for ``_main``).
"""

from __future__ import annotations

import os
import random
import socket
import subprocess
import sys
import threading
import time as _time
from dataclasses import dataclass, field

import numpy as np


# ---------------------------------------------------------------------------
# CTP fault injection: the chaos proxy
# ---------------------------------------------------------------------------


class ChaosProxy:
    """TCP proxy injecting control-plane faults between a controller
    and one replica. Connections accepted on ``port`` forward to
    ``target``; the seeded schedule decides which forwarded chunks die
    (connection reset mid-frame — the CRC/partial-frame path) and how
    long frames are delayed. ``partition()`` severs the link entirely
    until ``heal()``."""

    def __init__(
        self,
        target: tuple[str, int],
        seed: int = 0,
        kill_every: int = 0,
        delay_ms: float = 0.0,
    ):
        self.target = target
        self.kill_every = kill_every
        self.delay_ms = delay_ms
        self._rng = random.Random(seed)
        self._rng_lock = threading.Lock()
        self._stop = threading.Event()
        self._partitioned = threading.Event()
        self._conns: list = []
        self._conns_lock = threading.Lock()
        self.stats = {"accepted": 0, "chunks": 0, "killed": 0}
        self._listener = socket.socket()
        self._listener.setsockopt(
            socket.SOL_SOCKET, socket.SO_REUSEADDR, 1
        )
        self._listener.bind(("127.0.0.1", 0))
        self._listener.listen(8)
        self._listener.settimeout(0.2)
        self.port = self._listener.getsockname()[1]
        threading.Thread(target=self._accept_loop, daemon=True).start()

    @property
    def addr(self) -> tuple:
        return ("127.0.0.1", self.port)

    # -- fault controls -----------------------------------------------------
    def partition(self) -> None:
        """Sever the link: refuse new connections and kill live ones
        (both directions — the controller sees a dead socket, the
        replica sees its session drop)."""
        self._partitioned.set()
        self.kill_connections()

    def heal(self) -> None:
        self._partitioned.clear()

    def kill_connections(self) -> None:
        from ..coord.protocol import hard_close

        with self._conns_lock:
            doomed, self._conns = self._conns, []
        for s in doomed:
            # shutdown-then-close: pump threads blocked in recv on
            # these sockets must wake with EOF (a bare close defers
            # while they hold the socket — the exact hazard the proxy
            # exists to inject, not to suffer).
            hard_close(s)
        if doomed:
            self.stats["killed"] += 1

    def stop(self) -> None:
        self._stop.set()
        self.kill_connections()
        try:
            self._listener.close()
        except OSError:
            pass

    # -- plumbing -----------------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                client, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            if self._partitioned.is_set():
                client.close()
                continue
            try:
                upstream = socket.create_connection(
                    self.target, timeout=5.0
                )
            except OSError:
                client.close()
                continue
            self.stats["accepted"] += 1
            with self._conns_lock:
                self._conns.extend((client, upstream))
            for src, dst in ((client, upstream), (upstream, client)):
                threading.Thread(
                    target=self._pump, args=(src, dst), daemon=True
                ).start()

    def _pump(self, src: socket.socket, dst: socket.socket) -> None:
        pair = (src, dst)
        try:
            while not self._stop.is_set():
                data = src.recv(65536)
                if not data:
                    break
                self.stats["chunks"] += 1
                if self.delay_ms:
                    _time.sleep(self.delay_ms / 1000.0)
                if self.kill_every:
                    with self._rng_lock:
                        die = (
                            self._rng.randrange(self.kill_every) == 0
                        )
                    if die:
                        # Mid-frame reset: the receiver sees a torn
                        # frame, both sides reconnect.
                        break
                dst.sendall(data)
        except OSError:
            pass
        finally:
            from ..coord.protocol import hard_close

            for s in pair:
                hard_close(s)


# ---------------------------------------------------------------------------
# replica process management
# ---------------------------------------------------------------------------


def subprocess_available() -> bool:
    """Whether this host can spawn replica subprocesses (the chaos
    lane skips cleanly where it cannot — sandboxes without fork)."""
    try:
        p = subprocess.Popen(
            [sys.executable, "-c", "pass"],
            stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL,
        )
        p.wait(timeout=30)
        return p.returncode == 0
    except Exception:
        return False


class ReplicaProcess:
    """One subprocess replica (clusterd) that can be SIGKILLed and
    respawned on the same port."""

    def __init__(self, blob: str, consensus: str, port: int,
                 rid: str = "r0", device: str = "cuda"):
        self.blob = blob
        self.device = device
        self.consensus = consensus
        self.port = port
        self.rid = rid
        self.proc: subprocess.Popen | None = None
        self.kills = 0
        self.spawn()

    def spawn(self) -> None:
        self.proc = subprocess.Popen(
            [
                sys.executable, "-m", "materialize_tpu_torch.coord.replica",
                "--port", str(self.port),
                "--blob", self.blob,
                "--consensus", self.consensus,
                "--replica-id", self.rid,
                "--device", str(self.device),
            ],
            stdout=subprocess.DEVNULL,
            stderr=subprocess.STDOUT,
        )

    def sigkill(self) -> None:
        if self.proc is not None:
            self.proc.kill()
            self.proc.wait()
            self.kills += 1

    def sigkill_and_respawn(self) -> None:
        self.sigkill()
        self.spawn()

    def stop(self) -> None:
        if self.proc is not None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()


# ---------------------------------------------------------------------------
# the storm: ChaosDriver
# ---------------------------------------------------------------------------


@dataclass
class ChaosReport:
    ops: int = 0
    inserts: int = 0
    retractions: int = 0
    late: int = 0
    acked_times: int = 0
    replica_kills: int = 0
    partitions: int = 0
    conn_kills: int = 0
    blob_fail_every: int = 0
    failures: list = field(default_factory=list)
    oracle: dict = field(default_factory=dict)
    result: dict = field(default_factory=dict)
    sink: dict = field(default_factory=dict)
    recovery: dict = field(default_factory=dict)
    hydration: list = field(default_factory=list)
    elapsed_s: float = 0.0

    @property
    def ok(self) -> bool:
        return not self.failures


def _mk_kv_schema():
    from ..repr.schema import Column, ColumnType, Schema

    return Schema(
        [Column("k", ColumnType.INT64), Column("v", ColumnType.INT64)]
    )


def _sum_by_k(schema):
    from ..expr import relation as mir
    from ..expr.relation import AggregateExpr, AggregateFunc
    from ..expr.scalar import col

    return mir.Get("kv", schema).reduce(
        (0,), (AggregateExpr(AggregateFunc.SUM_INT, col(1)),)
    )


class ChaosDriver:
    """A controller + one replica (thread or subprocess) joined
    through a ChaosProxy, over optionally-unreliable blob storage.
    ``run_storm`` feeds a seeded retraction storm with late data into
    the ``kv`` shard while injecting scheduled faults, then verifies
    the exact invariants."""

    def __init__(
        self,
        data_dir: str,
        seed: int = 0,
        subprocess_replica: bool = False,
        blob_fail_every: int = 0,
        proxy_kill_every: int = 0,
        device: str = "cuda",
    ):
        from ..coord.controller import ComputeController
        from ..coord.protocol import DataflowDescription, PersistLocation
        from ..storage.persist import (
            FileBlob,
            PersistClient,
            SqliteConsensus,
            UnreliableBlob,
        )

        os.makedirs(data_dir, exist_ok=True)
        self.rng = random.Random(seed)
        self.blob_path = os.path.join(data_dir, "blob")
        self.cons_path = os.path.join(data_dir, "consensus.db")
        blob = FileBlob(self.blob_path)
        if blob_fail_every:
            blob = UnreliableBlob(blob, fail_every=blob_fail_every)
        self.persist = PersistClient(
            blob, SqliteConsensus(self.cons_path)
        )
        self.schema = _mk_kv_schema()
        self.writer = self.persist.open_writer("kv", self.schema)
        self.report = ChaosReport(blob_fail_every=blob_fail_every)

        # Replica: subprocess (SIGKILL-able) or in-process thread.
        port = _free_port()
        self.replica_proc: ReplicaProcess | None = None
        self._replica_worker = None
        if subprocess_replica:
            self.replica_proc = ReplicaProcess(
                self.blob_path, self.cons_path, port, device=device
            )
        else:
            from ..coord.replica import serve_forever

            ready = threading.Event()
            threading.Thread(
                target=serve_forever,
                args=(
                    port,
                    PersistLocation(self.blob_path, self.cons_path),
                    "r0",
                    ready,
                ),
                kwargs={"device": device},
                daemon=True,
            ).start()
            ready.wait(10)

        self.proxy = ChaosProxy(
            ("127.0.0.1", port),
            seed=seed ^ 0x5EED,
            kill_every=proxy_kill_every,
        )
        self.ctl = ComputeController()
        self.ctl.add_replica("r0", self.proxy.addr)
        self.desc = DataflowDescription(
            name="mv_sums",
            expr=_sum_by_k(self.schema),
            source_imports={"kv": ("kv", self.schema)},
            sink_shard="mv_sums_out",
        )
        self.ctl.create_dataflow(self.desc)
        # Oracle: the net multiset of (k, v) rows ever acked. The MV
        # result oracle derives from it (sum v per k).
        self.oracle: dict = {}

    # -- workload -----------------------------------------------------------
    def _feed(self, t: int, ups: list) -> None:
        """One acked write: compare_and_append returning IS the ack —
        once it returns, every later invariant treats these rows as
        durable truth."""
        k = np.array([p[0] for p in ups], np.int64)
        v = np.array([p[1] for p in ups], np.int64)
        d = np.array([p[2] for p in ups], np.int64)
        self.writer.compare_and_append(
            [k, v], [None, None],
            np.full(len(ups), t, np.uint64), d, t, t + 1,
        )
        for key, val, diff in ups:
            self.oracle[(key, val)] = (
                self.oracle.get((key, val), 0) + diff
            )
            if self.oracle[(key, val)] == 0:
                del self.oracle[(key, val)]
        self.report.acked_times += 1
        self.report.inserts += sum(1 for u in ups if u[2] > 0)
        self.report.retractions += sum(1 for u in ups if u[2] < 0)

    def run_storm(
        self,
        ticks: int = 60,
        keys: int = 8,
        fault_plan: dict | None = None,
    ) -> ChaosReport:
        """The retraction-storm + late-data workload. Per tick: a
        burst of inserts, retractions of rows inserted earlier
        (sampled from the live oracle — every retraction is valid),
        and LATE re-inserts of long-retracted rows. ``fault_plan``
        maps tick -> a list of fault actions:
        ``"kill_conns"``, ``("partition", n_ticks)``,
        ``"kill_replica"`` (subprocess mode only), ``"ddl"``
        (install + drop a second dataflow mid-storm)."""
        t0 = _time.monotonic()
        fault_plan = fault_plan or {}
        heal_at = -1
        live_retracted: list = []
        for t in range(ticks):
            for action in _actions_at(fault_plan, t):
                if action == "kill_conns":
                    self.proxy.kill_connections()
                    self.report.conn_kills += 1
                elif (
                    isinstance(action, tuple)
                    and action[0] == "partition"
                ):
                    self.proxy.partition()
                    self.report.partitions += 1
                    heal_at = t + action[1]
                elif action == "kill_replica":
                    if self.replica_proc is not None:
                        # Pace the kill so it lands MID-SPAN: wait
                        # (bounded) until the replica has caught up to
                        # the storm — killing a replica that never
                        # even connected proves nothing about span
                        # recovery. The wait is best-effort; a replica
                        # that cannot catch up gets killed anyway, and
                        # at once behind a partition, which heals only
                        # at a later tick of this loop (the reference
                        # waits out its whole 240 s bound there).
                        deadline = _time.monotonic() + 240.0
                        while (
                            self.ctl.any_frontier("mv_sums") < t
                            and not self.proxy._partitioned.is_set()
                            and _time.monotonic() < deadline
                        ):
                            _time.sleep(0.02)
                        self.replica_proc.sigkill_and_respawn()
                        self.report.replica_kills += 1
                elif action == "ddl":
                    # Mid-storm DDL: a second dataflow installs (and
                    # must come back after any concurrent fault).
                    self._mid_storm_ddl(t)
            if heal_at == t:
                self.proxy.heal()
            ups = []
            # Insert burst.
            for _ in range(self.rng.randrange(1, 4)):
                k = self.rng.randrange(keys)
                v = self.rng.randrange(100)
                ups.append((k, v, 1))
            # Retraction storm: retract currently-live rows.
            live = list(self.oracle.items())
            if live and self.rng.random() < 0.7:
                (rk, rv), _n = self.rng.choice(live)
                ups.append((rk, rv, -1))
                live_retracted.append((rk, rv))
            # Late data: re-insert a row retracted long ago.
            if live_retracted and self.rng.random() < 0.3:
                lk, lv = live_retracted.pop(0)
                ups.append((lk, lv, 1))
                self.report.late += 1
            self._feed(t, ups)
        if heal_at >= ticks:
            # heal_at == ticks included: the in-loop heal only fires
            # for t < ticks, so a partition whose duration lands
            # exactly on the last tick must heal here or the link
            # stays severed after the storm returns.
            self.proxy.heal()
        self.report.ops = ticks
        self.report.elapsed_s = _time.monotonic() - t0
        return self.report

    def _mid_storm_ddl(self, t: int) -> None:
        from ..coord.protocol import DataflowDescription

        name = f"mv_ddl_{t}"
        self.ctl.create_dataflow(
            DataflowDescription(
                name=name,
                expr=_sum_by_k(self.schema),
                source_imports={"kv": ("kv", self.schema)},
                sink_shard=None,
            )
        )
        self.ctl.drop_dataflow(name)

    # -- verification -------------------------------------------------------
    def expected_sums(self) -> dict:
        """The MV oracle: SUM(v) per key over the net acked multiset
        (oracle entries are always live rows — zero-count pairs are
        deleted on retraction — so every key present has a group)."""
        sums: dict = {}
        for (k, v), n in self.oracle.items():
            sums[k] = sums.get(k, 0) + v * n
        return {(k, s): 1 for k, s in sums.items()}

    def verify(self, timeout: float = 180.0) -> ChaosReport:
        """Heal every fault, wait for the frontier, and check the
        exact invariants. Appends human-readable failure descriptions
        to the report instead of raising — the caller asserts
        ``report.ok`` so a failed storm prints the whole picture."""
        rep = self.report
        self.proxy.heal()
        # Stop injecting blob faults for the verification reads (the
        # retry machinery was the thing under test during the storm).
        blob = self.persist.blob
        if hasattr(blob, "fail_every"):
            blob.fail_every = 0
        frontier = self.writer.upper
        try:
            deadline = _time.monotonic() + timeout
            while self.ctl.any_frontier("mv_sums") < frontier:
                if _time.monotonic() > deadline:
                    raise TimeoutError(
                        f"mv_sums frontier stuck at "
                        f"{self.ctl.any_frontier('mv_sums')} < "
                        f"{frontier}"
                    )
                _time.sleep(0.01)
            rows, _ = self.ctl.peek(
                "mv_sums", as_of=frontier - 1, timeout=timeout
            )
        except Exception as e:
            rep.failures.append(f"verification peek failed: {e!r}")
            rep.recovery = self.ctl.recovery_snapshot()
            return rep
        got: dict = {}
        for r in rows:
            got[r[:-2]] = got.get(r[:-2], 0) + r[-1]
        got = {k: n for k, n in got.items() if n}
        expect = self.expected_sums()
        rep.oracle = expect
        rep.result = got
        if got != expect:
            missing = {k: n for k, n in expect.items() if got.get(k) != n}
            extra = {k: n for k, n in got.items() if expect.get(k) != n}
            rep.failures.append(
                "peeked result diverged from oracle (lost ack or "
                f"double-applied delta): missing={missing} "
                f"extra={extra}"
            )
        # The durable sink must hold the identical multiset: that is
        # what any FUTURE replica resumes from.
        try:
            reader = self.persist.open_reader("mv_sums_out", "chaos-verify")
            try:
                _sch, cols, _nulls, _t2, diff = reader.snapshot(
                    frontier - 1
                )
            finally:
                reader.expire()
            sink: dict = {}
            for i in range(len(diff)):
                key = tuple(int(c[i]) for c in cols)
                sink[key] = sink.get(key, 0) + int(diff[i])
            sink = {k: n for k, n in sink.items() if n}
            rep.sink = sink
            if sink != expect:
                rep.failures.append(
                    f"durable sink diverged from oracle: {sink} != "
                    f"{expect}"
                )
        except Exception as e:
            rep.failures.append(f"sink verification failed: {e!r}")
        # Counted reconciliation: no description ever changed, so NO
        # dataflow may report a rebuild — reconnects and kills must
        # resolve through reconciliation (surviving replica) or fresh
        # installs (respawned process), never silent rebuilds.
        rep.recovery = self.ctl.recovery_snapshot()
        for df, per in rep.recovery["dataflows"].items():
            for r, v in per.items():
                if int(v.get("rebuilds", 0)) != 0:
                    rep.failures.append(
                        f"dataflow {df!r} on {r} reports "
                        f"{v['rebuilds']} rebuild(s); fingerprints "
                        "never changed, so reconciliation should have "
                        "kept it"
                    )
        # Freshness-plane status transitions: after the
        # storm heals, every CONNECTED replica's mv_sums must end
        # hydrated on the controller's hydration board — a terminal
        # `stalled`/`pending` after a verified-correct run means the
        # status machine lost a transition.
        rep.hydration = self.ctl.hydration_snapshot()
        connected = {
            r
            for r, rc in self.ctl.replicas.items()
            if rc.connected.is_set()
        }
        seen = set()
        for df, r, status, _since, _att, error in rep.hydration:
            if df != "mv_sums" or r not in connected:
                continue
            seen.add(r)
            if status != "hydrated":
                rep.failures.append(
                    f"hydration status of mv_sums on connected "
                    f"replica {r} ended {status!r} "
                    f"(error={error!r}); expected hydrated"
                )
        for r in connected - seen:
            rep.failures.append(
                f"connected replica {r} has no mv_sums hydration "
                "status entry"
            )
        return rep

    def shutdown(self) -> None:
        try:
            self.ctl.shutdown()
        except Exception:
            pass
        self.proxy.stop()
        if self.replica_proc is not None:
            self.replica_proc.stop()


def _actions_at(plan: dict, t: int) -> list:
    got = plan.get(t, [])
    if not isinstance(got, list):
        got = [got]
    return got


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def seeded_fault_plan(
    seed: int,
    ticks: int,
    conn_kills: int = 2,
    partitions: int = 1,
    replica_kills: int = 0,
    ddls: int = 1,
) -> dict:
    """A deterministic fault schedule: fault ticks drawn without
    replacement from the storm's middle third outward, so faults land
    while state is nontrivial and the tail leaves room to recover."""
    rng = random.Random(seed ^ 0xC4A05)
    plan: dict = {}
    lo, hi = max(1, ticks // 6), max(2, ticks - 2)
    candidates = list(range(lo, hi))
    rng.shuffle(candidates)

    def take(action, n):
        for _ in range(n):
            if not candidates:
                return
            plan.setdefault(candidates.pop(), []).append(action)

    take("kill_conns", conn_kills)
    take(("partition", max(2, ticks // 10)), partitions)
    take("kill_replica", replica_kills)
    take("ddl", ddls)
    return plan


# ---------------------------------------------------------------------------
# explorer trace replay: an interleaving trace -> fault plan
# ---------------------------------------------------------------------------


def trace_seed(trace: dict) -> int:
    """Deterministic storm seed for an explorer trace: crc32 of the
    minimal schedule, so the same violation always replays the same
    wall-clock storm."""
    import zlib

    schedule = trace.get("schedule") or [
        s.get("task", "") for s in trace.get("steps", [])
    ]
    return zlib.crc32("|".join(schedule).encode()) & 0x7FFFFFFF


def fault_plan_from_trace(trace: dict, ticks: int) -> dict:
    """Map an explorer schedule trace (``interleave.Violation
    .to_trace()``) onto this harness's fault plan.

    The explorer runs a virtual-time model, so its step indices become
    tick positions: step *i* of an *n*-step minimal schedule lands at
    the proportional tick inside the same middle-third-outward window
    ``seeded_fault_plan`` uses. Three things transfer:

    - ``Op(chaos=...)`` tags become that chaos action at the step's
      tick (JSON round-trips tuples to lists; both are accepted);
    - a crash branch (``crash_after``) becomes ``kill_conns`` at the
      crash step's tick — abrupt connection death is the wall-clock
      analogue of the model stopping at a durable-write boundary;
    - the residual storm (background DDL churn, extra conn kills)
      comes from ``seeded_fault_plan`` keyed on :func:`trace_seed`,
      merged in, so the replay exercises the full harness even for
      traces that tag no faults of their own.
    """
    steps = trace.get("steps") or []
    lo, hi = max(1, ticks // 6), max(2, ticks - 2)
    span = max(1, hi - lo)
    n = max(1, len(steps))

    def tick_for(i: int) -> int:
        return min(hi - 1, lo + (int(i) * span) // n)

    plan: dict = {}
    for i, s in enumerate(steps):
        action = s.get("chaos")
        if action is None:
            continue
        if isinstance(action, list):
            action = tuple(action)
        plan.setdefault(tick_for(i), []).append(action)
    crash_after = trace.get("crash_after")
    if crash_after is not None:
        plan.setdefault(tick_for(crash_after), []).append("kill_conns")
    base = seeded_fault_plan(trace_seed(trace), ticks)
    for t, actions in base.items():
        plan.setdefault(t, []).extend(actions)
    return plan


# ---------------------------------------------------------------------------
# the subscriber storm: push-plane lifecycle under churn
# ---------------------------------------------------------------------------


@dataclass
class SubscriberStormReport:
    """Push-plane chaos outcome: clients die abruptly mid-storm (raw
    socket close, SIGKILL'd subprocesses, mid-snapshot drops) while
    ingest churns; at the end every SURVIVING session's replayed
    stream must reconstruct the exact oracle multiset, and closing the
    last session must leave NO leaked dataflows, tails, or persist
    readers — the drop-exactly-once invariant as a counted check."""

    subscribers: int = 0
    pgwire_clients: int = 0
    sigkill_clients: int = 0
    killed_sessions: int = 0
    killed_sockets: int = 0
    ticks: int = 0
    installs: int = 0
    readbacks: int = 0
    spans: int = 0
    failures: list = field(default_factory=list)
    oracle: dict = field(default_factory=dict)
    elapsed_s: float = 0.0

    @property
    def ok(self) -> bool:
        return not self.failures


def _pg_startup(sock) -> None:
    import struct

    payload = struct.pack("!I", 196608) + b"user\x00chaos\x00\x00"
    sock.sendall(struct.pack("!I", len(payload) + 4) + payload)
    # Read until ReadyForQuery ('Z').
    buf = b""
    while True:
        chunk = sock.recv(4096)
        if not chunk:
            raise ConnectionError("server closed during startup")
        buf += chunk
        if b"Z" in buf[-16:]:
            return


def _pg_subscribe(port: int, sql: str):
    """A raw pgwire client mid-SUBSCRIBE: startup, send the query,
    read the CopyOutResponse, return the live socket (the caller
    kills it abruptly)."""
    import struct

    sock = socket.create_connection(("127.0.0.1", port), 10)
    _pg_startup(sock)
    payload = sql.encode() + b"\x00"
    sock.sendall(b"Q" + struct.pack("!I", len(payload) + 4) + payload)
    sock.settimeout(10.0)
    tag = sock.recv(1)
    assert tag == b"H", f"expected CopyOutResponse, got {tag!r}"
    (length,) = struct.unpack("!I", sock.recv(4))
    got = b""
    while len(got) < length - 4:
        got += sock.recv(length - 4 - len(got))
    sock.settimeout(None)
    return sock


_SIGKILL_CLIENT_SRC = """
import socket, struct, sys, time
sock = socket.create_connection(("127.0.0.1", int(sys.argv[1])), 10)
payload = struct.pack("!I", 196608) + b"user\\x00chaos\\x00\\x00"
sock.sendall(struct.pack("!I", len(payload) + 4) + payload)
buf = b""
while b"Z" not in buf[-16:]:
    buf += sock.recv(4096)
q = sys.argv[2].encode() + b"\\x00"
sock.sendall(b"Q" + struct.pack("!I", len(q) + 4) + q)
print("streaming", flush=True)
while True:
    if not sock.recv(65536):
        break
"""


def run_subscriber_storm(
    data_dir: str,
    seed: int = 0,
    ticks: int = 24,
    subscribers: int = 12,
    kills: int = 4,
    pgwire_clients: int = 3,
    sigkill_clients: int = 0,
    device: str = "cuda",
) -> SubscriberStormReport:
    """Drive a coordinator + replica + pgwire server with a mixed
    subscriber population (hub sessions on a SHARED query dataflow,
    direct table tails, raw pgwire COPY-out clients) under seeded
    insert/retraction churn, killing a seeded subset abruptly
    mid-storm (including one mid-snapshot). Verifies exact delivery
    on every survivor and zero leaked dataflows/tails/readers after
    the last close."""
    from ..coord.coordinator import Coordinator
    from ..coord.protocol import PersistLocation
    from ..coord.replica import serve_forever
    from ..server.pgwire import PgServer
    from ..storage.persist import (
        FileBlob,
        PersistClient,
        SqliteConsensus,
    )

    t0 = _time.monotonic()
    rng = random.Random(seed ^ 0x5B5C)
    os.makedirs(data_dir, exist_ok=True)
    loc = PersistLocation(
        os.path.join(data_dir, "blob"),
        os.path.join(data_dir, "consensus.db"),
    )
    port = _free_port()
    ready = threading.Event()
    threading.Thread(
        target=serve_forever, args=(port, loc, "r0", ready),
        kwargs={"device": device}, daemon=True,
    ).start()
    ready.wait(10)
    coord = Coordinator(
        PersistClient(
            FileBlob(loc.blob_root), SqliteConsensus(loc.consensus_path)
        ),
        tick_interval=None,
        device=device,
    )
    coord.add_replica("r0", ("127.0.0.1", port))
    pg = PgServer(coord).start()
    rep = SubscriberStormReport(
        subscribers=subscribers,
        pgwire_clients=pgwire_clients,
        sigkill_clients=sigkill_clients,
        ticks=ticks,
    )
    procs: list = []
    sockets: list = []
    try:
        coord.execute(
            "CREATE TABLE kv (k BIGINT NOT NULL, v BIGINT NOT NULL)"
        )
        coord.execute("INSERT INTO kv VALUES (0, 0)")
        # Generous queue: survivors drain only at the end.
        coord.update_config({"subscribe_queue_depth": 1_000_000})
        query_sql = "SUBSCRIBE TO (SELECT k, v FROM kv WHERE k >= 0)"
        sessions = []
        for i in range(subscribers):
            sql = query_sql if i % 2 == 0 else "SUBSCRIBE kv"
            sessions.append(coord.execute(sql).subscription)
        for _ in range(pgwire_clients):
            sockets.append(_pg_subscribe(pg.port, "SUBSCRIBE kv"))
        if sigkill_clients and subprocess_available():
            for _ in range(sigkill_clients):
                p = subprocess.Popen(
                    [sys.executable, "-c", _SIGKILL_CLIENT_SRC,
                     str(pg.port), "SUBSCRIBE kv"],
                    stdout=subprocess.PIPE,
                    stderr=subprocess.DEVNULL,
                )
                p.stdout.readline()  # "streaming": mid-COPY-out
                procs.append(p)
        # One client dies MID-SNAPSHOT: subscribe and kill before
        # reading a single CopyData frame.
        mid_snap = socket.create_connection(("127.0.0.1", pg.port), 10)
        _pg_startup(mid_snap)
        import struct as _struct

        q = b"SUBSCRIBE kv\x00"
        mid_snap.sendall(
            b"Q" + _struct.pack("!I", len(q) + 4) + q
        )
        from ..coord.protocol import hard_close

        hard_close(mid_snap)
        rep.killed_sockets += 1
        # The storm: seeded inserts + retraction bursts, with abrupt
        # client deaths interleaved.
        oracle: dict = {(0, 0): 1}
        kill_ticks = set(
            rng.sample(range(2, max(3, ticks - 2)),
                       min(kills, max(1, ticks - 4)))
        )
        live = [(0, 0)]
        for t in range(ticks):
            ups = []
            for _ in range(rng.randrange(1, 4)):
                k, v = rng.randrange(6), rng.randrange(100)
                ups.append(f"({k}, {v})")
                oracle[(k, v)] = oracle.get((k, v), 0) + 1
                live.append((k, v))
            coord.execute(
                "INSERT INTO kv VALUES " + ", ".join(ups)
            )
            if live and rng.random() < 0.5:
                rk, rv = rng.choice(live)
                n = oracle.pop((rk, rv), 0)
                if n:
                    coord.execute(
                        f"DELETE FROM kv WHERE k = {rk} AND v = {rv}"
                    )
                live = [p for p in live if p != (rk, rv)]
            if t in kill_ticks:
                victim = rng.randrange(3)
                if victim == 0 and len(sessions) > 2:
                    # Abrupt session close (the wire layer died).
                    sessions.pop(
                        rng.randrange(len(sessions))
                    ).close()
                    rep.killed_sessions += 1
                elif victim == 1 and sockets:
                    hard_close(sockets.pop(rng.randrange(len(sockets))))
                    rep.killed_sockets += 1
                elif procs:
                    p = procs.pop(rng.randrange(len(procs)))
                    p.kill()
                    p.wait()
                    rep.killed_sockets += 1
        rep.oracle = dict(oracle)
        # Wait until the final frontier reaches every surviving
        # session, then verify reconstruction: snapshot chunks RESET
        # state, delta chunks apply.
        final = coord._table_writers["kv"].upper
        deadline = _time.monotonic() + 120.0
        for s in sessions:
            state: dict = {}
            while s.frontier < final:
                if _time.monotonic() > deadline:
                    rep.failures.append(
                        f"session {s.session_id} stuck at frontier "
                        f"{s.frontier} < {final}"
                    )
                    break
                if not s.wait(1.0):
                    continue
                for kind, events, _up, _st in s.pop_ready():
                    if kind == "snapshot":
                        state = {}
                    for ev in events:
                        key = tuple(ev[:-2])
                        state[key] = state.get(key, 0) + ev[-1]
            for kind, events, _up, _st in s.pop_ready():
                if kind == "snapshot":
                    state = {}
                for ev in events:
                    key = tuple(ev[:-2])
                    state[key] = state.get(key, 0) + ev[-1]
            got = {k: n for k, n in state.items() if n}
            if got != oracle:
                rep.failures.append(
                    f"session {s.session_id} diverged: "
                    f"missing={ {k: n for k, n in oracle.items() if got.get(k) != n} } "
                    f"extra={ {k: n for k, n in got.items() if oracle.get(k) != n} }"
                )
        snap = coord.subscribe_hub.snapshot()
        rep.installs = snap["installs"]
        rep.readbacks = snap["readbacks"]
        rep.spans = snap["spans"]
        if snap["installs"] > 1:
            rep.failures.append(
                f"{snap['installs']} dataflow installs for ONE shared "
                "query (expected exactly 1)"
            )
        if snap["spans"] and snap["readbacks"] != snap["spans"]:
            rep.failures.append(
                f"readbacks {snap['readbacks']} != spans "
                f"{snap['spans']}: the one-readback-per-span "
                "invariant broke"
            )
        # Close every survivor; the pgwire/SIGKILL clients' sessions
        # must have been reaped by their wire loops already (bounded
        # wait: half-close detection is event-driven, not instant).
        for s in sessions:
            s.close()
        for sock in sockets:
            hard_close(sock)
        for p in procs:
            p.kill()
            p.wait()
        deadline = _time.monotonic() + 30.0
        while (
            coord.subscribe_hub.session_count()
            and _time.monotonic() < deadline
        ):
            _time.sleep(0.05)
        leaked_sessions = coord.subscribe_hub.session_count()
        if leaked_sessions:
            rep.failures.append(
                f"{leaked_sessions} sessions leaked after every "
                "client died"
            )
        with coord.subscribe_hub._lock:
            leaked_tails = list(coord.subscribe_hub._tails)
        if leaked_tails:
            rep.failures.append(f"tails leaked: {leaked_tails}")
        with coord.controller._lock:
            leaked_dfs = [
                n for n in coord.controller._dataflows
                if n.startswith("sub")
            ]
        if leaked_dfs:
            rep.failures.append(
                f"subscription dataflows leaked: {leaked_dfs}"
            )
        drops = coord.subscribe_hub.stats["drops"]
        if drops != rep.installs:
            rep.failures.append(
                f"drop-exactly-once violated: {rep.installs} installs "
                f"vs {drops} drops"
            )
        for shard, machine in coord.persist._machines.items():
            holds = [
                r
                for r, _s in machine.reload().reader_holds
                if r.startswith("subtail-")
            ]
            if holds:
                rep.failures.append(
                    f"persist readers leaked on {shard!r}: {holds}"
                )
    finally:
        for p in procs:
            try:
                p.kill()
                p.wait()
            except Exception:
                pass
        pg.stop()
        coord.shutdown()
    rep.elapsed_s = _time.monotonic() - t0
    return rep


# ---------------------------------------------------------------------------
# the failover storm: routed reads under replica SIGKILL
# ---------------------------------------------------------------------------


@dataclass
class FailoverStormReport:
    """Elastic-serving chaos outcome: N replicas serve routed reads
    while ingest churns; the routed-to replica is killed MID-PEEK
    (paced: the kill waits until a read is registered in flight
    against it) and every client-visible result must still equal the
    host-side oracle exactly — the failover re-dispatch plus the
    first-response-wins dedup make a duplicate or a lost waiter
    impossible, and this report counts both."""

    replicas: int = 0
    ticks: int = 0
    kills: int = 0
    killed: list = field(default_factory=list)
    routed_before: str | None = None
    routed_after: str | None = None
    failovers: int = 0
    routed_peeks: int = 0
    fallback_broadcasts: int = 0
    retried_statements: int = 0
    reader_queries: int = 0
    route_changes: int = 0
    failures: list = field(default_factory=list)
    oracle: dict = field(default_factory=dict)
    result: dict = field(default_factory=dict)
    subscribe: dict = field(default_factory=dict)
    inflight_rows: int = -1
    elapsed_s: float = 0.0

    @property
    def ok(self) -> bool:
        return not self.failures


def run_failover_storm(
    data_dir: str,
    seed: int = 0,
    ticks: int = 20,
    replicas: int = 3,
    subprocess_replicas: bool = True,
    verify_timeout: float = 180.0,
    device: str = "cuda",
) -> FailoverStormReport:
    """Drive a coordinator + N replicas with routed reads under
    insert/retraction churn, SIGKILL the replica the controller is
    routing to while a peek is IN FLIGHT against it, and verify:

    1. the in-flight peek resolves through failover with the EXACT
       rows its as_of implies (no lost waiter, no duplicate rows —
       a double-delivered response would double the multiset);
    2. every storm statement succeeds with at most one retried
       statement total (zero client-visible errors otherwise);
    3. the final peeked result and a SUBSCRIBE session's reconstructed
       state both equal the oracle multiset exactly;
    4. the routing target after the kill is a surviving replica.

    ``subprocess_replicas=False`` runs in-process workers (kill =
    ``worker.stop()``, which hard-closes the live session — the same
    disconnect edge, minus the SIGKILL) so the smoke gate can run
    where fork is unavailable.
    """
    from ..coord.coordinator import Coordinator
    from ..coord.protocol import PersistLocation
    from ..coord.replica import serve_forever
    from ..storage.persist import (
        FileBlob,
        PersistClient,
        SqliteConsensus,
    )

    t0 = _time.monotonic()
    rng = random.Random(seed ^ 0xFA170)
    os.makedirs(data_dir, exist_ok=True)
    blob_path = os.path.join(data_dir, "blob")
    cons_path = os.path.join(data_dir, "consensus.db")
    rep = FailoverStormReport(replicas=replicas, ticks=ticks)

    records: dict[str, dict] = {}
    for i in range(replicas):
        rid = f"r{i}"
        port = _free_port()
        if subprocess_replicas:
            records[rid] = {
                "port": port,
                "proc": ReplicaProcess(
                    blob_path, cons_path, port, rid=rid, device=device
                ),
                "worker": None,
            }
        else:
            handle: list = []
            ready = threading.Event()
            threading.Thread(
                target=serve_forever,
                args=(
                    port,
                    PersistLocation(blob_path, cons_path),
                    rid,
                    ready,
                ),
                kwargs={"handle": handle, "device": device},
                daemon=True,
            ).start()
            ready.wait(10)
            records[rid] = {
                "port": port,
                "proc": None,
                "worker": handle[0] if handle else None,
            }

    coord = Coordinator(
        PersistClient(FileBlob(blob_path), SqliteConsensus(cons_path)),
        tick_interval=None,
        device=device,
    )
    for rid, rec in records.items():
        coord.add_replica(rid, ("127.0.0.1", rec["port"]))
    ctl = coord.controller

    def _kill(rid: str) -> None:
        rec = records[rid]
        if rec["proc"] is not None:
            rec["proc"].sigkill()
        elif rec["worker"] is not None:
            rec["worker"].stop()
        rep.killed.append(rid)
        rep.kills += 1

    oracle: dict = {}

    def expect_sums(state: dict) -> dict:
        sums: dict = {}
        for (k, v), n in state.items():
            sums[k] = sums.get(k, 0) + v * n
        return {(k, s): 1 for k, s in sums.items()}

    def ex(sql: str):
        try:
            return coord.execute(sql)
        except Exception:
            # The acceptance budget: at most ONE retried statement
            # across the whole storm; a second failure is terminal.
            rep.retried_statements += 1
            try:
                return coord.execute(sql)
            except Exception as e2:
                rep.failures.append(
                    f"statement failed after retry: {sql!r}: {e2!r}"
                )
                raise

    reader_stop = threading.Event()

    def reader():
        # Continuous routed reads so the kill lands against a serving
        # surface, not an idle one. Any error here (beyond the shared
        # single-retry budget) is a client-visible failover leak.
        retried = False
        while not reader_stop.is_set():
            try:
                coord.execute("SELECT k, s FROM sums ORDER BY k")
                rep.reader_queries += 1
            except Exception as e:
                if not retried and rep.retried_statements == 0:
                    retried = True
                    rep.retried_statements += 1
                    continue
                rep.failures.append(
                    f"reader query failed mid-storm: {e!r}"
                )
                return

    sub = None
    pending: dict = {}
    pending_thread = None
    try:
        coord.execute(
            "CREATE TABLE kv (k bigint NOT NULL, v bigint NOT NULL)"
        )
        coord.execute(
            "CREATE MATERIALIZED VIEW sums AS "
            "SELECT k, sum(v) AS s FROM kv GROUP BY k"
        )
        sub = coord.execute("SUBSCRIBE sums").subscription

        # Per-statement oracle history: (upper after the statement,
        # SUM-per-key state). Peeks are served from the replica's
        # CURRENT consolidated arrangement once its frontier passes
        # the as_of, so a correct result equals the oracle after SOME
        # statement prefix at/beyond the pinned frontier — a lost or
        # double-applied delta produces a state matching NO prefix.
        history: list = []

        def record() -> None:
            history.append(
                (coord._table_writers["kv"].upper, expect_sums(oracle))
            )

        def feed(t: int) -> None:
            ups = []
            for _ in range(rng.randrange(1, 4)):
                k, v = rng.randrange(6), rng.randrange(100)
                ups.append((k, v))
            ex(
                "INSERT INTO kv VALUES "
                + ", ".join(f"({k}, {v})" for k, v in ups)
            )
            for k, v in ups:
                oracle[(k, v)] = oracle.get((k, v), 0) + 1
            record()
            live = [p for p, n in oracle.items() if n]
            if live and rng.random() < 0.5:
                rk, rv = rng.choice(live)
                n = oracle.pop((rk, rv))
                if n:
                    ex(f"DELETE FROM kv WHERE k = {rk} AND v = {rv}")
                record()

        # Warm-up: every replica hydrates `sums` before the storm so
        # the kill proves failover, not cold-start racing.
        feed(0)
        deadline = _time.monotonic() + 120.0
        while len(ctl.serving_replicas("sums")) < replicas:
            if _time.monotonic() > deadline:
                rep.failures.append(
                    "not all replicas became serving candidates: "
                    f"{ctl.serving_replicas('sums')}"
                )
                return rep
            _time.sleep(0.02)

        rt = threading.Thread(target=reader, daemon=True)
        rt.start()
        kill_tick = max(2, ticks // 2)
        for t in range(1, ticks):
            feed(t)
            if t == kill_tick:
                # Pin a peek in flight against the routed target: an
                # as_of beyond the current frontier parks the response
                # replica-side, so the SIGKILL provably lands mid-peek
                # and resolution MUST travel through failover.
                pending["ts"] = coord._table_writers["kv"].upper + 3

                def pending_peek():
                    try:
                        rows, _ = ctl.peek(
                            "sums", as_of=pending["ts"], timeout=90.0
                        )
                        pending["rows"] = rows
                    except Exception as e:
                        pending["error"] = repr(e)

                pending_thread = threading.Thread(
                    target=pending_peek, daemon=True
                )
                pending_thread.start()
                victim = None
                spin = _time.monotonic() + 10.0
                while victim is None and _time.monotonic() < spin:
                    with ctl._lock:
                        for info in ctl._inflight_peeks.values():
                            if info["dataflow"] == "sums":
                                victim = info["target"]
                                break
                    if victim is None:
                        _time.sleep(0.001)
                if victim is None:
                    rep.failures.append(
                        "pinned peek never registered in flight"
                    )
                    return rep
                rep.routed_before = victim
                _kill(victim)
        if pending_thread is not None:
            # Make sure a write crossed the pinned frontier so the
            # parked peek resolves.
            while coord._table_writers["kv"].upper <= pending["ts"]:
                feed(ticks)
        reader_stop.set()
        rt.join(30)

        # -- verification ---------------------------------------------------
        if pending_thread is not None:
            pending_thread.join(verify_timeout)
            if pending_thread.is_alive():
                rep.failures.append(
                    "in-flight peek never resolved through failover"
                )
            elif "error" in pending:
                rep.failures.append(
                    f"in-flight peek surfaced an error instead of "
                    f"failing over: {pending['error']}"
                )
            else:
                got: dict = {}
                for r in pending.get("rows", []):
                    got[r[:-2]] = got.get(r[:-2], 0) + r[-1]
                got = {k: n for k, n in got.items() if n}
                rep.inflight_rows = len(got)
                valid = [
                    snap
                    for up, snap in history
                    if up > pending["ts"]
                ]
                if got not in valid:
                    rep.failures.append(
                        "in-flight peek matches NO oracle prefix at/"
                        "beyond its as_of (lost waiter or double-"
                        f"delivered response): {got} not in "
                        f"{len(valid)} candidate states"
                    )
        expect = expect_sums(oracle)
        rep.oracle = expect
        try:
            rows = ex("SELECT k, s FROM sums ORDER BY k").rows
        except Exception:
            return rep
        got = {}
        for r in rows:
            got[tuple(r)] = got.get(tuple(r), 0) + 1
        rep.result = got
        if got != expect:
            rep.failures.append(
                f"final peek diverged from oracle: {got} != {expect}"
            )
        rep.routed_after = ctl.routing_target("sums")
        if rep.routed_after in rep.killed:
            rep.failures.append(
                f"routing target {rep.routed_after!r} is a killed "
                "replica"
            )
        snap = ctl.routing_snapshot()
        rep.failovers = snap["failovers"]
        rep.routed_peeks = snap["routed"]
        rep.fallback_broadcasts = snap["fallback_broadcasts"]
        if rep.kills and not rep.failovers:
            rep.failures.append(
                "routed replica killed mid-peek but zero failovers "
                "recorded"
            )
        # SUBSCRIBE exactness: the push plane rides span-fenced sink
        # writes, so the reconstructed state must equal the oracle —
        # a double-applied span would overshoot and never converge.
        final = coord._table_writers["kv"].upper
        state: dict = {}
        deadline = _time.monotonic() + verify_timeout
        while sub.frontier < final:
            if _time.monotonic() > deadline:
                rep.failures.append(
                    f"subscription stuck at frontier {sub.frontier} "
                    f"< {final}"
                )
                break
            if not sub.wait(1.0):
                continue
            for kind, events, _up, _st in sub.pop_ready():
                if kind == "snapshot":
                    state = {}
                for ev in events:
                    key = tuple(ev[:-2])
                    state[key] = state.get(key, 0) + ev[-1]
        for kind, events, _up, _st in sub.pop_ready():
            if kind == "snapshot":
                state = {}
            for ev in events:
                key = tuple(ev[:-2])
                state[key] = state.get(key, 0) + ev[-1]
        sub_got = {k: n for k, n in state.items() if n}
        rep.subscribe = sub_got
        if sub_got != expect:
            rep.failures.append(
                "subscription diverged from oracle (double-delivered "
                f"or lost deltas): {sub_got} != {expect}"
            )
        rep.route_changes = sum(
            t.get("route_changes", 0)
            for t in coord.subscribe_hub.snapshot()["tails"]
        )
        # Surviving connected replicas must end hydrated on `sums`.
        connected = {
            r
            for r, rc in ctl.replicas.items()
            if rc.connected.is_set()
        }
        for df, r, status, _s, _a, error in ctl.hydration_snapshot():
            if df == "sums" and r in connected and status != "hydrated":
                rep.failures.append(
                    f"surviving replica {r} ended {status!r} on sums "
                    f"(error={error!r})"
                )
    except Exception as e:
        # The report IS the result: a storm that dies mid-flight must
        # still come back with its failure picture, never a raise.
        if not rep.failures:
            rep.failures.append(f"storm aborted: {e!r}")
    finally:
        reader_stop.set()
        if sub is not None:
            try:
                sub.close()
            except Exception:
                pass
        try:
            coord.shutdown()
        except Exception:
            pass
        for rec in records.values():
            try:
                if rec["proc"] is not None:
                    rec["proc"].stop()
                elif rec["worker"] is not None:
                    rec["worker"].stop()
            except Exception:
                pass
        rep.elapsed_s = _time.monotonic() - t0
    return rep


def run_failover_smoke(data_dir: str, seed: int = 0,
                       device: str = "cuda") -> FailoverStormReport:
    """The bounded CI shape: two
    in-process replicas serve a live window, one dies mid-peek, zero
    client-visible errors and exact rows via failover."""
    return run_failover_storm(
        data_dir,
        seed=seed,
        ticks=10,
        replicas=2,
        subprocess_replicas=False,
        verify_timeout=120.0,
        device=device,
    )


# ---------------------------------------------------------------------------
# the compactor storm — leased background compaction under fire
# ---------------------------------------------------------------------------


@dataclass
class CompactorStormReport:
    """Off-path compaction chaos outcome: a churn workload runs with
    the production tick path (request-only, ``auto_compaction=True``)
    while the background compactor is SIGKILLed mid-merge (lease held,
    orphan part — the crash hook leaves exactly a SIGKILL's durable
    residue), a second compactor takes over after lease expiry, a
    stale-epoch swap is fenced, and readers race just-swapped parts.
    Every read and the final state must equal the host oracle multiset
    EXACTLY, and every invariant here is a counter, not an inspection:
    zero tick-path merges/blob-writes, >=1 crash, >=1 handoff, >=1
    fenced swap, bounded uncompacted spine."""

    ticks: int = 0
    appends: int = 0
    requests: int = 0
    merges_background: int = 0
    merges_inline: int = 0
    blob_writes_inline: int = 0
    blob_writes_background: int = 0
    crashes: int = 0
    crash_residue_holder: str = ""
    handoffs: int = 0
    handoff_epoch: int = 0
    fenced_swaps: int = 0
    reader_reads: int = 0
    reader_races: int = 0
    rehydrations: int = 0
    final_batches: int = -1
    orphan_parts: int = 0
    oracle_rows: int = 0
    failures: list = field(default_factory=list)
    elapsed_s: float = 0.0

    @property
    def ok(self) -> bool:
        return not self.failures


def _kv_multiset(cols, diff) -> dict:
    """(k, v) -> count from snapshot columns; zero counts dropped so
    dict equality IS multiset equality."""
    ms: dict = {}
    if not len(diff):
        return ms
    ks, vs = cols[0], cols[1]
    for i in range(len(diff)):
        key = (int(ks[i]), int(vs[i]))
        c = ms.get(key, 0) + int(diff[i])
        if c:
            ms[key] = c
        else:
            ms.pop(key, None)
    return ms


def run_compactor_storm(
    data_dir: str,
    seed: int = 0,
    ticks: int = 36,
    blob_fail_every: int = 11,
    lease_s: float = 0.6,
) -> CompactorStormReport:
    """Churn + crash + handoff + race against the leased background
    compactor (chaos coverage). The writer appends with
    ``auto_compaction=True`` so compaction flows through the real tick
    path: an O(1) request to the shared background service — the storm
    asserts BY COUNTER that the tick path never merged and never wrote
    a compaction blob. Mid-storm:

    1. compactor A is crashed AFTER its merge blob-write but BEFORE
       the swap (``crash_next='merge'`` — a SIGKILL's residue: lease
       still held, orphan merged part in blob, state untouched);
    2. compactor B is fenced out while A's lease is live, then takes
       over after expiry (counted handoff; epoch bumps);
    3. a swap presented with a stale lease epoch raises
       ``CompactorFenced`` (the swap-in rejection, counted);
    4. a reader holding a pre-swap batch list observes the swapped-out
       parts as ``CompactionRace`` and the retrying snapshot path
       heals to the exact oracle multiset — while a free-running
       reader thread snapshots the newest tick throughout.
    """
    from ..storage.persist import (
        FileBlob,
        PersistClient,
        SqliteConsensus,
        UnreliableBlob,
    )
    from ..storage.persist.compactor import (
        STATS,
        CompactionService,
        CompactorCrash,
        compaction_service,
        reset_compaction_service,
    )
    from ..storage.persist.machine import CompactionRace, CompactorFenced
    from ..utils.dyncfg import (
        ARRANGEMENT_COMPACTION_BATCHES,
        COMPUTE_CONFIGS,
    )

    os.makedirs(data_dir, exist_ok=True)
    rng = random.Random(seed)
    t_start = _time.monotonic()
    report = CompactorStormReport(ticks=ticks)
    threshold = ARRANGEMENT_COMPACTION_BATCHES(COMPUTE_CONFIGS)

    blob = FileBlob(os.path.join(data_dir, "blob"))
    if blob_fail_every:
        blob = UnreliableBlob(blob, fail_every=blob_fail_every)
    client = PersistClient(
        blob,
        SqliteConsensus(os.path.join(data_dir, "consensus.db")),
        auto_compaction=True,  # the production tick path: request-only
    )
    writer = client.open_writer("kvc", _mk_kv_schema())
    machine = writer.machine
    reset_compaction_service()
    STATS.reset()
    svc_a = CompactionService(holder="chaos-compactor-a", lease_s=lease_s)
    svc_b = CompactionService(holder="chaos-compactor-b", lease_s=lease_s)

    oracle: dict = {}
    live: list = []
    oracle_at: dict[int, dict] = {}
    lock = threading.Lock()
    latest = [-1]
    clock = [0]

    def append_tick():
        t = clock[0]
        rows = [
            (rng.randrange(8), rng.randrange(100))
            for _ in range(rng.randrange(3, 7))
        ]
        upd = [(k, v, 1) for k, v in rows]
        for _ in range(min(len(live), rng.randrange(0, 3))):
            k, v = live.pop(rng.randrange(len(live)))
            upd.append((k, v, -1))
        live.extend(rows)
        ks = np.array([u[0] for u in upd], np.int64)
        vs = np.array([u[1] for u in upd], np.int64)
        time = np.full(len(upd), t, np.uint64)
        diff = np.array([u[2] for u in upd], np.int64)
        writer.compare_and_append(
            [ks, vs], [None, None], time, diff, t, t + 1
        )
        for k, v, d in upd:
            c = oracle.get((k, v), 0) + d
            if c:
                oracle[(k, v)] = c
            else:
                oracle.pop((k, v), None)
        with lock:
            oracle_at[t] = dict(oracle)
            latest[0] = t
        clock[0] = t + 1
        report.appends += 1

    # Free-running reader: snapshot the newest closed tick and demand
    # the exact per-tick oracle multiset while compactors swap parts
    # underneath (its CompactionRace retries are counted).
    storm_reader = client.open_reader("kvc", "storm-reader")
    stop = threading.Event()

    def reader_loop():
        while not stop.is_set():
            with lock:
                t = latest[0]
                want = oracle_at.get(t)
            if t < 0:
                _time.sleep(0.001)
                continue
            try:
                _, cols, _, _, diff = storm_reader.snapshot(t)
            except CompactionRace:
                continue  # racing a since downgrade: re-pick the tick
            got = _kv_multiset(cols, diff)
            if got != want:
                report.failures.append(
                    f"reader snapshot(as_of={t}) != oracle "
                    f"({len(got)} vs {len(want)} distinct rows)"
                )
                stop.set()
                return
            report.reader_reads += 1
            _time.sleep(0.0005)

    rt = threading.Thread(target=reader_loop, daemon=True)
    rt.start()

    def grow_past_threshold():
        while len(machine.reload().batches) <= threshold:
            append_tick()

    try:
        crash_tick = max(6, ticks // 3)
        for _ in range(ticks):
            append_tick()
            if clock[0] - 1 != crash_tick or report.crashes:
                continue

            # (1) SIGKILL compactor A after its merge blob-write.
            svc_a.crash_next = "merge"
            for _ in range(300):
                if len(machine.reload().batches) <= threshold:
                    append_tick()
                try:
                    svc_a.compact_shard(machine)
                except CompactorCrash:
                    report.crashes += 1
                    break
                _time.sleep(0.005)
            else:
                report.failures.append("crash injection never fired")
            st = machine.reload()
            report.crash_residue_holder = st.compactor_holder
            if st.compactor_holder != svc_a.holder:
                report.failures.append(
                    "crashed compactor's lease not held: "
                    f"{st.compactor_holder!r}"
                )

            # (2) B is walled off while A's lease lives, then takes
            # over once it expires.
            r = svc_b.compact_shard(machine)
            if r.get("skipped") != "lease-held" and "replaced" not in r:
                report.failures.append(
                    f"unexpected pre-expiry compaction outcome: {r}"
                )
            deadline = _time.monotonic() + 20 * lease_s
            while _time.monotonic() < deadline:
                if len(machine.reload().batches) <= threshold:
                    append_tick()
                try:
                    r = svc_b.compact_shard(machine)
                except CompactorCrash:
                    r = {}
                if "replaced" in r:
                    report.handoffs += 1
                    report.handoff_epoch = int(r["lease_epoch"])
                    break
                _time.sleep(lease_s / 20)
            else:
                report.failures.append("lease handoff never completed")

            # (3) a swap presenting a stale lease epoch must be
            # rejected (the swap-in fence).
            st = machine.reload()
            if st.batches:
                try:
                    machine.swap_compacted(
                        st.batches, "kvc/stale-probe", 1, 1,
                        epoch=st.compactor_epoch + 1000,
                    )
                    report.failures.append("stale-epoch swap not fenced")
                except CompactorFenced:
                    report.fenced_swaps += 1

            # (4) a reader pinned to the pre-swap batch list sees the
            # swapped-out parts as CompactionRace; its retrying
            # snapshot still yields the exact oracle.
            probe = client.open_reader("kvc", "race-probe")
            grow_past_threshold()
            stale_batches = list(machine.reload().batches)
            swapped = False
            for _ in range(400):
                # max_batches=0: merge whatever spine exists, so the
                # swap can't be starved by the shared service racing
                # us to every over-threshold spine.
                r = svc_b.compact_shard(machine, max_batches=0)
                if r.get("replaced"):
                    swapped = True
                    break
                _time.sleep(0.005)
            if not swapped:
                report.failures.append("race-probe swap never landed")
            elif stale_batches:
                try:
                    probe._read_parts(stale_batches)
                    report.failures.append(
                        "stale batch list readable after swap "
                        "(parts not deleted?)"
                    )
                except CompactionRace:
                    report.reader_races += 1
            with lock:
                t = latest[0]
                want = dict(oracle_at[t])
            _, cols, _, _, diff = probe.snapshot(t)
            if _kv_multiset(cols, diff) != want:
                report.failures.append(
                    "post-swap probe snapshot != oracle"
                )
            probe.expire()

        # Drain the shared service the tick path enqueued into, then
        # verify the end state exactly.
        compaction_service().drain(timeout=20.0)
        stop.set()
        rt.join(timeout=10.0)

        final_t = latest[0]
        verify = client.open_reader("kvc", "verify")
        _, cols, _, _, diff = verify.snapshot(final_t)
        got = _kv_multiset(cols, diff)
        if got != oracle:
            report.failures.append(
                f"final snapshot != oracle ({len(got)} vs "
                f"{len(oracle)} distinct rows)"
            )
        report.oracle_rows = sum(oracle.values())

        st = machine.reload()
        report.final_batches = len(st.batches)
        bound = 3 * threshold + 2
        if report.final_batches > bound:
            report.failures.append(
                f"uncompacted spine unbounded: {report.final_batches}"
                f" batches > {bound}"
            )
        refd = st.referenced_keys()
        report.orphan_parts = len(
            [k for k in blob.list_keys("kvc/") if k not in refd]
        )

        tot = STATS.totals()
        report.requests = tot["requests"]
        report.merges_background = tot["merges_background"]
        report.merges_inline = tot["merges_inline"]
        report.blob_writes_inline = tot["blob_writes_inline"]
        report.blob_writes_background = tot["blob_writes_background"]
        report.rehydrations = client.part_cache.stats()["rehydrations"]
        report.reader_races += storm_reader.race_retries
        if tot["merges_inline"] or tot["blob_writes_inline"]:
            report.failures.append(
                "tick path did compaction work under background mode:"
                f" merges_inline={tot['merges_inline']}"
                f" blob_writes_inline={tot['blob_writes_inline']}"
            )
        if not tot["merges_background"]:
            report.failures.append("background compactor never merged")
        if not report.requests:
            report.failures.append("tick path never requested compaction")
        report.elapsed_s = _time.monotonic() - t_start
        return report
    finally:
        stop.set()
        rt.join(timeout=5.0)
        reset_compaction_service()


def run_compactor_smoke(
    data_dir: str, seed: int = 0
) -> CompactorStormReport:
    """The bounded CI shape:
    fewer ticks, a short lease, UnreliableBlob on — same counted
    invariants as the full storm."""
    return run_compactor_storm(
        data_dir, seed=seed, ticks=18, blob_fail_every=9, lease_s=0.4
    )


def run_chaos(
    data_dir: str,
    seed: int = 0,
    ticks: int = 60,
    subprocess_replica: bool = False,
    blob_fail_every: int = 13,
    proxy_kill_every: int = 0,
    replica_kills: int = 0,
    verify_timeout: float = 180.0,
    replay_trace: dict | None = None,
    device: str = "cuda",
) -> ChaosReport:
    """One seeded chaos run end to end: build the ChaosDriver, run the
    storm under the seeded fault plan, verify, tear down. The tests,
    ``_main`` and ``chip_smoke.py``'s ``chaos`` phase enter here.

    ``replay_trace``: an explorer schedule trace (the JSON of
    ``analysis/interleave.py``'s ``Violation.to_trace()``,
    loaded as a dict). The trace pins BOTH the storm seed
    (:func:`trace_seed`) and the fault plan
    (:func:`fault_plan_from_trace`), so an interleaving the explorer
    flagged replays wall-clock in the real-thread harness."""
    if replay_trace is not None:
        seed = trace_seed(replay_trace)
    chaos = ChaosDriver(
        data_dir,
        seed=seed,
        subprocess_replica=subprocess_replica,
        blob_fail_every=blob_fail_every,
        proxy_kill_every=proxy_kill_every,
        device=device,
    )
    try:
        if replay_trace is not None:
            plan = fault_plan_from_trace(replay_trace, ticks)
        else:
            plan = seeded_fault_plan(
                seed,
                ticks,
                replica_kills=(
                    replica_kills if subprocess_replica else 0
                ),
            )
        chaos.run_storm(ticks=ticks, fault_plan=plan)
        return chaos.verify(timeout=verify_timeout)
    finally:
        chaos.shutdown()


def _main(argv=None) -> int:
    """``python -m materialize_tpu_torch.testing.chaos --replay-trace t.json``
    — replay an explorer-emitted schedule trace wall-clock. Without
    ``--replay-trace`` this runs one ordinary seeded storm."""
    import argparse
    import json
    import tempfile

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--replay-trace",
        help="path to an interleaving trace JSON file "
        "('-' reads stdin); pins the storm seed and fault plan",
    )
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ticks", type=int, default=60)
    ap.add_argument("--subprocess-replica", action="store_true")
    ap.add_argument(
        "--device", default="cuda",
        help="the replica's device (default cuda; exits non-zero "
        "without a card)",
    )
    args = ap.parse_args(argv)
    from .. import resolve_device

    resolve_device(args.device)

    trace = None
    if args.replay_trace:
        if args.replay_trace == "-":
            trace = json.load(sys.stdin)
        else:
            with open(args.replay_trace) as f:
                trace = json.load(f)
        print(
            f"replaying trace: model={trace.get('model')!r} "
            f"kind={trace.get('kind')!r} "
            f"schedule={len(trace.get('steps', []))} steps "
            f"seed={trace_seed(trace)}"
        )
    with tempfile.TemporaryDirectory() as tmp:
        rep = run_chaos(
            args.data_dir or tmp,
            seed=args.seed,
            ticks=args.ticks,
            subprocess_replica=args.subprocess_replica,
            replay_trace=trace,
            device=args.device,
        )
    print(rep)
    return 0 if rep.ok else 1


if __name__ == "__main__":
    raise SystemExit(_main())
