"""Compute controller: command history, replica clients, rehydration.

Analog of ``compute-client/src/controller.rs`` + ``controller/replica.rs``:
the controller owns the desired state (an append-only command history,
compacted like ``protocol/history.rs``), fans every command out to every
replica of the instance, and on replica failure reconnects and replays
the compacted history — the replica reconciles, keeping unchanged
dataflows (rehydration, ``controller/instance.rs:1379 rehydrate_failed_
replicas``). Multi-replica peek responses are deduplicated: first
response wins (``service.rs:271 absorb_peek_response``). Active-active
replication is exactly this: run >=2 replicas, mask failures.

Reads are ROUTED, not broadcast: with ``peek_routing =
'route'`` (the default) each peek / batched lookup dispatches to the
single least-lagged hydrated replica (``route_candidates``), and fails
over to the next candidate immediately on that replica's disconnect —
or after the ``retry_policy_failover`` per-target stall budget — with
a terminal one-shot broadcast fallback once the candidate list is
exhausted. The first-response-wins dedup stays: it is what makes
re-dispatch (and the broadcast fallback) safe to race a straggler
answer from the original target. ``peek_routing = 'broadcast'``
restores the legacy fan-out for comparison.

The port's copy routes without lag data (the freshness recorder waits
for ROADMAP Queue 1 item 6b): candidates rank by serving capability,
then frontier, then name.
"""

from __future__ import annotations

import itertools
import queue
import socket
import threading
import time as _time
from collections import deque

from . import protocol as ctp
from ..utils import retry as retry_mod
from .peek import PeekTimedOut, ServerBusy
from .protocol import DataflowDescription
from ..utils.locks import tracked_lock


def _batch_resolve_timeout() -> float:
    """Batched gathers wait for dataflow frontiers like ordinary
    peeks; the resolver budget is the unified peek retry policy
    (retry_policy_peek, mirroring the coordinator's PEEK_TIMEOUT)."""
    b = retry_mod.policy("peek").budget
    return b if b > 0 else 180.0


# -- /metrics (lazy registration: module may be imported many times) ---------


def _counter(name: str, help_: str):
    from ..utils.metrics import REGISTRY

    got = REGISTRY.get(name)
    if got is None:
        got = REGISTRY.counter(name, help_)
    return got


def routed_peeks_total():
    return _counter(
        "mz_peek_routed_total",
        "peeks/batched lookups dispatched to a single routed replica "
        "(peek_routing='route') instead of broadcast to all",
    )


def broadcast_avoided_total():
    return _counter(
        "mz_peek_broadcast_avoided_total",
        "duplicate peek dispatches avoided by routing: for each "
        "routed read, the N-1 replica sends (and discarded responses) "
        "the legacy broadcast path would have paid",
    )


def peek_failovers_total():
    return _counter(
        "mz_peek_failovers_total",
        "routed reads re-dispatched to another candidate after the "
        "target disconnected, stalled past retry_policy_failover's "
        "per-target budget, or started draining",
    )


class _NonceSource:
    """Strictly-increasing Hello nonces, with fast-forward: a
    HelloReject carries the replica's current epoch, and the next
    connect must jump PAST it instead of linearly probing one nonce
    per backoff cycle — a restarted controller (nonce counter reset to
    0) would otherwise take O(previous session count) reconnect rounds
    to re-fence a surviving replica (recovery time is a
    counted metric now)."""

    def __init__(self):
        self._next = 1
        self._lock = threading.Lock()

    def next(self) -> int:
        with self._lock:
            n = self._next
            self._next += 1
            return n

    def bump_past(self, epoch: int) -> None:
        with self._lock:
            if epoch >= self._next:
                self._next = epoch + 1


_WAITER_TLS = threading.local()


class _PeekWaiter:
    """One session's queued fast-path lookup. The completion Event is
    reused per thread (one outstanding lookup per session thread):
    allocating an Event + its lock per request is measurable at
    thousands of lookups per second."""

    __slots__ = (
        "probe", "as_of", "event", "rows", "served_at", "error",
        "retryable", "trace",
    )

    def __init__(self, probe: tuple, as_of: int):
        from ..utils.trace import TRACER

        self.probe = probe
        self.as_of = as_of
        # Statement trace context: captured on the SESSION
        # thread so the batched dispatch (possibly on the flusher
        # thread) can still ship a context the replica's serve span
        # joins — one tree per statement even through batching.
        self.trace = TRACER.context()
        ev = getattr(_WAITER_TLS, "event", None)
        if ev is None:
            ev = threading.Event()
            _WAITER_TLS.event = ev
        ev.clear()
        self.event = ev
        self.rows = None
        self.served_at = None
        self.error = None
        # Timeouts and sheds are RETRYABLE (surfaced as ServerBusy at
        # pgwire/HTTP); replica-reported evaluation errors are not.
        self.retryable = False


class _PeekBatch:
    __slots__ = ("peek_id", "event", "waiters", "scan")

    def __init__(self, peek_id, event, waiters, scan):
        self.peek_id = peek_id
        self.event = event
        self.waiters = waiters
        self.scan = scan


class PeekBatcher:
    """The RTT-amortized read plane: fans N
    concurrent sessions' fast-path lookups against the same index into
    ONE stacked device gather per batch window, with admission control
    (queue-depth shedding + an in-flight batch cap) in front.

    Waiters queue per (dataflow, bound-column signature, scan); a
    flusher thread drains every group each ``peek_batch_window_ms``
    span tick into one ``peek_lookup`` command (the replica pads the
    stacked probes to a pow2 batch lane and runs one gather program).
    With ``peek_batching`` off, each lookup dispatches on its own —
    the serial baseline ``bench.py --serve`` compares against."""

    def __init__(self, controller: "ComputeController"):
        self.ctrl = controller
        self._lock = tracked_lock("controller.peek_batcher")
        self._groups: dict = {}  # (df, bound_cols, scan) -> [waiters]
        self._queued = 0
        self._inflight = 0
        self._flusher: threading.Thread | None = None
        self._resolver_pool = None
        self.stats = {
            "lookups": 0,
            "batches": 0,
            "probes": 0,
            "shed": 0,
            "max_batch": 0,
        }

    # -- submission ---------------------------------------------------------
    def submit(
        self,
        dataflow: str,
        bound_cols: tuple,
        scan: bool,
        probe: tuple,
        as_of: int,
        timeout: float,
    ):
        from ..utils.dyncfg import (
            COMPUTE_CONFIGS,
            PEEK_BATCHING,
            PEEK_QUEUE_DEPTH,
        )

        w = _PeekWaiter(tuple(probe), int(as_of))
        if not PEEK_BATCHING(COMPUTE_CONFIGS):
            # Serial per-peek dispatch: one command, one gather, the
            # caller resolves its own batch (no flusher involvement).
            with self._lock:
                self.stats["lookups"] += 1
            batch = self._dispatch_group(
                dataflow, bound_cols, scan, [w]
            )
            self._resolve_batch(batch, timeout)
        else:
            from ..utils.dyncfg import (
                PEEK_MAX_BATCH,
                PEEK_MAX_INFLIGHT,
            )

            dispatch_now = None
            with self._lock:
                if self._queued >= int(
                    PEEK_QUEUE_DEPTH(COMPUTE_CONFIGS)
                ):
                    self.stats["shed"] += 1
                    raise ServerBusy(
                        f"server busy: peek queue full "
                        f"({self._queued} lookups queued); retry"
                    )
                self.stats["lookups"] += 1
                key = (dataflow, tuple(bound_cols), bool(scan))
                ws = self._groups.setdefault(key, [])
                ws.append(w)
                self._queued += 1
                # Flush-when-full: a group at the batch cap dispatches
                # from the SUBMITTING thread — under heavy concurrency
                # the flusher thread's scheduling latency (GIL) must
                # not gate batch cadence; the flusher only sweeps up
                # partial batches each window tick.
                if len(ws) >= int(
                    PEEK_MAX_BATCH(COMPUTE_CONFIGS)
                ) and self._inflight < int(
                    PEEK_MAX_INFLIGHT(COMPUTE_CONFIGS)
                ):
                    self._groups.pop(key, None)
                    self._queued -= len(ws)
                    dispatch_now = (key, ws)
                self._ensure_flusher()
            if dispatch_now is not None:
                (df_k, bc_k, scan_k), ws = dispatch_now
                batch = self._dispatch_group(df_k, bc_k, scan_k, ws)
                # The submitter IS one of the batch's waiters: resolve
                # inline (sets every waiter's event, ours included) —
                # no extra thread on the full-batch hot path.
                self._resolve_batch(batch, timeout)
            if not w.event.wait(timeout):
                # The batch may still resolve later and set this
                # (thread-reused) event; detach it so the thread's next
                # lookup cannot be spuriously woken.
                _WAITER_TLS.event = None
                raise PeekTimedOut(
                    f"server busy: fast-path peek on {dataflow!r} "
                    "timed out; retry"
                )
        if w.error is not None:
            if w.retryable:
                raise PeekTimedOut(f"server busy: {w.error}; retry")
            raise RuntimeError(w.error)
        return w.rows, w.served_at

    # -- flushing -----------------------------------------------------------
    def _ensure_flusher(self) -> None:  # caller holds self._lock
        if self._flusher is None or not self._flusher.is_alive():
            self._flusher = threading.Thread(
                target=self._flush_loop, daemon=True
            )
            self._flusher.start()

    def _flush_loop(self) -> None:
        from ..utils.dyncfg import (
            COMPUTE_CONFIGS,
            PEEK_BATCH_WINDOW_MS,
        )

        while not self.ctrl._stop.is_set():
            _time.sleep(
                max(
                    float(PEEK_BATCH_WINDOW_MS(COMPUTE_CONFIGS))
                    / 1000.0,
                    0.0005,
                )
            )
            try:
                self._flush_once()
            except Exception:
                # A flush failure must not kill the read plane; the
                # affected waiters time out individually.
                pass
        self._fail_queued("controller shut down")

    def _flush_once(self) -> None:
        from ..utils.dyncfg import (
            COMPUTE_CONFIGS,
            PEEK_MAX_BATCH,
            PEEK_MAX_INFLIGHT,
        )

        max_batch = int(PEEK_MAX_BATCH(COMPUTE_CONFIGS))
        dispatches = []
        with self._lock:
            budget = int(PEEK_MAX_INFLIGHT(COMPUTE_CONFIGS)) - (
                self._inflight
            )
            for key in list(self._groups):
                # Drain the whole group in max_batch chunks while the
                # in-flight budget lasts: one chunk per tick would
                # serialize a deep queue behind the window cadence.
                while budget > 0:
                    ws = self._groups.get(key)
                    if not ws:
                        self._groups.pop(key, None)
                        break
                    take = ws if key[2] else ws[:max_batch]
                    rest = ws[len(take):]
                    if rest:
                        self._groups[key] = rest
                    else:
                        self._groups.pop(key, None)
                    self._queued -= len(take)
                    dispatches.append((key, take))
                    budget -= 1
                if budget <= 0:
                    break
        if dispatches and self._resolver_pool is None:
            from concurrent.futures import ThreadPoolExecutor

            # Persistent resolver pool: a thread spawn per batch costs
            # ~0.2ms of GIL at serving rates.
            self._resolver_pool = ThreadPoolExecutor(
                max_workers=8, thread_name_prefix="peek-resolve"
            )
        for (df, bound_cols, scan), ws in dispatches:
            batch = self._dispatch_group(df, bound_cols, scan, ws)
            self._resolver_pool.submit(
                self._resolve_batch, batch, _batch_resolve_timeout()
            )

    def _dispatch_group(
        self, dataflow: str, bound_cols: tuple, scan: bool, waiters
    ) -> _PeekBatch:
        ctrl = self.ctrl
        peek_id = next(ctrl._peek_counter)
        ev = threading.Event()
        # Registered under the controller lock: the absorber reads
        # this map on every PeekResponse, and an unlocked insert from
        # the flusher thread was a detector-confirmed race
        # (tests/test_racecheck.py pins it).
        with ctrl._lock:
            ctrl._peek_events[peek_id] = ev
        spec = {
            "scan": bool(scan),
            "bound_cols": tuple(bound_cols),
            "probes": [w.probe for w in waiters],
        }
        as_of = max(w.as_of for w in waiters)
        with self._lock:
            self._inflight += 1
            self.stats["batches"] += 1
            self.stats["probes"] += len(waiters)
            self.stats["max_batch"] = max(
                self.stats["max_batch"], len(waiters)
            )
        # A batch serves N sessions' statements; the shipped context is
        # the FIRST traced waiter's (a replica span can join one tree).
        trace = next(
            (w.trace for w in waiters if w.trace is not None), None
        )
        ctrl._dispatch_peek(
            peek_id,
            dataflow,
            ctp.peek_lookup(
                peek_id, dataflow, as_of, spec, trace=trace
            ),
        )
        return _PeekBatch(peek_id, ev, waiters, scan)

    def _resolve_batch(self, batch: _PeekBatch, timeout: float) -> None:
        ctrl = self.ctrl
        resp = None
        error = None
        retryable = False
        try:
            if not ctrl._await_peek_event(
                batch.peek_id, batch.event, timeout
            ):
                error = "batched peek timed out"
                retryable = True
            else:
                with ctrl._lock:
                    resp = ctrl._peek_results.pop(batch.peek_id, None)
                if resp is None:
                    error = "batched peek response lost"
                elif "error" in resp:
                    error = resp["error"]
        finally:
            with ctrl._lock:
                ctrl._peek_events.pop(batch.peek_id, None)
                ctrl._peek_results.pop(batch.peek_id, None)
                info = ctrl._inflight_peeks.pop(batch.peek_id, None)
            ctrl._cancel_peek(batch.peek_id, info)
            with self._lock:
                self._inflight -= 1
        if error is not None:
            for w in batch.waiters:
                w.error = error
                w.retryable = retryable
                w.event.set()
            return
        groups = resp.get("rows_groups") or []
        served_at = resp.get("served_at")
        for i, w in enumerate(batch.waiters):
            gi = 0 if batch.scan else i
            if gi < len(groups):
                w.rows = groups[gi]
                w.served_at = served_at
            else:
                w.error = (
                    "batched peek returned "
                    f"{len(groups)} groups for "
                    f"{len(batch.waiters)} probes"
                )
            w.event.set()

    def _fail_queued(self, why: str) -> None:
        with self._lock:
            groups, self._groups = self._groups, {}
            self._queued = 0
        for ws in groups.values():
            for w in ws:
                w.error = why
                w.retryable = True  # shutdown/failover: client retries
                w.event.set()

    def snapshot(self) -> dict:
        with self._lock:
            out = dict(self.stats)
            out["queued"] = self._queued
            out["inflight"] = self._inflight
        out["batch_occupancy"] = (
            out["probes"] / out["batches"] if out["batches"] else 0.0
        )
        return out


class ReplicaClient:
    """Background connection owner for one replica: connect, Hello,
    replay history, then stream commands; responses land in the
    controller's shared queue tagged with the replica name. Sessions,
    reconnects, and observed fencings are counted (the mz_recovery /
    /metrics surface: recovery time and failover behavior are counted
    invariants, not vibes)."""

    def __init__(
        self,
        name: str,
        addr: tuple[str, int],
        history_fn,
        response_q: queue.Queue,
        nonce_counter: _NonceSource,
    ):
        self.name = name
        self.addr = addr
        self._history_fn = history_fn
        self._response_q = response_q
        self._nonce_counter = nonce_counter
        self._cmd_q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self.connected = threading.Event()
        # Session/fence counters are written by the connection thread
        # and read by recovery_snapshot / mz_recovery from session
        # threads — a plain int increment is atomic under the GIL but
        # invisible to the happens-before order, so the race detector
        # (rightly) flagged the pair. Guarded by a dedicated leaf lock;
        # read through stats().
        self._stats_lock = tracked_lock(
            "controller.replica_stats"
        )
        self.sessions = 0  # established sessions (reconnects = n-1)
        self.fenced = 0  # HelloRejects observed (newer epoch exists)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stats(self) -> dict:
        with self._stats_lock:
            return {
                "sessions": self.sessions,
                "reconnects": max(self.sessions - 1, 0),
                "fenced": self.fenced,
                "connected": self.connected.is_set(),
            }

    def send(self, cmd: dict) -> None:
        self._cmd_q.put(cmd)

    def stop(self) -> None:
        self._stop.set()

    # -- connection loop ----------------------------------------------------
    def _run(self) -> None:
        stream = retry_mod.policy("reconnect").stream()
        while not self._stop.is_set():
            try:
                self._session()
                stream = retry_mod.policy("reconnect").stream()
            except (OSError, ctp.TransportError):
                pass
            was_connected = self.connected.is_set()
            self.connected.clear()
            if was_connected and not self._stop.is_set():
                # Failover trigger: the absorber re-routes
                # this replica's in-flight reads NOW — a waiter must
                # not ride out the stall timer for a dead session.
                self._response_q.put(
                    {
                        "kind": "ReplicaDisconnected",
                        "__replica__": self.name,
                    }
                )
            if not self._stop.is_set():
                # Unbounded: reconnect never gives up (an expired
                # attempts/budget must back off at the ceiling, not
                # return a 0.0 sleep and busy-spin); 1ms floor guards
                # a base=0 misconfiguration the same way.
                stream.advance()
                _time.sleep(max(stream.next_sleep_unbounded(), 0.001))

    def _session(self) -> None:
        sock = socket.create_connection(self.addr, timeout=5.0)
        try:
            # CTP frames are small pickled commands; Nagle + delayed
            # ACK turns each command/response exchange into a ~40ms
            # stall (the classic small-write interaction), which was
            # the hidden floor under every peek round trip.
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sock.settimeout(None)
            nonce = self._nonce_counter.next()
            ctp.send_msg(sock, ctp.hello(nonce))
            resp = ctp.recv_msg(sock)
            if resp.get("kind") != "HelloOk":
                if resp.get("kind") == "HelloReject":
                    # Fast-forward past the fencing epoch: the next
                    # attempt must win immediately, not probe one
                    # nonce per backoff cycle (recovery time).
                    with self._stats_lock:
                        self.fenced += 1
                    retry_mod.fenced_epochs_total().inc()
                    self._nonce_counter.bump_past(
                        int(resp.get("epoch", 0))
                    )
                raise ctp.TransportError(f"hello rejected: {resp}")
            with self._stats_lock:
                self.sessions += 1
                reconnect = self.sessions > 1
            if reconnect:
                retry_mod.reconnects_total().inc()
            # Rehydration: replay the compacted history. The replica
            # reconciles (keeps unchanged dataflows) and drops the rest.
            history, live = self._history_fn()
            for name in resp.get("installed", []):
                if name not in live:
                    ctp.send_msg(sock, ctp.drop_dataflow(name))
            for cmd in history:
                ctp.send_msg(sock, cmd)
            self.connected.set()

            dead = threading.Event()

            def reader():
                try:
                    while not dead.is_set():
                        msg = ctp.recv_msg(sock)
                        msg["__replica__"] = self.name
                        self._response_q.put(msg)
                except (OSError, ctp.TransportError):
                    dead.set()

            t = threading.Thread(target=reader, daemon=True)
            t.start()
            while not self._stop.is_set() and not dead.is_set():
                try:
                    cmd = self._cmd_q.get(timeout=0.1)
                except queue.Empty:
                    continue
                ctp.send_msg(sock, cmd)
            if dead.is_set():
                raise ctp.TransportError("replica connection lost")
        finally:
            # hard_close: the reader thread is blocked in recv on this
            # socket — a deferred close would leak the thread AND keep
            # the replica-side session half-alive.
            ctp.hard_close(sock)


class ComputeController:
    """Desired-state owner for one compute instance (cluster)."""

    def __init__(self):
        self._nonce_counter = _NonceSource()
        self._peek_counter = itertools.count(1)
        self.responses: queue.Queue = queue.Queue()
        self.replicas: dict[str, ReplicaClient] = {}
        # Command history, compacted: dataflow name -> CreateDataflow cmd
        # (a dropped dataflow disappears entirely: history.rs compaction).
        self._dataflows: dict[str, dict] = {}
        self._config: dict = {}
        self._lock = tracked_lock("controller.state")
        # Observed state (guarded by _lock: mutated by the absorber
        # thread, read by caller threads).
        self.frontiers: dict[str, dict[str, int]] = {}  # df -> replica -> upper
        self.arrangement_records: dict[str, dict[str, int]] = {}
        # Monotone COMMITTED span counters (df -> replica ->
        # epoch): the span boundary each reported frontier belongs to.
        # Peeks and compaction decisions sequence against boundaries,
        # not individual ticks — the counter is the observable identity
        # of a boundary.
        self.span_epochs: dict[str, dict[str, int]] = {}
        # Buffer-provenance/donation verdicts (df -> replica
        # -> verdict dict): the prover's per-carry-argnum donation
        # safety each replica reports whenever it changes. Surfaced by
        # EXPLAIN ANALYSIS and the mz_donation introspection relation.
        self.donation_verdicts: dict[str, dict[str, dict]] = {}
        # Shard-spec prover reports (df -> replica -> report
        # dict): SPMD-safety verdict of the slot-ring cursors, resolved
        # ingest mode, communication census. Surfaced by EXPLAIN
        # ANALYSIS's `sharding:` block and the mz_sharding relation.
        self.sharding_verdicts: dict[str, dict[str, dict]] = {}
        # Recovery accounting (df -> replica -> counters):
        # each replica's install/rebuild/reconcile counts piggyback on
        # Frontiers whenever they change. `rebuilds == 0` for a
        # fingerprint-unchanged dataflow across a controller restart
        # is THE counted reconciliation invariant (mz_recovery).
        self.recovery_stats: dict[str, dict[str, dict]] = {}
        # Observability piggybacks: per-dataflow device-
        # resident bytes by spine component (df -> replica -> dict) and
        # each replica's latest /metrics sample snapshot (replica ->
        # families list, utils/metrics.py) — the deployment-wide
        # mz_arrangement_sizes and /metrics surfaces. Trace spans and
        # compile records ingest straight into the process-global
        # TRACER / LEDGER (pid-deduped), not controller state.
        self.arrangement_bytes: dict[str, dict[str, dict]] = {}
        self.replica_metrics: dict[str, list] = {}
        # Compaction-plane piggybacks (shard -> replica ->
        # counted stats row): subprocess replicas ship their compactor
        # activity on Frontiers; merged with the coordinator's own
        # process-global registry by mz_compactions.
        self.compactions: dict[str, dict[str, dict]] = {}
        # Async-compile hot-swap states (df -> replica ->
        # {"state": pending|swapped|swap-failed, timestamps}): the
        # EXPLAIN ANALYSIS `pending_swap` / mz_program_bank surface.
        self.swap_states: dict[str, dict[str, dict]] = {}
        # Freshness plane: the per-(dataflow, replica)
        # hydration status board (pending -> hydrating -> hydrated ->
        # stalled, with bounded transition history). Seeded "pending"
        # at create_dataflow/add_replica, overwritten by replica
        # piggybacks, and stamped "stalled" by wait_installed when the
        # install budget expires without an ack. Own lock (StatusBoard)
        # so the absorber, DDL waits, and introspection never contend
        # on controller._lock. Lag records go to the process-global
        # FRESHNESS recorder (pid-deduped), not controller state.
        from .freshness import StatusBoard

        self.hydration = StatusBoard()
        self.statuses: deque = deque(maxlen=1000)  # replica error reports
        # Install acks: df name -> replica -> error string | None (ok).
        self.install_acks: dict[str, dict] = {}
        self._peek_results: dict[int, dict] = {}
        self._peek_events: dict[int, threading.Event] = {}
        # Routed-read state (guarded by _lock): per in-flight
        # peek the dispatched command, current target, and candidates
        # already tried — everything failover needs to re-dispatch the
        # SAME peek_id to the next replica. Draining replicas stay
        # connected (they may still answer what they hold) but are
        # excluded from new routing decisions.
        self._inflight_peeks: dict[int, dict] = {}
        self._draining: set[str] = set()
        self.routing_stats = {
            "routed": 0,  # single-target dispatches
            "broadcast": 0,  # fan-out dispatches (mode or no candidate)
            "avoided": 0,  # duplicate dispatches routing skipped
            "failovers": 0,  # re-dispatches (disconnect/stall/drain)
            "fallback_broadcasts": 0,  # terminal candidate-exhausted
        }
        self.routed_counts: dict[str, int] = {}  # replica -> dispatches
        # The RTT-amortized read plane: batches fast-path lookups.
        self._peek_batcher = PeekBatcher(self)
        self._absorber = threading.Thread(
            target=self._absorb_responses, daemon=True
        )
        self._stop = threading.Event()
        self._absorber.start()

    # -- replica management --------------------------------------------------
    def add_replica(self, name: str, addr: tuple[str, int]) -> None:
        """Provision a replica (cluster-controller ensure_service analog);
        it will connect, receive the history, and hydrate."""
        rc = ReplicaClient(
            name, addr, self._history_snapshot, self.responses,
            self._nonce_counter,
        )
        # The replicas map is iterated by _broadcast (any session
        # thread) and checked by the absorber mid-Frontiers-ingest;
        # mutating it outside _lock was a detector-confirmed race
        # (tests/test_racecheck.py pins it).
        with self._lock:
            self.replicas[name] = rc
            dataflows = list(self._dataflows)
        for df in dataflows:
            self.hydration.seed((df, name))

    def drop_replica(self, name: str) -> None:
        with self._lock:
            rc = self.replicas.pop(name, None)
        if rc is not None:
            rc.stop()
        with self._lock:
            for per_df in self.frontiers.values():
                per_df.pop(name, None)
            for per_df in self.arrangement_records.values():
                per_df.pop(name, None)
            for per_df in self.span_epochs.values():
                per_df.pop(name, None)
            for per_df in self.donation_verdicts.values():
                per_df.pop(name, None)
            for per_df in self.sharding_verdicts.values():
                per_df.pop(name, None)
            for per_df in self.recovery_stats.values():
                per_df.pop(name, None)
            for per_df in self.arrangement_bytes.values():
                per_df.pop(name, None)
            self.replica_metrics.pop(name, None)
            self._draining.discard(name)
            self.routed_counts.pop(name, None)
        self.hydration.forget_replica(name)
        # Reads still in flight against the dropped replica re-route
        # to the survivors (the stopped client can no longer answer).
        self._on_replica_disconnect(name)

    def _history_snapshot(self):
        with self._lock:
            history = []
            if self._config:
                history.append(ctp.update_configuration(dict(self._config)))
            history.extend(self._dataflows.values())
            return history, set(self._dataflows)

    def _broadcast(self, cmd: dict) -> None:
        # Snapshot under _lock (iterating the live dict races
        # add/drop_replica); sends happen outside — rc.send is just a
        # queue put, but a slow replica must not serialize the others
        # behind the controller lock.
        with self._lock:
            targets = list(self.replicas.values())
        for rc in targets:
            rc.send(cmd)

    # -- read routing ----------------------------------------------
    def route_candidates(self, dataflow: str) -> list[str]:
        """Ranked failover chain for reads of ``dataflow``: CONNECTED,
        non-draining replicas, serving-capable ones first (hydration
        board hydrated/swapping, or any reported frontier — a replica
        mid-rehydration must not be preferred over one that answers),
        then by windowed p50 wallclock lag (no lag data ranks last),
        ties toward the higher reported frontier, then name order.
        Element 0 is the routing target; the rest are the failover
        order."""
        with self._lock:
            live = [
                r
                for r, rc in self.replicas.items()
                if rc.connected.is_set() and r not in self._draining
            ]
            per_frontier = dict(self.frontiers.get(dataflow, {}))
        if not live:
            return []
        def rank(r):
            lag = float("inf")  # no lag data in the port (item 6b)
            status = self.hydration.status((dataflow, r))
            serving = (
                status in ("hydrated", "swapping")
                or per_frontier.get(r, 0) > 0
            )
            return (0 if serving else 1, lag, -per_frontier.get(r, 0), r)

        return sorted(live, key=rank)

    def serving_replicas(self, dataflow: str) -> list[str]:
        """Connected, non-draining replicas currently ABLE to answer
        reads of ``dataflow``: hydrated/swapping on the board, or
        reporting a frontier. The rolling-restart invariant ("at least
        one hydrated replica serves every durable dataflow at every
        instant", server/environmentd.py) counts exactly these."""
        out = []
        for r in self.route_candidates(dataflow):
            status = self.hydration.status((dataflow, r))
            with self._lock:
                frontier = self.frontiers.get(dataflow, {}).get(r, 0)
            if status in ("hydrated", "swapping") or frontier > 0:
                out.append(r)
        return out

    def routing_target(self, dataflow: str) -> str | None:
        """Where a read of ``dataflow`` dispatches right now: the head
        of the candidate chain, or None (broadcast mode / nothing
        connected). The EXPLAIN ANALYSIS ``replicas:`` block and the
        subscribe hub's tail attribution read this."""
        from ..utils.dyncfg import COMPUTE_CONFIGS, PEEK_ROUTING

        if str(PEEK_ROUTING(COMPUTE_CONFIGS)).lower() == "broadcast":
            return None
        cands = self.route_candidates(dataflow)
        return cands[0] if cands else None

    def _dispatch_peek(
        self, peek_id: int, dataflow: str, cmd: dict
    ) -> None:
        """Dispatch a registered peek (its event is already in
        ``_peek_events``): to ONE routed replica by default, recording
        enough in ``_inflight_peeks`` to fail over; broadcast when the
        mode says so or no candidate is connected."""
        from ..utils.dyncfg import COMPUTE_CONFIGS, PEEK_ROUTING

        target = None
        if str(PEEK_ROUTING(COMPUTE_CONFIGS)).lower() != "broadcast":
            cands = self.route_candidates(dataflow)
            if cands:
                target = cands[0]
        avoided = 0
        with self._lock:
            rc = self.replicas.get(target) if target else None
            if rc is None:
                target = None
            self._inflight_peeks[peek_id] = {
                "dataflow": dataflow,
                "cmd": cmd,
                "target": target,
                "tried": [target] if target else [],
                "broadcasted": target is None,
            }
            if target is None:
                self.routing_stats["broadcast"] += 1
            else:
                n_live = sum(
                    1
                    for c in self.replicas.values()
                    if c.connected.is_set()
                )
                avoided = max(n_live - 1, 0)
                self.routing_stats["routed"] += 1
                self.routing_stats["avoided"] += avoided
                self.routed_counts[target] = (
                    self.routed_counts.get(target, 0) + 1
                )
        if target is None:
            self._broadcast(cmd)
            return
        routed_peeks_total().inc()
        if avoided:
            broadcast_avoided_total().inc(avoided)
        rc.send(cmd)

    def _failover_peek(self, peek_id: int, reason: str) -> bool:
        """Re-dispatch a still-unanswered routed peek to the next
        candidate (or, with the chain exhausted / the attempts cap
        hit, fall back to ONE broadcast — any surviving replica may
        answer, first response wins). Returns True when a re-dispatch
        happened. Safe to race the original answer: the absorber's
        first-wins check under _lock drops stragglers."""
        pol = retry_mod.policy("failover")
        max_hops = pol.attempts if pol.attempts > 0 else 3
        with self._lock:
            info = self._inflight_peeks.get(peek_id)
            if (
                info is None
                or info["broadcasted"]
                or peek_id not in self._peek_events
                or peek_id in self._peek_results
            ):
                return False
            dataflow = info["dataflow"]
            tried = list(info["tried"])
        # route_candidates takes _lock itself; choose outside, then
        # re-validate and commit the choice under the lock.
        cands = [
            r
            for r in self.route_candidates(dataflow)
            if r not in tried
        ]
        with self._lock:
            info = self._inflight_peeks.get(peek_id)
            if (
                info is None
                or info["broadcasted"]
                or peek_id not in self._peek_events
                or peek_id in self._peek_results
            ):
                return False
            self.routing_stats["failovers"] += 1
            if not cands or len(info["tried"]) >= max_hops:
                info["broadcasted"] = True
                info["target"] = None
                self.routing_stats["fallback_broadcasts"] += 1
                rc = None
            else:
                nxt = cands[0]
                info["target"] = nxt
                info["tried"].append(nxt)
                self.routed_counts[nxt] = (
                    self.routed_counts.get(nxt, 0) + 1
                )
                rc = self.replicas.get(nxt)
            cmd = info["cmd"]
        peek_failovers_total().inc()
        if rc is None:
            self._broadcast(cmd)
        else:
            rc.send(cmd)
        return True

    def _await_peek_event(
        self, peek_id: int, ev: threading.Event, timeout: float
    ) -> bool:
        """Wait for a peek's response with stall failover: every
        ``retry_policy_failover`` base interval without an answer,
        re-dispatch to the next candidate (disconnect failover happens
        eagerly in the absorber; this timer catches a target that is
        connected but wedged). Returns the event verdict within the
        caller's overall ``timeout``."""
        pol = retry_mod.policy("failover")
        stall = pol.base if pol.base > 0 else 0.0
        deadline = _time.monotonic() + timeout
        while True:
            remaining = deadline - _time.monotonic()
            if remaining <= 0:
                return ev.is_set()
            if stall <= 0:
                return ev.wait(remaining)
            if ev.wait(min(stall, remaining)):
                return True
            if not self._failover_peek(peek_id, "stall"):
                # Nothing left to fail over to (broadcast already, or
                # chain exhausted): plain-wait the rest of the budget.
                stall = 0.0

    def _cancel_peek(self, peek_id: int, info: dict | None) -> None:
        """Post-resolution cleanup dispatch: cancel on the replicas
        that actually saw the peek (the routed `tried` chain), or all
        of them after a broadcast."""
        cmd = ctp.cancel_peek(peek_id)
        if info is None or info.get("broadcasted") or not info.get(
            "tried"
        ):
            self._broadcast(cmd)
            return
        with self._lock:
            targets = [
                self.replicas[r]
                for r in info["tried"]
                if r in self.replicas
            ]
        for rc in targets:
            rc.send(cmd)

    def _on_replica_disconnect(self, name: str) -> None:
        """A replica's session died: every in-flight routed read
        targeting it re-dispatches to the next candidate NOW — waiters
        must not ride out the stall timer (the
        disconnect event, not the timeout, is the failover trigger)."""
        with self._lock:
            doomed = [
                pid
                for pid, info in self._inflight_peeks.items()
                if info["target"] == name
            ]
        for pid in doomed:
            self._failover_peek(pid, "disconnect")

    def drain_replica(
        self, name: str, timeout: float | None = None
    ) -> dict:
        """Graceful removal: stop routing NEW reads to ``name``,
        immediately move its in-flight routed reads to surviving
        candidates, wait (failover budget) for stragglers, then
        drop_replica. The replica stays connected while draining so
        already-dispatched work it holds can still answer."""
        pol = retry_mod.policy("failover")
        if timeout is None:
            timeout = pol.budget if pol.budget > 0 else 10.0
        with self._lock:
            known = name in self.replicas
            if known:
                self._draining.add(name)
        if not known:
            return {"drained": False, "moved": 0}
        with self._lock:
            pids = [
                pid
                for pid, info in self._inflight_peeks.items()
                if info["target"] == name
            ]
        moved = sum(
            1 for pid in pids if self._failover_peek(pid, "drain")
        )
        deadline = _time.monotonic() + timeout
        while _time.monotonic() < deadline:
            with self._lock:
                still = any(
                    info["target"] == name
                    for info in self._inflight_peeks.values()
                )
            if not still:
                break
            _time.sleep(0.01)
        self.drop_replica(name)
        return {"drained": True, "moved": moved}

    def replica_states(self) -> list[dict]:
        """The mz_cluster_replicas rows' source: per replica its
        connection state, lifecycle state (active|draining), and how
        many reads routed to it."""
        with self._lock:
            items = sorted(self.replicas.items())
            draining = set(self._draining)
            routed = dict(self.routed_counts)
        return [
            {
                "name": n,
                "connected": rc.connected.is_set(),
                "state": "draining" if n in draining else "active",
                "routed": routed.get(n, 0),
            }
            for n, rc in items
        ]

    def routing_snapshot(self) -> dict:
        """Routing observability (bench.py --serve's per-replica
        distribution + the mz_metrics counters' in-process twin)."""
        with self._lock:
            out = dict(self.routing_stats)
            out["per_replica"] = dict(self.routed_counts)
            out["draining"] = sorted(self._draining)
            out["inflight"] = len(self._inflight_peeks)
        return out

    # -- commands -------------------------------------------------------------
    def create_dataflow(self, desc: DataflowDescription) -> None:
        from ..utils.trace import TRACER

        # History keeps the UNTRACED command: a reconnect replay must
        # not attribute reinstall spans to the original DDL statement.
        cmd = ctp.create_dataflow(desc)
        with self._lock:
            self._dataflows[desc.name] = cmd
            self.install_acks.pop(desc.name, None)
        for r in list(self.replicas):
            self.hydration.seed((desc.name, r))
        with TRACER.span("controller.create_dataflow",
                         dataflow=desc.name):
            self._broadcast(
                ctp.create_dataflow(desc, trace=TRACER.context())
            )

    def wait_installed(
        self, name: str, timeout: float | None = None
    ) -> None:
        """Block until some replica acks the install (ok), or raise the
        replica-reported error once every connected replica has failed
        it. Surfaces bad plans at DDL time instead of as a later
        "no such dataflow" peek error. No replicas -> returns (the
        dataflow installs on the next replica connect via history).
        Budget + poll cadence come from ``retry_policy_install_wait``;
        an explicit ``timeout`` overrides the budget."""
        pol = retry_mod.policy("install_wait")
        if timeout is None:
            timeout = pol.budget if pol.budget > 0 else 30.0
        poll = max(pol.base, 0.001)
        deadline = _time.monotonic() + timeout
        while True:
            # Only CONNECTED replicas owe an ack: a dead/reconnecting
            # replica gets the dataflow from history replay later, and
            # must not stall DDL (chaos kills replicas mid-run).
            with self._lock:
                connected = [
                    r
                    for r, rc in self.replicas.items()
                    if rc.connected.is_set()
                ]
                acks = dict(self.install_acks.get(name, {}))
            if not connected:
                return
            if any(e is None for e in acks.values()):
                return
            if acks and all(r in acks for r in connected):
                raise RuntimeError(next(iter(acks.values())))
            if _time.monotonic() >= deadline:
                if acks:
                    raise RuntimeError(next(iter(acks.values())))
                # Slow hydration is still not a DDL error (the install
                # completes in the background), but it is no longer
                # SILENT: every connected replica that failed to ack
                # within the budget transitions to `stalled` in
                # mz_hydration_statuses (with its attempt count and a
                # budget-exceeded error), a hydration_stall event lands
                # in mz_freshness_events, and the stall counter ticks.
                # The replica's own later hydrating/hydrated report
                # overrides the stall.
                for r in connected:
                    if r in acks:
                        continue
                    prev = self.hydration.get((name, r)) or {}
                    self.hydration.transition(
                        (name, r), "stalled",
                        attempts=prev.get("attempts", 0),
                        error=(
                            f"hydration exceeded {timeout:.1f}s "
                            "install budget"
                        ),
                    )
                return
            _time.sleep(poll)

    def drop_dataflow(self, name: str) -> None:
        with self._lock:
            self._dataflows.pop(name, None)
            self.frontiers.pop(name, None)
            self.arrangement_records.pop(name, None)
            self.span_epochs.pop(name, None)
            self.donation_verdicts.pop(name, None)
            self.sharding_verdicts.pop(name, None)
            self.recovery_stats.pop(name, None)
            self.arrangement_bytes.pop(name, None)
            self.swap_states.pop(name, None)
            self.install_acks.pop(name, None)
        self.hydration.forget_dataflow(name)
        self._broadcast(ctp.drop_dataflow(name))

    def allow_compaction(self, dataflow: str, since: int) -> None:
        self._broadcast(ctp.allow_compaction(dataflow, since))

    def update_configuration(self, params: dict) -> None:
        with self._lock:
            self._config.update(params)
        self._broadcast(ctp.update_configuration(params))

    def peek(
        self, dataflow: str, as_of: int | None, timeout: float = 30.0,
        exact: bool = False,
    ):
        """Peek, ROUTED to the least-lagged hydrated replica (with
        disconnect/stall failover) by default; broadcast to every
        replica with first-response-wins under
        peek_routing='broadcast'. Returns (rows, served_at)."""
        from ..utils.trace import TRACER

        peek_id = next(self._peek_counter)
        ev = threading.Event()
        # Same discipline as the batcher's _dispatch_group: the
        # absorber walks this map under _lock, so the insert must be
        # under it too.
        with self._lock:
            self._peek_events[peek_id] = ev
        with TRACER.span(
            "controller.peek", dataflow=dataflow, peek_id=peek_id
        ):
            self._dispatch_peek(
                peek_id,
                dataflow,
                ctp.peek(
                    peek_id, dataflow, as_of, exact,
                    trace=TRACER.context(),
                ),
            )
            try:
                if not self._await_peek_event(peek_id, ev, timeout):
                    # Retryable by contract: the
                    # front ends shed this as ServerBusy (53400 / 503),
                    # and the sequencing lock was released around the
                    # wait, so a timed-out peek never poisons later
                    # statements.
                    raise PeekTimedOut(
                        f"server busy: peek {peek_id} on {dataflow!r} "
                        "timed out; retry"
                    )
                with self._lock:
                    resp = self._peek_results.pop(peek_id)
                if "error" in resp:
                    raise RuntimeError(resp["error"])
                return resp["rows"], resp["served_at"]
            finally:
                # Event first, then any straggler result, both under
                # the absorber's lock: later duplicate responses cannot
                # leak. Cancels go to the replicas that saw the peek.
                with self._lock:
                    self._peek_events.pop(peek_id, None)
                    self._peek_results.pop(peek_id, None)
                    info = self._inflight_peeks.pop(peek_id, None)
                self._cancel_peek(peek_id, info)

    def peek_lookup(
        self,
        dataflow: str,
        bound_cols: tuple,
        scan: bool,
        probe: tuple,
        as_of: int,
        timeout: float = 30.0,
    ):
        """Fast-path lookup against ``dataflow``'s maintained
        arrangement: queued into the peek batcher, dispatched as part
        of one stacked device gather, first replica response wins.
        Returns (rows, served_at); raises ServerBusy when admission
        control sheds the read."""
        from ..utils.trace import TRACER

        with TRACER.span("controller.peek_lookup", dataflow=dataflow):
            return self._peek_batcher.submit(
                dataflow, tuple(bound_cols), bool(scan), tuple(probe),
                int(as_of), timeout,
            )

    def peek_stats(self) -> dict:
        """Read-plane observability: lookups, batches, occupancy,
        shed count, queue depth, and the routing distribution
        (bench.py --serve reports these)."""
        out = self._peek_batcher.snapshot()
        out["routing"] = self.routing_snapshot()
        return out

    # -- response absorption ---------------------------------------------------
    def _absorb_responses(self) -> None:
        while not self._stop.is_set():
            try:
                msg = self.responses.get(timeout=0.1)
            except queue.Empty:
                continue
            kind = msg.get("kind")
            if kind == "Frontiers":
                replica = msg["__replica__"]
                with self._lock:
                    # A dropped replica may still have queued reports:
                    # discard them or they pin the definite frontier.
                    known = replica in self.replicas
                    if known:
                        for df, upper in msg["uppers"].items():
                            self.frontiers.setdefault(df, {})[
                                replica
                            ] = upper
                        for df, n in msg.get("records", {}).items():
                            self.arrangement_records.setdefault(df, {})[
                                replica
                            ] = n
                        for df, e in msg.get(
                            "span_epochs", {}
                        ).items():
                            self.span_epochs.setdefault(df, {})[
                                replica
                            ] = e
                        for df, v in msg.get("donation", {}).items():
                            self.donation_verdicts.setdefault(df, {})[
                                replica
                            ] = v
                        for df, v in msg.get("sharding", {}).items():
                            self.sharding_verdicts.setdefault(df, {})[
                                replica
                            ] = v
                        for df, v in msg.get("recovery", {}).items():
                            self.recovery_stats.setdefault(df, {})[
                                replica
                            ] = v
                        for df, v in msg.get(
                            "arrangement_bytes", {}
                        ).items():
                            self.arrangement_bytes.setdefault(df, {})[
                                replica
                            ] = v
                        for df, v in msg.get("swaps", {}).items():
                            self.swap_states.setdefault(df, {})[
                                replica
                            ] = v
                        for sh, v in msg.get(
                            "compactions", {}
                        ).items():
                            self.compactions.setdefault(sh, {})[
                                replica
                            ] = v
                        if "metrics" in msg:
                            self.replica_metrics[replica] = msg[
                                "metrics"
                            ]
                # Trace spans and compile records merge into the
                # process-global rings OUTSIDE the controller lock
                # (ingest has its own; pid-dedupe makes in-process
                # replicas — which share the rings — a no-op). The
                # membership verdict is the one taken under _lock
                # above — re-reading the live dict here unlocked was a
                # detector finding.
                if known:
                    # In-process replicas ship no spans, compile records
                    # or lag (the port has no subprocess replica yet:
                    # item 6b); status transitions land on the
                    # hydration board (its own lock) keyed by replica.
                    fresh = msg.get("freshness")
                    if fresh:
                        for df, entry in (
                            fresh.get("status") or {}
                        ).items():
                            self.hydration.apply(
                                (df, replica), entry
                            )
            elif kind == "Status":
                with self._lock:
                    self.statuses.append(msg)
            elif kind == "DataflowInstalled":
                with self._lock:
                    self.install_acks.setdefault(msg["name"], {})[
                        msg["__replica__"]
                    ] = msg.get("error")
            elif kind == "PeekResponse":
                pid = msg["peek_id"]
                with self._lock:
                    ev = self._peek_events.get(pid)
                    if ev is not None and pid not in self._peek_results:
                        self._peek_results[pid] = msg  # first wins
                        ev.set()
            elif kind == "ReplicaDisconnected":
                self._on_replica_disconnect(msg["__replica__"])

    # -- observed state --------------------------------------------------------
    def frontier(self, dataflow: str) -> int:
        """The definite frontier: MIN over ALL replicas of the instance —
        a replica that has not reported yet (still hydrating) counts as
        0, so the definite frontier never overstates."""
        with self._lock:
            if not self.replicas:
                return 0
            per = self.frontiers.get(dataflow, {})
            return min(per.get(name, 0) for name in self.replicas)

    def span_epoch(self, dataflow: str) -> int:
        """The serving span boundary: MAX committed span epoch over
        replicas (some replica serves at this boundary). Monotone —
        two reads straddling an increment are separated by at least
        one committed span."""
        with self._lock:
            per = self.span_epochs.get(dataflow)
            return max(per.values()) if per else 0

    def any_frontier(self, dataflow: str) -> int:
        """The serving frontier: MAX over replicas (some replica can
        answer at this time)."""
        with self._lock:
            per = self.frontiers.get(dataflow)
            return max(per.values()) if per else 0

    def least_lagged_replica(self, dataflow: str) -> str | None:
        """The routing hook: among CONNECTED replicas, the one with the
        lowest windowed p50 wallclock lag in the reference. The port
        records no lag (item 6b), so every replica ranks as lag-less and
        ties break toward the higher reported frontier, then name
        order. None when no replica is connected."""
        with self._lock:
            live = [
                r
                for r, rc in self.replicas.items()
                if rc.connected.is_set()
            ]
            per_frontier = dict(self.frontiers.get(dataflow, {}))
        if not live:
            return None
        return min(sorted(live), key=lambda r: -per_frontier.get(r, 0))

    def hydration_snapshot(self) -> list:
        """The mz_hydration_statuses rows: (dataflow, replica, status,
        since, attempts, last_error), sorted."""
        return [
            (key[0], key[1], status, at, attempts, error)
            for key, status, at, attempts, error, _hist
            in self.hydration.rows()
        ]

    def wait_frontier(
        self, dataflow: str, past: int, timeout: float | None = None
    ) -> int:
        pol = retry_mod.policy("frontier_wait")
        if timeout is None:
            timeout = pol.budget if pol.budget > 0 else 30.0
        poll = max(pol.base, 0.001)
        deadline = _time.monotonic() + timeout
        while _time.monotonic() < deadline:
            f = self.any_frontier(dataflow)
            if f > past:
                return f
            _time.sleep(poll)
        raise TimeoutError(
            f"frontier of {dataflow!r} stuck at "
            f"{self.any_frontier(dataflow)} (wanted > {past}); retry"
        )

    def recovery_snapshot(self) -> dict:
        """Recovery observability (the mz_recovery relation's
        controller half): per-replica session/fence counters and the
        per-dataflow install/rebuild/reconcile counts the replicas
        piggyback on their frontier reports."""
        with self._lock:
            dataflows = {
                df: {rep: dict(v) for rep, v in per.items()}
                for df, per in self.recovery_stats.items()
            }
            clients = list(self.replicas.items())
        # Counter reads go through ReplicaClient.stats() (its own leaf
        # lock): the connection thread increments them mid-session.
        replicas = {name: rc.stats() for name, rc in clients}
        return {"replicas": replicas, "dataflows": dataflows}

    def shutdown(self) -> None:
        self._stop.set()
        self._peek_batcher._fail_queued("controller shut down")
        with self._lock:
            clients = list(self.replicas.values())
        for rc in clients:
            rc.stop()
