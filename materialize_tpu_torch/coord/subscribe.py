"""The span-native push plane: SUBSCRIBE fan-out hub.

Analog of the reference's SUBSCRIBE/TAIL serving surface
(``adapter/src/coord/sequencer``'s subscribe path + ``sink/subscribe.rs``),
re-cast for the span-pipelined replica: every maintained dataflow's
output deltas land in its durable sink shard exactly once per committed
span boundary (``MaintainedView._commit_span`` -> ``_publish``), so the
coordinator can serve N long-lived subscribers from ONE tail of that
shard — the PeekBatcher trick applied to writes: one readback per span,
fanned out host-side to per-session bounded queues. Per-step push work
is O(delta + subscribers·bytes_delivered), never
O(subscribers·dataflows); DBSP's proportionality promise (PAPERS.md)
extended to the push surface the way Differential Dataflow's
arrangement sharing extends it to readers.

Sharing levels, cheapest first:

1. **Borrowed shard tails.** ``SUBSCRIBE <obj>`` where ``obj`` is a
   table, source, or materialized view tails the object's OWN durable
   shard: zero dataflow installs, zero device work beyond what the
   object already pays. Dropping the last session does NOT drop the
   object's dataflow (the hub never owned it).
2. **Shared owned dataflows.** ``SUBSCRIBE TO (<query>)`` installs one
   sink'd dataflow per distinct (optimized expr, imports, as_of)
   signature; later same-query SUBSCRIBEs join the live tail (counted
   in ``stats['shared_joins']``). When the LAST sharer leaves, the hub
   drops the dataflow exactly once.

Consistency: a session joining a live tail gets a collapsed snapshot at
its join frontier (read under the tail lock, so no delta chunk can
interleave), then deltas strictly beyond it — never a half-applied
carry, because sink shards only ever advance at committed span
boundaries (the replica sequences appends through ``sync_spans()``).

Backpressure follows the peek admission-control pattern:
``subscribe_max_sessions`` sheds new sessions with ServerBusy (pgwire
53400 / HTTP 503); a consumer whose bounded queue overflows is handled
per ``subscribe_slow_policy`` — disconnected with a retryable error, or
coalesced to a snapshot (state transfer) at the current frontier.
"""

from __future__ import annotations

import pickle
import socket
import threading
import time as _time
import uuid
from collections import deque

from ..expr import relation as mir
from ..sql.hir import PlanError
from .peek import ServerBusy
from ..utils import lockcheck as _lockcheck
from .protocol import DataflowDescription


class SubscriptionLagging(RuntimeError):
    """A slow consumer exceeded subscribe_queue_depth under the
    'disconnect' policy: the session is dead; the client may
    re-SUBSCRIBE (retryable, like a shed)."""


# -- /metrics (lazy registration: module may be imported many times) ---------


def _counter(name: str, help_: str):
    from ..utils.metrics import REGISTRY

    got = REGISTRY.get(name)
    if got is None:
        got = REGISTRY.counter(name, help_)
    return got


def _gauge(name: str, help_: str):
    from ..utils.metrics import REGISTRY

    got = REGISTRY.get(name)
    if got is None:
        got = REGISTRY.gauge(name, help_)
    return got


def sessions_active():
    return _gauge(
        "mz_subscribe_sessions_active",
        "live SUBSCRIBE sessions registered with the fan-out hub",
    )


def sessions_total():
    return _counter(
        "mz_subscribe_sessions_total",
        "SUBSCRIBE sessions ever admitted by the fan-out hub",
    )


def sheds_total():
    return _counter(
        "mz_subscribe_sheds_total",
        "SUBSCRIBE sessions shed at admission (subscribe_max_sessions)",
    )


def slow_total():
    return _counter(
        "mz_subscribe_slow_consumers_total",
        "per-session queue overflows handled by subscribe_slow_policy "
        "(disconnects + coalesces)",
    )


def readbacks_total():
    return _counter(
        "mz_subscribe_readbacks_total",
        "shared-tail shard reads (one per committed span window, "
        "regardless of subscriber count — THE push-plane invariant)",
    )


def deltas_total():
    return _counter(
        "mz_subscribe_deltas_total",
        "delta rows fanned out to subscriber queues (rows x sessions)",
    )


# ---------------------------------------------------------------------------
# sessions
# ---------------------------------------------------------------------------


class SubscribeSession:
    """One subscriber: a bounded queue of chunks fed by a shared tail,
    an event + optional wake socket for event-driven delivery (the
    pgwire COPY-out loop selects on it; SSE waits on the event), and
    per-session progress/lag accounting.

    Chunks are ``(kind, events, frontier, stamp)`` with kind
    ``"deltas"`` or ``"snapshot"`` (coalesce state transfer); events
    are decoded ``(vals..., time, diff)`` tuples SHARED by reference
    across all sessions of the tail — fan-out cost is one queue append
    per session, not a copy of the delta."""

    def __init__(self, hub, tail, session_id: int, columns, schema):
        from ..utils.locks import tracked_lock

        self.hub = hub
        self.tail = tail
        self.session_id = session_id
        self.columns = columns
        self.schema = schema
        self.frontier = 0  # progress delivered to the consumer
        self.closed = False
        self.delivered = 0  # rows handed to the consumer
        self.sheds = 0  # queue overflows (either policy)
        self.lag_ms = 0.0  # last observed enqueue->pop latency
        self._chunks: deque = deque()
        self._queued_rows = 0
        self._needs_snapshot = False
        self._coalesce_upper = 0
        self._error: str | None = None
        self._event = threading.Event()
        self._lock = tracked_lock("subscribe.session")
        self._wake_pair: tuple | None = None

    # -- producer side (tail thread / hub) ----------------------------------
    def _enqueue(self, kind: str, events: list, upper: int,
                 stamp: float) -> None:
        from ..utils.dyncfg import (
            COMPUTE_CONFIGS,
            SUBSCRIBE_QUEUE_DEPTH,
            SUBSCRIBE_SLOW_POLICY,
        )

        wake = None
        with self._lock:
            if self.closed or self._error is not None:
                return
            depth = int(SUBSCRIBE_QUEUE_DEPTH(COMPUTE_CONFIGS))
            if self._needs_snapshot:
                # Already coalescing: fold this window into the future
                # snapshot's frontier; the queued rows stay zero.
                self._coalesce_upper = max(self._coalesce_upper, upper)
            else:
                self._chunks.append((kind, events, upper, stamp))
                self._queued_rows += len(events)
                if self._queued_rows > depth:
                    # Slow consumer: the BACKLOG (rows sitting
                    # unconsumed) exceeded the bound.
                    self.sheds += 1
                    slow_total().inc()
                    policy = str(
                        SUBSCRIBE_SLOW_POLICY(COMPUTE_CONFIGS)
                    ).lower()
                    if policy == "coalesce":
                        # State transfer: drop the backlog, deliver
                        # one collapsed snapshot at the tail frontier
                        # instead.
                        self._chunks.clear()
                        self._queued_rows = 0
                        self._needs_snapshot = True
                        self._coalesce_upper = upper
                    else:
                        self._error = (
                            "subscription lagging: session "
                            f"{self.session_id} fell more than "
                            f"{depth} rows behind the shared tail; "
                            "re-subscribe"
                        )
            if self._wake_pair is not None:
                wake = self._wake_pair[1]
        self._event.set()
        if wake is not None:
            try:
                wake.send(b"x")
            except OSError:
                pass

    # -- consumer side (wire loops, bench, tests) ---------------------------
    def wait(self, timeout: float) -> bool:
        """Block until a chunk (or close/error) is ready."""
        return self._event.wait(timeout)

    def wake_socket(self) -> socket.socket:
        """A selectable fd that becomes readable whenever the session
        has work (data, error, close): the pgwire COPY-out loop
        selects on [client socket, this] — event-driven delivery with
        immediate half-close detection, no polling heartbeat."""
        with self._lock:
            if self._wake_pair is None:
                self._wake_pair = socket.socketpair()
                for s in self._wake_pair:
                    s.setblocking(False)
            return self._wake_pair[0]

    def pop_ready(self) -> list:
        """Drain every queued chunk (non-blocking). Returns
        ``[(kind, events, frontier, stamp), ...]``; raises
        SubscriptionLagging if the disconnect policy killed this
        session. A coalesced session synthesizes its snapshot chunk
        here, on the CONSUMER's thread — the tail never blocks on a
        slow consumer's recovery read."""
        with self._lock:
            err = self._error
            self._error = None
        if err is not None:
            # Deregister BEFORE surfacing: a lagging session must not
            # keep holding the tail (and its owned dataflow) while the
            # wire layer unwinds.
            self.hub.close_session(self)
            raise SubscriptionLagging(err)
        with self._lock:
            snap_upper = None
            if self._needs_snapshot:
                self._needs_snapshot = False
                snap_upper = self._coalesce_upper
            chunks = list(self._chunks)
            self._chunks.clear()
            self._queued_rows = 0
            self._event.clear()
        out = []
        if snap_upper is not None and snap_upper > 0:
            events = self.tail.snapshot_events(snap_upper - 1)
            out.append(
                ("snapshot", events, snap_upper, _time.monotonic())
            )
        out.extend(chunks)
        # Delivery lag shares the freshness plane's single definition
        # and clock (coord/freshness.lag_ms): monotonic delta between
        # the chunk's enqueue stamp and this pop, clamped at zero.
        from .freshness import lag_ms as _lag_ms

        now = _time.monotonic()
        for _kind, events, upper, stamp in out:
            self.frontier = max(self.frontier, upper)
            self.delivered += len(events)
            self.lag_ms = _lag_ms(stamp, now)
        return out

    def poll(self, timeout: float = 5.0):
        """Blocking convenience API (the pre-hub ``Subscription.poll``
        contract, kept for programmatic consumers): returns
        ``(events, progress_frontier)`` or None on timeout; events
        concatenate every ready chunk's rows."""
        deadline = _time.monotonic() + timeout
        while True:
            chunks = self.pop_ready()
            if chunks:
                events: list = []
                for _kind, ev, _up, _st in chunks:
                    events.extend(ev)
                return events, self.frontier
            if self.closed:
                return None
            remaining = deadline - _time.monotonic()
            if remaining <= 0 or not self._event.wait(remaining):
                return None

    def queue_depth(self) -> int:
        with self._lock:
            return self._queued_rows

    def close(self) -> None:
        self.hub.close_session(self)

    def _teardown(self) -> None:  # hub-side: after deregistration
        with self._lock:
            self.closed = True
            wake = self._wake_pair[1] if self._wake_pair else None
        self._event.set()
        if wake is not None:
            # Wake, don't close: the wire loop may be blocked in
            # select() on the read end — closing a selected fd raises
            # EBADF there and the loop would miss its final
            # pop_ready (which owes a reaped lagging session its
            # SubscriptionLagging error). The pair dies with the
            # session object once the wire loop drops it.
            try:
                wake.send(b"x")
            except OSError:
                pass


# ---------------------------------------------------------------------------
# shared tails
# ---------------------------------------------------------------------------


class _SharedTail:
    """One maintained delta stream, many consumers: a single persist
    reader tails the dataflow's sink shard (or the borrowed object
    shard); each committed span window is fetched ONCE, decoded ONCE,
    and the decoded chunk is fanned out by reference to every
    session's queue. ``readbacks == spans`` is the counted invariant —
    a per-session tail regression multiplies readbacks by the session
    count and fails the bench/CI gates."""

    def __init__(self, hub, key, label: str, shard: str, schema,
                 owned_dataflow: str | None, start_frontier: int,
                 deps: frozenset = frozenset()):
        from ..utils.locks import tracked_lock

        self.hub = hub
        self.key = key
        self.label = label  # display name (dataflow or catalog object)
        # Catalog objects this stream reads (the tailed object itself,
        # or an owned dataflow's imports): a DROP of any of them ends
        # the stream (close_for) — the shard would never advance again.
        self.deps = deps
        self.shard = shard
        self.schema = schema
        # The dataflow the hub installed FOR this tail (dropped exactly
        # once when the last sharer leaves); None for borrowed shards.
        self.owned_dataflow = owned_dataflow
        self.frontier = start_frontier
        self.sessions: dict[int, SubscribeSession] = {}
        self.readbacks = 0  # tail shard fetches (one per span window)
        self.spans = 0  # span windows consumed
        self.snapshot_reads = 0  # join/coalesce state reads (per event,
        # not per span — excluded from readbacks_per_span)
        # Routed-replica attribution: the tail reads the durable sink
        # shard directly (no replica in the read path), but the shard
        # only advances because SOME replica maintains the dataflow —
        # record which replica the controller currently routes to for
        # this dataflow, so mz_subscriptions / chaos runs can attribute
        # push-plane delivery to the effective producer and count
        # failovers (route_changes) across replica kills.
        self.routed: str | None = None
        self.route_changes = 0
        self._route_checked = 0.0
        self.retired = False
        self._lock = tracked_lock("subscribe.tail")
        self._stop = threading.Event()
        self.reader = hub.coord.persist.open_reader(
            shard, f"subtail-{label}-{id(self):x}"
        )
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"subtail-{label}",
        )
        self._thread.start()

    # -- the tail loop ------------------------------------------------------
    def _run(self) -> None:
        from ..repr.schema import decode_result_rows
        from ..utils.dyncfg import (
            COMPUTE_CONFIGS,
            SUBSCRIBE_TAIL_POLL_MS,
        )

        while not self._stop.is_set():
            self._refresh_route()
            timeout = max(
                float(SUBSCRIBE_TAIL_POLL_MS(COMPUTE_CONFIGS)) / 1000.0,
                0.005,
            )
            try:
                got = self.reader.listen_next(self.frontier, timeout)
            except Exception:
                if self._stop.is_set():
                    return
                # Transient read fault (chaos blob faults, a dropped
                # shard): back off one cycle rather than killing the
                # tail — durable state heals or the hub retires us.
                _time.sleep(timeout)
                continue
            if got is None:
                continue
            (_sch, cols, nulls, time, diff), upper = got
            events = decode_result_rows(
                self.schema, cols, nulls, time, diff
            )
            stamp = _time.monotonic()
            with self._lock:
                _lockcheck.shared_read("subscribe.sessions")
                self.readbacks += 1
                self.spans += 1
                self.frontier = upper
                sessions = list(self.sessions.values())
            readbacks_total().inc()
            if events:
                deltas_total().inc(len(events) * len(sessions))
            doomed = []
            for s in sessions:
                s._enqueue("deltas", events, upper, stamp)
                with s._lock:
                    errored = s._error is not None
                if errored:
                    doomed.append(s)
            # Disconnect-policy sessions are reaped HERE too: a
            # consumer so wedged it never pops must not pin the tail
            # (its queued error still surfaces if it ever returns).
            for s in doomed:
                self.hub.close_session(s)

    def _refresh_route(self) -> None:
        """Throttled (~1s) routed-replica attribution sample; a change
        from one live replica to another is counted as a route change
        (the push-plane failover witness the chaos storm asserts on)."""
        now = _time.monotonic()
        if now - self._route_checked < 1.0:
            return
        self._route_checked = now
        df = self.owned_dataflow or self.label
        if not df:
            return
        try:
            target = self.hub.coord.controller.routing_target(df)
        except Exception:
            return
        with self._lock:
            if target != self.routed:
                if self.routed is not None and target is not None:
                    self.route_changes += 1
                self.routed = target

    # -- membership ---------------------------------------------------------
    def add_session(
        self,
        session: SubscribeSession,
        snapshot_at: int | None = None,
        resume_at: int | None = None,
    ) -> None:
        """Register under the tail lock so the snapshot/catch-up read
        and the registration are atomic w.r.t. fan-out: the session
        sees the collapsed state at its join frontier (or exactly
        ``snapshot_at`` for AS OF, or raw deltas from ``resume_at``
        for exactly-once resume), then every delta strictly beyond it
        — no gap, no overlap."""
        from ..repr.schema import decode_result_rows

        with self._lock:
            if resume_at is not None:
                if resume_at < self.frontier:
                    # Exactly-once resume (durable tails across
                    # restarts): raw deltas in [resume_at, frontier),
                    # NOT a snapshot — the consumer holds the state
                    # its delivered frontier implies.
                    _sch, cols, nulls, time, diff = self.reader.fetch(
                        resume_at, self.frontier
                    )
                    self.snapshot_reads += 1
                    session._enqueue(
                        "deltas",
                        decode_result_rows(
                            self.schema, cols, nulls, time, diff
                        ),
                        self.frontier,
                        _time.monotonic(),
                    )
            else:
                if snapshot_at is None and self.frontier > 0:
                    snapshot_at = self.frontier - 1
                if snapshot_at is not None:
                    events = self._snapshot_events_locked(snapshot_at)
                    session._enqueue(
                        "snapshot", events, snapshot_at + 1,
                        _time.monotonic(),
                    )
                    if self.frontier > snapshot_at + 1:
                        # AS OF behind the live tail: bridge with the
                        # exact deltas so the session's stream stays
                        # gapless up to the shared frontier.
                        (_s2, cols, nulls, time, diff) = (
                            self.reader.fetch(
                                snapshot_at + 1, self.frontier
                            )
                        )
                        self.snapshot_reads += 1
                        session._enqueue(
                            "deltas",
                            decode_result_rows(
                                self.schema, cols, nulls, time, diff
                            ),
                            self.frontier,
                            _time.monotonic(),
                        )
                    else:
                        self.frontier = max(
                            self.frontier, snapshot_at + 1
                        )
            _lockcheck.shared_write("subscribe.sessions")
            self.sessions[session.session_id] = session

    def remove_session(self, session_id: int) -> bool:
        """Returns True when this tail just became empty."""
        with self._lock:
            _lockcheck.shared_write("subscribe.sessions")
            self.sessions.pop(session_id, None)
            return not self.sessions

    # -- state reads --------------------------------------------------------
    def _snapshot_events_locked(self, as_of: int) -> list:
        from ..repr.schema import decode_result_rows

        self.snapshot_reads += 1
        _sch, cols, nulls, time, diff = self.reader.snapshot(as_of)
        rows = decode_result_rows(self.schema, cols, nulls, time, diff)
        # Collapse to the net multiset: a snapshot is state, not a
        # delta log (retractions inside it would be noise).
        acc: dict = {}
        for r in rows:
            acc[r[:-2]] = acc.get(r[:-2], 0) + r[-1]
        return [
            vals + (as_of, n) for vals, n in acc.items() if n
        ]

    def snapshot_events(self, as_of: int) -> list:
        with self._lock:
            return self._snapshot_events_locked(as_of)

    def stats(self) -> dict:
        with self._lock:
            _lockcheck.shared_read("subscribe.sessions")
            return {
                "label": self.label,
                "sessions": len(self.sessions),
                "owned": self.owned_dataflow is not None,
                "frontier": self.frontier,
                "readbacks": self.readbacks,
                "spans": self.spans,
                "snapshot_reads": self.snapshot_reads,
                "routed": self.routed,
                "route_changes": self.route_changes,
            }

    def retire(self) -> None:
        self._stop.set()
        try:
            self.reader.expire()
        except Exception:
            pass


# ---------------------------------------------------------------------------
# the hub
# ---------------------------------------------------------------------------


class SubscribeHub:
    """Coordinator-owned subscription registry: admission control,
    tail sharing, lifecycle (a dropped object closes its sessions; the
    last sharer of an owned dataflow drops it exactly once), and the
    mz_subscriptions / metrics / EXPLAIN ANALYSIS surfaces."""

    def __init__(self, coord):
        from ..utils.locks import tracked_lock

        self.coord = coord
        self._lock = tracked_lock("coord.subscribe_hub")
        self._tails: dict = {}  # share key -> _SharedTail
        self._session_seq = 0
        self.stats = {
            "sessions_total": 0,
            "shared_joins": 0,  # sessions served WITHOUT a new install
            "installs": 0,  # owned sub dataflows ever installed
            "drops": 0,  # owned sub dataflows dropped (must == installs
            # once all sessions close)
            "sheds": 0,  # admission sheds
        }

    # -- admission + sharing -------------------------------------------------
    def session_count(self) -> int:
        # Each tail's session table is guarded by the TAIL lock, not
        # the hub lock — reading it under only the hub lock was a race
        # against add/remove_session (detector finding).
        # Hub -> tail nesting matches close_session's established
        # order.
        with self._lock:
            tails = list(self._tails.values())
        n = 0
        for t in tails:
            with t._lock:
                _lockcheck.shared_read("subscribe.sessions")
                n += len(t.sessions)
        return n

    def subscribe(
        self,
        expr: mir.RelationExpr,
        imports: dict,
        index_imports: dict,
        columns: tuple,
        as_of: int | None = None,
    ) -> SubscribeSession:
        """Admit one SUBSCRIBE. Called under the coordinator's
        sequencing lock (subscribes serialize, so check-then-install
        on the tail map is atomic); the install wait itself releases
        the sequencing lock like any DDL."""
        from ..utils.dyncfg import (
            COMPUTE_CONFIGS,
            SUBSCRIBE_MAX_SESSIONS,
        )

        limit = int(SUBSCRIBE_MAX_SESSIONS(COMPUTE_CONFIGS))
        if self.session_count() >= limit:
            with self._lock:
                self.stats["sheds"] += 1
            sheds_total().inc()
            raise ServerBusy(
                f"server busy: subscribe_max_sessions ({limit}) "
                "sessions already active; retry"
            )
        # Level-1 sharing: a bare Get of an object with a durable
        # shard (table / source / MV) tails that shard directly —
        # zero installs, and N subscribers ride the object's own
        # maintenance.
        direct = self._direct_shard(expr)
        if direct is not None:
            name, shard, schema = direct
            return self._admit(
                key=("shard", shard, as_of),
                label=name,
                shard=shard,
                schema=schema,
                columns=columns,
                as_of=as_of,
                install=None,
                deps=frozenset({name}),
            )
        # Level-2 sharing: same-signature queries share one installed
        # dataflow + one tail.
        key = (
            "expr",
            pickle.dumps(
                (
                    expr,
                    sorted(imports.items()),
                    sorted(index_imports.items()),
                    as_of,
                ),
                protocol=pickle.HIGHEST_PROTOCOL,
            ),
        )
        return self._admit(
            key=key,
            label=None,
            shard=None,
            schema=expr.schema(),
            columns=columns,
            as_of=as_of,
            install=(expr, imports, index_imports),
            deps=frozenset(imports)
            | frozenset(index_imports)
            | {pub for pub, _ in index_imports.values()},
        )

    def resume(
        self, name: str, frontier: int, columns: tuple | None = None
    ) -> SubscribeSession:
        """Exactly-once resume of a durable-object subscription after
        a disconnect or coordinator restart: deltas from ``frontier``
        on, NO snapshot — the consumer already holds the state its
        delivered frontier implies (the durable sink shard makes the
        replay exact; tests/test_subscribe.py pins no-dup/no-loss)."""
        it = self.coord.catalog.items.get(name)
        if (
            it is None
            or not isinstance(it.definition, dict)
            or not it.definition.get("shard")
        ):
            raise PlanError(
                f"{name!r} has no durable collection to resume from"
            )
        return self._admit(
            key=("shard", it.definition["shard"], None),
            label=name,
            shard=it.definition["shard"],
            schema=it.schema,
            columns=columns or tuple(c.name for c in it.schema.columns),
            as_of=None,
            install=None,
            resume_at=frontier,
            deps=frozenset({name}),
        )

    def _direct_shard(self, expr) -> tuple | None:
        if not isinstance(expr, mir.Get):
            return None
        it = self.coord.catalog.items.get(expr.name)
        if (
            it is not None
            and isinstance(it.definition, dict)
            and it.definition.get("shard")
            and not it.definition.get("generator")
        ):
            return expr.name, it.definition["shard"], it.schema
        return None

    def _admit(
        self,
        key,
        label,
        shard,
        schema,
        columns,
        as_of,
        install,
        resume_at: int | None = None,
        deps: frozenset = frozenset(),
    ) -> SubscribeSession:
        installed = False
        while True:
            made_tail = False
            with self._lock:
                tail = self._tails.get(key)
                if tail is not None and tail.retired:
                    self._tails.pop(key, None)
                    tail = None
                if tail is None and (install is None or installed):
                    start = 0
                    if resume_at is not None:
                        start = resume_at
                    elif install is None:
                        # Borrowed shard: join at the CURRENT upper;
                        # the join snapshot covers everything before
                        # it. (A freshly installed dataflow starts at
                        # 0 — its sink's first chunk IS the hydration
                        # snapshot.)
                        start = (
                            as_of + 1
                            if as_of is not None
                            else self.coord.persist.machine(
                                shard
                            ).reload().upper
                        )
                    tail = _SharedTail(
                        self,
                        key,
                        label,
                        shard,
                        schema,
                        owned_dataflow=(label if installed else None),
                        start_frontier=start,
                        deps=deps,
                    )
                    self._tails[key] = tail
                    made_tail = True
                if tail is not None:
                    self._session_seq += 1
                    session = SubscribeSession(
                        self, tail, self._session_seq, columns, schema
                    )
                    self.stats["sessions_total"] += 1
                    if not (made_tail and installed):
                        self.stats["shared_joins"] += 1
                    break
            # No live tail and the query needs a dataflow: install
            # OUTSIDE the hub lock (the wait can take a cold compile);
            # subscribes serialize on the sequencing lock so no
            # duplicate install races in, and the loop re-checks in
            # case a concurrent close retired the prior tail.
            expr, imports, index_imports = install
            label, shard = self._install_dataflow(
                expr, imports, index_imports, as_of
            )
            installed = True
        sessions_total().inc()
        sessions_active().inc()
        # Join under the TAIL lock (snapshot + registration atomic
        # w.r.t. fan-out). AS OF borrowed tails snapshot at exactly
        # as_of; fresh owned tails (frontier==0) skip the snapshot —
        # their sink's first window IS the hydration snapshot.
        tail.add_session(
            session,
            snapshot_at=(as_of if install is None else None),
            resume_at=resume_at,
        )
        return session

    def _install_dataflow(
        self, expr, imports, index_imports, as_of
    ) -> tuple:
        coord = self.coord
        coord._sub_seq += 1
        # Unique across coordinator restarts: the sink shard is
        # durable, so a process-local counter alone would tail a STALE
        # shard from a previous run's different subscription.
        name = f"sub{coord._sub_seq}-{uuid.uuid4().hex[:8]}"
        shard = f"{name}_out"
        coord._register_dataflow(
            DataflowDescription(
                name=name,
                expr=expr,
                source_imports=imports,
                sink_shard=shard,
                index_imports=index_imports,
                as_of=as_of,
            )
        )
        with self._lock:
            self.stats["installs"] += 1
        return name, shard

    # -- lifecycle -----------------------------------------------------------
    def close_session(self, session: SubscribeSession) -> None:
        """Deregister one session; when the last sharer of an OWNED
        dataflow leaves, drop it exactly once. Safe to call from any
        thread, any number of times (wire teardown paths overlap:
        client disconnect + session close + coordinator shutdown)."""
        tail = session.tail
        drop_df = None
        with self._lock:
            already = session.closed
            session.closed = True
            if not already:
                sessions_active().dec()
            empty = tail.remove_session(session.session_id)
            if empty and not tail.retired:
                tail.retired = True
                self._tails.pop(tail.key, None)
                tail.retire()
                if tail.owned_dataflow is not None:
                    drop_df = tail.owned_dataflow
                    self.stats["drops"] += 1
        session._teardown()
        if drop_df is not None:
            self.coord._deregister_dataflow(drop_df)
            try:
                self.coord.controller.drop_dataflow(drop_df)
            except Exception:
                # A dead replica socket must not wedge teardown; the
                # compacted history no longer carries the dataflow, so
                # reconnect replay drops it replica-side.
                pass

    def close_for(self, doomed: set) -> None:
        """A DROP of a subscribed object — or of anything a query
        subscription's dataflow reads: close every affected session
        (their shard would never advance again otherwise)."""
        with self._lock:
            affected = [
                t
                for t in self._tails.values()
                if t.label in doomed or (t.deps & doomed)
            ]
        victims = []
        for t in affected:
            with t._lock:
                _lockcheck.shared_read("subscribe.sessions")
                victims.extend(t.sessions.values())
        for s in victims:
            self.close_session(s)

    def shutdown(self) -> None:
        with self._lock:
            tails = list(self._tails.values())
        victims = []
        for t in tails:
            with t._lock:
                _lockcheck.shared_read("subscribe.sessions")
                victims.extend(t.sessions.values())
        for s in victims:
            self.close_session(s)

    # -- observability -------------------------------------------------------
    def snapshot(self) -> dict:
        """The push plane's counted state: per-tail readbacks/spans
        (the 1.0 invariant), per-session frontiers/queues/lag, and the
        sharing counters (bench.py --subscribe, mz_subscriptions, and
        EXPLAIN ANALYSIS all read this)."""
        with self._lock:
            tails = list(self._tails.values())
            out = dict(self.stats)
        t_stats = [t.stats() for t in tails]
        out["tails"] = t_stats
        out["sessions"] = sum(t["sessions"] for t in t_stats)
        out["readbacks"] = sum(t["readbacks"] for t in t_stats)
        out["spans"] = sum(t["spans"] for t in t_stats)
        out["snapshot_reads"] = sum(
            t["snapshot_reads"] for t in t_stats
        )
        out["readbacks_per_span"] = (
            out["readbacks"] / out["spans"] if out["spans"] else 0.0
        )
        return out

    def introspection_rows(self) -> list:
        """(session_id, dataflow, sharers, frontier, queued, delivered,
        sheds, lag_ms) per live session — the mz_subscriptions
        relation's source."""
        with self._lock:
            tails = list(self._tails.values())
        rows = []
        for t in tails:
            with t._lock:
                sessions = list(t.sessions.values())
                label = t.label
                n = len(sessions)
            for s in sessions:
                rows.append(
                    (
                        s.session_id,
                        label or "",
                        n,
                        s.frontier,
                        s.queue_depth(),
                        s.delivered,
                        s.sheds,
                        float(s.lag_ms),
                    )
                )
        rows.sort()
        return rows

    def analysis_text(self) -> str:
        """The EXPLAIN ANALYSIS ``subscriptions:`` block (the
        donation/sharding/recovery precedent): per-tail sharing +
        readback facts, then the hub totals."""
        snap = self.snapshot()
        lines = ["subscriptions:"]
        if not snap["tails"]:
            lines.append("  (no active subscriptions)")
            return "\n".join(lines)
        for t in sorted(snap["tails"], key=lambda x: str(x["label"])):
            rps = (
                t["readbacks"] / t["spans"] if t["spans"] else 0.0
            )
            lines.append(
                f"  {t['label']}: sessions={t['sessions']} "
                f"owned={str(bool(t['owned'])).lower()} "
                f"frontier={t['frontier']} "
                f"readbacks={t['readbacks']} spans={t['spans']} "
                f"readbacks_per_span={rps:.2f} "
                f"routed={t['routed'] or 'none'} "
                f"route_changes={t['route_changes']}"
            )
        lines.append(
            f"  totals: sessions={snap['sessions']} "
            f"installs={snap['installs']} "
            f"shared_joins={snap['shared_joins']} "
            f"sheds={snap['sheds']}"
        )
        return "\n".join(lines)
