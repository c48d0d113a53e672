"""Replica worker process: the clusterd analog.

One process = one replica of a cluster (``clusterd/src/lib.rs:190``): it
hosts the compute runtime (installed dataflows stepped as TPU
micro-batches) and the storage runtime (shard sources/sinks). A single
controller connection is active at a time; a strictly-increasing Hello
nonce fences stale controllers (``cluster/src/communication.rs`` epoch
protocol + ``protocol/command.rs:45-53``). On reconnect the controller
replays its command history; reconciliation keeps dataflows whose
description is unchanged instead of rebuilding them
(``compute/src/server.rs:373 run_client``).

The port's replica runs in-process (``serve_forever`` on a thread) and
steps its dataflows on the device it is given (``device=``, default
``"cuda"``). All device work stays on the worker thread
(``_worker_loop``); peek responses cross the protocol as Python rows,
never as tensors. Not ported yet, each raising with its ROADMAP item:
SPMD workers (item 8), async compile and hot swap (Queue 2 item 6: the
program bank has no counterpart in eager torch), shipping observability
and the subprocess entry point (item 6b, with environmentd), and the
dictionary-rebalance rebuild (item 6b: expr/remap.py).
"""

from __future__ import annotations

import queue
import socket
import threading
import time as _time

from .. import resolve_device
from ..render.dataflow import Dataflow
from ..storage.persist import (
    IndexSource,
    FileBlob,
    MaintainedView,
    PersistClient,
    SqliteConsensus,
)
from ..storage.persist.machine import CompactionRace, Fenced
from ..storage.persist.operators import SinkConflict
from . import protocol as ctp
from .protocol import DataflowDescription, PersistLocation


def _result_rows(batch, df=None) -> list:
    """Batch -> decoded result rows (strings decoded, NULLs as None):
    dictionary codes never cross the wire raw — the controller may live
    in another process. ``df`` enables basic-aggregate edge
    finalization (digest columns -> materialized strings) before
    decode."""
    import numpy as np

    from ..repr.schema import decode_result_rows

    n = int(batch.count)
    cols = [c[:n].cpu().numpy() for c in batch.cols]
    nulls = [
        None if nl is None else nl[:n].cpu().numpy() for nl in batch.nulls
    ]
    if df is not None and getattr(df, "_basic_finalizers", None):
        cols = df.finalize_basic_columns(cols, nulls)
    return decode_result_rows(
        batch.schema,
        cols,
        nulls,
        batch.time[:n].cpu().numpy().view(np.uint64),
        batch.diff[:n].cpu().numpy(),
    )


class _Installed:
    """A running dataflow + its shipped description fingerprint (for
    reconciliation) and read-hold bookkeeping."""

    def __init__(self, desc: DataflowDescription, view: MaintainedView):
        self.desc = desc
        self.fingerprint = desc.fingerprint()
        self.view = view
        self.reported_upper = -1


class ReplicaWorker:
    def __init__(
        self,
        location: PersistLocation | None = None,
        persist_client: PersistClient | None = None,
        replica_id: str = "r0",
        workers: int = 1,
        ship_observability: bool = False,
        device=None,
    ):
        if workers > 1:
            raise NotImplementedError(
                "replicas with workers > 1 (an SPMD mesh) are not ported "
                "(ROADMAP Queue 1 item 8)"
            )
        if ship_observability:
            raise NotImplementedError(
                "shipping observability from a subprocess replica is not "
                "ported (ROADMAP Queue 1 item 6b, with environmentd)"
            )
        self.device = resolve_device(device)
        if persist_client is not None:
            self.client = persist_client
        else:
            assert location is not None
            self.client = PersistClient(
                FileBlob(location.blob_root),
                SqliteConsensus(location.consensus_path),
                # The reference requests background compaction from sink
                # appends; the port's compactor waits for ROADMAP Queue 1
                # item 6b, so sink shards only keep more parts.
                auto_compaction=False,
            )
        self.replica_id = replica_id
        self.workers = workers
        self.epoch = -1
        self.dataflows: dict[str, _Installed] = {}
        self.pending_peeks: list[dict] = []
        self.config: dict = {}
        # Recovery accounting: per-dataflow install /
        # rebuild / reconcile counts + last hydration time, piggybacked
        # on Frontiers whenever they change. A fingerprint-unchanged
        # dataflow surviving a controller restart must show
        # rebuilds == 0 — reconciliation as a counted invariant.
        self._recovery: dict[str, dict] = {}
        self._recovery_dirty: set = set()
        # Hydration status machine (freshness plane): per-dataflow
        # pending -> hydrating -> hydrated -> stalled with attempt
        # count and last error. Unlike lag records, status entries ship
        # on EVERY Frontiers report path (dirty-set, keyed by replica
        # on the controller board — no pid-dedupe question arises).
        self._hydration: dict[str, dict] = {}
        self._hydration_dirty: set = set()
        self._stop = threading.Event()

    # -- serving -------------------------------------------------------------
    def serve(self, listen_sock: socket.socket) -> None:
        """One active controller session at a time; a NEW connection with
        a higher nonce preempts the current session immediately (the
        reference's single-client-at-a-time servers where a reconnecting
        controller takes over, transport.rs:10-21)."""
        listen_sock.settimeout(0.2)
        session_q: queue.Queue = queue.Queue()

        def acceptor():
            while not self._stop.is_set():
                try:
                    conn, _addr = listen_sock.accept()
                except socket.timeout:
                    continue
                except OSError:
                    return
                try:
                    conn.setsockopt(
                        socket.IPPROTO_TCP, socket.TCP_NODELAY, 1
                    )
                    conn.settimeout(5.0)
                    msg = ctp.recv_msg(conn)
                    if (
                        msg.get("kind") != "Hello"
                        or msg["nonce"] <= self.epoch
                    ):
                        ctp.send_msg(
                            conn,
                            {"kind": "HelloReject", "epoch": self.epoch},
                        )
                        conn.close()
                        continue
                    nonce = msg["nonce"]
                    # Fences the running session: its loop observes the
                    # epoch change and exits.
                    self.epoch = nonce
                    conn.settimeout(None)
                    ctp.send_msg(
                        conn,
                        {
                            "kind": "HelloOk",
                            "epoch": nonce,
                            "replica_id": self.replica_id,
                            # Reconciliation: what we still have running.
                            "installed": sorted(self.dataflows),
                        },
                    )
                    session_q.put((conn, nonce))
                except Exception:
                    # A malformed hello (bad pickle, non-dict) must not
                    # kill the acceptor — the replica would stop
                    # accepting controllers forever.
                    try:
                        conn.close()
                    except OSError:
                        pass

        threading.Thread(target=acceptor, daemon=True).start()
        while not self._stop.is_set():
            try:
                conn, nonce = session_q.get(timeout=0.2)
            except queue.Empty:
                continue
            if nonce != self.epoch:
                conn.close()  # superseded while queued
                continue
            try:
                self._serve_session(conn, nonce)
            except Exception:
                # The session dies, the replica survives: the controller
                # reconnects and replays history (rehydration).
                pass
            finally:
                # hard_close, not close: the session's reader thread
                # may still be blocked in recv on this socket, and a
                # deferred close would leave the fenced controller
                # hanging on a half-dead link forever (chaos-found).
                ctp.hard_close(conn)

    def stop(self) -> None:
        self._stop.set()

    def _serve_session(self, conn: socket.socket, nonce: int) -> None:
        cmd_q: queue.Queue = queue.Queue()
        dead = threading.Event()

        def reader():
            try:
                while not dead.is_set():
                    cmd_q.put(ctp.recv_msg(conn))
            except (ctp.TransportError, OSError):
                dead.set()

        t = threading.Thread(target=reader, daemon=True)
        t.start()
        try:
            self._worker_loop(conn, cmd_q, dead, nonce)
        finally:
            dead.set()

    # -- the worker loop ------------------------------------------------------
    def _worker_loop(self, conn, cmd_q, dead, nonce) -> None:
        """Single-threaded compute loop: drain commands, step dataflows,
        serve ready peeks, report frontiers (run()/step_or_park,
        compute/src/server.rs:356)."""
        while not dead.is_set() and not self._stop.is_set():
            if self.epoch != nonce:
                return  # fenced by a newer controller
            worked = False
            try:
                while True:
                    cmd = cmd_q.get_nowait()
                    try:
                        self._handle_command(conn, cmd)
                    except Exception as e:
                        # A failing command must not kill the session.
                        self._send_status(
                            conn, f"command {cmd.get('kind')} failed: {e!r}"
                        )
                    worked = True
            except queue.Empty:
                pass
            from ..utils.dyncfg import COMPUTE_CONFIGS, SPAN_PIPELINING

            pipelined = SPAN_PIPELINING(COMPUTE_CONFIGS)
            for name, inst in list(self.dataflows.items()):
                try:
                    # Non-blocking: only if some input advanced. The
                    # pipelined span path dispatches every
                    # READY micro-batch as one deferred span and
                    # commits span K at its single boundary readback
                    # while span K+1 executes — device occupancy, not
                    # per-tick round trips, limits throughput.
                    if (
                        inst.view.step_span(timeout=0)
                        if pipelined
                        else inst.view.step(timeout=0)
                    ):
                        worked = True
                except SinkConflict:
                    # Another replica's durable chunking won a hydration
                    # race: rebuild this view from the durable shard
                    # (fresh dataflow state; hydrate resumes exactly).
                    self._rebuild_cascade(name)
                    worked = True
                except Exception as e:
                    # DictExhausted lands here too: the port's dictionary
                    # cannot rebalance (item 6b), so the dataflow halts.  # halt!-analog, scoped to the df
                    self.dataflows.pop(name, None)
                    inst.view.expire()
                    # A runtime failure is a freshness stall, not just
                    # a status line: mz_hydration_statuses shows it.
                    self._set_hydration(name, "stalled", error=repr(e))
                    self._send_status(
                        conn, f"dataflow {name!r} failed: {e!r}"
                    )
                    worked = True
            worked |= self._serve_peeks(conn)
            worked |= self._report_frontiers(conn)
            if not worked:
                _time.sleep(0.002)  # park

    def _make_dataflow(self, desc: DataflowDescription):
        return Dataflow(desc.expr, name=desc.name, device=self.device)

    def _count_recovery(self, name: str, key: str) -> dict:
        rec = self._recovery.setdefault(
            name,
            {"installs": 0, "rebuilds": 0, "reconciles": 0,
             "hydrate_ms": 0.0},
        )
        if key:
            rec[key] = rec.get(key, 0) + 1
        self._recovery_dirty.add(name)
        return rec

    def _set_hydration(
        self, name: str, status: str, attempts: int = 0, error: str = ""
    ) -> None:
        """One hydration status transition, queued for the next
        Frontiers piggyback (coord/freshness.py status machine)."""
        from .freshness import status_entry  # the status machine only

        self._hydration[name] = status_entry(
            status, attempts=attempts, error=error
        )
        self._hydration_dirty.add(name)

    def _build(
        self, desc: DataflowDescription
    ) -> _Installed:
        """Build (or rebuild) a dataflow. Hydration can race with an
        active-active sibling writing the same sink (SinkConflict) or
        with a concurrent compaction moving the as_of or swapping a
        part mid-read (CompactionRace — and ONLY that; a blanket
        ValueError catch used to retry real codec bugs forever): all
        transient — retry against the fresh durable state on the
        unified ``retry_policy_hydration`` backoff. Every attempt is
        visible in the hydration status machine: hydrating (with the
        attempt count) while building, hydrated on success, stalled
        (with the last error) when the retry budget is exhausted or
        the failure is permanent."""
        from ..utils.retry import policy as _retry_policy

        t0 = _time.monotonic()
        attempts = 0
        self._set_hydration(desc.name, "hydrating")
        stream = _retry_policy("hydration").stream()
        while True:
            # Render BEFORE subscribing index sources: a render failure
            # must not leak subscribers onto publishers (each publisher
            # step would copy its delta to the orphan forever).
            df = self._make_dataflow(desc)
            index_sources: dict = {}
            try:
                # Index imports resolve against dataflows ALREADY
                # installed on this replica (command history preserves
                # install order, so publishers precede subscribers).
                for name, (pub_name, schema) in getattr(
                    desc, "index_imports", {}
                ).items():
                    pub = self.dataflows.get(pub_name)
                    if pub is None:
                        raise RuntimeError(
                            f"index import {pub_name!r} for dataflow "
                            f"{desc.name!r} is not installed"
                        )
                    index_sources[name] = IndexSource(
                        pub.view, schema
                    )
                inst = _Installed(
                    desc,
                    MaintainedView(
                        self.client,
                        df,
                        desc.source_imports,
                        desc.sink_shard,
                        index_sources=index_sources,
                        replica_id=self.replica_id,
                        as_of=getattr(desc, "as_of", None),
                    ),
                )
                self._count_recovery(desc.name, "")["hydrate_ms"] = (
                    (_time.monotonic() - t0) * 1000.0
                )
                self._set_hydration(
                    desc.name, "hydrated", attempts=attempts
                )
                return inst
            except (SinkConflict, Fenced, CompactionRace) as e:
                # Fenced: an active-active sibling re-registered the sink
                # writer mid-hydration (epoch ping-pong) — rebuild picks
                # up the durable state it wrote.
                attempts += 1
                for src in index_sources.values():
                    src.reader.expire()  # unsubscribe the failed attempt
                if not stream.sleep():
                    self._set_hydration(
                        desc.name, "stalled",
                        attempts=attempts, error=repr(e),
                    )
                    raise
                self._set_hydration(
                    desc.name, "hydrating",
                    attempts=attempts, error=repr(e),
                )
            except BaseException as e:
                for src in index_sources.values():
                    src.reader.expire()
                self._set_hydration(
                    desc.name, "stalled",
                    attempts=attempts, error=repr(e),
                )
                raise

    def _recover_dict_exhaustion(self, conn) -> dict:
        """The reference rebalances the string dictionary, remaps the
        codes in every installed description and rebuilds every
        dataflow. The port's dictionary cannot rebalance."""
        raise NotImplementedError(
            "dictionary rebalance and rebuild are not ported "
            "(ROADMAP Queue 1 item 6b: expr/remap.py)"
        )

    def _dependents_of(self, name: str) -> list[str]:
        """Installed dataflows that index-import `name`, transitively
        (subscribers hold a direct reference to the publisher's view, so
        rebuilding a publisher must cascade to them)."""
        out: list[str] = []
        frontier = {name}
        while frontier:
            nxt = set()
            for dn, inst in self.dataflows.items():
                if dn in out or dn in frontier:
                    continue
                pubs = {
                    p
                    for p, _s in getattr(
                        inst.desc, "index_imports", {}
                    ).values()
                }
                if pubs & frontier:
                    nxt.add(dn)
            out.extend(sorted(nxt))
            frontier = nxt
        return out

    def _rebuild_cascade(self, name: str, new_desc=None) -> None:
        """Rebuild `name` (optionally with a replacement description)
        and, in dependency order, every installed dataflow that
        index-imports it — their IndexSources must re-subscribe to the
        NEW publisher view."""
        deps = self._dependents_of(name)
        inst = self.dataflows.get(name)
        if inst is not None:
            inst.view.expire()
        desc = new_desc if new_desc is not None else inst.desc
        self.dataflows[name] = self._build(desc)
        self._count_recovery(name, "rebuilds")
        for dn in deps:
            dinst = self.dataflows.get(dn)
            if dinst is None:
                continue
            dinst.view.expire()
            self.dataflows[dn] = self._build(dinst.desc)
            self._count_recovery(dn, "rebuilds")

    def _send_installed(self, conn, name: str, error) -> None:
        """Install ack: the DDL response path waits on these so a bad
        plan surfaces AT CREATE TIME instead of as a later "no such
        dataflow" peek error."""
        if conn is None:
            return
        try:
            ctp.send_msg(
                conn,
                {
                    "kind": "DataflowInstalled",
                    "name": name,
                    "error": error,
                    "replica_id": self.replica_id,
                },
            )
        except (ctp.TransportError, OSError):
            pass

    def _send_status(self, conn, error: str) -> None:
        if conn is None:
            return
        try:
            ctp.send_msg(
                conn,
                {
                    "kind": "Status",
                    "error": error,
                    "replica_id": self.replica_id,
                },
            )
        except (ctp.TransportError, OSError):
            pass

    def _handle_command(self, conn, cmd: dict) -> None:
        kind = cmd["kind"]
        if kind == "CreateDataflow":
            # Adopt the DDL statement's propagated trace context:
            # the install/hydration span joins the SAME
            # tree as the coordinator's sequencing spans, piggybacked
            # back on the next Frontiers report.
            from ..utils.trace import TRACER

            with TRACER.adopt(cmd.get("trace")), TRACER.span(
                "replica.install", dataflow=cmd["desc"].name
            ):
                self._handle_create_dataflow(conn, cmd)
        elif kind == "DropDataflow":
            inst = self.dataflows.pop(cmd["name"], None)
            self._recovery.pop(cmd["name"], None)
            self._recovery_dirty.discard(cmd["name"])
            self._hydration.pop(cmd["name"], None)
            self._hydration_dirty.discard(cmd["name"])
            if inst is not None:
                inst.view.expire()
        elif kind == "Peek":
            self.pending_peeks.append(cmd)
        elif kind == "CancelPeek":
            self.pending_peeks = [
                p for p in self.pending_peeks
                if p["peek_id"] != cmd["peek_id"]
            ]
        elif kind == "AllowCompaction":
            from ..utils.dyncfg import (
                ARRANGEMENT_COMPACTION_BATCHES,
                COMPACTION_MODE,
                COMPUTE_CONFIGS,
            )

            inst = self.dataflows.get(cmd["dataflow"])
            if inst is not None:
                mode = COMPACTION_MODE(COMPUTE_CONFIGS)
                for s in inst.view.sources.values():
                    s.reader.downgrade_since(cmd["since"])
                    if mode == "off":
                        continue
                    if mode == "inline":
                        # Pre-ISSUE-20 behavior: merge on the worker
                        # loop (blocks command drain + span stepping).
                        s.reader.machine.maybe_compact(
                            max_batches=ARRANGEMENT_COMPACTION_BATCHES(
                                COMPUTE_CONFIGS
                            ),
                            ctx="inline",
                        )
                    # "background": the reference hands the shard to its
                    # compaction service; the port's waits for ROADMAP
                    # Queue 1 item 6b, so the since moves and the shard
                    # keeps its parts.
        elif kind == "UpdateConfiguration":
            # Command-stream ordering makes every worker flip the flags
            # at the same point (compute_state.rs:46-59 analog). The
            # process-global ConfigSet is the read site for rendering
            # decisions (delta-join breadth, temporal filters, ...).
            from ..utils.dyncfg import COMPUTE_CONFIGS

            self.config.update(cmd["params"])
            COMPUTE_CONFIGS.update(cmd["params"])
            if "trace_level" in cmd["params"]:
                # The trace_level dyncfg drives THIS process's span
                # recorder too (log_filter propagation).
                from ..utils.trace import LEVELS, TRACER

                lvl = cmd["params"]["trace_level"]
                if lvl is None:  # reset-to-default delta
                    from ..utils.dyncfg import TRACE_LEVEL

                    lvl = TRACE_LEVEL.default
                if lvl in LEVELS:
                    TRACER.set_level(lvl)

    def _handle_create_dataflow(self, conn, cmd: dict) -> None:
        desc: DataflowDescription = cmd["desc"]
        existing = self.dataflows.get(desc.name)
        if (
            existing is not None
            and existing.fingerprint == desc.fingerprint()
        ):
            existing.reported_upper = -1  # re-report frontier
            # The counted reconciliation invariant: a
            # kept dataflow increments `reconciles` and NOT
            # `rebuilds` — a restarted controller whose replayed
            # descriptions fingerprint-match must leave
            # rebuilds == 0 (asserted in tests via mz_recovery).
            self._count_recovery(desc.name, "reconciles")
            # A reconciled dataflow kept its device state: it IS
            # hydrated (the new controller's board starts at pending).
            self._set_hydration(desc.name, "hydrated")
            self._send_installed(conn, desc.name, None)
            return  # reconciliation: unchanged, keep running
        try:
            if existing is not None:
                # Replaced: rebuild it AND everything that imports
                # its arrangement (subscribers hold direct view
                # references).
                self._rebuild_cascade(desc.name, new_desc=desc)
            else:
                self.dataflows[desc.name] = self._build(desc)
                self._count_recovery(desc.name, "installs")
        except Exception as e:
            # A bad plan must not kill the replica: report and skip
            # (scoped halt!; the reference would crash-loop the whole
            # process, we keep sibling dataflows alive).
            err = f"CreateDataflow {desc.name!r} failed: {e!r}"
            self._set_hydration(desc.name, "stalled", error=err)
            self._send_status(conn, err)
            self._send_installed(conn, desc.name, err)
        else:
            self._send_installed(conn, desc.name, None)

    def _serve_peeks(self, conn) -> bool:
        served = False
        keep = []
        lookup_buckets: dict = {}
        for p in self.pending_peeks:
            inst = self.dataflows.get(p["dataflow"])
            if inst is None:
                ctp.send_msg(
                    conn,
                    {
                        "kind": "PeekResponse",
                        "peek_id": p["peek_id"],
                        "error": f"no such dataflow {p['dataflow']}",
                        "replica_id": self.replica_id,
                    },
                )
                served = True
                continue
            as_of = p["as_of"]
            if as_of is not None and inst.view.upper <= as_of:
                # Peek timestamp sequencing under pipelined ticks:
                # the data may already be DISPATCHED in an
                # in-flight span — commit its boundary before deciding
                # the peek is not ready, so an admitted peek never
                # waits a full extra span behind the committed
                # frontier.
                inst.view.sync_spans()
            if as_of is not None and inst.view.upper <= as_of:
                keep.append(p)  # not yet complete at as_of
                continue
            # Every serving path below reads maintained state; it must
            # observe a COMMITTED span boundary, never the in-flight
            # span's half-applied carry.
            inst.view.sync_spans()
            # ok/err pair: a nonempty err collection poisons reads until
            # the offending rows are retracted (render.rs:12-101 — "SQL
            # picks an arbitrary error if errs nonempty").
            errs = inst.view.df.peek_errors()
            if errs:
                from ..expr.errors import MESSAGES

                code = errs[0][0]
                msg = MESSAGES.get(code, f"evaluation error {code}")
                ctp.send_msg(
                    conn,
                    {
                        "kind": "PeekResponse",
                        "peek_id": p["peek_id"],
                        "error": f"Evaluation error: {msg}",
                        "replica_id": self.replica_id,
                    },
                )
                served = True
                continue
            if p.get("lookup") is not None:
                # Batched fast-path gather (coord/peek.py): collect
                # every READY lookup for the same (dataflow, binding)
                # this pass — they merge into ONE device gather below
                # (the replica-side span tick; concurrent controller
                # batches coalesce further here). No transient
                # dataflow exists, nothing to render.
                spec = p["lookup"]
                from ..utils.dyncfg import (
                    COMPUTE_CONFIGS,
                    PEEK_BATCHING,
                )

                # With peek_batching OFF the plane is per-peek end to
                # end: every command pays its own gather dispatch (the
                # serial baseline bench.py --serve measures against).
                merge_key = (
                    None
                    if PEEK_BATCHING(COMPUTE_CONFIGS)
                    else p["peek_id"]
                )
                lookup_buckets.setdefault(
                    (
                        p["dataflow"],
                        tuple(spec.get("bound_cols") or ()),
                        bool(spec.get("scan")),
                        merge_key,
                    ),
                    [],
                ).append(p)
                continue
            exact = bool(p.get("exact")) and as_of is not None
            if exact and as_of != inst.view.upper - 1:
                # AS OF inside the multiversion window: rewind the
                # maintained result by the retained deltas in
                # (as_of, upper) instead of serving the live frontier.
                from ..repr.schema import decode_result_rows
                from ..storage.persist.operators import AsOfError

                try:
                    cols, nulls, time, diff = inst.view.updates_as_of(
                        as_of
                    )
                    rows = decode_result_rows(
                        inst.view.df.out_schema, cols, nulls, time, diff
                    )
                except AsOfError as e:
                    ctp.send_msg(
                        conn,
                        {
                            "kind": "PeekResponse",
                            "peek_id": p["peek_id"],
                            "error": str(e),
                            "replica_id": self.replica_id,
                        },
                    )
                    served = True
                    continue
                ctp.send_msg(
                    conn,
                    {
                        "kind": "PeekResponse",
                        "peek_id": p["peek_id"],
                        "rows": rows,
                        "served_at": as_of,
                        "replica_id": self.replica_id,
                    },
                )
                served = True
                continue
            t_wall, t0 = _time.time(), _time.perf_counter()
            rows = _result_rows(inst.view.result_batch(), inst.view.df)
            ctp.send_msg(
                conn,
                {
                    "kind": "PeekResponse",
                    "peek_id": p["peek_id"],
                    "rows": rows,
                    "served_at": inst.view.upper - 1,
                    "replica_id": self.replica_id,
                },
            )
            # The statement's replica-side span: recorded
            # under the peek command's propagated context, shipped back
            # on the next Frontiers piggyback — one tree per statement.
            self._record_serve_span(
                p, t_wall, t0, dataflow=p["dataflow"], rows=len(rows)
            )
            served = True
        self.pending_peeks = keep
        for (
            df_name, bound_cols, scan, _mk
        ), ps in lookup_buckets.items():
            served = True
            self._serve_lookup_bucket(
                conn, df_name, bound_cols, scan, ps
            )
        return served

    def _record_serve_span(
        self, cmd: dict, t_wall: float, t0: float, **attrs
    ) -> None:
        """Retroactive replica-side peek span under the command's
        propagated trace context (no-op at level off / untraced)."""
        from ..utils.trace import TRACER

        if not TRACER.enabled("info"):
            return
        with TRACER.adopt(cmd.get("trace")):
            TRACER.record(
                "replica.peek", t_wall, _time.perf_counter() - t0,
                **attrs,
            )

    def _serve_lookup_bucket(
        self, conn, df_name: str, bound_cols: tuple, scan: bool, ps
    ) -> None:
        """Serve every ready lookup peek sharing one (dataflow,
        binding) signature with ONE stacked gather: the probes of all
        pending commands concatenate into a single program call, and
        each command gets its slice of the result groups back."""
        from .peek import serve_peek_groups

        # Bound the merged gather at a fixed probe tier: an unbounded
        # merge would hit ever-larger pow2 batch lanes, each paying a
        # fresh XLA compile mid-serving.
        MERGE_CAP = 128
        if len(ps) > 1:
            total = sum(
                len(p["lookup"].get("probes") or []) for p in ps
            )
            if total > MERGE_CAP:
                chunk: list = []
                n = 0
                for p in ps:
                    k = len(p["lookup"].get("probes") or [])
                    if chunk and n + k > MERGE_CAP:
                        self._serve_lookup_bucket(
                            conn, df_name, bound_cols, scan, chunk
                        )
                        chunk, n = [], 0
                    chunk.append(p)
                    n += k
                if chunk:
                    self._serve_lookup_bucket(
                        conn, df_name, bound_cols, scan, chunk
                    )
                return
        inst = self.dataflows.get(df_name)
        all_probes: list = []
        slices: list = []
        for p in ps:
            probes = p["lookup"].get("probes") or []
            slices.append((len(all_probes), len(probes)))
            all_probes.extend(probes)
        t_wall, t0 = _time.time(), _time.perf_counter()
        try:
            if inst is None:
                raise RuntimeError(f"no such dataflow {df_name}")
            # Gathers read the maintained spine directly: sequence to
            # a committed span boundary first (no half-applied carry).
            inst.view.sync_spans()
            groups = serve_peek_groups(
                inst.view,
                {
                    "scan": scan,
                    "bound_cols": bound_cols,
                    "probes": all_probes,
                },
            )
            served_at = inst.view.upper - 1
            self._record_serve_span(
                next((p for p in ps if p.get("trace")), ps[0]),
                t_wall, t0, dataflow=df_name, probes=len(all_probes),
                batched=len(ps),
            )
        except Exception as e:
            for p in ps:
                ctp.send_msg(
                    conn,
                    {
                        "kind": "PeekResponse",
                        "peek_id": p["peek_id"],
                        "error": f"peek lookup failed: {e!r}",
                        "replica_id": self.replica_id,
                    },
                )
            return
        for p, (lo, n) in zip(ps, slices):
            ctp.send_msg(
                conn,
                {
                    "kind": "PeekResponse",
                    "peek_id": p["peek_id"],
                    "rows_groups": (
                        groups if scan else groups[lo : lo + n]
                    ),
                    "served_at": served_at,
                    "replica_id": self.replica_id,
                },
            )

    def _report_frontiers(self, conn) -> bool:
        changed = {}
        records = {}
        epochs = {}
        abytes = {}
        for name, inst in self.dataflows.items():
            upper = inst.view.upper
            if upper != inst.reported_upper:
                changed[name] = upper
                inst.reported_upper = upper
                # Monotone span-epoch counter: the committed
                # span boundary this frontier belongs to — peeks and
                # compaction decisions sequence against it.
                epochs[name] = inst.view.span_epoch
                # Arrangement introspection (mz_arrangement_sizes
                # analog): the output arrangement's current row count.
                # One small device->host read, only on frontier change
                # (may slightly overcount rows an in-flight span is
                # still inserting — introspection only).
                records[name] = inst.view.df.output_records()
                # Device-resident bytes by spine component:
                # pure metadata (shape * itemsize off the avals — no
                # device read), same cadence as the row count.
                abytes[name] = inst.view.device_bytes()
        # Recovery counters ride the frontier report the
        # same way: only when they changed (install, rebuild,
        # reconciliation) — steady state ships nothing extra.
        recovery = {}
        if self._recovery_dirty:
            dirty, self._recovery_dirty = self._recovery_dirty, set()
            for name in dirty:
                rec = self._recovery.get(name)
                if rec is not None and name in self.dataflows:
                    recovery[name] = dict(rec)
        # Freshness piggyback: hydration status transitions ship on
        # EVERY report path (dirty-set — the controller board is keyed
        # by replica, so in-process replicas can't double-count). The
        # port records no lag (coord/freshness.py).
        freshness = {}
        if self._hydration_dirty:
            dirty, self._hydration_dirty = self._hydration_dirty, set()
            status = {
                name: dict(self._hydration[name])
                for name in dirty
                if name in self._hydration
            }
            if status:
                freshness["status"] = status
        if changed or recovery or freshness:
            ctp.send_msg(
                conn,
                ctp.frontiers(
                    changed, records, epochs, self.replica_id,
                    recovery=recovery, arrangement_bytes=abytes,
                    freshness=freshness,
                ),
            )
            return True
        return False

def serve_forever(
    port: int,
    location: PersistLocation,
    replica_id: str = "r0",
    ready_event: threading.Event | None = None,
    workers: int = 1,
    ship_observability: bool = False,
    handle: list | None = None,
    device=None,
) -> None:
    """Serve one replica on ``127.0.0.1:port`` until ``stop()`` (the
    worker is appended to ``handle`` when given). ``device`` names where
    its dataflows live (default ``"cuda"``; raises without a card)."""
    worker = ReplicaWorker(
        location=location, replica_id=replica_id, workers=workers,
        ship_observability=ship_observability, device=device,
    )
    if handle is not None:
        # In-process lifecycle hook: the caller gets the worker so it
        # can stop the thread replica (worker.stop() exits serve()
        # within its 0.2s accept timeout).
        handle.append(worker)
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    sock.bind(("127.0.0.1", port))
    sock.listen(4)
    if ready_event is not None:
        ready_event.set()
    try:
        worker.serve(sock)
    finally:
        sock.close()


def main() -> None:
    raise NotImplementedError(
        "the subprocess replica entry point is not ported (ROADMAP Queue "
        "1 item 6b, with environmentd); run serve_forever on a thread"
    )
