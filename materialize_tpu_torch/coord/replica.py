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

Run as a subprocess:
    python -m materialize_tpu_torch.coord.replica --port P --blob DIR \
        --consensus FILE [--replica-id R] [--device cuda] \
        [--workers N [--backend nccl|gloo]]

or in-process (``serve_forever`` on a thread, one worker). With
``--workers N`` > 1 (the command only) the process is rank 0 of an SPMD
mesh: it starts N-1 follower processes
(``--follow``, ``coord/spmd.py``), its dataflows are
``ShardedDataflow``s, and a follower that dies fails the replica. The
replica steps its
dataflows on the device it is given (``--device`` / ``device=``, default
``"cuda"``; no card means an error, never the CPU). All device work
stays on the worker thread (``_worker_loop``); peek responses cross the
protocol as Python rows, never as tensors. A subprocess replica ships
its observability on its Frontiers reports (``ship_observability``):
trace spans, /metrics families (the merge-path kernel's launch count and
the replica's peak device bytes among them), lag records, compaction
stats and compile records (its native library builds and loads,
``utils/compile_ledger.py``). A string-dictionary label gap run dry
rebalances the dictionary, remaps every installed description's codes
(``expr/remap.py``) and rebuilds every dataflow from durable state. Not
ported yet, each raising with its ROADMAP item: async compile and hot
swap (Queue 2 item 6: the program bank has no
counterpart in eager torch).
"""

from __future__ import annotations

import argparse
import queue
import socket
import threading
import time as _time

from .. import resolve_device
from ..render.dataflow import Dataflow
from ..repr.schema import DictExhausted
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

# True once this interpreter runs the replica command (``main``): the
# only place an SPMD replica (workers > 1) may start.
_AS_COMMAND = False


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
        spmd_backend: str | None = None,
    ):
        self.device = resolve_device(device)
        # Workers per replica = ranks of its SPMD mesh (the reference's
        # TimelyConfig.workers): 1 renders single-device dataflows; P > 1
        # makes this process rank 0 of P, starting P-1 follower
        # processes (coord/spmd.py) before it serves. A mesh it cannot
        # place (NCCL with more workers than cards) fails the boot. Rank
        # 0 joins the process-wide torch.distributed group and exits the
        # process when a follower dies, so only the replica command
        # (``main``) may take P > 1; an in-process replica is refused.
        if workers > 1:
            from ..parallel.mesh import check_backend, default_backend

            check_backend(spmd_backend or default_backend(self.device), self.device,
                          workers)
            if not _AS_COMMAND:
                raise ValueError(
                    f"a replica of {workers} workers runs only as its own process: "
                    "python -m materialize_tpu_torch.coord.replica --workers "
                    f"{workers}; an in-process replica takes workers=1")
        self._spmd = None
        if persist_client is not None:
            self.client = persist_client
        else:
            assert location is not None
            self.client = PersistClient(
                FileBlob(location.blob_root),
                SqliteConsensus(location.consensus_path),
                # Production client: sink-shard appends request
                # background compaction per the compaction_mode dyncfg
                # instead of growing the spine forever.
                auto_compaction=True,
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
        # Observability piggybacks: completed trace spans and compile-
        # ledger records (native library builds and loads) queue for the
        # Frontiers report; /metrics snapshots ship on a throttle, only
        # when changed. Shipping is enabled only for SUBPROCESS replicas
        # (ship_observability, set by the `-m ...coord.replica` entry
        # point): an in-process replica shares the coordinator's
        # process-global rings and registry, so its spans are already
        # visible locally and shipping them would only pickle bytes
        # over loopback for the controller's pid-dedupe to drop (and
        # double-report metrics, which carry no pid).
        if ship_observability:
            from ..utils.compile_ledger import LEDGER as _LEDGER
            from ..utils.trace import TRACER as _TRACER
            from .freshness import FRESHNESS as _FRESHNESS

            _LEDGER.enable_ship()
            _TRACER.enable_ship()
            _FRESHNESS.enable_ship()
        self._ship_observability = bool(ship_observability)
        # Hydration status machine (freshness plane): per-dataflow
        # pending -> hydrating -> hydrated -> stalled with attempt
        # count and last error. Unlike lag records, status entries ship
        # on EVERY Frontiers report path (dirty-set, keyed by replica
        # on the controller board — no pid-dedupe question arises).
        self._hydration: dict[str, dict] = {}
        self._hydration_dirty: set = set()
        self._metrics_last_ship = 0.0
        self._metrics_last: list | None = None
        self._stop = threading.Event()
        # A rebalance initiated ELSEWHERE in this process (e.g. the
        # coordinator replanning after a planning-time exhaustion)
        # invalidates our device-resident codes too: queue the remaps
        # and rebuild from the worker loop (single-threaded owner).
        self._pending_remaps: list[dict] = []
        from ..utils.locks import tracked_lock

        self._remap_lock = tracked_lock("replica.remap")

        def _on_rebalance(remap, _self=self):
            with _self._remap_lock:
                _self._pending_remaps.append(remap)

        from ..repr.schema import GLOBAL_DICT

        self._rebalance_listener = _on_rebalance
        GLOBAL_DICT.add_rebalance_listener(_on_rebalance)
        if workers > 1:
            from .spmd import SpmdLeader

            self._spmd = SpmdLeader(workers, self.device, spmd_backend, replica_id,
                                    on_failure=self._spmd_failed)

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

    def _spmd_failed(self, reason: str) -> None:
        """A follower rank died: the replica command exits non-zero,
        never carrying on with fewer workers."""
        import os
        import sys

        print(f"replica {self.replica_id}: {reason}", file=sys.stderr, flush=True)
        os._exit(3)

    def stop(self) -> None:
        self._stop.set()
        from ..repr.schema import GLOBAL_DICT

        GLOBAL_DICT.remove_rebalance_listener(self._rebalance_listener)

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
            if self._drain_pending_remaps(conn):
                worked = True
            from ..utils.dyncfg import COMPUTE_CONFIGS, SPAN_PIPELINING

            pipelined = SPAN_PIPELINING(COMPUTE_CONFIGS)
            for name, inst in list(self.dataflows.items()):
                t_step = _time.perf_counter()
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
                        step_seconds().observe(
                            _time.perf_counter() - t_step
                        )
                except SinkConflict:
                    # Another replica's durable chunking won a hydration
                    # race: rebuild this view from the durable shard
                    # (fresh dataflow state; hydrate resumes exactly).
                    self._rebuild_cascade(name)
                    worked = True
                except DictExhausted:
                    # A step's string-table build ran a label gap dry:
                    # rebalance and rebuild everything (scoped recovery,
                    # not a halt — all state is durable or rebuildable).
                    self._recover_dict_exhaustion(conn)
                    worked = True
                except Exception as e:  # halt!-analog, scoped to the df
                    self.dataflows.pop(name, None)
                    inst.view.expire()
                    # A runtime failure is a freshness stall, not just
                    # a status line: mz_hydration_statuses shows it.
                    self._set_hydration(name, "stalled", error=repr(e))
                    self._send_status(
                        conn, f"dataflow {name!r} failed: {e!r}"
                    )
                    worked = True
            try:
                worked |= self._serve_peeks(conn)
            except DictExhausted:
                # A peek's string work can run a gap dry too: same
                # recovery as the step path. The peek stays pending and
                # is served after the rebuild.
                self._recover_dict_exhaustion(conn)
                worked = True
            worked |= self._report_frontiers(conn)
            if not worked:
                _time.sleep(0.002)  # park

    def _make_dataflow(self, desc: DataflowDescription):
        if self._spmd is None:
            return Dataflow(desc.expr, name=desc.name, device=self.device)
        from ..render.dataflow import ShardedDataflow

        # Installs stay synchronous under SPMD (the reference's too):
        # every rank renders the same plan now.
        df = ShardedDataflow(desc.expr, self._spmd.mesh, name=desc.name)
        self._spmd.install(df, desc.expr, {})
        return df

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
        from .freshness import status_entry

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

    def _drain_pending_remaps(self, conn) -> bool:
        """Apply rebalances initiated elsewhere in this process: remap
        installed descs through every queued remap (in order) and
        rebuild all dataflows once."""
        with self._remap_lock:
            remaps, self._pending_remaps = self._pending_remaps, []
        if not remaps:
            return False
        for remap in remaps:
            self._remap_descs(remap)
        self._rebuild_all(conn, "external rebalance")
        return True

    def _recover_dict_exhaustion(self, conn) -> dict:
        """String-dictionary gap exhaustion recovery (repr/schema.py
        DictExhausted): rebalance the label space, remap the string
        codes embedded in every installed description's MIR, and rebuild
        ALL dataflows in install order (publishers precede subscribers
        in command history, so index imports resolve). Device state is
        rebuilt from durable shards, which store actual strings
        (storage/persist/codec.py) — codes re-enter via decode under the
        new labeling. In-process rebalance listeners (controller command
        history, sibling workers' descs) fire inside rebalance()."""
        from ..repr.schema import GLOBAL_DICT

        remap = GLOBAL_DICT.rebalance()
        # Our rebalance's remap (and any earlier/concurrent ones) sit in
        # the listener queue in CHRONOLOGICAL order; applying them FIFO
        # composes correctly no matter how they interleaved. Drain up to
        # and including our own.
        with self._remap_lock:
            queued, self._pending_remaps = self._pending_remaps, []
        applied_own = False
        for r in queued:
            self._remap_descs(r)
            if r is remap:
                applied_own = True
        if not applied_own:
            self._remap_descs(remap)
        self._rebuild_all(conn, "dictionary rebalance")
        return remap

    def _rebuild_all(self, conn, why: str) -> None:
        """Expire + rebuild every installed dataflow from its (already
        remapped) description, tolerating per-dataflow failures: one
        broken rebuild must not leave the rest expired. Failed ones are
        dropped (their stale-marker fingerprint makes reconnect
        reconciliation reinstall them from history)."""
        from ..repr.schema import GLOBAL_DICT

        for name, inst in list(self.dataflows.items()):
            inst.view.expire()
        failed = []
        for name, inst in list(self.dataflows.items()):
            try:
                self.dataflows[name] = self._build(inst.desc)
                self._count_recovery(name, "rebuilds")
            except Exception as e:
                failed.append(name)
                self.dataflows.pop(name, None)
                self._send_status(
                    conn,
                    f"rebuild of {name!r} after {why} failed: {e!r}",
                )
        self._send_status(
            conn,
            f"dictionary epoch {GLOBAL_DICT.epoch}: "
            f"{len(self.dataflows)} dataflows rebuilt after {why}"
            + (f"; {len(failed)} failed: {failed}" if failed else ""),
        )

    def _remap_descs(self, remap: dict) -> None:
        import dataclasses as _dc

        from ..expr.remap import remap_relation

        for name, inst in list(self.dataflows.items()):
            new_expr = remap_relation(inst.desc.expr, remap)
            if new_expr is not inst.desc.expr:
                inst.desc = _dc.replace(inst.desc, expr=new_expr)
                # Never-matching marker until the REBUILD succeeds: a
                # remapped-but-not-rebuilt dataflow must not pass
                # reconnect reconciliation (its device state still
                # holds old-labeling codes).
                inst.fingerprint = b"\x00stale-remap"

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
                if self._spmd is not None:
                    self._spmd.drop(cmd["name"])
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
                        # The synchronous discipline: merge on the worker
                        # loop (blocks command drain + span stepping).
                        s.reader.machine.maybe_compact(
                            max_batches=ARRANGEMENT_COMPACTION_BATCHES(
                                COMPUTE_CONFIGS
                            ),
                            ctx="inline",
                        )
                    else:
                        from ..storage.persist.compactor import (
                            compaction_service,
                        )

                        compaction_service().request(s.reader.machine)
        elif kind == "UpdateConfiguration":
            # Command-stream ordering makes every worker flip the flags
            # at the same point (compute_state.rs:46-59 analog). The
            # process-global ConfigSet is the read site for rendering
            # decisions (delta-join breadth, temporal filters, ...).
            from ..utils.dyncfg import COMPUTE_CONFIGS

            self.config.update(cmd["params"])
            COMPUTE_CONFIGS.update(cmd["params"])
            if self._spmd is not None:
                self._spmd.config(cmd["params"])
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
        except DictExhausted:
            # Dense string insertions (e.g. a generative function's
            # table over a polluted dictionary) ran a label gap dry.
            # Rebalance + rebuild everything, then retry the
            # install with remapped codes. Each rebalance evens ALL
            # current strings, so repeated attempts make monotone
            # progress; the bound guards a pathological treadmill.
            import dataclasses as _dc

            from ..expr.remap import remap_relation

            desc2, err = desc, None
            for _attempt in range(4):
                try:
                    # A REPLACEMENT keeps the old dataflow in place
                    # through the rebuild-all (its subscribers must
                    # resolve their index imports); only a fresh
                    # install attempt is dropped first.
                    if existing is None:
                        self.dataflows.pop(desc.name, None)
                    remap = self._recover_dict_exhaustion(conn)
                    # The incoming desc was planned pre-rebalance:
                    # remap its codes too (the recovery pass only
                    # covers already-installed descs).
                    new_expr = remap_relation(desc2.expr, remap)
                    if new_expr is not desc2.expr:
                        desc2 = _dc.replace(desc2, expr=new_expr)
                    if existing is not None:
                        self._rebuild_cascade(
                            desc2.name, new_desc=desc2
                        )
                    else:
                        self.dataflows[desc2.name] = self._build(
                            desc2
                        )
                        self._count_recovery(
                            desc2.name, "installs"
                        )
                    err = None
                    break
                except DictExhausted as e:
                    err = (
                        f"CreateDataflow {desc.name!r} failed "
                        f"after dictionary rebalance: {e!r}"
                    )
                except Exception as e:
                    err = (
                        f"CreateDataflow {desc.name!r} failed "
                        f"after dictionary rebalance: {e!r}"
                    )
                    break
            if err is None:
                self._send_installed(conn, desc.name, None)
            else:
                if existing is None:
                    self.dataflows.pop(desc.name, None)
                self._set_hydration(desc.name, "stalled", error=err)
                self._send_status(conn, err)
                self._send_installed(conn, desc.name, err)
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
        donation = {}
        sharding = {}
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
            # Donation verdicts ride the frontier report only when the
            # verdict changed (a new subscriber, a dyncfg flip): steady
            # state ships nothing extra.
            if inst.view._donation_dirty:
                info = inst.view.donation_info()
                if info is not None:
                    donation[name] = info
                inst.view._donation_dirty = False
            # Sharding reports ride the same way: shipped once at
            # install (a render-time fact), again only after a rebuild.
            if inst.view._sharding_dirty:
                info = inst.view.sharding_info()
                if info is not None:
                    sharding[name] = info
                inst.view._sharding_dirty = False
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
        # Observability piggybacks: completed trace spans ship whenever
        # present (empty in steady state / tracing off); the /metrics
        # snapshot ships on the metrics_report_ms throttle and only when
        # some value changed. Subprocess replicas only (see __init__).
        spans, compiles, metrics = [], [], None
        if self._ship_observability:
            from ..utils.compile_ledger import LEDGER
            from ..utils.trace import TRACER

            spans = TRACER.drain_shippable()
            compiles = LEDGER.drain_shippable()
            metrics = self._metrics_snapshot()
        # Freshness piggyback: hydration status transitions ship on
        # EVERY report path (dirty-set — the controller board is keyed
        # by replica, so in-process replicas can't double-count); lag
        # records ship only from subprocess replicas (in-process ones
        # share the process-global FRESHNESS ring, and the controller's
        # pid-dedupe would drop the copies anyway).
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
        if self._ship_observability:
            from .freshness import FRESHNESS

            lag = FRESHNESS.drain_shippable()
            if lag:
                freshness["lag"] = lag
        # Compaction stats ride the same way: dirty-set of
        # shards whose counters moved since the last report. Subprocess
        # replicas only — in-process ones share the process-global
        # registry the coordinator serves directly.
        compactions = {}
        if self._ship_observability:
            from ..storage.persist.compactor import STATS as _CSTATS

            compactions = _CSTATS.take_dirty()
        if (changed or donation or sharding or recovery or spans
                or compiles or metrics or freshness or compactions):
            ctp.send_msg(
                conn,
                ctp.frontiers(
                    changed, records, epochs, self.replica_id,
                    donation=donation, sharding=sharding,
                    recovery=recovery, spans=spans, compiles=compiles,
                    metrics=metrics,
                    arrangement_bytes=abytes, freshness=freshness,
                    compactions=compactions,
                ),
            )
            return True
        return False

    def _metrics_snapshot(self) -> list | None:
        """This process's /metrics families for the controller-side
        merged exposition, at most once per metrics_report_ms and only
        on change (None = nothing to ship this report). The device
        gauges are sampled first: the merge-path kernel's launches in
        this process and the replica's peak device bytes."""
        from ..utils.dyncfg import COMPUTE_CONFIGS, METRICS_REPORT_MS
        from ..utils.metrics import REGISTRY

        interval = float(METRICS_REPORT_MS(COMPUTE_CONFIGS)) / 1000.0
        now = _time.monotonic()
        if now - self._metrics_last_ship < max(interval, 0.05):
            return None
        _sample_device_metrics(self.device)
        fams = REGISTRY.families()
        if fams == self._metrics_last:
            self._metrics_last_ship = now
            return None
        self._metrics_last = fams
        self._metrics_last_ship = now
        return fams


def step_seconds():
    """Histogram of the worker thread's dataflow steps (or spans) that
    did work: the replica's own step time, read from its shipped
    /metrics."""
    from ..utils.metrics import REGISTRY

    return REGISTRY.get_or_create(
        "histogram", "mz_replica_step_seconds",
        "seconds of each dataflow step or span that did work on a "
        "replica's worker thread",
    )


class _ShapeLaunches:
    """The merge-path kernel's launches by merge shape
    (``ops/merge_kernel.LAUNCHES_BY_SHAPE``), one sample a shape labeled
    ``cap_a``, ``cap_b``, ``out`` and ``lanes``: what a caller needs to
    run the kernel again at the shapes this process launched."""

    name = "mz_merge_path_launches_by_shape"
    kind = "counter"
    help = "merge-path kernel launches in this process, by merge shape"

    def __init__(self, registry):
        registry._register(self)

    def samples(self):
        from ..ops import merge_kernel

        return [
            (self.name, {"cap_a": str(a), "cap_b": str(b), "out": str(o),
                         "lanes": str(lanes)}, float(n))
            for (a, b, o, lanes), n in sorted(
                merge_kernel.LAUNCHES_BY_SHAPE.items())
        ]


def _sample_device_metrics(device) -> None:
    """Copy this process's device facts into its registry: the
    merge-path kernel's launch count (``ops/merge_kernel.LAUNCHES``,
    which only its wrapper bumps, at a launch) as a counter, and by merge
    shape, the kernel library's load seconds, the peak bytes torch's allocator held on
    the replica's card (0 on the CPU), and the span census
    (``storage/persist/operators.SPANS``)."""
    import torch

    from ..ops import merge_kernel
    from ..utils.metrics import REGISTRY

    launches = REGISTRY.get_or_create(
        "counter", "mz_merge_path_launches_total",
        "merge-path kernel launches in this process",
    )
    gap = merge_kernel.LAUNCHES - launches.value
    if gap > 0:
        launches.inc(gap)
    if REGISTRY.get(_ShapeLaunches.name) is None:
        _ShapeLaunches(REGISTRY)
    REGISTRY.get_or_create(
        "gauge", "mz_merge_path_load_seconds",
        "seconds this process spent building or loading the merge-path "
        "kernel library",
    ).set(float(merge_kernel.BUILD_INFO.get("load_seconds", 0.0)))
    peak = (
        torch.cuda.max_memory_allocated(device)
        if device.type == "cuda" else 0
    )
    REGISTRY.get_or_create(
        "gauge", "mz_device_peak_bytes",
        "peak device bytes torch's allocator held in this process",
    ).set(float(peak))
    from ..storage.persist.operators import SPANS

    for key, name, help_ in (
        ("committed", "mz_span_commits",
         "spans the maintained views of this process committed"),
        ("boundary_readbacks", "mz_span_boundary_readbacks",
         "flags readbacks taken at those spans' boundaries"),
        ("overflows", "mz_span_overflows",
         "those spans whose flags showed an overflow (rolled back, grown "
         "and replayed)"),
        ("max_inflight", "mz_spans_in_flight_max",
         "most spans one view held dispatched past its committed frontier"),
    ):
        REGISTRY.get_or_create("gauge", name, help_).set(float(SPANS[key]))

def serve_forever(
    port: int,
    location: PersistLocation,
    replica_id: str = "r0",
    ready_event: threading.Event | None = None,
    workers: int = 1,
    ship_observability: bool = False,
    handle: list | None = None,
    device=None,
    spmd_backend: str | None = None,
) -> None:
    """Serve one replica on ``127.0.0.1:port`` until ``stop()`` (the
    worker is appended to ``handle`` when given). ``device`` names where
    its dataflows live (default ``"cuda"``; raises without a card);
    ``workers`` > 1 makes it rank 0 of an SPMD mesh over
    ``spmd_backend`` (``parallel/mesh.py``), whose followers stop with
    it; only the replica command (``main``) may ask for that."""
    worker = ReplicaWorker(
        location=location, replica_id=replica_id, workers=workers,
        ship_observability=ship_observability, device=device,
        spmd_backend=spmd_backend,
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
        if worker._spmd is not None:
            worker._spmd.shutdown()


def main() -> None:
    ap = argparse.ArgumentParser(description="materialize_tpu_torch replica")
    ap.add_argument("--replica-id", default="r0")
    ap.add_argument(
        "--workers", type=int, default=1,
        help="ranks of this replica's SPMD mesh: this process and "
        "workers - 1 follower processes",
    )
    ap.add_argument(
        "--device", default="cuda",
        help="where the dataflows live: cuda (default; exits non-zero "
        "without a card) or cpu",
    )
    ap.add_argument(
        "--backend", default=None, choices=("nccl", "gloo"),
        help="the SPMD mesh's backend: by default gloo on the CPU and "
        "NCCL on cards (a rank each); gloo lets ranks share a card",
    )
    ap.add_argument("--follow", action="store_true",
                    help="run as a follower rank of an SPMD replica "
                    "(started by its rank 0, with --rank, --world, --addr)")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--addr", default=None)
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--blob", default=None)
    ap.add_argument("--consensus", default=None)
    args = ap.parse_args()
    if args.follow:
        from .spmd import follow

        raise SystemExit(follow(args.rank, args.world, args.addr,
                                resolve_device(args.device), args.backend))
    if args.port is None or args.blob is None or args.consensus is None:
        ap.error("--port, --blob and --consensus are required")
    # The device is checked before the replica listens: without the card
    # it asks for, it exits non-zero instead of serving on the CPU.
    device = resolve_device(args.device)
    # This interpreter IS the replica: label its span recorder so
    # piggybacked spans carry the replica identity (in-process test
    # replicas share the coordinator's tracer and skip this).
    from ..utils.trace import TRACER

    TRACER.process = f"replica:{args.replica_id}"
    global _AS_COMMAND
    _AS_COMMAND = True
    print(f"replica {args.replica_id} listening on {args.port}", flush=True)
    serve_forever(
        args.port,
        PersistLocation(args.blob, args.consensus),
        args.replica_id,
        workers=args.workers,
        # This interpreter is a dedicated replica: its spans/metrics
        # exist nowhere else, so piggyback them to the controller
        # (in-process replicas skip this — shared rings).
        ship_observability=True,
        device=device,
        spmd_backend=args.backend,
    )


if __name__ == "__main__":
    main()
