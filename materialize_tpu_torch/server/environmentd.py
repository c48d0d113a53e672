"""environmentd: the controller process.

Analog of the reference's ``environmentd`` (``Listeners::serve``,
``environmentd/src/lib.rs:361``): opens the durable catalog, boots the
coordinator + controllers, (optionally) spawns replica subprocesses, and
serves pgwire + HTTP. One command brings up a working deployment:

    python -m materialize_tpu_torch.server.environmentd \
        --data-dir DIR [--pg-port P] [--http-port P] [--replicas N] \
        [--recover] [--device cuda]

Every replica steps its dataflows on ``--device`` (default ``"cuda"``),
and so do the coordinator's introspection reads. A replica that cannot
have its device exits non-zero, and the environment then raises instead
of serving without it. The reference's program bank (``compile/bank.py``)
has no counterpart in eager torch (ROADMAP Queue 2 item 6): no bank is
configured and no compile records are reported.
"""

from __future__ import annotations

import argparse
import atexit
import os
import signal
import socket
import subprocess
import sys
import time as _time

from ..coord.coordinator import Coordinator
from ..storage.persist import FileBlob, PersistClient, SqliteConsensus
from .http import HttpServer
from .pgwire import PgServer


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# Seconds a spawned replica has to connect before the environment gives
# up on it (torch's import and the CUDA context come first).
REPLICA_BOOT_TIMEOUT = 120.0


def spawn_replica(
    data_dir: str, port: int, rid: str, workers: int = 1,
    device: str = "cuda",
) -> subprocess.Popen:
    """One clusterd subprocess (orchestrator-process analog), a fresh
    interpreter started with ``python -m`` (never a fork of a process
    that may hold a CUDA context)."""
    return subprocess.Popen(
        [
            sys.executable, "-m", "materialize_tpu_torch.coord.replica",
            "--port", str(port),
            "--blob", os.path.join(data_dir, "blob"),
            "--consensus", os.path.join(data_dir, "consensus.db"),
            "--replica-id", rid,
            "--workers", str(workers),
            "--device", str(device),
        ],
        env=dict(os.environ),
    )


class Environment:
    """A running deployment: coordinator + replicas + listeners."""

    def __init__(
        self,
        data_dir: str,
        pg_port: int = 0,
        http_port: int = 0,
        n_replicas: int = 1,
        workers: int = 1,
        tick_interval: float | None = 0.05,
        in_process_replicas: bool = False,
        device: str = "cuda",
    ):
        from .. import resolve_device
        from ..utils.locks import tracked_lock

        # The coordinator's device is checked before anything starts.
        resolve_device(device)
        os.makedirs(data_dir, exist_ok=True)
        self.data_dir = data_dir
        self.device = str(device)
        self.procs: list[subprocess.Popen] = []
        self._in_process = in_process_replicas
        self._default_workers = workers
        # Replica registry: rid -> {port, proc|worker+thread,
        # workers}. add/drop/rolling-restart/autoscale actions all
        # serialize on the scale lock — the interleave model
        # `autoscale-vs-restart` pins why (an unserialized check-then-
        # spawn can bust the replica band or drop the last server).
        self.replica_records: dict[str, dict] = {}
        self._scale_lock = tracked_lock("environment.scale")
        self._replica_seq = n_replicas
        self._down = False
        self.coord = None
        # The shutdown is registered before the first replica is
        # spawned: an exit at any later point (a SIGTERM that lands
        # after this constructor returns but before its caller could
        # register anything) still stops every replica process.
        atexit.register(self.shutdown)
        try:
            self._boot(n_replicas, workers, tick_interval, device,
                       pg_port, http_port)
        except BaseException:
            # Never serve, or leave a process behind, without the
            # replicas this deployment spawned.
            self._down = True
            atexit.unregister(self.shutdown)
            if self.coord is not None:
                self.coord.shutdown()
            for rec in self.replica_records.values():
                self._stop_record(rec)
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=5)
            raise

    def _boot(self, n_replicas, workers, tick_interval, device, pg_port,
              http_port) -> None:
        for i in range(n_replicas):
            self._spawn_record(f"r{i}", workers=workers)
        self.coord = Coordinator(
            PersistClient(
                FileBlob(os.path.join(self.data_dir, "blob")),
                SqliteConsensus(
                    os.path.join(self.data_dir, "consensus.db")
                ),
                # Production client: table/catalog appends
                # request leased background compaction off the serving
                # path per the compaction_mode dyncfg.
                auto_compaction=True,
            ),
            tick_interval=tick_interval,
            device=device,
        )
        for rid, rec in self.replica_records.items():
            self.coord.add_replica(rid, ("127.0.0.1", rec["port"]))
        for rid in list(self.replica_records):
            self._await_connected(rid)
        self.pg = PgServer(self.coord, port=pg_port).start()
        self.http = HttpServer(self.coord, port=http_port).start()
        # The SLO-driven autoscaler (coord/autoscaler.py): the policy
        # thread always runs; it acts only while the autoscale_policy
        # dyncfg is non-empty, so SET enables/disables it live.
        from ..coord.autoscaler import Autoscaler

        self.autoscaler = Autoscaler(
            self.coord.controller,
            lambda: self.add_replica(),
            lambda rid: self.drop_replica(rid, drain=True),
        ).start()

    # -- replica lifecycle ---------------------------------------
    def _spawn_record(
        self, rid: str, workers: int | None = None
    ) -> dict:
        """Start one replica (subprocess or in-process thread, matching
        the deployment mode) and register it in the records map. Does
        NOT touch the coordinator — callers pair this with
        coord.add_replica under the scale lock."""
        port = _free_port()
        w = self._default_workers if workers is None else workers
        if self._in_process:
            import threading

            if w > 1:
                # An SPMD replica's rank 0 joins the process-wide
                # torch.distributed group: one per process, so only a
                # replica process may take more workers.
                raise ValueError(
                    f"in-process replicas take workers=1, not {w}: a replica of "
                    "more workers runs as python -m materialize_tpu_torch.coord.replica")

            from ..coord.protocol import PersistLocation
            from ..coord.replica import serve_forever

            ready = threading.Event()
            handle: list = []
            t = threading.Thread(
                target=serve_forever,
                args=(
                    port,
                    PersistLocation(
                        os.path.join(self.data_dir, "blob"),
                        os.path.join(self.data_dir, "consensus.db"),
                    ),
                    rid,
                    ready,
                ),
                kwargs={
                    "workers": w, "handle": handle, "device": self.device,
                },
                daemon=True,
            )
            t.start()
            if not ready.wait(REPLICA_BOOT_TIMEOUT):
                raise RuntimeError(f"in-process replica {rid} did not start")
            rec = {
                "port": port,
                "proc": None,
                "worker": handle[0] if handle else None,
                "thread": t,
                "workers": w,
            }
        else:
            p = spawn_replica(self.data_dir, port, rid, w, self.device)
            self.procs.append(p)
            rec = {
                "port": port, "proc": p, "worker": None,
                "thread": None, "workers": w,
                "spawned_at": _time.monotonic(),
            }
        self.replica_records[rid] = rec
        return rec

    def _await_connected(
        self, rid: str, timeout: float = REPLICA_BOOT_TIMEOUT
    ) -> None:
        """Block until the controller's session with replica ``rid`` is
        up. A subprocess replica that exits first (no card for
        ``--device cuda``, a bad flag) or never connects raises
        ``RuntimeError``. Records the seconds from spawn to connection
        as the record's ``boot_s``."""
        rec = self.replica_records[rid]
        rc = self.coord.controller.replicas[rid]
        p = rec.get("proc")
        t0 = rec.get("spawned_at", _time.monotonic())
        while not rc.connected.wait(0.05):
            if p is not None and p.poll() is not None:
                raise RuntimeError(
                    f"replica {rid} (pid {p.pid}) exited with code "
                    f"{p.returncode} before it connected"
                )
            if _time.monotonic() - t0 > timeout:
                raise RuntimeError(
                    f"replica {rid} did not connect within {timeout:.0f} s"
                )
        rec["boot_s"] = _time.monotonic() - t0

    def _stop_record(self, rec: dict) -> None:
        p = rec.get("proc")
        if p is not None:
            from ..utils.retry import policy as _retry_policy

            budget = _retry_policy("shutdown").budget or 5.0
            p.terminate()
            try:
                p.wait(timeout=budget)
            except subprocess.TimeoutExpired:
                p.kill()
                try:
                    p.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    pass
            if p in self.procs:
                self.procs.remove(p)
        w = rec.get("worker")
        if w is not None:
            w.stop()
            t = rec.get("thread")
            if t is not None:
                t.join(2)

    def add_replica(
        self, rid: str | None = None, workers: int | None = None
    ) -> str:
        """Runtime scale-up (`CREATE CLUSTER REPLICA` analog): spawn,
        register with the controller (the nonce Hello fences it like
        any boot-time replica), and return the name. It hydrates from
        the durable shards and becomes a routing candidate once the
        hydration board flips."""
        with self._scale_lock:
            if self._down:
                raise RuntimeError("environment is shut down")
            if rid is None:
                rid = f"r{self._replica_seq}"
                self._replica_seq += 1
            if rid in self.replica_records:
                raise ValueError(f"replica {rid!r} already exists")
            rec = self._spawn_record(rid, workers=workers)
            self.coord.add_replica(rid, ("127.0.0.1", rec["port"]))
            self._await_connected(rid)
        return rid

    def drop_replica(self, rid: str, drain: bool = True) -> dict:
        """Runtime scale-down (`DROP CLUSTER REPLICA` analog): drain
        (stop routing, move in-flight reads, then drop) or hard-drop,
        then stop the process/thread."""
        with self._scale_lock:
            return self._drop_replica_locked(rid, drain)

    def _drop_replica_locked(self, rid: str, drain: bool) -> dict:
        rec = self.replica_records.pop(rid, None)
        if rec is None:
            return {"dropped": False, "reason": "unknown replica"}
        ctl = self.coord.controller
        if drain:
            out = dict(ctl.drain_replica(rid))
        else:
            ctl.drop_replica(rid)
            out = {"drained": False}
        self._stop_record(rec)
        out["dropped"] = True
        return out

    def rolling_restart(
        self, hydrate_timeout: float = 60.0
    ) -> dict:
        """Restart every replica, one at a time, under live ingest +
        serving. Per replica: wait until every durable dataflow has at
        least one OTHER serving replica, drain it (in-flight reads
        move immediately), stop it, respawn the SAME rid (fenced
        Hello, rehydration from the durable shards), and
        wait until it serves again before touching the next one.

        The "at least one hydrated replica serves every durable
        dataflow at every instant" invariant is CHECKED, not assumed:
        a monitor thread samples `controller.serving_replicas` for
        every durable dataflow throughout and the report carries every
        violation (none = the restart was continuously served).
        `rebuilds` counts the restarted replicas' reported dataflow
        rebuilds — 0 on unchanged fingerprints (reconciliation)."""
        import threading
        import time as _t

        ctl = self.coord.controller
        dataflows = sorted(set(self.coord.peekable.values()))
        monitor_stop = threading.Event()
        violations: list = []
        samples = [0]

        def monitor():
            while not monitor_stop.is_set():
                samples[0] += 1
                for df in dataflows:
                    if not ctl.serving_replicas(df):
                        violations.append((df, samples[0]))
                monitor_stop.wait(0.02)

        mt = threading.Thread(target=monitor, daemon=True)
        mt.start()
        report: dict = {"replicas": [], "aborted": None}
        try:
            for rid in list(self.replica_records):
                with self._scale_lock:
                    if rid not in self.replica_records:
                        continue  # dropped while we iterated
                    entry: dict = {"replica": rid}
                    t0 = _t.monotonic()
                    deadline = t0 + hydrate_timeout
                    # Precondition: losing `rid` must leave every
                    # durable dataflow served by someone else.
                    uncovered = dataflows
                    while _t.monotonic() < deadline:
                        uncovered = [
                            df
                            for df in dataflows
                            if not [
                                r
                                for r in ctl.serving_replicas(df)
                                if r != rid
                            ]
                        ]
                        if not uncovered:
                            break
                        _t.sleep(0.05)
                    if uncovered:
                        entry["error"] = (
                            "no other serving replica for "
                            f"{uncovered}; restart aborted"
                        )
                        report["replicas"].append(entry)
                        report["aborted"] = rid
                        break
                    workers = self.replica_records[rid]["workers"]
                    drained = self._drop_replica_locked(
                        rid, drain=True
                    )
                    entry["moved_reads"] = drained.get("moved", 0)
                    rec = self._spawn_record(rid, workers=workers)
                    self.coord.add_replica(
                        rid, ("127.0.0.1", rec["port"])
                    )
                    while _t.monotonic() < deadline:
                        if all(
                            rid in ctl.serving_replicas(df)
                            for df in dataflows
                        ):
                            break
                        _t.sleep(0.05)
                    entry["seconds"] = round(_t.monotonic() - t0, 3)
                    entry["rehydrated"] = all(
                        rid in ctl.serving_replicas(df)
                        for df in dataflows
                    )
                report["replicas"].append(entry)
        finally:
            monitor_stop.set()
            mt.join(2)
        # The restarted replicas' own rebuild counts (piggybacked on
        # their frontier reports): 0 on unchanged fingerprints.
        restarted = {e["replica"] for e in report["replicas"]}
        rebuilds = 0
        snap = ctl.recovery_snapshot()["dataflows"]
        for df, per in snap.items():
            for rep, counters in per.items():
                if rep in restarted:
                    rebuilds += int(counters.get("rebuilds", 0))
        report["rebuilds"] = rebuilds
        report["invariant"] = {
            "samples": samples[0],
            "violations": violations[:20],
            "continuously_served": not violations,
        }
        return report

    # -- restart recovery ----------------------------------------
    def recovery_report(self) -> dict:
        """What this boot recovered: the coordinator's catalog replay
        counts and the controller's replica/dataflow recovery view
        (the programmatic face of `mz_recovery`). It has no
        ``compiles`` block: no program bank serves compiles in eager
        torch."""
        report = {"coordinator": dict(self.coord.recovery)}
        report.update(self.coord.controller.recovery_snapshot())
        return report

    def await_recovery(self, timeout: float = 120.0) -> dict:
        """Block until every durable dataflow (MV/index) the replayed
        catalog re-registered is installed on some replica, then
        return the recovery report — the --recover boot path's proof
        obligation: the catalog came back AND the dataflows re-rendered
        and re-hydrated (from input-shard snapshots at the persisted
        as_of; storage/persist/operators.py)."""
        import time as _t

        deadline = _t.monotonic() + timeout
        for name in sorted(set(self.coord.peekable.values())):
            self.coord.controller.wait_installed(
                name, timeout=max(deadline - _t.monotonic(), 0.1)
            )
        # Install-acked is not hydrated: wait for the readiness verdict
        # (every durable dataflow hydrated somewhere), so the report
        # describes this boot instead of racing it.
        while _t.monotonic() < deadline:
            if self.coord.health()["ready"]:
                break
            _t.sleep(0.05)
        return self.recovery_report()

    def shutdown(self) -> dict:
        """Stop listeners, coordinator, and replicas. Replica exits
        escalate terminate -> kill when the graceful budget
        (retry_policy_shutdown) expires — a wedged replica must never
        hang shutdown forever — and the exit report says exactly what
        happened to each process."""
        report: dict = {"replicas": [], "escalations": 0}
        if self._down:
            return report
        self._down = True
        atexit.unregister(self.shutdown)
        self.autoscaler.stop()
        # In-process thread replicas stop via their worker handle (the
        # subprocess ones get the terminate -> kill loop below).
        for rec in self.replica_records.values():
            w = rec.get("worker")
            if w is not None:
                w.stop()
        # Stop the process-global background compactor: its queue
        # holds Machines rooted in THIS deployment's blob/consensus; a
        # later Environment starts a fresh one.
        from ..storage.persist import reset_compaction_service

        try:
            reset_compaction_service()
            self.pg.stop()
            self.http.stop()
            self.coord.shutdown()
        finally:
            # The replica processes stop even if a listener or the
            # coordinator failed to.
            self._reap(report)
        return report

    def _reap(self, report: dict) -> None:
        from ..utils.retry import policy as _retry_policy

        budget = _retry_policy("shutdown").budget or 5.0
        for p in self.procs:
            p.terminate()
        deadline = _time.monotonic() + budget
        for p in self.procs:
            entry = {"pid": p.pid, "escalated": False}
            try:
                entry["returncode"] = p.wait(
                    timeout=max(deadline - _time.monotonic(), 0.1)
                )
            except subprocess.TimeoutExpired:
                # Escalate: SIGKILL, then a short bounded reap. A
                # process that survives SIGKILL (unkillable D-state)
                # is reported, not waited on forever.
                entry["escalated"] = True
                report["escalations"] += 1
                p.kill()
                try:
                    entry["returncode"] = p.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    entry["returncode"] = None
            report["replicas"].append(entry)


def main() -> None:
    ap = argparse.ArgumentParser(
        description="materialize_tpu_torch environmentd"
    )
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--pg-port", type=int, default=6875)
    ap.add_argument("--http-port", type=int, default=6876)
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument(
        "--workers", type=int, default=1,
        help="devices per replica (SPMD mesh size)",
    )
    ap.add_argument(
        "--tick-interval", type=float, default=0.05,
        help="load-generator tick seconds",
    )
    ap.add_argument(
        "--recover", action="store_true",
        help="restart-recovery boot: replay the durable catalog, "
        "re-render every dataflow, wait for replicas to re-hydrate "
        "from persist, and print the recovery report before serving",
    )
    ap.add_argument(
        "--device", default="cuda",
        help="where every replica's dataflows and the coordinator's "
        "introspection reads run: cuda (default; exits non-zero without "
        "a card) or cpu",
    )
    args = ap.parse_args()

    def _terminate(signum, frame):
        # SIGTERM ends the deployment cleanly: the exit runs the atexit
        # shutdown that ``Environment`` registers before its first
        # spawn, which stops the replica processes this one started
        # (the reference's process dies on the signal and leaves them).
        raise SystemExit(0)

    signal.signal(signal.SIGTERM, _terminate)
    env = Environment(
        args.data_dir,
        pg_port=args.pg_port,
        http_port=args.http_port,
        n_replicas=args.replicas,
        workers=args.workers,
        tick_interval=args.tick_interval,
        device=args.device,
    )
    if args.recover:
        import json as _json

        report = env.await_recovery()
        print("recovery: " + _json.dumps(report, sort_keys=True),
              flush=True)
    print(
        f"materialize_tpu_torch listening: pgwire=127.0.0.1:{env.pg.port} "
        f"http=127.0.0.1:{env.http.port} data={args.data_dir}",
        flush=True,
    )
    # Serve until SIGTERM (or SIGINT). Not ``signal.pause()``: the kernel
    # may hand a process-directed signal to any thread of this process,
    # and then pause() in the main thread never returns, while the
    # Python handler runs only once the main thread executes again. A
    # short sleep bounds that wait.
    while True:
        _time.sleep(0.2)


if __name__ == "__main__":
    main()
