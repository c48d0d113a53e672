"""The Coordinator: SQL sequencing over catalog + controller + oracle.

Analog of the reference's ``Coordinator`` (adapter/src/coord.rs:1989,
``serve():4696``): owns the durable catalog, the timestamp oracle, the
compute controller, and the storage runtime (generator sources); turns
SQL statements into catalog transactions + dataflow installations +
peeks. DDL is durably recorded (as SQL text, replayed on boot — the
expression-cache-less version of catalog/src/durable.rs) before taking
effect, so a restarted coordinator reconstructs everything
(``bootstrap``, coord.rs).

Single-threaded sequencing: ``execute`` takes one statement at a time
under a lock, exactly the single-coordinator-loop discipline of the
reference (simple, and all the heavy lifting is async underneath).

The port's copy plans with the port's own frontend and optimizer
(``sql/``, ``transform/``) and evaluates introspection reads on the
device it is given (``device=``, default ``"cuda"``). Not ported yet,
and raising with its ROADMAP item: the program bank's introspection
relation (``coord/introspection.py``).
"""

from __future__ import annotations

import json
import threading
import time as _time
from dataclasses import dataclass, field

import numpy as np

from .. import resolve_device
from ..expr import relation as mir
from ..repr.schema import GLOBAL_DICT, parse_text_value, Column, ColumnType, Schema
from ..sql.catalog import Catalog as SqlCatalog
from ..sql.catalog import CatalogItem
from ..sql.hir import PlanError
from ..sql.plan import (
    CopyFromPlan,
    CreateIndexPlan,
    CreateSinkPlan,
    CreateSourcePlan,
    CreateTablePlan,
    CreateViewPlan,
    CreateWebhookPlan,
    DeletePlan,
    DropPlan,
    ExplainPlan,
    InsertPlan,
    SelectPlan,
    SetVarPlan,
    ShowPlan,
    ShowVarPlan,
    SubscribePlan,
    UpdatePlan,
    plan_statement,
)
from ..storage.persist import PersistClient
from ..transform.optimizer import optimize
from ..storage.persist import WriteHandle
from ..utils.dyncfg import COMPUTE_CONFIGS
from .controller import ComputeController
from .oracle import TimestampOracle
from .protocol import DataflowDescription
from .replica import _result_rows as _decode_peek_rows
from .sources import GeneratorSource

# Peeks wait for dataflow frontiers; first-compile latency on a fresh
# replica can be tens of seconds (XLA), so the default bound is
# generous. The live value comes from the unified retry policy
# (`retry_policy_peek`, utils/retry.py) so operators — and the chaos
# tests — can retune the budget at runtime; exhaustion surfaces as the
# retryable ServerBusy shed (53400 / 503), never a generic error.
PEEK_TIMEOUT = 180.0


def _peek_timeout() -> float:
    from ..utils.retry import policy as _retry_policy

    b = _retry_policy("peek").budget
    return b if b > 0 else PEEK_TIMEOUT

CATALOG_SHARD = "mz_catalog"
CATALOG_SCHEMA = Schema([Column("item", ColumnType.STRING)])


@dataclass
class ExecuteResult:
    """What a statement returns to the session (ExecuteResponse analog,
    adapter/src/command.rs)."""

    kind: str  # "rows" | "text" | "ok" | "subscription" | "copy_in"
    rows: list = field(default_factory=list)
    columns: tuple = ()
    text: str = ""
    subscription: object = None
    schema: object = None  # result Schema (wire type OIDs)
    affected: int = 0  # DML row count (wire CommandComplete tag)
    copy_out: bool = False  # stream rows via the COPY-out subprotocol
    table: str = ""  # copy_in target


class Coordinator:
    def __init__(
        self,
        persist: PersistClient,
        tick_interval: float | None = None,
        device=None,
    ):
        # Where introspection reads run (their one local dataflow step):
        # named by the caller, "cuda" by default, raising without a card.
        self.device = resolve_device(device)
        self.persist = persist
        self.catalog = SqlCatalog()
        self.controller = ComputeController()
        # Tables share ONE timeline driven by the oracle (the reference's
        # EpochMilliseconds timeline + txn-wal group commit: every write
        # advances every table's upper to the same timestamp). Generator
        # sources carry their own per-source tick timelines; reads select
        # min(upper)-1 per involved shard set.
        self.oracle = TimestampOracle(persist.consensus, "tables")
        self._table_writers: dict[str, WriteHandle] = {}
        self._webhooks: dict[str, WriteHandle] = {}
        self.sources: dict[str, GeneratorSource] = {}
        self.sinks: dict[str, object] = {}  # KafkaSink by name
        self._sub_seq = 0
        self.tick_interval = tick_interval
        # name -> installed dataflow name serving peeks for it
        self.peekable: dict[str, str] = {}
        # dataflow name -> upstream SOURCE shards (timestamp selection
        # reads at the sources' time, then waits for the dataflow).
        self._df_upstream: dict[str, list] = {}
        # dataflow name -> publisher dataflows whose arrangements it
        # index-imports (drop protection for TraceManager sharing).
        self._index_importers: dict[str, set] = {}
        # durable catalog bookkeeping
        self._cat_writer = self.persist.open_writer(
            CATALOG_SHARD, CATALOG_SCHEMA
        )
        self._item_seq = 0
        self._transient_seq = 0
        # Slow-path SELECT memoization: description
        # fingerprint -> installed transient dataflow name, LRU-capped
        # by the transient_peek_cache dyncfg. Flushed on DROP (a cached
        # transient's index imports would otherwise block DROP INDEX on
        # its publisher) and on dictionary rebalance (its expr codes go
        # stale).
        self._transient_cache: dict = {}
        # Serving-mode timestamp-selection cache (peek_ts_cache_ms):
        # df name -> (as_of, monotonic stamp, write epoch).
        self._ts_cache: dict = {}
        self._write_epoch = 0
        # Net durable effects of the CURRENT statement (appends minus
        # retractions): the DictExhausted replan-retry in execute() is
        # only safe when the failed attempt left no net durable state.
        self._net_durable = 0
        # Tracked for the lock-order sanitizer (utils/lockcheck,
        # `-m analysis`): THE sequencing lock — holding it across a
        # device dispatch or against the controller locks in reverse
        # order is exactly what the sanitizer exists to catch.
        from ..utils.locks import tracked_rlock

        self._lock = tracked_rlock("coord.sequencing", sequencing=True)
        # The push serving plane: SUBSCRIBE sessions fan
        # out from shared sink-shard tails — one readback per span, N
        # consumers (coord/subscribe.py).
        from .subscribe import SubscribeHub

        self.subscribe_hub = SubscribeHub(self)
        # Introspection relations (mz_internal analog): virtual items
        # resolved to snapshots at peek time (introspection.py).
        from .introspection import INTROSPECTION_SCHEMAS

        for name, schema in INTROSPECTION_SCHEMAS.items():
            self.catalog.create(
                CatalogItem(name=name, kind="introspection", schema=schema)
            )
        # Recovery report: what this boot replayed from the
        # durable catalog and how long it took — surfaced via
        # mz_recovery, EXPLAIN ANALYSIS's `recovery:` block, /metrics,
        # and environmentd --recover.
        self.recovery: dict = {
            "catalog_replayed": 0.0,
            "dyncfg_replayed": 0.0,
            "replay_failures": 0.0,
            "recovery_ms": 0.0,
        }
        # var -> its live durable {"set": var} record, so a later SET
        # retracts the prior override in O(1) instead of re-reading
        # the whole catalog shard under the sequencing lock.
        self._dyncfg_records: dict[str, dict] = {}
        # Slow-statement log: statements over the
        # slow_statement_ms dyncfg threshold, bounded ring, served by
        # the mz_slow_statements introspection relation.
        from collections import deque as _deque

        from ..utils.metrics import REGISTRY as _REGISTRY

        self.slow_statements: _deque = _deque(maxlen=256)
        self._slow_statement_counter = _REGISTRY.get_or_create(
            "counter", "mz_slow_statements_total",
            "statements exceeding the slow_statement_ms threshold",
        )
        # Label this process's span recorder: merged trace trees show
        # WHERE each span ran (replica processes label theirs in
        # coord/replica.main).
        from ..utils.trace import TRACER as _TRACER

        if _TRACER.process.startswith("pid"):
            _TRACER.process = "coordinator"
        t0 = _time.monotonic()
        self._bootstrap()
        self.recovery["recovery_ms"] = (_time.monotonic() - t0) * 1e3
        from ..utils import retry as _retry_mod

        _retry_mod.recovery_seconds().set(
            self.recovery["recovery_ms"] / 1e3
        )

    def _unlocked(self):
        """Release the sequencing lock around a blocking wait (peek
        response): one cold replica compile must not block every other
        session's statements. The catalog is not read after release, so
        sequencing decisions stay consistent."""
        import contextlib

        coord = self

        @contextlib.contextmanager
        def cm():
            # Bootstrap (and other pre-serve paths) call sequencing
            # helpers without holding the lock: releasing an un-owned
            # RLock raises, so only drop it when this thread holds it.
            held = coord._lock._is_owned()
            if held:
                coord._lock.release()
            try:
                yield
            finally:
                if held:
                    coord._lock.acquire()

        return cm()

    # -- replicas -----------------------------------------------------------
    def add_replica(self, name: str, addr) -> None:
        self.controller.add_replica(name, addr)

    def _donation_analysis_text(self) -> str:
        """Provenance/donation verdicts for every installed
        catalog-named dataflow (the EXPLAIN ANALYSIS live block;
        mz_donation serves ALL installed dataflows relationally,
        transient-SELECT cache installs included — those carry
        session-scoped generated names, which would make EXPLAIN
        output nondeterministic). A dataflow whose replica has not
        reported a verdict yet prints as pending rather than being
        omitted — the surface always covers the full install set."""
        named = {it.name for it in self.catalog.items.values()}
        named |= set(self.peekable.values())
        with self.controller._lock:
            installed = sorted(
                n for n in self.controller._dataflows if n in named
            )
            verdicts = {
                df: dict(per)
                for df, per in (
                    self.controller.donation_verdicts.items()
                )
            }
        lines = ["donation:"]
        if not installed:
            lines.append("  (no dataflows installed)")
        for name in installed:
            per = verdicts.get(name)
            if not per:
                lines.append(
                    f"  {name}: pending (no replica verdict yet)"
                )
                continue
            for rep, v in sorted(per.items()):
                from ..analysis.donation import verdict_display

                donated, prov = verdict_display(v)
                lines.append(
                    f"  {name}@{rep}: "
                    f"safe={str(bool(v.get('safe'))).lower()} "
                    f"requested="
                    f"{str(bool(v.get('requested'))).lower()} "
                    f"wired={str(bool(v.get('wired'))).lower()} "
                    f"donated=[{donated}] provenance({prov})"
                )
        return "\n".join(lines)

    def _sharding_analysis_text(self) -> str:
        """Shard-spec prover reports for every installed catalog-named
        dataflow (the EXPLAIN ANALYSIS `sharding:` block;
        mz_sharding serves the same rows relationally). Same coverage
        discipline as the donation block: a dataflow whose replica has
        not reported yet prints as pending, never omitted."""
        from ..analysis.shard_prop import sharding_display

        named = {it.name for it in self.catalog.items.values()}
        named |= set(self.peekable.values())
        with self.controller._lock:
            installed = sorted(
                n for n in self.controller._dataflows if n in named
            )
            verdicts = {
                df: dict(per)
                for df, per in (
                    self.controller.sharding_verdicts.items()
                )
            }
        lines = ["sharding:"]
        if not installed:
            lines.append("  (no dataflows installed)")
        for name in installed:
            per = verdicts.get(name)
            if not per:
                lines.append(
                    f"  {name}: pending (no replica report yet)"
                )
                continue
            for rep, v in sorted(per.items()):
                census, blame = sharding_display(v)
                line = (
                    f"  {name}@{rep}: "
                    f"spmd={str(bool(v.get('spmd'))).lower()} "
                    f"workers={int(v.get('workers') or 1)} "
                    f"ingest={v.get('ingest_mode')} "
                    f"safe={str(bool(v.get('safe'))).lower()} "
                    f"comm({census})"
                )
                if blame:
                    line += f" blame[{blame}]"
                lines.append(line)
        return "\n".join(lines)

    def _recovery_analysis_text(self) -> str:
        """Crash-recovery observability (the EXPLAIN ANALYSIS
        `recovery:` block; mz_recovery serves the same rows
        relationally): what the last boot replayed, each replica's
        session/fence counters, and the per-dataflow
        install/rebuild/reconcile counts — reconciliation as a counted
        invariant (rebuilds == 0 across restart when fingerprints are
        unchanged)."""
        r = self.recovery
        coord_line = (
            "  coordinator: "
            f"catalog_replayed={int(r['catalog_replayed'])} "
            f"dyncfg_replayed={int(r['dyncfg_replayed'])} "
            f"replay_failures={int(r['replay_failures'])}"
        )
        # recovery_ms is wall-clock; on a fresh boot (nothing replayed)
        # it measures bootstrap overhead, not recovery, so EXPLAIN
        # omits it to stay deterministic for SLT — mz_recovery always
        # serves it relationally.
        if any((r["catalog_replayed"], r["dyncfg_replayed"],
                r["replay_failures"])):
            coord_line += f" recovery_ms={r['recovery_ms']:.1f}"
        lines = ["recovery:", coord_line]
        snap = self.controller.recovery_snapshot()
        for name, st in sorted(snap["replicas"].items()):
            lines.append(
                f"  replica {name}: sessions={st['sessions']} "
                f"reconnects={st['reconnects']} "
                f"fenced={st['fenced']} "
                f"connected={str(bool(st['connected'])).lower()}"
            )
        named = {it.name for it in self.catalog.items.values()}
        named |= set(self.peekable.values())
        for df, per in sorted(snap["dataflows"].items()):
            if df not in named:
                continue
            for rep, v in sorted(per.items()):
                lines.append(
                    f"  {df}@{rep}: "
                    f"installs={int(v.get('installs', 0))} "
                    f"rebuilds={int(v.get('rebuilds', 0))} "
                    f"reconciles={int(v.get('reconciles', 0))} "
                    f"hydrate_ms={float(v.get('hydrate_ms', 0)):.1f}"
                )
        return "\n".join(lines)

    def _compile_analysis_text(self) -> str:
        """The compile ledger's EXPLAIN ANALYSIS block: the port's
        builds and loads of its native libraries (``merge_path.cu`` by
        nvcc, ``mtnative.cpp`` by g++), this process's and those its
        replica processes shipped. The reference records one XLA compile
        per dataflow program and scopes the block to the installed
        catalog-named dataflows; a port library serves every dataflow,
        so the block lists every library once any such dataflow is
        installed (``mz_compile_log`` serves each record)."""
        from ..utils.compile_ledger import LEDGER

        named = {it.name for it in self.catalog.items.values()}
        named |= set(self.peekable.values())
        with self.controller._lock:
            installed = any(n in named for n in self.controller._dataflows)
        recs = LEDGER.records() if installed else []
        lines = ["compiles:"]
        if not recs:
            lines.append("  (no compiles recorded for installed "
                         "dataflows)")
            return "\n".join(lines)
        libs: dict = {}
        for r in recs:
            k = libs.setdefault((r.kind, r.name), [0, 0, 0.0])
            k[0 if r.cache == "miss" else 1] += 1
            k[2] += r.seconds
        for (kind, name), (misses, hits, secs) in sorted(libs.items()):
            lines.append(
                f"  {kind} {name}: compiles={misses + hits} "
                f"misses={misses} hits={hits} seconds={secs:.3f}"
            )
        s = LEDGER.summary()
        lines.append(
            f"  total: compiles={s['compiles']} "
            f"misses={s['misses']} hits={s['hits']} "
            f"seconds={s['seconds']:.3f}"
        )
        return "\n".join(lines)

    def _freshness_analysis_text(self) -> str:
        """The freshness plane's EXPLAIN ANALYSIS block:
        per installed catalog-named dataflow and replica, the
        hydration status and the windowed wallclock-lag rollup — the
        same scoping discipline as the donation/compile blocks
        (transient SELECT installs are excluded; mz_wallclock_lag_*
        and mz_hydration_statuses serve everything relationally)."""
        from .freshness import FRESHNESS

        named = {it.name for it in self.catalog.items.values()}
        named |= set(self.peekable.values())
        with self.controller._lock:
            installed = sorted(
                n for n in self.controller._dataflows if n in named
            )
        lines = ["freshness:"]
        if not installed:
            lines.append("  (no dataflows installed)")
            return "\n".join(lines)
        summary = FRESHNESS.summary()
        board = {
            (df, rep): (status, attempts, error)
            for df, rep, status, _since, attempts, error
            in self.controller.hydration_snapshot()
        }
        for df in installed:
            reps = sorted(
                {rep for (d, rep) in summary if d == df}
                | {rep for (d, rep) in board if d == df}
            )
            if not reps:
                lines.append(
                    f"  {df}: pending (no replica report yet)"
                )
                continue
            for rep in reps:
                status, attempts, error = board.get(
                    (df, rep), ("pending", 0, "")
                )
                line = f"  {df}@{rep}: status={status}"
                if attempts:
                    line += f" attempts={attempts}"
                s = summary.get((df, rep))
                if s is not None and s["samples"]:
                    line += (
                        f" lag_p50_ms={s['p50_ms']:.1f}"
                        f" lag_p99_ms={s['p99_ms']:.1f}"
                        f" samples={s['samples']}"
                    )
                if error:
                    line += f" last_error={error!r}"
                lines.append(line)
        return "\n".join(lines)

    def _replicas_analysis_text(self) -> str:
        """The elastic read plane's EXPLAIN ANALYSIS block:
        per installed catalog-named dataflow, the replica set with
        hydration status + windowed lag and the CURRENT routing
        target — routing decisions inspectable without reading
        metrics. Same scoping discipline as the freshness block
        (transients excluded; mz_cluster_replicas serves the replica
        rows relationally)."""
        from .freshness import FRESHNESS

        named = {it.name for it in self.catalog.items.values()}
        named |= set(self.peekable.values())
        with self.controller._lock:
            installed = sorted(
                n for n in self.controller._dataflows if n in named
            )
        states = {
            s["name"]: s for s in self.controller.replica_states()
        }
        lines = ["replicas:"]
        if not installed:
            lines.append("  (no dataflows installed)")
            return "\n".join(lines)
        summary = FRESHNESS.summary()
        for df in installed:
            target = self.controller.routing_target(df)
            cands = self.controller.route_candidates(df)
            parts = []
            for rep in sorted(states):
                st = states[rep]
                status = (
                    self.controller.hydration.status((df, rep))
                    or "pending"
                )
                piece = f"{rep}:{status}"
                if st["state"] == "draining":
                    piece += "(draining)"
                elif not st["connected"]:
                    piece += "(disconnected)"
                s = summary.get((df, rep))
                if s is not None and s["samples"]:
                    piece += f" lag_p50_ms={s['p50_ms']:.1f}"
                parts.append(piece)
            line = f"  {df}: [" + ", ".join(parts) + "]"
            line += (
                f" target={target}"
                if target is not None
                else " target=broadcast"
            )
            if len(cands) > 1:
                line += " failover=[" + ", ".join(cands[1:]) + "]"
            lines.append(line)
        return "\n".join(lines)

    def _catalog_append(self, record: dict, diff: int) -> None:
        self._net_durable += 1 if diff > 0 else -1
        code = GLOBAL_DICT.encode(json.dumps(record, sort_keys=True))
        t = self._cat_writer.upper
        self._cat_writer.compare_and_append(
            [np.array([code], np.int64)],
            [None],
            np.array([t], np.uint64),
            np.array([diff], np.int64),
            t,
            t + 1,
        )

    def _catalog_live_records(self) -> list[dict]:
        st = self._cat_writer.machine.reload()
        if st.upper == 0:
            return []
        reader = self.persist.open_reader(CATALOG_SHARD, "coord-boot")
        try:
            _sch, cols, _nulls, _time, diff = reader.snapshot(st.upper - 1)
        finally:
            reader.expire()
        acc: dict[str, int] = {}
        for code, d in zip(cols[0], diff):
            s = GLOBAL_DICT.decode(int(code))
            acc[s] = acc.get(s, 0) + int(d)
        records = [json.loads(s) for s, d in acc.items() if d > 0]
        records.sort(key=lambda r: r["id"])
        return records

    def _bootstrap(self) -> None:
        """Replay the durable catalog: re-plan every recorded DDL in id
        order (bootstrap, adapter/src/coord.rs; dataflow as-ofs are
        re-selected by the replicas on CreateDataflow)."""
        from ..utils import retry as _retry_mod

        for rec in self._catalog_live_records():
            self._item_seq = max(self._item_seq, rec["id"])
            try:
                self._sequence(
                    plan_statement(rec["sql"], self.catalog),
                    sql=rec["sql"],
                    replay=True,
                    record=rec,
                )
                self.recovery["catalog_replayed"] += 1
                _retry_mod.catalog_replayed_total().inc()
            except Exception as e:
                # A record that no longer replays (e.g. its install was
                # compensated mid-crash) must not brick the boot:
                # retract it and keep going. Dependents fail the same
                # way and retract too — self-healing, at the cost of
                # dropping the broken item (surfaced in statuses).
                self.controller.statuses.append(
                    {
                        "kind": "Status",
                        "error": f"bootstrap replay of {rec['sql']!r} "
                        f"failed ({e!r}); record retracted",
                    }
                )
                self.recovery["replay_failures"] += 1
                self._catalog_append(rec, -1)

    def health(self) -> dict:
        """The /api/readyz verdict (the freshness plane's probe): ready iff catalog replay had no failures AND (no
        replicas are registered OR at least one is connected) AND
        every durable (catalog-installed peekable) dataflow has some
        connected replica that hydrated — board status `hydrated`, or
        a reported frontier past 0 — AND, when the freshness_slo_ms
        SLO is set, no durable dataflow's latest committed lag
        breaches it. Machine-checkable readiness for `environmentd
        --recover` drives and rolling restarts."""
        from ..utils.dyncfg import FRESHNESS_SLO_MS
        from .freshness import FRESHNESS

        controller = self.controller
        replicas = dict(controller.replicas)
        connected = {
            r for r, rc in replicas.items() if rc.connected.is_set()
        }
        dataflows = sorted(set(self.peekable.values()))
        with controller._lock:
            frontiers = {
                df: dict(controller.frontiers.get(df, {}))
                for df in dataflows
            }
        unhydrated = []
        if replicas:
            for df in dataflows:
                ok = False
                for r in connected:
                    if (
                        controller.hydration.status((df, r))
                        == "hydrated"
                        or frontiers[df].get(r, 0) > 0
                    ):
                        ok = True
                        break
                if not ok:
                    unhydrated.append(df)
        try:
            slo = float(FRESHNESS_SLO_MS(COMPUTE_CONFIGS) or 0.0)
        except (TypeError, ValueError):
            slo = 0.0
        breaching = []
        if slo > 0.0:
            for df in dataflows:
                for rep, (_f, lag, _at) in sorted(
                    FRESHNESS.latest(df).items()
                ):
                    if lag > slo:
                        breaching.append(f"{df}@{rep}")
        checks = {
            "catalog_replayed": (
                int(self.recovery.get("replay_failures", 0)) == 0
            ),
            "replicas_connected": (not replicas) or bool(connected),
            "dataflows_hydrated": not unhydrated,
            "lag_under_slo": not breaching,
        }
        return {
            "ready": all(checks.values()),
            "checks": checks,
            "unhydrated": unhydrated,
            "breaching": breaching,
            "replicas": {
                "registered": len(replicas),
                "connected": len(connected),
            },
            "dataflows": len(dataflows),
            "freshness_slo_ms": slo,
        }

    # -- statement execution -------------------------------------------------
    def execute(self, sql: str) -> ExecuteResult:
        """One statement, sequenced. Opens the coordinator's span of
        the statement trace (child of the front end's root span when
        one is open on this thread; a root of its own for programmatic
        callers) and feeds the slow-statement log."""
        from ..utils.trace import TRACER

        t0 = _time.perf_counter()
        with TRACER.span("coord.execute", sql=sql[:100]):
            try:
                return self._execute_inner(sql)
            finally:
                self._note_statement(
                    sql, (_time.perf_counter() - t0) * 1e3,
                    TRACER.current_trace(),
                )

    def _note_statement(
        self, sql: str, ms: float, trace_id: int
    ) -> None:
        """Slow-statement log (dyncfg-gated): statements over the
        slow_statement_ms threshold land in a bounded ring served by
        mz_slow_statements and count in /metrics."""
        from ..utils.dyncfg import SLOW_STATEMENT_MS

        thresh = float(SLOW_STATEMENT_MS(COMPUTE_CONFIGS))
        if thresh <= 0 or ms < thresh:
            return
        self.slow_statements.append(
            {
                "sql": sql.strip()[:500],
                "ms": round(ms, 3),
                "trace_id": int(trace_id or 0),
                "at": _time.time(),
            }
        )
        self._slow_statement_counter.inc()

    def _execute_inner(self, sql: str) -> ExecuteResult:
        from ..repr.schema import DictExhausted

        with self._lock:
            before = self._net_durable
            try:
                plan = plan_statement(sql, self.catalog)
                return self._sequence(plan, sql=sql)
            except DictExhausted:
                # Planning (or an in-process replica this statement
                # drove) ran a string-label gap dry. Rebalance the
                # process dictionary — listeners remap the controller's
                # command history and queue rebuilds on in-process
                # replica workers — then replan from SQL text, which
                # re-encodes literals under the new labeling. Only safe
                # when the failed attempt left no NET durable state
                # (DDL compensation retracts its record on failure;
                # a completed table write cannot be undone -> re-raise).
                if self._net_durable != before:
                    raise
                # Cached transient dataflows hold exprs labeled under
                # the OLD dictionary: their fingerprints go stale and
                # must not serve post-rebalance replans.
                self._flush_transient_peeks()
                GLOBAL_DICT.rebalance()
                plan = plan_statement(sql, self.catalog)
                return self._sequence(plan, sql=sql)

    def _sequence(
        self, plan, sql: str, replay: bool = False, record: dict | None = None
    ) -> ExecuteResult:
        if isinstance(plan, CreateSourcePlan):
            return self._sequence_create_source(plan, sql, replay, record)
        if isinstance(plan, CreateSinkPlan):
            return self._sequence_create_sink(plan, sql, replay, record)
        if isinstance(plan, CreateViewPlan):
            return self._sequence_create_view(plan, sql, replay, record)
        if isinstance(plan, CreateIndexPlan):
            return self._sequence_create_index(plan, sql, replay, record)
        if isinstance(plan, CreateTablePlan):
            return self._sequence_create_table(plan, sql, replay, record)
        if isinstance(plan, CreateWebhookPlan):
            return self._sequence_create_webhook(plan, sql, replay, record)
        if isinstance(plan, InsertPlan):
            return self._sequence_insert(plan)
        if isinstance(plan, CopyFromPlan):
            it = self._check_writable_table(plan.table)
            cols = plan.columns or tuple(
                c.name for c in it.schema.columns
            )
            known = {c.name for c in it.schema.columns}
            seen = set()
            for c in cols:
                if c not in known:
                    raise PlanError(
                        f"column {c!r} of {plan.table!r} does not exist"
                    )
                if c in seen:
                    raise PlanError(
                        f"column {c!r} specified more than once"
                    )
                seen.add(c)
            res = ExecuteResult("copy_in")
            res.table = plan.table
            res.columns = cols
            return res
        if isinstance(plan, DeletePlan):
            return self._sequence_delete(plan)
        if isinstance(plan, UpdatePlan):
            return self._sequence_update(plan)
        if isinstance(plan, SetVarPlan):
            if plan.name not in COMPUTE_CONFIGS.current():
                raise PlanError(
                    f"unknown system variable {plan.name!r}"
                )
            try:
                if plan.name.startswith("retry_policy_"):
                    # Validate the spec NOW: a malformed spec that
                    # reached the durable catalog would raise at
                    # policy() time inside a reconnect daemon thread
                    # — on this boot and every --recover after it.
                    from ..utils.retry import RetryPolicy

                    RetryPolicy.parse(plan.value)
                if plan.name == "trace_level" and plan.value is not None:
                    # None = SET ... DEFAULT (reset): always legal.
                    from ..utils.trace import LEVELS

                    if str(plan.value) not in LEVELS:
                        raise ValueError(
                            f"expected one of {sorted(LEVELS)}"
                        )
                if (
                    plan.name == "freshness_slo_ms"
                    and plan.value is not None
                    and float(plan.value) < 0.0
                ):
                    raise ValueError("expected a value >= 0")
                self.update_config({plan.name: plan.value})
            except (TypeError, ValueError) as e:
                raise PlanError(
                    f"invalid value for {plan.name!r}: {e}"
                ) from e
            # Dyncfg overrides are part of the durable catalog:
            # a restarted coordinator must come back with
            # the same flags (span pipelining, ingest mode, retry
            # policies), or recovery silently changes behavior. Later
            # SETs of the same var retract the earlier record, so boot
            # replays exactly the newest override per var (tracked in
            # _dyncfg_records so retraction is O(1), not a full
            # catalog scan per SET).
            if replay:
                self.recovery["dyncfg_replayed"] += 1
                if record is not None:
                    # Two live records for one var = a crash landed
                    # between append-new and retract-prior below.
                    # Replay runs in id order so this newer record
                    # wins; retract the orphaned older one now
                    # (self-healing, like failed-replay retraction).
                    stale = self._dyncfg_records.pop(plan.name, None)
                    if stale is not None:
                        self._catalog_append(stale, -1)
                    self._dyncfg_records[plan.name] = record
            else:
                # Append the NEW record before retracting the prior
                # one: a crash between the two durable writes must
                # leave the override present (two live records replay
                # newest-wins), never absent — losing an acknowledged
                # SET across restart is exactly the bug class this
                # catalog exists to prevent. The interleaving explorer
                # checks this window exhaustively — every crash point
                # in every schedule, retract-first shown to lose the
                # var (analysis/interleave.SetCrashModel; the
                # check_plans --bench `interleave-smoke` gate).
                prior = self._dyncfg_records.pop(plan.name, None)
                self._dyncfg_records[plan.name] = self._record_ddl(
                    sql, {"set": plan.name}
                )
                if prior is not None:
                    self._catalog_append(prior, -1)
            return ExecuteResult("ok")
        if isinstance(plan, ShowVarPlan):
            cur = COMPUTE_CONFIGS.current()
            if plan.name not in cur:
                raise PlanError(f"unknown system variable {plan.name!r}")
            return ExecuteResult(
                "rows",
                rows=[(str(cur[plan.name]),)],
                columns=(plan.name,),
            )
        if isinstance(plan, SelectPlan):
            res = self._sequence_peek(plan)
            res.copy_out = plan.copy_out
            return res
        if isinstance(plan, SubscribePlan):
            return self._sequence_subscribe(plan)
        if isinstance(plan, DropPlan):
            return self._sequence_drop(plan)
        if isinstance(plan, ExplainPlan):
            text = plan.text
            if plan.stage == "analysis":
                # The LIVE half of EXPLAIN ANALYSIS: the
                # buffer-provenance / donation-safety verdict and the
                # shard-spec prover report of every INSTALLED dataflow,
                # as last reported by the replicas (the plan-side half
                # above is static and catalog-only).
                text = (
                    text
                    + "\n"
                    + self._donation_analysis_text()
                    + "\n"
                    + self._sharding_analysis_text()
                    + "\n"
                    + self._recovery_analysis_text()
                    + "\n"
                    + self._compile_analysis_text()
                    + "\n"
                    + self.subscribe_hub.analysis_text()
                    + "\n"
                    + self._freshness_analysis_text()
                    + "\n"
                    + self._replicas_analysis_text()
                )
            return ExecuteResult(
                "text", text=text, columns=("explain",)
            )
        if isinstance(plan, ShowPlan):
            kind = plan.kind.lower().rstrip("s")  # sources -> source
            wanted = {
                "object": None,  # all
                "view": {"view", "materialized-view"},
                "source": {"source"},
                "table": {"table"},
                "inde": {"index"},  # "indexes" -> "indexe"
                "index": {"index"},
            }.get("inde" if kind == "indexe" else kind, {kind})
            rows = sorted(
                (it.name, it.kind)
                for it in self.catalog.items.values()
                if wanted is None or it.kind in wanted
            )
            return ExecuteResult("rows", rows=rows, columns=("name", "kind"))
        raise PlanError(f"cannot sequence {type(plan).__name__}")

    # -- DDL -----------------------------------------------------------------
    def _record_ddl(self, sql: str, extra: dict | None = None) -> dict:
        self._item_seq += 1
        rec = {"id": self._item_seq, "sql": sql}
        if extra:
            rec.update(extra)
        self._catalog_append(rec, +1)
        return rec

    def _sequence_create_source(
        self, plan: CreateSourcePlan, sql, replay, record
    ) -> ExecuteResult:
        options = dict(plan.options)
        if plan.schema is not None:
            options["_schema"] = plan.schema
        options["_name"] = plan.name
        if not replay:
            # Validate EVERYTHING that can fail BEFORE the durable
            # record — a poison record would brick every future boot.
            from .sources import GENERATORS

            if plan.generator not in GENERATORS:
                raise PlanError(
                    f"unknown load generator {plan.generator!r}"
                )
            self._check_name_free(plan.name)
            try:
                # Adapter construction validates options (and gates
                # unavailable backends like kafka).
                GENERATORS[plan.generator](
                    {
                        str(k).lower().replace(" ", "_"): v
                        for k, v in options.items()
                    }
                )
            except PlanError:
                raise
            except Exception as e:
                raise PlanError(str(e)) from e
        if record is None:
            record = self._record_ddl(sql, {"name": plan.name})
        shard_prefix = f"u{record['id']}"
        src = GeneratorSource(
            self.persist,
            plan.name,
            plan.generator,
            options,
            shard_prefix,
            tick_interval=self.tick_interval,
        )
        self.sources[plan.name] = src
        for sub, schema in src.adapter.subsources.items():
            self.catalog.create(
                CatalogItem(
                    name=sub,
                    kind="source",
                    schema=schema,
                    definition={
                        "shard": src.shards[sub],
                        "source": plan.name,
                    },
                ),
                or_replace=True,
            )
        if plan.name not in src.adapter.subsources:
            # summary item for multi-subsource generators; an external
            # source whose single subsource carries the source's own
            # name (kafka) IS its own catalog item
            self.catalog.create(
                CatalogItem(
                    name=plan.name,
                    kind="source",
                    schema=Schema([]),
                    definition={"generator": plan.generator},
                ),
                or_replace=True,
            )
        src.start()
        return ExecuteResult("ok")

    # -- sinks ---------------------------------------------------------------
    def _sequence_create_sink(
        self, plan: CreateSinkPlan, sql, replay, record
    ) -> ExecuteResult:
        """CREATE SINK name FROM obj INTO KAFKA (BROKER ..., TOPIC ...,
        FORMAT ..., ENVELOPE ...): exactly-once publication of the
        object's update stream (storage/src/sink/kafka.rs analog; the
        transaction is the broker's atomic multi-topic append)."""
        from ..storage.kafka.broker import FileBroker
        from ..storage.kafka.sink import KafkaSink

        opts = {
            str(k).lower().replace(" ", "_"): v
            for k, v in plan.options.items()
        }
        it = self.catalog.items.get(plan.from_obj)
        if it is None:
            raise PlanError(f"unknown relation {plan.from_obj!r}")
        shard = (
            it.definition.get("shard")
            if isinstance(it.definition, dict)
            else None
        )
        if shard is None:
            raise PlanError(
                f"{plan.from_obj!r} has no durable collection to sink "
                "(sink from a TABLE, SOURCE, or MATERIALIZED VIEW)"
            )
        broker_path = opts.get("broker")
        topic = opts.get("topic")
        if not broker_path or not topic:
            raise PlanError("KAFKA sinks require BROKER and TOPIC")
        if not replay:
            self._check_name_free(plan.name)
            # Validate EVERYTHING that can fail BEFORE the durable
            # record (same invariant as sources: a poison record bricks
            # every future boot): encoder construction catches unknown
            # formats and avro-without-registry; FileBroker validates
            # the path is creatable.
            try:
                from ..storage.kafka.decode import make_encoder

                make_encoder(
                    str(opts.get("format", "json")),
                    it.schema,
                    opts.get("registry"),
                )
                FileBroker(str(broker_path))
            except Exception as e:
                raise PlanError(str(e)) from e
        if record is None:
            record = self._record_ddl(sql, {"name": plan.name})
        sink = KafkaSink(
            self.persist,
            shard,
            it.schema,
            FileBroker(str(broker_path)),
            str(topic),
            fmt=str(opts.get("format", "json")),
            envelope=str(opts.get("envelope", "none")),
            registry=opts.get("registry"),
            sink_id=f"u{record['id']}",
        )
        self.sinks[plan.name] = sink
        self.catalog.create(
            CatalogItem(
                name=plan.name,
                kind="sink",
                schema=it.schema,
                definition={
                    "on": plan.from_obj,
                    "topic": str(topic),
                    "shard": shard,
                },
            )
        )
        if self.tick_interval is not None:
            sink.start(self.tick_interval)
        return ExecuteResult("ok")

    def _sequence_create_table(
        self, plan: CreateTablePlan, sql, replay, record
    ) -> ExecuteResult:
        if not replay:
            self._check_name_free(plan.name)
        if record is None:
            record = self._record_ddl(sql, {"name": plan.name})
        shard = f"u{record['id']}_table"
        w = self.persist.open_writer(shard, plan.schema)
        if w.upper == 0:
            # Initialize the table at the timeline's current read time so
            # it is immediately readable.
            ts = self.oracle.read_ts()
            w.compare_and_append(
                [np.zeros(0, c.dtype) for c in plan.schema.columns],
                [None] * plan.schema.arity,
                np.zeros(0, np.uint64),
                np.zeros(0, np.int64),
                0,
                ts + 1,
            )
        self._table_writers[plan.name] = w
        self.catalog.create(
            CatalogItem(
                name=plan.name,
                kind="table",
                schema=plan.schema,
                definition={"shard": shard},
            )
        )
        return ExecuteResult("ok")

    def _sequence_create_webhook(
        self, plan: CreateWebhookPlan, sql, replay, record
    ) -> ExecuteResult:
        """A webhook source: rows arrive over HTTP (append_webhook), on
        the source's own monotone timeline (webhook.rs analog)."""
        if not replay:
            self._check_name_free(plan.name)
        if record is None:
            record = self._record_ddl(sql, {"name": plan.name})
        shard = f"u{record['id']}_webhook"
        w = self.persist.open_writer(shard, plan.schema)
        if w.upper == 0:
            w.compare_and_append(
                [np.zeros(0, c.dtype) for c in plan.schema.columns],
                [None] * plan.schema.arity,
                np.zeros(0, np.uint64),
                np.zeros(0, np.int64),
                0,
                1,
            )
        self._webhooks[plan.name] = w
        self.catalog.create(
            CatalogItem(
                name=plan.name,
                kind="source",
                schema=plan.schema,
                definition={"shard": shard, "webhook": True},
            )
        )
        return ExecuteResult("ok")

    def append_webhook(self, name: str, rows: list) -> int:
        """Ingest rows into a webhook source; returns the count. Rows
        are python value tuples/lists matching the declared columns."""
        with self._lock:
            w = self._webhooks.get(name)
            it = self.catalog.items.get(name)
            if w is None or it is None:
                raise PlanError(f"unknown webhook source {name!r}")
            norm = []
            for r in rows:
                if len(r) != it.schema.arity:
                    raise PlanError(
                        f"webhook row has {len(r)} values, expected "
                        f"{it.schema.arity}"
                    )
                for v, col in zip(r, it.schema.columns):
                    if v is None and not col.nullable:
                        raise PlanError(
                            "null value in non-nullable column "
                            f"{col.name!r}"
                        )
                norm.append(tuple(r))
            if not norm:
                return 0
            self._write_epoch += 1
            cols, nulls = self._encode_insert(it.schema, norm)
            t = w.upper
            w.compare_and_append(
                cols,
                nulls,
                np.full(len(norm), t, np.uint64),
                np.ones(len(norm), np.int64),
                t,
                t + 1,
            )
            return len(norm)

    @staticmethod
    def _temporal_to_int(v, col):
        """date/datetime objects -> epoch day / epoch ms ints (identity
        on ints: SLTs may still write raw epoch numbers)."""
        import datetime as _dt

        from ..repr.schema import date_to_days, ts_to_ms

        if col.ctype is ColumnType.TIMESTAMP and isinstance(
            v, _dt.datetime
        ):
            return ts_to_ms(v)
        if col.ctype is ColumnType.DATE and isinstance(v, _dt.date):
            return date_to_days(v)
        return v

    def _encode_insert(self, schema: Schema, rows: list):
        cols, nulls = [], []
        for j, col in enumerate(schema.columns):
            vals = []
            mask = []
            for r in rows:
                v = r[j]
                mask.append(v is None)
                if v is None:
                    vals.append(0)
                elif col.ctype is ColumnType.STRING:
                    vals.append(GLOBAL_DICT.encode(str(v)))
                elif col.ctype is ColumnType.DECIMAL:
                    vals.append(round(float(v) * 10**col.scale))
                elif col.ctype is ColumnType.BOOL:
                    vals.append(bool(v))
                else:
                    vals.append(self._temporal_to_int(v, col))
            cols.append(np.asarray(vals, dtype=col.dtype))
            nulls.append(np.asarray(mask, bool) if any(mask) else None)
        return cols, nulls

    def _sequence_insert(self, plan: InsertPlan) -> ExecuteResult:
        it = self._check_writable_table(plan.table)
        cols, nulls = self._encode_insert(it.schema, plan.rows)
        self._group_commit(
            plan.table, cols, nulls, np.ones(len(plan.rows), np.int64)
        )
        return ExecuteResult("ok", affected=len(plan.rows))

    def copy_in_rows(
        self, table: str, columns: tuple, text_rows: list
    ) -> int:
        """Finish a COPY table FROM STDIN: parse pg-text rows into
        values for the named columns (others NULL) and group-commit
        them (the reference's COPY-in lands in the same table-write
        path as INSERT, protocol.rs COPY -> adapter appends)."""
        it = self._check_writable_table(table)
        by_name = {c.name: i for i, c in enumerate(it.schema.columns)}
        positions = [by_name[c] for c in columns]
        rows = []
        for ln, parts in enumerate(text_rows):
            if len(parts) != len(columns):
                raise PlanError(
                    f"COPY row {ln + 1} has {len(parts)} fields, "
                    f"expected {len(columns)}"
                )
            row = [None] * it.schema.arity
            for pos, raw in zip(positions, parts):
                col = it.schema.columns[pos]
                row[pos] = (
                    None if raw is None else parse_text_value(raw, col)
                )
            for v, col in zip(row, it.schema.columns):
                if v is None and not col.nullable:
                    raise PlanError(
                        f"null value in non-nullable column {col.name!r}"
                    )
            rows.append(tuple(row))
        if not rows:
            return 0
        with self._lock:
            cols_arr, nulls = self._encode_insert(it.schema, rows)
            self._group_commit(
                table, cols_arr, nulls, np.ones(len(rows), np.int64)
            )
        return len(rows)

    def _group_commit(self, table: str, cols, nulls, diffs) -> int:
        """Group commit on the shared table timeline (coord/appends.rs
        + txn-wal): allocate one write timestamp past every table
        upper, write the target table, advance all other tables to the
        same upper with empty appends, then apply the write to the
        oracle. The ONE place the table-timeline protocol lives."""
        self._net_durable += 1
        self._write_epoch += 1  # invalidate cached peek timestamps
        at_least = max(
            (w.upper for w in self._table_writers.values()), default=0
        )
        ts = self.oracle.write_ts(at_least=at_least)
        w = self._table_writers[table]
        w.compare_and_append(
            cols,
            nulls,
            np.full(len(diffs), ts, np.uint64),
            diffs,
            w.upper,
            ts + 1,
        )
        for name, other in self._table_writers.items():
            if name != table and other.upper <= ts:
                sch = self.catalog.items[name].schema
                other.compare_and_append(
                    [np.zeros(0, c.dtype) for c in sch.columns],
                    [None] * sch.arity,
                    np.zeros(0, np.uint64),
                    np.zeros(0, np.int64),
                    other.upper,
                    ts + 1,
                )
        self.oracle.apply_write(ts)
        return ts

    # -- read-then-write DML ---------------------------------------------------
    def _transient_peek(
        self, expr: mir.RelationExpr, unlocked: bool,
        as_of: int | None = None,
    ):
        """Install a transient dataflow, peek it at the sources' latest
        complete time (or exactly ``as_of`` when given: AS OF hydrates
        the dataflow at t — inputs must be readable there); returns raw
        (vals..., time, diff) rows. ``unlocked`` releases the
        sequencing lock during the wait — safe for SELECT, NOT for DML
        whose read must be atomic with its write.

        SELECT-path installs are MEMOIZED by description fingerprint
        (the fingerprint-stability work exists for exactly this):
        a repeated identical SELECT reuses the still-installed (and
        still-maintained) transient dataflow — no re-render, no
        re-compile, just a fresh timestamp selection + peek. The cache
        is LRU-capped (transient_peek_cache dyncfg); evicted and
        non-memoized installs drop as before."""
        from ..utils.dyncfg import TRANSIENT_PEEK_CACHE

        imports, index_imports = self._source_imports(expr)
        cap = int(TRANSIENT_PEEK_CACHE(COMPUTE_CONFIGS))
        key = None
        if unlocked and cap > 0:
            import pickle as _pickle

            key = _pickle.dumps(
                (
                    expr,
                    sorted(imports.items()),
                    sorted(index_imports.items()),
                    as_of,
                ),
                protocol=_pickle.HIGHEST_PROTOCOL,
            )
            hit = self._transient_cache.get(key)
            if hit is not None:
                name, _deps = hit
                # LRU touch (dict preserves insertion order).
                self._transient_cache[key] = self._transient_cache.pop(
                    key
                )
                try:
                    return self._peek_transient(name, as_of, unlocked)
                except Exception:
                    # The replica lost it (restart, drop race) or the
                    # peek failed against the cached install: forget
                    # it and fall through to a fresh install, which
                    # surfaces any real error to the user. The drop
                    # broadcast itself may fail against the same dead
                    # replica — that must not preempt the retry.
                    self._transient_cache.pop(key, None)
                    self._deregister_dataflow(name)
                    try:
                        self.controller.drop_dataflow(name)
                    except Exception:
                        pass
        self._transient_seq += 1
        name = f"t{self._transient_seq}"
        self._register_dataflow(
            DataflowDescription(
                name=name, expr=expr, source_imports=imports,
                sink_shard=None, index_imports=index_imports,
                as_of=as_of,
            ),
            unlocked=unlocked,
            durable=False,
        )
        if key is not None:
            deps = (
                set(imports)
                | set(index_imports)
                | {pub for pub, _ in index_imports.values()}
            )
            self._transient_cache[key] = (name, deps)
            while len(self._transient_cache) > cap:
                old_key = next(iter(self._transient_cache))
                old, _deps = self._transient_cache.pop(old_key)
                self._deregister_dataflow(old)
                try:
                    self.controller.drop_dataflow(old)
                except Exception:
                    pass
            return self._peek_transient(name, as_of, unlocked)
        try:
            return self._peek_transient(name, as_of, unlocked)
        finally:
            # Deregister FIRST: the dict pops cannot fail, while
            # drop_dataflow's broadcast can (dead replica socket) — a
            # raise there must not leave a stale _index_importers entry
            # blocking DROP INDEX on the publisher forever.
            self._deregister_dataflow(name)
            self.controller.drop_dataflow(name)

    def _peek_transient(
        self, name: str, as_of: int | None, unlocked: bool
    ):
        """Timestamp-select + peek an installed transient dataflow."""
        if as_of is not None:
            as_of_sel, exact = as_of, True
        else:
            as_of_sel = self._select_timestamp_shards(
                self._df_upstream.get(name, [])
            )
            exact = False
        if unlocked:
            with self._unlocked():
                rows, _ = self.controller.peek(
                    name, as_of=as_of_sel, timeout=_peek_timeout(),
                    exact=exact,
                )
        else:
            rows, _ = self.controller.peek(
                name, as_of=as_of_sel, timeout=_peek_timeout(),
                exact=exact,
            )
        return rows

    def _flush_transient_peeks(self, doomed: set | None = None) -> None:
        """Drop memoized transient dataflows — all of them (dictionary
        rebalance: stale codes; shutdown), or with ``doomed`` only the
        entries whose imports reference a dropped object (a cached
        transient's index imports would otherwise block DROP INDEX on
        its publisher; unrelated cached SELECTs keep their installs)."""
        if doomed is None:
            cache, self._transient_cache = self._transient_cache, {}
            victims = list(cache.values())
        else:
            victims = []
            for k in list(self._transient_cache):
                name, deps = self._transient_cache[k]
                if deps & doomed:
                    victims.append(self._transient_cache.pop(k))
        for name, _deps in victims:
            self._deregister_dataflow(name)
            try:
                self.controller.drop_dataflow(name)
            except Exception:
                pass

    def _read_rows_multiset(self, expr: mir.RelationExpr) -> dict:
        """The read half of DELETE/UPDATE's read-then-write: runs UNDER
        the sequencing lock so concurrent DML cannot double-retract
        (the reference serializes table writes through group commit)."""
        opt = optimize(self._inline_views(expr))
        rows = self._transient_peek(opt, unlocked=False)
        acc: dict = {}
        for r in rows:
            acc[r[:-2]] = acc.get(r[:-2], 0) + r[-1]
        return {k: v for k, v in acc.items() if v}

    def _encode_internal(self, schema: Schema, rows: list):
        """Encode DECODED result rows back to device representation:
        strings re-encode to dictionary codes; decimals re-scale from the
        exact decimal.Decimal user value back to the scaled int."""
        cols, nulls = [], []
        for j, col in enumerate(schema.columns):
            vals, mask = [], []
            for r in rows:
                v = r[j]
                mask.append(v is None)
                if v is None:
                    vals.append(0)
                elif col.ctype is ColumnType.STRING:
                    vals.append(GLOBAL_DICT.encode(str(v)))
                elif col.ctype is ColumnType.DECIMAL and col.scale:
                    vals.append(int(v * (10 ** col.scale)))
                else:
                    vals.append(self._temporal_to_int(v, col))
            cols.append(np.asarray(vals, dtype=col.dtype))
            nulls.append(np.asarray(mask, bool) if any(mask) else None)
        return cols, nulls

    def _table_write(self, table: str, updates: list) -> None:
        """Group-commit a batch of INTERNALLY-represented (row, diff)
        updates (the DELETE/UPDATE write half)."""
        it = self.catalog.items[table]
        rows = [u[0] for u in updates]
        diffs = np.array([u[1] for u in updates], np.int64)
        cols, nulls = self._encode_internal(it.schema, rows)
        self._group_commit(table, cols, nulls, diffs)

    def _check_writable_table(self, name: str):
        it = self.catalog.items.get(name)
        if it is None or it.kind != "table":
            raise PlanError(f"{name!r} is not a writable table")
        return it

    def _sequence_delete(self, plan: DeletePlan) -> ExecuteResult:
        self._check_writable_table(plan.table)
        matched = self._read_rows_multiset(plan.expr)
        if not matched:
            return ExecuteResult("ok", affected=0)
        updates = [(vals, -mult) for vals, mult in matched.items()]
        n = sum(m for m in matched.values())
        self._table_write(plan.table, updates)
        return ExecuteResult("ok", affected=n)

    def _sequence_update(self, plan: UpdatePlan) -> ExecuteResult:
        it = self._check_writable_table(plan.table)
        arity = it.schema.arity
        matched = self._read_rows_multiset(plan.expr)
        if not matched:
            return ExecuteResult("ok", affected=0)
        updates = []
        n = 0
        for vals, mult in matched.items():
            old = vals[:arity]
            new = list(old)
            for tgt, src_pos in plan.set_positions.items():
                new[tgt] = _coerce_internal(
                    vals[src_pos],
                    plan.expr_schema.columns[src_pos],
                    it.schema.columns[tgt],
                )
            updates.append((old, -mult))
            updates.append((tuple(new), mult))
            n += mult
        self._table_write(plan.table, updates)
        return ExecuteResult("ok", affected=n)

    # -- subscribe ------------------------------------------------------------
    def _sequence_subscribe(self, plan: SubscribePlan) -> ExecuteResult:
        """SUBSCRIBE through the fan-out hub: same-query
        sessions share ONE dataflow + ONE sink-shard tail; bare-Get
        subscriptions of durable objects tail the object's own shard
        with zero installs. Admission sheds with ServerBusy (pgwire
        53400 / HTTP 503) past subscribe_max_sessions."""
        expr = optimize(self._inline_views(plan.expr))
        imports, index_imports = self._source_imports(expr)
        sub = self.subscribe_hub.subscribe(
            expr,
            imports,
            index_imports,
            plan.column_names,
            as_of=getattr(plan, "as_of", None),
        )
        res = ExecuteResult("subscription", columns=plan.column_names)
        res.subscription = sub
        return res

    def _inline_views(self, expr: mir.RelationExpr) -> mir.RelationExpr:
        """Replace Get(view) with the view's definition so rendered
        dataflows bottom out at sources (view inlining; the reference
        does this during global optimization). Operators are positional,
        so the view's internal column names need no reconciliation.

        INDEXED views are NOT inlined: a Get of an indexed view becomes
        an index import of the serving dataflow's device-resident
        arrangement (TraceManager sharing, arrangement/manager.rs:33) —
        the whole point of CREATE INDEX is that later dataflows reuse
        the maintained arrangement instead of recomputing the view."""

        def walk(e):
            if isinstance(e, mir.Get):
                it = self.catalog.items.get(e.name)
                if it is not None and it.kind == "view" and (
                    e.name not in self.peekable
                    # Basic-aggregate views are ALWAYS inlined, even
                    # when indexed: their index arrangement carries
                    # opaque digests that only the serving dataflow's
                    # own edge finalization can materialize — importing
                    # it into another dataflow would leak digests
                    # (doc/aggregates.md restrictions).
                    or _has_basic_aggs(it.definition, self.catalog)
                ):
                    return walk(it.definition)
                return e
            return _rewrite_children(e, walk)

        return walk(expr)

    def _source_imports(self, expr: mir.RelationExpr) -> tuple:
        """Every FREE Get leaf resolves to either a shard import
        (source subsource, table, MV shard) or an INDEX import (an
        indexed view's serving dataflow). Returns (shard_imports,
        index_imports). Let/LetRec-bound names are not imports."""
        imports: dict = {}
        index_imports: dict = {}

        def walk(e, bound: frozenset):
            if isinstance(e, mir.Let):
                walk(e.value, bound)
                walk(e.body, bound | {e.name})
                return
            if isinstance(e, mir.LetRec):
                inner = bound | set(e.names)
                for v in e.values:
                    walk(v, inner)
                walk(e.body, inner)
                return
            if isinstance(e, mir.Get):
                if e.name in bound:
                    return
                it = self.catalog.items.get(e.name)
                if it is None:
                    raise PlanError(f"unknown relation {e.name!r}")
                if it.kind == "view" and e.name in self.peekable:
                    index_imports[e.name] = (
                        self.peekable[e.name],
                        it.schema,
                    )
                elif it.kind in ("source", "materialized-view", "table"):
                    imports[e.name] = (it.definition["shard"], it.schema)
                else:
                    raise PlanError(
                        f"{e.name!r} ({it.kind}) is not directly "
                        "readable; create an index or materialize it"
                    )
            for c in e.children():
                walk(c, bound)

        walk(expr, frozenset())
        return imports, index_imports

    def _check_name_free(self, name: str, or_replace: bool = False) -> None:
        """Validate BEFORE durably recording DDL: a poison record that
        fails catalog.create on replay would brick every future boot."""
        if name in self.catalog.items and not or_replace:
            raise PlanError(f"catalog item {name!r} already exists")

    def _sequence_create_view(
        self, plan: CreateViewPlan, sql, replay, record=None
    ) -> ExecuteResult:
        schema = plan.expr.schema().rename(plan.column_names)
        expr = plan.expr
        if plan.materialized:
            self._check_name_free(plan.name, plan.or_replace)
            inlined = optimize(self._inline_views(expr))
            imports, index_imports = self._source_imports(inlined)
            if record is None:
                record = self._record_ddl(sql, {"name": plan.name})
            # Shard named by the unique record id: DROP + re-CREATE of
            # the same name must NOT resume from the old MV's data.
            shard = f"u{record['id']}_mv"
            try:
                self._register_dataflow(
                    DataflowDescription(
                        name=plan.name,
                        expr=inlined,
                        source_imports=imports,
                        sink_shard=shard,
                        index_imports=index_imports,
                    )
                )
            except BaseException:
                # Compensate: a poison record that fails on replay
                # would brick every future boot. On REPLAY the record
                # belongs to _bootstrap, which retracts it itself — a
                # second retraction here would drive the ledger sum
                # negative and could mask a future identical record.
                if not replay:
                    self._catalog_append(record, -1)
                raise
            self.catalog.create(
                CatalogItem(
                    name=plan.name,
                    kind="materialized-view",
                    schema=schema,
                    definition={"shard": shard, "expr": expr},
                    column_names=plan.column_names,
                ),
                or_replace=plan.or_replace,
            )
            self.peekable[plan.name] = plan.name
        else:
            self._check_name_free(plan.name, plan.or_replace)
            if not replay:
                self._record_ddl(sql, {"name": plan.name})
            self.catalog.create(
                CatalogItem(
                    name=plan.name,
                    kind="view",
                    schema=schema,
                    definition=expr,
                    column_names=plan.column_names,
                ),
                or_replace=plan.or_replace,
            )
        return ExecuteResult("ok")

    def _sequence_create_index(
        self, plan: CreateIndexPlan, sql, replay, record=None
    ) -> ExecuteResult:
        it = self.catalog.items.get(plan.on)
        if it is None:
            raise PlanError(f"unknown relation {plan.on!r}")
        self._check_name_free(plan.name)
        if plan.on in self.peekable:
            # MVs (and already-indexed views) are already peekable; the
            # reference would build another arrangement — we reuse, but
            # the index still gets a catalog item (visible, droppable).
            if not replay:
                self._record_ddl(sql, {"name": plan.name})
            self.catalog.create(
                CatalogItem(
                    name=plan.name,
                    kind="index",
                    schema=it.schema,
                    definition={"on": plan.on, "reused": True},
                )
            )
            return ExecuteResult("ok")
        if it.kind == "view":
            expr = optimize(self._inline_views(it.definition))
        elif it.kind == "source":
            expr = mir.Get(plan.on, it.schema)
        else:
            raise PlanError(f"cannot index {it.kind} {plan.on!r}")
        imports, index_imports = self._source_imports(expr)
        idx_record = None
        if not replay:
            idx_record = self._record_ddl(sql, {"name": plan.name})
        try:
            self._register_dataflow(
                DataflowDescription(
                    name=plan.name,
                    expr=expr,
                    source_imports=imports,
                    sink_shard=None,
                    index_imports=index_imports,
                )
            )
        except BaseException:
            if idx_record is not None:
                self._catalog_append(idx_record, -1)
            raise
        self.catalog.create(
            CatalogItem(
                name=plan.name,
                kind="index",
                schema=it.schema,
                definition={"on": plan.on},
            )
        )
        self.peekable[plan.on] = plan.name
        return ExecuteResult("ok")

    def _dependents(self, names: set) -> list[str]:
        """Live catalog items that reference any of `names` (Get leaves
        of view/MV definitions, index targets)."""
        out = []
        for it in self.catalog.items.values():
            if it.kind == "index":
                if it.definition["on"] in names:
                    out.append(it.name)
            elif it.kind in ("view", "materialized-view"):
                expr = (
                    it.definition
                    if it.kind == "view"
                    else it.definition["expr"]
                )
                hit = []

                def walk(e):
                    if isinstance(e, mir.Get) and e.name in names:
                        hit.append(e.name)
                    for c in e.children():
                        walk(c)

                walk(expr)
                if hit:
                    out.append(it.name)
        return out

    _DROP_KINDS = {
        "view": {"view", "materialized-view"},
        "source": {"source"},
        "index": {"index"},
        "table": {"table"},
        "sink": {"sink"},
        "object": {
            "view", "materialized-view", "source", "index", "table",
            "sink",
        },
    }

    def _sequence_drop(self, plan: DropPlan) -> ExecuteResult:
        name = plan.name
        it = self.catalog.items.get(name)
        if it is None:
            if plan.if_exists:
                return ExecuteResult("ok")
            raise PlanError(f"unknown catalog item {name!r}")
        allowed = self._DROP_KINDS.get(plan.kind.lower())
        if allowed is not None and it.kind not in allowed:
            raise PlanError(
                f"{name!r} is a {it.kind}, not a {plan.kind}"
            )
        # Dependency check: a drop that leaves a dangling reference
        # would make the durable catalog unreplayable (bricked boot).
        doomed = {name}
        if it.kind == "source":
            src = self.sources.get(name)
            if src is not None:
                doomed.update(src.adapter.subsources)
        # Memoized transient SELECT dataflows importing the dropped
        # object would block the DROP (importer bookkeeping): flush
        # exactly those entries before the checks below; unrelated
        # cached SELECTs keep their installs.
        self._flush_transient_peeks(doomed=doomed)
        self._ts_cache.clear()
        deps = [d for d in self._dependents(doomed) if d not in doomed]
        if deps:
            raise PlanError(
                f"cannot drop {name!r}: still depended on by {deps}"
            )
        # Installed dataflows importing this index's arrangement
        # (TraceManager sharing): dropping the publisher would strand
        # them mid-maintenance.
        importers = sorted(
            dn
            for dn, pubs in self._index_importers.items()
            if name in pubs
        )
        if importers:
            raise PlanError(
                f"cannot drop {name!r}: its arrangement is imported by "
                f"dataflows {importers}"
            )
        # Subscriptions tailing a dropped object's shard would block
        # forever on an upper that never advances again: close them
        # (their wire loops see `closed` and terminate the stream).
        self.subscribe_hub.close_for(doomed)
        # Remove the durable record (retract by replayed-sql identity).
        for rec in self._catalog_live_records():
            if rec.get("name") == name:
                self._catalog_append(rec, -1)
        if it.kind == "materialized-view":
            self._deregister_dataflow(name)
            self.controller.drop_dataflow(name)
            self.peekable.pop(name, None)
        elif it.kind == "index":
            self._deregister_dataflow(name)
            self.controller.drop_dataflow(name)
            on = it.definition["on"]
            if self.peekable.get(on) == name:
                del self.peekable[on]
        elif it.kind == "source":
            src = self.sources.pop(name, None)
            if src is not None:
                src.stop()
                for sub in src.adapter.subsources:
                    self.catalog.drop(sub, if_exists=True)
            self._webhooks.pop(name, None)
        elif it.kind == "table":
            self._table_writers.pop(name, None)
        elif it.kind == "sink":
            snk = self.sinks.pop(name, None)
            if snk is not None:
                snk.stop()
        # if_exists: a kafka source's own item IS one of its subsources,
        # already dropped by the loop above
        self.catalog.drop(name, if_exists=True)
        return ExecuteResult("ok")

    # -- peeks ---------------------------------------------------------------
    def _introspection_names(self, expr) -> set | None:
        """The introspection relations referenced by free Gets, or None
        if any free Get is NOT introspection (mixing is unsupported)."""
        names: set = set()
        non: list = []

        def walk(e, bound):
            if isinstance(e, mir.Let):
                walk(e.value, bound)
                walk(e.body, bound | {e.name})
                return
            if isinstance(e, mir.LetRec):
                inner = bound | set(e.names)
                for v in e.values:
                    walk(v, inner)
                walk(e.body, inner)
                return
            if isinstance(e, mir.Get) and e.name not in bound:
                it = self.catalog.items.get(e.name)
                if it is not None and it.kind == "introspection":
                    names.add(e.name)
                else:
                    non.append(e.name)
            for c in e.children():
                walk(c, bound)

        walk(expr, frozenset())
        if not names:
            return None
        if non:
            raise PlanError(
                "queries mixing introspection and ordinary relations "
                f"are not supported (introspection: {sorted(names)}, "
                f"other: {sorted(set(non))})"
            )
        return names

    def _sequence_introspection_peek(self, plan, expr) -> ExecuteResult:
        """Evaluate entirely coordinator-side: substitute snapshots as
        Constants and run one local dataflow step (full SQL surface over
        introspection state)."""
        from ..render.dataflow import Dataflow
        from .introspection import snapshot

        def subst(e):
            if isinstance(e, mir.Get):
                it = self.catalog.items.get(e.name)
                if it is not None and it.kind == "introspection":
                    rows = tuple(
                        (vals, 1) for vals in snapshot(self, e.name)
                    )
                    return mir.Constant(rows, it.schema)
                return e
            return _rewrite_children(e, subst)

        from ..utils.lockcheck import allow_dispatch

        with allow_dispatch("introspection constants"):
            # Sanctioned dispatch under the sequencing lock: the plan is
            # pure Constants over coordinator snapshots — bounded rows,
            # no source waits — stepped once on the coordinator's device
            # (the lockcheck dispatch-under-lock rule would flag it).
            df = Dataflow(subst(expr), device=self.device)
            df.step({})
            rows = _decode_peek_rows(df.output_batch(), df)
        return ExecuteResult(
            "rows",
            rows=_finish(rows, plan.order_by,
                         getattr(plan, "limit", None),
                         getattr(plan, "offset", 0)),
            columns=plan.column_names,
            schema=expr.schema(),
        )

    def _sequence_peek(self, plan: SelectPlan) -> ExecuteResult:
        expr = optimize(self._inline_views(plan.expr))
        if self._introspection_names(expr) is not None:
            return self._sequence_introspection_peek(plan, expr)
        as_of_req = getattr(plan, "as_of", None)
        # O(result) fast path (coord/peek.py): a key-equality
        # lookup or full scan over a peekable relation row-gathers
        # straight from the maintained spine — no transient dataflow,
        # no render, batched with concurrent sessions' lookups into one
        # device gather. AS OF reads keep the multiversion peek path.
        from ..utils.dyncfg import PEEK_FAST_PATH

        if as_of_req is None and PEEK_FAST_PATH(COMPUTE_CONFIGS):
            from ..plan.decisions import peek_fast_path

            dec = peek_fast_path(expr, frozenset(self.peekable))
            if dec is not None and not self._peek_has_basic(dec.name):
                return self._sequence_fast_peek(plan, expr, dec)
        # Peekable bare Get (peek.rs fast-path detection): serve the
        # maintained dataflow's full result via the ordinary peek
        # protocol (the AS OF / fast-path-disabled route). Timestamp
        # selection (coord/timestamp_selection.rs): read at the latest
        # complete time of the UPSTREAM SOURCES, waiting for the
        # dataflow's frontier to pass it (freshness: the read is
        # linearizable w.r.t. ingested data, not merely whatever the
        # dataflow happens to have processed).
        if isinstance(expr, mir.Get) and expr.name in self.peekable:
            df = self.peekable[expr.name]
            if as_of_req is not None:
                # AS OF: serve at exactly the requested time (a rewind
                # inside the dataflow's multiversion window, or an
                # error outside it).
                as_of, exact = as_of_req, True
            else:
                as_of = self._select_timestamp_shards(
                    self._df_upstream.get(df, [])
                )
                exact = False
            with self._unlocked():
                rows, _ = self.controller.peek(
                    df, as_of=as_of, timeout=_peek_timeout(), exact=exact
                )
            return ExecuteResult(
                "rows",
                rows=_finish(rows, plan.order_by,
                         getattr(plan, "limit", None),
                         getattr(plan, "offset", 0)),
                columns=plan.column_names,
                schema=expr.schema(),
            )
        # Slow path: transient dataflow, peek, drop (life-of-a-query
        # slow path).
        rows = self._transient_peek(expr, unlocked=True, as_of=as_of_req)
        return ExecuteResult(
            "rows",
            rows=_finish(rows, plan.order_by,
                         getattr(plan, "limit", None),
                         getattr(plan, "offset", 0)),
            columns=plan.column_names,
            schema=expr.schema(),
        )

    # -- the O(result) fast path (coord/peek.py serving plane) ---------------
    def _peek_has_basic(self, name: str) -> bool:
        """Basic-aggregate (string_agg/array_agg/list_agg) outputs carry
        opaque digests in the maintained arrangement; only the serving
        dataflow's own edge finalization can materialize them, so such
        relations keep the ordinary peek path."""
        it = self.catalog.items.get(name)
        if it is None:
            return False
        if it.kind == "materialized-view":
            return _has_basic_aggs(it.definition["expr"], self.catalog)
        if it.kind == "view":
            return _has_basic_aggs(it.definition, self.catalog)
        return False

    def _select_peek_timestamp(self, df: str) -> int:
        """Timestamp selection for a fast-path read, with an optional
        serving-mode cache (peek_ts_cache_ms): under concurrency, reads
        within one serving tick share a selected timestamp instead of
        each paying a consensus read — invalidated by any write through
        this coordinator, so read-your-writes holds; staleness w.r.t.
        out-of-band source ticks is bounded by the window."""
        from ..utils.dyncfg import PEEK_TS_CACHE_MS

        ttl = float(PEEK_TS_CACHE_MS(COMPUTE_CONFIGS)) / 1000.0
        if ttl > 0:
            hit = self._ts_cache.get(df)
            if (
                hit is not None
                and hit[2] == self._write_epoch
                and _time.monotonic() - hit[1] < ttl
            ):
                return hit[0]
        # Pipelined replicas: the selected source time may
        # run up to one span ahead of the replica's COMMITTED
        # frontier. The read does NOT clamp to the reported frontier —
        # that would break read-your-writes (the write epoch
        # invalidates this cache precisely so a post-write read
        # re-selects a timestamp covering the write, and the reported
        # frontier can lag it). Instead the replica sequences the
        # admitted peek itself: a pending peek whose as_of is past the
        # committed frontier forces the in-flight span's boundary
        # readback (replica._serve_peeks -> view.sync_spans), so the
        # wait is one boundary commit, not a stall behind the span
        # pipeline.
        as_of = self._select_timestamp_shards(
            self._df_upstream.get(df, [])
        )
        if ttl > 0:
            self._ts_cache[df] = (
                as_of, _time.monotonic(), self._write_epoch
            )
        return as_of

    def _fast_peek_rows(self, dec) -> list:
        """Raw (vals..., time, diff) rows for a fast-path decision:
        timestamp-select, then one batched lookup through the
        controller's read plane (the sequencing lock is released for
        the wait — and for the ServerBusy shed, which must never poison
        subsequent statements)."""
        if dec.kind == "empty":
            return []
        df = self.peekable[dec.name]
        as_of = self._select_peek_timestamp(df)
        bound_cols = tuple(c for c, _ in dec.bound)
        probe = tuple(lit.value for _, lit in dec.bound)
        with self._unlocked():
            rows, _served = self.controller.peek_lookup(
                df,
                bound_cols,
                dec.kind == "scan",
                probe,
                as_of,
                timeout=_peek_timeout(),
            )
        return rows

    def _sequence_fast_peek(self, plan, expr, dec) -> ExecuteResult:
        rows = self._fast_peek_rows(dec)
        if dec.projection is not None:
            rows = [
                tuple(r[c] for c in dec.projection) + r[-2:]
                for r in rows
            ]
        return ExecuteResult(
            "rows",
            rows=_finish(rows, plan.order_by,
                         getattr(plan, "limit", None),
                         getattr(plan, "offset", 0)),
            columns=plan.column_names,
            schema=expr.schema(),
        )

    def fast_peek_values(
        self, name: str, values: tuple, bound_cols: tuple | None = None
    ) -> list:
        """Programmatic point lookup over a peekable relation — the
        serving-plane API bench.py --serve and tests drive (the SQL
        front end reaches the same plane through _sequence_peek; this
        entry point skips parsing/planning, like a prepared statement
        with bound parameters). ``values`` are user-space; ``bound_cols``
        defaults to the leading columns. Returns finished result rows."""
        with self._lock:
            if name not in self.peekable:
                raise PlanError(f"{name!r} is not peekable")
            it = self.catalog.items[name]
            cols = tuple(
                bound_cols
                if bound_cols is not None
                else range(len(values))
            )
            probe = tuple(
                self._encode_probe(it.schema.columns[c], v)
                for c, v in zip(cols, values)
            )
            df = self.peekable[name]
            as_of = self._select_peek_timestamp(df)
        # Dispatch + wait WITHOUT the sequencing lock (the _unlocked
        # dance would re-acquire just to release again): everything
        # the read needs was resolved above.
        rows, _ = self.controller.peek_lookup(
            df, cols, False, probe, as_of, timeout=_peek_timeout()
        )
        return _finish(rows)

    def _encode_probe(self, col: Column, v):
        """User-space probe value -> internal representation (exactly
        _encode_insert's per-value rule, so probes compare raw against
        maintained columns)."""
        if v is None:
            raise PlanError("NULL never matches an equality lookup")
        # Column-type checks FIRST (an int probe against a TEXT/BOOL
        # column must still dictionary-encode/coerce, exactly like
        # _encode_insert); the plain-numeric tail skips the temporal
        # coercion helper, whose per-call imports cost real time at
        # thousands of lookups per second.
        if col.ctype is ColumnType.STRING:
            return GLOBAL_DICT.encode(str(v))
        if col.ctype is ColumnType.DECIMAL:
            return round(float(v) * 10**col.scale)
        if col.ctype is ColumnType.BOOL:
            return bool(v)
        if type(v) is int or type(v) is float:
            return v
        return self._temporal_to_int(v, col)

    def _register_dataflow(
        self, desc: DataflowDescription, unlocked: bool = True,
        durable: bool = True,
    ) -> None:
        # Last line of defense before a DURABLE plan ships to replicas:
        # the MIR/LIR typechecker (analysis/typecheck.py). Catching an
        # invalid plan here costs a DDL error; catching it replica-side
        # costs a render failure inside wait_installed with a worse
        # message. Transient peeks (durable=False) skip it — the check
        # would sit on every slow-path SELECT's latency, and a broken
        # transient plan fails the one peek, not a persisted object.
        # Also skipped when the optimizer_typecheck dyncfg is on: every
        # call site passes optimize() output straight here, and under
        # the flag the optimizer already typechecked after each
        # transform (naming the offender) and ran typecheck_lir.
        from ..utils.dyncfg import COMPUTE_CONFIGS, OPTIMIZER_TYPECHECK

        if durable and not OPTIMIZER_TYPECHECK(COMPUTE_CONFIGS):
            from ..analysis import typecheck, typecheck_lir

            typecheck(desc.expr)
            typecheck_lir(desc.expr)
        # Transitive upstream shards: index imports contribute their
        # PUBLISHER's upstream so timestamp selection for reads over
        # shared arrangements still sees the real persist inputs.
        shards = [sh for sh, _ in desc.source_imports.values()]
        for pub_name, _schema in desc.index_imports.values():
            shards += self._df_upstream.get(pub_name, [])
        self._df_upstream[desc.name] = sorted(set(shards))
        self._index_importers[desc.name] = {
            pub for pub, _ in desc.index_imports.values()
        }
        try:
            self.controller.create_dataflow(desc)
            # Surface replica-side install failures AT DDL TIME: a bad
            # plan raises here instead of leaving a ghost dataflow that
            # every later peek reports as "no such dataflow". The wait
            # covers hydration, so release the sequencing lock unless
            # the caller needs read-write atomicity (DML).
            if unlocked:
                with self._unlocked():
                    self.controller.wait_installed(desc.name)
            else:
                self.controller.wait_installed(desc.name)
        except BaseException:
            # A failed install must not leave importer bookkeeping that
            # would permanently block DROP INDEX on the publisher, NOR
            # a ghost command in the controller history that every
            # replica reconnect would replay forever.
            self._deregister_dataflow(desc.name)
            try:
                self.controller.drop_dataflow(desc.name)
            except Exception:
                pass
            raise

    def _deregister_dataflow(self, name: str) -> None:
        """Forget a dataflow's upstream + importer bookkeeping. Every
        drop path must come through here: a stale _index_importers entry
        permanently blocks DROP INDEX on the publisher."""
        self._df_upstream.pop(name, None)
        self._index_importers.pop(name, None)

    def _select_timestamp_shards(self, shards: list[str]) -> int:
        """Timestamp selection (coord/timestamp_selection.rs): the latest
        complete time across the inputs = min(upper) - 1."""
        uppers = [
            self.persist.machine(sh).reload().upper for sh in shards
        ]
        if not uppers:
            return 0
        return max(min(uppers) - 1, 0)

    def update_config(self, values: dict) -> None:
        """Apply dyncfg updates and propagate to replicas in
        command-stream order (dyncfg sync + UpdateConfiguration). Raw
        DELTAS are shipped (None = reset-to-default) so resets reach
        replicas and reconnect replay stays faithful — a full override
        map would silently drop resets."""
        COMPUTE_CONFIGS.update(values)
        if "trace_level" in values:
            # The trace_level dyncfg drives this process's span
            # recorder; replicas flip theirs when the
            # UpdateConfiguration command reaches them.
            from ..utils.trace import LEVELS, TRACER

            lvl = values["trace_level"]
            if lvl is None:
                from ..utils.dyncfg import TRACE_LEVEL

                lvl = TRACE_LEVEL.default
            if lvl in LEVELS:
                TRACER.set_level(lvl)
        self.controller.update_configuration(dict(values))

    def shutdown(self) -> None:
        self._flush_transient_peeks()
        for src in self.sources.values():
            src.stop()
        for snk in self.sinks.values():
            snk.stop()
        self.subscribe_hub.shutdown()
        self.controller.shutdown()


def _coerce_internal(v, from_col: Column, to_col: Column):
    """Coerce a USER-SPACE value between column types (UPDATE SET
    expression -> target column). Rows arrive decoded
    (decode_result_rows: decimals as decimal.Decimal), and
    _encode_internal re-scales on the write path, so all arithmetic
    here is in user space."""
    import decimal

    if v is None:
        if not to_col.nullable:
            raise PlanError(
                f"null value in non-nullable column {to_col.name!r}"
            )
        return None
    if to_col.ctype is ColumnType.DECIMAL:
        q = decimal.Decimal(1).scaleb(-to_col.scale)
        return decimal.Decimal(str(v)).quantize(
            q, rounding=decimal.ROUND_HALF_UP
        )
    if to_col.ctype is ColumnType.FLOAT64:
        return float(v)
    if to_col.ctype is ColumnType.STRING:
        return str(v)
    if to_col.ctype is ColumnType.BOOL:
        return bool(v)
    if isinstance(v, decimal.Decimal):
        # numeric -> integer rounds half away from zero (pg)
        return int(
            v.quantize(0, rounding=decimal.ROUND_HALF_UP)
        )
    return int(v)


def _finish(rows: list, order_by: tuple = (), limit=None,
            offset: int = 0) -> list:
    """Collapse (cols..., time, diff) into SELECT result rows with
    multiplicities expanded and the query's ORDER BY applied
    (RowSetFinishing application, coord/peek.rs:910). Without an ORDER
    BY, rows sort by full value for determinism; NULLs sort first (ASC)
    as in the reference's Datum ordering."""
    # Point-lookup fast path: one row, multiplicity one — nothing to
    # collapse or sort (the serving plane's hottest result shape).
    if (
        len(rows) == 1
        and not order_by
        and not offset
        and limit is None
        and rows[0][-1] == 1
    ):
        return [rows[0][:-2]]
    acc: dict = {}
    for r in rows:
        acc[r[:-2]] = acc.get(r[:-2], 0) + r[-1]

    def default_key(vals):
        return tuple(
            (v is not None, v if v is not None else 0) for v in vals
        )

    if order_by:

        def key(vals):
            parts = []
            for idx, desc, nulls_last in order_by:
                v = vals[idx]
                null_rank = (v is None) == nulls_last  # False sorts first
                if v is None:
                    parts.append((null_rank, _Rev(0) if desc else 0))
                else:
                    parts.append(
                        (null_rank, _Rev(v) if desc else v)
                    )
            # Full-row tiebreak keeps output deterministic.
            return (tuple(parts), default_key(vals))

    else:
        key = default_key

    out = []
    for vals in sorted(acc.keys(), key=key):
        mult = acc[vals]
        if mult < 0:
            raise RuntimeError(
                f"negative multiplicity {mult} for row {vals} "
                "(non-monotonic input to a raw SELECT?)"
            )
        out.extend([vals] * mult)
    if offset:
        out = out[offset:]
    if limit is not None:
        out = out[: int(limit)]
    return out


class _Rev:
    """Reverses comparison order for DESC sort keys."""

    __slots__ = ("v",)

    def __init__(self, v):
        self.v = v

    def __eq__(self, other):
        return self.v == other.v

    def __lt__(self, other):
        return other.v < self.v


def _has_basic_aggs(expr, catalog=None, _seen=None) -> bool:
    """Does any Reduce in this MIR tree use a basic (collection)
    aggregate? Such plans finalize at their own serving edge and cannot
    be shared through index imports. With a catalog, Get(view) leaves
    resolve TRANSITIVELY (a wrapper view over a basic-aggregate view
    inlines that view, so its dataflow carries the finalizers too)."""
    if isinstance(expr, mir.Reduce) and any(
        a.func.is_basic for a in expr.aggregates
    ):
        return True
    if catalog is not None and isinstance(expr, mir.Get):
        seen = _seen or set()
        if expr.name in seen:
            return False
        it = catalog.items.get(expr.name)
        if it is not None and it.kind == "view":
            return _has_basic_aggs(
                it.definition, catalog, seen | {expr.name}
            )
        return False
    return any(
        _has_basic_aggs(c, catalog, _seen) for c in expr.children()
    )


def _rewrite_children(e: mir.RelationExpr, fn) -> mir.RelationExpr:
    """Rebuild `e` with `fn` applied to every RelationExpr child
    (generic MIR visitor; the nodes are frozen dataclasses)."""
    import dataclasses

    kwargs = {}
    for f in dataclasses.fields(e):
        v = getattr(e, f.name)
        if isinstance(v, mir.RelationExpr):
            nv = fn(v)
            if nv is not v:
                kwargs[f.name] = nv
        elif (
            isinstance(v, tuple)
            and v
            and all(isinstance(x, mir.RelationExpr) for x in v)
        ):
            nv = tuple(fn(x) for x in v)
            if any(a is not b for a, b in zip(nv, v)):
                kwargs[f.name] = nv
    return dataclasses.replace(e, **kwargs) if kwargs else e
