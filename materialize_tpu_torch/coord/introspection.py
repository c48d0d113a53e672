"""Introspection relations: the mz_internal / mz_catalog analog.

The reference renders timely/differential/compute event logs as
arrangements queryable through hundreds of ``mz_internal`` relations
(``compute/src/logging/*``, ``catalog/src/builtin.rs``). The TPU
re-cast: introspection relations are *virtual* — each has a schema and a
snapshot function over coordinator state (catalog, controller frontiers,
arrangement sizes, metrics, trace spans); a SELECT that references only
introspection relations is evaluated coordinator-side by substituting
the snapshots as constants into the plan and running it through the
ordinary dataflow renderer, so the FULL SQL surface (joins, aggregates,
ORDER BY) works over them.

In the port every relation is registered with the reference's schema.
One reads state the port does not have and raises ``NotImplementedError``
naming its ROADMAP item when selected (:data:`UNPORTED`): the program
bank. ``mz_donation`` and ``mz_sharding`` serve the replicas' donation
verdicts (``analysis/donation.py``) and single-device sharding reports
(``analysis/shard_prop.py``) with EXPLAIN ANALYSIS's formatters.
``mz_compile_log``
lists the port's native library builds and loads
(``utils/compile_ledger.py``). ``mz_recovery`` has no ``compile`` scope:
no program bank serves compiles in eager torch.
"""

from __future__ import annotations

from ..repr.schema import GLOBAL_DICT, Column, ColumnType, Schema

S = ColumnType.STRING
I = ColumnType.INT64
F = ColumnType.FLOAT64


def _enc(s: str) -> int:
    return GLOBAL_DICT.encode(s)


# Relations over reference state with no counterpart in the port yet:
# name -> where its source waits.
UNPORTED = {
    "mz_program_bank": (
        "ROADMAP Queue 2 item 6: the program bank has no counterpart in "
        "eager torch"
    ),
}


INTROSPECTION_SCHEMAS: dict[str, Schema] = {
    "mz_objects": Schema(
        [Column("id", I), Column("name", S), Column("type", S)]
    ),
    "mz_sources": Schema(
        [Column("name", S), Column("generator", S), Column("tick", I)]
    ),
    "mz_dataflows": Schema(
        [Column("name", S), Column("sink_shard", S), Column("on", S)]
    ),
    "mz_dataflow_frontiers": Schema(
        [Column("dataflow", S), Column("replica", S), Column("upper", I)]
    ),
    "mz_arrangement_sizes": Schema(
        [
            Column("dataflow", S),
            Column("replica", S),
            Column("records", I),
            # Device-resident bytes per spine component:
            # the run ladder, the append-slot ingest ring, the cached
            # sort lanes, and the multiversion history window.
            Column("bytes", I),
            Column("runs_bytes", I),
            Column("slots_bytes", I),
            Column("lanes_bytes", I),
            Column("history_bytes", I),
            # Batch-part tiering: encoded bytes of this
            # dataflow's shard parts host-resident in the hot tier vs
            # blob-only cold — the accounting that drives the
            # part_hot_bytes budget boundary.
            Column("hot_bytes", I),
            Column("cold_bytes", I),
        ]
    ),
    "mz_compactions": Schema(
        [
            # Counted compaction-plane activity per shard:
            # which lease epoch last compacted it, merge counts by
            # context (background service vs writer-inline), the
            # bytes in/out of merges, and the seconds of maintenance
            # spent OFF the serving path. The compactor-smoke gate
            # and the acceptance criterion read these counters.
            Column("shard", S),
            Column("replica", S),
            Column("lease_epoch", I),
            Column("requests", I),
            Column("merges_background", I),
            Column("merges_inline", I),
            Column("merges_lost", I),
            Column("blob_writes_background", I),
            Column("blob_writes_inline", I),
            Column("input_bytes", I),
            Column("output_bytes", I),
            Column("off_path_ms", I),
            Column("fenced", I),
            Column("crashes", I),
        ]
    ),
    "mz_span_epochs": Schema(
        [
            Column("dataflow", S),
            Column("replica", S),
            Column("span_epoch", I),
        ]
    ),
    "mz_donation": Schema(
        [
            Column("dataflow", S),
            Column("replica", S),
            Column("safe", I),
            Column("requested", I),
            Column("wired", I),
            Column("donated", S),
            Column("provenance", S),
        ]
    ),
    "mz_sharding": Schema(
        [
            Column("dataflow", S),
            Column("replica", S),
            Column("spmd", I),
            Column("workers", I),
            Column("ingest_mode", S),
            Column("safe", I),
            Column("collectives", I),
            Column("comm_bytes", I),
            Column("blame", S),
        ]
    ),
    "mz_recovery": Schema(
        [
            Column("scope", S),
            Column("object", S),
            Column("replica", S),
            Column("metric", S),
            Column("value", F),
        ]
    ),
    "mz_subscriptions": Schema(
        [
            Column("session", I),
            Column("dataflow", S),
            Column("sharers", I),
            Column("frontier", I),
            Column("queued", I),
            Column("delivered", I),
            Column("sheds", I),
            Column("lag_ms", F),
        ]
    ),
    "mz_metrics": Schema(
        [Column("metric", S), Column("value", F)]
    ),
    "mz_trace_spans": Schema(
        [
            # The statement trace tree: one trace_id per
            # statement; spans from every process (pgwire/coordinator/
            # controller locally, replicas via the Frontiers
            # piggyback) share the id space, parent_id links the tree
            # across the CTP boundary. parent_id 0 = root.
            Column("trace_id", I),
            Column("span_id", I),
            Column("parent_id", I),
            Column("process", S),
            Column("name", S),
            Column("level", S),
            Column("start_us", I),
            Column("duration_us", I),
        ]
    ),
    "mz_compile_log": Schema(
        [
            # Every native library build or load anywhere in the
            # deployment: the compiler (nvcc, g++), the library's
            # source, its source-and-flags fingerprint, the flags, wall
            # seconds, and "miss" (built) or "hit" (an earlier build
            # loaded). The column names are the reference's.
            Column("process", S),
            Column("kind", S),
            Column("dataflow", S),
            Column("fingerprint", S),
            Column("tier", S),
            Column("seconds", F),
            Column("cache", S),
        ]
    ),
    "mz_program_bank": Schema(
        [
            # The persistent AOT program bank: one row per
            # banked executable (kind/fingerprint/tier parsed from the
            # entry filename, size and store time from stat) plus one
            # row per async hot-swap in flight (kind="swap",
            # dataflow=the DDL, state=pending|swapped|swap-failed).
            Column("kind", S),
            Column("dataflow", S),
            Column("fingerprint", S),
            Column("tier", S),
            Column("bytes", I),
            Column("state", S),
            Column("stored_at", F),
        ]
    ),
    "mz_slow_statements": Schema(
        [
            Column("sql", S),
            Column("ms", F),
            Column("trace_id", I),
        ]
    ),
    "mz_cluster_replicas": Schema(
        [
            Column("name", S),
            Column("connected", I),
            # Lifecycle state: active | draining (a
            # draining replica stays connected but takes no new
            # routed reads).
            Column("state", S),
            # Reads routed to this replica (the per-replica routing
            # distribution bench.py --serve reports).
            Column("routed", I),
        ]
    ),
    # Every autoscaler decision with its triggering evidence
    # (coord/autoscaler.py ledger): why each replica was
    # spawned or drained, explainable after the fact.
    "mz_autoscale_events": Schema(
        [
            Column("at", F),
            Column("action", S),
            Column("replica", S),
            Column("reason", S),
            Column("evidence", S),
        ]
    ),
    # -- the freshness plane -----------------------------------
    "mz_wallclock_lag_history": Schema(
        [
            # One row per committed span boundary (bounded ring,
            # coord/freshness.py): how far the committed frontier
            # trailed the wallclock arrival of its newest input tick.
            Column("dataflow", S),
            Column("replica", S),
            Column("frontier", I),
            Column("lag_ms", F),
            Column("at", F),
        ]
    ),
    "mz_wallclock_lag_summary": Schema(
        [
            # The windowed quantile rollup (nearest-rank over the last
            # WINDOW_PER_KEY samples per (dataflow, replica)).
            Column("dataflow", S),
            Column("replica", S),
            Column("samples", I),
            Column("p50_ms", F),
            Column("p90_ms", F),
            Column("p99_ms", F),
            Column("max_ms", F),
        ]
    ),
    "mz_hydration_statuses": Schema(
        [
            # The per-(dataflow, replica) hydration status machine:
            # pending -> hydrating -> hydrated -> stalled, with the
            # transition timestamp, build attempt count, and last
            # error. wait_installed stamps `stalled` when the install
            # budget expires without an ack (the formerly silent path).
            Column("dataflow", S),
            Column("replica", S),
            Column("status", S),
            Column("since", F),
            Column("attempts", I),
            Column("last_error", S),
        ]
    ),
    "mz_source_statuses": Schema(
        [
            # Ingest-loop health per source: running / stalled /
            # dropped, the last tick and its wallclock, last error.
            Column("name", S),
            Column("generator", S),
            Column("status", S),
            Column("tick", I),
            Column("since", F),
            Column("last_error", S),
        ]
    ),
    "mz_sink_statuses": Schema(
        [
            # Persist-sink progress per (sinked dataflow, replica),
            # derived from the reported frontier and the hydration
            # board: running once the frontier advanced, stalled when
            # the dataflow's status machine says so.
            Column("name", S),
            Column("sink_shard", S),
            Column("replica", S),
            Column("status", S),
            Column("frontier", I),
            Column("last_error", S),
        ]
    ),
    "mz_freshness_events": Schema(
        [
            # Bounded event ring: freshness_slo_ms breach onsets and
            # hydration stalls.
            Column("object", S),
            Column("replica", S),
            Column("kind", S),
            Column("lag_ms", F),
            Column("at", F),
        ]
    ),
}


def snapshot(coord, name: str) -> list[tuple]:
    """Current rows of one introspection relation (values already
    dictionary-encoded for Constant substitution)."""
    if name in UNPORTED:
        raise NotImplementedError(
            f"introspection relation {name!r} is not ported "
            f"({UNPORTED[name]})"
        )
    if name == "mz_donation":
        # The buffer-provenance prover's verdicts: per
        # (dataflow, replica), whether the run_steps span train's
        # carry is provably donatable, which parts actually donate
        # (requested && safe), whether the backend wires the argnums,
        # and the provenance class census of the scanned state tree.
        with coord.controller._lock:
            snap = {
                df: dict(per)
                for df, per in (
                    coord.controller.donation_verdicts.items()
                )
            }
        from ..analysis.donation import verdict_display

        rows = []
        for df, per in sorted(snap.items()):
            for rep, v in sorted(per.items()):
                donated, prov = verdict_display(v)
                rows.append(
                    (
                        _enc(df),
                        _enc(rep),
                        int(bool(v.get("safe"))),
                        int(bool(v.get("requested"))),
                        int(bool(v.get("wired"))),
                        _enc(donated),
                        _enc(prov),
                    )
                )
        return rows
    if name == "mz_sharding":
        # The shard-spec reports: per (dataflow,
        # replica), whether the dataflow runs SPMD, how many workers,
        # the prover-gated ingest mode, the SPMD-safety verdict of its
        # slot-ring cursors (vacuously safe in merge mode), and the
        # communication census (collective count + per-device bytes),
        # with the offending collective sites in `blame` when refuted.
        with coord.controller._lock:
            snap = {
                df: dict(per)
                for df, per in (
                    coord.controller.sharding_verdicts.items()
                )
            }
        from ..analysis.shard_prop import sharding_display

        rows = []
        for df, per in sorted(snap.items()):
            for rep, v in sorted(per.items()):
                census = v.get("census") or {}
                _ctext, blame = sharding_display(v)
                rows.append(
                    (
                        _enc(df),
                        _enc(rep),
                        int(bool(v.get("spmd"))),
                        int(v.get("workers") or 1),
                        _enc(str(v.get("ingest_mode") or "")),
                        int(bool(v.get("safe"))),
                        int(census.get("collectives") or 0),
                        int(census.get("bytes") or 0),
                        _enc(blame),
                    )
                )
        return rows
    if name == "mz_span_epochs":
        # The committed span boundaries: per (dataflow, replica), the
        # monotone span-epoch counter frontier reports ride on — what
        # peeks and compaction sequence against.
        with coord.controller._lock:
            snap = {
                df: dict(per)
                for df, per in coord.controller.span_epochs.items()
            }
        return [
            (_enc(df), _enc(rep), e)
            for df, per in sorted(snap.items())
            for rep, e in sorted(per.items())
        ]
    if name == "mz_compile_log":
        from ..utils.compile_ledger import LEDGER

        return [
            (
                _enc(r.process),
                _enc(r.kind),
                _enc(r.name),
                _enc(r.fingerprint),
                _enc(r.tier),
                float(r.seconds),
                _enc(r.cache),
            )
            for r in LEDGER.records()
        ]
    if name == "mz_objects":
        rows = []
        for i, it in enumerate(sorted(
            coord.catalog.items.values(), key=lambda x: x.name
        )):
            rows.append((i, _enc(it.name), _enc(it.kind)))
        return rows
    if name == "mz_sources":
        return [
            (_enc(n), _enc(type(src.adapter).__name__), src.t)
            for n, src in sorted(coord.sources.items())
        ]
    if name == "mz_dataflows":
        rows = []
        for it in sorted(
            coord.catalog.items.values(), key=lambda x: x.name
        ):
            if it.kind == "materialized-view":
                rows.append(
                    (
                        _enc(it.name),
                        _enc(it.definition["shard"]),
                        _enc(it.name),
                    )
                )
            elif it.kind == "index":
                rows.append(
                    (_enc(it.name), _enc(""), _enc(it.definition["on"]))
                )
        return rows
    if name == "mz_dataflow_frontiers":
        with coord.controller._lock:
            snap = {
                df: dict(per)
                for df, per in coord.controller.frontiers.items()
            }
        return [
            (_enc(df), _enc(rep), upper)
            for df, per in sorted(snap.items())
            for rep, upper in sorted(per.items())
        ]
    if name == "mz_arrangement_sizes":
        with coord.controller._lock:
            snap = {
                df: dict(per)
                for df, per in coord.controller.arrangement_records.items()
            }
            bsnap = {
                df: dict(per)
                for df, per in coord.controller.arrangement_bytes.items()
            }
        rows = []
        for df, per in sorted(snap.items()):
            for rep, n in sorted(per.items()):
                b = bsnap.get(df, {}).get(rep, {})
                comp = [
                    int(b.get(k, 0))
                    for k in ("runs", "slots", "lanes", "history")
                ]
                rows.append(
                    (
                        _enc(df), _enc(rep), n, sum(comp), *comp,
                        int(b.get("part_hot", 0)),
                        int(b.get("part_cold", 0)),
                    )
                )
        return rows
    if name == "mz_compactions":
        # Coordinator + in-process replicas share the process-global
        # registry; subprocess replicas' rows arrive via the Frontiers
        # piggyback (controller.compactions). Replica "" = this
        # process.
        from ..storage.persist.compactor import STATS as _CSTATS

        with coord.controller._lock:
            shipped = {
                sh: dict(per)
                for sh, per in coord.controller.compactions.items()
            }
        merged: list = []
        for sh, s in sorted(_CSTATS.rows().items()):
            merged.append((sh, "", s))
        for sh, per in sorted(shipped.items()):
            for rep, s in sorted(per.items()):
                merged.append((sh, rep, s))
        return [
            (
                _enc(sh), _enc(rep),
                int(s.get("lease_epoch", 0)),
                int(s.get("requests", 0)),
                int(s.get("merges_background", 0)),
                int(s.get("merges_inline", 0)),
                int(s.get("merges_lost", 0)),
                int(s.get("blob_writes_background", 0)),
                int(s.get("blob_writes_inline", 0)),
                int(s.get("input_bytes", 0)),
                int(s.get("output_bytes", 0)),
                int(round(1000.0 * s.get("off_path_s", 0.0))),
                int(s.get("fenced", 0)),
                int(s.get("crashes", 0)),
            )
            for sh, rep, s in merged
        ]
    if name == "mz_recovery":
        # Crash-recovery accounting: coordinator boot
        # replay counts, per-replica session/fence counters, and the
        # per-dataflow install/rebuild/reconcile counts replicas
        # piggyback on Frontiers. `rebuilds == 0` for a
        # fingerprint-unchanged dataflow across a restart IS the
        # counted reconciliation invariant.
        rows = []
        for metric, value in sorted(coord.recovery.items()):
            rows.append(
                (_enc("coordinator"), _enc(""), _enc(""),
                 _enc(metric), float(value))
            )
        snap = coord.controller.recovery_snapshot()
        for rep, st in sorted(snap["replicas"].items()):
            for metric in ("sessions", "reconnects", "fenced",
                           "connected"):
                rows.append(
                    (_enc("replica"), _enc(""), _enc(rep),
                     _enc(metric), float(st[metric]))
                )
        for df, per in sorted(snap["dataflows"].items()):
            for rep, v in sorted(per.items()):
                for metric in ("installs", "rebuilds", "reconciles",
                               "hydrate_ms"):
                    rows.append(
                        (_enc("dataflow"), _enc(df), _enc(rep),
                         _enc(metric), float(v.get(metric, 0)))
                    )
        return rows
    if name == "mz_subscriptions":
        # The push plane's live sessions: per session, the
        # shared tail it rides (`sharers` = sessions on the same tail
        # — the fan-out sharing made relationally visible), its
        # delivered progress frontier, queue depth, rows delivered,
        # slow-consumer sheds, and last observed delivery lag.
        return [
            (
                sid,
                _enc(df),
                sharers,
                frontier,
                queued,
                delivered,
                sheds,
                float(lag_ms),
            )
            for (
                sid, df, sharers, frontier, queued, delivered, sheds,
                lag_ms,
            ) in coord.subscribe_hub.introspection_rows()
        ]
    if name == "mz_metrics":
        from ..utils.metrics import REGISTRY

        def full_name(sname, labels):
            return sname + (
                "{" + ",".join(
                    f"{k}={v}" for k, v in sorted(labels.items())
                ) + "}"
                if labels
                else ""
            )

        rows = []
        with REGISTRY._lock:  # copy: registration may race iteration
            metrics = list(REGISTRY._metrics.values())
        for m in sorted(metrics, key=lambda m: m.name):
            for sname, labels, value in m.samples():
                rows.append((_enc(full_name(sname, labels)),
                             float(value)))
        # Deployment-wide half: every replica's last
        # piggybacked snapshot, labeled replica=<name> — one relation
        # covers the cluster, like the merged /metrics scrape.
        with coord.controller._lock:
            remote = dict(coord.controller.replica_metrics)
        for rep in sorted(remote):
            for _fam, _kind, _help, samples in remote[rep]:
                for sname, labels, value in samples:
                    rows.append(
                        (
                            _enc(full_name(
                                sname, {**labels, "replica": rep}
                            )),
                            float(value),
                        )
                    )
        return rows
    if name == "mz_trace_spans":
        from ..utils.trace import TRACER

        # Hot read path: the ring holds up to 4096 spans and every
        # snapshot re-renders all of them, ~15x the cost of listing
        # the ring. A completed SpanRecord is immutable, so cache the
        # rendered row on the record — stamped with the dict epoch,
        # since a rebalance relabels the three string codes.
        epoch = GLOBAL_DICT.epoch
        enc = GLOBAL_DICT.encode
        rows = []
        append = rows.append
        for r in TRACER.records():
            cached = r.__dict__.get("_row")
            if cached is not None and cached[0] == epoch:
                append(cached[1])
                continue
            row = (
                r.trace_id,
                r.span_id,
                r.parent_id or 0,
                enc(r.process),
                enc(r.name),
                enc(r.level),
                int(r.start * 1e6),
                int(r.duration * 1e6),
            )
            r._row = (epoch, row)
            append(row)
        return rows
    if name == "mz_slow_statements":
        return [
            (_enc(s["sql"]), float(s["ms"]), int(s["trace_id"]))
            for s in list(coord.slow_statements)
        ]
    if name == "mz_cluster_replicas":
        return [
            (
                _enc(s["name"]),
                int(s["connected"]),
                _enc(s["state"]),
                int(s["routed"]),
            )
            for s in coord.controller.replica_states()
        ]
    if name == "mz_autoscale_events":
        from .autoscaler import AUTOSCALE

        return [
            (
                float(at),
                _enc(action),
                _enc(replica),
                _enc(reason),
                _enc(evidence),
            )
            for at, action, replica, reason, evidence
            in AUTOSCALE.rows()
        ]
    if name == "mz_wallclock_lag_history":
        from .freshness import FRESHNESS

        return [
            (_enc(df), _enc(rep), int(frontier), float(lag),
             float(at))
            for df, rep, frontier, lag, at in FRESHNESS.history_rows()
        ]
    if name == "mz_wallclock_lag_summary":
        from .freshness import FRESHNESS

        return [
            (
                _enc(df),
                _enc(rep),
                int(s["samples"]),
                float(s["p50_ms"]),
                float(s["p90_ms"]),
                float(s["p99_ms"]),
                float(s["max_ms"]),
            )
            for (df, rep), s in sorted(FRESHNESS.summary().items())
        ]
    if name == "mz_hydration_statuses":
        return [
            (_enc(df), _enc(rep), _enc(status), float(since),
             int(attempts), _enc(error))
            for df, rep, status, since, attempts, error
            in coord.controller.hydration_snapshot()
        ]
    if name == "mz_source_statuses":
        return [
            (
                _enc(n),
                _enc(type(src.adapter).__name__),
                _enc(getattr(src, "status", "running")),
                src.t,
                float(getattr(src, "status_at", 0.0)),
                _enc(getattr(src, "last_error", "")),
            )
            for n, src in sorted(coord.sources.items())
        ]
    if name == "mz_sink_statuses":
        # Persist-sink progress, derived: a sinked (materialized-view)
        # dataflow is `running` on a replica once its reported frontier
        # advanced, `stalled` when the hydration board says so, and
        # `starting` before either.
        sinks = {
            it.name: it.definition["shard"]
            for it in coord.catalog.items.values()
            if it.kind == "materialized-view"
        }
        with coord.controller._lock:
            fsnap = {
                df: dict(per)
                for df, per in coord.controller.frontiers.items()
                if df in sinks
            }
        board = {
            (df, rep): (status, error)
            for df, rep, status, _since, _att, error
            in coord.controller.hydration_snapshot()
            if df in sinks
        }
        rows = []
        for df, shard in sorted(sinks.items()):
            replicas = set(fsnap.get(df, {})) | {
                rep for (d, rep) in board if d == df
            }
            for rep in sorted(replicas) or [""]:
                status, error = board.get((df, rep), ("", ""))
                frontier = fsnap.get(df, {}).get(rep, 0)
                if status != "stalled":
                    status = "running" if frontier > 0 else "starting"
                    error = ""
                rows.append(
                    (_enc(df), _enc(shard), _enc(rep), _enc(status),
                     int(frontier), _enc(error))
                )
        return rows
    if name == "mz_freshness_events":
        from .freshness import FRESHNESS

        return [
            (_enc(obj), _enc(rep), _enc(kind), float(lag), float(at))
            for obj, rep, kind, lag, at in FRESHNESS.events_rows()
        ]
    raise KeyError(name)
