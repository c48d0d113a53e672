"""Port parity for the serving stack: the coordinator, the controller,
the replica and the sources, statement by statement against the
reference.

- One SQL script runs through a reference cluster and a port cluster
  (``tests/torch_serving.Cluster``: an in-process replica, a persist
  location and a coordinator; the port's replica runs on the CPU).
  Every statement's kind, sorted rows and error (type and text) must be
  equal. This file's script covers the table path (a join and an
  aggregate over two tables, DELETE, UPDATE, a slow-path SELECT), the
  counter generator with ticks, DROP, planning errors and the
  ``enable_temporal_filters`` gate;
  ``tests/test_torch_serve_tpch.py`` runs the TPC-H one.
- The port's coordinator boots (``_bootstrap``) from the data directory
  the reference's coordinator wrote, and answers the same SELECTs.
- With ``span_pipelining`` on, the port's replica steps in spans, and a
  state tier that overflows inside a span still leaves the sink shard
  with each delta once.
- Every unported piece the slice reaches raises, naming its ROADMAP item;
  so does a SET of a registered flag the port does not read, to any value
  but its default.
"""

from __future__ import annotations

import numpy as np
import pytest

from tests.oracle import as_multiset
from tests.torch_serving import (  # noqa: F401
    Cluster, boot_and_read, deadline, mod, one_torch_thread, run_script,
)

# ("tick", source, n) advances a generator source n ticks by hand.
SCRIPT = [
    "CREATE TABLE t (a bigint NOT NULL, b text, c numeric(10,2), d date)",
    "INSERT INTO t VALUES (1, 'x', 1.50, DATE '2024-01-02'), (2, 'y', NULL, NULL), "
    "(3, NULL, 2.25, DATE '1999-12-31'), (4, 'x', 0.01, DATE '1970-01-01')",
    "CREATE TABLE u (a bigint NOT NULL, w text NOT NULL)",
    "INSERT INTO u VALUES (1, 'one'), (3, 'three'), (4, 'four'), (4, 'quatre')",
    "CREATE MATERIALIZED VIEW tj AS SELECT t.b, count(*) AS n, sum(t.c) AS sc, "
    "max(u.w) AS mw FROM t JOIN u ON t.a = u.a GROUP BY t.b",
    "SELECT * FROM tj",
    "DELETE FROM t WHERE a = 1",
    "UPDATE t SET a = a + 10, b = 'z' WHERE b IS NULL",
    "INSERT INTO u VALUES (13, 'thirteen')",
    "SELECT * FROM tj",
    "SELECT * FROM t",
    "CREATE SOURCE cnt FROM LOAD GENERATOR counter",
    "CREATE MATERIALIZED VIEW totals AS SELECT count(*) AS n, sum(counter) AS s FROM counter",
    ("tick", "cnt", 3),
    "SELECT * FROM totals",
    "SHOW VIEWS",
    "SHOW TABLES",
    "CREATE VIEW tv AS SELECT b FROM t",
    "DROP VIEW tv",
    "SELECT * FROM tv",
    "SELECT * FROM nope",
    "SELECT nope FROM t",
    "SELECT a FROM t WHERE b = 1 +",
    "INSERT INTO t VALUES ('not a number', 'x', 1.0, NULL)",
    "CREATE TABLE t (a bigint)",
    "DROP TABLE nope",
    # The temporal-filter gate: off, the install fails on the replica.
    "SET enable_temporal_filters = false",
    "CREATE MATERIALIZED VIEW tw AS SELECT a FROM t WHERE mz_now() <= a",
    "SET enable_temporal_filters = DEFAULT",
    "CREATE MATERIALIZED VIEW tw AS SELECT a FROM t WHERE mz_now() <= a",
    ("tick", "cnt", 2),
]

# What the port, booted from the reference's data directory, must answer
# as the reference did at the end of its script.
READS = ["SELECT * FROM tj", "SELECT * FROM totals", "SHOW OBJECTS"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    roots = {pkg: str(tmp_path_factory.mktemp(pkg)) for pkg in ("ref", "port")}
    return roots, {pkg: run_script(pkg, roots[pkg], SCRIPT, READS) for pkg in roots}


def test_script_statement_by_statement(runs):
    _roots, res = runs
    (ref, _), (port, _) = res["ref"], res["port"]
    assert len(ref) == len(port) == len(SCRIPT)
    for stmt, r, p in zip(SCRIPT, ref, port):
        assert p == r, stmt
    kinds = [o[0] for o in port]
    assert kinds.count("error") == 8
    assert "enable_temporal_filters" in port[SCRIPT.index("SET enable_temporal_filters = false") + 1][2]
    assert port[SCRIPT.index("SELECT * FROM tj")] != port[SCRIPT.index("SELECT * FROM tj", 6)]
    assert port[SCRIPT.index("SELECT * FROM totals")][1] == [(4, 6)]


def test_bootstrap_from_the_reference_data_directory(runs):
    """The port's coordinator boots from the catalog, tables, sources and
    sink shards the reference wrote, and answers as it did."""
    roots, res = runs
    recovery, got = boot_and_read(roots["ref"], READS)
    # Six objects and the SET that put the temporal-filter gate back.
    assert recovery["catalog_replayed"] == 7 and recovery["replay_failures"] == 0
    assert recovery["dyncfg_replayed"] == 1
    dyncfg = mod("port", "utils.dyncfg")
    assert dyncfg.ENABLE_TEMPORAL_FILTERS(dyncfg.COMPUTE_CONFIGS) is True
    assert got == res["ref"][1] == res["port"][1]
    assert got[1][1] == [(6, 15)]


def test_span_stepping_replica_overflow_keeps_the_sink_exact(tmp_path):
    """The port's replica with ``span_pipelining`` on steps each view in
    spans (``MaintainedView.step_span``). A GROUP BY whose groups outgrow
    its state tier (256 rows) overflows inside a span, which rolls back,
    grows and replays; the MV's sink shard must hold every group once,
    at its final count."""
    cl = Cluster("port", str(tmp_path))
    try:
        c = cl.coordinator()
        c.execute("SET span_pipelining = 'true'")
        c.execute("CREATE TABLE k (a bigint NOT NULL)")
        c.execute("CREATE MATERIALIZED VIEW g AS SELECT a, count(*) AS n FROM k GROUP BY a")
        want: dict = {}
        for keys in (range(40), range(1000, 1400), range(1000, 1400, 7), range(20)):
            c.execute("INSERT INTO k VALUES " + ", ".join(f"({a})" for a in keys))
            for a in keys:
                want[a] = want.get(a, 0) + 1
        assert sorted(c.execute("SELECT * FROM g").rows) == sorted(want.items())
        inst = cl._handle[0].dataflows["g"]
        assert inst.view.df._grown, "the state tier should have overflowed"
        persist = mod("port", "storage.persist")
        client = persist.PersistClient(persist.FileBlob(cl.loc.blob_root),
                                       persist.SqliteConsensus(cl.loc.consensus_path))
        reader = client.open_reader(c.catalog.items["g"].definition["shard"])
        try:
            _sch, cols, _n, time_, diff = reader.snapshot(reader.upper - 1)
        finally:
            reader.expire()
        sink = as_multiset(list(zip(cols[0].tolist(), cols[1].tolist(),
                                    time_.tolist(), diff.tolist())))
        assert sink == {(a, n): 1 for a, n in want.items()}
    finally:
        cl.shutdown()
        mod("port", "utils.dyncfg").COMPUTE_CONFIGS.update({"span_pipelining": None})


def test_unported_pieces_raise_naming_their_item(tmp_path):
    cl = Cluster("port", str(tmp_path))
    try:
        c = cl.coordinator()
        c.execute("CREATE TABLE st (v bigint NOT NULL)")
        plan_error = mod("port", "sql.hir").PlanError
        cases = {
            "SUBSCRIBE st": (NotImplementedError, "item 6b: coord/subscribe.py"),
            "SELECT * FROM mz_objects": (NotImplementedError, "item 6b: coord/introspection.py"),
            "EXPLAIN ANALYSIS SELECT * FROM st": (NotImplementedError, "item"),
            "CREATE SINK s FROM st INTO KAFKA (BROKER 'b', TOPIC 't')": (
                NotImplementedError, "item 16"),
            # Source options are validated at CREATE time: the adapter's
            # raise reaches the session as a planning error.
            "CREATE SOURCE k (a bigint) FROM KAFKA (BROKER 'b', TOPIC 't')": (
                plan_error, "item 16"),
        }
        # Flags the port registers but does not read: the default is
        # accepted, any other value raises naming where the reader waits.
        unported = {
            "delta_join_min_inputs": ("2", "item 13"),
            "arrangement_ingest_mode": ("'merge'", "item 13"),
            "compaction_lease_s": ("1.0", "item 6b: storage/persist/compactor.py"),
            "optimizer_typecheck": ("true", "item 14"),
            "buffer_sanitizer": ("true", "item 14"),
            "race_detector": ("true", "item 14"),
            "fused_merge": ("'lax'", "Queue 3"),
            "cached_run_lanes": ("false", "Queue 3"),
            "span_window_spans": ("4", "item 6b: render/span_exec.py"),
            "span_donation": ("'on'", "item 6b: render/span_exec.py"),
            "program_bank_path": ("'/x'", "Queue 2 item 6"),
            "enable_async_compile": ("true", "Queue 2 item 6"),
            "subscribe_max_sessions": ("10", "item 6b: coord/subscribe.py"),
            "subscribe_queue_depth": ("10", "item 6b: coord/subscribe.py"),
            "subscribe_slow_policy": ("'coalesce'", "item 6b: coord/subscribe.py"),
            "subscribe_tail_poll_ms": ("5", "item 6b: coord/subscribe.py"),
            "metrics_report_ms": ("10", "item 6b: ship_observability"),
            "freshness_slo_ms": ("100", "item 6b: coord/freshness.py"),
            "autoscale_policy": ("'min=1,max=2'", "item 6b: coord/autoscaler.py"),
        }
        dyncfg = mod("port", "utils.dyncfg")
        configs = dyncfg.COMPUTE_CONFIGS._configs
        assert {n for n, cfg in configs.items() if cfg.unported} == set(unported)
        for name, (value, item) in unported.items():
            cases[f"SET {name} = {value}"] = (NotImplementedError, item)
        for sql, (exc, item) in cases.items():
            with pytest.raises(exc, match=item):
                c.execute(sql)
        assert c.execute("SELECT * FROM st").kind == "rows"  # the session lives on
        for name in unported:
            default = configs[name].default
            literal = f"'{default}'" if isinstance(default, str) else str(default).lower()
            c.execute(f"SET {name} = {literal}")
        assert {n: dyncfg.COMPUTE_CONFIGS.get(n) for n in unported} == {
            n: configs[n].default for n in unported}
    finally:
        cl.shutdown()
    replica = mod("port", "coord.replica")
    protocol = mod("port", "coord.protocol")
    loc = protocol.PersistLocation(str(tmp_path / "b2"), str(tmp_path / "c2.db"))
    with pytest.raises(NotImplementedError, match="item 8"):
        replica.ReplicaWorker(location=loc, workers=2, device="cpu")
    with pytest.raises(NotImplementedError, match="item 6b"):
        replica.ReplicaWorker(location=loc, ship_observability=True, device="cpu")
    with pytest.raises(NotImplementedError, match="item 6b"):
        replica.main()
    w = replica.ReplicaWorker(location=loc, device="cpu")
    with pytest.raises(NotImplementedError, match="item 6b: expr/remap.py"):
        w._recover_dict_exhaustion(None)
    sources = mod("port", "coord.sources")
    with pytest.raises(NotImplementedError, match="item 16"):
        sources.KafkaAdapter({})
    persist = mod("port", "storage.persist")
    client = persist.PersistClient(persist.MemBlob(), persist.MemConsensus(),
                                   auto_compaction=True)
    sch = mod("port", "repr.schema")
    kv = sch.Schema([sch.Column("k", sch.ColumnType.INT64)])
    wr = client.open_writer("s", kv)
    with pytest.raises(NotImplementedError, match="item 6b"):
        for t in range(12):
            wr.compare_and_append([np.array([t], np.int64)], [None],
                                  np.array([t], np.uint64), np.ones(1, np.int64), t, t + 1)
    df = mod("port", "render.dataflow")
    rel = mod("port", "expr.relation")
    d = df.Dataflow(rel.Get("s", kv), device="cpu")
    with pytest.raises(NotImplementedError, match="item 15"):
        d.capture_basic_multisets()
    with pytest.raises(NotImplementedError, match="item 15"):
        d.finalize_basic_columns([], [])
