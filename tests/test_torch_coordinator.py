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
  but its default. The pieces ported since answer: ``mz_span_epochs``,
  ``mz_compile_log`` (the native library's build and load), EXPLAIN
  ANALYSIS, ``mz_donation``, ``mz_sharding``, ``mz_program_bank``, the
  span, plan and analysis flags and the program bank's; a replica of two workers whose mesh cannot be placed
  (NCCL on the CPU) fails its boot.
"""

from __future__ import annotations

import os

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
        # Every introspection relation is ported: the program bank's too
        # (item 16), which answers with no bank configured.
        assert c.execute("SELECT * FROM mz_program_bank").rows == []
        cases = {}
        # Kafka sources and sinks are ported (item 16): their options are
        # validated before the durable record, as the reference's are
        # (a poison record would fail every later boot).
        broker = tmp_path / "broker"
        mod("port", "storage.kafka.broker").FileBroker(str(broker)).create_topic("t2")
        for sql, msg in (
            (f"CREATE SINK s FROM st INTO KAFKA (BROKER '{broker}', TOPIC 't', "
             "FORMAT 'protobuf')", "unknown sink format"),
            ("CREATE SINK s FROM st INTO KAFKA (TOPIC 't')", "require BROKER and TOPIC"),
            (f"CREATE SINK s FROM nope INTO KAFKA (BROKER '{broker}', TOPIC 't')",
             "unknown relation"),
            (f"CREATE SOURCE k (a bigint) FROM KAFKA (BROKER '{broker}', TOPIC 't')",
             "unknown topic"),
            ("CREATE SOURCE k (a bigint) FROM KAFKA (TOPIC 't')", "requires BROKER"),
            (f"CREATE SOURCE k (a bigint) FROM KAFKA (BROKER '{broker}', TOPIC 't2', "
             "ENVELOPE 'bogus')", "unknown envelope"),
            (f"CREATE SOURCE k (a bigint) FROM KAFKA (BROKER '{broker}', TOPIC 't2', "
             "FORMAT 'avro')", "schema registry"),
        ):
            with pytest.raises(plan_error, match=msg):
                c.execute(sql)
        assert not any(rec.get("name") in ("s", "k") for rec in c._catalog_live_records())
        # Flags the port registers but does not read: the default is
        # accepted, any other value raises naming where the reader waits.
        unported = {
            "fused_merge": ("'lax'", "Queue 3"),
            "cached_run_lanes": ("false", "Queue 3"),
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
        # The rest of the introspection relations answer, those ported
        # since included: the view's committed span epochs and the
        # native library's load in this process.
        assert c.execute("SELECT name FROM mz_objects WHERE name = 'st'").rows == [("st",)]
        c.execute("CREATE MATERIALIZED VIEW stv AS SELECT v FROM st")
        c.execute("INSERT INTO st VALUES (1)")
        assert c.execute("SELECT * FROM stv").rows == [(1,)]
        epochs = c.execute("SELECT dataflow, replica, span_epoch FROM mz_span_epochs").rows
        assert [(d, r) for d, r, _e in epochs if d == "stv"] == [("stv", "r0")]
        assert "Reduce Accumulable group=[0]" in c.execute(
            "EXPLAIN PHYSICAL PLAN FOR SELECT v, count(*) FROM st GROUP BY v").text
        # EXPLAIN ANALYSIS, mz_donation and mz_sharding answer (item 14).
        text = c.execute("EXPLAIN ANALYSIS SELECT * FROM stv").text
        assert text.startswith("typecheck: ok") and "stv@r0: safe=true" in text
        assert "stv@r0: spmd=false workers=1" in text
        assert c.execute(
            "SELECT wired FROM mz_donation WHERE dataflow = 'stv'").rows == [(0,)]
        assert c.execute(
            "SELECT spmd, workers FROM mz_sharding WHERE dataflow = 'stv'").rows == [(0, 1)]
        # The span, plan and analysis flags have their readers: any value
        # is taken.
        bank_dir = tmp_path / "bank"
        for sql in ("SET span_window_spans = 4", "SET span_donation = 'on'",
                    "SET delta_join_min_inputs = 2", "SET arrangement_ingest_mode = 'merge'",
                    "SET optimizer_typecheck = true", "SET buffer_sanitizer = true",
                    "SET race_detector = true", f"SET program_bank_path = '{bank_dir}'",
                    "SET enable_async_compile = true"):
            c.execute(sql)
        assert dyncfg.SPAN_WINDOW_SPANS(dyncfg.COMPUTE_CONFIGS) == 4
        assert dyncfg.DELTA_JOIN_MIN_INPUTS(dyncfg.COMPUTE_CONFIGS) == 2
        # The program bank's path has its reader (item 16): this process
        # points its bank there.
        assert mod("port", "compile.bank").get_bank().root == str(bank_dir)
        c.execute("SET program_bank_path = ''")
        assert mod("port", "compile.bank").get_bank() is None
        for name in unported:
            default = configs[name].default
            literal = f"'{default}'" if isinstance(default, str) else str(default).lower()
            c.execute(f"SET {name} = {literal}")
        assert {n: dyncfg.COMPUTE_CONFIGS.get(n) for n in unported} == {
            n: configs[n].default for n in unported}
    finally:
        cl.shutdown()
        mod("port", "utils.dyncfg").COMPUTE_CONFIGS.update({
            n: None for n in ("span_window_spans", "span_donation",
                              "delta_join_min_inputs", "arrangement_ingest_mode",
                              "optimizer_typecheck", "buffer_sanitizer", "race_detector",
                              "program_bank_path", "enable_async_compile")})
        mod("port", "compile.bank").configure_bank(None)
    replica = mod("port", "coord.replica")
    protocol = mod("port", "coord.protocol")
    loc = protocol.PersistLocation(str(tmp_path / "b2"), str(tmp_path / "c2.db"))
    # SPMD replicas are ported (item 8; ``test_torch_spmd_replica.py``
    # serves with two ranks): a mesh the replica cannot place fails its
    # boot before it starts a follower.
    with pytest.raises(ValueError, match="gloo"):
        replica.ReplicaWorker(location=loc, workers=2, device="cpu", spmd_backend="nccl")
    replica.ReplicaWorker(location=loc, device="cpu").stop()
    sources = mod("port", "coord.sources")
    with pytest.raises(ValueError, match="declared columns"):
        sources.KafkaAdapter({})
    sch = mod("port", "repr.schema")
    kv = sch.Schema([sch.Column("k", sch.ColumnType.INT64)])
    df = mod("port", "render.dataflow")
    rel = mod("port", "expr.relation")
    d = df.Dataflow(rel.Get("s", kv), device="cpu")
    # The collection aggregates are ported (item 15): a dataflow without
    # one has nothing to capture or finalize.
    assert d.capture_basic_multisets() == {}
    assert d.finalize_basic_columns([], []) == []


def test_compile_log_records_the_native_library_build_and_load(tmp_path, monkeypatch):
    """``mz_compile_log`` lists the port's native library builds: a g++
    build into an empty build directory is a ``miss``, the next process's
    load of that build a ``hit``, both with the source's fingerprint."""
    native = mod("port", "native")
    ledger = mod("port", "utils.compile_ledger").LEDGER
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    n0 = len(ledger.records())
    native.lib()  # builds
    monkeypatch.setattr(native, "_lib", None)
    native.lib()  # loads the build
    recs = ledger.records()[n0:]
    assert [(r.kind, r.name, r.cache) for r in recs] == [
        ("g++", "mtnative.cpp", "miss"), ("g++", "mtnative.cpp", "hit")]
    assert recs[0].fingerprint == recs[1].fingerprint
    assert (tmp_path / "build" / f"libmtnative-{recs[0].fingerprint}.so").exists()
    assert recs[0].seconds > recs[1].seconds > 0
    cl = Cluster("port", str(tmp_path / "cl"))
    try:
        c = cl.coordinator()
        rows = c.execute("SELECT process, kind, dataflow, fingerprint, cache FROM mz_compile_log").rows
    finally:
        cl.shutdown()
    me = f"pid{os.getpid()}"
    for r in recs:
        assert (me, r.kind, r.name, r.fingerprint, r.cache) in rows
