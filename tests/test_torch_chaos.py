"""Port parity for the chaos harness (``materialize_tpu_torch/testing/chaos.py``).

- ``seeded_fault_plan``, ``trace_seed`` and ``fault_plan_from_trace``
  equal the reference's over seeds, tick counts and a trace dict.
- The non-slow cases of ``tests/test_chaos.py`` run through the port's
  harness and coordinator, replicas on the CPU: the two in-process
  storms, the coordinator restart over a surviving replica, the peek
  shed and the compactor smoke. Each storm's oracle equals the
  reference's ``expected_sums()`` for the same seed (the reference's
  storm runs too).
- The subprocess storms (a replica SIGKILL, the failover storms, an
  environmentd kill -9) are ported with the ``slow`` mark the reference
  gives them; their replica processes run with ``--device cpu``.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time as _time
import urllib.request

import pytest

from tests.torch_dict import reference_dict_restored  # noqa: F401
from tests.torch_serving import deadline, mod, one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def chaos(pkg: str):
    return mod(pkg, "testing.chaos")


# -- fault plans --------------------------------------------------------------

TRACE = {
    "model": "ctp",
    "kind": "lost_write",
    "steps": [
        {"task": "writer"},
        {"task": "replica", "chaos": ["partition", 3]},
        {"task": "controller", "chaos": "kill_conns"},
        {"task": "writer"},
        {"task": "replica", "chaos": "ddl"},
    ],
    "crash_after": 3,
}


@pytest.mark.parametrize("seed,ticks,kw", [
    (0, 60, {}),
    (3, 30, {}),
    (11, 30, {"replica_kills": 1}),
    (7, 8, {"conn_kills": 5, "partitions": 2, "ddls": 3}),
    (12345, 4, {"replica_kills": 2}),
])
def test_seeded_fault_plan_equals_the_reference(seed, ticks, kw):
    ref = chaos("ref").seeded_fault_plan(seed, ticks, **kw)
    port = chaos("port").seeded_fault_plan(seed, ticks, **kw)
    assert port == ref and ref


@pytest.mark.parametrize("trace", [
    TRACE,
    {"schedule": ["a", "b", "a"], "steps": []},
    {"steps": [{"task": "x"}, {"task": "y", "chaos": "kill_conns"}]},
    # JSON round trip: tuples arrive as lists.
    json.loads(json.dumps(TRACE)),
])
@pytest.mark.parametrize("ticks", [6, 30, 60])
def test_trace_replay_plans_equal_the_reference(trace, ticks):
    ref, port = chaos("ref"), chaos("port")
    assert port.trace_seed(trace) == ref.trace_seed(trace)
    assert port.fault_plan_from_trace(trace, ticks) == ref.fault_plan_from_trace(trace, ticks)


# -- the in-process storms ----------------------------------------------------

STORMS = {
    "blob_faults_and_conn_kills": dict(seed=3, ticks=30, blob_fail_every=11),
    "frame_kills_different_seed": dict(
        seed=11, ticks=30, blob_fail_every=7, proxy_kill_every=20),
}


@pytest.fixture(scope="module")
def storms(tmp_path_factory):
    """Each storm through both packages (the port's replica on the CPU)."""
    out = {}
    for name, kw in STORMS.items():
        root = tmp_path_factory.mktemp(name)
        out[name] = {
            "ref": chaos("ref").run_chaos(str(root / "ref"), **kw),
            "port": chaos("port").run_chaos(str(root / "port"), device="cpu", **kw),
        }
    return out


def test_storm_blob_faults_and_conn_kills(storms):
    rep = storms["blob_faults_and_conn_kills"]["port"]
    assert rep.ok, rep.failures
    # The seeded plan injected real faults and the link recovered.
    assert rep.conn_kills >= 1 and rep.partitions >= 1
    assert rep.recovery["replicas"]["r0"]["reconnects"] >= 1
    # Counted reconciliation: the description never changed.
    v = rep.recovery["dataflows"]["mv_sums"]["r0"]
    assert v["rebuilds"] == 0
    assert v["reconciles"] >= 1


def test_storm_frame_kills_different_seed(storms):
    rep = storms["frame_kills_different_seed"]["port"]
    assert rep.ok, rep.failures
    assert rep.retractions > 0 and rep.late > 0  # real storm


@pytest.mark.parametrize("name", sorted(STORMS))
def test_storm_oracle_equals_the_reference(storms, name):
    ref, port = storms[name]["ref"], storms[name]["port"]
    assert ref.ok, ref.failures
    assert port.oracle == ref.oracle and port.oracle
    assert port.result == port.sink == ref.result
    counts = ("ops", "inserts", "retractions", "late", "acked_times",
              "partitions", "conn_kills")
    assert {c: getattr(port, c) for c in counts} == {c: getattr(ref, c) for c in counts}


# -- restart recovery ---------------------------------------------------------


def _start_replica(tmp_path, rid="r0"):
    port = chaos("port")._free_port()
    loc = mod("port", "coord.protocol").PersistLocation(
        str(tmp_path / "blob"), str(tmp_path / "consensus.db"))
    ready = threading.Event()
    threading.Thread(
        target=mod("port", "coord.replica").serve_forever,
        args=(port, loc, rid, ready), kwargs={"device": "cpu"}, daemon=True,
    ).start()
    assert ready.wait(10)
    return port, loc


def _mk_coord(tmp_path):
    persist = mod("port", "storage.persist")
    return mod("port", "coord.coordinator").Coordinator(
        persist.PersistClient(
            persist.FileBlob(str(tmp_path / "blob")),
            persist.SqliteConsensus(str(tmp_path / "consensus.db")),
        ),
        tick_interval=None,
        device="cpu",
    )


def test_coordinator_restart_surviving_replica(tmp_path):
    configs = mod("port", "utils.dyncfg").COMPUTE_CONFIGS
    port, _loc = _start_replica(tmp_path)
    coord = _mk_coord(tmp_path)
    coord.add_replica("r0", ("127.0.0.1", port))
    coord2 = None
    try:
        coord.execute("CREATE TABLE kv (k bigint NOT NULL, v bigint NOT NULL)")
        coord.execute("INSERT INTO kv VALUES (1, 10), (2, 20), (1, 5)")
        coord.execute(
            "CREATE MATERIALIZED VIEW sums AS SELECT k, sum(v) AS s FROM kv GROUP BY k")
        # A durable dyncfg override: must replay on the next boot.
        coord.execute("SET span_max_ticks = 4")
        coord.execute("DELETE FROM kv WHERE k = 2")
        coord.execute("INSERT INTO kv VALUES (2, 7)")
        expect = coord.execute("SELECT k, s FROM sums ORDER BY k").rows
        assert expect == [(1, 15), (2, 7)]
        # "Crash" the control plane; the replica thread survives.
        coord.shutdown()
        configs.update({"span_max_ticks": None})
        coord2 = _mk_coord(tmp_path)
        assert coord2.recovery["catalog_replayed"] >= 3
        assert coord2.recovery["dyncfg_replayed"] >= 1
        assert coord2.recovery["replay_failures"] == 0
        assert float(configs.get("span_max_ticks")) == 4
        names = {it.name for it in coord2.catalog.items.values()}
        assert {"kv", "sums"} <= names
        coord2.add_replica("r0", ("127.0.0.1", port))
        assert coord2.execute("SELECT k, s FROM sums ORDER BY k").rows == expect
        # The surviving replica kept the unchanged dataflow.
        deadline_at = _time.monotonic() + 30
        while True:
            snap = coord2.controller.recovery_snapshot()
            per = snap["dataflows"].get("sums", {}).get("r0")
            if per is not None and per["reconciles"] >= 1:
                break
            assert _time.monotonic() < deadline_at, snap
            _time.sleep(0.01)
        assert per["rebuilds"] == 0, per
        assert snap["replicas"]["r0"]["fenced"] >= 1
        res = coord2.execute(
            "SELECT object, value FROM mz_recovery "
            "WHERE scope = 'dataflow' AND metric = 'rebuilds'")
        assert ("sums", 0.0) in res.rows
        txt = coord2.execute("EXPLAIN ANALYSIS FOR SELECT k FROM kv").text
        assert "recovery:" in txt and "catalog_replayed=" in txt
    finally:
        configs.update({"span_max_ticks": None})
        (coord2 or coord).shutdown()


# -- the peek shed ------------------------------------------------------------


def test_peek_timeout_retryable_and_lock_clean(tmp_path):
    configs = mod("port", "utils.dyncfg").COMPUTE_CONFIGS
    coord = _mk_coord(tmp_path)  # deliberately no replicas
    try:
        coord.execute("CREATE TABLE t (a bigint NOT NULL)")
        coord.execute("INSERT INTO t VALUES (1)")
        coord.execute("CREATE MATERIALIZED VIEW m AS SELECT a FROM t")
        coord.execute("SET retry_policy_peek = 'budget=300ms'")
        with pytest.raises(mod("port", "coord.peek").ServerBusy) as exc:
            coord.execute("SELECT a FROM m")
        assert "retry" in str(exc.value)
        assert mod("port", "server.pgwire")._error_code(exc.value) == "53400"
        # The sequencing lock is not poisoned.
        assert coord.execute("SHOW retry_policy_peek").rows
        coord.execute("INSERT INTO t VALUES (2)")
        assert coord.execute("SELECT name FROM mz_cluster_replicas").rows == []
    finally:
        configs.update({"retry_policy_peek": None})
        coord.shutdown()


def test_batched_lookup_timeout_is_retryable():
    timed_out = mod("port", "coord.peek").PeekTimedOut
    ctl = mod("port", "coord.controller").ComputeController()
    try:
        with pytest.raises(timed_out):
            ctl.peek_lookup("nope", (0,), False, (1,), 0, timeout=0.2)
        with pytest.raises(timed_out):
            ctl.peek("nope", as_of=0, timeout=0.2)
    finally:
        ctl.shutdown()
    # The shutdown wakes the batch's resolver, which would otherwise wait
    # out its own timeout and hold the interpreter's exit.
    deadline_at = _time.monotonic() + 10
    while ctl._peek_events:
        assert _time.monotonic() < deadline_at, "a batched peek still waits"
        _time.sleep(0.01)


# -- the compactor storm ------------------------------------------------------


def test_compactor_smoke(tmp_path):
    rep = chaos("port").run_compactor_smoke(str(tmp_path / "cs"), seed=1)
    assert rep.ok, rep.failures
    assert rep.crashes == 1
    assert rep.crash_residue_holder == "chaos-compactor-a"
    assert rep.handoffs == 1
    assert rep.handoff_epoch >= 2
    assert rep.fenced_swaps == 1
    assert rep.reader_races >= 1
    assert rep.reader_reads >= 1
    assert rep.merges_inline == 0
    assert rep.blob_writes_inline == 0
    assert rep.merges_background >= 1
    assert rep.requests >= 1


@pytest.mark.slow
def test_compactor_storm_long(tmp_path):
    rep = chaos("port").run_compactor_storm(
        str(tmp_path / "cst"), seed=7, ticks=48, blob_fail_every=7)
    assert rep.ok, rep.failures
    assert rep.crashes == 1 and rep.handoffs == 1
    assert rep.merges_inline == 0 and rep.blob_writes_inline == 0
    assert rep.final_batches >= 0


# -- the subprocess storms (slow, as in the reference) -------------------------


@pytest.mark.slow
def test_sigkill_midspan_storm(tmp_path):
    c = chaos("port")
    if not c.subprocess_available():
        pytest.skip("subprocess spawning unavailable")
    rep = c.run_chaos(
        str(tmp_path / "storm"), seed=7, ticks=30, blob_fail_every=9,
        proxy_kill_every=25, subprocess_replica=True, replica_kills=1,
        verify_timeout=480.0, device="cpu",
    )
    assert rep.ok, rep.failures
    assert rep.replica_kills == 1
    assert rep.recovery["dataflows"]["mv_sums"]["r0"]["rebuilds"] == 0


@pytest.mark.slow
def test_smoke_two_replicas_in_process(tmp_path):
    rep = chaos("port").run_failover_smoke(str(tmp_path / "fo"), seed=1, device="cpu")
    assert rep.ok, rep.failures
    assert rep.kills == 1
    assert rep.routed_before in rep.killed
    assert rep.routed_after not in rep.killed
    assert rep.failovers >= 1
    assert rep.retried_statements <= 1
    assert rep.reader_queries >= 1


@pytest.mark.slow
def test_sigkill_routed_replica_mid_peek_n3(tmp_path):
    c = chaos("port")
    if not c.subprocess_available():
        pytest.skip("subprocess spawning unavailable")
    rep = c.run_failover_storm(
        str(tmp_path / "fo3"), seed=7, ticks=16, replicas=3,
        subprocess_replicas=True, verify_timeout=480.0, device="cpu",
    )
    assert rep.ok, rep.failures
    assert rep.replicas == 3 and rep.kills == 1
    assert rep.routed_before in rep.killed
    assert rep.routed_after not in rep.killed
    assert rep.failovers >= 1
    assert rep.retried_statements <= 1
    assert rep.route_changes >= 1


def _http_sql(port: int, sql: str):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/api/sql",
        data=json.dumps({"query": sql}).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=190) as r:
        out = json.loads(r.read())
    for res in out.get("results", []):
        if isinstance(res, dict) and res.get("error"):
            raise RuntimeError(res["error"])
    return out["results"][-1].get("rows", [])


def _read_until(proc, needle: str, timeout: float = 300.0) -> str:
    deadline_at = _time.monotonic() + timeout
    lines = []
    while _time.monotonic() < deadline_at:
        line = proc.stdout.readline()
        if not line:
            rc = proc.poll()
            if rc is not None:
                raise AssertionError(
                    f"environmentd exited rc={rc} before {needle!r}: " + "".join(lines[-20:]))
            _time.sleep(0.05)
            continue
        lines.append(line)
        if needle in line:
            return line
    raise AssertionError(f"timed out waiting for {needle!r}: " + "".join(lines[-20:]))


# environmentd's own line: its replica processes print theirs to the same
# stdout ("replica r0 listening on ...").
LISTENING = "materialize_tpu_torch listening"


def _spawn_environmentd(data_dir: str, pg: int, hp: int, extra=()):
    return subprocess.Popen(
        [sys.executable, "-m", "materialize_tpu_torch.server.environmentd",
         "--data-dir", data_dir, "--pg-port", str(pg), "--http-port", str(hp),
         "--replicas", "1", "--tick-interval", "0.5", "--device", "cpu", *extra],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )


@pytest.mark.slow
def test_kill9_mid_ingest_then_recover(tmp_path):
    c = chaos("port")
    if not c.subprocess_available():
        pytest.skip("subprocess spawning unavailable")
    data = str(tmp_path / "envd")
    pg1, hp1 = c._free_port(), c._free_port()
    p = _spawn_environmentd(data, pg1, hp1)
    p2 = None
    orphans: list = []
    try:
        _read_until(p, LISTENING)
        _http_sql(hp1, "CREATE TABLE kv (k bigint NOT NULL, v bigint NOT NULL)")
        _http_sql(hp1, "CREATE MATERIALIZED VIEW sums AS SELECT k, sum(v) AS s FROM kv GROUP BY k")
        acked: list = []
        inflight = [None]
        stop = threading.Event()

        def writer():
            i = 0
            while not stop.is_set():
                i += 1
                inflight[0] = i
                try:
                    _http_sql(hp1, f"INSERT INTO kv VALUES ({i % 4}, {i})")
                except Exception:
                    return
                acked.append(i)
                inflight[0] = None

        t = threading.Thread(target=writer, daemon=True)
        t.start()
        deadline_at = _time.monotonic() + 120
        while len(acked) < 10:
            assert _time.monotonic() < deadline_at, acked
            _time.sleep(0.05)
        orphans = _children(p.pid)
        os.kill(p.pid, signal.SIGKILL)
        p.wait()
        stop.set()
        t.join(30)
        maybe_inflight = inflight[0]
        acked_set = set(acked)
        pg2, hp2 = c._free_port(), c._free_port()
        p2 = _spawn_environmentd(data, pg2, hp2, extra=("--recover",))
        line = _read_until(p2, "recovery: ")
        report = json.loads(line.split("recovery: ", 1)[1])
        assert report["coordinator"]["catalog_replayed"] >= 2
        assert report["coordinator"]["replay_failures"] == 0
        _read_until(p2, LISTENING)
        assert {"kv", "sums"} <= {r[0] for r in _http_sql(hp2, "SHOW OBJECTS")}
        rows = _http_sql(hp2, "SELECT k, v FROM kv")
        got = {int(r[1]) for r in rows}
        assert acked_set <= got, sorted(acked_set - got)
        assert got - acked_set <= {maybe_inflight}
        expect_sums: dict = {}
        for r in rows:
            expect_sums[int(r[0])] = expect_sums.get(int(r[0]), 0) + int(r[1])
        got_sums = {int(r[0]): int(r[1]) for r in _http_sql(hp2, "SELECT k, s FROM sums")}
        assert got_sums == expect_sums
        _http_sql(hp2, "INSERT INTO kv VALUES (9, 999999)")
        assert any(int(r[0]) >= 999999 for r in _http_sql(hp2, "SELECT s FROM sums WHERE k = 9"))
    finally:
        for proc in (p, p2):
            if proc is None:
                continue
            if proc.poll() is None:
                orphans += _children(proc.pid)
            try:
                proc.kill()
                proc.wait(timeout=30)
            except Exception:
                pass
        # A killed environmentd's replica process outlives it.
        for pid in orphans:
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass


def _children(pid: int) -> list:
    out = []
    for task in os.listdir(f"/proc/{pid}/task"):
        with open(f"/proc/{pid}/task/{task}/children") as f:
            out += [int(c) for c in f.read().split()]
    return out
