"""Port parity for the deployment: ``server/environmentd.py``,
``server/http.py``, SUBSCRIBE over pgwire and SSE.

- One ``Environment`` of each package (a module fixture: in-process
  replicas, the reference under JAX on the CPU, the port with
  ``device="cpu"``) takes the exchanges of ``tests/test_server.py``'s
  ``TestPgwire`` SUBSCRIBE cases (COPY-out, CopyFail, Terminate),
  ``TestHttp`` (``/api/sql``, ``/metrics``, ``/api/livez``,
  ``/api/readyz``, SSE), ``TestPeekParity`` and
  ``tests/test_failover.py``'s ``TestEnvironmentLifecycle`` (runtime
  add and drop, a rolling restart served throughout, a single replica's
  restart refused). Each exchange's transcript must be equal across the
  packages; timestamps inside SUBSCRIBE lines are not compared.
- The port's command, ``python -m materialize_tpu_torch.server.environmentd
  --device cpu``, runs with one subprocess replica: a SQL script over
  pgwire, HTTP and SSE answers as the reference's deployment answers the
  same script; the replica's shipped metrics reach ``/metrics``; then a
  boot with ``--recover`` on the same directory replays the catalog, and
  a subscription resumed at its last frontier gets exactly the updates
  after it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time as _time
import urllib.error
import urllib.parse
import urllib.request
from pathlib import Path

import pytest

from tests.torch_dict import reference_dict_restored  # noqa: F401
from tests.torch_serving import MiniPg, deadline, free_port, mod, one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
PKGS = ("ref", "port")


@pytest.fixture(scope="module")
def envs(tmp_path_factory):
    """{package: Environment} with one in-process replica each."""
    up = {}
    try:
        for pkg in PKGS:
            kw = {"device": "cpu"} if pkg == "port" else {}
            up[pkg] = mod(pkg, "server.environmentd").Environment(
                str(tmp_path_factory.mktemp(f"envd-{pkg}")), n_replicas=1,
                tick_interval=None, in_process_replicas=True, **kw)
        yield up
    finally:
        for e in up.values():
            e.shutdown()


def both(envs, exchange):
    out = {pkg: exchange(envs[pkg], pkg) for pkg in PKGS}
    assert out["port"] == out["ref"]
    return out["port"]


def _until(pred, timeout=30.0, msg="condition"):
    end = _time.monotonic() + timeout
    while _time.monotonic() < end:
        v = pred()
        if v:
            return v
        _time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


def _http(port: int, path: str, body=None):
    """(status, headers' content type, body bytes); errors included."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def _sql(port: int, sql: str):
    status, _ct, body = _http(port, "/api/sql", {"query": sql})
    return status, json.loads(body)


def _copy_lines(data: bytes) -> list:
    """A COPY-out chunk's lines with each line's time field left out."""
    out = []
    for line in data.decode().split("\n"):
        if line:
            f = line.split("\t")
            out.append("\t".join(["T"] + f[1:]))
    return out


def _start_subscribe(c: MiniPg, sql: str):
    c.send(b"Q", sql.encode() + b"\x00")
    return c.read_msg()


# -- pgwire SUBSCRIBE ---------------------------------------------------------------


def test_subscribe_copy_out(envs):
    def ex(env, pkg):
        c = MiniPg(env.pg.port)
        try:
            c.query("CREATE TABLE st (v bigint NOT NULL)")
            c.query("INSERT INTO st VALUES (7)")
            tag, _ = _start_subscribe(c, "SUBSCRIBE st")
            out = [tag]
            tag, data = c.read_msg()
            out += [tag, _copy_lines(data)]
            # A delta while streaming arrives as its own chunk.
            c2 = MiniPg(env.pg.port)
            c2.query("INSERT INTO st VALUES (8)")
            c2.close()
            tag, data = c.read_msg()
            out += [tag, _copy_lines(data)]
            return out
        finally:
            c.sock.close()  # drop mid-stream: the server cleans up

    out = both(envs, ex)
    assert out[0] == b"H" and out[2] == ["T\t0\tsnapshot", "T\t1\t7", "T\t0\tprogress"]
    assert out[4] == ["T\t1\t8", "T\t0\tprogress"]


@pytest.mark.parametrize("end", ["copy_fail", "terminate"])
def test_subscribe_client_ends_the_stream(envs, end):
    """CopyFail ('f') or Terminate ('X') mid-SUBSCRIBE ends the stream
    and the hub reaps the session."""

    def ex(env, pkg):
        c = MiniPg(env.pg.port)
        hub = env.coord.subscribe_hub
        try:
            name = f"e_{end}"
            c.query(f"CREATE TABLE {name} (v bigint NOT NULL)")
            c.query(f"INSERT INTO {name} VALUES (1)")
            before = hub.session_count()
            tag, _ = _start_subscribe(c, f"SUBSCRIBE {name}")
            tag2, _ = c.read_msg()
            during = hub.session_count()
            if end == "copy_fail":
                c.send(b"f", b"client aborted\x00")
            else:
                c.send(b"X", b"")
            _until(lambda: hub.session_count() == before, msg="session reaped")
            return tag, tag2, during - before
        finally:
            c.sock.close()

    assert both(envs, ex) == (b"H", b"d", 1)


# -- HTTP ------------------------------------------------------------------------------


def test_sql_metrics_ready(envs):
    def ex(env, pkg):
        port = env.http.port
        live = _http(port, "/api/livez")
        verdict = _until(lambda: (lambda r: json.loads(r[2]) if r[0] == 200 else None)(
            _http(port, "/api/readyz")), msg="readyz 200")
        status, out = _sql(port, "CREATE TABLE ht (x bigint NOT NULL); "
                                 "INSERT INTO ht VALUES (3); SELECT x FROM ht")
        metrics = _http(port, "/metrics")
        bad = _sql(port, "SELECT nope FROM ht")
        missing = _http(port, "/nope")
        return (live, verdict["ready"], verdict["checks"], status, out,
                metrics[0], metrics[1], metrics[2].startswith(b"#"), bad, missing[0])

    out = both(envs, ex)
    assert out[0][2] == b"live\n" and out[1] is True and out[4]["results"][-1]["rows"] == [[3]]
    assert out[8][0] == 400


def test_subscribe_sse_stream(envs):
    def ex(env, pkg):
        port = env.http.port
        _sql(port, "CREATE TABLE sse (x bigint NOT NULL)")
        _sql(port, "INSERT INTO sse VALUES (41)")
        url = (f"http://127.0.0.1:{port}/api/subscribe?query="
               + urllib.parse.quote("SUBSCRIBE sse"))
        r = urllib.request.urlopen(url, timeout=30)
        try:
            def next_data():
                while True:
                    line = r.readline()
                    assert line, "stream closed early"
                    if line.startswith(b"data: "):
                        return json.loads(line[6:])

            first = next_data()
            out = [r.headers.get("Content-Type"), first.get("snapshot"),
                   [[e[0], e[-1]] for e in first["events"]]]
            _sql(port, "INSERT INTO sse VALUES (42)")
            saw = []
            while not saw:
                saw = [[e[0], e[-1]] for e in next_data()["events"] if e[0] == 42]
            out.append(saw)
            return out
        finally:
            r.close()

    assert both(envs, ex) == ["text/event-stream", True, [[41, 1]], [[42, 1]]]


def test_subscribe_sse_rejects_non_subscribe(envs):
    def ex(env, pkg):
        port = env.http.port
        out = [_http(port, "/api/subscribe", {"query": "SELECT 1"})]
        out.append(_http(port, "/api/subscribe?query="))
        _sql(port, "CREATE TABLE nsw (x bigint NOT NULL)")
        out.append(_http(port, "/api/subscribe?query="
                         + urllib.parse.quote("INSERT INTO nsw VALUES (1)")))
        out.append(_sql(port, "SELECT count(*) FROM nsw")[1])  # nothing written
        return out

    out = both(envs, ex)
    assert out[0][0] == 400 and "SUBSCRIBE" in json.loads(out[0][2])["error"]
    assert out[3]["results"][-1]["rows"] == [[0]]


def test_pgwire_http_peek_parity(envs):
    queries = [
        "SELECT * FROM ptv", "SELECT * FROM ptv WHERE k = 1",
        "SELECT s FROM ptv WHERE k = 2", "SELECT * FROM ptv WHERE k = 1 AND s = 'a'",
        "SELECT * FROM ptv WHERE k = 99", "SELECT count(*) FROM ptv",
    ]

    def ex(env, pkg):
        c = MiniPg(env.pg.port)
        try:
            c.query("CREATE TABLE pt (k bigint NOT NULL, s text);"
                    "INSERT INTO pt VALUES (1, 'a'), (1, 'a'), (2, 'b'), (3, NULL);"
                    "CREATE VIEW ptv AS SELECT * FROM pt;"
                    "CREATE INDEX pti ON ptv")
            out = []
            for q in queries:
                _cols, pg_rows, err, _tag = c.query(q)
                assert err is None, (q, err)
                http_rows = _sql(env.http.port, q)[1]["results"][-1]["rows"]
                norm = [tuple(None if v is None else str(v) for v in row) for row in http_rows]
                assert sorted(pg_rows) == sorted(norm), (pkg, q)
                out.append(sorted(pg_rows, key=repr))
            return out
        finally:
            c.close()

    out = both(envs, ex)
    assert out[0] == [("1", "a"), ("1", "a"), ("2", "b"), ("3", None)]


# -- the port's command, with a subprocess replica ---------------------------------------

SCRIPT = [
    "CREATE TABLE dep (k bigint NOT NULL, v text)",
    "INSERT INTO dep VALUES (1, 'a'), (2, 'b'), (2, 'b')",
    "CREATE MATERIALIZED VIEW depmv AS SELECT k, count(*) AS n FROM dep GROUP BY k",
    "CREATE VIEW depv AS SELECT k, v FROM dep",
    "CREATE INDEX depv_idx ON depv (k)",
    "SELECT * FROM depmv",
    "SELECT * FROM depv WHERE k = 2",
    "SELECT name FROM mz_objects WHERE name LIKE 'dep%'",
    "SELECT dataflow, replica, status FROM mz_hydration_statuses WHERE dataflow = 'depmv'",
    "SELECT name, connected, state FROM mz_cluster_replicas",
    "SELECT count(*) FROM mz_subscriptions",
]


def _script_answers(pg_port: int, http_port: int) -> list:
    """The script over pgwire (rows as text) and each SELECT again over
    /api/sql, normalized to text."""
    c = MiniPg(pg_port)
    try:
        out = []
        for sql in SCRIPT:
            cols, rows, err, tag = c.query(sql)
            if "mz_hydration" in sql and not rows:
                rows = _until(lambda: c.query(sql)[1], msg="hydration status")
            out.append((cols, sorted(rows, key=repr), err, tag))
            if sql.startswith("SELECT"):
                http_rows = _sql(http_port, sql)[1]["results"][-1]["rows"]
                out.append(sorted((tuple(None if v is None else str(v) for v in r)
                                   for r in http_rows), key=repr))
        return out
    finally:
        c.close()


def _sse_subscribe(http_port: int, sql: str):
    url = f"http://127.0.0.1:{http_port}/api/subscribe?query=" + urllib.parse.quote(sql)
    r = urllib.request.urlopen(url, timeout=30)

    def next_data():
        while True:
            line = r.readline()
            assert line, "stream closed early"
            if line.startswith(b"data: "):
                return json.loads(line[6:])

    return r, next_data


def _boot(data_dir: str, *extra) -> tuple:
    """Start the port's environmentd with ``--device cpu``; returns the
    process and its ports (``_listening`` waits for it)."""
    pg, http = free_port(), free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "materialize_tpu_torch.server.environmentd",
         "--data-dir", data_dir, "--pg-port", str(pg), "--http-port", str(http),
         "--device", "cpu", "--tick-interval", "0.05", *extra],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        # One intra-op thread in both processes, as in every port test.
        env={**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"},
    )
    return proc, pg, http


def _listening(proc) -> list:
    """The process's stdout lines up to its listening line."""
    lines = []
    for line in proc.stdout:
        lines.append(line.rstrip("\n"))
        if "listening: pgwire" in line:
            return lines
    proc.wait(10)
    raise AssertionError(f"environmentd exited {proc.returncode}: {lines}")


def _stop(proc) -> int:
    proc.terminate()
    try:
        return proc.wait(30)
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.stdout.close()


def test_port_environmentd_with_a_subprocess_replica(envs, tmp_path):
    ref = envs["ref"]
    data_dir = str(tmp_path / "dep")
    proc, pg, http = _boot(data_dir)  # boots while the reference answers
    try:
        want = _script_answers(ref.pg.port, ref.http.port)
        _listening(proc)
        assert _script_answers(pg, http) == want
        # SUBSCRIBE over pgwire and over SSE on the subprocess replica's
        # materialized view; then one more write reaches both.
        c = MiniPg(pg)
        assert _start_subscribe(c, "SUBSCRIBE depmv")[0] == b"H"
        tag, data = c.read_msg()
        assert tag == b"d" and sorted(_copy_lines(data)) == sorted(
            ["T\t0\tsnapshot", "T\t1\t1\t1", "T\t1\t2\t2", "T\t0\tprogress"])
        r, next_data = _sse_subscribe(http, "SUBSCRIBE depmv")
        first = next_data()
        assert first["snapshot"] is True
        assert sorted([e[0], e[1], e[-1]] for e in first["events"]) == [[1, 1, 1], [2, 2, 1]]
        frontier = first["progress"]
        _sql(http, "INSERT INTO dep VALUES (3, 'c')")
        tag, data = c.read_msg()
        assert sorted(_copy_lines(data)) == ["T\t0\tprogress", "T\t1\t3\t1"]
        sse = next_data()
        assert [[e[0], e[1], e[-1]] for e in sse["events"]] == [[3, 1, 1]]
        frontier = sse["progress"]
        r.close()
        c.sock.close()
        # The replica's own observability, shipped on its Frontiers.
        _sql(http, "SET metrics_report_ms = 50")
        metrics = _until(lambda: (lambda t: t if 'mz_replica_step_seconds_count{replica="r0"}'
                                  in t else None)(_http(http, "/metrics")[2].decode()),
                         msg="shipped replica metrics")
        assert 'mz_merge_path_launches_total{replica="r0"} 0' in metrics  # the CPU
        lag = _until(lambda: [row for row in _sql(http, (
            "SELECT dataflow, replica, samples FROM mz_wallclock_lag_summary"))[1][
            "results"][-1]["rows"] if row[0] == "depmv"], msg="lag records from the replica")
        assert lag[0][1] == "r0" and lag[0][2] >= 1
        # The replica process's native library load, shipped on its
        # Frontiers into the compile ledger.
        compiles = _until(lambda: [row for row in _sql(http, (
            "SELECT process, kind, dataflow, cache FROM mz_compile_log"))[1][
            "results"][-1]["rows"] if row[0] == "r0"], msg="the replica's compile records")
        assert ["r0", "g++", "mtnative.cpp", "hit"] in compiles, compiles
        ready = _until(lambda: (lambda x: x if x[0] == 200 else None)(
            _http(http, "/api/readyz")), msg="readyz")
        assert json.loads(ready[2])["ready"] is True
    finally:
        assert _stop(proc) == 0
    # Recovery: the catalog replays and the view comes back; a
    # subscription resumed AS OF its last frontier gets exactly what
    # came after it.
    proc, pg, http = _boot(data_dir, "--recover")
    try:
        lines = _listening(proc)
        report = json.loads(next(ln for ln in lines if ln.startswith("recovery: "))[10:])
        assert report["coordinator"]["catalog_replayed"] == 5.0
        assert report["coordinator"]["replay_failures"] == 0.0
        assert "compiles" not in report
        assert sorted(_sql(http, "SELECT * FROM depmv")[1]["results"][-1]["rows"]) == [
            [1, 1], [2, 2], [3, 1]]
        r, next_data = _sse_subscribe(http, f"SUBSCRIBE depmv AS OF {frontier - 1}")
        first = next_data()
        assert sorted([e[0], e[1], e[-1]] for e in first["events"]) == [
            [1, 1, 1], [2, 2, 1], [3, 1, 1]]
        _sql(http, "INSERT INTO dep VALUES (3, 'd')")
        after = next_data()
        assert sorted([e[0], e[1], e[-1]] for e in after["events"]) == [[3, 1, -1], [3, 2, 1]]
        r.close()
    finally:
        assert _stop(proc) == 0


# -- the environment's replica lifecycle -------------------------------------------------


def test_environment_lifecycle(envs):
    """Last in the file (the reference's deployment does not answer a
    new view's SELECT after this sequence). In order, on each package's
    deployment: a rolling restart of its
    only replica is refused (nobody else serves); a runtime replica is
    added and serves; a rolling restart of both keeps every durable
    dataflow served throughout; the added replica is dropped."""

    def ex(env, pkg):
        c, ctl = env.coord, env.coord.controller
        c.execute("CREATE TABLE lt (x BIGINT NOT NULL)")
        c.execute("INSERT INTO lt VALUES (1), (2)")
        c.execute("CREATE MATERIALIZED VIEW lmv AS SELECT x FROM lt")
        _until(lambda: ctl.serving_replicas("lmv") == ["r0"], msg="r0 serving")
        single = env.rolling_restart(hydrate_timeout=0.5)
        out = [single["aborted"], "no other serving replica" in single["replicas"][0]["error"],
               sorted(c.execute("SELECT x FROM lmv").rows)]
        rid = env.add_replica()
        _until(lambda: rid in ctl.serving_replicas("lmv"), timeout=60, msg="added replica")
        out += [rid, sorted(r[0] for r in c.execute("SELECT name FROM mz_cluster_replicas").rows)]
        report = env.rolling_restart(hydrate_timeout=90.0)
        out += [report["aborted"], [e["rehydrated"] for e in report["replicas"]],
                report["invariant"]["continuously_served"], report["invariant"]["samples"] > 0]
        dropped = env.drop_replica(rid)
        out += [dropped["dropped"], rid in ctl.replicas, sorted(c.execute("SELECT x FROM lmv").rows)]
        return out

    assert both(envs, ex) == ["r0", True, [(1,), (2,)], "r1", ["r0", "r1"], None, [True, True],
                              True, True, True, False, [(1,), (2,)]]
