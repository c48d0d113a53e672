"""The port's replica with ``--workers 2`` on the CPU (``coord/spmd.py``).

The replica command runs as a process of its own, rank 0 of a gloo mesh
with one follower process; a coordinator of the port in this process
drives it. One script (a table, a materialized view with SUM, COUNT and
STRING_AGG by key, inserts, deletes, SELECTs, and a SUBSCRIBE drained
to the table's final frontier) gives the same outcomes at ``--workers
2`` as at ``--workers 1``; the SELECTs also equal an oracle. EXPLAIN
ANALYSIS reports ``spmd=true workers=2``. A follower killed with
SIGKILL fails the replica: its process exits non-zero, and no follower
outlives it.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

from tests.torch_serving import (SOCKET_TIMEOUT_S, deadline, free_port, mod,  # noqa: F401
                                 one_torch_thread)

ROOT = Path(__file__).resolve().parents[1]
BOOT_S = 60.0


def _replica(root: Path, workers: int):
    port = free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "materialize_tpu_torch.coord.replica", "--port", str(port),
         "--blob", str(root / "blob"), "--consensus", str(root / "consensus.db"),
         "--workers", str(workers), "--device", "cpu"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    line = proc.stdout.readline()
    assert "listening" in line, line + proc.stderr.read()[-2000:]
    return proc, port


def _coordinator(root: Path, port: int):
    coordinator = mod("port", "coord.coordinator")
    persist = mod("port", "storage.persist")
    c = coordinator.Coordinator(
        persist.PersistClient(persist.FileBlob(str(root / "blob")),
                              persist.SqliteConsensus(str(root / "consensus.db"))),
        tick_interval=None, device="cpu",
    )
    c.add_replica("r0", ("127.0.0.1", port))
    return c


def _stop(proc) -> int:
    proc.send_signal(signal.SIGTERM)
    try:
        return proc.wait(30)
    finally:
        if proc.poll() is None:
            proc.kill()


def _followers(pid: int) -> list:
    """Pids of the follower ranks a replica process started."""
    out = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                ppid = int(f.read().split(") ", 1)[1].split()[1])
            with open(f"/proc/{d}/cmdline", "rb") as f:
                cmd = f.read()
        except (OSError, IndexError, ValueError):
            continue
        if ppid == pid and b"--follow" in cmd:
            out.append(int(d))
    return out


ROWS = [(k % 5, k, f"s{k % 7}") for k in range(40)]


def _script(coord) -> list:
    out = []
    coord.execute("CREATE TABLE t (k BIGINT NOT NULL, v BIGINT NOT NULL, s TEXT NOT NULL)")
    coord.execute("INSERT INTO t VALUES " + ", ".join(f"({k}, {v}, '{s}')" for k, v, s in ROWS[:25]))
    coord.execute("CREATE MATERIALIZED VIEW mv AS SELECT k, sum(v) AS sv, count(*) AS n, "
                  "string_agg(s, ',') AS ss FROM t GROUP BY k")
    out.append(sorted(coord.execute("SELECT * FROM mv").rows))
    sub = coord.execute("SUBSCRIBE TO (SELECT k, v FROM t WHERE k >= 1)").subscription
    coord.execute("INSERT INTO t VALUES " + ", ".join(f"({k}, {v}, '{s}')" for k, v, s in ROWS[25:]))
    coord.execute("DELETE FROM t WHERE v < 6")
    out.append(sorted(coord.execute("SELECT * FROM mv").rows))
    out.append(sorted(coord.execute("SELECT k, n FROM mv WHERE k = 3").rows))
    final = coord._table_writers["t"].upper
    state: dict = {}
    end = time.monotonic() + 60.0
    while sub.frontier < final:
        assert time.monotonic() < end, f"subscription stuck at {sub.frontier} < {final}"
        if sub.wait(1.0):
            for kind, events, _upper, _stamp in sub.pop_ready():
                if kind == "snapshot":
                    state = {}
                for ev in events:
                    key = tuple(ev[:-2])
                    state[key] = state.get(key, 0) + ev[-1]
    for kind, events, _upper, _stamp in sub.pop_ready():
        for ev in events:
            key = tuple(ev[:-2])
            state[key] = state.get(key, 0) + ev[-1]
    out.append(sorted((k, n) for k, n in state.items() if n))
    sub.close()
    out.append(coord.execute("EXPLAIN ANALYSIS SELECT * FROM mv").text)
    return out


def _oracle(rows) -> list:
    acc: dict = {}
    for k, v, s in rows:
        sv, n, ss = acc.get(k, (0, 0, []))
        acc[k] = (sv + v, n + 1, ss + [s])
    return sorted((k, sv, n, ",".join(sorted(ss))) for k, (sv, n, ss) in acc.items())


def _run(root: Path, workers: int) -> list:
    proc, port = _replica(root, workers)
    coord = None
    try:
        coord = _coordinator(root, port)
        return _script(coord)
    finally:
        if coord is not None:
            coord.shutdown()
        assert _stop(proc) is not None


def test_two_workers_answer_as_one(tmp_path):
    one = _run(tmp_path / "w1", 1)
    two = _run(tmp_path / "w2", 2)
    assert two[:4] == one[:4]
    live = [r for r in ROWS if r[1] >= 6]
    assert [tuple(r[:3]) for r in two[0]] == [r[:3] for r in _oracle(ROWS[:25])]
    assert [tuple(r) for r in two[1]] == _oracle(live)
    assert two[3] == sorted(((k, v), 1) for k, v, _s in live if k >= 1)
    assert "spmd=true workers=2" in two[4] and "spmd=false workers=1" in one[4]


def test_killed_follower_fails_the_replica(tmp_path):
    proc, port = _replica(tmp_path, 2)
    try:
        end = time.monotonic() + 10
        followers = _followers(proc.pid)
        while not followers and time.monotonic() < end:
            time.sleep(0.1)
            followers = _followers(proc.pid)
        assert len(followers) == 1, followers
        os.kill(followers[0], signal.SIGKILL)
        rc = proc.wait(30)
        assert rc != 0
        assert "follower rank 1 exited" in proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_in_process_replicas_refuse_more_workers(tmp_path):
    """Rank 0 of an SPMD replica joins the process-wide worker group and
    exits its process when a follower dies, so more workers than one
    are the replica command's alone: an in-process ``ReplicaWorker`` and
    an ``Environment`` of in-process replicas refuse them, naming the
    command, before any follower or thread starts."""
    replica = mod("port", "coord.replica")
    protocol = mod("port", "coord.protocol")
    environmentd = mod("port", "server.environmentd")
    loc = protocol.PersistLocation(str(tmp_path / "blob"), str(tmp_path / "c.db"))
    with pytest.raises(ValueError, match="python -m materialize_tpu_torch.coord.replica"):
        replica.ReplicaWorker(location=loc, workers=2, device="cpu")
    with pytest.raises(ValueError, match="python -m materialize_tpu_torch.coord.replica"):
        environmentd.Environment(str(tmp_path / "envd"), workers=2, tick_interval=None,
                                 in_process_replicas=True, device="cpu")
    import torch.distributed as dist

    assert not dist.is_initialized()
    replica.ReplicaWorker(location=loc, device="cpu").stop()
