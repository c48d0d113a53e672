"""The port's lock-order sanitizer (``utils/lockcheck.py``), the cases of
``tests/test_lockcheck.py``: cycle detection over tracked locks, the
dispatch-under-sequencing-lock rule, the tracked-lock registry, and a
clean bill over the port's serving path (the pipelined span train,
coordinator sequencing, fast-path peeks, SUBSCRIBE, introspection) run
with recording on. ``utils/locks.py``'s constructors, which every
control-plane lock of the port goes through, build these tracked locks.
"""

from __future__ import annotations

import threading
import time

import pytest

from materialize_tpu_torch.utils import lockcheck
from tests.torch_serving import Cluster, deadline, one_torch_thread  # noqa: F401


@pytest.fixture
def checker():
    lockcheck.enable(reset=True)
    yield lockcheck
    lockcheck.disable()
    lockcheck.clear()


def test_consistent_order_is_clean(checker):
    a = lockcheck.tracked_lock("test.a")
    b = lockcheck.tracked_lock("test.b")
    for _ in range(3):
        with a:
            with b:
                pass
    assert checker.findings() == []
    assert "test.b" in checker.edges().get("test.a", set())


def test_reversed_order_closes_cycle(checker):
    a = lockcheck.tracked_lock("test.a")
    b = lockcheck.tracked_lock("test.b")
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    found = checker.findings()
    assert len(found) == 1 and found[0].kind == "lock-cycle"
    assert "test.a" in found[0].message and "test.b" in found[0].message


def test_three_lock_cycle_via_path(checker):
    a, b, c = (lockcheck.tracked_lock(f"test.{n}") for n in "abc")
    with a:
        with b:
            pass
    with b:
        with c:
            pass
    with c:
        with a:
            pass  # a -> b -> c -> a
    assert [f.kind for f in checker.findings()] == ["lock-cycle"]


def test_rlock_reentry_is_not_an_edge(checker):
    r = lockcheck.tracked_rlock("test.r")
    with r:
        with r:  # re-entry: no self-edge, no cycle
            pass
    assert checker.findings() == [] and checker.edges() == {}


def test_cross_thread_orders_merge_into_one_graph(checker):
    a = lockcheck.tracked_lock("test.a")
    b = lockcheck.tracked_lock("test.b")

    def t1():
        with a:
            with b:
                pass

    th = threading.Thread(target=t1)
    th.start()
    th.join()
    with b:
        with a:
            pass  # reverse order on the main thread
    assert [f.kind for f in checker.findings()] == ["lock-cycle"]


def test_dispatch_under_sequencing_lock_flagged(checker):
    seq = lockcheck.tracked_rlock("coord.sequencing", sequencing=True)
    with seq:
        lockcheck.device_dispatch("test-site")
    found = checker.findings()
    assert len(found) == 1 and found[0].kind == "dispatch-under-lock"
    assert "test-site" in found[0].message


def test_allow_dispatch_sanctions_bounded_sites(checker):
    seq = lockcheck.tracked_rlock("coord.sequencing", sequencing=True)
    with seq:
        with lockcheck.allow_dispatch("test constants"):
            lockcheck.device_dispatch("test-site")
    assert checker.findings() == []


def test_dispatch_without_lock_is_clean(checker):
    lockcheck.device_dispatch("test-site")
    assert checker.findings() == []


def test_subsystem_locks_register(checker):
    """The port's control-plane locks are tracked (``utils/locks.py``
    builds them through lockcheck), and the race detector's shims exist
    with the reference's API (the detector itself is ROADMAP item 14)."""
    from materialize_tpu_torch.coord import freshness  # noqa: F401
    from materialize_tpu_torch.coord.coordinator import Coordinator  # noqa: F401
    from materialize_tpu_torch.utils import compile_ledger  # noqa: F401
    from materialize_tpu_torch.utils import dyncfg  # noqa: F401
    from materialize_tpu_torch.utils.locks import tracked_lock

    assert isinstance(tracked_lock("test.locks"), lockcheck.TrackedLock)
    names = lockcheck.registered_names()
    for expected in ("compile.ledger", "freshness.recorder", "dyncfg",
                     "coord.sequencing", "test.locks"):
        assert expected in names, expected
    seen = []

    class Hooks:
        def on_read(self, name):
            seen.append(("r", name))

        def on_write(self, name):
            seen.append(("w", name))

    lockcheck.shared_read("x")  # no detector: a no-op
    lockcheck.set_racecheck(Hooks())
    try:
        lockcheck.shared_read("a")
        lockcheck.shared_write("b")
    finally:
        lockcheck.set_racecheck(None)
    assert seen == [("r", "a"), ("w", "b")]


def _acyclic(edges: dict) -> bool:
    """Kahn's algorithm over the observed graph: every node drains."""
    nodes = set(edges) | {n for vs in edges.values() for n in vs}
    indeg = {n: 0 for n in nodes}
    for vs in edges.values():
        for v in vs:
            indeg[v] += 1
    queue = [n for n, d in indeg.items() if d == 0]
    drained = 0
    while queue:
        n = queue.pop()
        drained += 1
        for v in edges.get(n, ()):
            indeg[v] -= 1
            if indeg[v] == 0:
                queue.append(v)
    return drained == len(nodes)


def test_subscribe_locks_register_and_nest_acyclically(checker, tmp_path):
    cl = Cluster("port", str(tmp_path))
    try:
        coord = cl.coordinator()
        coord.execute("CREATE TABLE st (a BIGINT, b BIGINT)")
        coord.execute("INSERT INTO st VALUES (1, 2)")
        sub = coord.execute("SUBSCRIBE TO (SELECT a, b FROM st WHERE a >= 0)").subscription
        coord.execute("INSERT INTO st VALUES (3, 4)")
        final = coord._table_writers["st"].upper
        end = time.monotonic() + 60.0
        while sub.frontier < final and time.monotonic() < end:
            sub.pop_ready()
            time.sleep(0.01)
        assert sub.frontier >= final
        coord.subscribe_hub.session_count()
        sub.close()
        time.sleep(0.2)
    finally:
        cl.shutdown()
    assert [str(f) for f in checker.findings()] == []
    names = lockcheck.registered_names()
    for expected in ("coord.subscribe_hub", "subscribe.tail", "subscribe.session"):
        assert expected in names, expected
    edges = checker.edges()
    assert edges, "no lock orders recorded"
    assert _acyclic(edges), f"observed lock-order graph has a cycle: {edges}"


def test_serving_script_records_zero_findings(checker, tmp_path):
    """A serving script with recording on: the replica worker loop with
    the pipelined span path (``span_pipelining`` is on by default),
    coordinator sequencing, fast-path and slow-path peeks, and the
    introspection step sanctioned under the sequencing lock."""
    cl = Cluster("port", str(tmp_path))
    try:
        coord = cl.coordinator()
        coord.execute("CREATE TABLE t (a INT, b INT)")
        coord.execute("INSERT INTO t VALUES (1, 2), (3, 4)")
        coord.execute("CREATE MATERIALIZED VIEW mv AS SELECT a, b FROM t")
        coord.execute("CREATE INDEX i ON mv (a)")
        coord.execute("INSERT INTO t VALUES (5, 6)")
        assert sorted(coord.execute("SELECT * FROM mv").rows) == [(1, 2), (3, 4), (5, 6)]
        assert coord.execute("SELECT * FROM mv WHERE a = 1").rows == [(1, 2)]
        assert coord.execute("SELECT count(*) FROM mz_span_epochs").rows[0][0] >= 1
        coord.execute("SELECT * FROM mz_compile_log")
        time.sleep(0.2)
    finally:
        cl.shutdown()
    assert [str(f) for f in checker.findings()] == []
    assert checker.edges(), "no lock orders recorded"
