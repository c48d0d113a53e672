"""Port parity for the happens-before race detector
(``analysis/racecheck.py``) and its annotations in the port's control
plane.

- The reference's mechanics cases (``tests/test_racecheck.py``: fork
  and join edges, lock release/acquire, both stack chains, the
  suppression valve, the two pinned race reproductions) on the port's
  detector.
- The declared shared-state registry names the same variables as the
  reference's, and the port's modules annotate each at the counterpart
  of every reference site (the same count of ``shared_read`` and
  ``shared_write`` calls, module by module).
- With ``race_detector`` on (the dyncfg, through
  ``maybe_enable_from_dyncfg``), the port's serving and subscribe paths
  (DDL, ingest, fast and slow peeks, a collection aggregate, SUBSCRIBE
  delivery and teardown, introspection, EXPLAIN ANALYSIS) record zero
  findings.
"""

import ast
import threading
from pathlib import Path

import pytest

from materialize_tpu_torch.analysis import racecheck
from materialize_tpu_torch.utils import lockcheck
from tests.torch_serving import deadline, one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def detector():
    lockcheck.enable(reset=True)
    racecheck.enable(reset=True)
    yield racecheck
    racecheck.disable()
    lockcheck.disable()


def _findings_for(name):
    return [f for f in racecheck.findings() if f.name == name]


class TestMechanics:
    def test_unlocked_concurrent_writes_detected(self, detector):
        racecheck.declare_shared("test.ww")
        wrote = threading.Event()

        def child():
            lockcheck.shared_write("test.ww")
            wrote.set()

        t = threading.Thread(target=child)
        t.start()
        assert wrote.wait(5)
        # Event hand-offs are deliberately NOT modeled: this write is
        # ordered in wall-clock time but not in the happens-before
        # relation — exactly the kind of "works on my machine" pair
        # the detector exists to flag.
        lockcheck.shared_write("test.ww")
        t.join()
        found = _findings_for("test.ww")
        assert [f.kind for f in found] == ["write-write"]

    def test_finding_carries_both_stack_chains(self, detector):
        racecheck.declare_shared("test.stacks")
        wrote = threading.Event()

        def child():
            lockcheck.shared_write("test.stacks")
            wrote.set()

        t = threading.Thread(target=child)
        t.start()
        assert wrote.wait(5)
        lockcheck.shared_write("test.stacks")
        t.join()
        (f,) = _findings_for("test.stacks")
        assert "test_torch_racecheck.py" in f.a_where
        assert "test_torch_racecheck.py" in f.b_where
        assert f.a_thread != f.b_thread
        assert "no happens-before edge" in str(f)

    def test_common_lock_orders_the_pair(self, detector):
        racecheck.declare_shared("test.locked")
        lk = lockcheck.tracked_lock("test.locked.lock")
        wrote = threading.Event()

        def child():
            with lk:
                lockcheck.shared_write("test.locked")
            wrote.set()

        t = threading.Thread(target=child)
        t.start()
        assert wrote.wait(5)
        with lk:  # acquire joins the clock the child's release left
            lockcheck.shared_write("test.locked")
        t.join()
        assert _findings_for("test.locked") == []

    def test_fork_and_join_edges(self, detector):
        racecheck.declare_shared("test.forkjoin")
        lockcheck.shared_write("test.forkjoin")  # before start: ordered

        def child():
            lockcheck.shared_read("test.forkjoin")
            lockcheck.shared_write("test.forkjoin")

        t = threading.Thread(target=child)
        t.start()
        t.join()
        lockcheck.shared_read("test.forkjoin")  # after join: ordered
        assert _findings_for("test.forkjoin") == []

    def test_suppress_is_a_valve(self, detector):
        racecheck.declare_shared("test.benign")
        racecheck.suppress("test.benign")
        try:
            wrote = threading.Event()

            def child():
                lockcheck.shared_write("test.benign")
                wrote.set()

            t = threading.Thread(target=child)
            t.start()
            assert wrote.wait(5)
            lockcheck.shared_write("test.benign")
            t.join()
            assert _findings_for("test.benign") == []
        finally:
            racecheck.unsuppress("test.benign")

    def test_declared_registry_covers_the_control_plane(self):
        reg = racecheck.registry()
        for name in (
            "controller.replicas",
            "controller.observed",
            "controller.peek_events",
            "controller.replica_stats",
            "subscribe.sessions",
            "freshness.lag_rings",
            "compile_ledger.seen",
            "dyncfg.values",
        ):
            assert name in reg, name


class TestFixedRaceReproductions:
    """The reference's reproductions of two racy access patterns of its
    control plane: the port's detector finds each again, and passes the
    fixed shape."""

    def test_unlocked_snapshot_read_races_locked_write(self, detector):
        """A map read with no lock while another thread writes it under
        one (the controller's replica map before its fix)."""
        racecheck.declare_shared("repro.replicas")
        state = lockcheck.tracked_lock("repro.state")
        wrote = threading.Event()

        def adder():
            with state:
                lockcheck.shared_write("repro.replicas")
            wrote.set()

        t = threading.Thread(target=adder)
        t.start()
        assert wrote.wait(5)
        lockcheck.shared_read("repro.replicas")  # pre-fix: no lock
        t.join()
        assert [f.kind for f in _findings_for("repro.replicas")] == [
            "write-read"
        ]

    def test_wrong_lock_does_not_order(self, detector):
        """A census read under one lock of state written under another:
        two locks, zero edges (the subscribe hub's before its fix); the
        fixed shape takes both, hub then tail."""
        racecheck.declare_shared("repro.sessions")
        tail = lockcheck.tracked_lock("repro.tail")
        hub = lockcheck.tracked_lock("repro.hub")
        wrote = threading.Event()

        def session_add():
            with tail:
                lockcheck.shared_write("repro.sessions")
            wrote.set()

        t = threading.Thread(target=session_add)
        t.start()
        assert wrote.wait(5)
        with hub:  # pre-fix census: the WRONG lock
            lockcheck.shared_read("repro.sessions")
        t.join()
        assert [f.kind for f in _findings_for("repro.sessions")] == [
            "write-read"
        ]
        # and the fixed shape — hub THEN tail — is clean:
        racecheck.clear()
        t2 = threading.Thread(target=session_add)
        wrote.clear()
        t2.start()
        assert wrote.wait(5)
        with hub:
            with tail:
                lockcheck.shared_read("repro.sessions")
        t2.join()
        assert _findings_for("repro.sessions") == []


def test_registry_names_the_reference_variables():
    from materialize_tpu.analysis import racecheck as jracecheck

    def standing(reg):
        return {n for n in reg if not n.startswith(("test.", "repro."))}

    assert standing(racecheck.registry()) == standing(jracecheck.registry())


MODULES = ("coord/controller.py", "coord/freshness.py", "coord/subscribe.py",
           "coord/autoscaler.py", "utils/compile_ledger.py", "utils/dyncfg.py")


def _annotations(path: Path) -> list:
    out = []
    for node in ast.walk(ast.parse(path.read_text())):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("shared_read", "shared_write")):
            arg = node.args[0]
            out.append((node.func.attr, arg.value if isinstance(arg, ast.Constant) else None))
    return sorted(out)


@pytest.mark.parametrize("module", MODULES)
def test_annotations_match_the_reference_sites(module):
    """Each module annotates the same shared variables, read and write,
    as many times as the reference's (37 sites in the controller, 9 in
    the freshness recorder, 7 in the subscribe hub, 3 in the
    autoscaler, 2 in the compile ledger, 3 in the flag store)."""
    got = _annotations(ROOT / "materialize_tpu_torch" / module)
    assert got == _annotations(ROOT / "materialize_tpu" / module) and got


def test_serving_and_subscribe_paths_record_zero_findings(tmp_path):
    import time

    from materialize_tpu_torch.utils.dyncfg import COMPUTE_CONFIGS
    from tests.torch_serving import Cluster

    COMPUTE_CONFIGS.update({"race_detector": True})
    lockcheck.enable(reset=True)
    try:
        assert racecheck.maybe_enable_from_dyncfg(reset=True)
        cl = Cluster("port", str(tmp_path))
        try:
            coord = cl.coordinator()
            coord.execute("CREATE TABLE t (a BIGINT, b BIGINT, c TEXT)")
            coord.execute("INSERT INTO t VALUES (1, 2, 'x'), (3, 4, 'y'), (1, 5, 'w')")
            coord.execute("CREATE MATERIALIZED VIEW mv AS SELECT a, b FROM t")
            coord.execute("CREATE VIEW sv AS SELECT a, string_agg(c, ',') AS s "
                          "FROM t GROUP BY a")
            coord.execute("CREATE INDEX svx ON sv (a)")
            coord.execute("SELECT * FROM mv")
            coord.execute("SELECT * FROM mv WHERE a = 1")
            assert sorted(coord.execute("SELECT * FROM sv").rows) == [(1, "w,x"), (3, "y")]
            sub = coord.execute("SUBSCRIBE TO (SELECT a, b FROM t WHERE a >= 0)").subscription
            coord.execute("INSERT INTO t VALUES (5, 6, 'z')")
            final = coord._table_writers["t"].upper
            deadline_s = time.monotonic() + 60.0
            while sub.frontier < final and time.monotonic() < deadline_s:
                sub.pop_ready()
                time.sleep(0.01)
            sub.close()
            coord.execute("SELECT * FROM mz_donation")
            coord.execute("EXPLAIN ANALYSIS SELECT * FROM mv")
            coord.execute("SET span_window_spans = 8")
            time.sleep(0.2)
        finally:
            cl.shutdown()
        findings = [str(f) for f in racecheck.findings()]
        seen = set(racecheck._vars)
    finally:
        racecheck.disable()
        lockcheck.disable()
        COMPUTE_CONFIGS.update({"race_detector": None, "span_window_spans": None})
    assert findings == []
    # The run went through the annotated sites.
    assert {"controller.replicas", "controller.observed", "controller.peek_events",
            "subscribe.sessions", "freshness.lag_rings", "dyncfg.values"} <= seen, seen
