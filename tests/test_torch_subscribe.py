"""Port parity for SUBSCRIBE: the fan-out hub (``coord/subscribe.py``)
over each package's cluster.

The cases of ``tests/test_subscribe.py`` run as one scenario through the
reference's coordinator (JAX on the CPU) and the port's
(``device="cpu"``), each over its own in-process cluster; what each
scenario returns (every subscriber's multiset at every delivered
frontier, the hub's counters, the errors) must be equal. Covered:
sharing (one dataflow for same-query sessions, borrowed shard tails
with no install, one readback a span however many sessions), the
snapshot plus updates against an independent read of the durable shard
at every frontier, AS OF, exactly-once resume across a coordinator
restart, admission, both slow-consumer policies, DROP, shutdown and
``mz_subscriptions``. The slow-consumer cases wait until the shared tail
has fanned every window out before the consumer reads, so the queue
bound, not scheduling, decides what happens. The port alone: a query
subscription over an indexed view installed before any tick gets the
view's snapshot (the reference's hydration drops it, ROADMAP Queue 3).
"""

from __future__ import annotations

import random
import time as _time

import pytest

from tests.torch_dict import reference_dict_restored  # noqa: F401
from tests.torch_serving import Cluster, deadline, mod, one_torch_thread  # noqa: F401

PKGS = ("ref", "port")


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    """{package: Cluster}; a test takes a coordinator with ``coord``."""
    up = {}
    try:
        for pkg in PKGS:
            up[pkg] = Cluster(pkg, str(tmp_path_factory.mktemp(f"sub-{pkg}")))
            up[pkg].main = up[pkg].coordinator()
            up[pkg].main.execute("CREATE TABLE cfgsync (x BIGINT)")
        yield up
    finally:
        for cl in up.values():
            cl.shutdown()


@pytest.fixture(autouse=True)
def _reset_subscribe_dyncfg(clusters):
    yield
    reset = {"subscribe_max_sessions": None, "subscribe_queue_depth": None,
             "subscribe_slow_policy": None}
    for pkg in PKGS:
        # Through the coordinator: the in-process replica applies a test's
        # ``update_config`` to the same process-wide flags when its worker
        # gets to the command, which on a loaded host can be after a reset
        # made here directly. A reset sent down the same command stream
        # lands after it, and a read through the replica (served after
        # every command before it) waits until the reset has landed, so it
        # cannot undo the next test's settings either.
        main = clusters[pkg].main
        main.update_config(reset)
        main.execute("SELECT * FROM cfgsync")


def _new_main(cl):
    """A new coordinator fences the catalog writer of every earlier one:
    it becomes the cluster's main."""
    cl.main = cl.coordinator()
    return cl.main


def both(clusters, scenario):
    """``scenario(pkg, coord)`` on each package's cluster; equal outcomes.

    A scenario that raises fails its test only: its package's main
    coordinator is shut down (which reaps the sessions and read holds
    the scenario left open) and replaced before the error goes on. The
    scenarios compare frontiers relative to their own tables' first
    upper, so the writes an aborted scenario made do not shift later
    tests' frontiers either."""
    out = {}
    for pkg in PKGS:
        try:
            out[pkg] = scenario(pkg, clusters[pkg].main)
        except BaseException:
            cl = clusters[pkg]
            cl.main.shutdown()
            cl.coords.remove(cl.main)
            _new_main(cl)
            raise
    assert out["port"] == out["ref"]
    return out["port"]


def _apply(state: dict, chunks) -> dict:
    for kind, events, _upper, _stamp in chunks:
        if kind == "snapshot":
            state = {}
        for ev in events:
            key = tuple(ev[:-2])
            state[key] = state.get(key, 0) + ev[-1]
    return {k: n for k, n in state.items() if n}


def _drain_until(session, frontier, timeout=60.0, state=None):
    state = dict(state or {})
    end = _time.monotonic() + timeout
    while session.frontier < frontier:
        assert _time.monotonic() < end, f"session stuck at {session.frontier} < {frontier}"
        if session.wait(1.0):
            state = _apply(state, session.pop_ready())
    return _apply(state, session.pop_ready())


def _until(pred, timeout=30.0, msg="condition"):
    end = _time.monotonic() + timeout
    while _time.monotonic() < end:
        v = pred()
        if v:
            return v
        _time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {msg}")


def _sub_dataflows(coord):
    with coord.controller._lock:
        return sorted(n for n in coord.controller._dataflows if n.startswith("sub"))


def test_same_query_subscribes_share_one_dataflow(clusters):
    def scen(pkg, coord):
        coord.execute("CREATE TABLE kv (k BIGINT NOT NULL, v BIGINT NOT NULL)")
        coord.execute("INSERT INTO kv VALUES (1, 10), (2, 20)")
        hub = coord.subscribe_hub
        base = dict(hub.stats)
        sql = "SUBSCRIBE TO (SELECT k, v FROM kv WHERE k >= 0)"
        subs = [coord.execute(sql).subscription for _ in range(6)]
        dfs = _sub_dataflows(coord)
        out = [len(dfs), hub.stats["installs"] - base["installs"],
               hub.stats["shared_joins"] - base["shared_joins"]]
        states = [_drain_until(s, coord._table_writers["kv"].upper) for s in subs]
        out.append(states)
        coord.execute("INSERT INTO kv VALUES (3, 30)")
        final = coord._table_writers["kv"].upper
        out.append([_drain_until(s, final, state=st) for s, st in zip(subs, states)])
        for s in subs[:-1]:
            s.close()
        out.append(dfs[0] in _sub_dataflows(coord))
        subs[-1].close()
        out.append(dfs[0] in _sub_dataflows(coord))
        subs[-1].close()  # idempotent: no second drop
        out += [hub.stats["drops"] - base["drops"], hub.snapshot()["tails"]]
        return out

    out = both(clusters, scen)
    assert out[:3] == [1, 1, 5] and out[5:] == [True, False, 1, []]
    assert all(st == {(1, 10): 1, (2, 20): 1, (3, 30): 1} for st in out[4])


def test_bare_get_tails_object_shard_and_readbacks_do_not_scale(clusters):
    def scen(pkg, coord):
        hub = coord.subscribe_hub
        coord.execute("CREATE TABLE rt (x BIGINT NOT NULL)")
        coord.execute("INSERT INTO rt VALUES (0)")
        installs = hub.stats["installs"]
        subs = [coord.execute("SUBSCRIBE rt").subscription for _ in range(8)]
        out = [hub.stats["installs"] - installs, _sub_dataflows(coord)]
        for i in range(4):
            coord.execute(f"INSERT INTO rt VALUES ({i + 1})")
        final = coord._table_writers["rt"].upper
        out.append([_drain_until(s, final) for s in subs])
        snap = hub.snapshot()
        (tail,) = snap["tails"]
        out += [tail["sessions"], tail["readbacks"] == tail["spans"],
                snap["readbacks_per_span"], 0 < tail["readbacks"] <= 6]
        for s in subs:
            s.close()
        return out

    out = both(clusters, scen)
    assert out[0] == 0 and out[1] == [] and out[3:] == [8, True, 1.0, True]
    assert all(st == {(i,): 1 for i in range(5)} for st in out[2])


def test_snapshot_plus_updates_reconstructs_oracle(clusters):
    """Every subscriber's replayed stream equals an independent read of
    the durable shard at every delivered frontier, early and mid-stream
    joiners alike, under duplicates and retractions."""

    def scen(pkg, coord):
        coord.execute("CREATE TABLE pu (k BIGINT NOT NULL, v BIGINT NOT NULL)")
        base = coord._table_writers["pu"].upper
        coord.execute("INSERT INTO pu VALUES (0, 0), (0, 0)")
        early = coord.execute("SUBSCRIBE TO (SELECT k, v FROM pu WHERE k >= 0)").subscription
        rng = random.Random(7)
        live, mid = [(0, 0), (0, 0)], None
        for t in range(12):
            ups = []
            for _ in range(rng.randrange(1, 3)):
                k, v = rng.randrange(4), rng.randrange(8)
                ups.append(f"({k}, {v})")
                live.append((k, v))
            coord.execute("INSERT INTO pu VALUES " + ", ".join(ups))
            if live and rng.random() < 0.5:
                rk, rv = rng.choice(live)
                coord.execute(f"DELETE FROM pu WHERE k = {rk} AND v = {rv}")
                live = [p for p in live if p != (rk, rv)]
            if t == 5:
                mid = coord.execute("SUBSCRIBE pu").subscription
        final = coord._table_writers["pu"].upper
        shard = coord.catalog.items["pu"].definition["shard"]

        def oracle_at(frontier):
            reader = coord.persist.open_reader(shard, "test-oracle")
            try:
                _s, cols, _n, _t, diff = reader.snapshot(frontier - 1)
            finally:
                reader.expire()
            acc: dict = {}
            for i in range(len(diff)):
                key = tuple(int(c[i]) for c in cols)
                acc[key] = acc.get(key, 0) + int(diff[i])
            return {k: n for k, n in acc.items() if n}

        out = []
        for sub in (early, mid):
            state, seen = {}, []
            end = _time.monotonic() + 60.0
            while sub.frontier < final:
                assert _time.monotonic() < end
                if not sub.wait(1.0):
                    continue
                for chunk in sub.pop_ready():
                    state = _apply(state, [chunk])
                    assert state == oracle_at(chunk[2]), f"{pkg} diverged at {chunk[2]}"
                    seen.append((chunk[2] - base, sorted(state.items())))
            assert state == oracle_at(final)
            out.append((sorted(state.items()), seen[-1]))
        early.close()
        mid.close()
        return out

    both(clusters, scen)


def test_as_of_subscribe_snapshots_at_exact_time(clusters):
    def scen(pkg, coord):
        coord.execute("CREATE TABLE ao (x BIGINT NOT NULL)")
        coord.execute("INSERT INTO ao VALUES (1)")
        t1 = coord._table_writers["ao"].upper - 1
        coord.execute("INSERT INTO ao VALUES (2)")
        sub = coord.execute(f"SUBSCRIBE ao AS OF {t1}").subscription
        events, _f = sub.poll(timeout=30)
        snap = [(e[0], e[-1]) for e in events if e[-2] == t1]
        state = _apply({}, [("deltas", events, sub.frontier, 0.0)])
        state = _drain_until(sub, coord._table_writers["ao"].upper, state=state)
        sub.close()
        return snap, state

    assert both(clusters, scen) == ([(1, 1)], {(1,): 1, (2,): 1})


def test_resume_across_coordinator_restart(clusters):
    """Deliveries before a coordinator restart plus a resumed session's
    after it equal one replay of the durable shard: no duplicate, no
    loss."""

    def scen(pkg, _coord):
        cl = clusters[pkg]
        coord = _new_main(cl)
        coord.execute("CREATE TABLE src (x BIGINT NOT NULL)")
        coord.execute("CREATE MATERIALIZED VIEW rmv AS SELECT x, count(*) FROM src GROUP BY x")
        coord.execute("INSERT INTO src VALUES (1), (1), (2)")
        sub = coord.execute("SUBSCRIBE rmv").subscription
        pre_events, pre_frontier = sub.poll(timeout=60)
        pre_state = _apply({}, [("deltas", pre_events, pre_frontier, 0.0)])
        sub.close()
        coord.shutdown()
        cl.coords.remove(coord)
        coord2 = _new_main(cl)
        coord2.execute("INSERT INTO src VALUES (2), (3)")
        sub2 = coord2.subscribe_hub.resume("rmv", pre_frontier)
        want = {(1, 2), (2, 2), (3, 1)}
        state = dict(pre_state)
        end = _time.monotonic() + 90.0
        while not (set(state) == want and all(n == 1 for n in state.values())):
            assert _time.monotonic() < end, state
            if sub2.wait(1.0):
                state = _apply(state, sub2.pop_ready())
        shard = coord2.catalog.items["rmv"].definition["shard"]
        reader = coord2.persist.open_reader(shard, "test-replay")
        try:
            upper = coord2.persist.machine(shard).reload().upper
            _s, cols, _n, _tm, diff = reader.snapshot(upper - 1)
        finally:
            reader.expire()
        replay: dict = {}
        for i in range(len(diff)):
            key = tuple(int(c[i]) for c in cols)
            replay[key] = replay.get(key, 0) + int(diff[i])
        sub2.close()
        return pre_state, state, {k: n for k, n in replay.items() if n}

    pre, state, replay = both(clusters, scen)
    assert state == replay and pre in ({(1, 2): 1, (2, 1): 1}, {})


def test_admission_sheds_with_server_busy(clusters):
    def scen(pkg, coord):
        busy = mod(pkg, "coord.peek").ServerBusy
        coord.execute("CREATE TABLE ad (x BIGINT NOT NULL)")
        coord.execute("INSERT INTO ad VALUES (1)")
        sheds = coord.subscribe_hub.stats["sheds"]
        coord.update_config({"subscribe_max_sessions": 2})
        s1 = coord.execute("SUBSCRIBE ad").subscription
        s2 = coord.execute("SUBSCRIBE ad").subscription
        with pytest.raises(busy) as e:
            coord.execute("SUBSCRIBE ad")
        out = [str(e.value), coord.subscribe_hub.stats["sheds"] - sheds]
        s1.close()
        s3 = coord.execute("SUBSCRIBE ad").subscription
        out.append(coord.subscribe_hub.session_count())
        s2.close()
        s3.close()
        return out

    out = both(clusters, scen)
    assert out[1:] == [1, 2] and "subscribe_max_sessions" in out[0]


@pytest.mark.parametrize("policy", ["disconnect", "coalesce"])
def test_slow_consumer_policies(clusters, policy):
    """A consumer that reads nothing while the table takes 12 single-row
    windows, with the queue bound at 3 rows: the tail fans every window
    out first (the test waits for its frontier), then the consumer
    reads. Disconnect: the read raises SubscriptionLagging and the hub
    has reaped the session. Coalesce: one snapshot chunk of the exact
    state replaces the backlog and the session lives on."""

    def scen(pkg, coord):
        lagging = mod(pkg, "coord.subscribe").SubscriptionLagging
        name = f"sl_{policy}"
        coord.execute(f"CREATE TABLE {name} (x BIGINT NOT NULL)")
        base = coord._table_writers[name].upper
        coord.execute(f"INSERT INTO {name} VALUES (0)")
        sub = coord.execute(f"SUBSCRIBE {name}").subscription
        first = _drain_until(sub, coord._table_writers[name].upper)
        coord.update_config({"subscribe_queue_depth": 3, "subscribe_slow_policy": policy})
        for i in range(12):
            coord.execute(f"INSERT INTO {name} VALUES ({i + 1})")
        final = coord._table_writers[name].upper
        _until(lambda: sub.tail.frontier >= final or sub.closed, msg="the tail's fan-out")
        out = [first, sub.sheds >= 1]
        if policy == "disconnect":
            with pytest.raises(lagging) as e:
                sub.pop_ready()
            out += ["re-subscribe" in str(e.value), sub.closed,
                    coord.subscribe_hub.session_count()]
        else:
            chunks = sub.pop_ready()
            out += [[c[0] for c in chunks][:1], _apply({}, chunks), sub.closed,
                    sub.frontier - base]
            sub.close()
        return out

    out = both(clusters, scen)
    assert out[:2] == [{(0,): 1}, True]
    if policy == "disconnect":
        assert out[2:] == [True, True, 0]
    else:
        assert out[2] == ["snapshot"] and out[3] == {(i,): 1 for i in range(13)}
        assert out[4] is False


def test_drop_closes_tailing_and_query_sessions(clusters):
    def scen(pkg, coord):
        hub = coord.subscribe_hub
        coord.execute("CREATE TABLE dr (x BIGINT NOT NULL)")
        coord.execute("INSERT INTO dr VALUES (5)")
        base = dict(hub.stats)
        tail_sub = coord.execute("SUBSCRIBE dr").subscription
        query_sub = coord.execute("SUBSCRIBE TO (SELECT x FROM dr WHERE x >= 0)").subscription
        upper = coord._table_writers["dr"].upper
        out = [_drain_until(tail_sub, upper), _drain_until(query_sub, upper),
               hub.stats["installs"] - base["installs"]]
        coord.execute("DROP TABLE dr")
        _until(lambda: tail_sub.closed and query_sub.closed, msg="sessions closed")
        out += [hub.session_count(), tail_sub.poll(timeout=0.1),
                hub.stats["drops"] - base["drops"], _sub_dataflows(coord)]
        return out

    assert both(clusters, scen) == [{(5,): 1}, {(5,): 1}, 1, 0, None, 1, []]


def test_shutdown_reaps_sessions_and_readers(clusters):
    def scen(pkg, _coord):
        cl = clusters[pkg]
        coord = _new_main(cl)
        coord.execute("CREATE TABLE sh (x BIGINT NOT NULL)")
        coord.execute("INSERT INTO sh VALUES (1)")
        sql = "SUBSCRIBE TO (SELECT x FROM sh WHERE x >= 0)"
        subs = [coord.execute(sql).subscription for _ in range(3)]
        subs.append(coord.execute("SUBSCRIBE sh").subscription)
        coord.shutdown()
        cl.coords.remove(coord)
        holds = {shard: [r for r, _s in m.reload().reader_holds if r.startswith("subtail-")]
                 for shard, m in coord.persist._machines.items()}
        _new_main(cl)
        return ([s.closed for s in subs], coord.subscribe_hub.session_count(),
                [h for h in holds.values() if h])

    assert both(clusters, scen) == ([True] * 4, 0, [])


def test_mz_subscriptions_and_metrics(clusters):
    def scen(pkg, coord):
        coord.execute("CREATE TABLE mzs (x BIGINT NOT NULL)")
        coord.execute("INSERT INTO mzs VALUES (1)")
        out = [coord.execute("SELECT count(*) FROM mz_subscriptions").rows]
        s1 = coord.execute("SUBSCRIBE mzs").subscription
        s2 = coord.execute("SUBSCRIBE mzs").subscription
        _drain_until(s1, coord._table_writers["mzs"].upper)
        rows = coord.execute("SELECT session, dataflow, sharers FROM mz_subscriptions").rows
        out.append(sorted((r[1], r[2]) for r in rows))
        by_sid = {int(r[0]): int(r[1]) for r in coord.execute(
            "SELECT session, delivered FROM mz_subscriptions").rows}
        out.append(by_sid[s1.session_id] >= 1)
        text = mod(pkg, "utils.metrics").REGISTRY.expose_text()
        out.append(all(m in text for m in ("mz_subscribe_sessions_total",
                                           "mz_subscribe_readbacks_total")))
        s1.close()
        s2.close()
        out.append(coord.execute("SELECT count(*) FROM mz_subscriptions").rows)
        return out

    assert both(clusters, scen) == [[(0,)], [("mzs", 2), ("mzs", 2)], True, True, [(0,)]]


def test_port_query_subscription_over_an_index_gets_its_snapshot(clusters):
    """A query subscription whose plan imports an index, installed while
    the index's publisher has absorbed only its snapshot (upper 1): the
    port hydrates it from the publisher's arrangement, so its first
    chunk is the view's state (the reference's replays from 0 and loses
    it, ROADMAP Queue 3)."""
    coord = clusters["port"].main
    coord.execute("CREATE SOURCE isrc FROM LOAD GENERATOR TPCH (SCALE FACTOR 0.001, "
                  "CHURN ORDERS 8)")
    coord.execute("CREATE VIEW iol AS SELECT l_orderkey, count(*) AS lines FROM lineitem "
                  "GROUP BY l_orderkey")
    coord.execute("CREATE INDEX iol_idx ON iol (l_orderkey)")
    want = {tuple(r): 1 for r in coord.execute("SELECT * FROM iol WHERE l_orderkey <= 100").rows}
    sub = coord.execute("SUBSCRIBE TO (SELECT l_orderkey, lines FROM iol "
                        "WHERE l_orderkey <= 100)").subscription
    try:
        assert coord.sources["isrc"].t == 1 and len(want) == 100
        assert _drain_until(sub, 1) == want
    finally:
        sub.close()
        coord.execute("DROP INDEX iol_idx")
        coord.execute("DROP VIEW iol")
        coord.execute("DROP SOURCE isrc")
