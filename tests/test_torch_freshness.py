"""Port parity for the freshness plane, the background compactor and
the autoscaler's brain.

Each case of ``tests/test_freshness.py`` (the lag recorder, the status
board, lag-ranked routing, the live relations, the readiness verdict,
SUBSCRIBE's delivery lag), the compactor cases of
``tests/test_compactor.py`` (the lease, the fenced swap, the
request-only tick path) and the autoscaler policy and brain cases of
``tests/test_failover.py`` runs as one scenario through both packages
(``materialize_tpu`` under JAX on the CPU, ``materialize_tpu_torch``
with ``device="cpu"``); the two outcomes must be equal. Wall-clock
values (lags, timestamps, durations) are not compared between the
packages, only what they count and rank.
"""

from __future__ import annotations

import math
import os
import random
import threading
import time as _time

import numpy as np
import pytest

from tests.torch_dict import reference_dict_restored  # noqa: F401
from tests.torch_serving import Cluster, deadline, mod, one_torch_thread  # noqa: F401

PKGS = ("ref", "port")


def both(scenario):
    """``scenario(pkg)`` for each package; the outcomes must be equal."""
    out = {pkg: scenario(pkg) for pkg in PKGS}
    assert out["port"] == out["ref"]
    return out["port"]


def _until(pred, timeout: float = 30.0, msg: str = "condition"):
    end = _time.monotonic() + timeout
    while _time.monotonic() < end:
        v = pred()
        if v:
            return v
        _time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


@pytest.fixture(autouse=True)
def _reset_process_state():
    yield
    for pkg in PKGS:
        mod(pkg, "utils.dyncfg").COMPUTE_CONFIGS.update(
            {"freshness_slo_ms": None, "autoscale_policy": "", "compaction_mode": None})
        mod(pkg, "coord.autoscaler").AUTOSCALE.clear()
        mod(pkg, "storage.persist.compactor").reset_compaction_service()
        mod(pkg, "storage.persist.compactor").STATS.reset()


# -- the lag recorder -------------------------------------------------------------


def test_lag_ms_is_the_definition():
    def scen(pkg):
        lag_ms = mod(pkg, "coord.freshness").lag_ms
        return (lag_ms(10.0, 10.5), lag_ms(3.0, 3.0), lag_ms(_time.monotonic() + 100.0))

    assert both(scen) == (500.0, 0.0, 0.0)


def test_history_ring_bounded_under_churn():
    def scen(pkg):
        fr = mod(pkg, "coord.freshness")
        rec = fr.FreshnessRecorder()
        n = 2 * fr.HISTORY_CAPACITY + 37
        for i in range(n):
            rec.record(f"df{i % 5}", "r0", i, float(i % 97))
        rows = rec.history_rows()
        windows = sorted((k, len(w)) for k, w in rec._windows.items())
        for _ in range(2 * fr.EVENTS_CAPACITY):
            rec.record_event("obj", "r0", "hydration_stall")
        return ([r[:4] for r in rows[-3:]], len(rows), windows,
                sorted((k, s["samples"], s["p50_ms"]) for k, s in rec.summary().items()),
                len(rec.events_rows()), fr.HISTORY_CAPACITY, fr.WINDOW_PER_KEY)

    out = both(scen)
    assert out[1] == out[5] and out[0][-1][2] == 2 * out[5] + 36
    assert all(n <= out[6] for _k, n in out[2])


def test_quantile_rollup_matches_bruteforce():
    rng = random.Random(7)
    vals = [rng.uniform(0.0, 500.0) for _ in range(1377)]

    def scen(pkg):
        fr = mod(pkg, "coord.freshness")
        rec = fr.FreshnessRecorder()
        for i, v in enumerate(vals):
            rec.record("qdf", "r0", i, v)
        s = rec.summary()[("qdf", "r0")]
        edges = (fr.quantile([], 0.5), fr.quantile([3.0], 0.99),
                 fr.quantile([1.0, 2.0], -1.0), fr.quantile([1.0, 2.0], 2.0))
        return {k: s[k] for k in ("samples", "p50_ms", "p90_ms", "p99_ms", "max_ms",
                                  "last_ms", "frontier")}, edges

    s, edges = both(scen)
    window = sorted(vals[-512:])

    def brute(q):
        return window[min(len(window) - 1, math.ceil(q * len(window)) - 1)]

    assert s["samples"] == 512 and s["p50_ms"] == brute(0.5) and s["p99_ms"] == brute(0.99)
    assert s["max_ms"] == window[-1] and s["last_ms"] == vals[-1]
    assert edges == (0.0, 3.0, 1.0, 2.0)


def test_wire_roundtrip_and_pid_dedupe():
    def scen(pkg):
        fr = mod(pkg, "coord.freshness")
        rec = fr.FreshnessRecorder()
        rec.enable_ship()
        rec.record("wd", "r1", 3, 7.5)
        wire = rec.drain_shippable()
        again = rec.drain_shippable()
        r = fr.LagRecord.from_wire(wire[0])
        other = fr.FreshnessRecorder()
        other.ingest(wire, process="r1")
        same_pid = other.history_rows()
        other.ingest([w[:5] + (w[5] + 1,) for w in wire], process="r1")
        return (len(wire), again, (r.dataflow, r.replica, r.frontier, r.lag_ms),
                r.pid == os.getpid(), same_pid, [row[:4] for row in other.history_rows()],
                other.latest("wd")["r1"][0])

    assert both(scen) == (1, [], ("wd", "r1", 3, 7.5), True, [], [("wd", "r1", 3, 7.5)], 3)


def test_slo_breach_counts_samples_events_record_onsets():
    def scen(pkg):
        fr = mod(pkg, "coord.freshness")
        cfg = mod(pkg, "utils.dyncfg").COMPUTE_CONFIGS
        cfg.update({"freshness_slo_ms": 5.0})
        rec = fr.FreshnessRecorder()
        before = fr.breaches_total().value
        for f, lag in ((1, 10.0), (2, 11.0), (3, 1.0), (4, 12.0)):
            rec.record("slo_df", "r0", f, lag)
        counted = fr.breaches_total().value - before
        events = [(obj, kind) for obj, _r, kind, _lag, _at in rec.events_rows()]
        breaching = rec.breaching()
        cfg.update({"freshness_slo_ms": None})
        before = fr.breaches_total().value
        rec.record("slo_df", "r0", 5, 99999.0)
        return (counted, events, breaching, fr.breaches_total().value - before,
                len(rec.events_rows()), rec.breaching())

    assert both(scen) == (3, [("slo_df", "slo_breach")] * 2, {("slo_df", "r0")}, 0, 2, set())


# -- the status board and lag-ranked routing ----------------------------------------


def test_status_board_transitions():
    def scen(pkg):
        b = mod(pkg, "coord.freshness").StatusBoard()
        key = ("df", "r0")
        b.seed(key)
        out = [b.status(key)]
        b.seed(key, "hydrated")
        out.append(b.status(key))
        b.transition(key, "hydrating", attempts=1)
        b.transition(key, "stalled", attempts=3, error="boom")
        e = b.get(key)
        out.append((e["status"], e["attempts"], e["error"]))
        b.transition(key, "hydrated")
        e = b.get(key)
        out.append((e["status"], e["attempts"], e["error"], [s for s, _ in e["history"]]))
        ts = [at for _s, at in e["history"]]
        out.append(ts == sorted(ts))
        with pytest.raises(AssertionError):
            b.transition(("d", "r"), "exploded")
        for k in (("a", "r0"), ("a", "r1"), ("b", "r0")):
            b.seed(k)
        out.append([k for k, *_ in b.rows()])
        b.forget_replica("r0")
        out.append([k for k, *_ in b.rows()])
        b.forget_dataflow("a")
        out.append(b.rows())
        return out

    out = both(scen)
    assert out[3] == ("hydrated", 3, "boom", ["pending", "hydrating", "stalled", "hydrated"])


def test_routing_ranks_replicas_by_lag():
    class _RC:
        def __init__(self, up=True):
            self.connected = threading.Event()
            if up:
                self.connected.set()

        def send(self, cmd):
            pass

        def stop(self):
            pass

    def scen(pkg):
        fresh = mod(pkg, "coord.freshness").FRESHNESS
        ctl = mod(pkg, "coord.controller").ComputeController()
        try:
            ctl.replicas.update({"ra": _RC(), "rb": _RC(), "rc": _RC(up=False)})
            for i in range(4):
                fresh.record("lld_df", "ra", i, 50.0)
                fresh.record("lld_df", "rb", i, 5.0)
                fresh.record("lld_df", "rc", i, 0.1)  # fastest, disconnected
            out = [ctl.least_lagged_replica("lld_df"), ctl.route_candidates("lld_df"),
                   ctl.least_lagged_replica("lld_other")]
            with ctl._lock:
                ctl.frontiers["lld_other"] = {"ra": 1, "rb": 7}
            out.append(ctl.least_lagged_replica("lld_other"))
            ctl.replicas.clear()
            out.append(ctl.least_lagged_replica("lld_df"))
            return out
        finally:
            ctl.replicas.clear()
            ctl.shutdown()
            fresh.forget("lld_df")
            fresh.forget("lld_other")

    assert both(scen) == ["rb", ["rb", "ra"], "ra", "rb", None]


# -- live surfaces over a cluster of each package -----------------------------------


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    """{package: coordinator}, each over its own in-process cluster."""
    up = {}
    try:
        for pkg in PKGS:
            cl = Cluster(pkg, str(tmp_path_factory.mktemp(f"fresh-{pkg}")))
            up[pkg] = (cl, cl.coordinator())
        yield {pkg: c for pkg, (_cl, c) in up.items()}
    finally:
        for cl, _c in up.values():
            cl.shutdown()


def test_relations_serve_and_agree_with_recorder(clusters):
    def scen(pkg):
        coord = clusters[pkg]
        schemas = mod(pkg, "coord.introspection").INTROSPECTION_SCHEMAS
        coord.execute("CREATE TABLE ft (k BIGINT NOT NULL, v BIGINT NOT NULL)")
        coord.execute("INSERT INTO ft VALUES (1, 10), (2, 20)")
        coord.execute("CREATE SOURCE fsrc FROM LOAD GENERATOR counter")
        coord.execute("CREATE MATERIALIZED VIEW fmv AS SELECT k, v FROM ft")
        out = {"fmv": sorted(coord.execute("SELECT k, v FROM fmv").rows)}
        for i in range(3, 6):
            coord.execute(f"INSERT INTO ft VALUES ({i}, {i * 10})")
        out["arity"] = {
            rel: (len(coord.execute(f"SELECT * FROM {rel}").columns), schemas[rel].arity)
            for rel in ("mz_wallclock_lag_history", "mz_wallclock_lag_summary",
                        "mz_hydration_statuses", "mz_source_statuses", "mz_sink_statuses",
                        "mz_freshness_events")}
        hist = _until(lambda: [r for r in coord.execute(
            "SELECT dataflow, replica, frontier, lag_ms FROM mz_wallclock_lag_history").rows
            if r[0] == "fmv"], msg="fmv lag history")
        assert all(r[1] == "r0" and r[2] >= 1 and r[3] >= 0.0 for r in hist)
        srow = _until(lambda: [r for r in coord.execute(
            "SELECT dataflow, replica, samples, p50_ms, p90_ms, p99_ms, max_ms "
            "FROM mz_wallclock_lag_summary").rows if r[0] == "fmv"], msg="fmv summary")[0]
        assert srow[2] >= 1 and 0.0 <= srow[3] <= srow[4] <= srow[5] <= srow[6]
        _until(lambda: ("fmv", "r0", "hydrated") in {tuple(r[:3]) for r in coord.execute(
            "SELECT dataflow, replica, status FROM mz_hydration_statuses").rows},
            msg="fmv hydrated")
        out["sources"] = sorted((r[0], r[1], r[2] in ("running", "stopped"), r[5])
                                for r in coord.execute("SELECT * FROM mz_source_statuses").rows)
        _until(lambda: any(r[0] == "fmv" and r[2] == "r0" and r[3] == "running" and r[4] > 0
                           for r in coord.execute("SELECT * FROM mz_sink_statuses").rows),
               msg="fmv sink running")
        out["least_lagged"] = coord.controller.least_lagged_replica("fmv")
        return out

    out = both(scen)
    assert out["fmv"] == [(1, 10), (2, 20)] and out["least_lagged"] == "r0"
    assert ("fsrc", "CounterAdapter", True, "") in out["sources"]


def test_health_verdict_and_slo_gate(clusters):
    def scen(pkg):
        coord = clusters[pkg]
        fresh = mod(pkg, "coord.freshness").FRESHNESS
        _until(lambda: coord.health()["ready"], msg="initial readiness")
        coord.execute("CREATE TABLE ht (x BIGINT NOT NULL)")
        coord.execute("INSERT INTO ht VALUES (1)")
        coord.execute("CREATE MATERIALIZED VIEW hmv AS SELECT x FROM ht")
        v = _until(lambda: (lambda h: h if h["ready"] else None)(coord.health()),
                   msg="hydrated readiness")
        out = [v["checks"], v["dataflows"] >= 1]
        with pytest.raises(Exception) as e:
            coord.execute("SET freshness_slo_ms = '-1'")
        out.append(type(e.value).__name__)
        coord.execute("SET freshness_slo_ms = '5'")
        fresh.record("hmv", "r0", 999, 50.0)
        v = coord.health()
        out += [v["ready"], v["checks"]["lag_under_slo"], "hmv@r0" in v["breaching"]]
        coord.execute("SET freshness_slo_ms = '0'")
        out.append(coord.health()["ready"])
        return out

    out = both(scen)
    assert out[0]["dataflows_hydrated"] and out[3:] == [False, False, True, True]


def test_subscribe_lag_shares_the_definition(clusters, monkeypatch):
    def scen(pkg):
        coord = clusters[pkg]
        fr = mod(pkg, "coord.freshness")
        coord.execute("CREATE TABLE sl (x BIGINT NOT NULL)")
        coord.execute("INSERT INTO sl VALUES (1)")
        sub = coord.execute("SUBSCRIBE sl").subscription
        monkeypatch.setattr(fr, "lag_ms", lambda since, now=None: 1234.5)
        try:
            chunks = _until(lambda: sub.pop_ready(), msg="subscribe chunk")
            return [(kind, events) for kind, events, _f, _st in chunks], sub.lag_ms
        finally:
            sub.close()

    chunks, lag = both(scen)
    assert lag == 1234.5 and chunks[0][0] == "snapshot"


# -- the background compactor ------------------------------------------------------


def _schema(pkg):
    sch = mod(pkg, "repr.schema")
    return sch.Schema([sch.Column("k", sch.ColumnType.INT64),
                       sch.Column("v", sch.ColumnType.INT64)])


def _client(pkg, **kw):
    p = mod(pkg, "storage.persist")
    return p.PersistClient(p.MemBlob(), p.MemConsensus(), **kw)


def _append_ticks(writer, n, t0=0, rows=4):
    for t in range(t0, t0 + n):
        ks = np.arange(rows, dtype=np.int64)
        writer.compare_and_append([ks, ks + t], [None, None], np.full(rows, t, np.uint64),
                                  np.ones(rows, np.int64), t, t + 1)


def _threshold(pkg):
    d = mod(pkg, "utils.dyncfg")
    return d.ARRANGEMENT_COMPACTION_BATCHES(d.COMPUTE_CONFIGS)


def test_lease_protocol():
    def scen(pkg):
        out = []
        m = _client(pkg).machine("s")
        out += [m.acquire_compaction_lease("a", 10.0, now=0.0),
                m.acquire_compaction_lease("b", 10.0, now=5.0),
                m.acquire_compaction_lease("a", 10.0, now=5.0)]
        m = _client(pkg).machine("s")
        e1 = m.acquire_compaction_lease("a", 10.0, now=0.0)
        out += [m.acquire_compaction_lease("b", 10.0, now=11.0) - e1,
                m.reload().compactor_holder]
        m = _client(pkg).machine("s")
        e1 = m.acquire_compaction_lease("a", 10.0, now=0.0)
        out.append(m.renew_compaction_lease(e1, 10.0, now=1.0))
        m.acquire_compaction_lease("b", 10.0, now=20.0)
        out.append(m.renew_compaction_lease(e1, 10.0, now=21.0))
        m = _client(pkg).machine("s")
        e1 = m.acquire_compaction_lease("a", 10.0, now=0.0)
        m.release_compaction_lease(e1)
        st = m.reload()
        out += [st.compactor_holder, st.compactor_epoch == e1,
                m.acquire_compaction_lease("b", 10.0, now=1.0) - e1]
        client = _client(pkg)
        w = client.open_writer("s", _schema(pkg))
        _append_ticks(w, 2)
        w.machine.acquire_compaction_lease("a", 7.5, now=3.0)
        st = w.machine.reload()
        rt = type(st).from_bytes(st.to_bytes())
        out += [rt == st, rt.compactor_holder, rt.lease_expires, st.to_bytes()[:0]]
        return out

    assert both(scen)[:3] == [1, None, 2]


def test_fenced_swap_and_lost_prefix():
    def scen(pkg):
        machine = mod(pkg, "storage.persist.machine")
        out = []
        w = _client(pkg).open_writer("s", _schema(pkg))
        _append_ticks(w, 3)
        m = w.machine
        e1 = m.acquire_compaction_lease("a", 10.0, now=0.0)
        st = m.reload()
        merged_key, n, _old = m._merge_parts(st, ctx="background")
        m.acquire_compaction_lease("b", 10.0, now=20.0)
        with pytest.raises(machine.CompactorFenced):
            m.swap_compacted(st.batches, merged_key, n, m._last_merge_bytes[1], epoch=e1)
        out.append(merged_key in m.reload().referenced_keys())
        w = _client(pkg).open_writer("s", _schema(pkg))
        _append_ticks(w, 3)
        m = w.machine
        st = m.reload()
        merged_key, n, _old = m._merge_parts(st, ctx="background")
        out.append(m.maybe_compact(max_batches=1, ctx="background") > 0)
        out.append(m.swap_compacted(st.batches, merged_key, n, m._last_merge_bytes[1]))
        return out

    assert both(scen) == [False, True, 0]


def test_crash_leaves_lease_held_and_successor_takes_over():
    def scen(pkg):
        comp = mod(pkg, "storage.persist.compactor")
        w = _client(pkg).open_writer("s", _schema(pkg))
        _append_ticks(w, _threshold(pkg) + 3)
        m = w.machine
        a = comp.CompactionService(holder="a", lease_s=0.05)
        a.crash_next = "merge"
        with pytest.raises(comp.CompactorCrash):
            a.compact_shard(m)
        holder = m.reload().compactor_holder
        b = comp.CompactionService(holder="b", lease_s=0.05)
        r = b.compact_shard(m)
        if "skipped" in r:
            assert r["skipped"] == "lease-held"
            _time.sleep(0.08)
            r = b.compact_shard(m)
        return holder, r["replaced"] > 0, len(m.reload().batches)

    assert both(scen) == ("a", True, 1)


@pytest.mark.parametrize("mode", ["background", "inline", "off", "bare"])
def test_tick_path_compaction_modes(mode):
    """background: the tick path only requests (zero inline merges or
    blob writes, counted); inline merges on the path; off and a bare
    client never compact. Content is untouched."""

    def scen(pkg):
        comp = mod(pkg, "storage.persist.compactor")
        cfg = mod(pkg, "utils.dyncfg").COMPUTE_CONFIGS
        comp.reset_compaction_service()
        comp.STATS.reset()
        if mode in ("inline", "off"):
            cfg.update({"compaction_mode": mode})
        client = _client(pkg, auto_compaction=mode != "bare")
        w = client.open_writer("s", _schema(pkg))
        k = _threshold(pkg)
        _append_ticks(w, 3 * k)
        drained = comp.compaction_service().drain(timeout=20.0)
        tot = comp.STATS.totals()
        _, _cols, _, _, diff = client.open_reader("s").snapshot(3 * k - 1)
        return (drained, tot["requests"] > 0, tot["merges_background"] > 0,
                tot["merges_inline"] > 0, tot["blob_writes_inline"] > 0,
                len(w.machine.reload().batches) <= k + 1, int(diff.sum()))

    out = both(scen)
    want = {"background": (True, True, True, False, False, True, 36),
            "inline": (True, False, False, True, True, True, 36),
            "off": (True, False, False, False, False, False, 36),
            "bare": (True, False, False, False, False, False, 36)}
    assert out[:6] == want[mode][:6] and out[6] == 4 * 3 * _threshold("port")


# -- the autoscaler ---------------------------------------------------------------


def test_autoscale_policy_parse():
    def scen(pkg):
        pol_cls = mod(pkg, "coord.autoscaler").AutoscalePolicy
        pol = pol_cls.parse("min=1,max=4")
        out = [(pol.min_replicas, pol.max_replicas, pol.up_sustain, pol.cooldown),
               pol_cls.parse(""), pol_cls.parse("   ")]
        for spec in ("mni=1", "min=0", "min=3,max=2", "headroom=1.5"):
            with pytest.raises(ValueError) as e:
                pol_cls.parse(spec)
            out.append(str(e.value))
        pol = pol_cls.parse("up_sustain=500ms,down_sustain=60s,cooldown=3s")
        out.append((pol.up_sustain, pol.down_sustain, pol.cooldown))
        return out

    out = both(scen)
    assert out[0] == (1, 4, 2.0, 5.0) and out[-1] == (0.5, 60.0, 3.0)


class _FakeController:
    def __init__(self, names):
        self.names = list(names)

    def replica_states(self):
        return [{"name": n, "connected": True, "state": "active", "routed": 0}
                for n in self.names]


def _brain(pkg, names, policy, script):
    """Drive the autoscaler's brain (``step(now)``) over a fake fleet:
    ``script`` is a list of (now, [(df, replica, lag), ...]) records
    before each step. Returns the actions, the fleet, the stats and the
    ledger's (action, replica, reason, evidence)."""
    auto = mod(pkg, "coord.autoscaler")
    fresh = mod(pkg, "coord.freshness").FRESHNESS
    cfg = mod(pkg, "utils.dyncfg").COMPUTE_CONFIGS
    fresh.clear()
    auto.AUTOSCALE.clear()
    cfg.update({"freshness_slo_ms": 100.0, "autoscale_policy": policy})
    ctl = _FakeController(names)
    seq = [len(names)]

    def spawn():
        rid = f"r{seq[0]}"
        seq[0] += 1
        ctl.names.append(rid)
        return rid

    try:
        sc = auto.Autoscaler(ctl, spawn, ctl.names.remove)
        acts = []
        for now, records in script:
            for df, rep, lag in records:
                fresh.record(df, rep, 1, lag)
            act = sc.step(now=now)
            acts.append(None if act is None else (act["action"], act["replica"]))
        return (acts, list(ctl.names), dict(sc.stats),
                [tuple(r[1:]) for r in auto.AUTOSCALE.rows()], sc.policy() is None)
    finally:
        fresh.clear()
        auto.AUTOSCALE.clear()


BRAIN_CASES = {
    "sustained_breach_spawns": (
        ["r0"], "min=1,max=3,up_sustain=2s,cooldown=5s",
        [(0.0, [("adf", "r0", 500.0)]), (1.9, []), (2.1, [])]),
    "cooldown_holds": (
        ["r0"], "min=1,max=3,up_sustain=1s,cooldown=10s",
        [(0.0, [("adf", "r0", 500.0)]), (1.5, []), (2.0, []), (3.5, [])]),
    "band_max_holds": (
        ["r0", "r1"], "min=1,max=2,up_sustain=1s",
        [(0.0, [("adf", "r0", 500.0)]), (1.5, [])]),
    "headroom_drains_most_lagged": (
        ["r0", "r1"], "min=1,max=3,down_sustain=2s,cooldown=0s,headroom=0.5",
        [(0.0, [("adf", "r0", 10.0), ("adf", "r1", 40.0)]), (2.5, [])]),
    "band_min_holds": (
        ["r0"], "min=1,max=3,down_sustain=1s,headroom=0.5",
        [(0.0, [("adf", "r0", 10.0)]), (1.5, [])]),
    "oscillating_never_acts": (
        ["r0", "r1"], "min=1,max=3,up_sustain=2s,down_sustain=2s,headroom=0.5",
        [(float(i), [("adf", "r0", 500.0 if i % 2 == 0 else 80.0)]) for i in range(12)]),
    "empty_policy_disables": (
        ["r0"], "", [(0.0, [("adf", "r0", 500.0)]), (5.0, []), (50.0, [])]),
    "malformed_spec_disables": (["r0"], "bogus_key=1", [(0.0, [])]),
}


@pytest.mark.parametrize("case", sorted(BRAIN_CASES))
def test_autoscaler_brain(case):
    names, policy, script = BRAIN_CASES[case]
    acts, fleet, stats, ledger, disabled = both(
        lambda pkg: _brain(pkg, names, policy, script))
    want = {
        "sustained_breach_spawns": ([None, None, ("scale_up", "r1")], ["r0", "r1"]),
        "cooldown_holds": ([None, ("scale_up", "r1"), None, None], ["r0", "r1"]),
        "band_max_holds": ([None, None], ["r0", "r1"]),
        "headroom_drains_most_lagged": ([None, ("scale_down", "r1")], ["r0"]),
        "band_min_holds": ([None, None], ["r0"]),
        "oscillating_never_acts": ([None] * 12, ["r0", "r1"]),
        "empty_policy_disables": ([None] * 3, ["r0"]),
        "malformed_spec_disables": ([None], ["r0"]),
    }[case]
    assert (acts, fleet) == want
    if case == "sustained_breach_spawns":
        assert ledger[0][:3] == ("scale_up", "r1", "sustained slo breach")
        assert "adf@r0" in ledger[0][3] and "band=1-3" in ledger[0][3]
    if case in ("cooldown_holds", "band_max_holds", "band_min_holds"):
        assert stats["holds"] >= 1
    assert disabled == (case in ("empty_policy_disables", "malformed_spec_disables"))
