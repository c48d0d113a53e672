"""Port parity for the collection aggregates (STRING_AGG, ARRAY_AGG,
LIST_AGG): the port's ``ops/reduce.py`` digest and multiset tier and the
render layer's edge finalization (``render/dataflow.py``).

1. ``ReduceOp.step`` in both packages over six ticks of one seeded
   stream (inserts, retractions, duplicates, NULL elements, a group
   whose values are all NULL, a group that dies), a STRING_AGG, an
   ARRAY_AGG and a LIST_AGG beside a COUNT: every state part (the
   accumulators with the digest pairs, each multiset) and the output
   delta are equal after every tick, so the digests are bit-equal; each
   output row's finalized value (retractions against the multiset
   before the tick) is equal too, looked up by group key and by digest
   alone. Both packages code the strings in
   fresh dictionaries that took the same inserts.
2. One SQL script through a reference cluster and a port cluster: a
   table, a materialized view with the three aggregates over ~400 rows
   (its state tier of 256 rows overflows, rolls back, grows and
   replays), DELETE and INSERT, a string dictionary rebalance in the
   middle (the replica's string table runs a squeezed gap dry, rebalances
   and rebuilds). Every answer is equal, and so are the view's persisted
   rows (decoded). (Views over the aggregates and transient SELECTs are
   ``basic_aggs.slt``'s, below.)
3. ``tests/slt/basic_aggs.slt`` through the port's coordinator by the
   port's own SLT runner (``materialize_tpu_torch/testing/slt.py``):
   every record passes.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.test_torch_dict_rebalance import _squeeze_gap
from tests.torch_dict import port_dict_restored, reference_dict_restored  # noqa: F401
from tests.torch_serving import Cluster, deadline, mod, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_dict_restored")

PKGS = ("ref", "port")
CAP = 1024
POOL = ("", "a", "ab", "b", "ba", "c", "zz")


def _schema(pkg):
    S = mod(pkg, "repr.schema")
    C, T = S.Column, S.ColumnType
    return S.Schema([C("k", T.INT64, True), C("s", T.STRING, True), C("n", T.INT64, True)])


def _aggs(pkg):
    rel, sc = mod(pkg, "expr.relation"), mod(pkg, "expr.scalar")
    A, F = rel.AggregateExpr, rel.AggregateFunc
    return (A(F.STRING_AGG, sc.col(1), params=(",",)), A(F.COUNT, sc.lit(True)),
            A(F.ARRAY_AGG, sc.col(2)), A(F.LIST_AGG, sc.col(1)))


def _ticks(codes: dict):
    """Six ticks of (k, k_null, s, s_null, n, n_null, diff), each drawn
    against the live multiset the earlier ticks left."""
    rng = np.random.default_rng(31)
    live: dict = {}

    def insert(m, keys, null_rate=0.25):
        out = []
        for _ in range(m):
            k = int(rng.choice(keys))
            s = None if rng.random() < null_rate else POOL[int(rng.integers(len(POOL)))]
            n = None if rng.random() < null_rate else int(rng.integers(-3, 4))
            out.append(((k, s, n), int(rng.choice([1, 1, 2]))))
        return out

    def retract(frac):
        rows = [r for r, c in live.items() if c > 0]
        pick = rng.random(len(rows)) < frac
        return [(r, -1) for r, p in zip(rows, pick) if p]

    plans = [
        lambda: insert(60, [1, 2, 3, 4, -1]),
        lambda: retract(0.3) + insert(20, [1, 2, 5]),
        lambda: insert(12, [6], null_rate=1.0),  # a group of NULLs only
        lambda: [(r, -c) for r, c in live.items() if c > 0 and r[0] == 4],  # dies
        lambda: retract(0.5),
        lambda: insert(30, [1, 2, 3, 5, 6, -1]),
    ]
    out = []
    for plan in plans:
        rows = plan()
        for r, d in rows:
            live[r] = live.get(r, 0) + d
        k = np.array([r[0] for r, _ in rows])
        s = [r[1] for r, _ in rows]
        n = [r[2] for r, _ in rows]
        out.append((
            np.where(k < 0, 0, k), k < 0,
            np.array([codes[x] if x is not None else 0 for x in s], np.int64),
            np.array([x is None for x in s]),
            np.array([0 if x is None else x for x in n], np.int64),
            np.array([x is None for x in n]),
            np.array([d for _, d in rows], np.int64),
        ))
    return out


def _finalizer(pkg, op, state, keyed=True):
    """A rendered dataflow's finalization surface over one reduce state:
    the Dataflow class without a plan, holding the op's state in slot 0,
    every output column of a basic aggregate finalized by group key (or,
    not ``keyed``, by digest alone, as where a plan projects the key
    away)."""
    df = object.__new__(mod(pkg, "render.dataflow").Dataflow)
    df.states = [state]
    df._basic_finalizers = [
        (op.n_key + j, 0, 1 + len(op.hier_aggs) + b, agg,
         agg.expr.typ(op.input_schema), tuple(range(op.n_key)) if keyed else None)
        for b, (j, agg) in enumerate(op.basic_aggs)
    ]
    assert len(df._basic_finalizers) == 3
    return df


def _host(b, pkg):
    n = int(b.count)
    if pkg == "ref":
        cols = [np.asarray(c)[:n] for c in b.cols]
        nulls = [None if x is None else np.asarray(x)[:n] for x in b.nulls]
        return n, cols, nulls, np.asarray(b.diff)[:n], np.asarray(b.time)[:n].view(np.int64)
    cols = [c[:n].numpy() for c in b.cols]
    nulls = [None if x is None else x[:n].numpy() for x in b.nulls]
    return n, cols, nulls, b.diff[:n].numpy(), b.time[:n].numpy()


def _same(jb, tb):
    jn, jc, jnl, jd, jt = _host(jb, "ref")
    tn, tc, tnl, td, tt = _host(tb, "port")
    assert jn == tn
    for a, b in zip(jc, tc):
        assert np.array_equal(a, b)
    assert np.array_equal(jd, td) and np.array_equal(jt, tt)
    for a, b in zip(jnl, tnl):
        assert (a is None) == (b is None)
        assert a is None or np.array_equal(a, b)


def test_basic_reduce_steps_match_reference(monkeypatch):
    dicts = {p: mod(p, "repr.schema").StringDictionary() for p in PKGS}
    codes = {p: {s: dicts[p].encode(s) for s in POOL} for p in PKGS}
    assert codes["ref"] == codes["port"]
    for p in PKGS:  # finalization decodes in the fresh dictionaries
        monkeypatch.setattr(mod(p, "repr.schema"), "GLOBAL_DICT", dicts[p])
    ops = {p: mod(p, "ops.reduce").ReduceOp(_schema(p), (0,), _aggs(p)) for p in PKGS}
    jop, top = ops["ref"], ops["port"]
    for attr in ("state_schema", "out_schema"):
        assert [c.name for c in getattr(top, attr).columns] == [
            c.name for c in getattr(jop, attr).columns]
    assert [sch.columns[-1].nullable for sch in top.basic_schemas] == [False, True, True]
    jstep = jax.jit(jop.step)
    jstate, tstate = jop.init_state(CAP), top.init_state(CAP, device="cpu")
    finalized = []
    for t, (k, kn, s, sn, n, nn, diff) in enumerate(_ticks(codes["port"]), start=1):
        time = np.full(len(diff), t, np.uint64)
        cols, nulls = [k, s, n], [kn, sn, nn]
        jb = mod("ref", "repr.batch").Batch.from_numpy(_schema("ref"), cols, time, diff,
                                                       capacity=CAP, nulls=nulls)
        tb = mod("port", "repr.batch").Batch.from_numpy(_schema("port"), cols, time, diff,
                                                        capacity=CAP, nulls=nulls,
                                                        device="cpu")
        jold = _finalizer("ref", jop, jstate).capture_basic_multisets()
        told = _finalizer("port", top, tstate).capture_basic_multisets()
        jstate, jout, jovf = jstep(jstate, jb, jnp.asarray(t, jnp.uint64))
        tstate, tout, tovf = top.step(tstate, tb, t)
        assert {p: bool(f) for p, f in jovf.items()} == {p: bool(f) for p, f in tovf.items()}
        assert not any(bool(f) for f in tovf.values())
        for jp, tp in zip(jstate, tstate):
            _same(jp.batch, tp.batch)
        _same(jout, tout)  # the digests, bit for bit
        got = {}
        for keyed in (True, False):
            for p, op, st, out, old in (("ref", jop, jstate, jout, jold),
                                        ("port", top, tstate, tout, told)):
                _n, c, nl, d, _t = _host(out, p)
                fin = _finalizer(p, op, st, keyed).finalize_basic_columns(
                    c, nl, diffs=d, old_multisets=old)
                got[p, keyed] = [tuple(row) for row in zip(*[list(x) for x in fin],
                                                           d.tolist())]
            assert got["port", keyed] == got["ref", keyed]
        assert got["port", False] == got["port", True]
        got = {"port": got["port", True]}
        finalized += [(t, r) for r in got["port"]]
    # The stream reaches every case: NULL elements kept by array_agg and
    # list_agg, a NULL string_agg (a group of NULLs only), duplicates,
    # and retractions finalized against the earlier multiset.
    nulls_only = [r for t, r in finalized if t == 3 and r[0] == 6]
    assert len(nulls_only) == 1 and nulls_only[0][1] is None
    assert nulls_only[0][3] == nulls_only[0][4] == "{" + ",".join(["NULL"] * nulls_only[0][2]) + "}"
    assert any(r[-1] < 0 for _t, r in finalized)
    # NULL elements sort first, beside values.
    assert any(r[3].startswith("{NULL,") and not r[3].endswith("NULL}")
               for _t, r in finalized if r[3])


def _scenario(pkg: str, root: str) -> tuple:
    cl = Cluster(pkg, root)
    S = mod(pkg, "repr.schema")
    rng = np.random.default_rng(5)
    words = ("rbza", "rbzc", "abc", "abd", "x", "y")
    try:
        c = cl.coordinator()
        out = []

        def rows(sql):
            out.append(sorted(c.execute(sql).rows, key=repr))

        c.execute("CREATE TABLE bt (k bigint NOT NULL, s text, n bigint)")
        vals = ", ".join(
            f"({int(rng.integers(0, 40))}, "
            f"{'NULL' if rng.random() < 0.1 else repr(words[int(rng.integers(len(words)))])}, "
            f"{'NULL' if rng.random() < 0.1 else int(rng.integers(-50, 50))})"
            for _ in range(420))
        c.execute(f"INSERT INTO bt VALUES {vals}")
        c.execute("CREATE MATERIALIZED VIEW bmv AS SELECT k, string_agg(s, ',') AS f, "
                  "array_agg(n) AS a, list_agg(s) AS l, count(*) AS c FROM bt GROUP BY k")
        rows("SELECT * FROM bmv")
        c.execute("DELETE FROM bt WHERE n < -20")
        c.execute("INSERT INTO bt VALUES (3, 'abcd', 7), (41, NULL, NULL), (3, 'rbzb', 1)")
        rows("SELECT * FROM bmv")
        # upper('rbza') lands in a squeezed gap: the replica's string
        # table runs it dry, rebalances the dictionary and rebuilds.
        epoch = S.GLOBAL_DICT.epoch
        _squeeze_gap(S.GLOBAL_DICT, "RBZ", "RBZB")
        rows("SELECT upper(s) FROM bt WHERE s = 'rbza'")
        assert S.GLOBAL_DICT.epoch > epoch, pkg
        rows("SELECT * FROM bmv")
        c.execute("INSERT INTO bt VALUES (3, 'abcc', 2), (7, 'rbzbb', 3)")
        rows("SELECT * FROM bmv")
        shard = c.catalog.items["bmv"].definition["shard"]
        reader = c.persist.open_reader(shard)
        upper = reader.machine.reload().upper
        _sch, cols, nulls, _time, diff = reader.snapshot(upper - 1)
        persisted = {}
        for i in range(len(diff)):
            row = tuple(
                None if nulls[j] is not None and nulls[j][i]
                else S.GLOBAL_DICT.decode(int(cols[j][i])) if j in (1, 2, 3)
                else int(cols[j][i])
                for j in range(len(cols)))
            persisted[row] = persisted.get(row, 0) + int(diff[i])
        reader.expire()
        grown = None
        if pkg == "port":
            grown = list(cl._handle[0].dataflows["bmv"].view.df._grown)
        return out, {r: d for r, d in persisted.items() if d}, grown
    finally:
        cl.shutdown()


def test_basic_aggregates_serve_like_the_reference(tmp_path):
    got = {p: _scenario(p, str(tmp_path / p)) for p in PKGS}
    (jout, jpersisted, _), (tout, tpersisted, grown) = got["ref"], got["port"]
    assert tout == jout
    assert tpersisted == jpersisted and len(tpersisted) == 41
    assert set(tpersisted.values()) == {1}
    # The view's multiset outgrew its first state tier: rolled back,
    # grown and replayed on the port's replica.
    assert any(k[0] == "state" for k in grown), grown
    # Elements in string order, across the rebalance.
    k3 = [r for r in tout[-1] if r[0] == 3][0]
    assert k3[1] == "abcc,abcd,rbzb,rbzc,rbzc,y,y"


def test_basic_aggs_slt_passes_on_the_port(tmp_path):
    from materialize_tpu_torch.testing.slt import parse_slt, run_slt_file

    path = os.path.join(os.path.dirname(__file__), "slt", "basic_aggs.slt")
    cl = Cluster("port", str(tmp_path))
    try:
        with open(path) as f:
            n = len(parse_slt(f.read()))
        assert run_slt_file(path, cl.coordinator()) == n == 28
    finally:
        cl.shutdown()


def test_source_codes_survive_the_rebalance_a_sink_forces(tmp_path):
    """``order_flags`` (``chip_smoke.py``'s deploy view) on an in-process
    cluster: its sink codes every result string in the process's
    dictionary, whose labels between strings such as 'A,A,A,A,A,A' and
    'A,A,A,A,A,A,R' run dry (here a squeezed gap), so the replica
    rebalances and rebuilds. The
    TPC-H source in the same process then writes codes of the relabelled
    dictionary (the reference's generator keeps its first codes and
    fails to encode its next part), and the view equals the oracle,
    read through the coordinator and through the replica's peek
    fallback (``coord/peek.py``), which finalizes the rows it returns."""
    import chip_smoke as cs
    from materialize_tpu_torch.repr.schema import GLOBAL_DICT

    cl = Cluster("port", str(tmp_path))
    try:
        c = cl.coordinator()
        c.execute("CREATE SOURCE tpch FROM LOAD GENERATOR TPCH "
                  "(SCALE FACTOR 0.002, CHURN ORDERS 64)")
        # Where the labels run dry is up to what the dictionary holds:
        # squeeze the gap around 'A,A,A,A' so that it does here.
        epoch = GLOBAL_DICT.epoch
        _squeeze_gap(GLOBAL_DICT, "A,A,A", "A,A,A,R")
        c.execute(cs.ORDER_FLAGS_SQL)
        c.execute("SELECT * FROM order_flags WHERE l_orderkey = 1")
        assert GLOBAL_DICT.epoch > epoch
        src = c.sources["tpch"]
        for _ in range(3):
            src.tick_once()
        rows = [tuple(str(v) for v in r) for r in c.execute("SELECT * FROM order_flags").rows]
        _gen, snap, churn = cs._serve_oracle_parts(0.002, 64, src.t - 1)
        want = cs._order_flags_oracle(snap + churn)
        cs._check_order_flags(rows, want, "order_flags after the rebalance")
        # The replica's peek fallback finalizes the rows it returns too.
        view = cl._handle[0].dataflows["order_flags"].view
        keys = sorted(want, key=int)[:3]
        groups = mod("port", "coord.peek").serve_peek_groups(
            view, {"scan": False, "bound_cols": (0,), "probes": [(int(k),) for k in keys]})
        assert [[tuple(str(v) for v in r[:4]) for r in g] for g in groups] == [
            [(k,) + want[k]] for k in keys]
    finally:
        cl.shutdown()
