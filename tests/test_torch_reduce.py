"""Port parity for the accumulable Reduce.

1. ``ReduceOp.step`` eagerly in both packages over one sequence of
   seeded numpy batches: inserts over a nullable group key, retractions,
   a group that dies, and a SUM whose running total crosses 2^62 (an err
   row +1) and comes back (-1). After every step the group state, the
   output delta and the err row must be equal (tolerance 0: integers).
2. The hierarchical path: ``ReduceOp.step`` with MAX and MIN, on the
   empty group key (Q15's global MAX) and on a nullable key beside SUM
   and COUNT, over inserts with NULL values, retractions of each group's
   current maximum and then minimum, a group of only NULL values and a
   group that dies. After every step every state part (the accumulators
   and each sorted multiset) and the output delta must be equal.
3. A ``GROUP BY l_orderkey`` dataflow at ``state_cap`` 256 on the TPC-H
   stream: its third hydrate tick overflows the state in both packages;
   both roll back, grow the state one tier and replay on that tick, and
   the maintained results stay equal through churn. One reference
   dataflow in the file (its compiles dominate the run time)."""

from __future__ import annotations

from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from materialize_tpu.expr import errors as jerrors
from materialize_tpu.expr import relation as jmir
from materialize_tpu.expr import scalar as js
from materialize_tpu.ops.reduce import ReduceOp as JReduceOp
from materialize_tpu.render.dataflow import Dataflow as JDataflow
from materialize_tpu.repr import schema as jschema
from materialize_tpu.repr.batch import Batch as JBatch
from materialize_tpu.storage.generator.tpch import LINEITEM_SCHEMA as J_LINEITEM
from materialize_tpu.storage.generator.tpch import TpchGenerator as JGen
from materialize_tpu_torch import interop
from materialize_tpu_torch.expr import relation as tmir
from materialize_tpu_torch.expr import scalar as ts
from materialize_tpu_torch.ops.reduce import ReduceOp as TReduceOp
from materialize_tpu_torch.render.dataflow import Dataflow as TDataflow
from materialize_tpu_torch.repr import schema as tschema
from materialize_tpu_torch.repr.batch import Batch as TBatch
from materialize_tpu_torch.storage.generator.tpch import LINEITEM_SCHEMA
from tests.test_torch_dataflow import _jbatch_dict


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's eager ops here are small: one intra-op thread runs them
    about as fast, and does not contend with other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

BIG = 1 << 62
CAP = 256


def _schema(mod):
    C, T = mod.Column, mod.ColumnType
    return mod.Schema([
        C("k1", T.STRING), C("k2", T.INT32, True), C("v", T.DECIMAL, True, 2),
        C("b", T.BOOL, True), C("q", T.INT64),
    ])


def _aggs(rel, sc):
    A, F = rel.AggregateExpr, rel.AggregateFunc
    return (
        A(F.SUM_INT, sc.col(2)), A(F.COUNT, sc.lit(True)), A(F.COUNT, sc.col(2)),
        A(F.ANY, sc.col(3)), A(F.ALL, sc.col(3)), A(F.SUM_INT, sc.col(4)),
    )


def _batches():
    """Five steps of (cols, nulls, diff) over groups (k1, k2)."""
    rng = np.random.default_rng(21)
    n = 80
    # key 30 only in rows 20..49, which step 2 leaves alone
    k1 = rng.choice(np.array([10, 20]), n)
    k1[20:50] = rng.choice(np.array([10, 20, 30]), 30)
    k2 = rng.integers(1, 3, n).astype(np.int32)
    k2_null = rng.random(n) < 0.2
    v = rng.integers(-10**6, 10**6, n)
    v_null = rng.random(n) < 0.2
    b = rng.random(n) < 0.5
    b_null = rng.random(n) < 0.2
    q = rng.integers(0, 100, n)
    rows = [k1, k2, v, b, q]
    nulls = [None, k2_null, v_null, b_null, None]

    def take(idx, diff, v_override=None):
        cols = [c[idx] for c in rows]
        if v_override is not None:
            cols[2] = np.full(len(idx), v_override)
        return cols, [None if m is None else m[idx] for m in nulls], np.full(len(idx), diff)

    first, second = np.arange(0, 50), np.arange(50, n)
    dying = np.nonzero((k1 == 30) & ~k2_null & (k2 == 2))[0]
    steps = [take(first, 1)]
    cols, nl, _ = take(second, 1)
    rc, rn, _ = take(first[:20], -1)
    steps.append(([np.concatenate([a, b]) for a, b in zip(cols, rc)],
                  [None if a is None else np.concatenate([a, b]) for a, b in zip(nl, rn)],
                  np.concatenate([np.ones(len(second), np.int64), -np.ones(20, np.int64)])))
    steps.append(take(dying, -1))  # the (30, 2) group dies
    big = np.array([0])
    cols, nl, _ = take(big, 1, v_override=BIG)
    nl[2] = np.array([False])
    steps.append((cols, nl, np.ones(1, np.int64)))  # crosses 2^62
    steps.append((cols, nl, -np.ones(1, np.int64)))  # re-enters
    return steps


def _collecting(step):
    """The reference step with its err sink active (jitted: one compile)."""

    def run(state, delta, time):
        with jerrors.step_scope() as errs:
            out = step(state, delta, time)
        return (*out, errs)

    return run


def _jvalid(b):
    n = int(b.count)
    return n, [np.asarray(c)[:n] for c in b.cols], [
        None if x is None else np.asarray(x)[:n] for x in b.nulls
    ], np.asarray(b.diff)[:n], np.asarray(b.time)[:n].view(np.int64)


def _tvalid(b):
    n = int(b.count)
    return n, [c[:n].numpy() for c in b.cols], [
        None if x is None else x[:n].numpy() for x in b.nulls
    ], b.diff[:n].numpy(), b.time[:n].numpy()


def _same(jb, tb):
    jn, jc, jnl, jd, jt = _jvalid(jb)
    tn, tc, tnl, td, tt = _tvalid(tb)
    assert jn == tn
    for a, b in zip(jc, tc):
        assert np.array_equal(a, b)
    assert np.array_equal(jd, td) and np.array_equal(jt, tt)
    for a, b in zip(jnl, tnl):
        assert (a is None) == (b is None)
        assert a is None or np.array_equal(a, b)


def test_reduce_op_steps_match_reference():
    jop = JReduceOp(_schema(jschema), (0, 1), _aggs(jmir, js))
    top = TReduceOp(_schema(tschema), (0, 1), _aggs(tmir, ts))
    assert [c.name for c in top.out_schema.columns] == [c.name for c in jop.out_schema.columns]
    assert [c.name for c in top.state_schema.columns] == [
        c.name for c in jop.state_schema.columns]
    jstep = jax.jit(_collecting(jop.step))
    jstate = jop.init_state(CAP)
    tstate = top.init_state(CAP, device="cpu")
    errs_seen, alive = [], []
    for t, (cols, nulls, diff) in enumerate(_batches(), start=1):
        time = np.full(len(diff), t, np.uint64)
        jb = JBatch.from_numpy(_schema(jschema), cols, time, diff, capacity=CAP, nulls=nulls)
        tb = TBatch.from_numpy(_schema(tschema), cols, time, diff, capacity=CAP,
                               nulls=nulls, device="cpu")
        jstate, jout, jovf, jerrs = jstep(jstate, jb, jnp.asarray(t, jnp.uint64))
        terrs: list = []
        tstate, tout, tovf = top.step(tstate, tb, t, terrs)
        assert bool(jovf[0]) == bool(tovf[0]) is False
        _same(jstate[0].batch, tstate[0].batch)
        _same(jout, tout)
        assert len(jerrs) == len(terrs) == 1
        _same(jerrs[0], terrs[0])
        errs_seen.append(int(terrs[0].diff[0]))
        alive.append(int(tstate[0].batch.count))
        assert int(tout.count) > 0
    # the dying group leaves the state; the big sum's err row comes and goes
    assert alive[2] == alive[1] - 1
    assert errs_seen == [0, 0, 0, 1, -1]


def test_reduce_op_refuses_unported_aggregates():
    """DISTINCT aggregates raise (the optimizer rewrites them away); the
    collection aggregates are ported: each keeps a digest pair in the
    accumulator part and a multiset part of its own
    (``tests/test_torch_basic_aggs.py`` holds them to the reference)."""
    A, F = tmir.AggregateExpr, tmir.AggregateFunc
    for func in (F.ARRAY_AGG, F.STRING_AGG, F.LIST_AGG):
        op = TReduceOp(_schema(tschema), (0,), (A(func, ts.col(4)),))
        assert [c.name for c in op.state_schema.columns][-2:] == ["__a0_mix__", "__a0_nn__"]
        assert len(op.init_state(CAP, device="cpu")) == 2
    with pytest.raises(NotImplementedError, match="DISTINCT"):
        TReduceOp(_schema(tschema), (0,), (A(F.COUNT, ts.col(4), distinct=True),))


def _mm_schema(mod):
    C, T = mod.Column, mod.ColumnType
    return mod.Schema([C("k", T.INT64, True), C("v", T.DECIMAL, True, 2),
                       C("w", T.INT64)])


def _mm_aggs(rel, sc, keyed: bool):
    A, F = rel.AggregateExpr, rel.AggregateFunc
    if not keyed:  # Q15's shape: hierarchical aggregates only
        return (A(F.MAX, sc.col(1)), A(F.MIN, sc.col(1)))
    return (A(F.SUM_INT, sc.col(2)), A(F.MAX, sc.col(1)), A(F.COUNT, sc.lit(True)),
            A(F.MIN, sc.col(1)))


def _mm_steps():
    """Six steps of (k, k_null, v, v_null, w, diff), each computed from
    the live multiset the earlier steps left: inserts with NULL values,
    retractions of every group's current MAX then MIN, a group whose
    values are all NULL, and a group that dies."""
    rng = np.random.default_rng(8)
    live: Counter = Counter()

    def emit(rows):
        for r, d in rows:
            live[r] += d
        return rows

    def insert(n, groups, null_rate=0.2):
        out = []
        for _ in range(n):
            k = int(rng.choice(groups))
            v = None if rng.random() < null_rate else int(rng.integers(-500, 500))
            out.append(((k, v, int(rng.integers(0, 9))), int(rng.choice([1, 2]))))
        return emit(out)

    def retract_extreme(pick):
        by_key: dict = {}
        for (k, v, w), c in live.items():
            if c and v is not None:
                by_key.setdefault(k, []).append(v)
        return emit([((k, v, w), -c) for (k, v, w), c in list(live.items())
                     if c and v is not None and v == pick(by_key[k])])

    steps = [
        insert(40, [1, 2, 3, -1]),  # -1 stands for the NULL key
        retract_extreme(max),
        insert(10, [4], null_rate=1.0) + insert(10, [1, 2]),
        retract_extreme(min),
        emit([(r, -c) for r, c in list(live.items()) if c and r[0] == 3]),
        insert(12, [1, 2, 3]),
    ]
    out = []
    for rows in steps:
        k = np.array([r[0] for r, _ in rows])
        v = np.array([0 if r[1] is None else r[1] for r, _ in rows])
        out.append((np.where(k < 0, 0, k), k < 0, v,
                    np.array([r[1] is None for r, _ in rows]),
                    np.array([r[2] for r, _ in rows]), np.array([d for _, d in rows])))
    return out


@pytest.mark.parametrize("keyed", [False, True], ids=["global", "keyed"])
def test_minmax_reduce_steps_match_reference(keyed):
    key = (0,) if keyed else ()
    jop = JReduceOp(_mm_schema(jschema), key, _mm_aggs(jmir, js, keyed))
    top = TReduceOp(_mm_schema(tschema), key, _mm_aggs(tmir, ts, keyed))
    assert top.plan.kind == jop.plan.kind == "Collation"
    assert [c.name for c in top.out_schema.columns] == [c.name for c in jop.out_schema.columns]
    jstep = jax.jit(jop.step)
    jstate = jop.init_state(CAP)
    tstate = top.init_state(CAP, device="cpu")
    assert len(tstate) == len(jstate) == 3
    outs = []
    for t, (k, kn, v, vn, w, diff) in enumerate(_mm_steps(), start=1):
        time = np.full(len(diff), t, np.uint64)
        args = ([k, v, w], time, diff)
        kw = dict(capacity=CAP, nulls=[kn, vn, None])
        jb = JBatch.from_numpy(_mm_schema(jschema), *args, **kw)
        tb = TBatch.from_numpy(_mm_schema(tschema), *args, device="cpu", **kw)
        jstate, jout, jovf = jstep(jstate, jb, jnp.asarray(t, jnp.uint64))
        tstate, tout, tovf = top.step(tstate, tb, t)
        assert sorted(tovf) == sorted(jovf) == [0, 1, 2]
        assert not any(bool(tovf[p]) or bool(jovf[p]) for p in tovf)
        for jp, tp in zip(jstate, tstate):
            _same(jp.batch, tp.batch)
        _same(jout, tout)
        outs.append(int(tout.count))
    # retracting the current MAX (step 2) and MIN (step 4) changes them
    assert outs[1] > 0 and outs[3] > 0


def _groupby(rel, sc, schema):
    A, F = rel.AggregateExpr, rel.AggregateFunc
    return rel.Get("lineitem", schema).reduce(
        (0,), (A(F.SUM_INT, sc.col(4)), A(F.COUNT, sc.lit(True)))
    )


def test_groupby_state_overflow_rolls_back_on_the_reference_tick():
    jdf = JDataflow(_groupby(jmir, js, J_LINEITEM), state_cap=CAP)
    tdf = TDataflow(_groupby(tmir, ts, LINEITEM_SCHEMA), state_cap=CAP, device="cpu")
    gen = JGen(sf=0.0002, seed=42)  # 300 orders: 300 groups > 256
    ticks = list(gen.snapshot_lineitem_batches(batch_orders=100, capacity=512))
    ticks += [gen.churn_lineitem_batch(16, tick=i, time=len(ticks) + i, capacity=512)
              for i in range(5)]
    overs, caps = [], []
    for i, jb in enumerate(ticks):
        tb = interop.batch_from_numpy(_jbatch_dict(jb), LINEITEM_SCHEMA, "cpu")
        before = tdf._readbacks
        jdf.run_steps([{"lineitem": jb}], defer_check=True)
        tdf.run_steps([{"lineitem": tb}], defer_check=True)
        over = (jdf.check_flags(), tdf.check_flags())
        assert over[0] == over[1], (i, over)
        overs.append(over[1])
        caps.append(tdf.states[0][0].capacity)
        assert caps[-1] == jdf.states[0][0].capacity
        # one readback, and the replay's after an overflow
        assert tdf._readbacks - before == (2 if over[1] else 1)
        if i in (2, len(ticks) - 1):
            assert tdf.peek() == jdf.peek()
            assert tdf.peek_errors() == jdf.peek_errors() == []
    assert overs.index(True) == 2 and overs.count(True) == 1
    assert caps[1] == CAP and caps[2] == 2 * CAP
    assert int(tdf.states[0][0].batch.count) == 300
