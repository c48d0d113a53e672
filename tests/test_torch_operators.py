"""Port parity for the remaining render arms: Threshold, Negate,
Constant, FlatMap and ArrangeBy.

1. ``ThresholdOp.step`` equals the jitted reference op, state and output
   row for row, over the cases of ``tests/test_operators_v1.py``
   (negative multiplicities suppressed: (1,1) twice and (2,2) at -1
   keep (1,1) only, then (2,2) +3 shows it at 2), four randomized steps
   of diffs in [-2, 2] over a nullable column, and a step whose distinct
   rows overflow the state tier (both flag it on the same step). The
   outputs summed equal the positive part of the inputs summed.
2. ``flat_map`` (``generate_series``) equals the jitted reference
   function on bounds with NULLs, empty ranges (lo > hi), zero diffs and
   negative diffs, at a tier that holds the fan-out and at one that
   overflows (both flag it and keep the same prefix).
3. One dataflow in both packages, ``Union(Threshold(a - b) arranged by
   k, Constant, generate_series over s's bounds)`` at ``state_cap`` 256
   over 3 ticks: the first tick's fan-out overflows the FlatMap's tier of
   1,024 and the second's rows overflow the Threshold's arrangement, in
   both packages on the same tick; both roll back, grow and replay. The
   peek, every state part, the tiers and each tick's output delta are
   equal, and the peek equals a numpy oracle. The Constant's rows are in
   the first tick's delta only. The reference's state after tick 2,
   carried into a fresh port dataflow with ``interop.install_state``,
   runs tick 3 to the same result (its Constant does not fire again).
4. Port-only: Negate flips every diff; ArrangeBy renders as the
   identity; a Constant of a dataflow whose first tick is at time 5
   emits there, once.
Every value is an integer: tolerance 0. One reference dataflow is
stepped in the file (its step programs compile per tier).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from materialize_tpu.expr import relation as jmir
from materialize_tpu.expr import scalar as js
from materialize_tpu.ops.flat_map import flat_map as jflat_map
from materialize_tpu.ops.threshold import ThresholdOp as JThresholdOp
from materialize_tpu.render.dataflow import Dataflow as JDataflow
from materialize_tpu.repr import schema as jschema
from materialize_tpu.repr.batch import Batch as JBatch
from materialize_tpu_torch import interop
from materialize_tpu_torch.expr import relation as tmir
from materialize_tpu_torch.expr import scalar as ts
from materialize_tpu_torch.ops.flat_map import flat_map as tflat_map
from materialize_tpu_torch.ops.threshold import ThresholdOp as TThresholdOp
from materialize_tpu_torch.render.dataflow import Dataflow
from materialize_tpu_torch.repr import schema as tschema
from materialize_tpu_torch.repr.batch import Batch as TBatch
from tests.test_torch_auction import _same
from tests.test_torch_dataflow import _jspine_dict
from tests.test_torch_q1 import _jdict_arrangement


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's eager ops here are small: one intra-op thread runs them
    about as fast, and does not contend with other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CAP = 256


def _schema(mod, nullable=True):
    C, T = mod.Column, mod.ColumnType
    return mod.Schema([C("k", T.INT64), C("v", T.INT32), C("w", T.INT64, nullable)])


def _batches(cols, nulls, diff, t, cap=CAP, nullable=True):
    time = np.full(len(diff), t, np.uint64)
    jb = JBatch.from_numpy(_schema(jschema, nullable), cols, time, diff, capacity=cap,
                           nulls=nulls)
    tb = TBatch.from_numpy(_schema(tschema, nullable), cols, time, diff, capacity=cap,
                           nulls=nulls, device="cpu")
    return jb, tb


def _threshold_steps():
    """(cols, nulls, diff) per step: the two cases of
    ``tests/test_operators_v1.py``, four randomized steps, then a step
    of 300 new distinct rows (beyond the state tier of 256)."""
    def rows(k, v, w, wn, d):
        return ([np.asarray(k, np.int64), np.asarray(v, np.int32), np.asarray(w, np.int64)],
                [None, None, np.asarray(wn, bool)], np.asarray(d, np.int64))

    steps = [rows([1, 1, 2], [1, 1, 2], [0, 0, 0], [False] * 3, [1, 1, -1]),
             rows([2], [2], [0], [False], [3])]
    rng = np.random.default_rng(11)
    for _ in range(4):
        n = 100
        d = rng.integers(-2, 3, n)
        d[d == 0] = 1
        wn = rng.random(n) < 0.3
        # A NULL's value is -1, no set value's, so the host oracle can
        # key rows by value.
        w = np.where(wn, -1, rng.integers(0, 3, n))
        steps.append(rows(rng.integers(0, 5, n), rng.integers(0, 4, n), w, wn, d))
    n = 300
    steps.append(rows(np.arange(100, 100 + n), np.zeros(n), np.zeros(n), np.zeros(n, bool),
                      np.ones(n)))
    return steps


def _net(rows, acc):
    for r in rows:
        acc[r[:-2]] = acc.get(r[:-2], 0) + r[-1]
    return {k: v for k, v in acc.items() if v}


def test_threshold_op_steps_match_reference():
    jop, top = JThresholdOp(_schema(jschema)), TThresholdOp(_schema(tschema))
    jstep = jax.jit(jop.step)
    jstate, tstate = jop.init_state(CAP), top.init_state(CAP, device="cpu")
    fed, out = {}, {}
    steps = _threshold_steps()
    for t, (cols, nulls, diff) in enumerate(steps):
        jb, tb = _batches(cols, nulls, diff, t, cap=512)
        jstate, jout, jovf = jstep(jstate, jb, np.uint64(t))
        tstate, tout, tovf = top.step(tstate, tb, t)
        overflow = t == len(steps) - 1
        assert bool(jovf[0]) == bool(tovf[0]) == overflow
        _same(jstate[0].batch, tstate[0].batch)
        _same(jout, tout)
        assert tout.to_rows() == jout.to_rows()
        if t == 0:
            assert _net(tout.to_rows(), {}) == {(1, 1, 0): 2}
        if t == 1:
            assert _net(tout.to_rows(), {}) == {(2, 2, 0): 2}
        if not overflow:
            _net(tb.to_rows(), fed)
            _net(tout.to_rows(), out)
    assert _net([], out) == {k: m for k, m in _net([], fed).items() if m > 0}


def _series_batch(n, seed):
    rng = np.random.default_rng(seed)
    lo = rng.integers(-3, 5, n)
    cols = [np.arange(n, dtype=np.int64), lo.astype(np.int32),
            lo + rng.integers(-2, 9, n)]
    nulls = [None, None, rng.random(n) < 0.2]
    diff = rng.integers(-1, 3, n)
    return cols, nulls, diff


@pytest.mark.parametrize("out_cap,overflow", [(1024, False), (64, True)])
def test_flat_map_matches_reference(out_cap, overflow):
    cols, nulls, diff = _series_batch(120, 3)
    jb, tb = _batches(cols, nulls, diff, 4)
    exprs = {m: (m.col(1), m.col(2)) for m in (js, ts)}
    out_col = {m: (m.Column("x", m.ColumnType.INT64),) for m in (jschema, tschema)}
    jsch = jschema.Schema(tuple(_schema(jschema).columns) + out_col[jschema])
    tsch = tschema.Schema(tuple(_schema(tschema).columns) + out_col[tschema])
    jout, jovf = jax.jit(lambda b: jflat_map(b, "generate_series", exprs[js], jsch, 4,
                                              out_cap))(jb)
    tout, tovf = tflat_map(tb, "generate_series", exprs[ts], tsch, 4, out_cap)
    assert bool(jovf) == bool(tovf) == overflow
    _same(jout, tout)
    assert tout.to_rows() == jout.to_rows() and int(tout.count) > 0
    if not overflow:
        want = {}
        for k, lo, hi, hn, d in zip(*cols, nulls[2], diff):
            if not hn and d:
                for x in range(int(lo), int(hi) + 1):
                    want[(int(k), x)] = want.get((int(k), x), 0) + int(d)
        got = {}
        for r in tout.to_rows():
            got[(r[0], r[3])] = got.get((r[0], r[3]), 0) + r[-1]
        assert got == want


# -- the arms dataflow ---------------------------------------------------------------

CONSTANT = (((7, 70), 2), ((8, 80), 1), ((9, 90), -1))


def _arms_plan(m, sch, sc):
    C, T = sch.Column, sch.ColumnType
    kv = sch.Schema([C("k", T.INT64), C("v", T.INT64)])
    bounds = sch.Schema([C("k", T.INT64), C("lo", T.INT64, True), C("hi", T.INT64, True)])
    pos = m.Union((m.Get("a", kv), m.Negate(m.Get("b", kv)))).threshold()
    series = m.FlatMap(m.Get("s", bounds), "generate_series", (sc.col(1), sc.col(2)),
                       (C("x", T.INT64),)).project((0, 3))
    return m.Union((pos.arrange_by((0,)), m.Constant(CONSTANT, kv), series)), kv, bounds


def _arms_ticks():
    """3 ticks of (name -> (cols, nulls, diff)): tick 0's fan-out ~1,500
    rows, tick 1's a and b push the distinct (k, v) of the Threshold's
    input past 256."""
    rng = np.random.default_rng(5)
    ticks = []
    for t, (n, m) in enumerate(((120, 200), (260, 20), (80, 20))):
        tick = {}
        for name in ("a", "b"):
            d = rng.integers(1, 3, n) * rng.choice([-1, 1], n, p=[0.3, 0.7])
            tick[name] = ([rng.integers(0, 20, n), rng.integers(0, 40, n)], None, d)
        lo = rng.integers(-5, 5, m)
        tick["s"] = ([rng.integers(0, 50, m), lo, lo + rng.integers(-2, 20, m)],
                     [None, rng.random(m) < 0.1, rng.random(m) < 0.1], rng.integers(1, 3, m))
        ticks.append(tick)
    return ticks


def _arms_oracle(ticks) -> dict:
    ab, acc = {}, {}
    for tick in ticks:
        for name, sign in (("a", 1), ("b", -1)):
            (k, v), _, d = tick[name]
            for row in zip(k.tolist(), v.tolist(), d.tolist()):
                ab[row[:2]] = ab.get(row[:2], 0) + sign * row[2]
        (k, lo, hi), (_, ln, hn), d = tick["s"]
        for kk, a, b, skip, dd in zip(k.tolist(), lo.tolist(), hi.tolist(), ln | hn,
                                      d.tolist()):
            for x in ([] if skip else range(a, b + 1)):
                acc[(kk, x)] = acc.get((kk, x), 0) + dd
    for key, m in ab.items():
        if m > 0:
            acc[key] = acc.get(key, 0) + m
    for row, d in CONSTANT:
        acc[row] = acc.get(row, 0) + d
    return {k: v for k, v in acc.items() if v}


def _multiset(rows):
    return _net(rows, {})


def test_arms_dataflow_matches_reference():
    jexpr, jkv, jbounds = _arms_plan(jmir, jschema, js)
    texpr, tkv, tbounds = _arms_plan(tmir, tschema, ts)
    jdf, tdf = JDataflow(jexpr), Dataflow(texpr, device="cpu")
    schemas = {"a": (jkv, tkv), "b": (jkv, tkv), "s": (jbounds, tbounds)}
    ticks = _arms_ticks()

    def inputs(t, tick, which):
        out = {}
        for name, (cols, nulls, d) in tick.items():
            time = np.full(len(d), t, np.uint64)
            sch = schemas[name][which]
            if which == 0:
                out[name] = JBatch.from_numpy(sch, cols, time, d, nulls=nulls)
            else:
                out[name] = TBatch.from_numpy(sch, cols, time, d, nulls=nulls, device="cpu")
        return out

    def state_parts(df):
        return [p.batch for parts in df.states for p in parts]

    def same(df):
        assert df.peek() == jdf.peek()
        assert df._ctx.join_caps == jdf._ctx.join_caps
        for jp, tp in zip(state_parts(jdf), state_parts(df)):
            assert tp.capacity == jp.capacity
            _same(jp, tp)
        assert df.time == jdf.time

    # Tick 0's fan-out grows the FlatMap's tier, tick 1 the Threshold's.
    tiers = []
    for t, tick in enumerate(ticks[:2]):
        jd = jdf.run_steps([inputs(t, tick, 0)])
        td = tdf.run_steps([inputs(t, tick, 1)])
        assert td[-1].to_rows() == jd[-1].to_rows()
        same(tdf)
        tiers.append((list(tdf._ctx.join_caps), tdf.states[0][0].capacity))
        delta = _multiset(td[-1].to_rows())
        assert all(delta.get(row) == (d if t == 0 else None) for row, d in CONSTANT)
    assert tiers == [([2048], CAP), ([2048], 4 * CAP)]
    assert [b.capacity for b in tdf.output.runs_b] == [b.capacity for b in jdf.output.runs_b]
    assert _multiset(tdf.peek()) == _arms_oracle(ticks[:2])

    cdf = Dataflow(texpr, device="cpu")
    interop.install_state(
        cdf, [[_jdict_arrangement(p) for p in parts] for parts in jdf.states],
        _jspine_dict(jdf.output), _jdict_arrangement(jdf.err_output), jdf.time,
        jdf._compact_tick, join_caps=jdf._ctx.join_caps,
    )
    jdf.run_steps([inputs(2, ticks[2], 0)])
    for df in (tdf, cdf):
        df.run_steps([inputs(2, ticks[2], 1)])
        same(df)
    assert _multiset(cdf.peek()) == _arms_oracle(ticks)


# -- port-only arms ----------------------------------------------------------------


def _kv_df(expr_fn):
    sch = _schema(tschema, nullable=False)
    return Dataflow(expr_fn(tmir.Get("in", sch)), device="cpu"), sch


def _kv_batch(sch, t, seed=2):
    rng = np.random.default_rng(seed)
    n = 50
    cols = [rng.integers(0, 9, n), rng.integers(0, 4, n).astype(np.int32), rng.integers(0, 3, n)]
    return TBatch.from_numpy(sch, cols, np.full(n, t, np.uint64), rng.integers(1, 3, n),
                             device="cpu")


def test_negate_flips_every_diff():
    df, sch = _kv_df(lambda g: g.negate())
    b = _kv_batch(sch, 0)
    out = _multiset(df.step({"in": b}).to_rows())
    assert out == {k: -v for k, v in _multiset(b.to_rows()).items()}
    assert _multiset(df.peek()) == out


def test_arrange_by_is_the_identity():
    df, sch = _kv_df(lambda g: g.arrange_by((1,)))
    plain, _ = _kv_df(lambda g: g)
    for t in range(3):
        b = _kv_batch(sch, t, seed=t)
        assert df.step({"in": b}).to_rows() == plain.step({"in": b}).to_rows()
    assert df.peek() == plain.peek()


def test_constant_emits_once_at_the_first_time():
    sch = _schema(tschema, nullable=False)
    rows = (((1, 2, 3), 1), ((4, 5, 6), 2))
    df = Dataflow(tmir.Constant(rows, sch), device="cpu")
    df._time = 5
    first = df.step({})
    assert sorted(first.to_rows()) == [(1, 2, 3, 5, 1), (4, 5, 6, 5, 2)]
    assert df.step({}).to_rows() == []
    assert _multiset(df.peek()) == {(1, 2, 3): 1, (4, 5, 6): 2}
