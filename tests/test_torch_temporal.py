"""Port parity for temporal filters (``mz_now()``) and the auction under
a temporal window.

1. ``canonicalize_temporal`` splits each of the 8 forms of its table
   (``mz_now()`` on either side of ``>=``, ``>``, ``<=``, ``<``) into the
   reference's bounds, and raises where the reference raises: no
   comparison, an equality, ``mz_now()`` inside an expression, on both
   sides.
2. ``TemporalFilterOp.step`` equals the jitted reference op, buffer and
   output row for row, over 10 steps of random windows ``[lo, hi)``:
   ``lo`` before, at and after the step's time, ``lo == hi`` and
   ``lo > hi`` (never active), ``hi`` past ``NO_UPPER`` (never
   retracted), NULL bounds (never active), and retractions of earlier
   rows. The outputs summed equal ``tests/test_temporal.py``'s oracle of
   the rows active at each time. At a buffer tier of 64 the buffer
   overflows, on the same step in both packages, with equal truncated
   buffers.
3. ``mz_now()`` in a Map evaluates to the step's time
   (``tests/test_temporal.py::test_mz_now_in_map``).
4. The window auction: ``auction_window_plan(3, 4)`` equals the
   reference optimizer's plan of ``Filter(Get bids, mz_now() < bid_time +
   4)`` under the auction's TopK and Distinct; rendered by both packages
   at ``state_cap`` 256 on the reference generator's insert-only bids (64
   a tick, 16 ticks), its peek equals the reference's and the port's
   retract-mode auction's (bids retracted 4 ticks later) at every tick.
   The reference's state after tick 6, with retractions pending in its
   temporal buffer, carried into a fresh port dataflow with
   ``interop.install_state``, runs on to the same peeks.
Every value is an integer: tolerance 0. One reference dataflow is
stepped in the file.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from materialize_tpu.expr import relation as jmir
from materialize_tpu.expr import scalar as js
from materialize_tpu.ops import temporal as jtemporal
from materialize_tpu.render.dataflow import Dataflow as JDataflow
from materialize_tpu.repr import schema as jschema
from materialize_tpu.repr.batch import Batch as JBatch
from materialize_tpu.storage.generator.auction import BIDS_SCHEMA as J_BIDS_SCHEMA
from materialize_tpu.storage.generator.auction import AuctionGenerator as JGen
from materialize_tpu.transform.optimizer import optimize
from materialize_tpu_torch import interop
from materialize_tpu_torch.expr import relation as tmir
from materialize_tpu_torch.expr import scalar as ts
from materialize_tpu_torch.ops import temporal as ttemporal
from materialize_tpu_torch.render.dataflow import Dataflow
from materialize_tpu_torch.repr import schema as tschema
from materialize_tpu_torch.repr.batch import Batch as TBatch
from materialize_tpu_torch.storage.generator.auction import BIDS_SCHEMA
from materialize_tpu_torch.workloads.auction import (
    auction_config,
    auction_window_config,
    auction_window_plan,
)
from tests.test_temporal import _oracle_active
from tests.test_torch_auction import _same
from tests.test_torch_dataflow import _jbatch_dict, _jspine_dict
from tests.test_torch_q1 import _convert, _jdict_arrangement


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's eager ops here are small: one intra-op thread runs them
    about as fast, and does not contend with other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FUNCS = ("gte", "gt", "lte", "lt")


@pytest.mark.parametrize("now_left", [True, False])
@pytest.mark.parametrize("func", FUNCS)
def test_canonicalize_temporal_forms(func, now_left):
    def pred(m):
        e = m.col(1) + 2
        if now_left:
            return getattr(m.MzNow(), func)(e)
        return m.CallBinary(func, e, m.MzNow())

    want = _convert(tuple(tuple(x) for x in jtemporal.canonicalize_temporal([pred(js)])))
    got = tuple(tuple(x) for x in ttemporal.canonicalize_temporal([pred(ts)]))
    assert got == want and sum(map(len, got)) == 1


RAISING = {
    "not_a_comparison": lambda m: m.CallUnary("not", m.MzNow().lt(m.col(1))),
    "equality": lambda m: m.MzNow().eq(m.col(1)),
    "inside_an_expression": lambda m: (m.MzNow() + 1).lt(m.col(1)),
    "both_sides": lambda m: m.MzNow().lt(m.MzNow()),
}


@pytest.mark.parametrize("form", list(RAISING))
def test_canonicalize_temporal_raises_where_the_reference_does(form):
    for mod, op in ((js, jtemporal), (ts, ttemporal)):
        with pytest.raises(NotImplementedError):
            op.canonicalize_temporal([RAISING[form](mod)])


# -- TemporalFilterOp -------------------------------------------------------------


def _wschema(m):
    C, T = m.Column, m.ColumnType
    return m.Schema([C("id", T.INT64), C("lo", T.INT64, True), C("hi", T.INT64, True)])


def _window_steps(n_steps=10, n=40, seed=3):
    """Per step (rows [(id, lo, hi, diff)], lo NULL mask, hi NULL mask),
    rows inserted at time t; a quarter of a step's rows retract rows of
    earlier steps."""
    rng = np.random.default_rng(seed)
    steps, live, next_id = [], [], 0
    big = ttemporal.NO_UPPER + 3
    for t in range(n_steps):
        rows, ln, hn = [], [], []
        for _ in range(n):
            lo = t + int(rng.integers(-3, 6))
            hi = lo + int(rng.integers(-1, 6)) if rng.random() > 0.1 else big
            rows.append((next_id, lo, hi, 1))
            ln.append(bool(rng.random() < 0.08))
            hn.append(bool(rng.random() < 0.08))
            next_id += 1
        for i in rng.choice(len(live), min(len(live), n // 4), replace=False):
            r, a, b = live[i]
            rows.append((r[0], r[1], r[2], -1))
            ln.append(a)
            hn.append(b)
        live += [(r, a, b) for r, a, b in zip(rows, ln, hn) if r[3] == 1]
        steps.append((rows, np.array(ln), np.array(hn)))
    return steps


def _wbatches(rows, ln, hn, t, cap=256):
    cols = [np.array([r[i] for r in rows], np.int64) for i in range(3)]
    # A NULL bound's value is 0.
    cols[1] = np.where(ln, 0, cols[1])
    cols[2] = np.where(hn, 0, cols[2])
    diff = np.array([r[3] for r in rows], np.int64)
    time = np.full(len(rows), t, np.uint64)
    nulls = [None, ln, hn]
    return (JBatch.from_numpy(_wschema(jschema), cols, time, diff, capacity=cap, nulls=nulls),
            TBatch.from_numpy(_wschema(tschema), cols, time, diff, capacity=cap, nulls=nulls,
                              device="cpu"))


def _ops():
    jlo, jhi = jtemporal.canonicalize_temporal(
        [js.MzNow().gte(js.col(1)), js.MzNow().lt(js.col(2))])
    tlo, thi = ttemporal.canonicalize_temporal(
        [ts.MzNow().gte(ts.col(1)), ts.MzNow().lt(ts.col(2))])
    return (jtemporal.TemporalFilterOp(_wschema(jschema), tuple(jlo), tuple(jhi)),
            ttemporal.TemporalFilterOp(_wschema(tschema), tuple(tlo), tuple(thi)))


@pytest.mark.parametrize("buf_cap,overflow_at", [(1024, None), (64, 2)])
def test_temporal_filter_op_steps_match_reference(buf_cap, overflow_at):
    jop, top = _ops()
    jstep = jax.jit(jop.step, static_argnums=3)
    jstate, tstate = jop.init_state(buf_cap), top.init_state(buf_cap, device="cpu")
    by_time, out = {}, {}
    overflowed = []
    for t, (rows, ln, hn) in enumerate(_window_steps()):
        jb, tb = _wbatches(rows, ln, hn, t)
        jstate, jout, jovf, jo2 = jstep(jstate, jb, np.uint64(t), 512)
        tstate, tout, tovf, to2 = top.step(tstate, tb, t, 512)
        assert bool(jovf[0]) == bool(tovf[0]) and bool(jo2) == bool(to2) is False
        overflowed.append(bool(tovf[0]))
        _same(jstate[0].batch, tstate[0].batch)
        n = int(tstate[0].batch.count)
        assert np.array_equal(tstate[0].batch.time[:n].numpy().view(np.uint64),
                              np.asarray(jstate[0].batch.time)[:n])
        _same(jout, tout)
        assert tout.to_rows() == jout.to_rows()
        if overflow_at is None:
            by_time[t] = [r for r, a, b in zip(rows, ln, hn) if not (a or b)]
            for r in tout.to_rows():
                out[r[:3]] = out.get(r[:3], 0) + r[-1]
            assert {k: v for k, v in out.items() if v} == _oracle_active(by_time, t)
    assert overflowed.index(True) == overflow_at if overflow_at is not None \
        else not any(overflowed)


def test_mz_now_in_map():
    sch = _wschema(tschema)
    df = Dataflow(tmir.Map(tmir.Get("in", sch), (ts.MzNow(),)), device="cpu")
    df.step({"in": _wbatches([(7, 0, 0, 1)], [False], [False], 0)[1]})
    df._time = 5
    out = df.step({"in": _wbatches([(8, 0, 0, 1)], [False], [False], 5)[1]})
    assert out.to_rows() == [(8, 0, 0, 5, 5, 1)]


# -- the window auction -----------------------------------------------------------

GEN = dict(seed=42, n_users=64, auctions_per_tick=8, bids_per_auction=8)
STATE_CAP, WINDOW, TICKS, CARRY_AT = 256, 4, 16, 6


def _jwindow_mir(k=3, window=WINDOW):
    bids = jmir.Filter(jmir.Get("bids", J_BIDS_SCHEMA),
                       (js.MzNow().lt(js.col(4) + js.lit(window, jschema.ColumnType.INT64)),))
    return jmir.TopK(bids, (2,), ((3, True, False),), k).project((1,)).distinct()


def test_auction_window_plan_equals_the_reference_optimizer_output():
    want = _convert(optimize(_jwindow_mir()))
    assert auction_window_plan(3, WINDOW) == want
    assert auction_window_plan(3, WINDOW).schema() == want.schema()


def test_window_auction_matches_reference_and_retract_mode():
    jdf = JDataflow(optimize(_jwindow_mir()), state_cap=STATE_CAP)
    wdf, _, _ = auction_window_config(state_cap=STATE_CAP, window=WINDOW, device="cpu", **GEN)
    rdf, r_hydrate, r_churn = auction_config(state_cap=STATE_CAP, retract_after=WINDOW,
                                             device="cpu", **GEN)
    r_ticks = r_hydrate() + [r_churn(i, 8 + i)[0] for i in range(TICKS - 8)]
    gen = JGen(retract_after=None, **GEN)
    cdf = None
    for t in range(TICKS):
        jb = gen.tick(t, t)["bids"]
        jdf.run_steps([{"bids": jb}])
        tb = {"bids": interop.batch_from_numpy(_jbatch_dict(jb), BIDS_SCHEMA, "cpu")}
        dfs = [wdf] if cdf is None else [wdf, cdf]
        for df in dfs:
            df.run_steps([tb])
        rdf.run_steps([r_ticks[t]])
        want = jdf.peek()
        assert len(want) > 10 and rdf.peek() == want
        for df in dfs:
            assert df.peek() == want and df.time == jdf.time == t + 1
        if t + 1 == CARRY_AT:
            buf = jdf.states[-1][0].batch
            assert int(buf.count) > 0  # retractions pending
            cdf = Dataflow(auction_window_plan(3, WINDOW), state_cap=STATE_CAP, device="cpu")
            interop.install_state(
                cdf, [[_jdict_arrangement(p) for p in parts] for parts in jdf.states],
                _jspine_dict(jdf.output), _jdict_arrangement(jdf.err_output), jdf.time,
                jdf._compact_tick, join_caps=jdf._ctx.join_caps,
            )
            _same(buf, cdf.states[-1][0].batch)
            assert cdf.peek() == jdf.peek()
    assert wdf.peek_errors() == jdf.peek_errors() == []
