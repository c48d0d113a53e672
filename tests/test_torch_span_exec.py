"""Port parity for the pipelined span path (``render/span_exec.py`` and the
index view's pipelined step), the cases of ``tests/test_span_exec.py``
through both packages.

The same seeded churn (duplicates and ~25 % retractions) feeds the
reference's executor and the port's, and the port's serial
``run_steps`` train:

- the port's pipelined deltas are equal, tick for tick, to its serial
  train's, and its peeks to the reference's pipelined ones;
- a peek admitted while a span is in flight goes through the span
  barrier and sees a committed boundary, equal to the serial result
  and the reference's at that boundary;
- every span costs one flags readback, and at most one span is in
  flight once ``submit`` returns;
- an undersized base overflows inside the window: the port rolls back,
  grows and replays to the reference's result;
- a requested donation clones the window's rollback checkpoint;
- ``MaintainedView.step_span`` on an index view takes
  ``_step_span_pipelined`` and ends where the reference's per-tick view
  does, AS OF reads included.

The reference steps two dataflows here (its compiles dominate the
file's time): one executor run with mid-span peeks, shared by the
module, and one maintained view.
"""

from __future__ import annotations

import numpy as np
import pytest

from materialize_tpu.expr import relation as jmir
from materialize_tpu.render.dataflow import Dataflow as JDataflow
from materialize_tpu.render.span_exec import SpanExecutor as JSpanExecutor
from materialize_tpu.repr.batch import Batch as JBatch
from materialize_tpu.repr.schema import Column as JColumn
from materialize_tpu.repr.schema import ColumnType as JColumnType
from materialize_tpu.repr.schema import Schema as JSchema
from materialize_tpu_torch.expr import relation as tmir
from materialize_tpu_torch.render.dataflow import Dataflow
from materialize_tpu_torch.render.span_exec import SpanExecutor
from materialize_tpu_torch.repr.batch import Batch
from materialize_tpu_torch.repr.schema import Column, ColumnType, Schema
from tests.torch_serving import one_torch_thread  # noqa: F401

JSCH = JSchema((JColumn("k", JColumnType.INT64), JColumn("v", JColumnType.INT64)))
SCH = Schema((Column("k", ColumnType.INT64), Column("v", ColumnType.INT64)))
K = 8  # ticks per span (a multiple of the compaction cadence below)
# Eight spans: the level-2 fold at tick 64 reaches the base, which a
# 256-row state tier cannot hold (the overflow case).
N_SPANS = 8
PEEK_AFTER = (1, 3)  # spans after which a peek is admitted mid-pipeline


def _churn(seed: int, n_spans: int, n_rows=96, keyspace=512) -> list:
    """Per span, per tick: (k, v, diff) numpy arrays."""
    rng = np.random.default_rng(seed)
    spans = []
    for _s in range(n_spans):
        sp = []
        for _i in range(K):
            k = rng.integers(0, keyspace, n_rows).astype(np.int64)
            v = rng.integers(0, 16, n_rows).astype(np.int64)
            d = rng.choice(np.asarray([1, 1, 1, -1]), n_rows).astype(np.int64)
            sp.append((k, v, d))
        spans.append(sp)
    return spans


def _batches(pkg: str, spans: list) -> list:
    out, t = [], 0
    for sp in spans:
        ticks = []
        for k, v, d in sp:
            if pkg == "ref":
                b = JBatch.from_numpy(JSCH, [k, v], np.uint64(t), d, capacity=256)
            else:
                b = Batch.from_numpy(SCH, [k, v], np.uint64(t), d, capacity=256,
                                     device="cpu")
            ticks.append({"src": b})
            t += 1
        out.append(ticks)
    return out


def _mk(pkg: str, state_cap=1 << 14, slots=4):
    if pkg == "ref":
        df = JDataflow(jmir.Get("src", JSCH), out_levels=3, out_slots=slots,
                       state_cap=state_cap)
    else:
        df = Dataflow(tmir.Get("src", SCH), out_levels=3, out_slots=slots,
                      state_cap=state_cap, device="cpu")
    df._compact_every = 4
    df._compact_ratio = 4
    return df


def _accum(rows) -> dict:
    acc: dict = {}
    for r in rows:
        acc[r[:-2]] = acc.get(r[:-2], 0) + r[-1]
    return {k: d for k, d in acc.items() if d}


def _delta_rows(b) -> dict:
    return _accum(b.to_rows())


def _pipelined(pkg: str, spans: list, state_cap=1 << 14, donate=None,
               peek_after=PEEK_AFTER):
    """Submit every span, peeking after ``peek_after``'s spans; returns
    (dataflow, executor, {span: peek}, committed deltas per span)."""
    df = _mk(pkg, state_cap)
    ex = (JSpanExecutor if pkg == "ref" else SpanExecutor)(df, donate=donate)
    peeks, committed = {}, []
    for i, sp in enumerate(_batches(pkg, spans)):
        committed.append(ex.submit(sp))
        if i in peek_after:
            # Span i is in flight: the barrier commits it first.
            peeks[i] = _accum(df.peek())
            assert df.time == (i + 1) * K
    ex.close()
    return df, ex, peeks, committed


@pytest.fixture(scope="module")
def churn():
    return _churn(7, N_SPANS)


@pytest.fixture(scope="module")
def ref_run(churn):
    df, ex, peeks, _ = _pipelined("ref", churn)
    return _accum(df.peek()), peeks, ex.stats()


@pytest.fixture(scope="module")
def serial(churn):
    """The port's serial train: per span, its deltas and the peek after."""
    df = _mk("port")
    deltas, peeks = [], []
    for sp in _batches("port", churn):
        deltas.append([_delta_rows(b) for b in df.run_steps(sp)])
        peeks.append(_accum(df.peek()))
    return deltas, peeks


def test_pipelined_equals_serial_under_churn(churn, ref_run, serial):
    df, ex, _peeks, committed = _pipelined("port", churn)
    final = _accum(df.peek())
    assert final == serial[1][-1] == ref_run[0]
    # submit returns the PREVIOUS span's validated deltas: tick for tick
    # the serial train's (the peeks in between commit their own span).
    got = [(i - 1, c) for i, c in enumerate(committed) if c is not None]
    assert got, "no span's deltas came back through submit"
    for i, deltas in got:
        assert [_delta_rows(b) for b in deltas] == serial[0][i], f"span {i}"
    st = ex.stats()
    assert st["spans_committed"] == N_SPANS == ref_run[2]["spans_committed"]
    assert st["donated"] is False and st["overflows"] == 0


def test_one_readback_a_span_and_one_span_in_flight(churn, ref_run):
    df, ex, _peeks, _ = _pipelined("port", churn)
    st = ex.stats()
    assert st["readbacks_per_span"] == 1.0 == ref_run[2]["readbacks_per_span"]
    assert st["max_inflight"] == 1
    assert all(r["readbacks"] == 1 for r in ex.trace)


def test_mid_span_peeks_see_committed_boundaries(churn, ref_run, serial):
    _df, ex, peeks, _ = _pipelined("port", churn)
    assert set(peeks) == set(PEEK_AFTER)
    for i, got in peeks.items():
        assert got == serial[1][i] == ref_run[1][i], f"mismatch at boundary {i}"
    assert ex.boundary_syncs >= len(PEEK_AFTER)


def test_donation_request_clones_the_checkpoint(churn):
    """With donation requested the window's rollback checkpoint holds
    fresh tensors, never the live carry's; what takes effect (and what
    the trace reports) is no donation."""
    import torch

    df = _mk("port")
    ex = SpanExecutor(df, donate=True)
    ex.submit(_batches("port", churn[:1])[0])
    ck = df._defer_ck
    assert ck is not None

    def tensors(tree, out):
        if isinstance(tree, torch.Tensor):
            out.append(tree)
        elif isinstance(tree, (list, tuple)):
            for x in tree:
                tensors(x, out)
        elif hasattr(tree, "__dataclass_fields__"):
            for f in tree.__dataclass_fields__:
                tensors(getattr(tree, f), out)
        return out

    live = {id(t) for t in tensors((df.states, df.output, df.err_output), [])}
    cloned = tensors((ck[0], ck[1], ck[2]), [])
    assert cloned and not [t for t in cloned if id(t) in live]
    assert ex.donate_requested is True and ex.donate is False
    ex.close()
    assert [r["donated"] for r in ex.trace] == [False]


def test_overflow_rolls_back_grows_and_replays(churn, ref_run, serial):
    """A deliberately small base: the last span's level-2 fold overflows
    it inside the window; the span's boundary readback reports it, and
    the executor rolls back, grows and replays to the reference's
    result (no peek in between: nothing else compacts the base)."""
    small, ex, _peeks, _ = _pipelined("port", churn, state_cap=256,
                                      peek_after=())
    assert ex.overflows >= 1 and ("out", 2) in small._grown
    assert ex.stats()["readbacks_per_span"] == 1.0
    assert _accum(small.peek()) == ref_run[0] == serial[1][-1]


def test_maintained_view_step_span_matches_the_reference(tmp_path):
    """The replica-side pipelined path: the port's index view steps in
    spans through ``_step_span_pipelined`` (a backlog of ready ticks,
    at most one span in flight) and ends where the reference's per-tick
    view does, with the same AS OF rewinds."""
    from materialize_tpu import storage as _js  # noqa: F401
    from materialize_tpu.storage import persist as jpersist
    from materialize_tpu_torch.storage import persist as tpersist

    def build(pkg, tag):
        p = jpersist if pkg == "ref" else tpersist
        client = p.PersistClient(p.FileBlob(str(tmp_path / f"blob{tag}")),
                                 p.SqliteConsensus(str(tmp_path / f"c{tag}.db")))
        sch = JSCH if pkg == "ref" else SCH
        w = client.open_writer("src", sch)
        if pkg == "ref":
            df = JDataflow(jmir.Get("src", JSCH), out_slots=0)
        else:
            df = Dataflow(tmir.Get("src", SCH), out_slots=0, device="cpu")
        view = p.MaintainedView(client, df, {"src": ("src", sch)}, None)
        return w, view

    rng = np.random.default_rng(5)
    ticks = [
        (rng.integers(0, 64, 32).astype(np.int64),
         rng.integers(0, 8, 32).astype(np.int64),
         rng.choice(np.asarray([1, 1, -1]), 32).astype(np.int64))
        for _t in range(24)
    ]

    def feed(w, t, tick):
        k, v, d = tick
        w.compare_and_append([k, v], [None, None], np.full(len(d), t, np.uint64),
                             d, t, t + 1)

    w1, v_ref = build("ref", "a")
    for t, tk in enumerate(ticks):
        feed(w1, t, tk)
        assert v_ref.step(timeout=5)

    w2, v_span = build("port", "b")
    calls = []
    orig = v_span._step_span_pipelined
    v_span._step_span_pipelined = lambda *a: calls.append(a) or orig(*a)
    for t, tk in enumerate(ticks):
        feed(w2, t, tk)
        if t % 6 == 5:  # span over the accumulated backlog
            while v_span._dispatched < t + 1:
                assert v_span.step_span(max_ticks=4, timeout=5)
                assert v_span._dispatched - v_span.upper <= 4  # one span in flight
    v_span.sync_spans()
    while v_span.upper < len(ticks):
        v_span.step_span(max_ticks=4, timeout=5)
        v_span.sync_spans()
    assert calls, "the index view did not take the pipelined step"
    assert v_span.upper == v_ref.upper == len(ticks)
    assert v_span.span_epoch > 0
    assert _accum(v_ref.peek()) == _accum(v_span.peek())

    def acc(upd):
        cols, _nulls, _tm, diff = upd
        out: dict = {}
        for i in range(len(diff)):
            key = tuple(int(c[i]) for c in cols)
            out[key] = out.get(key, 0) + int(diff[i])
        return {k: d for k, d in out.items() if d}

    lo = max(v_ref.since, v_span.since)
    assert lo < len(ticks)
    for t in range(lo, len(ticks)):
        assert acc(v_ref.updates_as_of(t)) == acc(v_span.updates_as_of(t)), f"AS OF {t}"
    for v in (v_ref, v_span):
        v.expire()
