"""Port parity for the auction slice: the generator, TopK, Distinct and
the auction dataflow.

1. ``AuctionGenerator`` gives the reference's bids and auctions, tick
   for tick over 12 ticks of one seed (item names decoded: each package
   codes strings in its own dictionary), and the same side tables.
2. ``auction_plan(3)`` equals the reference optimizer's
   ``optimize(auction_winning_bidders_mir(3))``, converted into the
   port's MIR classes by walking its attributes.
3. ``TopKOp.step`` equals the jitted reference op over six churn steps
   (inserts, retractions inside and past the window, a group emptied),
   with many equal amounts so ties sit at the window's edges: DESC with
   a limit (the auction's), ASC on a nullable column with NULLS LAST
   and an offset, and two order columns, a nullable one DESC with NULLS
   FIRST, with an offset and no limit. The state arrangement (order
   lanes included) and the output delta are equal, row for row.
4. The auction dataflow at ``state_cap`` 256 on the reference
   generator's bids (64 a tick, retracted 4 ticks later): 8 hydrate
   ticks, whose fifth overflows the TopK state in both packages (both
   roll back, grow it to 512 and replay), then two churn spans of 8.
   ``peek()`` equals the reference's and ``tests/test_auction.py``'s
   oracle after hydration and after each span, with one flags readback
   a span; the state tiers are equal. The reference's state after
   hydration, carried into a fresh port dataflow with
   ``interop.install_state``, churns onward to the same result.
One reference dataflow in the file: its compiles dominate the run time.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from materialize_tpu.expr import relation as jmir
from materialize_tpu.ops.topk import TopKOp as JTopKOp
from materialize_tpu.render.dataflow import Dataflow as JDataflow
from materialize_tpu.repr import schema as jschema
from materialize_tpu.repr.batch import Batch as JBatch
from materialize_tpu.storage.generator.auction import AuctionGenerator as JGen
from materialize_tpu.transform.optimizer import optimize
from materialize_tpu.workloads.auction import auction_winning_bidders_mir
from materialize_tpu_torch import interop
from materialize_tpu_torch.expr import relation as tmir
from materialize_tpu_torch.ops.topk import TopKOp as TTopKOp
from materialize_tpu_torch.render.dataflow import Dataflow
from materialize_tpu_torch.repr import schema as tschema
from materialize_tpu_torch.repr.batch import Batch as TBatch
from materialize_tpu_torch.storage.generator.auction import BIDS_SCHEMA
from materialize_tpu_torch.storage.generator.auction import AuctionGenerator as TGen
from materialize_tpu_torch.workloads.auction import auction_plan
from tests.test_auction import _oracle_topk
from tests.test_torch_dataflow import _jbatch_dict, _jspine_dict
from tests.test_torch_q1 import _jdict_arrangement


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's eager ops here are small: one intra-op thread runs them
    about as fast, and does not contend with other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _decoded(rows, schema, dictionary):
    strings = [i for i, c in enumerate(schema.columns) if c.ctype.value == "string"]
    return [tuple(dictionary.decode(v) if i in strings else v for i, v in enumerate(r))
            for r in rows]


def test_generator_matches_reference():
    kw = dict(seed=11, n_users=40, auctions_per_tick=6, bids_per_auction=5, retract_after=3)
    jg, tg = JGen(**kw), TGen(device="cpu", **kw)
    for name, jb in jg.snapshot(0).items():
        tb = tg.snapshot(0)[name]
        assert _decoded(tb.to_rows(), tb.schema, tschema.GLOBAL_DICT) == _decoded(
            jb.to_rows(), jb.schema, jschema.GLOBAL_DICT)
    retracted = 0
    for tick in range(12):
        jt, tt = jg.tick(tick, tick), tg.tick(tick, tick)
        for name in ("auctions", "bids"):
            jb, tb = jt[name], tt[name]
            assert tb.capacity == jb.capacity
            assert _decoded(tb.to_rows(), tb.schema, tschema.GLOBAL_DICT) == _decoded(
                jb.to_rows(), jb.schema, jschema.GLOBAL_DICT)
        retracted += sum(r[-1] < 0 for r in tt["bids"].to_rows())
    assert retracted == (12 - 3) * 30


_CLASSES = {
    jmir.Get: tmir.Get, jmir.Project: tmir.Project, jmir.Reduce: tmir.Reduce,
    jmir.TopK: tmir.TopK,
}


def _convert(x):
    if isinstance(x, tuple):
        return tuple(_convert(v) for v in x)
    if isinstance(x, jschema.Schema):
        return tschema.Schema([_convert(c) for c in x.columns])
    if isinstance(x, jschema.Column):
        return tschema.Column(x.name, tschema.ColumnType(x.ctype.value), x.nullable, x.scale)
    if dataclasses.is_dataclass(x):
        return _CLASSES[type(x)](**{f.name: _convert(getattr(x, f.name))
                                    for f in dataclasses.fields(x)})
    assert isinstance(x, (str, int, bool, type(None))), type(x)
    return x


def test_auction_plan_equals_the_reference_optimizer_output():
    want = _convert(optimize(auction_winning_bidders_mir(3)))
    assert auction_plan(3) == want
    assert auction_plan(3).schema() == want.schema()


# -- TopKOp ----------------------------------------------------------------------

CAP = 256


def _kschema(mod):
    C, T = mod.Column, mod.ColumnType
    return mod.Schema([C("id", T.INT64), C("g", T.INT64), C("a", T.INT64, True),
                       C("b", T.INT32)])


CASES = {
    # (order_by, limit, offset)
    "desc_limit": (((2, True, False),), 3, 0),
    "asc_nulls_last_offset": (((2, False, True),), 2, 1),
    "two_columns_nulls_first_no_limit": (((2, True, False), (3, False, False)), None, 2),
}


def _ksteps():
    """Six steps of (cols, nulls, diff) over 6 groups of up to ~15 rows,
    with amounts from 0..4 (ties) and NULLs."""
    rng = np.random.default_rng(17)
    n = 90
    ids = np.arange(n, dtype=np.int64)
    g = rng.integers(0, 6, n)
    a = rng.integers(0, 5, n)
    an = rng.random(n) < 0.2
    b = rng.integers(0, 3, n).astype(np.int32)

    def take(idx, d):
        return [ids[idx], g[idx], a[idx], b[idx]], [None, None, an[idx], None], \
            np.full(len(idx), d, np.int64)

    group0 = np.nonzero(g[:60] == 0)[0]
    return [take(np.arange(0, 40), 1), take(np.arange(40, 60), 1),
            take(np.arange(5, 25, 2), -1), take(np.arange(60, 90), 1),
            take(group0, -1), take(np.arange(5, 25, 4), 1)]


def _valid(b):
    n = int(b.count)
    cols = [np.asarray(c)[:n] if not isinstance(c, torch.Tensor) else c[:n].numpy()
            for c in (*b.cols, b.diff)]
    nulls = [None if x is None else (np.asarray(x)[:n] if not isinstance(x, torch.Tensor)
                                     else x[:n].numpy()) for x in b.nulls]
    return cols, nulls


def _same(jb, tb):
    jc, jn = _valid(jb)
    tc, tn = _valid(tb)
    for a, b in zip(jc, tc):
        assert np.array_equal(a, b)
    for a, b in zip(jn, tn):
        # a mask that is absent on one side must be all False on the other
        if a is not None or b is not None:
            a = np.zeros(len(jc[0]), bool) if a is None else a
            b = np.zeros(len(tc[0]), bool) if b is None else b
            assert np.array_equal(a, b)


@pytest.mark.parametrize("case", list(CASES))
def test_topk_op_steps_match_reference(case):
    order_by, limit, offset = CASES[case]
    jop = JTopKOp(_kschema(jschema), (1,), order_by, limit, offset)
    top = TTopKOp(_kschema(tschema), (1,), order_by, limit, offset)
    assert top.state_key == jop.state_key and top.n_order_lanes == jop.n_order_lanes
    jstep = jax.jit(jop.step)
    jstate, tstate = jop.init_state(CAP), top.init_state(CAP, device="cpu")
    emitted = 0
    for t, (cols, nulls, diff) in enumerate(_ksteps(), start=1):
        time = np.full(len(diff), t, np.uint64)
        jb = JBatch.from_numpy(_kschema(jschema), cols, time, diff, capacity=CAP, nulls=nulls)
        tb = TBatch.from_numpy(_kschema(tschema), cols, time, diff, capacity=CAP,
                               nulls=nulls, device="cpu")
        jstate, jout, jovf = jstep(jstate, jb, jnp.asarray(t, jnp.uint64))
        tstate, tout, tovf = top.step(tstate, tb, t)
        assert bool(jovf[0]) == bool(tovf[0]) is False
        _same(jstate[0].batch, tstate[0].batch)
        _same(jout, tout)
        emitted += int(tout.count)
    assert emitted > 0


# -- the auction dataflow ----------------------------------------------------------

GEN = dict(seed=42, n_users=64, auctions_per_tick=8, bids_per_auction=8, retract_after=4)
STATE_CAP, SPAN = 256, 8


def _multiset(rows):
    out = {}
    for r in rows:
        out[r[:-2]] = out.get(r[:-2], 0) + r[-1]
    return {k: d for k, d in out.items() if d}


def _port_dataflow():
    return Dataflow(auction_plan(3), state_cap=STATE_CAP, device="cpu")


def _tiers(df):
    return [[p.batch.capacity for p in parts] for parts in df.states]


def test_auction_dataflow_matches_reference():
    jdf = JDataflow(optimize(auction_winning_bidders_mir(k=3)), state_cap=STATE_CAP)
    tdf = _port_dataflow()
    gen = JGen(**GEN)
    fed: dict = {}

    def feed(dfs, jbatches, overflow=False):
        jdf.run_steps([{"bids": b} for b in jbatches], defer_check=True)
        assert jdf.check_flags() is overflow
        for b in jbatches:
            for r in b.to_rows():
                fed[r[:-2]] = fed.get(r[:-2], 0) + r[-1]
        for df in dfs:
            tin = [{"bids": interop.batch_from_numpy(_jbatch_dict(b), BIDS_SCHEMA, "cpu")}
                   for b in jbatches]
            before = df._readbacks
            df.run_steps(tin, defer_check=True)
            assert df.check_flags() is overflow
            assert df._readbacks - before == (2 if overflow else 1)

    def same(df):
        got = df.peek()
        assert got == jdf.peek()
        want = {(r[1],): 1 for r in _oracle_topk(fed, 3)}
        assert _multiset(got) == want and len(want) > 10
        assert df.peek_errors() == jdf.peek_errors() == []
        assert df.time == jdf.time and df._compact_tick == jdf._compact_tick
        assert _tiers(df) == _tiers(jdf)

    feed([tdf], [gen.tick(i, i)["bids"] for i in range(8)], overflow=True)
    assert _tiers(tdf) == [[STATE_CAP], [2 * STATE_CAP]]  # Distinct, TopK
    same(tdf)
    cdf = _port_dataflow()
    interop.install_state(
        cdf, [[_jdict_arrangement(p) for p in parts] for parts in jdf.states],
        _jspine_dict(jdf.output), _jdict_arrangement(jdf.err_output), jdf.time,
        jdf._compact_tick,
    )
    assert cdf.peek() == jdf.peek()
    for first in (8, 8 + SPAN):
        feed([tdf, cdf], [gen.tick(i, i)["bids"] for i in range(first, first + SPAN)])
        same(tdf)
        same(cdf)
    assert tdf._folds > 0
