"""Port parity for the pagerank slice: the linear join, LetRec and the
pagerank dataflow.

1. ``JoinOp.step`` equals the jitted reference op over five steps with
   NULL keys on both sides, retractions and a FLOAT64 payload: both
   spines (every run) and the output delta after every step, then a
   step that overflows the join's output tier and the left spine's
   tail in both packages (the flags and the truncated state equal).
2. ``tests/test_letrec.py``'s transitive-closure cases (a chain grown
   by an edge, a random DAG over three ticks, an acyclic retraction)
   render in the port and equal that test's closure oracle. Two more
   cases pin the value evaluations a tick: a chain whose fixpoint takes
   4 (the fourth yields no delta), and a chain cut by ``max_iters`` 3,
   whose result holds exactly the paths of at most 3 edges.
3. Pagerank against the reference: ``test_torch_pagerank_ref.py`` (a
   file of its own, so that parallel test workers spread the two).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from materialize_tpu.ops.join import JoinOp as JJoinOp
from materialize_tpu.repr import schema as jschema
from materialize_tpu.repr.batch import Batch as JBatch
from materialize_tpu_torch.expr import relation as tmir
from materialize_tpu_torch.expr.scalar import ColumnRef
from materialize_tpu_torch.ops.join import JoinOp as TJoinOp
from materialize_tpu_torch.render.dataflow import Dataflow
from materialize_tpu_torch.repr import schema as tschema
from materialize_tpu_torch.repr.batch import Batch as TBatch
from materialize_tpu_torch.workloads.pagerank import EDGE_SCHEMA
from tests.test_letrec import _closure


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's eager ops here are small: one intra-op thread runs them
    about as fast, and does not contend with other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(jb, tb):
    """Valid rows equal: columns (floats bit for bit), masks, diffs."""
    n = int(jb.count)
    assert int(tb.count) == n
    for a, b in zip((*jb.cols, jb.diff), (*tb.cols, tb.diff)):
        a, b = _host(a)[:n], _host(b)[:n]
        if a.dtype == np.float64:
            a, b = a.view(np.int64), b.view(np.int64)
        assert np.array_equal(a, b)
    for a, b in zip(jb.nulls, tb.nulls):
        a = np.zeros(n, bool) if a is None else _host(a)[:n]
        b = np.zeros(n, bool) if b is None else _host(b)[:n]
        assert np.array_equal(a, b)


# -- JoinOp --------------------------------------------------------------------

def _lschema(mod):
    C, T = mod.Column, mod.ColumnType
    return mod.Schema([C("k", T.INT64, True), C("a", T.INT64)])


def _rschema(mod):
    C, T = mod.Column, mod.ColumnType
    return mod.Schema([C("v", T.FLOAT64, True), C("k", T.INT64, True)])


def _join_steps():
    """(left rows, right rows) per step: (cols, nulls, diff) each."""
    rng = np.random.default_rng(23)

    def left(n, d):
        k = rng.integers(0, 12, n)
        return [k, rng.integers(0, 5, n)], [rng.random(n) < 0.15, None], np.full(n, d)

    def right(n, d):
        return ([rng.standard_normal(n), rng.integers(0, 12, n)],
                [rng.random(n) < 0.1, rng.random(n) < 0.15], np.full(n, d))

    steps = [(left(30, 1), right(20, 1)), (left(25, 1), right(15, 1))]
    (lc, ln, _), (rc, rn, _) = steps[0]
    # retract what step 0 inserted, half of it
    steps.append(((lc, ln, np.full(30, -1))[:2] + (np.where(np.arange(30) < 15, -1, 0),),
                  ([c[:10] for c in rc], [None if m is None else m[:10] for m in rn],
                   np.full(10, -1))))
    steps.append((left(10, 1), right(0, 1)))
    steps.append((left(0, 1), right(12, 1)))
    return steps


def _jb(mod, schema, rows, t, cap):
    cols, nulls, diff = rows
    diff = np.asarray(diff, np.int64)
    keep = diff != 0
    cols = [np.asarray(c)[keep] for c in cols]
    nulls = [None if m is None else np.asarray(m)[keep] for m in nulls]
    kw = {} if mod is JBatch else {"device": "cpu"}
    return mod.from_numpy(schema, cols, np.full(keep.sum(), t, np.uint64), diff[keep],
                          capacity=cap, nulls=nulls, **kw)


def test_join_op_steps_match_reference():
    jop = JJoinOp(_lschema(jschema), _rschema(jschema), (0,), (1,))
    top = TJoinOp(_lschema(tschema), _rschema(tschema), (0,), (1,))
    assert [c.nullable for c in top.left_state_schema.columns] == [
        c.nullable for c in jop.left_state_schema.columns]
    jstep = jax.jit(jop.step, static_argnums=(4,))
    jstate = jop.init_state(256, tail_capacity=256)
    tstate = top.init_state(256, tail_capacity=256, device="cpu")
    out_rows = 0
    for t, (lrows, rrows) in enumerate(_join_steps(), start=1):
        jl, jr = (_jb(JBatch, s(jschema), r, t, 256)
                  for s, r in ((_lschema, lrows), (_rschema, rrows)))
        tl, tr = (_jb(TBatch, s(tschema), r, t, 256)
                  for s, r in ((_lschema, lrows), (_rschema, rrows)))
        jstate, jout, jsovf, jjovf = jstep(jstate, jl, jr, t, 1024)
        tstate, tout, tsovf, tjovf = top.step(tstate, tl, tr, t, 1024)
        assert not bool(jjovf) and not bool(tjovf)
        assert {k: bool(v) for k, v in jsovf.items()} == {k: bool(v) for k, v in tsovf.items()}
        for jsp, tsp in zip(jstate, tstate):
            for jrun, trun in zip(jsp.runs_b, tsp.runs_b):
                _same(jrun, trun)
        _same(jout, tout)
        out_rows += int(tout.count)
    assert out_rows > 50
    # one step past the left tail (256) and the output tier (64)
    rng = np.random.default_rng(5)
    big = ([rng.integers(0, 12, 300), np.arange(300)], [None, None], np.ones(300))
    jl, tl = _jb(JBatch, _lschema(jschema), big, 9, 512), _jb(TBatch, _lschema(tschema), big,
                                                                 9, 512)
    jr = JBatch.empty(_rschema(jschema), 256)
    tr = TBatch.empty(_rschema(tschema), 256, device="cpu")
    jstate, jout, jsovf, jjovf = jstep(jstate, jl, jr, 9, 64)
    tstate, tout, tsovf, tjovf = top.step(tstate, tl, tr, 9, 64)
    assert bool(jjovf) and bool(tjovf)
    assert bool(jsovf[(0, "tail")]) and bool(tsovf[(0, "tail")])
    _same(jstate[0].runs_b[0], tstate[0].runs_b[0])
    _same(jout, tout)


# -- LetRec: transitive closure ----------------------------------------------------

def _tc_mir(max_iters=None):
    """reach = DISTINCT(edges ∪ project(reach ⋈ edges on dst = src))."""
    edges = tmir.Get("edges", EDGE_SCHEMA)
    reach = tmir.Get("reach", EDGE_SCHEMA)
    step = tmir.Join((reach, edges), ((ColumnRef(1), ColumnRef(2)),)).project((0, 3))
    value = tmir.Union((edges, step)).distinct()
    return tmir.LetRec(names=("reach",), values=(value,), value_schemas=(EDGE_SCHEMA,),
                       body=tmir.Get("reach", EDGE_SCHEMA), max_iters=max_iters)


def _edges(pairs, diffs=None, time=0):
    arr = np.array(sorted(pairs), dtype=np.int64).reshape(-1, 2)
    d = np.ones(len(arr), np.int64) if diffs is None else np.asarray(diffs, np.int64)
    return {"edges": TBatch.from_numpy(EDGE_SCHEMA, [arr[:, 0], arr[:, 1]],
                                       np.full(len(arr), time, np.uint64), d, device="cpu")}


def _peek_set(df):
    acc = {}
    for r in df.peek():
        acc[r[:-2]] = acc.get(r[:-2], 0) + r[-1]
    assert all(v == 1 for v in acc.values())
    return set(acc)


def test_closure_chain_and_incremental_growth():
    df = Dataflow(_tc_mir(), device="cpu")
    e = {(0, 1), (1, 2), (2, 3)}
    df.step(_edges(e))
    assert _peek_set(df) == _closure(e)
    # the fixpoint of a 3-edge chain: paths of 1, 2, 3 edges, then none
    assert df._ctx.letrec_evals == [4]
    e.add((3, 4))
    df.step(_edges({(3, 4)}, time=1))
    assert _peek_set(df) == _closure(e)


def test_closure_branching_random_dag():
    rng = np.random.default_rng(7)
    df = Dataflow(_tc_mir(), device="cpu")
    e = set()
    for t in range(3):
        src = rng.integers(0, 12, 15)
        dst = np.minimum(src + rng.integers(1, 4, 15), 14)
        pairs = {(int(a), int(b)) for a, b in zip(src, dst) if a != b} - e
        e |= pairs
        df.step(_edges(pairs, time=t))
        assert _peek_set(df) == _closure(e)


def test_closure_acyclic_retraction():
    df = Dataflow(_tc_mir(), device="cpu")
    df.step(_edges({(0, 1), (1, 2), (0, 2)}))
    assert _peek_set(df) == {(0, 1), (1, 2), (0, 2)}
    df.step(_edges({(0, 1)}, diffs=[-1], time=1))
    assert _peek_set(df) == {(1, 2), (0, 2)}


def test_closure_stops_at_the_recursion_limit():
    """``max_iters`` 3 on an 8-edge chain: evaluation k adds the paths of
    k + 1 edges, so the result is every path of at most 3 edges, and
    the tick ran exactly 3 evaluations."""
    df = Dataflow(_tc_mir(max_iters=3), device="cpu")
    df.step(_edges({(i, i + 1) for i in range(8)}))
    assert _peek_set(df) == {(i, j) for i in range(9) for j in range(i + 1, min(i + 4, 9))}
    assert df._ctx.letrec_evals == [3]
