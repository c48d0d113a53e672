"""Port parity for pagerank (``workloads/pagerank.py``) on 200 nodes and
1,000 edges, ``max_iters`` 60, ``state_cap`` 256, in both packages on
the same numpy batches: one hydrate tick, then 4 churn ticks rewiring
16 edges each (one flags readback). Both LetRec tiers start at 256: the
hydrate tick's second evaluation (200 retractions and 200 insertions)
overflows it in both packages, which roll back, double it and replay.
After hydration and after the churn, ``peek()`` equals the reference's
EXACTLY, ranks bit for bit: the port sums every float group in the
reference's row order (``ops/reduce.py:_run_sums``). Keys and
multiplicities are exact (one row per node, multiplicity 1), every tick
runs 60 evaluations (the recursion limit stops it, not convergence),
and the ranks hold within rel 1e-3 of the graph's power-iteration
fixpoint (warm-started ticks of 60 evaluations). One reference dataflow
in the file: its compiles dominate the run time. Split from
``test_torch_pagerank.py`` so that parallel test workers spread the two.
"""

from __future__ import annotations

import numpy as np

from materialize_tpu.render.dataflow import Dataflow as JDataflow
from materialize_tpu.repr import schema as jschema
from materialize_tpu.repr.batch import Batch as JBatch
from materialize_tpu.workloads.pagerank import pagerank_mir as jpagerank_mir
from materialize_tpu_torch.render.dataflow import Dataflow
from materialize_tpu_torch.repr.batch import Batch as TBatch
from materialize_tpu_torch.workloads.pagerank import EDGE_SCHEMA, pagerank_mir
from tests.test_letrec import _pagerank_oracle
from tests.test_torch_pagerank import _one_torch_thread  # noqa: F401

N_NODES, N_EDGES, PER_TICK, MAX_ITERS, LR_CAP = 200, 1000, 16, 60, 256



def _fixpoint(src, dst, iters=400):
    return _pagerank_oracle(list(zip(src.tolist(), dst.tolist())), n_iters=iters)


def test_pagerank_matches_reference():
    jedge = jschema.Schema([jschema.Column("src", jschema.ColumnType.INT64),
                            jschema.Column("dst", jschema.ColumnType.INT64)])
    jdf = JDataflow(jpagerank_mir(jedge, max_iters=MAX_ITERS))
    tdf = Dataflow(pagerank_mir(EDGE_SCHEMA, max_iters=MAX_ITERS), device="cpu")
    assert tdf.state_cap == jdf._ctx.state_cap == 256
    jdf._ctx.letrec_caps[0] = tdf._ctx.letrec_caps[0] = LR_CAP
    rng = np.random.default_rng(42)
    src = rng.integers(0, N_NODES, N_EDGES).astype(np.int64)
    dst = rng.integers(0, N_NODES, N_EDGES).astype(np.int64)

    def both(cols, t, diffs, cap=None):
        return (JBatch.from_numpy(jedge, cols, np.uint64(t), diffs, capacity=cap),
                TBatch.from_numpy(EDGE_SCHEMA, cols, np.uint64(t), diffs, capacity=cap,
                                  device="cpu"))

    def feed(pairs, overflow):
        jdf.run_steps([{"edges": j} for j, _ in pairs], defer_check=True)
        assert jdf.check_flags() is overflow
        before = tdf._readbacks
        tdf.run_steps([{"edges": t} for _, t in pairs], defer_check=True)
        assert tdf.check_flags() is overflow
        assert tdf._readbacks - before == (2 if overflow else 1)

    def same():
        got = tdf.peek()
        assert got == jdf.peek()
        ranks = {r[0]: r[1] for r in got}
        assert len(ranks) == len(got) and all(r[-1] == 1 for r in got)
        want = _fixpoint(src, dst)
        assert set(ranks) == set(want)
        assert max(abs(ranks[n] - want[n]) / want[n] for n in want) < 1e-3

    feed([both([src, dst], 0, np.ones(N_EDGES, np.int64))], overflow=True)
    assert jdf._ctx.letrec_caps == tdf._ctx.letrec_caps == [2 * LR_CAP]
    assert tdf._ctx.letrec_evals == [MAX_ITERS, MAX_ITERS]  # overflowed, replayed
    same()
    ticks = []
    for i in range(4):
        r2 = np.random.default_rng(1000 + i)
        idx = r2.choice(N_EDGES, PER_TICK, replace=False)
        new_dst = r2.integers(0, N_NODES, PER_TICK).astype(np.int64)
        cols = [np.concatenate([src[idx], src[idx]]), np.concatenate([dst[idx], new_dst])]
        diffs = np.concatenate([-np.ones(PER_TICK, np.int64), np.ones(PER_TICK, np.int64)])
        dst[idx] = new_dst
        # the hydrate tick's tier: one step program in the reference
        ticks.append(both(cols, 1 + i, diffs, cap=1024))
    feed(ticks, overflow=False)
    assert tdf._ctx.letrec_evals[2:] == [MAX_ITERS] * 4
    same()
