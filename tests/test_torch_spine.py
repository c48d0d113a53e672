"""Port parity: Spine contents and cached lanes through inserts and folds.

Same schedule as the reference's
``test_cached_lanes_match_recompute_through_folds``: a 3-level spine
with a 4-slot ring, 12 random inserts (duplicate-dense keys,
retractions, NULLs), every level folded after every 4th insert. The
port and the reference are fed the same numpy batches; after every
operation each run and slot must hold the same rows (NULL-masked),
counts and cached lanes (mapped back to u64), exactly."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from materialize_tpu.arrangement import spine as js
from materialize_tpu.repr.batch import Batch as JBatch
from materialize_tpu.repr.schema import Column as JColumn
from materialize_tpu.repr.schema import ColumnType as JType
from materialize_tpu.repr.schema import Schema as JSchema
from materialize_tpu_torch.arrangement import spine as ts
from materialize_tpu_torch.ops.lanes import to_u64
from materialize_tpu_torch.repr.batch import Batch as TBatch
from materialize_tpu_torch.repr.schema import Column, ColumnType, Schema


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's eager ops here are small: one intra-op thread runs them
    about as fast, and does not contend with other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

JNSCH = JSchema(
    (JColumn("k", JType.INT64), JColumn("v", JType.INT64, nullable=True))
)
TNSCH = Schema(
    (Column("k", ColumnType.INT64), Column("v", ColumnType.INT64, nullable=True))
)


def _rand(rng, t):
    n = int(rng.integers(1, 80))
    ks = rng.integers(0, 40, n)
    vs = rng.integers(0, 3, n)
    ds = rng.choice([-1, 1, 1, 2], n).astype(np.int64)
    nl = rng.random(n) < 0.2
    args = ([ks, vs], np.uint64(t), ds)
    return (
        JBatch.from_numpy(JNSCH, *args, capacity=256, nulls=[None, nl]),
        TBatch.from_numpy(TNSCH, *args, capacity=256, nulls=[None, nl], device="cpu"),
    )


def _content(cols, nulls, diff, n):
    return [
        tuple(
            None if nulls[j] is not None and nulls[j][i] else int(cols[j][i])
            for j in range(len(cols))
        ) + (int(diff[i]),)
        for i in range(n)
    ]


def _same_batch(jb, tb):
    n = int(jb.count)
    assert int(tb.count) == n and jb.capacity == tb.capacity
    jc = [np.asarray(c) for c in jb.cols]
    jn = [None if x is None else np.asarray(x) for x in jb.nulls]
    tc = [c.numpy() for c in tb.cols]
    tn = [None if x is None else x.numpy() for x in tb.nulls]
    assert _content(jc, jn, np.asarray(jb.diff), n) == _content(
        tc, tn, tb.diff.numpy(), n
    )
    return n


def _same_spine(jsp, tsp):
    assert len(jsp.runs_b) == len(tsp.runs_b) and len(jsp.slots) == len(tsp.slots)
    assert int(jsp.cursor) == tsp.cursor
    for jr, tr, jl, tl in zip(jsp.runs_b, tsp.runs_b, jsp.lanes, tsp.lanes):
        n = _same_batch(jr, tr)
        assert np.array_equal(np.asarray(jl)[:n], to_u64(tl)[:n])
    for jr, tr, jl, tl in zip(jsp.slots, tsp.slots, jsp.slot_lanes, tsp.slot_lanes):
        n = _same_batch(jr, tr)
        assert np.array_equal(np.asarray(jl)[:n], to_u64(tl)[:n])


@pytest.mark.parametrize("order", ["hash", "exact"])
def test_spine_matches_reference_through_folds(order):
    rng = np.random.default_rng(17)
    kw = dict(capacity=1 << 12, tail_capacity=512, order=order, levels=3,
              ratio=4, ingest_slots=4, cache_lanes=True)
    jsp = js.Spine.empty(JNSCH, (0, 1), **kw)
    tsp = ts.Spine.empty(TNSCH, (0, 1), device="cpu", **kw)
    _same_spine(jsp, tsp)
    # jitted: one compile per program instead of one per eager op
    j_insert = jax.jit(js.insert_tail)
    j_fold = jax.jit(js.compact_level, static_argnums=1)
    for t in range(12):
        jb, tb = _rand(rng, t)
        jsp, jo = j_insert(jsp, jb)
        tsp, to = ts.insert_tail(tsp, tb)
        assert bool(jo) == bool(to) is False
        _same_spine(jsp, tsp)
        if (t + 1) % 4 == 0:
            for lvl in range(js.compact_depth(jsp)):
                jsp, jo = j_fold(jsp, lvl)
                tsp, to = ts.compact_level(tsp, lvl)
                assert bool(jo) == bool(to) is False
                _same_spine(jsp, tsp)
