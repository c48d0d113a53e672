"""Port parity: merge insertion points and the lane-carrying merge.

The port's plain ``search_right_torch`` (what the CPU runs) is held
exactly against the reference's ``lex_searchsorted_2d(..., "right")``,
the reference's Pallas kernel ``pallas_search_right`` run in interpret
mode (small sizes: the interpreter is slow), and the rows and carried
lanes of ``merge_sorted_cached``. Lanes include values on both sides of
2^63, heavy duplicates, random ``a_count``, n > m and n < m.
The CUDA kernel itself is held against the plain version on a card in
``tests/test_torch_kernel.py``."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from materialize_tpu.arrangement.spine import arrange as j_arrange
from materialize_tpu.ops.merge import merge_sorted_cached as j_merge
from materialize_tpu.ops.merge_pallas import pallas_search_right
from materialize_tpu.ops.search import lex_searchsorted_2d
from materialize_tpu.repr.batch import Batch as JBatch
from materialize_tpu.repr.schema import Column as JColumn
from materialize_tpu.repr.schema import ColumnType as JType
from materialize_tpu.repr.schema import Schema as JSchema
from materialize_tpu_torch import interop
from materialize_tpu_torch.ops.lanes import from_u64, to_u64
from materialize_tpu_torch.ops.merge import merge_sorted_cached, search_right_torch
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

# Heavy duplicates, both sides of the stored form's sign boundary.
_POOL = np.array(
    [0, 1, 2, (1 << 63) - 1, 1 << 63, (1 << 63) + 1, (1 << 64) - 1], dtype=np.uint64
)


def _sorted_lanes(rng, m, L):
    a = _POOL[rng.integers(0, len(_POOL), (m, L))]
    return a[np.lexsort(a.T[::-1])]


def _t(u):
    return torch.from_numpy(np.ascontiguousarray(from_u64(u)))


@pytest.mark.parametrize("L", [1, 3, 4, 8])
@pytest.mark.parametrize("m,n", [(300, 40), (40, 300), (128, 128), (0, 16)])
def test_insertion_points_match_reference(L, m, n):
    rng = np.random.default_rng(L * 1000 + m + n)
    a = _sorted_lanes(rng, m, L)
    b = _sorted_lanes(rng, n, L)
    for count in sorted({0, m, int(rng.integers(0, m + 1))}):
        want = np.asarray(
            lex_searchsorted_2d(jnp.asarray(a), count, jnp.asarray(b), side="right")
        ) if m else np.zeros(n, np.int32)
        got = search_right_torch(_t(a), torch.tensor(count, dtype=torch.int32), _t(b))
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want), (L, m, n, count)


@pytest.mark.parametrize("L", [1, 4])
def test_insertion_points_match_pallas_interpret(L):
    rng = np.random.default_rng(40 + L)
    a = _sorted_lanes(rng, 48, L)
    b = _sorted_lanes(rng, 24, L)
    count = 37
    want = np.asarray(
        pallas_search_right(jnp.asarray(a), count, jnp.asarray(b), 24)
    )
    got = search_right_torch(_t(a), torch.tensor(count, dtype=torch.int32), _t(b))
    assert np.array_equal(got.numpy(), want)


_SPEC = [("k", "INT64", False), ("v", "INT64", True), ("s", "STRING", False)]
# jitted: one compile per program instead of one per eager op
_J_ARRANGE = jax.jit(lambda b: j_arrange(b, (0, 1, 2), order="hash"))
_J_MERGE = jax.jit(j_merge, static_argnums=4)


def _run_batches(rng, n, cap):
    js = JSchema([JColumn(a, JType[t], nullable=nl) for a, t, nl in _SPEC])
    ts = Schema([Column(a, ColumnType[t], nullable=nl) for a, t, nl in _SPEC])
    ks = rng.integers(0, 12, n)
    vs = rng.integers(-3, 3, n)
    ss = rng.integers(-(1 << 62), 1 << 62, 3)[rng.integers(0, 3, n)]
    jb = JBatch.from_numpy(
        js, [ks, vs, ss], np.uint64(7), rng.choice([-1, 1, 2], n).astype(np.int64),
        capacity=cap, nulls=[None, rng.random(n) < 0.25, None],
    )
    arr = _J_ARRANGE(jb)
    lanes = np.asarray(arr.sort_lanes_2d())
    b = arr.batch
    d = {
        "cols": [np.asarray(c) for c in b.cols],
        "nulls": [None if x is None else np.asarray(x) for x in b.nulls],
        "time": np.asarray(b.time), "diff": np.asarray(b.diff),
        "count": int(b.count),
    }
    return (b, jnp.asarray(lanes)), (interop.batch_from_numpy(d, ts, "cpu"), _t(lanes))


@pytest.mark.parametrize("na,nb,out_cap", [(90, 60, 256), (200, 30, 256), (120, 100, 128)])
def test_merge_sorted_cached_matches_reference(na, nb, out_cap):
    rng = np.random.default_rng(na + nb)
    (ja, jal), (ta, tal) = _run_batches(rng, na, 256)
    (jb, jbl), (tb, tbl) = _run_batches(rng, nb, 128)
    jm, jml, jovf = _J_MERGE(ja, jal, jb, jbl, out_cap)
    tm, tml, tovf = merge_sorted_cached(ta, tal, tb, tbl, out_cap)
    assert bool(jovf) == bool(tovf)
    n = int(jm.count)
    assert int(tm.count) == n
    # whole capacity: padding rows must carry the same zeroed diff/time
    for a, b in zip(jm.cols, tm.cols):
        assert np.array_equal(np.asarray(a)[:n], b.numpy()[:n])
    for a, b in zip(jm.nulls, tm.nulls):
        assert (a is None) == (b is None)
        if a is not None:
            assert np.array_equal(np.asarray(a)[:n], b.numpy()[:n])
    assert np.array_equal(np.asarray(jm.diff), tm.diff.numpy())
    assert np.array_equal(np.asarray(jm.time), tm.time.numpy().view(np.uint64))
    assert np.array_equal(np.asarray(jml)[:n], to_u64(tml)[:n])



@pytest.mark.parametrize("include_time", [True, False])
def test_sort_compact_consolidate_match_reference(include_time):
    """The unhinted consolidate (hash pair, stable sort cascade, exact
    adjacent segments), concat_batches, shrink, segment_starts and
    unstack_lanes against the reference."""
    from materialize_tpu.ops import consolidate as jc
    from materialize_tpu.ops import sort as jsrt
    from materialize_tpu_torch.ops import consolidate as tc
    from materialize_tpu_torch.ops import sort as tsrt
    from materialize_tpu_torch.ops.lanes import unstack_lanes

    rng = np.random.default_rng(3 + include_time)
    js = JSchema([JColumn(a, JType[t], nullable=nl) for a, t, nl in _SPEC])
    ts = Schema([Column(a, ColumnType[t], nullable=nl) for a, t, nl in _SPEC])
    jparts, tparts = [], []
    for n, cap in ((70, 128), (150, 256)):
        cols = [rng.integers(0, 6, n), rng.integers(-2, 2, n), rng.integers(0, 2, n)]
        time = rng.integers(0, 3, n).astype(np.uint64)
        diff = rng.choice([-1, 1, 2], n).astype(np.int64)
        nulls = [None, rng.random(n) < 0.3, None]
        jparts.append(JBatch.from_numpy(js, cols, time, diff, capacity=cap, nulls=nulls))
        tparts.append(TBatch.from_numpy(ts, cols, time, diff, capacity=cap, nulls=nulls,
                                        device="cpu"))
    jcat, tcat = jsrt.concat_batches(jparts), tsrt.concat_batches(tparts)
    assert int(jcat.count) == int(tcat.count) == 220
    jcon = jc.consolidate(jcat, include_time=include_time)
    tcon = tc.consolidate(tcat, include_time=include_time)
    assert tcon.hints == jcon.hints
    n = int(jcon.count)
    assert int(tcon.count) == n
    for a, b in zip(jcon.cols + (jcon.diff,), tcon.cols + (tcon.diff,)):
        assert np.array_equal(np.asarray(a)[:n], b.numpy()[:n])
    assert np.array_equal(np.asarray(jcon.time)[:n], tcon.time.numpy().view(np.uint64)[:n])
    jsh, jovf = jsrt.shrink(jcon, 64)
    tsh, tovf = tsrt.shrink(tcon, 64)
    assert bool(jovf) == bool(tovf) and int(jsh.count) == int(tsh.count)
    lanes = [tcon.cols[0].to(torch.int64), tcon.cols[1].to(torch.int64)]
    jst = jsrt.segment_starts([jnp.asarray(l.numpy()) for l in lanes], jcon.count, jcon.capacity)
    tst = tsrt.segment_starts(lanes, tcon.count, tcon.capacity)
    assert np.array_equal(np.asarray(jst), tst.numpy())
    stacked = torch.stack(lanes, dim=1)
    assert all(torch.equal(u, l) for u, l in zip(unstack_lanes(stacked), lanes))
