"""The benchmark's generator copy against the program's TPC-H generator,
and the generator processes' transport."""

import multiprocessing as mp

import numpy as np
import pytest

from ivmbench.gen import feed, tpch

SF, SEED, PER_TICK, TICKS, BATCH = 0.003, 2**31 + 11, 32, 6, 300


def _multiset(cols, diffs):
    """Rows (int64 matrix) with multiplicities, consolidated and sorted."""
    mat = np.stack([np.asarray(c).astype(np.int64) for c in cols] + [np.asarray(diffs)], 1)
    order = np.lexsort(mat[:, :-1].T[::-1])
    mat = mat[order]
    rows, diffs = mat[:, :-1], mat[:, -1]
    starts = np.flatnonzero(np.concatenate(([True], (rows[1:] != rows[:-1]).any(axis=1))))
    sums = np.add.reduceat(diffs, starts)
    keep = sums != 0
    return rows[starts][keep], sums[keep]


def _same(a, b):
    assert a[0].shape == b[0].shape
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


@pytest.fixture(scope="module")
def port():
    from materialize_tpu_torch.repr.schema import GLOBAL_DICT
    from materialize_tpu_torch.storage.generator.tpch import TpchGenerator

    gen = TpchGenerator(sf=SF, seed=SEED)
    flags = [int(c) for c in GLOBAL_DICT.encode_many(list(tpch.RETURNFLAGS))]
    status = [int(c) for c in GLOBAL_DICT.encode_many(list(tpch.LINESTATUSES))]
    return gen, flags, status


def test_snapshot_is_the_programs(port):
    gen, flags, status = port
    ours = tpch.LineitemStream(SF, SEED, flags, status)
    theirs = list(gen.snapshot_lineitem_parts(batch_orders=BATCH))
    n = ours.snapshot_batches(BATCH)
    assert n == len(theirs)
    for i, (cols, diffs) in enumerate(theirs):
        mine = ours.snapshot_batch(i, BATCH)
        _same(_multiset(mine, np.ones(len(mine[0]), np.int64)), _multiset(cols, diffs))
    table = [np.concatenate(c) for c in zip(*ours.table())]
    allp = [np.concatenate(c) for c in zip(*(cols for cols, _ in theirs))]
    _same(_multiset(table, np.ones(len(table[0]))), _multiset(allp, np.ones(len(allp[0]))))


def test_churn_is_the_programs(port):
    gen, flags, status = port
    ours = tpch.LineitemStream(SF, SEED, flags, status)
    for tick in range(TICKS):
        cols, diffs = gen.churn_lineitem_part(PER_TICK, tick)
        mine, my_diffs = ours.churn(PER_TICK, tick)
        assert np.all(np.diff(mine[tpch.COL["l_orderkey"]][my_diffs > 0]) >= 0)
        _same(_multiset(mine, my_diffs), _multiset(cols, diffs))
    # the table after the churn is every order at its last version
    shadow = tpch.LineitemStream(SF, SEED, flags, status)
    rows = [shadow.snapshot_batch(i, BATCH) for i in range(shadow.snapshot_batches(BATCH))]
    parts = [(c, np.ones(len(c[0]), np.int64)) for c in rows]
    parts += [shadow.churn(PER_TICK, t) for t in range(TICKS)]
    fed = [np.concatenate(c) for c in zip(*(p[0] for p in parts))]
    fed_d = np.concatenate([p[1] for p in parts])
    table = [np.concatenate(c) for c in zip(*ours.table())]
    _same(_multiset(table, np.ones(len(table[0]))), _multiset(fed, fed_d))


def test_advance_is_churns_bookkeeping():
    a = tpch.LineitemStream(SF, SEED, [1, 2, 3], [4, 5])
    b = tpch.LineitemStream(SF, SEED, [1, 2, 3], [4, 5])
    for t in range(TICKS):
        a.churn(PER_TICK, t)
        b.advance(PER_TICK, t)
    assert np.array_equal(a.version, b.version)
    with pytest.raises(ValueError):
        b.advance(PER_TICK, TICKS + 1)


def test_source_interface():
    s = tpch.stream(SF, SEED, [1, 2, 3, 4, 5])
    assert list(s.flag_codes) == [1, 2, 3] and list(s.status_codes) == [4, 5]
    assert len(tpch.STRINGS) == 5 and set(tpch.INPUTS) == set(tpch.SCHEMAS)
    cols, diffs = s.snapshot_item(0, BATCH)["lineitem"]
    assert diffs is None and len(cols) == len(tpch.INPUTS["lineitem"])
    assert len(cols[0]) <= tpch.max_rows(PER_TICK, BATCH)
    cols, diffs = s.tick(PER_TICK, 0)["lineitem"]
    assert len(diffs) <= tpch.max_rows(PER_TICK, BATCH) and set(diffs) == {-1, 1}


@pytest.mark.parametrize("n_procs", [1, 3])
def test_feed_hands_every_item_in_order(n_procs):
    plan = dict(source="tpch", sf=SF, seed=SEED, orders_per_tick=PER_TICK, slots=2,
                slot_rows=tpch.max_rows(PER_TICK, BATCH))
    f = feed.Feed(mp.get_context("spawn"), plan, n_procs)
    try:
        f.start([1, 2, 3, 4, 5], BATCH)
        want = tpch.stream(SF, SEED, [1, 2, 3, 4, 5])
        n_snap = want.snapshot_batches(BATCH)
        for i in range(n_snap + TICKS):
            item, made = f.next()
            assert item == i and set(made) == {"lineitem"}
            cols, diffs = made["lineitem"]
            if i < n_snap:
                w, wd = want.snapshot_batch(i, BATCH), np.ones(len(cols[0]), np.int64)
            else:
                w, wd = want.churn(PER_TICK, i - n_snap)
            for got, exp in zip(cols, w):
                assert got.dtype == exp.dtype and np.array_equal(got, exp)
            assert np.array_equal(diffs, wd)
            f.release(item)
    finally:
        f.close()
    assert all(not p.is_alive() for p in f.procs)
