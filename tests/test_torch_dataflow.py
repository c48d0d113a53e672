"""Port parity for the slice as a whole: the maintained lineitem index.

One small index configuration (the layout of the reference bench's
``config_index``: append-slot ring, ``ce = ratio = 4``) runs in both
packages on the SAME numpy batches (string codes depend on each
package's own dictionary, so the port never re-generates them). The
schedule: hydrate (one span), churn span 1, churn span 2 — whose
level-1 fold overflows the deliberately small base, so both packages
roll back, grow the base one tier and replay. After every span the
maintained multisets, run capacities and cursors must agree exactly,
and the port reads its flags back once per span. The peek cores are
held against the reference's ``coord/peek.py`` cores, and a reference
spine carried across with ``interop.spine_from_numpy`` continues in
the port with the same result. One reference dataflow in the file:
its compiles dominate the run time."""

from __future__ import annotations

from collections import Counter

import jax
import numpy as np
import pytest
import torch

import bench
from materialize_tpu.coord import peek as jpeek
from materialize_tpu.expr import relation as jmir
from materialize_tpu.storage.generator.tpch import LINEITEM_SCHEMA as J_LINEITEM
from materialize_tpu.storage.generator.tpch import TpchGenerator as JGen
from materialize_tpu_torch import interop
from materialize_tpu_torch.coord import peek as tpeek
from materialize_tpu_torch.storage.generator.tpch import LINEITEM_SCHEMA
from materialize_tpu_torch.workloads.index import build_index_dataflow


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's eager ops here are small: one intra-op thread runs them
    about as fast, and does not contend with other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

SF, ORDERS_PER_TICK, CE = 0.002, 16, 4
LAYOUT = dict(n_orders_per_tick=ORDERS_PER_TICK, state_cap=1 << 12,
              out_levels=2, ce=CE, ratio=4, slots=True)
# Run 0 holds the whole state; the base (8192) is one tier short of the
# ~12k rows the first level-1 fold (tick 16) moves into it.
SIZES = [(("out", 0), 1 << 14), (("out", 1), 1 << 13)]


def _jbatch_dict(b):
    return {
        "cols": [np.asarray(c) for c in b.cols],
        "nulls": [None if x is None else np.asarray(x) for x in b.nulls],
        "time": np.asarray(b.time),
        "diff": np.asarray(b.diff),
        "count": int(b.count),
        "hints": tuple(b.hints),
    }


def _jspine_dict(sp):
    return {
        "runs": [_jbatch_dict(r) for r in sp.runs_b],
        "slots": [_jbatch_dict(s) for s in sp.slots],
        "lanes": [np.asarray(l) for l in sp.lanes],
        "slot_lanes": [np.asarray(l) for l in sp.slot_lanes],
        "cursor": int(sp.cursor or 0),  # None without a slot ring
        "key": sp.key,
        "order": sp.order,
    }


def _multiset(batches):
    """Consolidated (row -> diff) over every run and slot (time ignored:
    runs fold content across times)."""
    acc = Counter()
    for cols, diff, n in batches:
        for i in range(n):
            acc[tuple(int(c[i]) for c in cols)] += int(diff[i])
    return {k: v for k, v in acc.items() if v}


def _jmultiset(sp):
    return _multiset(
        ([np.asarray(c) for c in b.cols], np.asarray(b.diff), int(b.count))
        for b in list(sp.runs_b) + list(sp.slots)
    )


def _tmultiset(sp):
    return _multiset(
        ([c.numpy() for c in b.cols], b.diff.numpy(), int(b.count))
        for b in list(sp.runs_b) + list(sp.slots)
    )


def _same_state(jdf, tdf):
    js, ts = jdf.output, tdf.output
    assert [b.capacity for b in js.runs_b] == [b.capacity for b in ts.runs_b]
    assert [b.capacity for b in js.slots] == [b.capacity for b in ts.slots]
    assert int(js.cursor) == ts.cursor
    assert jdf._compact_tick == tdf._compact_tick and jdf.time == tdf.time
    want = _jmultiset(js)
    assert _tmultiset(ts) == want
    return want


def test_index_dataflow_matches_reference():
    jdf, _, _ = bench._tpch_lineitem_config(
        jmir.Get("lineitem", J_LINEITEM), sf=SF, **LAYOUT
    )
    tdf, h_orders, churn_cap = build_index_dataflow(device="cpu", **LAYOUT)
    for key, cap in SIZES:
        jdf._grow_for(key, target=cap)
        tdf._grow_for(key, target=cap)
    jdf._remake_jit()
    gen = JGen(sf=SF, seed=42)

    def feed(jbatches):
        """One span of the same batches into both; returns port inputs."""
        tin = [
            {"lineitem": interop.batch_from_numpy(_jbatch_dict(b), LINEITEM_SCHEMA, "cpu")}
            for b in jbatches
        ]
        jdf.run_steps([{"lineitem": b} for b in jbatches], defer_check=True)
        before = tdf._readbacks
        tdf.run_span(tin)
        over = (jdf.check_flags(), tdf.check_flags())
        return tin, over, tdf._readbacks - before

    hyd = list(gen.snapshot_lineitem_batches(batch_orders=h_orders, capacity=4096))
    assert len(hyd) == CE
    _, over, rb = feed(hyd)
    assert over == (False, False) and rb == 1
    _same_state(jdf, tdf)

    def churn_span(first_tick):
        return [
            gen.churn_lineitem_batch(ORDERS_PER_TICK, tick=i, time=jdf.time + i - first_tick,
                                     capacity=churn_cap)
            for i in range(first_tick, first_tick + 2 * CE)
        ]

    _, over, rb = feed(churn_span(0))
    assert over == (False, False) and rb == 1
    _same_state(jdf, tdf)

    # Carry the reference spine across and continue it in the port.
    cdf, _, _ = build_index_dataflow(device="cpu", **LAYOUT)
    cdf.output = interop.spine_from_numpy(_jspine_dict(jdf.output), LINEITEM_SCHEMA, "cpu")
    cdf.out_delta_cap = tdf.out_delta_cap
    cdf._time, cdf._compact_tick = jdf.time, jdf._compact_tick
    assert _tmultiset(cdf.output) == _tmultiset(tdf.output)
    # ... and back: the port's numpy form is the reference's state
    back = interop.spine_to_numpy(cdf.output)
    ref = _jspine_dict(jdf.output)
    assert back["cursor"] == ref["cursor"] and back["order"] == ref["order"]
    for got, want in zip(back["runs"] + back["slots"], ref["runs"] + ref["slots"]):
        assert got["count"] == want["count"]
        assert np.array_equal(got["time"], want["time"])
        for a, b in zip(got["cols"] + [got["diff"]], want["cols"] + [want["diff"]]):
            assert np.array_equal(a, b)
    for a, b in zip(back["lanes"] + back["slot_lanes"], ref["lanes"] + ref["slot_lanes"]):
        assert a.dtype == np.uint64 and np.array_equal(a, b)

    span2 = churn_span(2 * CE)
    tin, over, rb = feed(span2)
    # The level-1 fold at tick 16 overflowed the base in both: rolled
    # back, grown one tier, replayed (the replay costs one more read).
    assert over == (True, True) and rb == 2
    assert tdf.output.base.capacity == 1 << 14
    want = _same_state(jdf, tdf)
    cdf.run_span(tin)
    assert cdf.check_flags() is True
    assert _tmultiset(cdf.output) == want

    # -- peek cores against the reference's ------------------------------
    jcols, jnulls, jtime, jdiff, jvalid = jax.jit(jpeek._scan_core)(jdf.output)
    tcols, tnulls, ttime, tdiff, tvalid = tpeek._scan_core(tdf.output)
    assert np.array_equal(np.asarray(jvalid), tvalid.numpy())
    m = tvalid.numpy()
    for a, b in zip(jcols, tcols):
        assert np.array_equal(np.asarray(a)[m], b.numpy()[m])
    assert np.array_equal(np.asarray(jdiff)[m], tdiff.numpy()[m])

    rows = sorted(want)
    rng = np.random.default_rng(5)
    keys = [rows[i][0] for i in rng.integers(0, len(rows), 6)] + [10**9]
    span = 16
    B = 8
    jarr, jok = jpeek._probe_arrays(jdf.out_schema, (0,), [(k,) for k in keys], B)
    tarr, tok = tpeek._probe_arrays(tdf.out_schema, (0,), [(k,) for k in keys], B, "cpu")
    jl = jax.jit(jpeek._make_lookup_core((0,), span))(jdf.output, jarr, jok)
    tl = tpeek._make_lookup_core((0,), span, chunk=3)(tdf.output, tarr, tok)
    jcnt, tcnt = np.asarray(jl[4]), tl[4].numpy()
    assert np.array_equal(jcnt, tcnt) and tcnt.max() <= span
    for i in range(len(keys)):
        k = int(tcnt[i])
        for a, b in zip(jl[0], tl[0]):
            assert np.array_equal(np.asarray(a)[i, :k], b.numpy()[i, :k])
        assert np.array_equal(np.asarray(jl[3])[i, :k], tl[3].numpy()[i, :k])

    probes = [rows[i] for i in rng.integers(0, len(rows), 6)] + [tuple([0] * 13)]
    jarr, jok = jpeek._probe_arrays(jdf.out_schema, tuple(range(13)), probes, B)
    tarr, tok = tpeek._probe_arrays(tdf.out_schema, tuple(range(13)), probes, B, "cpu")
    jnet, jneed = jax.jit(jpeek._make_point_core(jdf.out_schema, span))(jdf.output, jarr, jok)
    tnet, tneed = tpeek._make_point_core(tdf.out_schema, span)(tdf.output, tarr, tok)
    assert np.array_equal(np.asarray(jnet), tnet.numpy())
    assert np.array_equal(np.asarray(jneed), tneed.numpy())
    assert [int(x) for x in tnet.numpy()[: len(probes)]] == [want.get(p, 0) for p in probes]

    # host glue and the compacting read agree with the multiset
    assert list(tpeek.point_net(tdf, probes)) == [want.get(p, 0) for p in probes]
    groups = tpeek.lookup_arrays(tdf, (0,), [(k,) for k in keys])
    for k, (cols, _, _, diff) in zip(keys, groups):
        got = _multiset([(cols, diff, len(diff))])
        assert got == {r: d for r, d in want.items() if r[0] == k}
    before = tdf._readbacks
    peeked = {r[:-2]: r[-1] for r in tdf.peek()}
    assert peeked == want
    assert tdf._readbacks - before == 1  # the compaction's flags
    assert torch.equal(tdf.output.base.count, torch.tensor(len(want), dtype=torch.int32))
