"""The port's CUDA merge-path kernel (``csrc/merge_path.cu``) against its
plain torch versions (``search_right_torch``, ``merge_source_map_torch``).

This file imports neither JAX nor the reference package, so it also runs
on a machine with a card and no JAX; there, skip the suite's conftest
(which imports the reference package):

    python -m pytest tests/test_torch_kernel.py --noconftest -q

Tests marked ``cuda`` skip without a card; besides the kernel, they hold
the FLOAT64 lanes on the card against the CPU's and a SUM_FLOAT reduce's
determinism. The CPU tests pin the wrapper's refusal of CPU tensors (no
silent fallback) and the build layout."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from materialize_tpu_torch.ops import merge_kernel
from materialize_tpu_torch.ops.lanes import from_u64
from materialize_tpu_torch.ops.merge import (
    merge_mode,
    merge_source_map_torch,
    search_right_torch,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's eager ops here are small: one intra-op thread runs them
    about as fast, and does not contend with other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

ROOT = Path(__file__).resolve().parents[1]
_POOL = np.array(
    [0, 1, 2, (1 << 63) - 1, 1 << 63, (1 << 63) + 1, (1 << 64) - 1], dtype=np.uint64
)


def _sorted_lanes(rng, m, L):
    a = _POOL[rng.integers(0, len(_POOL), (m, L))]
    return torch.from_numpy(np.ascontiguousarray(from_u64(a[np.lexsort(a.T[::-1])])))


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def test_wrapper_refuses_cpu_tensors():
    a = torch.zeros((8, 4), dtype=torch.int64)
    c = torch.tensor(8, dtype=torch.int32)
    before = merge_kernel.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        merge_kernel.search_right(a, c, a)
    with pytest.raises(ValueError, match="CUDA"):
        merge_kernel.search_right(a, c, a, c)
    with pytest.raises(ValueError, match="CUDA"):
        merge_kernel.merge_path(a, c, 8, a, c, 16)
    with pytest.raises(ValueError, match="CUDA"):
        merge_kernel.merge_path(a, c, 8, a, c, 16, want_pos=True)
    assert merge_kernel.LAUNCHES == before


def test_build_layout():
    assert merge_kernel.SOURCE.is_file()
    assert "arch=compute_90a,code=sm_90a" in merge_kernel.NVCC_FLAGS
    ignored = (ROOT / ".gitignore").read_text().splitlines()
    assert "materialize_tpu_torch/_build/" in ignored
    assert merge_kernel.BUILD_DIR == ROOT / "materialize_tpu_torch" / "_build"


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    _need_card()
    rng = np.random.default_rng(11)
    for L in (1, 3, 4, 5, 8):
        for m, n in ((3000, 500), (500, 3000), (0, 64)):
            a = _sorted_lanes(rng, m, L).cuda()
            b = _sorted_lanes(rng, n, L).cuda()
            for count in sorted({0, m, int(rng.integers(0, m + 1))}):
                c = torch.tensor(count, dtype=torch.int32, device="cuda")
                before = merge_kernel.LAUNCHES
                got = merge_kernel.search_right(a, c, b)
                assert merge_kernel.LAUNCHES == before + 1
                want = search_right_torch(a, c, b)
                assert torch.equal(got, want), (L, m, n, count)


def _padded(rng, cap, count, L, pool=_POOL):
    """Sorted valid prefix of ``count`` rows, then unsorted padding."""
    valid = pool[rng.integers(0, len(pool), (count, L))]
    valid = valid[np.lexsort(valid.T[::-1])]
    pad = rng.integers(0, 1 << 63, (cap - count, L), dtype=np.uint64) * np.uint64(2)
    return torch.from_numpy(from_u64(np.concatenate([valid, pad]).reshape(cap, L)))


def _merge_path_cases(rng):
    """(cap_a, a_count, cap_b, b_count, out_capacity, L, pool): overflow,
    empty sides, cap_a 0, unsorted b padding, tie runs longer than a tile."""
    ties = np.array([3, 1 << 63], dtype=np.uint64)
    for L in (1, 2, 3, 4, 5, 8, 13):
        yield 3000, 2500, 1000, 700, 4096, L, _POOL        # padding slots
        yield 3000, 2500, 1000, 900, 3000, L, _POOL        # overflow
        yield 3000, 0, 1000, 700, 2048, L, _POOL           # a_count 0
        yield 3000, 2500, 1000, 0, 4096, L, _POOL          # b_count 0
        yield 0, 0, 1000, 700, 1024, L, _POOL              # cap_a 0
        yield 9000, 8000, 6000, 5000, 16384, L, ties       # runs of ~7000 equal rows
    for _ in range(8):
        L = int(rng.integers(1, 9))
        cap_a, cap_b = (int(x) for x in rng.integers(1, 5000, 2))
        ac, bc = int(rng.integers(0, cap_a + 1)), int(rng.integers(0, cap_b + 1))
        yield cap_a, ac, cap_b, bc, int(rng.integers(1, cap_a + cap_b + 64)), L, _POOL


@pytest.mark.cuda
def test_merge_path_matches_plain_on_card():
    _need_card()
    rng = np.random.default_rng(12)
    for i, (cap_a, ac, cap_b, bc, out, L, pool) in enumerate(_merge_path_cases(rng)):
        a = _padded(rng, cap_a, ac, L, pool).cuda()
        b = _padded(rng, cap_b, bc, L, pool).cuda()
        a_count = torch.tensor(ac, dtype=torch.int32, device="cuda")
        b_count = torch.tensor(bc, dtype=torch.int32, device="cuda")
        if i % 2:  # 0-dim and one-element counts both work
            a_count, b_count = a_count.reshape(1), b_count.reshape(1)
        before = merge_kernel.LAUNCHES
        src, lanes, pos = merge_kernel.merge_path(
            a, a_count, cap_a, b, b_count, out, want_pos=True
        )
        assert merge_kernel.LAUNCHES == before + 1
        want_src, want_lanes = merge_source_map_torch(
            a, a_count, cap_a, b, b_count, cap_b, out
        )
        ins = search_right_torch(a, a_count, b)
        j = torch.arange(cap_b, device="cuda")
        want_pos = torch.where((j < bc) & (j + ins < out), ins, -1)
        case = (cap_a, ac, cap_b, bc, out, L)
        assert torch.equal(src, want_src), case
        assert torch.equal(lanes, want_lanes), case
        assert torch.equal(pos, want_pos), case
        got = merge_kernel.search_right(a, a_count, b, b_count)
        assert torch.equal(got[:bc], ins[:bc]) and bool((got[bc:] == -1).all()), case


def _id_batches(rng, device):
    """Two sorted runs (a: 700 of 1024 rows, b: 300 of 512, 4 lanes)
    whose one column holds each row's index into concat(a, b)."""
    from materialize_tpu_torch.repr.batch import Batch
    from materialize_tpu_torch.repr.schema import Column, ColumnType, Schema

    schema = Schema([Column("id", ColumnType.INT64, nullable=False)])
    runs = []
    for offset, cap, n in ((0, 1024, 700), (1024, 512, 300)):
        batch = Batch.from_numpy(schema, [np.arange(n) + offset], np.uint64(0),
                                 np.ones(n, np.int64), capacity=cap, device=device)
        runs.append((batch, _padded(rng, cap, n, 4).to(device)))
    return runs


@pytest.mark.cuda
def test_merge_sorted_cached_launches_once_on_card():
    """On CUDA tensors a merge is one kernel launch (no inversion chain)
    and gives the plain chain's batch and lanes."""
    _need_card()
    from materialize_tpu_torch.ops.merge import merge_sorted_cached

    (a, al), (b, bl) = _id_batches(np.random.default_rng(13), "cuda")
    got = []
    for mode in ("kernel", "torch"):
        before = merge_kernel.LAUNCHES
        with merge_mode(mode):
            merged, lanes, overflowed = merge_sorted_cached(a, al, b, bl, 1536)
        got.append((merged, lanes, overflowed, merge_kernel.LAUNCHES - before))
    (km, kl, kovf, k_launch), (tm, tl, tovf, t_launch) = got
    assert (k_launch, t_launch) == (1, 0)
    assert bool(kovf) == bool(tovf) and int(km.count) == int(tm.count) == 1000
    assert torch.equal(kl, tl)
    for x, y in zip(km.cols + (km.time, km.diff), tm.cols + (tm.time, tm.diff)):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_index_paths_agree_on_card():
    """The small index configuration run with the kernel and with the
    plain search must leave identical spines."""
    _need_card()
    from materialize_tpu_torch.workloads.index import index_config

    bases = []
    for mode in ("kernel", "torch"):
        df, hydrate, churn = index_config(
            sf=0.002, n_orders_per_tick=16, state_cap=1 << 12, out_levels=3,
            ce=4, ratio=4, device="cuda",
        )
        with merge_mode(mode):
            h = hydrate()
            n_h = len(h) - len(h) % 4
            df.run_span(h[:n_h])
            df.run_steps(h[n_h:])
            df.run_span([churn(i, df.time + i)[0] for i in range(8)])
            df.check_flags()
            bases.append(df.output_batch().to_rows())
    assert bases[0] == bases[1] and len(bases[0]) > 0


@pytest.mark.cuda
def test_index_span_executor_matches_serial_on_card():
    """The pipelined span executor (``render/span_exec.py``) over the
    small index on the card: span K+1 dispatched before span K's one
    flags readback. Its committed deltas, tick for tick, and its final
    index equal the serial ``run_steps`` train's; the kernel launched."""
    _need_card()
    from materialize_tpu_torch.render.span_exec import SpanExecutor
    from materialize_tpu_torch.workloads.index import index_config

    runs = []
    for pipelined in (False, True):
        df, hydrate, churn = index_config(
            sf=0.002, n_orders_per_tick=16, state_cap=1 << 12, out_levels=3,
            ce=4, ratio=4, device="cuda",
        )
        h = hydrate()
        n_h = len(h) - len(h) % 4
        df.run_span(h[:n_h])
        df.run_steps(h[n_h:])
        df.check_flags()
        spans = [[churn(8 * s + i, df.time + 8 * s + i)[0] for i in range(8)]
                 for s in range(4)]
        start = merge_kernel.LAUNCHES
        deltas = []
        if pipelined:
            ex = SpanExecutor(df)
            for sp in spans:
                got = ex.submit(sp)
                if got is not None:
                    deltas.append([sorted(b.to_rows()) for b in got])
            ex.sync()
            ex.close()
            st = ex.stats()
            assert st["readbacks_per_span"] == 1.0 and st["max_inflight"] == 1
        else:
            for sp in spans:
                deltas.append([sorted(b.to_rows()) for b in df.run_steps(sp)])
        assert merge_kernel.LAUNCHES > start
        runs.append((deltas, sorted(df.output_batch().to_rows())))
    (serial, base_s), (piped, base_p) = runs
    assert piped == serial[: len(piped)] and len(piped) == len(spans) - 1
    assert base_p == base_s and len(base_s) > 0


@pytest.mark.cuda
def test_index_rollback_grow_replay_agree_on_card():
    """With a base one tier short (the layout of
    ``tests/test_torch_dataflow.py``), the second churn span's level-1
    fold overflows: the span rolls back, the base and its lanes grow
    (zero-padded lane rows) and the span replays. The kernel and the
    plain chain must leave equal runs, slots and lanes."""
    _need_card()
    from materialize_tpu_torch.workloads.index import index_config

    spines = []
    for mode in ("kernel", "torch"):
        df, hydrate, churn = index_config(
            sf=0.002, n_orders_per_tick=16, state_cap=1 << 12, out_levels=2,
            ce=4, ratio=4, device="cuda",
        )
        df._grow_for(("out", 0), target=1 << 14)
        df._grow_for(("out", 1), target=1 << 13)
        before = merge_kernel.LAUNCHES
        overs = []
        with merge_mode(mode):
            df.run_span(hydrate())
            overs.append(df.check_flags())
            for first in (0, 8):
                df.run_span([churn(i, df.time + i - first)[0] for i in range(first, first + 8)])
                overs.append(df.check_flags())
        assert overs == [False, False, True], (mode, overs)
        assert df.output.base.capacity == 1 << 14
        launches = merge_kernel.LAUNCHES - before
        assert (launches > 0) if mode == "kernel" else (launches == 0)
        spines.append(df.output)
    k, t = spines
    for kb, tb, kl, tl in zip(k.runs_b + k.slots, t.runs_b + t.slots,
                              k.lanes + k.slot_lanes, t.lanes + t.slot_lanes):
        n = int(kb.count)
        assert int(tb.count) == n and kb.capacity == tb.capacity
        for x, y in zip(kb.cols + (kb.time, kb.diff), tb.cols + (tb.time, tb.diff)):
            assert torch.equal(x[:n], y[:n])
        assert torch.equal(kl[:n], tl[:n])


def _q1_forced_overflow(mode):
    """Q1 at SF 0.01 on the card whose reduce state starts at 2 rows: the
    first hydrate tick's 4 groups overflow it, the span rolls back, the
    state doubles and the span replays. Returns (dataflow, overflow per
    span, merge-path launches)."""
    from materialize_tpu_torch.arrangement.spine import Arrangement
    from materialize_tpu_torch.workloads.tpch import q1_config

    df, hydrate, churn = q1_config(sf=0.01, n_orders_per_tick=64, device="cuda")
    state = df.states[0][0]
    df.states[0] = (Arrangement.empty(state.schema, state.key, 2, device="cuda"),)
    before = merge_kernel.LAUNCHES
    overs = []
    with merge_mode(mode):
        h = hydrate()
        n_h = len(h) - len(h) % df._compact_every
        df.run_span(h[:n_h])
        overs.append(df.check_flags())
        df.run_steps(h[n_h:])
        df.run_span([churn(i, df.time + i)[0] for i in range(16)])
        overs.append(df.check_flags())
    return df, overs, merge_kernel.LAUNCHES - before


@pytest.mark.cuda
def test_q1_state_overflow_agrees_on_card():
    """Q1 with a forced state overflow, run through the kernel and through
    the plain chain: equal results after rollback, growth and replay."""
    _need_card()
    (kdf, kover, klaunch), (tdf, tover, tlaunch) = (
        _q1_forced_overflow("kernel"), _q1_forced_overflow("torch"))
    assert kover == tover == [True, False]
    assert klaunch > 0 and tlaunch == 0
    # 2 -> 4 -> 8: the merge holds state and touched groups before summing
    assert kdf.states[0][0].capacity == tdf.states[0][0].capacity == 8
    rows = kdf.peek()
    assert rows == tdf.peek() and len(rows) == 4
    assert kdf.peek_errors() == tdf.peek_errors() == []
    for kb, tb in ((kdf.states[0][0].batch, tdf.states[0][0].batch),
                   (kdf.err_output.batch, tdf.err_output.batch),
                   (kdf.output.base, tdf.output.base)):
        n = int(kb.count)
        assert int(tb.count) == n
        for x, y in zip(kb.cols + (kb.time, kb.diff), tb.cols + (tb.time, tb.diff)):
            assert torch.equal(x[:n], y[:n])


def _q15_run(mode, force: bool, device="cuda"):
    """Q15 at SF 0.01: hydrate, then a churn span of 16. With ``force``
    the join tier starts at 4 rows and the revenue state at 2, so the
    first hydrate span overflows both, rolls back, grows and replays.
    Returns (dataflow, overflow per span, merge-path launches)."""
    from materialize_tpu_torch.arrangement.spine import Arrangement
    from materialize_tpu_torch.workloads.tpch import q15_config

    df, hydrate, churn = q15_config(sf=0.01, n_orders_per_tick=64, device=device)
    if force:
        df._ctx.join_caps[0] = 4
        rev = df.states[0][0]
        df.states[0] = (Arrangement.empty(rev.schema, rev.key, 2, device=device),)
    before = merge_kernel.LAUNCHES
    overs = []
    with merge_mode(mode):
        h = hydrate()
        n_h = len(h) - len(h) % df._compact_every
        df.run_span(h[:n_h])
        overs.append(df.check_flags())
        df.run_steps(h[n_h:])
        df.run_span([churn(i, df.time + i)[0] for i in range(16)])
        overs.append(df.check_flags())
    return df, overs, merge_kernel.LAUNCHES - before


def _same_dataflow_state(kdf, tdf, min_rows: int = 1):
    """Equal peeks, err collections, and every state part: arrangements'
    batches; spines' runs, slots, cached lanes and slot cursors (the
    delta join's); the output runs and the err arrangement. The states
    are compared before the peeks, whose compaction folds every run and
    slot into the base."""
    batches = [(kdf.err_output.batch, tdf.err_output.batch)]
    for kparts, tparts in zip(kdf.states, tdf.states):
        for kp, tp in zip(kparts, tparts):
            if hasattr(kp, "runs_b"):
                assert kp.cursor == tp.cursor and len(kp.slots) == len(tp.slots)
                batches += list(zip(kp.runs_b + kp.slots, tp.runs_b + tp.slots))
                for kl, tl, kb in zip(kp.lanes + kp.slot_lanes, tp.lanes + tp.slot_lanes,
                                      kp.runs_b + kp.slots):
                    assert torch.equal(kl[: int(kb.count)], tl[: int(kb.count)])
            else:
                batches.append((kp.batch, tp.batch))
    batches += list(zip(kdf.output.runs_b, tdf.output.runs_b))
    for kb, tb in batches:
        n = int(kb.count)
        assert int(tb.count) == n and kb.capacity == tb.capacity
        for x, y in zip(kb.cols + (kb.time, kb.diff), tb.cols + (tb.time, tb.diff)):
            assert torch.equal(x[:n], y[:n])
    rows = kdf.peek()
    assert rows == tdf.peek() and len(rows) >= min_rows
    assert kdf.peek_errors() == tdf.peek_errors() == []


@pytest.mark.cuda
def test_q15_paths_agree_on_card():
    """Q15 run through the kernel and through the plain chain: equal
    peeks, join spines, revenue state and MAX multiset."""
    _need_card()
    (kdf, kover, klaunch), (tdf, tover, tlaunch) = (
        _q15_run("kernel", False), _q15_run("torch", False))
    assert kover == tover == [False, False]
    assert klaunch > 0 and tlaunch == 0
    _same_dataflow_state(kdf, tdf)


@pytest.mark.cuda
def test_q15_forced_overflows_agree_on_card():
    """A forced join-tier overflow and a forced revenue-state overflow
    roll back, grow and replay through the kernel exactly as through the
    plain chain."""
    _need_card()
    (kdf, kover, klaunch), (tdf, tover, tlaunch) = (
        _q15_run("kernel", True), _q15_run("torch", True))
    assert kover == tover == [True, False]
    assert klaunch > 0 and tlaunch == 0
    assert kdf._ctx.join_caps == tdf._ctx.join_caps and kdf._ctx.join_caps[0] > 4
    assert kdf.states[0][0].capacity == tdf.states[0][0].capacity > 2
    _same_dataflow_state(kdf, tdf)


# The Q9 tiers a forced run starts at half of: the join tier, the slot
# ring of the join's first lineitem spine and run 0 of its second.
Q9_FORCED = (("state", 1, (5, "tail")), ("state", 1, (6, 0)))


def _q9_run(mode, force: bool, device="cuda"):
    """Q9 at SF 0.002 in the bench's slotted layout, pre-sized
    (``q9_tiers``): 4 hydrate ticks and 4 churn ticks as one span (the
    join spines' rings flush into run 0 at tick 8), then 4 churn ticks
    into the flushed rings. With ``force`` the join tier, one lineitem
    spine's slot ring and another's run 0 start at half their tier, so
    the first span overflows all three, rolls back, grows and replays.
    Returns (dataflow, overflow per span, merge-path launches)."""
    from materialize_tpu_torch.storage.generator.tpch import TpchGenerator
    from materialize_tpu_torch.workloads.tpch import apply_tiers, q9_config, q9_tiers

    df, hydrate, churn = q9_config(sf=0.002, n_orders_per_tick=16, device=device)
    tiers = q9_tiers(df, TpchGenerator(sf=0.002, seed=42), 896, 16, 8)
    if force:
        tiers["grow"] = [[k, c // 2 if k in Q9_FORCED else c] for k, c in tiers["grow"]]
        tiers["join_caps"] = [c // 2 for c in tiers["join_caps"]]
    apply_tiers(df, tiers)
    before = merge_kernel.LAUNCHES
    overs = []
    with merge_mode(mode):
        h = hydrate()
        df.run_span(h + [churn(i, len(h) + i)[0] for i in range(8 - len(h))])
        overs.append(df.check_flags())
        df.run_steps([churn(i, df.time + i - 4)[0] for i in range(4, 8)],
                     defer_check=True)
        overs.append(df.check_flags())
    return df, overs, merge_kernel.LAUNCHES - before


@pytest.mark.cuda
def test_q9_paths_agree_on_card():
    """Q9 (ten slotted join spines) through the kernel and through the
    plain chain: equal peeks, join spines with their slots and cursors,
    accumulators, output and err arrangements."""
    _need_card()
    (kdf, kover, klaunch), (tdf, tover, tlaunch) = (
        _q9_run("kernel", False), _q9_run("torch", False))
    assert kover == tover == [False, False]
    assert klaunch > 0 and tlaunch == 0
    assert all(len(sp.slots) == 8 and sp.cursor == 4 for sp in kdf.states[1])
    _same_dataflow_state(kdf, tdf, min_rows=50)


@pytest.mark.cuda
def test_q9_forced_overflows_agree_on_card():
    """Forced overflows of the join tier, of a spine's slot ring and of a
    spine's run 0 roll back, grow and replay through the kernel exactly
    as through the plain chain."""
    _need_card()
    (kdf, kover, klaunch), (tdf, tover, tlaunch) = (
        _q9_run("kernel", True), _q9_run("torch", True))
    assert kover == tover == [True, False]
    assert klaunch > 0 and tlaunch == 0
    assert kdf._ctx.join_caps == tdf._ctx.join_caps
    for df in (kdf, tdf):  # each grew back to its pre-sized tier
        spines = df.states[1]
        assert spines[5].slots[0].capacity == spines[6].slots[0].capacity
        assert spines[6].runs_b[0].capacity == spines[5].runs_b[0].capacity
    _same_dataflow_state(kdf, tdf, min_rows=50)


def _f64_values():
    rng = np.random.default_rng(3)
    vals = rng.standard_normal(4000) * 10.0 ** rng.integers(-323, 308, 4000).astype(np.float64)
    edges = [0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 5e-324, -5e-324, 1e-310,
             2.0**-1022, 2.0**-1023, 2.0**1023, -(2.0**1023), np.finfo(np.float64).max]
    return np.concatenate([vals, np.array(edges)])


ORDER_FLAGS_SELECT = (
    "SELECT l_orderkey, string_agg(l_returnflag, ',') AS flags, "
    "array_agg(l_linenumber) AS lines, count(*) AS n FROM lineitem GROUP BY l_orderkey"
)


def _order_flags_run(device):
    """``chip_smoke.py``'s ``order_flags`` view (a STRING_AGG, an
    ARRAY_AGG and a COUNT by order) rendered from its SQL on ``device``
    at the default state tier of 256 rows (its multisets overflow, roll
    back, grow and replay), fed TPC-H lineitem at SF 0.01 and 4 churn
    ticks. Returns (dataflow, merge-path launches)."""
    from materialize_tpu_torch.render.dataflow import Dataflow
    from materialize_tpu_torch.repr.batch import Batch
    from materialize_tpu_torch.sql.plan import plan_statement
    from materialize_tpu_torch.storage.generator.tpch import LINEITEM_SCHEMA, TpchGenerator
    from materialize_tpu_torch.transform.optimizer import optimize
    from materialize_tpu_torch.workloads.tpch import tpch_catalog

    df = Dataflow(optimize(plan_statement(ORDER_FLAGS_SELECT, tpch_catalog()).expr),
                  device=device)
    gen = TpchGenerator(sf=0.01, seed=3)
    parts = list(gen.snapshot_lineitem_parts())
    parts += [gen.churn_lineitem_part(64, t) for t in range(1, 5)]
    before = merge_kernel.LAUNCHES
    for t, (cols, diff) in enumerate(parts):
        df.step({"lineitem": Batch.from_numpy(
            LINEITEM_SCHEMA, cols, np.full(len(diff), t, np.uint64), diff, device=device)})
    return df, merge_kernel.LAUNCHES - before


@pytest.mark.cuda
def test_order_flags_reduce_on_card_equals_cpu():
    """The collection aggregates' reduce on the card against its CPU
    run: every state part (digests and multisets), the output runs and
    the finalized peek equal, the multisets merged through the kernel."""
    _need_card()
    (kdf, klaunch), (cdf, claunch) = _order_flags_run("cuda"), _order_flags_run("cpu")
    assert klaunch > 0 and claunch == 0
    assert any(k[0] == "state" for k in kdf._grown) and kdf._grown == cdf._grown
    rows = kdf.peek()
    assert rows == cdf.peek() and len(rows) > 10_000
    # Each order's line numbers, one per row it counts.
    assert all(r[2].count(",") + 1 == r[3] == r[1].count(",") + 1 for r in rows)
    for kparts, cparts in zip(kdf.states, cdf.states):
        for kp, cp in zip(kparts, cparts):
            n = int(kp.batch.count)
            assert int(cp.batch.count) == n
            for x, y in zip(kp.batch.cols + (kp.batch.diff,), cp.batch.cols + (cp.batch.diff,)):
                assert torch.equal(x[:n].cpu(), y[:n])


@pytest.mark.cuda
def test_f64_lanes_on_card_equal_cpu():
    """FLOAT64 lanes on the card equal those on the CPU bit for bit: the
    card does not flush double subnormals, and the lanes put them in
    the zero bucket by their exponent field on both."""
    _need_card()
    from materialize_tpu_torch.ops.lanes import column_lanes
    from materialize_tpu_torch.repr.schema import ColumnType

    vals = torch.from_numpy(_f64_values())
    cpu = column_lanes(vals, ColumnType.FLOAT64)
    card = column_lanes(vals.cuda(), ColumnType.FLOAT64)
    for a, b in zip(cpu, card):
        assert torch.equal(a, b.cpu())


def _sum_float_run(device):
    """Five SUM_FLOAT reduce steps (inserts, retractions) over 64 groups
    of up to ~60 rows of mixed magnitudes; returns every state and
    output batch on the host."""
    from materialize_tpu_torch.expr.relation import AggregateExpr, AggregateFunc
    from materialize_tpu_torch.expr.scalar import col, lit
    from materialize_tpu_torch.ops.reduce import ReduceOp
    from materialize_tpu_torch.repr.batch import Batch
    from materialize_tpu_torch.repr.schema import Column, ColumnType, Schema

    schema = Schema([Column("k", ColumnType.INT64), Column("v", ColumnType.FLOAT64, True)])
    op = ReduceOp(schema, (0,), (AggregateExpr(AggregateFunc.SUM_FLOAT, col(1) * lit(0.85)),
                                 AggregateExpr(AggregateFunc.COUNT, col(1))))
    rng = np.random.default_rng(9)
    n = 4000
    k = rng.integers(0, 64, n)
    v = rng.standard_normal(n) * 10.0 ** rng.integers(-12, 13, n)
    vn = rng.random(n) < 0.1
    state = op.init_state(4096, device=device)
    got = []
    for t, (lo, hi, d) in enumerate([(0, 2000, 1), (2000, 4000, 1), (500, 1500, -1),
                                     (600, 900, 1), (3000, 4000, -1)], start=1):
        idx = np.arange(lo, hi)
        b = Batch.from_numpy(schema, [k[idx], v[idx]], np.full(len(idx), t, np.uint64),
                             np.full(len(idx), d, np.int64), capacity=4096,
                             nulls=[None, vn[idx]], device=device)
        state, out, ovf = op.step(state, b, t)
        assert not bool(ovf[0])
        for batch in (state[0].batch, out):
            m = int(batch.count)
            got.append([c[:m].cpu() for c in batch.cols + (batch.diff,)])
    return got


@pytest.mark.cuda
def test_sum_float_reduce_is_deterministic_on_card():
    """A SUM_FLOAT reduce gives bit-equal states and outputs in two runs
    on the card, and equal to the CPU's: every group's float sum runs in
    row order (``ops/reduce.py:_run_sums``), never through an atomic
    ``index_add_``."""
    _need_card()
    first, second, cpu = _sum_float_run("cuda"), _sum_float_run("cuda"), _sum_float_run("cpu")
    for a, b, c in zip(first, second, cpu):
        for x, y, z in zip(a, b, c):
            assert torch.equal(x, y) and torch.equal(x, z)


def test_index_reads_decode_against_numpy_oracle():
    """The port's own index end to end on the CPU (its generator, its
    string dictionary): scan, lookup and point reads, decoded, against a
    numpy oracle of every batch fed."""
    from collections import Counter

    from materialize_tpu_torch.coord import peek
    from materialize_tpu_torch.repr.schema import GLOBAL_DICT
    from materialize_tpu_torch.workloads.index import index_config

    df, hydrate, churn = index_config(
        sf=0.001, n_orders_per_tick=8, state_cap=1 << 12, out_levels=2, ce=4,
        ratio=4, device="cpu",
    )
    fed = hydrate()
    fed += [churn(i, 1 + i)[0] for i in range(7)]
    df.run_steps(fed)
    oracle = Counter()
    for inp in fed:
        for r in inp["lineitem"].to_rows():
            oracle[r[:13]] += r[-1]
    oracle = {k: v for k, v in oracle.items() if v}
    scanned = Counter()
    for r in peek.scan_rows(df):
        scanned[r[:13]] += r[-1]
    decoded = {k: v for k, v in scanned.items() if v}
    assert len(decoded) == len(oracle)
    flags = {GLOBAL_DICT.decode(k[8]) for k in oracle}
    assert {k[8] for k in decoded} == flags <= {"R", "A", "N"}
    keys = sorted({k[0] for k in oracle})[:5]
    for k, rows in zip(keys, peek.lookup_groups(df, (0,), [(k,) for k in keys])):
        got = Counter()
        for r in rows:
            got[r[0]] += r[-1]
        assert got[k] == sum(v for kk, v in oracle.items() if kk[0] == k)
    probes = list(oracle)[:6] + [tuple([0] * 13)]
    assert list(peek.point_net(df, probes)) == [oracle.get(p, 0) for p in probes]
