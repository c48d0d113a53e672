#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``materialize_tpu_torch``) on one NVIDIA
card and check it end to end.

    python3 chip_smoke.py
    python3 chip_smoke.py --serve-only

With ``--serve-only`` it runs phases 1, 5, 7a (twice: the replica
stepping a tick at a time, then with ``span_pipelining`` on) and
stops after ``serve_vs_plain_path``, printing neither the kernels line
nor the last line. Phases, each printing one JSON line (any failure exits non-zero):

1. card and build: the card's name and power limit (``nvidia-smi``),
   then the merge-path kernel built from ``csrc/merge_path.cu`` with
   nvcc for sm_90a (seconds, ptxas report); then ``sql_plans``: TPC-H
   Q21 and Q7 planned from their text by the port's SQL frontend and
   optimizer on this machine (no JAX), Q21's plan equal to
   ``q21_plan()``, node counts and planning ms;
2. kernel against its plain torch versions, exactly: insertion points
   (``pos``) against ``search_right_torch`` for L in {1, 2, 3, 4, 5, 8,
   13, 25, 29}, random ``a_count`` (0 and m included), heavy duplicates, lanes on
   both sides of 2^63; the merged run (``src``, merged lanes, ``pos``)
   against ``merge_source_map_torch`` with ``b_count < n`` and unsorted
   padding, overflow, ``cap_a = 0``, empty sides and tie runs longer
   than a tile; then each of the main path's merge shapes (cap_a, cap_b,
   out) at L = 4 and L = 1, timed as one CUDA-event pair around R
   back-to-back launches / R (and the same launches replayed from a CUDA
   graph, which leaves out the host): the fused kernel, the kernel with
   only ``pos``, the unfused chain (the kernel's ``pos``, then the
   mark/cumsum inversion and the lanes gather in eager torch), the plain
   chain (plain search + inversion + lanes gather), ``torch.searchsorted``
   at L = 1, beside the memory bound;
3. the maintained TPC-H lineitem index at SF 1 (the reference bench's
   ``config_index`` layout with ``state_cap = 2^23``): hydrate the
   snapshot in spans, churn 32 ticks as spans of 16, one flags readback
   per span, kernel launches counted over the whole run in all and by
   merge shape, the maintained multiset against a numpy oracle, and a
   full scan, 64 ``l_orderkey = k`` lookups and 64 full-row point
   lookups against it;
4. the index configuration at SF 0.01 with the merge forced to the
   kernel and then to the plain chain: the spines must be equal;
5. TPC-H Q1 at SF 0.1 (``workloads/tpch.py``, the reference bench's Q1
   layout and scale; SF 1 does not fit the time limit beside Q9):
   hydrate in spans, churn 32 ticks as spans of 16, one flags
   readback per span, kernel launches over the Q1 run in all and by
   merge shape, device operations per tick (16 more ticks under
   ``torch.profiler``), ``peek()`` against a numpy Q1 oracle over every
   batch fed and ``peek_errors()`` empty;
6. the kernel at each merge shape the Q1 path launched, against its
   plain chain;
7. Q1 at SF 0.01 in both merge modes: equal peeks, reduce states, output
   runs and err arrangements;
7a. ``serve``: the port's serving stack in this process, the replica's
    dataflows on the card: a replica thread (``coord/replica.py``), a
    Coordinator over FileBlob and SqliteConsensus in a temporary
    directory, a PgServer on a free port, and this script's own pgwire
    client (the simple query protocol). Over the wire: ``CREATE SOURCE
    tpch FROM LOAD GENERATOR TPCH (SCALE FACTOR 0.1, CHURN ORDERS
    1024)``, Q1's full text as a materialized view, ``order_lines`` (a
    count and a sum by ``l_orderkey``, ~150,000 groups) with its index;
    32 churn ticks of the source (``tick_once``) with ``SELECT * FROM
    q1`` after each span of 16, each equal to a numpy Q1 oracle over the
    generator's stream (not read from persist); 8 paced ticks, each
    waited for until both views stepped past it, their time split
    between the source's persist appends and the replica's fetch, step
    and sink append; 256 point lookups on ``order_lines`` over the wire
    and straight through the coordinator, each equal to the oracle; 32
    more Q1 SELECTs (Q1's sums and count equal to the oracle's, each
    average equal to its scale-2 sum over the count rounded down, as
    the engine's decimal division does); the table path (CREATE TABLE, INSERT, an MV with a
    join and an aggregate, DELETE, UPDATE, a slow-path SELECT). Printed:
    each DDL's ms, hydrate s, churn updates/s through the served path
    (source rows written over the wall time from the first tick to the
    SELECT that first sees the last) beside the bare ``q1`` cell's,
    SELECT and lookup ms p50/p99, flags readbacks a replica step,
    host-to-device copies a tick, persist parts and bytes written, merge
    launches, peak device memory; then the kernel at each merge shape
    the serve path launched (``serve_kernel_shape``), and
    ``serve_vs_plain_path``: the script at SF 0.002 with the replica's
    merges forced to the kernel and then to the plain chain, every
    SELECT equal;
8. TPC-H Q15 at SF 0.1 (``workloads/tpch.py``, the reference bench's Q15
   layout, twice its scale; SF 1 is left to earlier records, for time:
   the revenue view, its global MAX and the supplier table in a
   3-input delta join): hydrate in spans (the revenue state, the join
   spines, the MAX multiset and the join tier grow on overflow, roll back
   and replay), churn 32 ticks as spans of 16 with one flags readback
   each, kernel launches over the Q15 run in all and by merge shape,
   device operations per tick (16 more ticks under ``torch.profiler``),
   ``peek()`` against a numpy Q15 oracle over every batch fed and
   ``peek_errors()`` empty;
9. the kernel at each merge shape the Q15 path launched, against its
   plain chain;
10. Q15 at SF 0.01 in both merge modes: equal peeks, revenue
    accumulators, join spines, MAX multiset, output runs and err
    arrangements;
11. TPC-H Q9 at SF 0.25 (``Q9_SF``; SF 1 until Q7 took its time, SF
    0.5 until the serving phases did;
    ``workloads/tpch.py``, the reference bench's Q9 layout: a 6-input
    delta join over ten spines with a ring of 8 append slots each,
    EXTRACT(YEAR), profit summed by (n_name, o_year)): part, supplier,
    partsupp, nation and every order ride the first hydrate tick,
    lineitem hydrates in ticks of 16,384 orders with every tier
    pre-sized (``q9_tiers``; no hydrate span may overflow), no warm
    span, the join tier set back to a churn tick's
    (``set_join_tiers``), then 32 churn ticks as spans of 16 with one
    flags readback each; kernel launches by merge shape (2^21 rows at
    L = 6 among them; 2^23 at SF 1), device operations per tick from 2
    profiled ticks, peak device memory,
    ``peek()`` against a numpy Q9 oracle over every batch fed (175
    groups) and ``peek_errors()`` empty;
12. the kernel at each merge shape the Q9 path launched, against its
    plain chain;
13. Q9 at SF 0.002 in both merge modes: equal peeks, accumulators, join
    spines with their slots and cursors, output runs and err
    arrangements;
14. the auction (``workloads/auction.py``, the reference bench's
    ``config_auction``: TopK feeding Distinct over the churning bids of
    512 users, 128 auctions of 8 bids a tick, bids retracted 4 ticks
    later, ``state_cap`` 2^13), and ``auction_x16`` at 16 times the rate
    (8,192 users, 16,384 bids a tick, ``state_cap`` 2^17): 8 hydrate
    ticks, a warm span of 16, 32 churn ticks as 2 spans of 16 with one
    flags readback each, 16 profiled ticks, ``peek()`` against a numpy
    oracle of the distinct winning bidders over every bid fed, and
    ``peek_errors()`` empty;
15. the kernel at each merge shape the auction paths launched, and the
    small auction in both merge modes (every state part equal);
16. pagerank (``workloads/pagerank.py``, the reference bench's
    ``config_pagerank``: 2,000 nodes, 10,000 edges, 64 rewired a tick,
    60 evaluations a tick, ``state_cap`` 2^14, tiers pre-sized): 1
    hydrate tick, 16 churn ticks as 2 spans of 8 with one flags readback
    each (the LetRec's and the float sums' readbacks counted apart), a
    profiled tick, ``peek()`` one row per node within rel 1e-3 of a
    numpy fixpoint, and ``tests/test_letrec.py``'s five edges at 300
    evaluations within rel 1e-9; ``pagerank_x32`` at 32 times the graph
    (65,536 nodes, 327,680 edges, 2,048 rewired a tick, ``state_cap``
    2^19): 1 hydrate tick, 2 churn ticks (not 8: the script's time
    limit, PERF.md §6), a profiled tick;
17. the kernel at each merge shape the pagerank paths launched, and a
    small pagerank in both merge modes (every state part equal);
18. TPC-H Q21 (``workloads/tpch.py:q21_plan``: EXISTS as a semijoin, NOT
    EXISTS as ``Threshold(Union(cse13, Negate(...)))``) at SF 0.5
    (``Q21_SF``; SF 1 does not fit the time limit) in
    Q9's layout and stream: supplier, nation and every order on the
    first hydrate tick, lineitem in ticks of 16,384 orders with every
    tier pre-sized (``q21_tiers``, join tiers per site), 32 churn ticks
    as spans of 16 with one flags readback each; kernel launches by merge
    shape (25-lane merges of the Threshold and the cse3 spines among
    them), device operations per tick from 2 profiled ticks, peak device
    memory, the Threshold's state rows, ``peek()`` against a numpy Q21
    oracle over every batch fed and ``peek_errors()`` empty; then the
    kernel at each merge shape Q21 launched, and Q21 at SF 0.002 in both
    merge modes (every state part equal);
19. the auction under a temporal window at both auction sizes
    (``workloads/auction.py:auction_window_plan``: the insert-only bids
    behind ``mz_now() < bid_time + 4``): the auction's ticks and seed,
    updates counted as the inserts plus the retractions the filter
    releases, the final ``peek()`` equal to the retract-mode run's and
    to the oracle over the bids in the window, the temporal buffer's
    rows; and the kernel at each merge shape these launched;
20. ``arms_small``: Union, Constant, FlatMap (``generate_series``, its
    tier overflowing once, growing and replaying), ArrangeBy, Negate and
    Threshold in one plan over 3 ticks of a few hundred seeded rows,
    against numpy;
21. TPC-H Q7 (``Q7_SQL``, clause 2.4.7 less ORDER BY) planned from its
    text on this machine by the port's frontend and optimizer
    (``workloads/tpch.py:q7_expr``: a 6-input delta join with nation
    twice, the BETWEEN inside the lineitem input, the OR of the nation
    pairs after the join) at SF 0.5 (``Q7_SF``: the script's time
    limit) in Q9's layout: nation and supplier on the first hydrate
    tick, customer on the second, every order on the third with the
    first of the lineitem ticks of 32,768 orders (``q7_stagger``: on one
    tick, customer would meet every order in one probe), every tier pre-sized
    (``q7_tiers``), 32 churn ticks as spans of 16 with one flags
    readback each, 2 profiled ticks; launches by merge shape, peak
    memory, ``peek()`` against a numpy Q7 oracle (4 groups) and
    ``peek_errors()`` empty; then the kernel at each merge shape Q7
    launched, and Q7 at SF 0.002 in both merge modes (every state part
    equal);
22. ``scalars_small``: every scalar function outside the TPC-H paths
    (math, casts with their overflow errors, date_trunc, rounding,
    AND/OR, COALESCE, GREATEST/LEAST, ADD_INTERVAL, ``If``) and four
    string functions, in six small dataflows over 2 ticks of 256 seeded
    rows with NULLs, against numpy (floats within rel 1e-14), the err
    collection against numpy's count of out-of-range casts.

``{"phase": "kernel_table", ...}`` gives one row per merge shape of each
main path; ``{"phase": "done", ...}`` gives the script's wall seconds and
each phase group's. The line before the last is ``{"kernels": [...]}``
(``library_ms``: ``torch.searchsorted`` at L = 1 on the level-2 fold's
shape, which computes the kernel's ``search_right``, timed beside it);
the last is ``{"ok": true, "device": {...}}``. Without a CUDA card it
exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
TARGET_MS = 25.0  # device time per timed run of launches

# The index's merge shapes (cap_a, cap_b, out_capacity) with ce = 4,
# ratio = 4, 4 slots of 2^14 and the run ladder 2^19/2^21/2^23/2^23: the
# slot tree, the slot flush into run 0, the three level folds.
MAIN_SHAPES = (
    (1 << 14, 1 << 14, 1 << 15), (1 << 15, 1 << 15, 1 << 16),
    (1 << 19, 1 << 16, 1 << 19),
    (1 << 21, 1 << 19, 1 << 21), (1 << 23, 1 << 21, 1 << 23),
    (1 << 23, 1 << 23, 1 << 23),
)
KERNEL_SHAPE = (1 << 23, 1 << 21, 1 << 23)  # the level-2 fold


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def cuda_ms(torch, fn, graph: bool = False):
    """Device ms per call of ``fn``: one CUDA-event pair around R
    back-to-back calls, / R, after a warm-up; R sized so the run takes
    about ``TARGET_MS``. With ``graph`` the R calls are captured once in a
    CUDA graph and the replay is timed (no host work between launches).
    Returns (ms, R)."""
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    s.record()
    fn()
    e.record()
    torch.cuda.synchronize()
    reps = max(3, min(500, int(TARGET_MS / max(s.elapsed_time(e), 1e-3))))
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                fn()
        g.replay()
        torch.cuda.synchronize()
        s.record()
        g.replay()
        e.record()
    else:
        s.record()
        for _ in range(reps):
            fn()
        e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps, reps


def search_bound_ms(m_count: int, n: int, L: int) -> float:
    """Least time for the insertion points alone: read b once, write pos
    once, and probe at most a's valid prefix once (or n full searches,
    if fewer bytes)."""
    probe = min(m_count * L * 8, n * math.ceil(math.log2(m_count + 1)) * L * 8)
    return (n * L * 8 + n * 4 + probe) / HBM_BYTES_PER_S * 1e3


def merge_bound_ms(a_count: int, b_count: int, cap_a: int, out: int, L: int) -> float:
    """Least time for the merged run: read the T = min(a_count + b_count,
    out) rows the merge consumes and the distinct padding source rows
    once, write src and the merged lanes once."""
    total = min(a_count + b_count, out)
    pad_rows = 0
    if out > total:
        if cap_a:
            pad_rows = max(0, min(out - 1 - b_count, cap_a - 1) - a_count + 1)
        else:
            pad_rows = 0 if b_count else 1
    moved = (total + pad_rows) * L * 8 + out * 8 + out * L * 8
    return moved / HBM_BYTES_PER_S * 1e3


# -- consolidation oracle (numpy, independent of the port) ---------------------


def consolidate_np(mat: np.ndarray, diff: np.ndarray):
    """Rows of ``mat`` ([N, C] int64) summed by identical content, zeros
    dropped, sorted lexicographically with column 0 most significant."""
    if len(diff) == 0:
        return mat, diff
    order = np.lexsort(mat.T[::-1])
    mat, diff = mat[order], diff[order]
    start = np.ones(len(diff), dtype=bool)
    start[1:] = (mat[1:] != mat[:-1]).any(axis=1)
    seg = np.cumsum(start) - 1
    sums = np.zeros(seg[-1] + 1, dtype=np.int64)
    np.add.at(sums, seg, diff)
    rows = mat[start]
    keep = sums != 0
    return rows[keep], sums[keep]


def host_matrix(cols) -> np.ndarray:
    return np.stack([np.asarray(c).astype(np.int64) for c in cols], axis=1)


# -- phases ---------------------------------------------------------------------


def phase_card_and_build(torch, merge_kernel) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    print(card, flush=True)
    from materialize_tpu_torch import native

    t0 = time.perf_counter()
    merge_kernel.build()
    build_s = time.perf_counter() - t0
    # The host C++ of persist and the replica protocol (CRC32C, varints),
    # built with g++ before any phase times its first use.
    t1 = time.perf_counter()
    native.lib()
    emit({
        "phase": "build",
        "card": card,
        "device_name": torch.cuda.get_device_name(0),
        "build_s": build_s,
        "native_build_s": time.perf_counter() - t1,
        "ptxas": [l.strip() for l in merge_kernel.BUILD_INFO["log"].splitlines()
                  if "ptxas" in l or "spill" in l],
    })
    return card


_POOL = np.array(
    [0, 1, 2, (1 << 63) - 1, 1 << 63, (1 << 63) + 1, (1 << 64) - 1], dtype=np.uint64
)
_TIES = np.array([3, 1 << 63], dtype=np.uint64)


def _pool_lanes(rng, cap, L, count=None, pool=_POOL):
    """[cap, L] u64 lanes: a sorted prefix of ``count`` rows (all by
    default) drawn from ``pool`` (heavy duplicates, both sides of 2^63),
    then unsorted padding."""
    count = cap if count is None else count
    valid = pool[rng.integers(0, len(pool), (count, L))]
    valid = valid[np.lexsort(valid.T[::-1])]
    pad = rng.integers(0, 1 << 63, (cap - count, L), dtype=np.uint64) * np.uint64(2)
    return np.concatenate([valid, pad]).reshape(cap, L)


def _device_pool_lanes(torch, gen, cap, L, count):
    """``_pool_lanes`` made on the card (a sorted prefix of ``count`` rows
    drawn from ``_POOL``, then unsorted padding), for runs too large to
    sort on the host in time."""
    from materialize_tpu_torch.ops.lanes import from_u64

    pool = torch.from_numpy(from_u64(_POOL)).cuda()
    t = pool[torch.randint(0, len(_POOL), (cap, L), device="cuda", generator=gen)]
    v = t[:count]
    for j in reversed(range(L)):
        v = v[torch.sort(v[:, j], stable=True).indices]
    t[:count] = v
    t[count:] = torch.randint(-(1 << 62), 1 << 62, (cap - count, L), device="cuda",
                              generator=gen)
    return t


def _hash_run(torch, rng, cap, count, share_from=None):
    """A run like the index's at L = 4 ([kh1, kh2, kh1, kh2], random
    64-bit hashes, stored form) on the card: ``count`` valid rows sorted
    (on the device), then unsorted padding. ``share_from`` (host [k, 2])
    copies a quarter of its rows from another run (a retraction meeting
    its insert). Returns (lanes, host hashes of the valid rows)."""
    h = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, (cap, 2),
                     dtype=np.int64, endpoint=True)
    if share_from is not None and len(share_from):
        k = count // 4
        h[:k] = share_from[rng.integers(0, len(share_from), k)]
    t = torch.from_numpy(h).cuda()
    v = t[:count]
    v = v[torch.sort(v[:, 1], stable=True).indices]
    v = v[torch.sort(v[:, 0], stable=True).indices]
    t[:count] = v
    return t[:, [0, 1, 0, 1]].contiguous(), h[:count]


def _err(torch, got, want) -> float:
    if torch.equal(got, want):
        return 0.0
    if got.shape != want.shape:
        return float("inf")
    return float((got.double() - want.double()).abs().max())


# Lane counts of kernel_random: the templated widths (1-4, 8), the
# generic kernel's (5, 13), and the ~25-30-lane rows of Q21's Threshold.
RANDOM_LANES = (1, 2, 3, 4, 5, 8, 13, 25, 29)


def _merge_cases(rng):
    """(cap_a, a_count, cap_b, b_count, out_capacity, L, pool)."""
    for L in RANDOM_LANES:
        yield 5000, 4000, 2000, 1500, 8192, L, _POOL       # b_count < n, padding slots
        yield 5000, 4000, 2000, 1500, 5000, L, _POOL       # overflow
        yield 5000, 0, 2000, 1500, 4096, L, _POOL          # a_count 0
        yield 5000, 4000, 2000, 0, 8192, L, _POOL          # b_count 0
        yield 0, 0, 2000, 1500, 2048, L, _POOL             # cap_a 0
        yield 12000, 10000, 9000, 8000, 32768, L, _TIES    # tie runs of ~9000 rows


def phase_kernel(torch, merge_kernel, card) -> dict:
    from materialize_tpu_torch.ops.lanes import from_u64
    from materialize_tpu_torch.ops.merge import (
        merge_source_map_torch,
        search_right_torch,
        source_map_from_points,
    )

    rng = np.random.default_rng(1234)
    max_err = 0.0
    cases = {"pos": 0, "merge": 0}

    def on_card(u):
        return torch.from_numpy(from_u64(u)).cuda()

    def count(n):
        return torch.tensor(n, dtype=torch.int32, device="cuda")

    def compare_pos(a, ac, b):
        nonlocal max_err
        c = count(ac)
        err = _err(torch, merge_kernel.search_right(a, c, b), search_right_torch(a, c, b))
        max_err = max(max_err, err)
        cases["pos"] += 1
        check(err == 0, f"pos != plain at m={a.shape[0]} n={b.shape[0]} L={a.shape[1]} count={ac}")

    def compare_merge(a, ac, b, bc, out):
        nonlocal max_err
        cap_a, cap_b = a.shape[0], b.shape[0]
        ca, cb = count(ac), count(bc)
        src, lanes, pos = merge_kernel.merge_path(a, ca, cap_a, b, cb, out, want_pos=True)
        w_src, w_lanes = merge_source_map_torch(a, ca, cap_a, b, cb, cap_b, out)
        ins = search_right_torch(a, ca, b)
        j = torch.arange(cap_b, device="cuda")
        w_pos = torch.where((j < bc) & (j + ins < out), ins, -1)
        err = max(_err(torch, src, w_src), _err(torch, lanes, w_lanes), _err(torch, pos, w_pos))
        max_err = max(max_err, err)
        cases["merge"] += 1
        check(err == 0, f"merge != plain at {(cap_a, ac, cap_b, bc, out, a.shape[1])}")

    for L in RANDOM_LANES:
        for m, n in ((5000, 700), (700, 5000), (4096, 4096), (0, 300)):
            a = on_card(_pool_lanes(rng, m, L))
            b = on_card(_pool_lanes(rng, n, L))
            for ac in sorted({0, m, int(rng.integers(0, m + 1))}):
                compare_pos(a, ac, b)
    for cap_a, ac, cap_b, bc, out, L, pool in _merge_cases(rng):
        compare_merge(on_card(_pool_lanes(rng, cap_a, L, ac, pool)), ac,
                      on_card(_pool_lanes(rng, cap_b, L, bc, pool)), bc, out)
    torch.cuda.synchronize()
    emit({"phase": "kernel_random", "lanes": list(RANDOM_LANES), "pos_cases": cases["pos"],
          "merge_cases": cases["merge"], "max_abs_err": max_err})

    rows = []
    for cap_a, cap_b, out in MAIN_SHAPES:
        ac = int(cap_a * 0.7) - int(rng.integers(0, cap_a // 16))
        bc = min(int(cap_b * 0.7) - int(rng.integers(0, cap_b // 16)), out - ac - out // 16)
        a4, ah = _hash_run(torch, rng, cap_a, ac)
        b4, _ = _hash_run(torch, rng, cap_b, bc, share_from=ah)
        for L in (4, 1):
            a = a4 if L == 4 else a4[:, :1].contiguous()
            b = b4 if L == 4 else b4[:, :1].contiguous()
            ca, cb = count(ac), count(bc)
            compare_merge(a, ac, b, bc, out)
            bv = b[:bc].contiguous()
            compare_pos(a, ac, bv)
            ms, reps = cuda_ms(torch, lambda: merge_kernel.merge_path(a, ca, cap_a, b, cb, out))
            graph_ms, _ = cuda_ms(
                torch, lambda: merge_kernel.merge_path(a, ca, cap_a, b, cb, out), graph=True
            )
            def unfused():
                ins = merge_kernel.search_right(a, ca, b, cb)
                return source_map_from_points(ins, a, cap_a, b, cb, cap_b, out)

            fused = merge_kernel.merge_path(a, ca, cap_a, b, cb, out)
            check(all(torch.equal(x, y) for x, y in zip(unfused(), fused)),
                  "unfused chain != kernel")
            chain_ms, _ = cuda_ms(torch, unfused)
            plain_ms, plain_reps = cuda_ms(
                torch, lambda: merge_source_map_torch(a, ca, cap_a, b, cb, cap_b, out)
            )
            pos_ms, _ = cuda_ms(torch, lambda: merge_kernel.search_right(a, ca, bv))
            pos_graph_ms, _ = cuda_ms(
                torch, lambda: merge_kernel.search_right(a, ca, bv), graph=True
            )
            lib_ms = lib_graph_ms = None
            if L == 1:
                a1 = a[:ac, 0].contiguous()
                b1 = bv[:, 0].contiguous()
                lib = torch.searchsorted(a1, b1, right=True)
                check(torch.equal(lib.to(torch.int32), merge_kernel.search_right(a, ca, bv)),
                      "torch.searchsorted disagrees with the kernel")
                lib_ms, _ = cuda_ms(torch, lambda: torch.searchsorted(a1, b1, right=True))
                lib_graph_ms, _ = cuda_ms(
                    torch, lambda: torch.searchsorted(a1, b1, right=True), graph=True
                )
            bound = merge_bound_ms(ac, bc, cap_a, out, L)
            pos_bound = search_bound_ms(ac, bc, L)
            row = {
                "phase": "kernel_shape", "cap_a": cap_a, "cap_b": cap_b, "out": out,
                "L": L, "a_count": ac, "b_count": bc, "reps": reps,
                "ms": ms, "graph_ms": graph_ms, "bound_ms": bound,
                "bound_share": bound / ms, "chain_ms": chain_ms,
                "plain_ms": plain_ms, "plain_reps": plain_reps,
                "pos_ms": pos_ms, "pos_graph_ms": pos_graph_ms, "pos_bound_ms": pos_bound,
                "pos_bound_share": pos_bound / pos_ms,
                "library_ms": lib_ms, "library_graph_ms": lib_graph_ms, "card": card,
            }
            emit(row)
            rows.append(row)
            del a, b, bv, fused
        del a4, b4
        torch.cuda.empty_cache()
    return {"max_abs_err": max_err, "rows": rows}


def _spans(seq, size):
    return [seq[i:i + size] for i in range(0, len(seq), size)]


def phase_index(torch, merge_kernel, card, sf: float = 1.0) -> dict:
    from materialize_tpu_torch.coord import peek
    from materialize_tpu_torch.workloads.index import index_config

    ticks_churn, span_churn, span_hydrate = 32, 16, 32
    t0 = time.perf_counter()
    df, hydrate, churn = index_config(
        sf=sf, n_orders_per_tick=1024, state_cap=1 << 23, out_levels=4, ce=4,
        ratio=4, slots=True, seed=42, device="cuda",
    )
    h_inputs = hydrate()
    gen_s = time.perf_counter() - t0
    ladder = [b.capacity for b in df.output.runs_b]
    slots = [s.capacity for s in df.output.slots]
    ce = df._compact_every
    n_h = len(h_inputs) - len(h_inputs) % ce

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    merge_kernel.LAUNCHES = 0
    merge_kernel.LAUNCHES_BY_SHAPE.clear()
    folds_before = df._folds
    # -- main path: hydrate -----------------------------------------------------
    t_h = time.perf_counter()
    span_reads = []
    for span in _spans(h_inputs[:n_h], span_hydrate):
        before = df._readbacks
        df.run_span(span)
        check(df.check_flags() is False, "hydration overflowed a tier")
        span_reads.append(df._readbacks - before)
    if n_h < len(h_inputs):
        df.run_steps(h_inputs[n_h:])
    torch.cuda.synchronize()
    hydrate_s = time.perf_counter() - t_h
    # -- main path: churn ---------------------------------------------------------
    t_c = time.perf_counter()
    c_inputs, c_rows = [], []
    for i in range(ticks_churn):
        inp, n = churn(i, df.time + i)
        c_inputs.append(inp)
        c_rows.append(n)
    churn_gen_s = time.perf_counter() - t_c
    span_ms = []
    for span in _spans(c_inputs, span_churn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        before = df._readbacks
        df.run_span(span)
        check(df.check_flags() is False, "churn overflowed a tier")
        torch.cuda.synchronize()
        span_ms.append((time.perf_counter() - t) * 1e3)
        span_reads.append(df._readbacks - before)
    check(all(r == 1 for r in span_reads), f"flags readbacks per span {span_reads}")
    tick_ms = [s / span_churn for s in span_ms]
    ups = sum(c_rows) / (sum(span_ms) / 1e3)

    # -- oracle: every batch fed, consolidated (time ignored) -------------------
    fed = [inp["lineitem"] for inp in h_inputs + c_inputs]
    cols_all = [b.to_columns() for b in fed]
    o_mat = np.concatenate([host_matrix(c[:13]) for c in cols_all])
    o_diff = np.concatenate([c[14] for c in cols_all])
    t_o = time.perf_counter()
    o_rows, o_sums = consolidate_np(o_mat, o_diff)
    oracle_s = time.perf_counter() - t_o

    # -- peeks served from the uncompacted spine ------------------------------
    torch.cuda.synchronize()
    t = time.perf_counter()
    s_cols, _, _, s_diff = peek.scan_arrays(df)
    scan_ms = (time.perf_counter() - t) * 1e3
    sc_rows, sc_sums = consolidate_np(host_matrix(s_cols), s_diff)
    check(np.array_equal(sc_rows, o_rows) and np.array_equal(sc_sums, o_sums),
          "full scan != oracle")

    rng = np.random.default_rng(7)
    keys = [int(k) for k in o_rows[rng.integers(0, len(o_rows), 60), 0]]
    keys += [int(k) for k in np.unique(o_mat[o_diff < 0, 0])[:4]]
    torch.cuda.synchronize()
    t = time.perf_counter()
    groups = peek.lookup_arrays(df, (0,), [(k,) for k in keys])
    lookup_ms = (time.perf_counter() - t) * 1e3
    check(len(groups) == 64, "lookup groups")
    for k, (gcols, _, _, gdiff) in zip(keys, groups):
        lo, hi = np.searchsorted(o_rows[:, 0], [k, k + 1])
        g_rows, g_sums = consolidate_np(
            host_matrix(gcols) if len(gdiff) else np.zeros((0, 13), np.int64), gdiff
        )
        check(np.array_equal(g_rows, o_rows[lo:hi]) and np.array_equal(g_sums, o_sums[lo:hi]),
              f"lookup l_orderkey={k} != oracle")

    retracted = o_mat[o_diff < 0]
    probes = [tuple(int(x) for x in r) for r in o_rows[rng.integers(0, len(o_rows), 56)]]
    probes += [tuple(int(x) for x in r) for r in retracted[rng.integers(0, len(retracted), 8)]]
    torch.cuda.synchronize()
    t = time.perf_counter()
    net = peek.point_net(df, probes)
    point_ms = (time.perf_counter() - t) * 1e3
    for p, got in zip(probes, net):
        arr = np.asarray(p, dtype=np.int64)
        lo, hi = np.searchsorted(o_rows[:, 0], [arr[0], arr[0] + 1])
        hit = np.nonzero((o_rows[lo:hi] == arr).all(axis=1))[0]
        want = int(o_sums[lo + hit[0]]) if len(hit) else 0
        check(int(got) == want, f"point lookup {p}: {got} != {want}")

    # -- the compacted index equals the oracle -----------------------------------
    base = df.output_batch()
    torch.cuda.synchronize()
    launches = merge_kernel.LAUNCHES
    by_shape = dict(merge_kernel.LAUNCHES_BY_SHAPE)
    b_cols = base.to_columns()
    b_rows, b_sums = consolidate_np(host_matrix(b_cols[:13]), b_cols[14])
    check(len(b_sums) == int(base.count), "compacted base holds duplicate rows")
    check(np.array_equal(b_rows, o_rows) and np.array_equal(b_sums, o_sums),
          "maintained index != oracle")

    folds = df._folds - folds_before
    check(launches > 0 and launches >= folds, f"launches {launches} < folds {folds}")
    check(sum(by_shape.values()) == launches, "launches by shape do not add up")
    missing = [s for s in MAIN_SHAPES if not any(k[:3] == s for k in by_shape)]
    check(not missing, f"main-path merge shapes never launched: {missing}")
    out = {
        "phase": "index", "sf": sf, "card": card,
        "lineitem_rows": int(len(o_sums)), "hydrate_ticks": len(h_inputs),
        "hydrate_gen_s": gen_s, "hydrate_s": hydrate_s,
        "churn_ticks": ticks_churn, "churn_gen_s": churn_gen_s,
        "churn_updates": int(sum(c_rows)), "churn_updates_per_s": ups,
        "span_ms": span_ms, "tick_ms_p50": float(np.percentile(tick_ms, 50)),
        "tick_ms_p99": float(np.percentile(tick_ms, 99)),
        "readbacks_per_span": span_reads,
        "peek_scan_ms": scan_ms, "peek_lookup64_ms": lookup_ms,
        "peek_point64_ms": point_ms, "scan_rows": int(len(s_diff)),
        "max_memory_allocated": int(torch.cuda.max_memory_allocated()),
        "ladder": ladder, "slots": slots, "ladder_after": [b.capacity for b in df.output.runs_b],
        "launches": launches, "folds": folds, "oracle_s": oracle_s,
        "launches_by_shape": {",".join(map(str, k)): v for k, v in sorted(by_shape.items())},
    }
    emit(out)
    out["by_shape"] = by_shape
    del df, h_inputs, c_inputs, fed, base
    torch.cuda.empty_cache()
    return out


def _same_rows(torch, kb, tb, what: str) -> None:
    """Two batches hold the same valid rows (columns, time, diff) at the
    same capacity."""
    n = int(kb.count)
    check(int(tb.count) == n and kb.capacity == tb.capacity, f"{what}: counts differ")
    for x, y in zip(kb.cols + (kb.time, kb.diff), tb.cols + (tb.time, tb.diff)):
        check(torch.equal(x[:n], y[:n]), f"{what}: rows differ")


def _same_runs(torch, ks, ts) -> None:
    """Two spines hold the same runs, slots, cached lanes and cursor."""
    check(ks.cursor == ts.cursor and len(ks.slots) == len(ts.slots), "slot rings differ")
    for kb, tb, kl, tl in zip(ks.runs_b + ks.slots, ts.runs_b + ts.slots,
                              ks.lanes + ks.slot_lanes, ts.lanes + ts.slot_lanes):
        _same_rows(torch, kb, tb, "run")
        n = int(kb.count)
        check(torch.equal(kl[:n], tl[:n]), "run lanes differ")


def phase_modes(torch, merge_kernel, card) -> None:
    from materialize_tpu_torch.ops.merge import merge_mode
    from materialize_tpu_torch.workloads.index import index_config

    def run(mode):
        df, hydrate, churn = index_config(
            sf=0.01, n_orders_per_tick=1024, state_cap=1 << 23, out_levels=4,
            ce=4, ratio=4, slots=True, seed=42, device="cuda",
        )
        start = merge_kernel.LAUNCHES
        with merge_mode(mode):
            h = hydrate()
            n_h = len(h) - len(h) % df._compact_every
            df.run_span(h[:n_h])
            df.run_steps(h[n_h:])
            span = [churn(i, df.time + i)[0] for i in range(16)]
            df.run_span(span)
            df.check_flags()
            base = df.output_batch()
        return df, base, merge_kernel.LAUNCHES - start

    kdf, kbase, k_launch = run("kernel")
    tdf, tbase, t_launch = run("torch")
    check(k_launch > 0 and t_launch == 0, f"mode launches {k_launch}/{t_launch}")
    _same_runs(torch, kdf.output, tdf.output)
    emit({"phase": "kernel_vs_plain_path", "sf": 0.01, "rows": int(kbase.count),
          "kernel_launches": k_launch, "plain_launches": t_launch, "equal": True,
          "card": card})


# -- TPC-H Q1 -------------------------------------------------------------------

Q1_COLS = (4, 5, 6, 7, 8, 9, 10)  # quantity, extendedprice, discount, tax,
# returnflag, linestatus, shipdate: what Q1 reads of lineitem


def _host_cols(torch, batches, cols) -> tuple:
    """Columns ``cols`` and the diffs of every fed batch, on the host
    (one concatenation on the device and one copy per column)."""
    def column(get):
        return torch.cat([get(b)[:b._host_count] for b in batches]).cpu().numpy()

    return tuple(column(lambda b, i=i: b.cols[i]).astype(np.int64) for i in cols) + (
        column(lambda b: b.diff),
    )


def q1_oracle(qty, ext, disc, tax, flag, status, ship, diff, cutoff: int) -> dict:
    """TPC-H Q1 in numpy int64, independent of the port: {(returnflag,
    linestatus): (sum_qty, sum_base_price, sum_disc_price, sum_charge,
    count)} over the live rows (groups whose count nets to 0 vanish)."""
    keep = ship <= cutoff
    disc_price = ext * (100 - disc)  # scale 4
    charge = disc_price * (100 + tax)  # scale 6
    vals = np.stack([qty, ext, disc_price, charge, np.ones_like(qty)], 1)[keep]
    vals = vals * diff[keep][:, None]
    keys = np.stack([flag[keep], status[keep]], 1)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    sums = np.zeros((len(uniq), 5), dtype=np.int64)
    np.add.at(sums, inv.reshape(-1), vals)
    return {(int(k[0]), int(k[1])): tuple(int(x) for x in row)
            for k, row in zip(uniq, sums) if row[4] != 0}


def _device_ops(torch, fn) -> int:
    """Device operations (kernels, copies, fills) ``fn`` issues, counted
    by ``torch.profiler`` (device activity only: host events would cost
    the profiler more than the ticks). The profiler's raw events are
    counted: turning 10^5 of them into ``FunctionEvent``s takes tens of
    seconds."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return sum(1 for e in prof.profiler.kineto_results.events() if e.device_type() == cuda)


def _drive(torch, merge_kernel, df, h_inputs, c_inputs, name: str,
           warm: int = 0, span_hydrate: int = 32, span_churn: int = 16,
           ticks_churn: int = 32, after_hydrate=None, counters=None) -> dict:
    """The main path of a workload: hydrate in spans, call
    ``after_hydrate(df)`` if given, churn ``warm`` ticks, then churn
    ``ticks_churn`` more ticks in timed spans of ``span_churn``, each
    span's flags read back once. With ``warm`` (a workload whose tiers
    grow to the churn's size), hydrate and warm spans may overflow (roll
    back, grow and replay; counted); without, no span may. The timed
    churn spans never may. The merge-path counts are zeroed just before
    and read just after. ``counters()`` gives more counts to difference
    over each timed span."""
    growth = warm > 0
    ce = df._compact_every
    n_h = len(h_inputs) - len(h_inputs) % ce
    torch.cuda.synchronize()
    merge_kernel.LAUNCHES = 0
    merge_kernel.LAUNCHES_BY_SHAPE.clear()
    # -- main path: hydrate, then churn ------------------------------------------
    t_h = time.perf_counter()
    h_reads, grown = [], 0
    for span in _spans(h_inputs[:n_h], span_hydrate):
        before = df._readbacks
        df.run_span(span)
        over = df.check_flags()
        check(growth or not over, f"{name} hydration overflowed a tier")
        grown += over
        h_reads.append(df._readbacks - before)
    if n_h < len(h_inputs):
        df.run_steps(h_inputs[n_h:])
    torch.cuda.synchronize()
    hydrate_s = time.perf_counter() - t_h
    if after_hydrate is not None:
        after_hydrate(df)
    w_reads = []
    for span in _spans(c_inputs[:warm], span_churn):
        before = df._readbacks
        df.run_span(span)
        grown += df.check_flags()
        w_reads.append(df._readbacks - before)
    span_ms, c_reads, c_counts = [], [], []
    for span in _spans(c_inputs[warm:warm + ticks_churn], span_churn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        before = df._readbacks
        before_c = counters() if counters else {}
        if len(span) % ce:  # a span the fold schedule cannot start clean
            df.run_steps(span, defer_check=True)
        else:
            df.run_span(span)
        n_grown = len(df._grown)
        check(df.check_flags() is False,
              f"{name} churn overflowed a tier: {df._grown[n_grown:]}")
        torch.cuda.synchronize()
        span_ms.append((time.perf_counter() - t) * 1e3)
        c_reads.append(df._readbacks - before)
        if counters:
            c_counts.append({k: v - before_c[k] for k, v in counters().items()})
    torch.cuda.synchronize()
    launches = merge_kernel.LAUNCHES
    by_shape = dict(merge_kernel.LAUNCHES_BY_SHAPE)
    # -- end of the main path ------------------------------------------------------
    check(all(r == 1 for r in c_reads), f"{name} churn flags readbacks per span {c_reads}")
    check(growth or all(r == 1 for r in h_reads),
          f"{name} hydrate flags readbacks per span {h_reads}")
    check(launches > 0, f"the {name} path launched no merge-path kernel")
    check(sum(by_shape.values()) == launches, f"{name} launches by shape do not add up")
    return {"hydrate_s": hydrate_s, "span_ms": span_ms, "readbacks_per_span": c_reads,
            "hydrate_readbacks_per_span": h_reads, "warm_readbacks_per_span": w_reads,
            "spans_grown": grown, "grown_keys": [str(k) for k in df._grown],
            "counts_per_span": c_counts,
            "launches": launches, "by_shape": by_shape,
            "tick_ms": [m / span_churn for m in span_ms]}


def _profiled_ticks(torch, df, inputs, name: str) -> float:
    """Device operations per tick over a few more churn ticks (one
    deferred span, its flags read once)."""
    def ticks():
        df.run_steps(inputs, defer_check=True)
        check(df.check_flags() is False, f"{name} churn overflowed a tier")

    return _device_ops(torch, ticks) / len(inputs)


def _path_summary(run: dict, c_rows: list) -> dict:
    """The end-to-end numbers of a ``_drive`` run; ``c_rows``: the row
    updates of its timed churn ticks."""
    return {
        "hydrate_s": run["hydrate_s"], "churn_ticks": len(c_rows),
        "churn_updates": int(sum(c_rows)),
        "churn_updates_per_s": sum(c_rows) / (sum(run["span_ms"]) / 1e3),
        "span_ms": run["span_ms"], "tick_ms_p50": float(np.percentile(run["tick_ms"], 50)),
        "tick_ms_p99": float(np.percentile(run["tick_ms"], 99)),
        "readbacks_per_span": run["readbacks_per_span"],
        "hydrate_readbacks_per_span": run["hydrate_readbacks_per_span"],
        "warm_readbacks_per_span": run["warm_readbacks_per_span"],
        "spans_grown": run["spans_grown"], "grown_keys": run["grown_keys"],
        "launches": run["launches"],
        "launches_by_shape": {",".join(map(str, k)): v
                              for k, v in sorted(run["by_shape"].items())},
    }


def _stream(config, sf: float, ticks: int):
    """(df, hydrate inputs, churn inputs, churn rows, gen s, churn gen s)
    of a workload's configuration at ``sf`` on the card."""
    t0 = time.perf_counter()
    df, hydrate, churn = config(sf=sf, n_orders_per_tick=1024, seed=42, device="cuda")
    h_inputs = hydrate()
    gen_s = time.perf_counter() - t0
    t_c = time.perf_counter()
    c_inputs, c_rows = [], []
    for i in range(ticks):
        inp, n = churn(i, len(h_inputs) + i)
        c_inputs.append(inp)
        c_rows.append(n)
    return df, h_inputs, c_inputs, c_rows, gen_s, time.perf_counter() - t_c


def phase_q1(torch, merge_kernel, card, sf: float = 1.0) -> dict:
    from materialize_tpu_torch.workloads.tpch import Q1_CUTOFF, q1_config

    ticks_churn, span_churn = 32, 16
    df, h_inputs, c_inputs, c_rows, gen_s, churn_gen_s = _stream(
        q1_config, sf, ticks_churn + span_churn)
    run = _drive(torch, merge_kernel, df, h_inputs, c_inputs, "Q1")
    ops = _profiled_ticks(torch, df, c_inputs[ticks_churn:], "Q1")

    fed = [inp["lineitem"] for inp in h_inputs + c_inputs]
    t_o = time.perf_counter()
    want = q1_oracle(*_host_cols(torch, fed, Q1_COLS), cutoff=Q1_CUTOFF)
    oracle_s = time.perf_counter() - t_o
    t = time.perf_counter()
    rows = df.peek()
    peek_ms = (time.perf_counter() - t) * 1e3
    got = {(r[0], r[1]): tuple(r[2:7]) for r in rows}
    check(len(rows) == len(got) and all(r[-1] == 1 for r in rows), "Q1 peek rows not unique")
    check(got == want, f"Q1 peek != numpy oracle: {got} vs {want}")
    errors = df.peek_errors()
    check(errors == [], f"Q1 err collection not empty: {errors}")
    out = {
        "phase": "q1", "sf": sf, "card": card, "groups": len(got),
        "hydrate_ticks": len(h_inputs), "hydrate_gen_s": gen_s, "churn_gen_s": churn_gen_s,
        **_path_summary(run, c_rows[:ticks_churn]),
        "device_ops_per_tick": ops, "peek_ms": peek_ms,
        "oracle_s": oracle_s, "peek_errors": errors,
        "state_capacity": df.states[0][0].capacity,
        "output_ladder": [b.capacity for b in df.output.runs_b],
    }
    emit(out)
    out["by_shape"] = run["by_shape"]
    del df, h_inputs, c_inputs, fed
    torch.cuda.empty_cache()
    return out


# -- TPC-H Q15 ------------------------------------------------------------------

Q15_COLS = (2, 5, 6, 10)  # suppkey, extendedprice, discount, shipdate


def q15_oracle(supp, ext, disc, ship, diff, lo: int, hi: int, s_keys, s_names) -> set:
    """TPC-H Q15 in numpy int64, independent of the port: {(s_suppkey,
    s_name, total_revenue)} for the suppliers whose revenue (scale 4)
    over the live rows shipped in [lo, hi) is the largest. A supplier's
    group lives while its rows net to a nonzero count."""
    keep = (ship >= lo) & (ship < hi)
    amount = ext[keep] * (100 - disc[keep]) * diff[keep]
    keys, inv = np.unique(supp[keep], return_inverse=True)
    revenue = np.zeros(len(keys), dtype=np.int64)
    rows = np.zeros(len(keys), dtype=np.int64)
    np.add.at(revenue, inv.reshape(-1), amount)
    np.add.at(rows, inv.reshape(-1), diff[keep])
    live = rows != 0
    if not live.any():
        return set()
    top = revenue[live].max()
    name = dict(zip(s_keys.tolist(), s_names.tolist()))
    return {(int(k), int(name[int(k)]), int(r))
            for k, r, alive in zip(keys, revenue, live) if alive and r == top}


def _state_tiers(df) -> list:
    """Capacity tiers of every state part (each run of a spine)."""
    return [[[b.capacity for b in p.runs_b] if hasattr(p, "runs_b") else p.capacity
             for p in parts] for parts in df.states]


def phase_q15(torch, merge_kernel, card, sf: float = 1.0) -> dict:
    from materialize_tpu_torch.workloads.tpch import Q15_HI, Q15_LO, q15_config

    warm, ticks_churn, span_churn = 16, 32, 16
    df, h_inputs, c_inputs, c_rows, gen_s, churn_gen_s = _stream(
        q15_config, sf, warm + ticks_churn + span_churn)
    tiers_before = _state_tiers(df)
    # The join spines' first run takes a churn tick's revenue changes
    # (~2.5x a hydrate tick's) for 8 ticks: the warm span grows it.
    run = _drive(torch, merge_kernel, df, h_inputs, c_inputs, "Q15", warm=warm)
    ops = _profiled_ticks(torch, df, c_inputs[warm + ticks_churn:], "Q15")

    fed = [inp["lineitem"] for inp in h_inputs + c_inputs]
    sup = h_inputs[0]["supplier"]
    n_sup = int(sup.count)
    t_o = time.perf_counter()
    want = q15_oracle(*_host_cols(torch, fed, Q15_COLS), lo=Q15_LO, hi=Q15_HI,
                      s_keys=sup.cols[0][:n_sup].cpu().numpy(),
                      s_names=sup.cols[2][:n_sup].cpu().numpy())
    oracle_s = time.perf_counter() - t_o
    t = time.perf_counter()
    rows = df.peek()
    peek_ms = (time.perf_counter() - t) * 1e3
    got = {tuple(r[:3]) for r in rows}
    check(len(rows) == len(got) and all(r[-1] == 1 for r in rows), "Q15 peek rows not unique")
    check(got == want and len(got) >= 1, f"Q15 peek != numpy oracle: {got} vs {want}")
    errors = df.peek_errors()
    check(errors == [], f"Q15 err collection not empty: {errors}")
    out = {
        "phase": "q15", "sf": sf, "card": card, "rows": sorted(got),
        "suppliers": n_sup, "hydrate_ticks": len(h_inputs),
        "hydrate_gen_s": gen_s, "churn_gen_s": churn_gen_s, "warm_ticks": warm,
        **_path_summary(run, c_rows[warm:warm + ticks_churn]),
        "device_ops_per_tick": ops, "peek_ms": peek_ms,
        "oracle_s": oracle_s, "peek_errors": errors,
        "state_tiers_before": tiers_before, "state_tiers": _state_tiers(df),
        "join_tiers": list(df._ctx.join_caps),
        "output_ladder": [b.capacity for b in df.output.runs_b],
        "max_memory_allocated": int(torch.cuda.max_memory_allocated()),
    }
    emit(out)
    out["by_shape"] = run["by_shape"]
    del df, h_inputs, c_inputs, fed
    torch.cuda.empty_cache()
    return out


# -- TPC-H Q9 -------------------------------------------------------------------

Q9_COLS = (0, 1, 2, 4, 5, 6)  # orderkey, partkey, suppkey, quantity,
# extendedprice, discount: what Q9 reads of lineitem


def _lookup(keys, vals, q):
    """(hit, value) of each ``q`` in the unique ``keys``, by searchsorted."""
    order = np.argsort(keys, kind="stable")
    ks, vs = keys[order], vals[order]
    i = np.clip(np.searchsorted(ks, q), 0, max(len(ks) - 1, 0))
    hit = (ks[i] == q) if len(ks) else np.zeros(len(q), bool)
    return hit, vs[i]


def q9_oracle(li: tuple, part, supplier, partsupp, orders, nation) -> dict:
    """TPC-H Q9 in numpy int64, independent of the port: {(n_name code,
    o_year): sum_profit (scale 4)} over the live rows, each weighted by
    its diff. ``li`` = (orderkey, partkey, suppkey, quantity,
    extendedprice, discount, diff); the tables are column lists. Joins by
    searchsorted; the year from ``datetime64``."""
    okey, pkey, skey, qty, ext, disc, diff = li
    hit_p, _ = _lookup(part[0], part[0], pkey)
    hit_s, nkey = _lookup(supplier[0], supplier[1], skey)
    width = int(max(partsupp[1].max(), skey.max())) + 1
    hit_ps, cost = _lookup(partsupp[0] * width + partsupp[1], partsupp[2], pkey * width + skey)
    hit_o, odate = _lookup(orders[0], orders[4].astype(np.int64), okey)
    hit_n, name = _lookup(nation[0], nation[2], nkey)
    keep = hit_p & hit_s & hit_ps & hit_o & hit_n
    year = odate[keep].astype("datetime64[D]").astype("datetime64[Y]").astype(np.int64) + 1970
    amount = (ext[keep] * (100 - disc[keep]) - cost[keep] * qty[keep]) * diff[keep]
    groups, inv = np.unique(np.stack([name[keep], year], 1), axis=0, return_inverse=True)
    sums = np.zeros(len(groups), np.int64)
    rows = np.zeros(len(groups), np.int64)
    np.add.at(sums, inv.reshape(-1), amount)
    np.add.at(rows, inv.reshape(-1), diff[keep])
    return {(int(g[0]), int(g[1])): int(v) for g, v, r in zip(groups, sums, rows) if r != 0}


def _table_cols(torch, b) -> list:
    n = b._host_count
    return [c[:n].cpu().numpy().astype(np.int64) for c in b.cols]


def q9_presized(sf: float, churn_ticks: int, hydrate_orders: int = 896, **kw):
    """``q9_config`` with every tier pre-sized (``q9_tiers``) for its
    hydration and ``churn_ticks`` churn ticks of 1024 orders."""
    from materialize_tpu_torch.storage.generator.tpch import TpchGenerator
    from materialize_tpu_torch.workloads.tpch import apply_tiers, q9_config, q9_tiers

    df, hydrate, churn = q9_config(sf=sf, hydrate_orders=hydrate_orders, **kw)
    apply_tiers(df, q9_tiers(df, TpchGenerator(sf=sf, seed=kw["seed"]), hydrate_orders,
                             kw["n_orders_per_tick"], churn_ticks))
    return df, hydrate, churn


# Q9's scale: SF 0.25 makes room for the serving phases. At SF 1 its
# phase took 420.5 s of the script's 939.1 s, at SF 0.5 250.9 s of
# 1,085.1 s with the serving phases in (an NVIDIA H100 80GB HBM3 at
# 700 W, PERF.md §4).
Q9_SF = 0.25


def phase_q9(torch, merge_kernel, card, sf: float = 1.0) -> dict:
    from materialize_tpu_torch.workloads.index import rows_per_tick
    from materialize_tpu_torch.workloads.tpch import set_join_tiers

    hydrate_orders, ticks_churn, span_churn, profile_ticks = 16384, 32, 16, 2
    n_ticks = ticks_churn + profile_ticks
    t0 = time.perf_counter()
    df, hydrate, churn = q9_presized(sf, n_ticks, hydrate_orders, n_orders_per_tick=1024,
                                     seed=42, device="cuda")
    h_inputs = hydrate()
    gen_s = time.perf_counter() - t0
    t_c = time.perf_counter()
    c_inputs, c_rows = [], []
    for i in range(n_ticks):
        inp, n = churn(i, len(h_inputs) + i)
        c_inputs.append(inp)
        c_rows.append(n)
    churn_gen_s = time.perf_counter() - t_c
    tiers_before = _state_tiers(df)
    join_before = list(df._ctx.join_caps)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # Pre-sized: no hydrate span may overflow. The join tier carries no
    # rows between ticks: churn runs at a churn tick's, not a hydrate
    # tick's (an overflow would still grow it, and fail the churn check).
    run = _drive(torch, merge_kernel, df, h_inputs, c_inputs, "Q9", span_churn=span_churn,
                 ticks_churn=ticks_churn,
                 after_hydrate=lambda df: set_join_tiers(df, rows_per_tick(1024)))
    peak = int(torch.cuda.max_memory_allocated())
    ops = _profiled_ticks(torch, df, c_inputs[ticks_churn:], "Q9")

    first = h_inputs[0]
    tables = {n: _table_cols(torch, first[n])
              for n in ("part", "supplier", "partsupp", "orders", "nation")}
    fed = [inp["lineitem"] for inp in h_inputs + c_inputs]
    t_o = time.perf_counter()
    want = q9_oracle(_host_cols(torch, fed, Q9_COLS), **tables)
    oracle_s = time.perf_counter() - t_o
    t = time.perf_counter()
    rows = df.peek()
    peek_ms = (time.perf_counter() - t) * 1e3
    got = {(r[0], r[1]): r[2] for r in rows}
    check(len(rows) == len(got) and all(r[-1] == 1 for r in rows), "Q9 peek rows not unique")
    check(got == want, f"Q9 peek != numpy oracle ({len(got)} vs {len(want)} groups)")
    # every (nation, order year): 25 nations x 7 years
    check(len(got) == 175, f"Q9 peek holds {len(got)} groups, not 175")
    errors = df.peek_errors()
    check(errors == [], f"Q9 err collection not empty: {errors}")
    # the largest merge at L = 6 grows with the scale: 2^23 rows at SF 1,
    # 2^22 at SF 0.5, 2^21 at SF 0.25
    wide_rows = int((1 << 23) * sf)
    wide = sorted(k for k in run["by_shape"] if k[3] == 6 and max(k[:3]) >= wide_rows)
    check(wide, f"Q9 launched no merge of {wide_rows} rows at L = 6")
    out = {
        "phase": "q9", "sf": sf, "card": card, "groups": len(got),
        "orders": int(first["orders"]._host_count), "parts": int(first["part"]._host_count),
        "suppliers": int(first["supplier"]._host_count),
        "partsupp": int(first["partsupp"]._host_count),
        "lineitem_rows": int(sum(b._host_count for b in fed[:len(h_inputs)])),
        "hydrate_orders_per_tick": hydrate_orders, "hydrate_ticks": len(h_inputs),
        "hydrate_gen_s": gen_s, "churn_gen_s": churn_gen_s,
        **_path_summary(run, c_rows[:ticks_churn]),
        "device_ops_per_tick": ops, "profiled_ticks": profile_ticks, "peek_ms": peek_ms,
        "oracle_s": oracle_s, "peek_errors": errors,
        "wide_shapes": [list(k) for k in wide],
        "state_tiers_before": tiers_before, "state_tiers": _state_tiers(df),
        "slot_tiers": [[sp.slots[0].capacity if sp.slots else 0 for sp in parts
                        if hasattr(sp, "slots")] for parts in df.states],
        "join_tiers_before": join_before, "join_tiers": list(df._ctx.join_caps),
        "output_ladder": [b.capacity for b in df.output.runs_b],
        "max_memory_allocated": peak,
    }
    emit(out)
    out["by_shape"] = run["by_shape"]
    del df, h_inputs, c_inputs, fed
    torch.cuda.empty_cache()
    return out


# -- TPC-H Q21 ------------------------------------------------------------------

Q21_COLS = (0, 2, 11, 12)  # orderkey, suppkey, commitdate, receiptdate
# Q21's scale. At SF 1 its phase took 347.1 s and the script 1,230.8 s
# of its 1,200 s limit (an NVIDIA H100 80GB HBM3 at 700 W, PERF.md §4).
Q21_SF = 0.5


def q21_oracle(li: tuple, orders, supplier, nation, f_code: int, saudi_code: int) -> dict:
    """TPC-H Q21 in numpy int64, independent of the port
    (``tests/test_decorrelate.py``'s Q21 oracle, vectorised): {s_name
    code: numwait}. ``li`` = (orderkey, suppkey, commitdate,
    receiptdate, diff) of every lineitem update fed. Per order and per
    (order, supplier), the rows and the late rows, weighted by diff; a
    row counts when it is late, its order is 'F' and its supplier Saudi,
    another supplier has a row of the order (EXISTS), and no other
    supplier has a late one (NOT EXISTS)."""
    okey, skey, commit, receipt, diff = li
    late = (receipt > commit).astype(np.int64)

    def by(keys, vals):
        _, inv = np.unique(keys, return_inverse=True)
        inv = inv.reshape(-1)
        sums = np.zeros(inv.max() + 1 if len(inv) else 0, np.int64)
        np.add.at(sums, inv, vals)
        return sums[inv]

    pair = okey * (int(max(skey.max(), supplier[0].max())) + 1) + skey
    exists = by(okey, diff) - by(pair, diff) > 0
    not_exists = by(okey, diff * late) - by(pair, diff * late) == 0
    hit_o, status = _lookup(orders[0], orders[2], okey)
    hit_s, nkey = _lookup(supplier[0], supplier[1], skey)
    _, name = _lookup(supplier[0], supplier[2], skey)
    hit_n, nname = _lookup(nation[0], nation[2], nkey)
    keep = ((late == 1) & hit_o & (status == f_code) & hit_s & hit_n
            & (nname == saudi_code) & exists & not_exists)
    groups, inv = np.unique(name[keep], return_inverse=True)
    counts = np.zeros(len(groups), np.int64)
    np.add.at(counts, inv.reshape(-1), diff[keep])
    return {int(g): int(c) for g, c in zip(groups, counts) if c != 0}


def q21_presized(sf: float, churn_ticks: int, hydrate_orders: int = 896, **kw):
    """``q21_config`` with every tier pre-sized (``q21_tiers``, from the
    hydrate inputs) for its hydration and ``churn_ticks`` churn ticks of
    ``n_orders_per_tick`` orders. Returns (df, hydrate, churn), with
    ``hydrate()`` giving the inputs the tiers were sized from."""
    from materialize_tpu_torch.workloads.tpch import apply_tiers, q21_config, q21_tiers

    df, hydrate, churn = q21_config(sf=sf, hydrate_orders=hydrate_orders, **kw)
    h_inputs = hydrate()
    apply_tiers(df, q21_tiers(df, h_inputs, kw["n_orders_per_tick"], churn_ticks))
    return df, lambda: h_inputs, churn


def _threshold_state(df):
    """The Threshold's arrangement: the one keyed by 25 columns."""
    return next(p for parts in df.states for p in parts
                if not hasattr(p, "runs_b") and p.schema.arity == 25)


def phase_q21(torch, merge_kernel, card, sf: float) -> dict:
    from materialize_tpu_torch.repr.schema import GLOBAL_DICT
    from materialize_tpu_torch.workloads.index import rows_per_tick
    from materialize_tpu_torch.workloads.tpch import set_join_tiers

    hydrate_orders, ticks_churn, span_churn, profile_ticks = 16384, 32, 16, 2
    n_ticks = ticks_churn + profile_ticks
    t0 = time.perf_counter()
    df, hydrate, churn = q21_presized(sf, n_ticks, hydrate_orders, n_orders_per_tick=1024,
                                      seed=42, device="cuda")
    h_inputs = hydrate()
    gen_s = time.perf_counter() - t0
    t_c = time.perf_counter()
    c_inputs, c_rows = [], []
    for i in range(n_ticks):
        inp, n = churn(i, len(h_inputs) + i)
        c_inputs.append(inp)
        c_rows.append(n)
    churn_gen_s = time.perf_counter() - t_c
    tiers_before = _state_tiers(df)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # Pre-sized: no hydrate span may overflow; churn runs at a churn
    # tick's join tier (``set_join_tiers``), as Q9's does.
    run = _drive(torch, merge_kernel, df, h_inputs, c_inputs, "Q21", span_churn=span_churn,
                 ticks_churn=ticks_churn,
                 after_hydrate=lambda df: set_join_tiers(df, rows_per_tick(1024)))
    peak = int(torch.cuda.max_memory_allocated())
    ops = _profiled_ticks(torch, df, c_inputs[ticks_churn:], "Q21")

    first = h_inputs[0]
    tables = {n: _table_cols(torch, first[n]) for n in ("orders", "supplier", "nation")}
    fed = [inp["lineitem"] for inp in h_inputs + c_inputs]
    t_o = time.perf_counter()
    want = q21_oracle(_host_cols(torch, fed, Q21_COLS), **tables,
                      f_code=GLOBAL_DICT.encode("F"),
                      saudi_code=GLOBAL_DICT.encode("SAUDI ARABIA"))
    oracle_s = time.perf_counter() - t_o
    t = time.perf_counter()
    rows = df.peek()
    peek_ms = (time.perf_counter() - t) * 1e3
    got = {r[0]: r[1] for r in rows}
    check(len(rows) == len(got) and all(r[-1] == 1 for r in rows), "Q21 peek rows not unique")
    check(got == want, f"Q21 peek != numpy oracle ({len(got)} vs {len(want)} suppliers)")
    check(len(got) >= 100 * sf, f"Q21 peek holds {len(got)} suppliers")
    errors = df.peek_errors()
    check(errors == [], f"Q21 err collection not empty: {errors}")
    wide = sorted(k for k in run["by_shape"] if k[3] >= 25)
    check(wide, "Q21 launched no merge of 25 lanes")
    out = {
        "phase": "q21", "sf": sf, "card": card, "suppliers_waiting": len(got),
        "numwait": sum(got.values()), "orders": int(first["orders"]._host_count),
        "suppliers": int(first["supplier"]._host_count),
        "lineitem_rows": int(sum(b._host_count for b in fed[:len(h_inputs)])),
        "hydrate_orders_per_tick": hydrate_orders, "hydrate_ticks": len(h_inputs),
        "hydrate_gen_s": gen_s, "churn_gen_s": churn_gen_s,
        **_path_summary(run, c_rows[:ticks_churn]),
        "device_ops_per_tick": ops, "profiled_ticks": profile_ticks, "peek_ms": peek_ms,
        "oracle_s": oracle_s, "peek_errors": errors,
        "threshold_state_rows": int(_threshold_state(df).batch.count),
        "threshold_state_capacity": _threshold_state(df).capacity,
        "wide_shapes": [list(k) for k in wide],
        "state_tiers_before": tiers_before, "state_tiers": _state_tiers(df),
        "join_tiers": list(df._ctx.join_caps),
        "output_ladder": [b.capacity for b in df.output.runs_b],
        "max_memory_allocated": peak,
    }
    emit(out)
    out["by_shape"] = run["by_shape"]
    del df, h_inputs, c_inputs, fed
    torch.cuda.empty_cache()
    return out


# -- TPC-H Q7, planned from its text --------------------------------------------

Q7_COLS = (0, 2, 5, 6, 10)  # orderkey, suppkey, extendedprice, discount, shipdate
# Q7's scale and hydrate tick, the cuts the time limit forced: at SF 1
# in ticks of 16,384 orders the script took 1,149.6 s, its Q7 phase
# 247.1 s (an NVIDIA H100 80GB HBM3 at 700 W, PERF.md §4).
Q7_SF = 0.5
Q7_HYDRATE_ORDERS = 32768


def q7_oracle(li: tuple, supplier, customer, orders, nation, fr_code: int, de_code: int,
              lo: int, hi: int) -> dict:
    """TPC-H Q7 in numpy int64, independent of the port: {(supp_nation
    code, cust_nation code, l_year): revenue (scale 4)} over the live
    rows, each weighted by its diff. ``li`` = (orderkey, suppkey,
    extendedprice, discount, shipdate, diff); the tables are column
    lists. A row counts when it shipped in [lo, hi] and its supplier's
    and its order's customer's nations are FRANCE and GERMANY, either
    way round. Joins by searchsorted; the year from ``datetime64``."""
    okey, skey, ext, disc, ship, diff = li
    hit_s, s_nat = _lookup(supplier[0], supplier[1], skey)
    hit_o, cust = _lookup(orders[0], orders[1], okey)
    hit_c, c_nat = _lookup(customer[0], customer[1], cust)
    _, n1 = _lookup(nation[0], nation[2], s_nat)
    _, n2 = _lookup(nation[0], nation[2], c_nat)
    pair = ((n1 == fr_code) & (n2 == de_code)) | ((n1 == de_code) & (n2 == fr_code))
    keep = (ship >= lo) & (ship <= hi) & hit_s & hit_o & hit_c & pair
    year = ship[keep].astype("datetime64[D]").astype("datetime64[Y]").astype(np.int64) + 1970
    volume = ext[keep] * (100 - disc[keep]) * diff[keep]
    groups, inv = np.unique(np.stack([n1[keep], n2[keep], year], 1), axis=0,
                            return_inverse=True)
    sums = np.zeros(len(groups), np.int64)
    np.add.at(sums, inv.reshape(-1), volume)
    return {tuple(int(x) for x in g): int(v) for g, v in zip(groups, sums) if v != 0}


def q7_presized(sf: float, churn_ticks: int, hydrate_orders: int = 896, **kw):
    """``q7_config`` (the dataflow planned from ``Q7_SQL`` by the port's
    frontend and optimizer) with every tier pre-sized (``q7_tiers``, from
    the hydrate inputs). Returns (df, hydrate, churn), with ``hydrate()``
    giving the inputs the tiers were sized from."""
    from materialize_tpu_torch.workloads.tpch import apply_tiers, q7_config, q7_tiers

    df, hydrate, churn = q7_config(sf=sf, hydrate_orders=hydrate_orders, **kw)
    h_inputs = hydrate()
    apply_tiers(df, q7_tiers(df, h_inputs, kw["n_orders_per_tick"], churn_ticks))
    return df, lambda: h_inputs, churn


def phase_q7(torch, merge_kernel, card, sf: float) -> dict:
    """TPC-H Q7 at ``sf`` in Q9's layout, its dataflow planned on the
    card's machine from ``Q7_SQL`` by the port's SQL frontend and
    optimizer: nation and supplier ride the first hydrate tick, customer
    the second, every order the third with the first of the lineitem
    ticks of ``Q7_HYDRATE_ORDERS`` orders (``q7_stagger``), every tier pre-sized
    (``q7_tiers``: no hydrate span may overflow); then the join tier is
    set to a churn tick's and 32 churn ticks run as spans of 16, one
    flags readback each, and 2 more are profiled."""
    from materialize_tpu_torch.repr.schema import GLOBAL_DICT
    from materialize_tpu_torch.workloads.index import rows_per_tick
    from materialize_tpu_torch.workloads.tpch import Q7_HI, Q7_LO, set_join_tiers

    hydrate_orders, ticks_churn, span_churn, profile_ticks = Q7_HYDRATE_ORDERS, 32, 16, 2
    n_ticks = ticks_churn + profile_ticks
    t0 = time.perf_counter()
    df, hydrate, churn = q7_presized(sf, n_ticks, hydrate_orders, n_orders_per_tick=1024,
                                     seed=42, device="cuda")
    h_inputs = hydrate()
    gen_s = time.perf_counter() - t0
    t_c = time.perf_counter()
    c_inputs, c_rows = [], []
    for i in range(n_ticks):
        inp, n = churn(i, len(h_inputs) + i)
        c_inputs.append(inp)
        c_rows.append(n)
    churn_gen_s = time.perf_counter() - t_c
    tiers_before = _state_tiers(df)
    join_before = list(df._ctx.join_caps)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run = _drive(torch, merge_kernel, df, h_inputs, c_inputs, "Q7", span_churn=span_churn,
                 ticks_churn=ticks_churn,
                 after_hydrate=lambda df: set_join_tiers(df, rows_per_tick(1024)))
    peak = int(torch.cuda.max_memory_allocated())
    ops = _profiled_ticks(torch, df, c_inputs[ticks_churn:], "Q7")

    tables = {n: _table_cols(torch, next(inp[n] for inp in h_inputs if inp[n]._host_count))
              for n in ("supplier", "customer", "orders", "nation")}
    fed = [inp["lineitem"] for inp in h_inputs + c_inputs]
    t_o = time.perf_counter()
    want = q7_oracle(_host_cols(torch, fed, Q7_COLS), **tables,
                     fr_code=GLOBAL_DICT.encode("FRANCE"),
                     de_code=GLOBAL_DICT.encode("GERMANY"), lo=Q7_LO, hi=Q7_HI)
    oracle_s = time.perf_counter() - t_o
    t = time.perf_counter()
    rows = df.peek()
    peek_ms = (time.perf_counter() - t) * 1e3
    got = {r[:3]: r[3] for r in rows}
    check(len(rows) == len(got) and all(r[-1] == 1 for r in rows), "Q7 peek rows not unique")
    check(got == want, f"Q7 peek != numpy oracle ({len(got)} vs {len(want)} groups)")
    check(len(got) == 4, f"Q7 peek holds {len(got)} groups, not 4")
    errors = df.peek_errors()
    check(errors == [], f"Q7 err collection not empty: {errors}")
    out = {
        "phase": "q7", "sf": sf, "card": card, "groups": len(got),
        "view": [[GLOBAL_DICT.decode(k[0]), GLOBAL_DICT.decode(k[1]), k[2], v]
                 for k, v in sorted(got.items())],
        "orders": len(tables["orders"][0]), "customers": len(tables["customer"][0]),
        "suppliers": len(tables["supplier"][0]),
        "lineitem_rows": int(sum(b._host_count for b in fed[:len(h_inputs)])),
        "hydrate_orders_per_tick": hydrate_orders, "hydrate_ticks": len(h_inputs),
        "hydrate_gen_s": gen_s, "churn_gen_s": churn_gen_s,
        **_path_summary(run, c_rows[:ticks_churn]),
        "device_ops_per_tick": ops, "profiled_ticks": profile_ticks, "peek_ms": peek_ms,
        "oracle_s": oracle_s, "peek_errors": errors,
        "state_tiers_before": tiers_before, "state_tiers": _state_tiers(df),
        "join_tiers_before": join_before, "join_tiers": list(df._ctx.join_caps),
        "output_ladder": [b.capacity for b in df.output.runs_b],
        "max_memory_allocated": peak,
    }
    emit(out)
    out["by_shape"] = run["by_shape"]
    del df, h_inputs, c_inputs, fed
    torch.cuda.empty_cache()
    return out


# -- the SQL frontend on the card's machine ---------------------------------------


def _count_nodes(expr) -> int:
    return 1 + sum(_count_nodes(c) for c in expr.children())


def phase_sql_plans(card) -> dict:
    """Q21 and Q7 planned from their text by the port's SQL frontend and
    optimizer on this machine (host Python; no JAX here): the Q21 plan
    must equal ``q21_plan()``, and Q7's must be one 6-input delta join.
    Planning ms are the best of 5."""
    from materialize_tpu_torch.expr import relation as mir
    from materialize_tpu_torch.sql.plan import plan_statement
    from materialize_tpu_torch.transform.optimizer import optimize
    from materialize_tpu_torch.workloads.tpch import Q7_SQL, Q21_SQL, q21_plan, tpch_catalog

    check("jax" not in sys.modules and "materialize_tpu" not in sys.modules,
          "the port imported JAX or the reference")
    out = {"phase": "sql_plans", "card": card}
    for name, sql in (("q21", Q21_SQL), ("q7", Q7_SQL)):
        times = []
        for _ in range(5):
            t = time.perf_counter()
            plan = optimize(plan_statement(sql, tpch_catalog()).expr)
            times.append((time.perf_counter() - t) * 1e3)
        out[f"{name}_nodes"] = _count_nodes(plan)
        out[f"{name}_plan_ms"] = min(times)
        if name == "q21":
            check(plan == q21_plan(), "the port's plan of Q21_SQL != q21_plan()")
        else:
            joins = [e for e in _walk(plan) if isinstance(e, mir.Join)]
            check(len(joins) == 1 and joins[0].implementation == "delta"
                  and len(joins[0].inputs) == 6, "Q7 is not one 6-input delta join")
    emit(out)
    return out


def _walk(expr):
    yield expr
    for c in expr.children():
        yield from _walk(c)


# -- the rest of scalar evaluation, on the card -----------------------------------

SCALAR_ROWS = 256
SCALAR_STRINGS = ("", "a", "Abc", "banana", "hello world", "HELLO", "x_y%z", "zeta")
DAY_MS = 86_400_000
SCALAR_FLOAT_RTOL = 1e-14


def _scalar_data(rng):
    """Seeded columns (id, f, d, i, day, ts, b1, b2, s) with NULLs: floats
    with the int32 and int64 cast edges and half-way rows, decimals of
    scale 2 with half-way rows, int64 with the int32 edges."""
    n = SCALAR_ROWS
    f = rng.uniform(-4, 4, n)
    f[:12] = [2.0**31 + 0.5, -(2.0**31) - 2.0, 1e19, -1e19, 0.5, 2.5, -2.5, 1.5, -0.5,
              0.0, 1.0, -1.0]
    i = rng.integers(-10**6, 10**6, n)
    i[:6] = [2**31, -(2**31) - 1, 2**31 - 1, -(2**31), 0, 7]
    d = rng.integers(-10**5, 10**5, n) * rng.choice([1, 5, 50], n)
    cols = [np.arange(n, dtype=np.int64), f, d, i,
            rng.integers(-30000, 30000, n).astype(np.int32),
            rng.integers(-(1 << 41), 1 << 41, n), rng.random(n) < 0.5, rng.random(n) < 0.5,
            rng.integers(0, len(SCALAR_STRINGS), n)]
    nulls = [None] + [rng.random(n) < 0.15 for _ in range(8)]
    return cols, nulls


def _civil(days):
    """(year, month, day) numpy arrays of day numbers."""
    d = np.asarray(days, dtype="datetime64[D]")
    y = d.astype("datetime64[Y]").astype(np.int64) + 1970
    m = d.astype("datetime64[M]").astype(np.int64) % 12 + 1
    return y, m, (d - d.astype("datetime64[M]")).astype(np.int64) + 1


def _ymd_days(y, m, dd=1):
    return ((np.asarray(y) - 1970) * 12 + np.asarray(m) - 1).astype("datetime64[M]") \
        .astype("datetime64[D]").astype(np.int64) + np.asarray(dd) - 1


def _add_months(days, months):
    y, m, d = _civil(days)
    m0 = m - 1 + months
    y2, m2 = y + m0 // 12, m0 % 12 + 1
    length = _ymd_days(y2 + (m2 == 12), np.where(m2 == 12, 1, m2 + 1)) - _ymd_days(y2, m2)
    return _ymd_days(y2, m2, np.minimum(d, length))


def _half_away(v, step):
    return np.sign(v) * ((np.abs(v) + step // 2) // step)


def _saturate(x):
    out = np.where(np.isnan(x) | (np.abs(x) >= 2.0**63), 0.0, x).astype(np.int64)
    return np.where(x >= 2.0**63, np.iinfo(np.int64).max,
                    np.where(x < -(2.0**63), np.iinfo(np.int64).min, out))


def scalar_groups(ms, text):
    """Groups of (name, expression over (id, f, d, i, day, ts, b1, b2, s),
    numpy oracle (cols, NULL masks) -> (values, NULL mask, the rows that
    raise a numeric out-of-range error or None)): every function of the
    port's ``expr/scalar.py`` that the TPC-H paths do not run, and a few
    string functions (``text`` makes a string literal)."""
    c, U, B, V = ms.col, ms.UnaryFunc, ms.BinaryFunc, ms.VariadicFunc
    lit = ms.lit

    def un(f, i):
        return ms.CallUnary(f, c(i))

    def plain(fn, i):
        return lambda cols, nulls: (fn(cols[i]), nulls[i], None)

    def domain(fn, bad, i):
        def go(cols, nulls):
            with np.errstate(all="ignore"):
                return fn(cols[i]), nulls[i] | bad(cols[i]), None
        return go

    f32_bad = lambda x: np.isnan(x) | (x >= 2.0**31) | (x < -(2.0**31))  # noqa: E731
    f64_bad = lambda x: np.isnan(x) | (x >= 2.0**63) | (x < -(2.0**63))  # noqa: E731
    i32_bad = lambda x: (x >= 2**31) | (x < -(2**31))  # noqa: E731

    def cast_err(bad, i, dtype):
        def go(cols, nulls):
            x = cols[i]
            b = bad(x)
            return np.where(b, 0, x).astype(dtype), nulls[i] | b, b & ~nulls[i]
        return go

    def trunc_ts(kind):
        def go(cols, nulls):
            ms_ = cols[5]
            days, msod = ms_ // DAY_MS, ms_ % DAY_MS
            y, m, _ = _civil(days)
            step = {"hour": 3_600_000, "minute": 60_000, "second": 1000}.get(kind)
            if step:
                return days * DAY_MS + msod - msod % step, nulls[5], None
            t = {"year": _ymd_days(y, 1), "quarter": _ymd_days(y, 3 * ((m - 1) // 3) + 1),
                 "month": _ymd_days(y, m), "week": days - (days + 3) % 7, "day": days}[kind]
            return t * DAY_MS, nulls[5], None
        return go

    def tri(op):
        """SQL three-valued AND/OR of b1, b2: (values, NULLs)."""
        def go(cols, nulls):
            a, b, an, bn = cols[6], cols[7], nulls[6], nulls[7]
            if op == "and":
                false = (~a & ~an) | (~b & ~bn)
                return a & b & ~false, (an | bn) & ~false, None
            true = (a & ~an) | (b & ~bn)
            return a | b, (an | bn) & ~true, None
        return go

    def greatest(cols, nulls):  # GREATEST(i, d) at scale 2; NULLs skipped
        i, d = cols[3] * 100, cols[2]
        inn, dn = nulls[3], nulls[2]
        v = np.where(inn, d, np.where(dn, i, np.maximum(i, d)))
        return v, inn & dn, None

    def least_f(cols, nulls):
        f, i = cols[1], cols[3].astype(np.float64)
        fn, inn = nulls[1], nulls[3]
        return np.where(fn, i, np.where(inn, f, np.minimum(f, i))), fn & inn, None

    def add_interval_day(cols, nulls):
        return _add_months(cols[4], 1) + 3, nulls[4], None

    def add_interval_ts(cols, nulls):
        days, msod = cols[5] // DAY_MS, cols[5] % DAY_MS
        return _add_months(days, -13) * DAY_MS + msod + 5000, nulls[5], None

    def if_(cols, nulls):
        take = cols[6] & ~nulls[6]
        return np.where(take, cols[3], 0), take & nulls[3], None

    def strings(fn):
        def go(cols, nulls):
            return [fn(SCALAR_STRINGS[k]) for k in cols[8]], nulls[8], None
        return go

    math_fns = {"sqrt": (np.sqrt, lambda x: x < 0), "ln": (np.log, lambda x: x <= 0),
                "log10": (np.log10, lambda x: x <= 0), "log2": (np.log2, lambda x: x <= 0),
                "asin": (np.arcsin, lambda x: np.abs(x) > 1),
                "acos": (np.arccos, lambda x: np.abs(x) > 1)}
    plain_fns = {"cbrt": np.cbrt, "exp": np.exp, "sin": np.sin, "cos": np.cos,
                 "tan": np.tan, "atan": np.arctan, "radians": np.radians,
                 "degrees": np.degrees, "floor": np.floor, "ceil": np.ceil,
                 "round": np.round, "trunc": np.trunc}
    groups = {
        "math": [(f"{k}_f", un(k, 1), domain(fn, bad, 1)) for k, (fn, bad) in math_fns.items()]
        + [(f"{k}_f", un(k, 1), plain(fn, 1)) for k, fn in plain_fns.items()]
        + [("sign_f", un(U.SIGN, 1), plain(lambda x: np.sign(x).astype(np.int64), 1)),
           ("sign_i", un(U.SIGN, 3), plain(np.sign, 3)),
           ("neg_i", un(U.NEG, 3), plain(np.negative, 3)),
           ("abs_d", un(U.ABS, 2), plain(np.abs, 2))],
        "rounding": [
            ("floor_d", un(U.FLOOR, 2), plain(lambda v: v // 100 * 100, 2)),
            ("ceil_d", un(U.CEIL, 2), plain(lambda v: -((-v) // 100) * 100, 2)),
            ("trunc_d", un(U.TRUNC, 2), plain(lambda v: np.sign(v) * (np.abs(v) // 100) * 100, 2)),
            ("round_d", un(U.ROUND, 2), plain(lambda v: _half_away(v, 100) * 100, 2)),
            ("round_to_f_2", ms.CallBinary(B.ROUND_TO, c(1), lit(2)),
             plain(lambda x: np.round(x * 100.0) / 100.0, 1)),
            ("round_to_d_1", ms.CallBinary(B.ROUND_TO, c(2), lit(1)),
             plain(lambda v: _half_away(v, 10) * 10, 2)),
            ("round_to_i_m2", ms.CallBinary(B.ROUND_TO, c(3), lit(-2)),
             plain(lambda v: _half_away(v, 100) * 100, 3)),
            ("cast_decimal_f_2", ms.CallBinary(B.CAST_DECIMAL, c(1), lit(2)),
             plain(lambda x: _saturate(np.round(x * 100.0)), 1)),
            ("cast_decimal_d_1", ms.CallBinary(B.CAST_DECIMAL, c(2), lit(1)),
             plain(lambda v: _half_away(v, 10), 2)),
            ("cast_decimal_i_2", ms.CallBinary(B.CAST_DECIMAL, c(3), lit(2)),
             plain(lambda v: v * 100, 3)),
        ],
        "casts": [
            ("cast_int64_f", un(U.CAST_INT64, 1), cast_err(f64_bad, 1, np.int64)),
            ("cast_int32_f", un(U.CAST_INT32, 1), cast_err(f32_bad, 1, np.int32)),
            ("cast_int32_i", un(U.CAST_INT32, 3), cast_err(i32_bad, 3, np.int32)),
            ("cast_int64_d", un(U.CAST_INT64, 2), plain(lambda v: v // 100, 2)),
            ("cast_float64_d", un(U.CAST_FLOAT64, 2), plain(lambda v: v / 100.0, 2)),
            ("cast_float64_i", un(U.CAST_FLOAT64, 3), plain(lambda v: v.astype(float), 3)),
            ("cast_bool_i", un(U.CAST_BOOL, 3), plain(lambda v: v != 0, 3)),
            ("cast_date_ts", un(U.CAST_DATE, 5), plain(lambda v: v // DAY_MS, 5)),
            ("cast_timestamp_day", un(U.CAST_TIMESTAMP, 4),
             plain(lambda v: v.astype(np.int64) * DAY_MS, 4)),
        ],
        "dates": [(f"date_trunc_{k}_ts", un(f, 5), trunc_ts(k))
                  for k, f in U.DATE_TRUNCS.items()]
        + [("date_trunc_month_day", un(U.DATE_TRUNC_MONTH, 4),
            plain(lambda v: _ymd_days(*_civil(v)[:2]), 4)),
           ("add_interval_day", ms.CallVariadic(V.ADD_INTERVAL, (c(4), lit(1), lit(3), lit(0))),
            add_interval_day),
           ("add_interval_ts",
            ms.CallVariadic(V.ADD_INTERVAL, (c(5), lit(-13), lit(0), lit(5000))),
            add_interval_ts)],
        "variadic": [
            ("and", ms.and_(c(6), c(7)), tri("and")),
            ("or", ms.or_(c(6), c(7)), tri("or")),
            ("coalesce", ms.CallVariadic(V.COALESCE, (c(3), lit(7))),
             lambda cols, nulls: (np.where(nulls[3], 7, cols[3]), np.zeros(len(cols[3]), bool),
                                  None)),
            ("greatest_i_d", ms.CallVariadic(V.GREATEST, (c(3), c(2))), greatest),
            ("least_f_i", ms.CallVariadic(V.LEAST, (c(1), c(3))), least_f),
            ("if_b1_i_0", ms.If(c(6), c(3), lit(0)), if_),
        ],
        "strings": [
            ("upper", ms.string_call("upper", c(8)), strings(str.upper)),
            ("length", ms.string_call("length", c(8)), strings(len)),
            ("like", ms.string_call("like", c(8), text("%a%")), strings(lambda s: "a" in s)),
            ("substr", ms.string_call("substr", c(8), lit(2), lit(3)),
             strings(lambda s: s[1:4])),
        ],
    }
    return groups


def phase_scalars_small(torch, merge_kernel, card) -> dict:
    """Every function of the port's scalar evaluation outside the TPC-H
    paths, and four string functions, in six small dataflows (one Map a
    group, the row id kept) over 2 ticks of 256 seeded rows with NULLs on
    the card (the second retracts 64 rows): each output column against
    numpy, exactly, floats within rel 1e-14; the err collection against
    the out-of-range casts numpy counts."""
    from materialize_tpu_torch.expr import relation as mir
    from materialize_tpu_torch.expr import scalar as ms
    from materialize_tpu_torch.render.dataflow import Dataflow
    from materialize_tpu_torch.repr.batch import Batch
    from materialize_tpu_torch.repr.schema import GLOBAL_DICT, Column, ColumnType, Schema

    T = ColumnType
    schema = Schema([Column("id", T.INT64), Column("f", T.FLOAT64, True),
                     Column("d", T.DECIMAL, True, 2), Column("i", T.INT64, True),
                     Column("day", T.DATE, True), Column("ts", T.TIMESTAMP, True),
                     Column("b1", T.BOOL, True), Column("b2", T.BOOL, True),
                     Column("s", T.STRING, True)])
    rng = np.random.default_rng(8)
    cols, nulls = _scalar_data(rng)
    masks = [np.zeros(SCALAR_ROWS, bool) if m is None else m for m in nulls]
    codes = GLOBAL_DICT.encode_many(SCALAR_STRINGS)
    dev_cols = cols[:8] + [codes[cols[8]]]
    n = SCALAR_ROWS
    gone = rng.choice(n, 64, replace=False)
    ticks = [
        Batch.from_numpy(schema, dev_cols, np.zeros(n, np.uint64), np.ones(n, np.int64),
                         nulls=nulls, device="cuda"),
        Batch.from_numpy(schema, [c[gone] for c in dev_cols], np.ones(64, np.uint64),
                         -np.ones(64, np.int64), nulls=[None if m is None else m[gone]
                                                        for m in nulls], device="cuda"),
    ]
    live = np.ones(n, bool)
    live[gone] = False
    groups = scalar_groups(ms, lambda v: ms.lit(GLOBAL_DICT.encode(v), T.STRING))
    dfs = {g: Dataflow(mir.Get("t", schema).map([e for _, e, _ in items])
                       .project([0, *range(9, 9 + len(items))]), device="cuda")
           for g, items in groups.items()}
    torch.cuda.synchronize()
    merge_kernel.LAUNCHES = 0
    merge_kernel.LAUNCHES_BY_SHAPE.clear()
    # -- main path --------------------------------------------------------------
    for df in dfs.values():
        df.run_steps([{"t": b} for b in ticks])
    torch.cuda.synchronize()
    launches = merge_kernel.LAUNCHES
    by_shape = dict(merge_kernel.LAUNCHES_BY_SHAPE)
    # -- end of the main path ----------------------------------------------------
    check(launches > 0, "the scalars path launched no merge-path kernel")
    checked, worst = 0, 0.0
    for g, items in groups.items():
        b = dfs[g].output_batch()
        m = int(b.count)
        ids = b.cols[0][:m].cpu().numpy()
        check(m == live.sum() and np.array_equal(np.sort(ids), np.flatnonzero(live)),
              f"scalars {g}: rows {m}")
        order = np.argsort(ids)
        want_errs = 0
        for k, (name, _, oracle) in enumerate(items):
            vals = b.cols[k + 1][:m].cpu().numpy()[order]
            nl = b.nulls[k + 1]
            got_null = (nl[:m].cpu().numpy()[order] if nl is not None
                        else np.zeros(m, bool))
            with np.errstate(all="ignore"):
                want, want_null, err_rows = oracle(cols, masks)
            if err_rows is not None:
                want_errs += int((err_rows & live).sum())
            want_null = want_null[live]
            check(np.array_equal(got_null, want_null), f"scalars {name}: NULLs differ")
            ok = ~want_null
            if isinstance(want, list):
                want = np.array(want, dtype=object)[live]
                got = ([GLOBAL_DICT.decode(int(x)) for x in vals] if isinstance(want[0], str)
                       else vals.tolist())
                check(all(a == w for a, w, o in zip(got, want, ok) if o),
                      f"scalars {name}: strings differ")
            elif np.asarray(want).dtype.kind == "f":
                w, v = np.asarray(want)[live][ok], vals[ok]
                with np.errstate(all="ignore"):
                    err = np.where(v == w, 0.0, np.abs(v - w) / np.maximum(np.abs(w), 1e-300))
                worst = max(worst, float(err.max(initial=0.0)))
                check(bool((err <= SCALAR_FLOAT_RTOL).all()), f"scalars {name}: floats differ")
            else:
                check(np.array_equal(vals[ok].astype(np.int64),
                                     np.asarray(want)[live][ok].astype(np.int64)),
                      f"scalars {name}: values differ")
            checked += 1
        errs = dfs[g].peek_errors()
        check(errs == ([(2, want_errs)] if want_errs else []),
              f"scalars {g}: err collection {errs}, want {want_errs} overflow rows")
    out = {"phase": "scalars_small", "card": card, "functions": checked,
           "groups": list(groups), "rows": int(live.sum()), "max_float_rel_err": worst,
           "launches": launches,
           "launches_by_shape": {",".join(map(str, k)): v for k, v in sorted(by_shape.items())}}
    emit(out)
    out["by_shape"] = by_shape
    return out


def phase_path_kernel(torch, merge_kernel, card, shapes, phase: str, counts) -> list:
    """The kernel at each merge shape a path launched, against its plain
    chain; ``counts(cap_a, cap_b, out)`` gives the valid rows of each
    side."""
    from materialize_tpu_torch.ops.merge import merge_source_map_torch

    gen = torch.Generator(device="cuda").manual_seed(99)
    rows = []
    for cap_a, cap_b, out, L in sorted(shapes):
        ac, bc = counts(cap_a, cap_b, out)
        a = _device_pool_lanes(torch, gen, cap_a, L, ac)
        b = _device_pool_lanes(torch, gen, cap_b, L, bc)
        ca = torch.tensor(ac, dtype=torch.int32, device="cuda")
        cb = torch.tensor(bc, dtype=torch.int32, device="cuda")
        src, lanes = merge_kernel.merge_path(a, ca, cap_a, b, cb, out)
        w_src, w_lanes = merge_source_map_torch(a, ca, cap_a, b, cb, cap_b, out)
        err = max(_err(torch, src, w_src), _err(torch, lanes, w_lanes))
        check(err == 0, f"{phase} {(cap_a, cap_b, out, L)}: kernel != plain")
        ms, reps = cuda_ms(torch, lambda: merge_kernel.merge_path(a, ca, cap_a, b, cb, out))
        graph_ms, _ = cuda_ms(
            torch, lambda: merge_kernel.merge_path(a, ca, cap_a, b, cb, out), graph=True
        )
        plain_ms, _ = cuda_ms(
            torch, lambda: merge_source_map_torch(a, ca, cap_a, b, cb, cap_b, out)
        )
        bound = merge_bound_ms(ac, bc, cap_a, out, L)
        row = {"phase": phase, "cap_a": cap_a, "cap_b": cap_b, "out": out,
               "L": L, "a_count": ac, "b_count": bc, "reps": reps, "ms": ms,
               "graph_ms": graph_ms, "bound_ms": bound, "bound_share": bound / ms,
               "plain_ms": plain_ms, "max_abs_err": err, "card": card}
        emit(row)
        rows.append(row)
        del a, b, src, lanes, w_src, w_lanes
    torch.cuda.empty_cache()
    return rows


def _same_state(torch, kdf, tdf) -> None:
    """Every state part (an arrangement's batch; a spine's runs and
    cached lanes), the err arrangement and the output runs are equal."""
    for kparts, tparts in zip(kdf.states, tdf.states):
        for kp, tp in zip(kparts, tparts):
            if hasattr(kp, "runs_b"):
                _same_runs(torch, kp, tp)
            else:
                _same_rows(torch, kp.batch, tp.batch, "state part")
    _same_rows(torch, kdf.err_output.batch, tdf.err_output.batch, "err arrangement")
    _same_runs(torch, kdf.output, tdf.output)


def phase_path_modes(torch, merge_kernel, card, phase: str, config, sf: float = 0.01,
                     span_ticks: int = 16) -> None:
    """A path at a small SF with the merge forced to the kernel and then
    to the plain chain (hydration, then one churn span of ``span_ticks``):
    equal peeks, err collections and states."""
    from materialize_tpu_torch.ops.merge import merge_mode

    def run(mode):
        df, hydrate, churn = config(sf=sf, n_orders_per_tick=1024, seed=42,
                                    device="cuda")
        start = merge_kernel.LAUNCHES
        with merge_mode(mode):
            h = hydrate()
            n_h = len(h) - len(h) % df._compact_every
            df.run_span(h[:n_h])
            df.check_flags()
            df.run_steps(h[n_h:])
            df.run_span([churn(i, df.time + i)[0] for i in range(span_ticks)])
            check(df.check_flags() is False, f"{phase}: churn at SF {sf} overflowed")
            rows = df.peek()
            errors = df.peek_errors()
        return df, rows, errors, merge_kernel.LAUNCHES - start

    kdf, krows, kerr, k_launch = run("kernel")
    tdf, trows, terr, t_launch = run("torch")
    check(k_launch > 0 and t_launch == 0, f"{phase} mode launches {k_launch}/{t_launch}")
    check(krows == trows and kerr == terr == [], f"{phase}: peeks differ between modes")
    _same_state(torch, kdf, tdf)
    emit({"phase": phase, "sf": sf, "rows": len(krows),
          "kernel_launches": k_launch, "plain_launches": t_launch, "equal": True,
          "card": card})


# -- the auction -----------------------------------------------------------------


def auction_oracle(ids, buyers, auctions, amounts, diff, k: int = 3) -> set:
    """``auction_winning_bidders_mir(k)`` in numpy, independent of the
    port (``tests/test_auction.py:_oracle_topk`` vectorised): the buyers
    of the top ``k`` live bids of each auction by amount DESC, ties by
    the bid's row (its id first). Bid ids are unique, so a bid is live
    when its updates net to 1."""
    uid, first, inv = np.unique(ids, return_index=True, return_inverse=True)
    net = np.zeros(len(uid), dtype=np.int64)
    np.add.at(net, inv.reshape(-1), diff)
    check(bool(np.isin(net, (0, 1)).all()), "a bid's updates net outside {0, 1}")
    live = first[net == 1]
    a, m, i, b = auctions[live], amounts[live], ids[live], buyers[live]
    order = np.lexsort((i, -m, a))
    a, b = a[order], b[order]
    start = np.ones(len(a), dtype=bool)
    start[1:] = a[1:] != a[:-1]
    first_of = np.maximum.accumulate(np.where(start, np.arange(len(a)), 0))
    rank = np.arange(len(a)) - first_of
    return {int(x) for x in b[rank < k]}


def phase_auction(torch, merge_kernel, card, name: str, state_cap: int,
                  window: int | None = None, same_as: dict | None = None, **gen) -> dict:
    """The auction (TopK feeding Distinct) on the bid stream of
    ``AuctionGenerator(seed=42, **gen)``, the output's base pre-sized to
    2 rows a user (the bench's recorded tier, ``bench_tiers.json``: 1,024
    for 512 users): 8 hydrate ticks, a warm span of 16 churn ticks, 32
    timed churn ticks as 2 spans of 16, 16 profiled ticks; ``peek()``
    against the numpy oracle over every bid fed.

    With ``window``, the auction under a temporal window
    (``auction_window_config``): the insert-only stream, each bid
    retracted by the filter ``mz_now() < bid_time + window``. Its
    updates are those reaching the TopK, the inserts fed plus the
    retractions the filter releases (the inserts of ``window`` ticks
    before), so they compare with the retract-mode auction's; its final
    peek must equal ``same_as``'s (the retract-mode run of the same seed
    and ticks) as well as the oracle over the bids still in the
    window."""
    from materialize_tpu_torch.workloads.auction import auction_config, auction_window_config
    from materialize_tpu_torch.workloads.tpch import apply_tiers

    warm, ticks_churn, span_churn, profile_ticks = 16, 32, 16, 16
    t0 = time.perf_counter()
    if window is None:
        df, hydrate, churn = auction_config(seed=42, state_cap=state_cap, device="cuda", **gen)
    else:
        df, hydrate, churn = auction_window_config(seed=42, state_cap=state_cap,
                                                   window=window, device="cuda", **gen)
    apply_tiers(df, {"grow": [[("out", df.output.levels - 1), 2 * gen["n_users"]]],
                     "join_caps": [], "out_delta_cap": df.out_delta_cap})
    h_inputs = hydrate()
    c_inputs, c_rows = [], []
    for i in range(warm + ticks_churn + profile_ticks):
        inp, n = churn(i, len(h_inputs) + i)
        c_inputs.append(inp)
        c_rows.append(n)
    if window is not None:
        inserts = [inp["bids"]._host_count for inp in h_inputs] + c_rows
        c_rows = [n + (inserts[t - window] if t >= window else 0)
                  for t, n in zip(range(len(h_inputs), len(inserts)), c_rows)]
    gen_s = time.perf_counter() - t0
    run = _drive(torch, merge_kernel, df, h_inputs, c_inputs, name, warm=warm,
                 span_hydrate=8, span_churn=span_churn, ticks_churn=ticks_churn)
    ops = _profiled_ticks(torch, df, c_inputs[warm + ticks_churn:], name)
    fed = [inp["bids"] for inp in h_inputs + c_inputs]
    t_o = time.perf_counter()
    ids, buyers, auctions, amounts, diff = _host_cols(torch, fed, (0, 1, 2, 3))
    if window is not None:
        # The bids still in the window at the last tick's time.
        last = df.time - 1
        bid_time = _host_cols(torch, fed, (4,))[0]
        live = bid_time > last - window
        ids, buyers, auctions, amounts, diff = (x[live] for x in (ids, buyers, auctions,
                                                                  amounts, diff))
    want = auction_oracle(ids, buyers, auctions, amounts, diff)
    oracle_s = time.perf_counter() - t_o
    t = time.perf_counter()
    rows = df.peek()
    peek_ms = (time.perf_counter() - t) * 1e3
    got = {r[0] for r in rows}
    check(len(got) == len(rows) and all(r[-1] == 1 for r in rows),
          f"{name} peek rows not unique")
    check(got == want and len(want) > 0,
          f"{name} peek != numpy oracle ({len(got)} vs {len(want)} buyers)")
    if same_as is not None:
        check(rows == same_as["peek"], f"{name} peek != {same_as['phase']}'s")
    errors = df.peek_errors()
    check(errors == [], f"{name} err collection not empty: {errors}")
    out = {
        "phase": name, "card": card, **gen, "state_cap": state_cap,
        "bids_per_tick": gen["auctions_per_tick"] * gen["bids_per_auction"],
        "buyers": len(got), "hydrate_ticks": len(h_inputs), "gen_s": gen_s,
        **_path_summary(run, c_rows[warm:warm + ticks_churn]),
        "device_ops_per_tick": ops, "profiled_ticks": profile_ticks, "peek_ms": peek_ms,
        "oracle_s": oracle_s, "peek_errors": errors, "state_tiers": _state_tiers(df),
        "output_ladder": [b.capacity for b in df.output.runs_b],
    }
    if window is not None:
        # The temporal Filter renders last: its buffer is the last slot.
        buf = df.states[-1][0]
        out.update(window=window, peek_equals=same_as["phase"],
                   temporal_buffer_rows=int(buf.batch.count),
                   temporal_buffer_capacity=buf.capacity,
                   join_tiers=list(df._ctx.join_caps))
    emit(out)
    out["by_shape"] = run["by_shape"]
    out["peek"] = rows
    del df, h_inputs, c_inputs, fed
    torch.cuda.empty_cache()
    return out


# -- the small arms ---------------------------------------------------------------

ARMS_CONSTANT = (((7, 70), 2), ((8, 80), 1), ((9, 90), -1))


def arms_plan():
    """Union(Threshold(a - b) arranged by k, a Constant, generate_series
    over s's bounds): every arm the Q21 and window paths leave out, and
    Negate and Threshold again, in one plan."""
    from materialize_tpu_torch.expr import relation as mir
    from materialize_tpu_torch.expr.scalar import col
    from materialize_tpu_torch.repr.schema import Column, ColumnType, Schema

    kv = Schema([Column("k", ColumnType.INT64), Column("v", ColumnType.INT64)])
    bounds = Schema([Column("k", ColumnType.INT64), Column("lo", ColumnType.INT64, True),
                     Column("hi", ColumnType.INT64, True)])
    pos = mir.Union((mir.Get("a", kv), mir.Negate(mir.Get("b", kv)))).threshold()
    series = mir.FlatMap(mir.Get("s", bounds), "generate_series", (col(1), col(2)),
                         (Column("x", ColumnType.INT64),)).project((0, 3))
    return mir.Union((pos.arrange_by((0,)), mir.Constant(ARMS_CONSTANT, kv), series)), kv, bounds


def arms_oracle(ticks) -> dict:
    """The arms plan in numpy: the positive part of a - b, the
    constant's rows once, and (k, x) for every x in [lo, hi] of each s
    row whose bounds are both set, weighted by its diff."""
    acc: dict = {}

    def add(key, d):
        acc[key] = acc.get(key, 0) + int(d)

    ab: dict = {}
    for t in ticks:
        for name, sign in (("a", 1), ("b", -1)):
            k, v, d = t[name]
            for kk, vv, dd in zip(k, v, d):
                ab[(int(kk), int(vv))] = ab.get((int(kk), int(vv)), 0) + sign * int(dd)
        k, lo, hi, lo_null, hi_null, d = t["s"]
        ok = ~(lo_null | hi_null)
        for kk, a, b, dd in zip(k[ok], lo[ok], hi[ok], d[ok]):
            for x in range(int(a), int(b) + 1):
                add((int(kk), x), dd)
    for key, m in ab.items():
        if m > 0:
            add(key, m)
    for row, d in ARMS_CONSTANT:
        add(row, d)
    return {k: v for k, v in acc.items() if v}


def phase_arms_small(torch, merge_kernel, card) -> dict:
    """The arms plan on the card over 3 ticks of a few hundred seeded
    rows: the first tick's fan-out (~2,000 rows) overflows the
    FlatMap's tier of 1,024, which grows and replays; the Threshold's
    input retracts more than it inserts for some rows. ``peek()``
    against ``arms_oracle``."""
    from materialize_tpu_torch.render.dataflow import Dataflow
    from materialize_tpu_torch.repr.batch import Batch

    expr, kv, bounds = arms_plan()
    rng = np.random.default_rng(5)
    ticks = []
    for t in range(3):
        n = 300
        tick = {name: (rng.integers(0, 20, n), rng.integers(0, 6, n),
                       rng.integers(1, 3, n) * rng.choice([-1, 1], n, p=[0.3, 0.7]))
                for name in ("a", "b")}
        m = 200 if t == 0 else 40
        lo = rng.integers(-5, 5, m)
        tick["s"] = (rng.integers(0, 50, m), lo, lo + rng.integers(-2, 20, m),
                     rng.random(m) < 0.1, rng.random(m) < 0.1, rng.integers(1, 3, m))
        ticks.append(tick)

    def inputs(t, tick):
        time = lambda n: np.full(n, t, np.uint64)  # noqa: E731
        out = {name: Batch.from_numpy(kv, [k, v], time(len(d)), d, device="cuda")
               for name, (k, v, d) in ((x, tick[x]) for x in ("a", "b"))}
        k, lo, hi, ln, hn, d = tick["s"]
        out["s"] = Batch.from_numpy(bounds, [k, lo, hi], time(len(d)), d,
                                    nulls=[None, ln, hn], device="cuda")
        return out

    df = Dataflow(expr, device="cuda")
    fed = [inputs(t, tick) for t, tick in enumerate(ticks)]
    torch.cuda.synchronize()
    merge_kernel.LAUNCHES = 0
    merge_kernel.LAUNCHES_BY_SHAPE.clear()
    # -- main path --------------------------------------------------------------
    for inp in fed:
        df.run_steps([inp])
    torch.cuda.synchronize()
    launches = merge_kernel.LAUNCHES
    by_shape = dict(merge_kernel.LAUNCHES_BY_SHAPE)
    # -- end of the main path ----------------------------------------------------
    check(launches > 0, "the arms path launched no merge-path kernel")
    check(("join", 0) in df._grown, f"the FlatMap's tier never grew: {df._grown}")
    got: dict = {}
    for r in df.peek():
        got[r[:-2]] = got.get(r[:-2], 0) + r[-1]
    want = arms_oracle(ticks)
    check(got == want, f"arms peek != numpy oracle ({len(got)} vs {len(want)} rows)")
    check(df.peek_errors() == [], "arms err collection not empty")
    out = {"phase": "arms_small", "card": card, "ticks": len(ticks), "rows": len(got),
           "grown_keys": [str(k) for k in df._grown], "join_tiers": list(df._ctx.join_caps),
           "launches": launches,
           "launches_by_shape": {",".join(map(str, k)): v for k, v in sorted(by_shape.items())}}
    emit(out)
    out["by_shape"] = by_shape
    return out


# -- pagerank --------------------------------------------------------------------


def pagerank_fixpoint(src, dst, max_iters: int = 2000, tol: float = 1e-15) -> dict:
    """The pagerank fixpoint of a graph in numpy, independent of the
    port: r = 0.15 + 0.85 * sum over edges m->n of r(m) / out_deg(m),
    power-iterated from 0.15 until no rank moves by more than ``tol``
    relative (multi-edges count with their multiplicity)."""
    nodes = np.union1d(src, dst)
    s, d = np.searchsorted(nodes, src), np.searchsorted(nodes, dst)
    deg = np.bincount(s, minlength=len(nodes)).astype(np.float64)
    r = np.full(len(nodes), 0.15)
    for _ in range(max_iters):
        nxt = np.full(len(nodes), 0.15)
        np.add.at(nxt, d, 0.85 * r[s] / deg[s])
        done = np.max(np.abs(nxt - r) / nxt) <= tol
        r = nxt
        if done:
            break
    return dict(zip(nodes.tolist(), r.tolist()))


def pagerank_power(edges, n_iters: int) -> dict:
    """``tests/test_letrec.py:_pagerank_oracle``: ``n_iters`` power
    iterations from 0.15, in python floats."""
    nodes = sorted({a for a, _ in edges} | {b for _, b in edges})
    deg = {}
    for a, _ in edges:
        deg[a] = deg.get(a, 0) + 1
    r = {n: 0.15 for n in nodes}
    for _ in range(n_iters):
        nxt = {n: 0.15 for n in nodes}
        for a, b in edges:
            nxt[b] += 0.85 * r[a] / deg[a]
        r = nxt
    return r


def _rank_rows(df, what: str) -> dict:
    rows = df.peek()
    ranks = {r[0]: r[1] for r in rows}
    check(len(ranks) == len(rows) and all(r[-1] == 1 for r in rows),
          f"{what}: peek is not one row of multiplicity 1 per node")
    return ranks


def phase_pagerank(torch, merge_kernel, card, name: str, n_nodes: int, n_edges: int,
                   per_tick: int, state_cap: int, ticks_churn: int, span_churn: int = 8,
                   profile_ticks: int = 1, small_check: bool = False) -> dict:
    """Pagerank (LetRec of a SUM_FLOAT over a Union and two linear joins)
    on the bench's random graph shape, its tiers pre-sized for the
    phase's ticks (``pagerank_tiers``): 1 hydrate tick, then
    ``ticks_churn`` timed ticks in spans of ``span_churn`` (none may
    overflow), and ``profile_ticks`` profiled ones. ``peek()``
    holds one row per node of the final graph, each within rel 1e-3 of
    its numpy fixpoint. With ``small_check``, also the 300-evaluation
    fixpoint of ``tests/test_letrec.py``'s five edges within rel 1e-9."""
    from materialize_tpu_torch.ops import reduce as reduce_ops
    from materialize_tpu_torch.workloads.pagerank import pagerank_config, pagerank_tiers
    from materialize_tpu_torch.workloads.tpch import apply_tiers

    warm, max_iters = 0, 60
    t0 = time.perf_counter()
    df, hydrate, churn, edges = pagerank_config(
        n_nodes=n_nodes, n_edges=n_edges, per_tick=per_tick, max_iters=max_iters,
        state_cap=state_cap, device="cuda")
    apply_tiers(df, pagerank_tiers(df, n_nodes, n_edges, per_tick,
                                   1 + warm + ticks_churn + profile_ticks))
    h_inputs = hydrate()
    c_inputs, c_rows = [], []
    for i in range(warm + ticks_churn + profile_ticks):
        inp, n = churn(i, 1 + i)
        c_inputs.append(inp)
        c_rows.append(n)
    gen_s = time.perf_counter() - t0
    ctx = df._ctx

    def counters():
        return {"letrec_readbacks": ctx.letrec_readbacks,
                "run_sum_readbacks": reduce_ops.RUN_READBACKS,
                "evaluations": sum(ctx.letrec_evals), "letrec_ticks": len(ctx.letrec_evals)}

    tiers_before = _state_tiers(df)
    run = _drive(torch, merge_kernel, df, h_inputs, c_inputs, name, warm=warm,
                 span_churn=span_churn, ticks_churn=ticks_churn, counters=counters)
    timed = run["counts_per_span"]
    evals = [c["evaluations"] / c["letrec_ticks"] for c in timed]
    ops = _profiled_ticks(torch, df, c_inputs[warm + ticks_churn:], name)
    src, dst = edges()
    t_o = time.perf_counter()
    want = pagerank_fixpoint(src, dst)
    oracle_s = time.perf_counter() - t_o
    t = time.perf_counter()
    ranks = _rank_rows(df, name)
    peek_ms = (time.perf_counter() - t) * 1e3
    check(set(ranks) == set(want), f"{name}: peek nodes != the final graph's")
    rel = max(abs(ranks[n] - want[n]) / want[n] for n in want)
    check(rel < 1e-3, f"{name}: ranks off the fixpoint by rel {rel}")
    errors = df.peek_errors()
    check(errors == [], f"{name} err collection not empty: {errors}")
    out = {
        "phase": name, "card": card, "nodes": len(want), "edges": n_edges,
        "edges_rewired_per_tick": per_tick, "max_iters": max_iters, "state_cap": state_cap,
        "gen_s": gen_s, **_path_summary(run, c_rows[warm:warm + ticks_churn]),
        "evaluations_per_tick": evals,
        "letrec_readbacks_per_span": [c["letrec_readbacks"] for c in timed],
        "run_sum_readbacks_per_span": [c["run_sum_readbacks"] for c in timed],
        "letrec_caps": list(ctx.letrec_caps), "join_tiers": list(ctx.join_caps),
        "device_ops_per_tick": ops, "profiled_ticks": profile_ticks,
        "peek_ms": peek_ms, "oracle_s": oracle_s, "max_rel_err": rel,
        "peek_errors": errors, "state_tiers_before": tiers_before,
        "state_tiers": _state_tiers(df),
        "output_ladder": [b.capacity for b in df.output.runs_b],
    }
    if small_check:
        out["five_edge_max_rel_err"] = _pagerank_five_edges(torch)
    emit(out)
    out["by_shape"] = run["by_shape"]
    del df, h_inputs, c_inputs
    torch.cuda.empty_cache()
    return out


def _pagerank_five_edges(torch) -> float:
    """``tests/test_letrec.py``'s fixpoint case on the card: five edges,
    300 evaluations, against 600 power iterations, within rel 1e-9."""
    from materialize_tpu_torch.repr.batch import Batch
    from materialize_tpu_torch.workloads.pagerank import EDGE_SCHEMA, pagerank_mir
    from materialize_tpu_torch.render.dataflow import Dataflow

    edges = [(0, 1), (1, 2), (2, 0), (0, 2), (3, 2)]
    arr = np.array(edges)
    df = Dataflow(pagerank_mir(EDGE_SCHEMA, max_iters=300), device="cuda")
    df.step({"edges": Batch.from_numpy(EDGE_SCHEMA, [arr[:, 0], arr[:, 1]],
                                       np.zeros(5, np.uint64), np.ones(5, np.int64),
                                       device="cuda")})
    got = _rank_rows(df, "pagerank five edges")
    want = pagerank_power(edges, 600)
    check(set(got) == set(want), "pagerank five edges: nodes differ")
    rel = max(abs(got[n] - want[n]) / want[n] for n in want)
    check(rel < 1e-9, f"pagerank five edges: rel {rel}")
    return rel


def phase_new_path_modes(torch, merge_kernel, card, phase: str, make) -> None:
    """A small run with the merge forced to the kernel and then to the
    plain chain: ``make()`` gives (df, list of tick inputs), fed as
    synchronous steps (growing tiers as needed). Every state part, the
    output runs and the peeks must be bit-equal."""
    from materialize_tpu_torch.ops.merge import merge_mode

    def run(mode):
        start = merge_kernel.LAUNCHES
        with merge_mode(mode):
            df, ticks = make()
            for inputs in ticks:
                df.run_steps([inputs])
            rows = df.peek()
            errors = df.peek_errors()
        return df, rows, errors, merge_kernel.LAUNCHES - start

    kdf, krows, kerr, k_launch = run("kernel")
    tdf, trows, terr, t_launch = run("torch")
    check(k_launch > 0 and t_launch == 0, f"{phase} mode launches {k_launch}/{t_launch}")
    check(krows == trows and kerr == terr == [], f"{phase}: peeks differ between modes")
    _same_state(torch, kdf, tdf)
    emit({"phase": phase, "rows": len(krows), "kernel_launches": k_launch,
          "plain_launches": t_launch, "equal": True, "card": card})


def _small_auction():
    from materialize_tpu_torch.workloads.auction import auction_config

    df, hydrate, churn = auction_config(seed=42, n_users=64, auctions_per_tick=8,
                                        bids_per_auction=8, state_cap=256, device="cuda")
    ticks = hydrate()
    return df, ticks + [churn(i, len(ticks) + i)[0] for i in range(8)]


def _small_pagerank():
    from materialize_tpu_torch.workloads.pagerank import pagerank_config

    df, hydrate, churn, _ = pagerank_config(n_nodes=200, n_edges=1000, per_tick=16,
                                            max_iters=10, state_cap=256, device="cuda")
    return df, hydrate() + [churn(i, 1 + i)[0] for i in range(3)]


def _merged_shapes(*runs) -> dict:
    out: dict = {}
    for r in runs:
        for k, v in r["by_shape"].items():
            out[k] = out.get(k, 0) + v
    return out


# -- the serving stack over pgwire ----------------------------------------------

SERVE_SF = 0.1  # bench config_q1's scale (bench.py:268-273)
SERVE_CHURN = 1024  # orders a tick, as the port's other TPC-H cells
SERVE_TICKS, SERVE_SPAN = 32, 16
SERVE_LOOKUPS = 256

SERVE_Q1_SQL = """SELECT l_returnflag, l_linestatus,
  sum(l_quantity) AS sum_qty, sum(l_extendedprice) AS sum_base_price,
  sum(l_extendedprice * (1 - l_discount)) AS sum_disc_price,
  sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) AS sum_charge,
  avg(l_quantity) AS avg_qty, avg(l_extendedprice) AS avg_price,
  avg(l_discount) AS avg_disc, count(*) AS count_order
FROM lineitem
WHERE l_shipdate <= DATE '1998-12-01' - INTERVAL '90' DAY
GROUP BY l_returnflag, l_linestatus"""

SERVE_ORDER_LINES_SQL = (
    "CREATE VIEW order_lines AS SELECT l_orderkey, count(*) AS lines, "
    "sum(l_quantity) AS qty FROM lineitem GROUP BY l_orderkey"
)


class PgClient:
    """The simple query protocol of PostgreSQL v3: a startup message,
    then Query messages answered by RowDescription, DataRows,
    CommandComplete and ReadyForQuery (or an ErrorResponse, raised)."""

    def __init__(self, port: int, timeout: float = 300.0):
        import socket
        import struct

        self._struct = struct
        self.sock = socket.create_connection(("127.0.0.1", port), timeout)
        self.sock.settimeout(timeout)
        body = struct.pack("!I", 196608) + b"user\x00chip_smoke\x00\x00"
        self.sock.sendall(struct.pack("!I", len(body) + 4) + body)
        self._until_ready()

    def _exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            check(bool(chunk), "pgwire server closed the connection")
            buf += chunk
        return buf

    def _until_ready(self) -> list:
        msgs = []
        while True:
            tag = self._exact(1)
            (n,) = self._struct.unpack("!I", self._exact(4))
            msgs.append((tag, self._exact(n - 4)))
            if tag == b"Z":
                return msgs

    def query(self, sql: str) -> tuple:
        """(columns, rows as tuples of text or None, command tag)."""
        st = self._struct
        body = sql.encode() + b"\x00"
        self.sock.sendall(b"Q" + st.pack("!I", len(body) + 4) + body)
        cols, rows, tag, err = [], [], None, None
        for t, p in self._until_ready():
            if t == b"T":
                (n,) = st.unpack("!H", p[:2])
                off = 2
                for _ in range(n):
                    end = p.index(b"\x00", off)
                    cols.append(p[off:end].decode())
                    off = end + 19
            elif t == b"D":
                (n,) = st.unpack("!H", p[:2])
                off, row = 2, []
                for _ in range(n):
                    (ln,) = st.unpack("!i", p[off:off + 4])
                    off += 4
                    row.append(None if ln == -1 else p[off:off + ln].decode())
                    off += max(ln, 0)
                rows.append(tuple(row))
            elif t == b"C":
                tag = p[:-1].decode()
            elif t == b"E":
                f = {x[:1]: x[1:].decode() for x in p.split(b"\x00") if x}
                err = f"{f.get(b'C')}: {f.get(b'M')}"
        check(err is None, f"pgwire error for {sql[:60]!r}: {err}")
        return cols, rows, tag

    def close(self) -> None:
        try:
            self.sock.sendall(b"X" + self._struct.pack("!I", 4))
        finally:
            self.sock.close()


class ServeStack:
    """The port's serving stack in this process: a replica thread on the
    card (its worker thread does all the device work), a Coordinator
    over FileBlob and SqliteConsensus in ``root``, a PgServer on a free
    port, and one wire client. ``mode`` forces the replica's merges to
    the kernel or the plain chain (None: the device rule)."""

    def __init__(self, root: str, mode=None):
        import contextvars
        import socket
        import threading

        from materialize_tpu_torch.coord.coordinator import Coordinator
        from materialize_tpu_torch.coord.protocol import PersistLocation
        from materialize_tpu_torch.coord.replica import serve_forever
        from materialize_tpu_torch.ops.merge import merge_mode
        from materialize_tpu_torch.server.pgwire import PgServer
        from materialize_tpu_torch.storage.persist import (FileBlob, PersistClient,
                                                           SqliteConsensus)

        self.loc = PersistLocation(f"{root}/blob", f"{root}/consensus.db")
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        ready, self._handle = threading.Event(), []
        # The merge mode is a context variable: the replica thread runs in
        # a copy of a context that holds it.
        with merge_mode(mode):
            ctx = contextvars.copy_context()
        self._thread = threading.Thread(
            target=ctx.run, args=(serve_forever, port, self.loc, "r0", ready),
            kwargs={"handle": self._handle, "device": "cuda"}, daemon=True)
        self._thread.start()
        check(ready.wait(60), "replica did not start")
        self.coord = Coordinator(
            PersistClient(FileBlob(self.loc.blob_root),
                          SqliteConsensus(self.loc.consensus_path)),
            tick_interval=None)
        self.coord.add_replica("r0", ("127.0.0.1", port))
        self.pg = PgServer(self.coord).start()
        self.client = PgClient(self.pg.port)

    @property
    def worker(self):
        return self._handle[0]

    def view(self, name: str):
        return self.worker.dataflows[name].view

    def blob_files(self) -> tuple:
        n = size = 0
        for d, _dirs, files in os.walk(self.loc.blob_root):
            for f in files:
                n += 1
                size += os.path.getsize(os.path.join(d, f))
        return n, size

    def close(self) -> None:
        self.client.close()
        self.pg.stop()
        self.pg._thread.join(30)
        self.coord.shutdown()
        self.worker.stop()
        self._thread.join(60)
        check(not self._thread.is_alive(), "replica thread did not stop")


def _timed(client, sql: str) -> tuple:
    t = time.perf_counter()
    out = client.query(sql)
    return out, (time.perf_counter() - t) * 1e3


def _serve_oracle_parts(sf: float, churn: int, ticks: int):
    """The generator's lineitem stream, on the host, as the source's
    adapter draws it: (snapshot parts, churn parts of ticks 1..ticks)."""
    from materialize_tpu_torch.storage.generator.tpch import TpchGenerator

    gen = TpchGenerator(sf=sf, seed=1)
    snap = list(gen.snapshot_lineitem_parts())
    churn_parts = [gen.churn_lineitem_part(min(churn, gen.n_orders), t)
                   for t in range(1, ticks + 1)]
    return gen, snap, churn_parts


def _cols_of(parts, idx) -> tuple:
    return tuple(np.concatenate([p[0][i] for p in parts]).astype(np.int64) for i in idx) + (
        np.concatenate([p[1] for p in parts]).astype(np.int64),)


def _check_q1_wire(rows, parts, what: str) -> None:
    """Q1's rows off the wire against ``q1_oracle`` over ``parts``: the
    sums and the count exactly, and each of the three averages exactly
    as the engine divides decimals: the scale-2 sum over the count,
    rounded down to scale 2."""
    from decimal import Decimal

    from materialize_tpu_torch.repr.schema import GLOBAL_DICT
    from materialize_tpu_torch.workloads.tpch import Q1_CUTOFF

    cols = _cols_of(parts, Q1_COLS)
    want = q1_oracle(*cols, cutoff=Q1_CUTOFF)
    _qty, _ext, disc, _tax, flag, status, ship, diff = cols
    keep = ship <= Q1_CUTOFF
    keys, inv = np.unique(np.stack([flag[keep], status[keep]], 1), axis=0, return_inverse=True)
    sums = np.zeros(len(keys), np.int64)
    np.add.at(sums, inv.reshape(-1), disc[keep] * diff[keep])
    disc_sum = {(int(f), int(s)): int(v) for (f, s), v in zip(keys, sums)}
    want = {(GLOBAL_DICT.decode(f), GLOBAL_DICT.decode(s)):
            v + tuple(t // v[4] for t in (v[0], v[1], disc_sum[(f, s)]))
            for (f, s), v in want.items()}
    got = {}
    for r in rows:
        qty, base, disc_price, charge, *avgs = (Decimal(x) for x in r[2:9])
        got[(r[0], r[1])] = (int(qty * 100), int(base * 100), int(disc_price * 10**4),
                             int(charge * 10**6), int(r[9]),
                             *(int(a * 100) for a in avgs))
    check(len(got) == len(rows) and got == want, f"{what}: Q1 over pgwire != oracle: {got} vs {want}")


def _order_lines_oracle(parts) -> tuple:
    """(lines, sum qty at scale 2) per orderkey over the live rows."""
    key, qty, diff = _cols_of(parts, (0, 4))
    n = int(key.max()) + 1
    lines = np.bincount(key, weights=diff, minlength=n).astype(np.int64)
    total = np.zeros(n, np.int64)
    np.add.at(total, key, qty * diff)
    return lines, total


TABLE_SCRIPT = [
    "CREATE TABLE items (id bigint NOT NULL, name text NOT NULL, price numeric(10,2) NOT NULL)",
    "CREATE TABLE sales (item bigint NOT NULL, qty bigint NOT NULL)",
    "INSERT INTO items VALUES (1, 'apple', 1.25), (2, 'pear', 2.50), (3, 'fig', 0.75)",
    "INSERT INTO sales VALUES (1, 4), (1, 10), (2, 3), (3, 7), (3, 1), (4, 2)",
    "CREATE MATERIALIZED VIEW revenue AS SELECT i.name, count(*) AS n, "
    "sum(s.qty * i.price) AS rev FROM sales s JOIN items i ON s.item = i.id GROUP BY i.name",
    "SELECT * FROM revenue",
    "DELETE FROM sales WHERE qty > 5",
    "UPDATE items SET price = price + 1 WHERE id = 1",
    "SELECT * FROM revenue",
    "SELECT * FROM sales",
]


def _table_path(client) -> tuple:
    """The table path over the wire: the timestamp oracle and group
    commit, a join and an aggregate maintained through DELETE and UPDATE,
    and a slow-path SELECT. Returns (ms per statement, SELECT rows)."""
    from decimal import Decimal

    ms, selects = [], []
    for sql in TABLE_SCRIPT:
        (cols, rows, tag), t = _timed(client, sql)
        ms.append(t)
        if sql.startswith("SELECT"):
            selects.append(sorted(rows, key=repr))

    def rev(rows):
        return {r[0]: (int(r[1]), Decimal(r[2])) for r in rows}

    check(rev(selects[0]) == {"apple": (2, Decimal("17.5")), "pear": (1, Decimal("7.5")),
                              "fig": (2, Decimal("6"))}, f"revenue {selects[0]}")
    check(rev(selects[1]) == {"apple": (1, Decimal("9")), "pear": (1, Decimal("7.5")),
                              "fig": (1, Decimal("0.75"))}, f"revenue {selects[1]}")
    check(sorted((int(a), int(b)) for a, b in selects[2]) == [(1, 4), (2, 3), (3, 1), (4, 2)],
          f"sales {selects[2]}")
    return ms, selects


class _TickSplit:
    """Where a paced served tick's time goes. On the coordinator's side
    (this thread) the source's generation and its persist appends, the
    lineitem shard's apart; on the replica's (its worker thread) each
    view's steps that did work, split into the shard fetch (wait for
    the upper, decode, host-to-device), the dataflow step (to its flags
    readback) and the sink append. The methods are wrapped on the
    instances for the paced ticks only, and timed on the host clock."""

    def __init__(self, src, views: dict):
        self.ms = {}
        self._undo = []
        self._wrap(src.adapter, "tick", "source.generate")
        self._wrap(src, "_append_all", "source.append_all")
        for name, v in views.items():
            self._wrap(v, "step", f"{name}.step", lambda r: r is True)
            self._wrap(v, "step_span", f"{name}.step_span", lambda r: r is True)
            self._wrap(v.df, "step", f"{name}.df_step")
            self._wrap(v.df, "run_steps", f"{name}.df_run_steps")
            self._wrap(v, "_append", f"{name}.sink_append")
            for sname, s in v.sources.items():
                self._wrap(s, "fetch_to", f"{name}.fetch_{sname}")
        for sub, w in src.writers.items():
            self._wrap(w, "compare_and_append",
                       "source.cas_lineitem" if sub == "lineitem" else "source.cas_other")

    def _wrap(self, obj, attr: str, key: str, keep=None) -> None:
        fn = getattr(obj, attr)

        def timed(*a, **kw):
            t = time.perf_counter()
            r = fn(*a, **kw)
            if keep is None or keep(r):
                self.ms.setdefault(key, []).append((time.perf_counter() - t) * 1e3)
            return r

        setattr(obj, attr, timed)
        self._undo.append((obj, attr))

    def remove(self) -> None:
        for obj, attr in self._undo:
            delattr(obj, attr)

    def p50(self) -> dict:
        out = {}
        for k, v in sorted(self.ms.items()):
            if k == "source.cas_other":  # 7 appends a tick
                v = [sum(v[i:i + 7]) for i in range(0, len(v), 7)]
            out[k] = float(np.percentile(v, 50))
        return out


def _serve_script(st, sf: float, churn: int, ticks: int, span: int, n_lookups: int,
                  q1_selects: int, paced: int = 8, span_pipelining: bool = False) -> dict:
    """The serving script on one stack: ``span_pipelining`` set over the
    wire (on, the replica steps every ready tick of a view as one span
    with one flags readback; off, a tick at a time), the DDL, ``ticks`` churn ticks
    of the source in spans of ``span`` with ``SELECT * FROM q1`` after
    each (checked against the oracle afterwards, off the clock), then
    ``paced`` ticks each waited for until both views have stepped past
    it (the source's persist write, then the replica's read, step and
    sink append), point lookups on ``order_lines`` over the wire and
    straight through the coordinator, checked against the oracle, more
    Q1 SELECTs for their latency, then the table path."""
    from decimal import Decimal

    from materialize_tpu_torch.storage.persist import operators

    c = st.client
    c.query(f"SET span_pipelining = {str(span_pipelining).lower()}")
    ddl = [
        ("create_source", f"CREATE SOURCE tpch FROM LOAD GENERATOR TPCH "
                          f"(SCALE FACTOR {sf}, CHURN ORDERS {churn})"),
        ("create_mv_q1", "CREATE MATERIALIZED VIEW q1 AS " + SERVE_Q1_SQL),
        ("create_view_order_lines", SERVE_ORDER_LINES_SQL),
        ("create_index_order_lines", "CREATE INDEX order_lines_idx ON order_lines (l_orderkey)"),
    ]
    ddl_ms = {}
    for name, sql in ddl:
        _out, ddl_ms[name] = _timed(c, sql)
    # The views hydrate on the replica's first steps, which the first
    # SELECT waits for.
    (_cols, first_q1, _tag), first_select_ms = _timed(c, "SELECT * FROM q1")
    t_o = time.perf_counter()
    gen, snap, churn_parts = _serve_oracle_parts(sf, churn, ticks + paced)
    oracle_gen_s = time.perf_counter() - t_o
    rows_written = sum(len(p[1]) for p in churn_parts[:ticks])
    src = st.coord.sources["tpch"]
    q1_view, ol_view = st.view("q1"), st.view("order_lines_idx")
    rb0 = {"q1": q1_view.df._readbacks, "order_lines": ol_view.df._readbacks}
    up0 = {"q1": q1_view.upper, "order_lines": ol_view.upper}
    for k in operators.H2D:
        operators.H2D[k] = 0
    files0, bytes0 = st.blob_files()
    span_selects, span_select_ms, tick_ms = [], [], []
    t_first = time.perf_counter()
    for _s in range(ticks // span):
        for _i in range(span):
            t = time.perf_counter()
            src.tick_once()
            tick_ms.append((time.perf_counter() - t) * 1e3)
        (_cols, rows, _tag), t = _timed(c, "SELECT * FROM q1")
        span_selects.append(rows)
        span_select_ms.append(t)
    served_s = time.perf_counter() - t_first
    h2d = dict(operators.H2D)
    files1, bytes1 = st.blob_files()
    steps = {"q1": q1_view.upper - up0["q1"], "order_lines": ol_view.upper - up0["order_lines"]}
    check(min(steps.values()) >= ticks, f"views stepped {steps} of {ticks} ticks")
    readbacks = {"q1": q1_view.df._readbacks - rb0["q1"],
                 "order_lines": ol_view.df._readbacks - rb0["order_lines"]}
    # -- paced ticks: one at a time, each waited for, its time split ---------
    paced_write_ms, paced_fresh_ms = [], []
    split = _TickSplit(src, {"q1": q1_view, "order_lines": ol_view})
    try:
        for _i in range(paced):
            target = src.t + 1
            t = time.perf_counter()
            src.tick_once()
            t_w = time.perf_counter()
            while q1_view.upper < target or ol_view.upper < target:
                check(time.perf_counter() - t_w < 60, "a paced tick was not stepped within 60 s")
                time.sleep(0.0002)
            paced_write_ms.append((t_w - t) * 1e3)
            paced_fresh_ms.append((time.perf_counter() - t) * 1e3)
    finally:
        split.remove()
    # -- checks, off the clock --------------------------------------------------
    _check_q1_wire(first_q1, snap, "Q1 after hydration")
    for i, rows in enumerate(span_selects):
        _check_q1_wire(rows, snap + churn_parts[: (i + 1) * span], f"Q1 after span {i}")
    lines, qty = _order_lines_oracle(snap + churn_parts)
    rng = np.random.default_rng(7)
    keys = rng.integers(1, gen.n_orders + 1, n_lookups)
    lookup_ms, direct_ms = [], []
    for k in keys.tolist():
        sql = f"SELECT * FROM order_lines WHERE l_orderkey = {k}"
        (_cols, rows, _tag), t = _timed(c, sql)
        lookup_ms.append(t)
        want = [] if lines[k] == 0 else [(k, int(lines[k]), int(qty[k]))]
        got = [(int(r[0]), int(r[1]), int(Decimal(r[2]) * 100)) for r in rows]
        check(got == want, f"order_lines lookup {k}: {got} vs {want}")
        # The same lookup below pgwire: the coordinator, the controller's
        # batcher, the protocol and the replica's gather on the card.
        t = time.perf_counter()
        res = st.coord.execute(sql)
        direct_ms.append((time.perf_counter() - t) * 1e3)
        got = [(int(r[0]), int(r[1]), int(r[2] * 100)) for r in res.rows]
        check(got == want, f"order_lines lookup {k} in process: {got} vs {want}")
    q1_ms = list(span_select_ms)
    for _ in range(q1_selects):
        (_cols, rows, _tag), t = _timed(c, "SELECT * FROM q1")
        q1_ms.append(t)
    _check_q1_wire(rows, snap + churn_parts, "Q1 at rest")
    table_ms, table_selects = _table_path(c)
    c.query("SET span_pipelining = DEFAULT")
    return {
        "span_pipelining": span_pipelining,
        "ddl_ms": ddl_ms,
        # From the first view's DDL to Q1's first answer.
        "hydrate_s": (sum(v for k, v in ddl_ms.items() if k != "create_source")
                      + first_select_ms) / 1e3,
        "first_select_q1_ms": first_select_ms, "oracle_gen_s": oracle_gen_s,
        "churn_ticks": ticks, "source_rows_written": rows_written,
        "served_s": served_s, "churn_updates_per_s": rows_written / served_s,
        "source_tick_ms_p50": float(np.percentile(tick_ms, 50)),
        "select_q1_ms_p50": float(np.percentile(q1_ms, 50)),
        "select_q1_ms_p99": float(np.percentile(q1_ms, 99)),
        "select_q1_after_span_ms": span_select_ms,
        "lookups": len(keys), "lookup_hits": int(sum(lines[k] != 0 for k in keys)),
        "lookup_ms_p50": float(np.percentile(lookup_ms, 50)),
        "lookup_ms_p99": float(np.percentile(lookup_ms, 99)),
        "lookup_in_process_ms_p50": float(np.percentile(direct_ms, 50)),
        "lookup_in_process_ms_p99": float(np.percentile(direct_ms, 99)),
        "paced_ticks": paced,
        "paced_source_write_ms_p50": float(np.percentile(paced_write_ms, 50)),
        "paced_tick_fresh_ms_p50": float(np.percentile(paced_fresh_ms, 50)),
        "paced_tick_fresh_ms_p99": float(np.percentile(paced_fresh_ms, 99)),
        "paced_split_ms_p50": split.p50(),
        "replica_steps": steps,
        "flags_readbacks_per_step": {k: readbacks[k] / max(steps[k], 1) for k in steps},
        "h2d_batches_per_tick": h2d["batches"] / ticks,
        "h2d_copies_per_tick": h2d["copies"] / ticks,
        "h2d_bytes_per_tick": h2d["bytes"] / ticks,
        "persist_parts_written_churn": files1 - files0,
        "persist_bytes_written_churn": bytes1 - bytes0,
        "table_ms": table_ms,
        "selects": [sorted(r) for r in [first_q1, *span_selects]] + table_selects,
    }


def phase_serve(torch, merge_kernel, card, bare_q1: dict, span_pipelining: bool = False) -> dict:
    """TPC-H Q1 and point lookups served over pgwire by the port's own
    stack, the replica's dataflows on the card (module docstring)."""
    import tempfile

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    merge_kernel.LAUNCHES = 0
    merge_kernel.LAUNCHES_BY_SHAPE.clear()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        st = ServeStack(root)
        try:
            out = _serve_script(st, SERVE_SF, SERVE_CHURN, SERVE_TICKS, SERVE_SPAN,
                                SERVE_LOOKUPS, q1_selects=32,
                                span_pipelining=span_pipelining)
            files, size = st.blob_files()
        finally:
            st.close()
    torch.cuda.synchronize()
    launches = merge_kernel.LAUNCHES
    by_shape = dict(merge_kernel.LAUNCHES_BY_SHAPE)
    check(launches > 0, "the serve path launched no merge-path kernel")
    out.pop("selects")
    res = {
        "phase": "serve", "sf": SERVE_SF, "churn_orders": SERVE_CHURN, "card": card,
        **out,
        "bare_q1_churn_updates_per_s": bare_q1["churn_updates_per_s"],
        "bare_q1_sf": bare_q1["sf"],
        "persist_parts_total": files, "persist_bytes_total": size,
        "launches": launches,
        "launches_by_shape": {",".join(map(str, k)): v for k, v in sorted(by_shape.items())},
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
        "phase_s": time.perf_counter() - t0,
    }
    emit(res)
    res["by_shape"] = by_shape
    return res


def phase_serve_modes(torch, merge_kernel, card) -> None:
    """The serve script at SF 0.002 with the replica's merges forced to
    the kernel and then to the plain chain: every SELECT equal."""
    import tempfile

    def run(mode):
        start = merge_kernel.LAUNCHES
        with tempfile.TemporaryDirectory() as root:
            st = ServeStack(root, mode=mode)
            try:
                out = _serve_script(st, 0.002, 64, 8, 4, 32, q1_selects=2)
            finally:
                st.close()
        return out["selects"], merge_kernel.LAUNCHES - start

    ksel, k_launch = run("kernel")
    tsel, t_launch = run("torch")
    check(k_launch > 0 and t_launch == 0, f"serve modes launches {k_launch}/{t_launch}")
    check(ksel == tsel, "serve: SELECTs differ between merge modes")
    emit({"phase": "serve_vs_plain_path", "sf": 0.002, "selects": len(ksel),
          "kernel_launches": k_launch, "plain_launches": t_launch, "equal": True,
          "card": card})


def half_full(ca, cb, out):
    """Q15's, Q9's, Q21's, pagerank's and the serving views' runs fill up
    to their tier (Q15's join spines and MAX multiset hold one row per
    supplier, Q9's and Q21's their tables, pagerank's a row per node or
    edge): time them half full."""
    return ca // 2, min(cb // 2, max(out - ca // 2, 0))


def serve_phases(torch, merge_kernel, card, bare_q1: dict, span_pipelining=(False,)) -> tuple:
    """``serve`` once for each ``span_pipelining`` setting, the kernel at
    each merge shape the first run launched, and ``serve_vs_plain_path``."""
    runs = [phase_serve(torch, merge_kernel, card, bare_q1, span_pipelining=sp)
            for sp in span_pipelining]
    rows = phase_path_kernel(torch, merge_kernel, card, runs[0]["by_shape"],
                             "serve_kernel_shape", half_full)
    phase_serve_modes(torch, merge_kernel, card)
    return runs[0], rows


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Drive the port on one CUDA card.")
    ap.add_argument("--serve-only", action="store_true",
                    help="the build, the bare q1 cell and the serving phases, "
                         "serve also with span_pipelining on; no kernels line, no ok line")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from materialize_tpu_torch.ops import merge_kernel
    from materialize_tpu_torch.workloads.tpch import q1_config, q15_config

    t0 = time.perf_counter()
    marks = [("start", t0)]

    def mark(name):
        marks.append((name, time.perf_counter()))

    card = phase_card_and_build(torch, merge_kernel)
    if args.serve_only:
        q1 = phase_q1(torch, merge_kernel, card, sf=0.1)
        mark("build+q1")
        serve_phases(torch, merge_kernel, card, q1, span_pipelining=(False, True))
        mark("serve")
        emit({"phase": "done", "wall_s": time.perf_counter() - t0, "card": card,
              "phase_s": {name: t - prev for (_, prev), (name, t) in zip(marks, marks[1:])}})
        return 0
    kern = phase_kernel(torch, merge_kernel, card)
    mark("build+kernel")
    phase_sql_plans(card)
    mark("sql_plans")
    paths, rows_by_path, by_path = {}, {}, {}
    paths["index"] = phase_index(torch, merge_kernel, card)
    phase_modes(torch, merge_kernel, card)
    mark("index")
    paths["q1"] = phase_q1(torch, merge_kernel, card, sf=0.1)
    # Q1's runs hold a few rows (4 groups, one output row a group).
    rows_by_path["q1"] = phase_path_kernel(
        torch, merge_kernel, card, paths["q1"]["by_shape"], "q1_kernel_shape",
        lambda ca, cb, out: (min(ca, 8), min(cb, 8)))
    phase_path_modes(torch, merge_kernel, card, "q1_vs_plain_path", q1_config)
    mark("q1")
    paths["serve"], rows_by_path["serve"] = serve_phases(torch, merge_kernel, card,
                                                         paths["q1"])
    mark("serve+kernel_shape+vs_plain")
    paths["q15"] = phase_q15(torch, merge_kernel, card, sf=0.1)
    rows_by_path["q15"] = phase_path_kernel(torch, merge_kernel, card,
                                            paths["q15"]["by_shape"],
                                            "q15_kernel_shape", half_full)
    phase_path_modes(torch, merge_kernel, card, "q15_vs_plain_path", q15_config)
    mark("q15")
    paths["q9"] = phase_q9(torch, merge_kernel, card, sf=Q9_SF)
    mark("q9")
    rows_by_path["q9"] = phase_path_kernel(torch, merge_kernel, card,
                                           paths["q9"]["by_shape"], "q9_kernel_shape",
                                           half_full)
    mark("q9_kernel_shape")
    phase_path_modes(torch, merge_kernel, card, "q9_vs_plain_path",
                     lambda **kw: q9_presized(churn_ticks=8, **kw), sf=0.002,
                     span_ticks=8)
    mark("q9_vs_plain_path")
    paths["auction"] = phase_auction(
        torch, merge_kernel, card, "auction", state_cap=1 << 13, n_users=512,
        auctions_per_tick=128, bids_per_auction=8, retract_after=4)
    paths["auction_x16"] = phase_auction(
        torch, merge_kernel, card, "auction_x16", state_cap=1 << 17, n_users=8192,
        auctions_per_tick=2048, bids_per_auction=8, retract_after=4)
    # The TopK arrangement and the Distinct state hold up to their
    # tier: time them half full.
    by_path["auction"] = _merged_shapes(paths["auction"], paths["auction_x16"])
    rows_by_path["auction"] = phase_path_kernel(torch, merge_kernel, card,
                                                by_path["auction"],
                                                "auction_kernel_shape", half_full)
    phase_new_path_modes(torch, merge_kernel, card, "auction_vs_plain_path",
                         _small_auction)
    mark("auction")
    paths["pagerank"] = phase_pagerank(
        torch, merge_kernel, card, "pagerank", n_nodes=2000, n_edges=10000,
        per_tick=64, state_cap=1 << 14, ticks_churn=16, profile_ticks=1,
        small_check=True)
    mark("pagerank")
    # 2 churn ticks, not 8: the script's time limit (PERF.md §6).
    paths["pagerank_x32"] = phase_pagerank(
        torch, merge_kernel, card, "pagerank_x32", n_nodes=65536, n_edges=327680,
        per_tick=2048, state_cap=1 << 19, ticks_churn=2, span_churn=2,
        profile_ticks=1)
    mark("pagerank_x32")
    by_path["pagerank"] = _merged_shapes(paths["pagerank"], paths["pagerank_x32"])
    rows_by_path["pagerank"] = phase_path_kernel(torch, merge_kernel, card,
                                                 by_path["pagerank"],
                                                 "pagerank_kernel_shape", half_full)
    phase_new_path_modes(torch, merge_kernel, card, "pagerank_vs_plain_path",
                         _small_pagerank)
    mark("pagerank_kernel_shape+vs_plain")
    paths["q21"] = phase_q21(torch, merge_kernel, card, sf=Q21_SF)
    mark("q21")
    rows_by_path["q21"] = phase_path_kernel(torch, merge_kernel, card,
                                            paths["q21"]["by_shape"], "q21_kernel_shape",
                                            half_full)
    phase_path_modes(torch, merge_kernel, card, "q21_vs_plain_path",
                     lambda **kw: q21_presized(churn_ticks=8, **kw), sf=0.002,
                     span_ticks=8)
    mark("q21_kernel_shape+vs_plain")
    paths["q7"] = phase_q7(torch, merge_kernel, card, sf=Q7_SF)
    mark("q7")
    rows_by_path["q7"] = phase_path_kernel(torch, merge_kernel, card,
                                           paths["q7"]["by_shape"], "q7_kernel_shape",
                                           half_full)
    # One lineitem hydrate tick (4,096 orders hold SF 0.002's 3,000).
    phase_path_modes(torch, merge_kernel, card, "q7_vs_plain_path",
                     lambda **kw: q7_presized(churn_ticks=8, hydrate_orders=4096, **kw),
                     sf=0.002, span_ticks=8)
    mark("q7_kernel_shape+vs_plain")
    paths["auction_window"] = phase_auction(
        torch, merge_kernel, card, "auction_window", state_cap=1 << 13, window=4,
        same_as=paths["auction"], n_users=512, auctions_per_tick=128,
        bids_per_auction=8)
    paths["auction_window_x16"] = phase_auction(
        torch, merge_kernel, card, "auction_window_x16", state_cap=1 << 17, window=4,
        same_as=paths["auction_x16"], n_users=8192, auctions_per_tick=2048,
        bids_per_auction=8)
    by_path["auction_window"] = _merged_shapes(paths["auction_window"],
                                               paths["auction_window_x16"])
    rows_by_path["auction_window"] = phase_path_kernel(
        torch, merge_kernel, card, by_path["auction_window"],
        "auction_window_kernel_shape", half_full)
    mark("auction_window")
    paths["arms_small"] = phase_arms_small(torch, merge_kernel, card)
    mark("arms_small")
    paths["scalars_small"] = phase_scalars_small(torch, merge_kernel, card)
    mark("scalars_small")
    for name, out in paths.items():
        shapes = out.pop("by_shape")
        out.pop("peek", None)
        by_path.setdefault(name, shapes)
    keys = ("cap_a", "cap_b", "out", "L", "a_count", "b_count", "ms", "graph_ms",
            "bound_ms", "bound_share", "plain_ms")
    table = [
        {k: r[k] for k in ("cap_a", "cap_b", "out", "L", "ms", "graph_ms", "bound_ms",
                           "bound_share", "chain_ms", "plain_ms", "pos_ms", "pos_graph_ms",
                           "pos_bound_share", "library_ms", "library_graph_ms")}
        | {"path": "index",
           "launches": by_path.get("index", {}).get((r["cap_a"], r["cap_b"], r["out"],
                                                     r["L"]), 0)}
        for r in kern["rows"]
    ] + [
        {k: r[k] for k in keys}
        | {"path": path, "launches": by_path[path][(r["cap_a"], r["cap_b"], r["out"], r["L"])]}
        for path, rows in rows_by_path.items()
        for r in rows
    ]
    emit({"phase": "kernel_table", "card": card, "rows": table})

    def fold_row(L):
        return next(r for r in kern["rows"]
                    if (r["cap_a"], r["cap_b"], r["out"]) == KERNEL_SHAPE and r["L"] == L)

    big, one = fold_row(4), fold_row(1)
    emit({"kernels": [{
        "name": "merge_path",
        "route": "cuda",
        "source": "materialize_tpu_torch/csrc/merge_path.cu",
        "replaces": "materialize_tpu/ops/merge_pallas.py:157",
        "launches": sum(out["launches"] for out in paths.values()),
        "launches_by_path": {name: out["launches"] for name, out in paths.items()},
        "max_abs_err": max([kern["max_abs_err"]]
                           + [r["max_abs_err"] for rows in rows_by_path.values()
                              for r in rows]),
        "ms": big["ms"],
        "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"],
        "bound_by": "bytes",
        # torch.searchsorted computes the kernel's ``search_right`` (not
        # the merge) at L = 1: timed at the level-2 fold's shape beside
        # the kernel's own ``pos`` there.
        "library_ms": one["library_ms"],
        "library_graph_ms": one["library_graph_ms"],
        "library_vs_ms": one["pos_ms"],
        "library_vs_graph_ms": one["pos_graph_ms"],
        "library_shape": [*KERNEL_SHAPE, 1],
    }]})
    emit({"phase": "done", "wall_s": time.perf_counter() - t0, "card": card,
          "phase_s": {name: t - prev for (_, prev), (name, t) in zip(marks, marks[1:])}})
    print(card, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
