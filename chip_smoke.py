#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``materialize_tpu_torch``) on one NVIDIA
card and check it end to end.

    python3 chip_smoke.py
    python3 chip_smoke.py --serve-only

With ``--serve-only`` it runs phases 1, 5, 7a, 7b and 7c, and stops
after ``kafka``, printing neither the kernels line nor the last line. Phases,
each printing one JSON line (any failure exits non-zero):

1. card and build: the card's name and power limit (``nvidia-smi``),
   then the merge-path kernel built from ``csrc/merge_path.cu`` with
   nvcc for sm_90a (seconds, ptxas report); then ``sql_plans``: TPC-H
   Q21 and Q7 planned from their text by the port's SQL frontend and
   optimizer on this machine (no JAX), Q21's plan equal to
   ``q21_plan()``, node counts and planning ms, and EXPLAIN PHYSICAL
   PLAN of Q7 and Q1 (printed), whose Join and Reduce lines must be the
   plans the render layer builds for the same queries on the card; then
   Q7, Q21 and Q1 planned again with ``optimizer_typecheck`` on (every
   transform's output typechecked, ``analysis/typecheck.py``): no
   transform blamed, each plan equal to the one planned with the flag
   off, each ``analysis.report`` printed (typecheck, monotonicity, LIR
   check), planning ms with the flag off and on;
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
   lookups against it; then the next 32 churn ticks through the
   pipelined executor (``render/span_exec.SpanExecutor``: span K+1
   dispatched before span K's one flags readback), its updates/s beside
   the serial train's; then churn ticks up to the next level-0 fold, the
   last one (the fold's) stepped under ``analysis/step_lint.py``'s
   recorder (a ``step_record`` line, below), and the index against the
   oracle again (by a 128-bit multiset fingerprint);
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
7s. ``sharded``: the SPMD path (``render/dataflow.py:ShardedDataflow``,
    one process per rank, ``parallel/``) on this one card. Two gloo
    ranks share it (NCCL refuses two ranks on one device) and run, in
    one spawn: (a) ``mc_index``, the reference bench's multichip
    configuration (a bare-Get index, ``state_cap`` 2^14, 3 output runs
    and a ring of 8 slots; 96 rows a tick, keys 0-1023, values 0-15,
    diffs from {+1, +1, +1, -1}, seed 42): one warm span, then 4 spans of
    16 ticks, its peek equal to the single-device ``Dataflow`` fed the
    same ticks and to a numpy oracle; (b) TPC-H Q1 at SF 0.1 over the
    ``q1`` phase's stream with 16 churn ticks (the Reduce's exchange by
    group key; the send slot pre-sized to a rank's share of a churn
    tick), equal to the single-device Q1 dataflow over the same stream
    and to the numpy Q1 oracle. Then (c) ``mc_index`` at world size 1
    over NCCL, one span, against the oracle. Printed per rank:
    updates/s, the collectives' host ms per step, the census per step,
    the ingest mode and the rank's merge launches; then the kernel at
    each merge shape the ranks launched (``sharded_kernel_shape``);
7a. ``serve``, run twice: the replica stepping a tick at a time, then
    with ``span_pipelining`` on (the default: ``order_lines``' index
    pipelines, ``_step_span_pipelined``; Q1's view commits each span at
    its boundary). The port's serving stack in this process, the
    replica's dataflows on the card: a replica thread (``coord/replica.py``), a
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
    SELECT and lookup ms p50/p99, flags readbacks a replica step, spans
    committed with the flags readbacks at their boundaries (exactly one
    a span when pipelined) and the most spans in flight (at most one),
    host-to-device copies a tick, persist parts and bytes written, merge
    launches, peak device memory, and the host-sync probe: 8 more ticks
    with ``torch.cuda.set_sync_debug_mode("warn")``, each synchronizing
    call counted by the line that made it, per span. A tick at a time,
    one more source tick before the probe is stepped by each view under
    ``analysis/step_lint.py``'s recorder on the replica's worker thread
    (``step_record`` lines for ``serve.q1`` and ``serve.order_lines``);
    every line the probe counts, in both runs, must be named by a
    recorded step's syncs and uploads or by ``analysis/host_sync.py``'s
    source findings over the hot path. Then the kernel at each merge shape
    the serve path launched (``serve_kernel_shape``), and
    ``serve_vs_plain_path``: the script at SF 0.002 with the replica's
    merges forced to the kernel and then to the plain chain, every
    SELECT equal;
7b. ``deploy``: the port deployed as users deploy it, at ``serve``'s
    width: an ``Environment`` (``server/environmentd.py``) in this
    process with one replica process on the card (``python -m
    materialize_tpu_torch.coord.replica --device cuda``), pgwire and
    HTTP; ``serve``'s source, Q1 view and ``order_lines`` index; one
    ``SUBSCRIBE q1`` over pgwire (a borrowed shard tail) and two
    identical ``SUBSCRIBE TO (SELECT ... FROM order_lines WHERE
    l_orderkey <= 4096)``, over pgwire and SSE, sharing one dataflow on
    the card; 32 churn ticks in spans of 16, then 16 paced ticks. Every
    subscription's snapshot plus updates equals the numpy oracle at
    every frontier it reports; ``/api/sql`` equals pgwire;
    ``mz_wallclock_lag_summary``, ``mz_hydration_statuses``,
    ``mz_subscriptions``, ``mz_cluster_replicas`` and ``mz_compactions``
    answer (background merges, none inline); ``/api/readyz`` is ready;
    the replica's shipped ``mz_merge_path_launches_total`` is above 0;
    ``mz_span_epochs`` (both views past 0) and ``mz_compile_log`` (the
    replica's ``merge_path.cu`` build or load) are read over pgwire and
    printed; the replica process's shipped span census shows one flags
    readback a span and at most one span in flight. A fourth view,
    ``order_flags`` (``ORDER_FLAGS_SQL``: a STRING_AGG of the return
    flags, an ARRAY_AGG of the line numbers and a COUNT by order, ~150,000
    groups over ~600,000 multiset rows per aggregate, its sink finalizing
    each changed group's strings a tick): 64 seeded orders looked up over
    pgwire after hydration and after the paced ticks, and the whole view
    once at the end (over ``/api/sql``), each against an oracle over the
    generator's rows;
    EXPLAIN ANALYSIS of ``SELECT * FROM order_flags``: ``typecheck: ok``,
    a ``donation:`` line with ``wired=false`` and a ``sharding:`` line
    with ``spmd=false workers=1`` for each of the three installed views,
    and the compile block naming ``merge_path.cu``.
    Then shutdown (each replica process alive until then) and a recovery
    on the same directory: the catalog replayed, Q1 equal to the oracle,
    and Q1's subscription resumed at its last frontier exactly. Printed:
    served updates/s, paced tick and SUBSCRIBE delivery lag p50/p99
    (``coord/freshness.lag_ms``), the recorder's lag, the replica's boot
    s, library load s, step ms a tick and peak device bytes (from its
    shipped metrics), recovery s, compactions, the phase's seconds;
7c. ``kafka``: a Debezium CDC feed of TPC-H into the port through a
    Kafka source, Q1 exported through an exactly-once Kafka sink, at SF
    0.05 (``KAFKA_SF``, ~300,000 lineitem rows; ``serve``'s 0.1 did not
    fit the script's time limit). Before
    ``environmentd`` boots, this script writes the generator's lineitem
    stream to a ``FileBroker`` topic ``tpch.lineitem`` of 4 partitions
    (``l_orderkey % 4``) as Debezium JSON: the snapshot after-only, each
    churn tick of 1,024 orders as before-only deletes and after-only
    inserts in one transaction. ``python -m
    materialize_tpu_torch.server.environmentd --device cuda`` runs in a
    process of its own with one replica process on the card; over
    pgwire: ``CREATE SOURCE li (...) FROM KAFKA (... ENVELOPE
    'debezium')``, Q1's text over ``li`` as ``q1``, ``CREATE INDEX
    li_by_order ON li (l_orderkey)`` and ``CREATE SINK q1_sink FROM q1
    INTO KAFKA (... TOPIC 'q1.out', ENVELOPE 'debezium')``. Checked
    after hydration, after the churn and at the end: ``li_progress``
    equal to the topic's end offsets, Q1 over pgwire equal to the numpy
    oracle, 64 ``l_orderkey`` lookups (EXPLAIN ANALYSIS: through the
    index) equal to the oracle's rows, and ``q1.out`` consolidated (+1
    after, -1 before) equal to Q1's rows. 32 churn ticks, the replica
    process SIGKILLed once the source binds churn and respawned on its
    port and rid (as an orchestrator restarts it), then ``mz_recovery``'s
    rebuilds all 0; 16 paced ticks, each timed from its append to its
    Q1 change in ``q1.out``; after 8 of them ``environmentd`` is killed
    with SIGKILL (its replica with it), 4 ticks are appended while it is
    down, and it restarts with ``--recover``: the source resumes at the
    offsets ``li_progress`` bound (the new process fetches exactly the
    records past them, its ``mz_kafka_source_records_total``;
    ``count(*)`` of ``li`` and Q1 exact) and no ``q1.out`` record is
    published twice. Printed: the producer's seconds apart, records
    decoded a second and the host decode seconds (the source's
    ``mz_kafka_source_*`` counters), first DDL to Q1's first exact
    answer, the paced ticks' append to ``q1.out`` p50/p99, the recovery
    seconds, records republished (0), ``merge_path`` launches of the
    three replica processes and their shapes, peak device bytes; then
    the kernel at each merge shape they launched (``kafka_kernel_shape``);
7d. ``chaos``: ``testing/chaos.py``'s storm with its replica process on
    the card (seed 3, 30 ticks, one blob operation in 11 failing,
    connection kills, a partition, a mid-storm DDL and one SIGKILL of
    the replica, respawned on its port): the maintained view and its
    sink shard equal to the oracle, ``rebuilds == 0`` for ``mv_sums``;
    the storm's counts, and the kernel at each merge shape the
    respawned replica launched (``chaos_kernel_shape``);
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
11. TPC-H Q9 at SF 0.1 (``Q9_SF``; SF 1 until Q7 took its time, SF
    0.5 until the serving phases did, SF 0.25 until the sharded phase
    did;
    ``workloads/tpch.py``, the reference bench's Q9 layout: a 6-input
    delta join over ten spines with a ring of 8 append slots each,
    EXTRACT(YEAR), profit summed by (n_name, o_year)): part, supplier,
    partsupp, nation and every order ride the first hydrate tick,
    lineitem hydrates in ticks of 16,384 orders with every tier
    pre-sized (``q9_tiers``; no hydrate span may overflow), no warm
    span, the join tier set back to a churn tick's
    (``set_join_tiers``), then 8 churn ticks as one span (16 until the
    sharded phase, 32 as two until ``kafka`` and ``chaos`` took their
    time) with one flags readback; kernel launches by merge shape (2^19
    rows at L = 6 among them; 2^23 at SF 1), device operations per tick
    from a profiled tick, peak device memory,
    ``peek()`` against a numpy Q9 oracle over every batch fed (175
    groups) and ``peek_errors()`` empty;
12. the kernel at each merge shape the Q9 path launched, against its
    plain chain;
13. Q9 at SF 0.002 in both merge modes (one hydrate tick, a churn span
    of 8): equal peeks, accumulators, join spines with their slots and
    cursors, output runs and err arrangements;
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
    hydrate tick, 4 churn ticks as one span of 4 (8 until the sharded
    phase, 16 before the pipelined checks joined: the script's time
    limit) with one flags readback (the
    LetRec's and the float sums' readbacks counted apart), a profiled
    tick, ``peek()`` one row per node within rel 1e-3 of a numpy
    fixpoint, and ``tests/test_letrec.py``'s five edges at 300
    evaluations within rel 1e-9; ``pagerank_x32`` at 32 times the graph
    (65,536 nodes, 327,680 edges, 2,048 rewired a tick, ``state_cap``
    2^19): 1 hydrate tick, 2 churn ticks (not 8: the script's time
    limit, PERF.md §6), a profiled tick;
17. the kernel at each merge shape the pagerank paths launched, and a
    small pagerank in both merge modes (every state part equal);
18. TPC-H Q21 (``workloads/tpch.py:q21_plan``: EXISTS as a semijoin, NOT
    EXISTS as ``Threshold(Union(cse13, Negate(...)))``) at SF 0.1
    (``Q21_SF``; SF 1 does not fit the time limit, SF 0.5 not beside
    ``deploy``, SF 0.25 not beside ``sharded``) in
    Q9's layout and stream: supplier, nation and every order on the
    first hydrate tick, lineitem in ticks of 16,384 orders with every
    tier pre-sized (``q21_tiers``, join tiers per site), 8 churn ticks
    as one span (16 until the sharded phase, 32 as two before the kafka
    and chaos phases: the script's time limit) with one flags readback;
    kernel launches by merge shape (25-lane merges of the Threshold and
    the cse3 spines among them), device operations per tick from a
    profiled tick, peak device
    memory, the Threshold's state rows, ``peek()`` against a numpy Q21
    oracle over every batch fed and ``peek_errors()`` empty; then the
    kernel at each merge shape Q21 launched, and Q21 at SF 0.002 in both
    merge modes (one hydrate tick, a churn span of 8; every state part
    equal);
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
    against numpy; then a string dictionary rebalance on the card
    through the serving stack: a view over strings, a SELECT whose
    string table runs a squeezed label gap dry (the replica rebalances,
    remaps and rebuilds from persist), a SELECT whose literal does (the
    coordinator rebalances and replans), every answer checked;
21. TPC-H Q7 (``Q7_SQL``, clause 2.4.7 less ORDER BY) planned from its
    text on this machine by the port's frontend and optimizer
    (``workloads/tpch.py:q7_expr``: a 6-input delta join with nation
    twice, the BETWEEN inside the lineitem input, the OR of the nation
    pairs after the join) at SF 0.1 (``Q7_SF``: the script's time
    limit; SF 0.25 until the sharded phase, SF 0.5 until ``kafka`` and
    ``chaos``) in Q9's layout: nation and supplier on the first hydrate
    tick, customer on the second, every order on the third with the
    first of the lineitem ticks of 32,768 orders (``q7_stagger``: on one
    tick, customer would meet every order in one probe), every tier pre-sized
    (``q7_tiers``), 8 churn ticks as one span (16 until the sharded
    phase, 32 as two before the kafka and chaos phases) with one flags
    readback, a profiled tick; launches by merge shape, peak
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

``{"phase": "step_record", "path": ...}`` (``index``, ``serve.q1``,
``serve.order_lines``) gives one recorded step: ``kernel_count`` (device
operations, ``analysis/step_lint.kernel_count``), ``merge_launches`` and
``merge_by_shape``, ``host_callback_sites`` (device->host reads by call
site, sanctioned ones left out), ``sync_sites`` (every read and upload
by call site), ``dyn_shape_ops``, ``h2d_bytes``, the census's largest
entries, every finding and the recorded step's host ms.
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
    dropped, in a canonical order: by column 0, then by a 64-bit hash of
    the row, then lexicographically. Only rows that share column 0 and
    the hash need the full lexicographic sort, so it runs only if two
    different rows do (a 13-column sort of the index's 6M rows took ~20 s
    a check)."""
    if len(diff) == 0:
        return mat, diff
    h = _row_hash(mat)
    order = np.lexsort((h, mat[:, 0]))
    mat, diff, h = mat[order], diff[order], h[order]
    same = (mat[1:] == mat[:-1]).all(axis=1)
    if ((mat[1:, 0] == mat[:-1, 0]) & (h[1:] == h[:-1]) & ~same).any():
        order = np.lexsort(tuple(mat.T[::-1]) + (h, mat[:, 0]))
        mat, diff = mat[order], diff[order]
        same = (mat[1:] == mat[:-1]).all(axis=1)
    starts = np.flatnonzero(np.concatenate(([True], ~same)))
    sums = np.add.reduceat(diff, starts)
    rows = mat[starts]
    keep = sums != 0
    return rows[keep], sums[keep]


# (seed, multiplier) of the fingerprint's two row hashes (murmur3's
# fmix64 multipliers).
_FP_HASHES = ((0x9E3779B97F4A7C15, np.uint64(0xFF51AFD7ED558CCD)),
              (0xC2B2AE3D27D4EB4F, np.uint64(0xC4CEB9FE1A85EC53)))


def _row_hash(mat: np.ndarray, seed: int = _FP_HASHES[0][0],
              mul: np.uint64 = _FP_HASHES[0][1]) -> np.ndarray:
    """A 64-bit hash of each row of ``mat`` ([N, C] int64)."""
    with np.errstate(over="ignore"):
        h = np.full(len(mat), seed, dtype=np.uint64)
        for j in range(mat.shape[1]):
            h ^= mat[:, j].astype(np.uint64)
            h *= mul
            h ^= h >> np.uint64(33)
        h *= mul
        h ^= h >> np.uint64(29)
    return h


def multiset_fingerprint(mat: np.ndarray, diff: np.ndarray) -> tuple:
    """Two 64-bit wrapping sums of a per-row hash times the row's diff:
    equal multisets (rows of ``mat`` with multiplicities ``diff``) give
    equal sums in any row order, and the sums add across batches; two
    unequal ones agree only if both 64-bit sums collide."""
    out = []
    with np.errstate(over="ignore"):
        for seed, mul in _FP_HASHES:
            h = _row_hash(mat, seed, mul)
            out.append(int((h * diff.astype(np.uint64)).sum(dtype=np.uint64)))
    return tuple(out)


def _signed(u: int) -> int:
    return u - (1 << 64) if u >= 1 << 63 else u


def multiset_fingerprint_torch(torch, mat, diff) -> tuple:
    """``multiset_fingerprint`` of the int64 tensors ``mat`` ([N, C]) and
    ``diff`` where they lie (on the card for the index: no 6M-row copy
    to the host), bit for bit: int64 arithmetic wraps as uint64's, and
    the logical shifts are arithmetic ones masked."""
    out = []
    for seed, mul in _FP_HASHES:
        m = _signed(int(mul))
        h = torch.full((mat.shape[0],), _signed(seed), dtype=torch.int64, device=mat.device)
        for j in range(mat.shape[1]):
            h = h ^ mat[:, j]
            h = h * m
            h = h ^ ((h >> 33) & ((1 << 31) - 1))
        h = h * m
        h = h ^ ((h >> 29) & ((1 << 35) - 1))
        out.append(int((h * diff).sum().item()) % (1 << 64))
    return tuple(out)


def fingerprint_add(a: tuple, b: tuple) -> tuple:
    return tuple((x + y) % (1 << 64) for x, y in zip(a, b))


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
    del base, b_cols

    # -- main path: the next 32 churn ticks through the pipelined executor ----
    # (render/span_exec.py, as the reference bench drives its span
    # configurations): span K+1 is dispatched before span K's one flags
    # readback; the peek after it is held to the oracle again.
    from materialize_tpu_torch.render.span_exec import SpanExecutor

    p_inputs, p_rows = [], []
    for i in range(ticks_churn):
        inp, n = churn(ticks_churn + i, df.time + i)
        p_inputs.append(inp)
        p_rows.append(n)
    ex = SpanExecutor(df)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for span in _spans(p_inputs, span_churn):
        ex.submit(span)
    ex.sync()
    torch.cuda.synchronize()
    pipelined_s = time.perf_counter() - t
    ex.close()
    pst = ex.stats()
    check(pst["readbacks_per_span"] == 1.0 and pst["max_inflight"] <= 1
          and pst["overflows"] == 0 and pst["spans_committed"] == ticks_churn // span_churn,
          f"pipelined index spans: {pst}")
    # Churn ticks up to the next level-0 fold, the last one stepped under
    # analysis/step_lint's recorder (its merges are the fold's); their
    # launches are the path's, and the oracle below covers them. The
    # recorder's first use imports torch's dispatch-mode machinery: timed
    # apart, on an empty call.
    from materialize_tpu_torch.analysis.step_lint import record_call, record_step

    t = time.perf_counter()
    record_call(lambda: torch.zeros(1, device=df.device) + 1)
    setup_ms = (time.perf_counter() - t) * 1e3
    while True:
        r_inp, _r_rows = churn(ticks_churn + len(p_inputs), df.time)
        p_inputs.append(r_inp)
        if (df._compact_tick + 1) % ce == 0:
            break
        df.step(r_inp)
    torch.cuda.synchronize()
    t = time.perf_counter()
    _out, rec = record_step(df, r_inp)
    torch.cuda.synchronize()
    record = step_record_line("index", rec, (time.perf_counter() - t) * 1e3, card)
    record["recorder_setup_ms"] = setup_ms
    check(rec.merge_launches > 0, "the recorded index step ran no fold")
    # Held to the oracle by multiset fingerprint (a second sort of the
    # 6M rows would take the script ~30 s): the oracle's is the last
    # check's consolidated rows plus every pipelined batch's.
    p_cols = [inp["lineitem"].to_columns() for inp in p_inputs]
    want_fp = fingerprint_add(
        multiset_fingerprint_torch(torch, torch.from_numpy(o_rows).to(df.device),
                                   torch.from_numpy(o_sums).to(df.device)),
        multiset_fingerprint(np.concatenate([host_matrix(c[:13]) for c in p_cols]),
                             np.concatenate([c[14] for c in p_cols])))
    base = df.output_batch()
    n_base = int(base.count)
    got_fp = multiset_fingerprint_torch(
        torch, torch.stack([c[:n_base].to(torch.int64) for c in base.cols[:13]], dim=1),
        base.diff[:n_base])
    check(got_fp == want_fp, "maintained index != oracle after the pipelined churn")
    torch.cuda.synchronize()
    launches = merge_kernel.LAUNCHES
    by_shape = dict(merge_kernel.LAUNCHES_BY_SHAPE)

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
        "pipelined_churn_updates": int(sum(p_rows)),
        "pipelined_churn_updates_per_s": sum(p_rows) / pipelined_s,
        "pipelined_tick_ms": pipelined_s * 1e3 / ticks_churn,
        "pipelined_spans": pst,
        "span_ms": span_ms, "tick_ms_p50": float(np.percentile(tick_ms, 50)),
        "tick_ms_p99": float(np.percentile(tick_ms, 99)),
        "readbacks_per_span": span_reads,
        "peek_scan_ms": scan_ms, "peek_lookup64_ms": lookup_ms,
        "peek_point64_ms": point_ms, "scan_rows": int(len(s_diff)),
        "max_memory_allocated": int(torch.cuda.max_memory_allocated()),
        "ladder": ladder, "slots": slots, "ladder_after": [b.capacity for b in df.output.runs_b],
        "launches": launches, "folds": folds, "oracle_s": oracle_s,
        "launches_by_shape": {",".join(map(str, k)): v for k, v in sorted(by_shape.items())},
        "step_record": {k: record[k] for k in ("kernel_count", "merge_launches",
                                               "merge_by_shape", "recorded_step_ms",
                                               "recorder_setup_ms")},
    }
    emit(out)
    out["by_shape"] = by_shape
    del df, h_inputs, c_inputs, p_inputs, fed, base, ex
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


def q1_oracle(qty, ext, disc, tax, flag, status, ship, diff, cutoff: int,
              nonzero: bool = True) -> dict:
    """TPC-H Q1 in numpy int64, independent of the port: {(returnflag,
    linestatus): (sum_qty, sum_base_price, sum_disc_price, sum_charge,
    count)} over the live rows (groups whose count nets to 0 vanish,
    unless ``nonzero`` is False: a delta's sums then add up)."""
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
            for k, row in zip(uniq, sums) if row[4] != 0 or not nonzero}


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


# -- the SPMD path ----------------------------------------------------------------

SHARDED_WORKERS = 2
SHARDED_Q1_SF = 0.1
SHARDED_Q1_CHURN = 16
SHARDED_SPAWN_S = 600.0


def _merge_rank_shapes(*runs) -> dict:
    """Launches by merge shape, summed over ranks' ``by_shape`` lists."""
    out: dict = {}
    for run in runs:
        for shape, n in run["by_shape"]:
            out[tuple(shape)] = out.get(tuple(shape), 0) + n
    return out


def phase_sharded(torch, merge_kernel, card) -> dict:
    """The SPMD path on the one card: ``mc_index`` and TPC-H Q1 over 2
    gloo ranks sharing the card, then ``mc_index`` at world size 1 over
    NCCL. Each rank is a process of its own (``parallel.multihost.
    spawn_workers``); a rank that fails or hangs fails the phase."""
    from materialize_tpu_torch.parallel.multihost import spawn_workers
    from materialize_tpu_torch.render.dataflow import Dataflow
    from materialize_tpu_torch.repr.schema import GLOBAL_DICT
    from materialize_tpu_torch.workloads import multichip as mc
    from materialize_tpu_torch.workloads.tpch import Q1_CUTOFF, q1_config

    t0 = time.perf_counter()
    parts = (("mc_index", {"spans": 4, "ticks": 16}),
             ("q1", {"sf": SHARDED_Q1_SF, "churn_ticks": SHARDED_Q1_CHURN}))
    ranks = spawn_workers(mc.sharded_rank, SHARDED_WORKERS, device="cuda", backend="gloo",
                          args=(parts,), timeout=SHARDED_SPAWN_S)
    gloo_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    (nccl,) = spawn_workers(mc.sharded_rank, 1, device="cuda", backend="nccl",
                            args=((("mc_index", {"spans": 1, "ticks": 16, "warm": False}),),),
                            timeout=SHARDED_SPAWN_S)
    nccl_s = time.perf_counter() - t1
    for r in ranks[1:]:
        check(r["mc_index"]["peek"] == ranks[0]["mc_index"]["peek"]
              and r["q1"]["peek"] == ranks[0]["q1"]["peek"], "sharded ranks read apart")
    # (a) mc_index: the single-device port dataflow fed the same ticks,
    # and a numpy oracle.
    mi = ranks[0]["mc_index"]
    host = mc.mc_index_ticks(mi["ticks"])
    single = Dataflow(mc.mc_index_expr(), device="cuda", **mc.MC_LAYOUT)
    for span in mc._spans_of(mc.mc_index_inputs(host, single.device), 16):
        single.run_steps(span)
    want: dict = {}
    for k, v, d in host:
        for row, dd in zip(zip(k.tolist(), v.tolist()), d.tolist()):
            want[row] = want.get(row, 0) + dd
    want = {r: d for r, d in want.items() if d}
    got = mc.net_rows(mi["peek"])
    check(got == mc.net_rows(single.peek()), "sharded mc_index != single-device Dataflow")
    check(got == want, "sharded mc_index != numpy oracle")
    n1 = nccl["mc_index"]
    n_host = mc.mc_index_ticks(n1["ticks"])
    n_want: dict = {}
    for k, v, d in n_host:
        for row, dd in zip(zip(k.tolist(), v.tolist()), d.tolist()):
            n_want[row] = n_want.get(row, 0) + dd
    check(mc.net_rows(n1["peek"]) == {r: d for r, d in n_want.items() if d},
          "NCCL mc_index != numpy oracle")
    check(n1["backend"] == "nccl" and n1["workers"] == 1, "the NCCL run did not run over NCCL")
    # (b) Q1: the single-device Q1 dataflow over the same stream, and the
    # numpy Q1 oracle.
    q = ranks[0]["q1"]
    df, hydrate, churn = q1_config(sf=SHARDED_Q1_SF, n_orders_per_tick=1024, seed=42,
                                   device="cuda")
    h_inputs = hydrate()
    c_inputs = [churn(i, len(h_inputs) + i)[0] for i in range(SHARDED_Q1_CHURN)]
    for span in mc._spans_of(h_inputs + c_inputs, 32):
        df.run_steps(span)
    fed = [inp["lineitem"] for inp in h_inputs + c_inputs]
    # The ranks code strings in dictionaries of their own: keys compare
    # as text.
    gd = GLOBAL_DICT.snapshot()
    q_want = {(gd.decode(f), gd.decode(s)): v for (f, s), v in
              q1_oracle(*_host_cols(torch, fed, Q1_COLS), cutoff=Q1_CUTOFF).items()}
    q_got = {(r[0], r[1]): tuple(r[2:7]) for r in q["peek"]}
    q_single = {(r[0], r[1]): tuple(r[2:7])
                for r in mc.decoded_rows(df.peek(), df.out_schema)}
    check(len(q_got) == len(q["peek"]), "sharded Q1 peek rows not unique")
    check(q_got == q_single, f"sharded Q1 != single-device Q1: {q_got} vs {q_single}")
    check(q_got == q_want, f"sharded Q1 != numpy oracle: {q_got} vs {q_want}")
    check(q["errors"] == [], f"sharded Q1 err collection not empty: {q['errors']}")
    check(q["report"]["census"]["kinds"].get("all_to_all", 0) > 0,
          "sharded Q1 issued no exchange")
    del df, h_inputs, c_inputs, fed, single
    torch.cuda.empty_cache()
    runs = [r[name] for r in ranks for name in ("mc_index", "q1")] + [n1]
    by_shape = _merge_rank_shapes(*runs)
    launches = sum(r["launches"] for r in runs)
    check(launches > 0, "the sharded path launched no merge-path kernel")
    check(sum(by_shape.values()) == launches, "sharded launches by shape do not add up")

    def cell(r, keys):
        return {k: r[k] for k in keys} | {"ingest_mode": r["report"]["ingest_mode"],
                                           "census_per_step": r["report"]["census"],
                                           "launches": r["launches"]}

    out = {
        "phase": "sharded", "card": card,
        "mc_index": [cell(r["mc_index"], ("rank", "workers", "backend", "updates",
                                          "updates_per_s", "collective_ms_per_step",
                                          "collectives_per_step", "span_ms", "grown"))
                     for r in ranks],
        "q1": [cell(r["q1"], ("rank", "workers", "backend", "sf", "hydrate_ticks",
                              "churn_ticks", "churn_updates", "churn_updates_per_s",
                              "collective_ms_per_churn_step", "slot_cap", "run_s",
                              "span_ms", "grown"))
               for r in ranks],
        "q1_groups": len(q_got),
        "mc_index_nccl": cell(n1, ("rank", "workers", "backend", "updates", "updates_per_s",
                                   "collective_ms_per_step", "collectives_per_step",
                                   "span_ms")),
        "gloo_spawn_s": gloo_s, "nccl_spawn_s": nccl_s,
        "launches": launches,
        "launches_by_shape": {",".join(map(str, k)): v for k, v in sorted(by_shape.items())},
        "phase_s": time.perf_counter() - t0,
    }
    emit(out)
    out["by_shape"] = by_shape
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


# Q9's scale: SF 0.1 makes room for the sharded phase (SF 0.25 made
# room for the serving phases). At SF 1 its phase took 420.5 s of the
# script's 939.1 s, at SF 0.5 250.9 s of 1,085.1 s with the serving
# phases in, at SF 0.25 108.7-163.2 s (an NVIDIA H100 80GB HBM3 at
# 700 W, PERF.md §4).
Q9_SF = 0.1


def phase_q9(torch, merge_kernel, card, sf: float = 1.0) -> dict:
    from materialize_tpu_torch.workloads.index import rows_per_tick
    from materialize_tpu_torch.workloads.tpch import set_join_tiers

    # 8 churn ticks, one span, and one profiled tick: the script's time
    # limit (PERF.md §4).
    hydrate_orders, ticks_churn, span_churn, profile_ticks = 16384, 8, 8, 1
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
    # 2^22 at SF 0.5, 2^21 at SF 0.25, 2^19 at SF 0.1
    wide_rows = 1 << int(math.log2((1 << 23) * sf))
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
# of its 1,200 s limit; at SF 0.5, with the deploy phase in, the script
# took 1,051.1 s; at SF 0.25, with the sharded phase in, 1,188.8 s on a
# slow host (its phase 127.0 s), so SF 0.1 (an NVIDIA H100 80GB HBM3 at
# 700 W, PERF.md §4).
Q21_SF = 0.1


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

    # 8 churn ticks, one span, and one profiled tick: the script's time
    # limit (PERF.md §4).
    hydrate_orders, ticks_churn, span_churn, profile_ticks = 16384, 8, 8, 1
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
# 247.1 s; SF 0.5 until the kafka and chaos phases took their time (the
# script 1,011.0 s before them); SF 0.25 until the sharded phase (the
# script 1,272.0 s on a slow host, its Q7 phase 89.1 s; an NVIDIA H100
# 80GB HBM3 at 700 W, PERF.md §4).
Q7_SF = 0.1
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
    set to a churn tick's and 8 churn ticks run as one span, one flags
    readback, and one more is profiled."""
    from materialize_tpu_torch.repr.schema import GLOBAL_DICT
    from materialize_tpu_torch.workloads.index import rows_per_tick
    from materialize_tpu_torch.workloads.tpch import Q7_HI, Q7_LO, set_join_tiers

    # 8 churn ticks, one span, and one profiled tick: the script's time
    # limit (PERF.md §4).
    hydrate_orders, ticks_churn, span_churn, profile_ticks = Q7_HYDRATE_ORDERS, 8, 8, 1
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
    for name, sql in (("q7", Q7_SQL), ("q1", SERVE_Q1_SQL)):
        out[f"{name}_explain_physical"] = _explain_vs_render(sql, tpch_catalog(), name)
    out.update(_typechecked_plans({"q7": Q7_SQL, "q21": Q21_SQL, "q1": SERVE_Q1_SQL}))
    emit(out)
    return out


def _typechecked_plans(queries: dict) -> dict:
    """Each query planned again with ``optimizer_typecheck`` on (every
    transform's output typechecked, the final plan's LIR decisions
    checked): no transform may be blamed, and the plan must equal the
    one planned with the flag off. Returns planning ms, best of 3, both
    ways, and the static EXPLAIN ANALYSIS report of each."""
    from materialize_tpu_torch.analysis import report
    from materialize_tpu_torch.sql.plan import plan_statement
    from materialize_tpu_torch.transform.optimizer import optimize
    from materialize_tpu_torch.utils.dyncfg import COMPUTE_CONFIGS
    from materialize_tpu_torch.workloads.tpch import tpch_catalog

    out = {}
    for name, sql in queries.items():
        plans, ms = {}, {}
        for flag in (False, True):
            COMPUTE_CONFIGS.update({"optimizer_typecheck": flag})
            try:
                times = []
                for _ in range(3):
                    t = time.perf_counter()
                    plans[flag] = optimize(plan_statement(sql, tpch_catalog()).expr)
                    times.append((time.perf_counter() - t) * 1e3)
            finally:
                COMPUTE_CONFIGS.update({"optimizer_typecheck": None})
            ms[flag] = min(times)
        check(plans[True] == plans[False],
              f"{name}: the plan with optimizer_typecheck on differs from the plan without")
        text = report(plans[True])
        check(text.startswith("typecheck: ok") and text.endswith("lir: ok"),
              f"{name}: EXPLAIN ANALYSIS report {text!r}")
        out[f"{name}_plan_ms_typecheck_off"] = ms[False]
        out[f"{name}_plan_ms_typecheck_on"] = ms[True]
        out[f"{name}_analysis"] = text.splitlines()
    return out


def _explain_vs_render(sql: str, catalog, name: str, device: str = "cuda") -> list:
    """EXPLAIN PHYSICAL PLAN of ``sql`` (``plan/lowering.py``'s LIR),
    checked against the plans the render layer built for the same
    optimized query on the card: every Join and Reduce the dataflow
    rendered (``_RenderContext.lir``, read from its operators) is one
    line of the EXPLAIN text, and no other Join or Reduce is."""
    from materialize_tpu_torch.render.dataflow import Dataflow
    from materialize_tpu_torch.sql.plan import plan_statement
    from materialize_tpu_torch.transform.optimizer import optimize

    text = plan_statement("EXPLAIN PHYSICAL PLAN FOR " + sql, catalog).text
    lines = text.splitlines()
    explained = sorted(
        ln.split(" ", 1)[1] for ln in (x.strip() for x in lines)
        if ln.split(" ")[1] in ("Join", "Reduce"))
    df = Dataflow(optimize(plan_statement(sql, catalog).expr), device=device)
    rendered = sorted(f"{op} {detail}" for op, detail in df._ctx.lir)
    check(rendered and explained == rendered,
          f"{name}: EXPLAIN PHYSICAL PLAN {explained} != rendered {rendered}")
    return lines


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
    rebalance = _dict_rebalance_on_card(torch, merge_kernel)
    launches += rebalance["launches"]
    for k, v in rebalance.pop("by_shape").items():
        by_shape[k] = by_shape.get(k, 0) + v
    out = {"phase": "arms_small", "card": card, "ticks": len(ticks), "rows": len(got),
           "grown_keys": [str(k) for k in df._grown], "join_tiers": list(df._ctx.join_caps),
           "dict_rebalance": rebalance,
           "launches": launches,
           "launches_by_shape": {",".join(map(str, k)): v for k, v in sorted(by_shape.items())}}
    emit(out)
    out["by_shape"] = by_shape
    return out


def _squeeze_gap(d, lo: str, hi: str) -> None:
    """Give two new strings adjacent labels, so any string that sorts
    between them runs the label gap dry (``tests/test_dict_rebalance.py``'s
    recipe)."""
    ca, cb = d.encode(lo), d.encode(hi)
    with d.lock():
        del d._by_code[cb]
        d._codes[hi] = ca + 1
        d._by_code[ca + 1] = hi
        d.version += 1


def _dict_rebalance_on_card(torch, merge_kernel) -> dict:
    """A string dictionary rebalance on the card, through the serving
    stack (a replica thread whose dataflows live on the card): a
    materialized view over strings; a SELECT whose string table runs a
    squeezed label gap dry, so the replica rebalances the dictionary,
    remaps every installed plan (``expr/remap.py``) and rebuilds its
    dataflows from the durable shards; then a SELECT whose literal lands
    in a squeezed gap, so the coordinator rebalances and replans. Every
    answer against the strings themselves, and the view still
    maintains."""
    import tempfile

    from materialize_tpu_torch.repr.schema import GLOBAL_DICT

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    start = merge_kernel.LAUNCHES
    shapes0 = dict(merge_kernel.LAUNCHES_BY_SHAPE)
    epoch0 = GLOBAL_DICT.epoch
    with tempfile.TemporaryDirectory() as root:
        st = ServeStack(root)
        try:
            c = st.coord

            def rows(sql):
                return sorted(c.execute(sql).rows)

            c.execute("CREATE TABLE rb (s text NOT NULL)")
            c.execute("INSERT INTO rb VALUES ('rbza'), ('rbzc')")
            c.execute("CREATE MATERIALIZED VIEW rbv AS SELECT s FROM rb WHERE s <> 'rbzx'")
            check(rows("SELECT s FROM rbv") == [("rbza",), ("rbzc",)], "rebalance: rbv")
            _squeeze_gap(GLOBAL_DICT, "RBZ", "RBZB")  # upper('rbza') sorts between
            check(rows("SELECT upper(s) FROM rb") == [("RBZA",), ("RBZC",)],
                  "rebalance: upper(s) after the replica's rebalance")
            replica_epoch = GLOBAL_DICT.epoch
            check(replica_epoch > epoch0, "rebalance: the replica did not rebalance")
            check(rows("SELECT s FROM rbv") == [("rbza",), ("rbzc",)],
                  "rebalance: rbv after the rebuild")
            c.execute("INSERT INTO rb VALUES ('rbzb')")
            want = [("rbza",), ("rbzb",), ("rbzc",)]
            check(rows("SELECT s FROM rbv") == want, "rebalance: rbv after an insert")
            _squeeze_gap(GLOBAL_DICT, "rbzq", "rbzr")  # the literal 'rbzqa' sorts between
            check(rows("SELECT s FROM rbv WHERE s < 'rbzqa'") == want,
                  "rebalance: the coordinator's replan")
            check(GLOBAL_DICT.epoch > replica_epoch, "rebalance: the coordinator did not")
            rebuilds = {n: r.get("rebuilds", 0) for n, r in st.worker._recovery.items()}
            check(rebuilds.get("rbv", 0) >= 1, f"rebalance: rbv was not rebuilt {rebuilds}")
        finally:
            st.close()
    torch.cuda.synchronize()
    launches = merge_kernel.LAUNCHES - start
    check(launches > 0, "the rebalance run launched no merge-path kernel")
    by_shape = {k: v - shapes0.get(k, 0) for k, v in merge_kernel.LAUNCHES_BY_SHAPE.items()
                if v - shapes0.get(k, 0)}
    return {"epochs": GLOBAL_DICT.epoch - epoch0, "rebuilds": rebuilds, "launches": launches,
            "by_shape": by_shape, "s": time.perf_counter() - t0}


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
    the kernel or the plain chain (None: the device rule); ``device`` is
    where the replica's dataflows live (the CPU for a rehearsal)."""

    def __init__(self, root: str, mode=None, device: str = "cuda"):
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
            kwargs={"handle": self._handle, "device": device}, daemon=True)
        self._thread.start()
        check(ready.wait(60), "replica did not start")
        self.coord = Coordinator(
            PersistClient(FileBlob(self.loc.blob_root),
                          SqliteConsensus(self.loc.consensus_path)),
            tick_interval=None, device=device)
        self.coord.add_replica("r0", ("127.0.0.1", port))
        self.pg = PgServer(self.coord).start()
        self.client = PgClient(self.pg.port)

    @property
    def worker(self):
        return self._handle[0]

    def view(self, name: str):
        return self.worker.dataflows[name].view

    def blob_files(self) -> tuple:
        # Compaction and the span commits delete parts while this walks:
        # a part gone before its size is read is not counted.
        n = size = 0
        for d, _dirs, files in os.walk(self.loc.blob_root):
            for f in files:
                try:
                    size += os.path.getsize(os.path.join(d, f))
                except FileNotFoundError:
                    continue
                n += 1
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


def _q1_sums(parts) -> dict:
    """Q1's additive sums over ``parts`` by (returnflag, linestatus)
    code: ``q1_oracle``'s five and the discount's (for avg_disc), groups
    of count 0 kept, so the sums of two parts add up."""
    from materialize_tpu_torch.workloads.tpch import Q1_CUTOFF

    cols = _cols_of(parts, Q1_COLS)
    sums = q1_oracle(*cols, cutoff=Q1_CUTOFF, nonzero=False)
    _qty, _ext, disc, _tax, flag, status, ship, diff = cols
    keep = ship <= Q1_CUTOFF
    keys, inv = np.unique(np.stack([flag[keep], status[keep]], 1), axis=0, return_inverse=True)
    d = np.zeros(len(keys), np.int64)
    np.add.at(d, inv.reshape(-1), disc[keep] * diff[keep])
    disc_sum = {(int(f), int(s)): int(v) for (f, s), v in zip(keys, d)}
    return {k: v + (disc_sum[k],) for k, v in sums.items()}


def _q1_add(a: dict, b: dict) -> dict:
    out = dict(a)
    for k, v in b.items():
        out[k] = tuple(x + y for x, y in zip(out.get(k, (0,) * len(v)), v))
    return out


def _check_q1_wire(rows, parts, what: str, sums=None) -> None:
    """Q1's rows off the wire against ``q1_oracle`` over ``parts`` (or
    over ``sums``, ``_q1_sums``' of them): the sums and the count
    exactly, and each of the three averages exactly as the engine
    divides decimals: the scale-2 sum over the count, rounded down to
    scale 2."""
    from decimal import Decimal

    from materialize_tpu_torch.repr.schema import GLOBAL_DICT

    sums = _q1_sums(parts) if sums is None else sums
    want = {(GLOBAL_DICT.decode(f), GLOBAL_DICT.decode(s)):
            v[:5] + tuple(t // v[4] for t in (v[0], v[1], v[5]))
            for (f, s), v in sums.items() if v[4] != 0}
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


# Source ticks of the serving script's host-sync probe (after the paced
# ticks, before the lookups; the oracles cover them).
SYNC_PROBE_TICKS = 8


def _serve_script(st, sf: float, churn: int, ticks: int, span: int, n_lookups: int,
                  q1_selects: int, paced: int = 8, span_pipelining: bool = False,
                  probe_ticks: int = SYNC_PROBE_TICKS, record: bool = False) -> dict:
    """The serving script on one stack: ``span_pipelining`` set over the
    wire (on, the replica steps every ready tick of a view as one span
    with one flags readback; off, a tick at a time), the DDL, ``ticks`` churn ticks
    of the source in spans of ``span`` with ``SELECT * FROM q1`` after
    each (checked against the oracle afterwards, off the clock), then
    ``paced`` ticks each waited for until both views have stepped past
    it (the source's persist write, then the replica's read, step and
    sink append), point lookups on ``order_lines`` over the wire and
    straight through the coordinator, checked against the oracle, more
    Q1 SELECTs for their latency, then the table path. With ``record``
    (a tick at a time only), one more source tick is stepped by each view
    under ``analysis/step_lint.py``'s recorder, before the sync probe."""
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
    gen, snap, churn_parts = _serve_oracle_parts(sf, churn,
                                                 ticks + paced + probe_ticks + int(record))
    oracle_gen_s = time.perf_counter() - t_o
    rows_written = sum(len(p[1]) for p in churn_parts[:ticks])
    src = st.coord.sources["tpch"]
    q1_view, ol_view = st.view("q1"), st.view("order_lines_idx")
    rb0 = {"q1": q1_view.df._readbacks, "order_lines": ol_view.df._readbacks}
    up0 = {"q1": q1_view.upper, "order_lines": ol_view.upper}
    for k in operators.H2D:
        operators.H2D[k] = 0
    for k in operators.SPANS:
        operators.SPANS[k] = 0
    epochs0 = {"q1": q1_view.span_epoch, "order_lines": ol_view.span_epoch}
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
    spans = dict(operators.SPANS)
    spans["by_view"] = {"q1": q1_view.span_epoch - epochs0["q1"],
                        "order_lines": ol_view.span_epoch - epochs0["order_lines"]}
    if span_pipelining:
        check(spans["committed"] > 0 and spans["boundary_readbacks"] == spans["committed"],
              f"serve: flags readbacks at span boundaries {spans}")
        check(spans["max_inflight"] == 1, f"serve: spans in flight {spans}")
    records = (_record_view_ticks(src, {"q1": q1_view, "order_lines": ol_view})
               if record else None)
    syncs = (_host_sync_probe(src, {"q1": q1_view, "order_lines": ol_view}, probe_ticks)
             if probe_ticks else None)
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
        # Spans committed over the churn and paced ticks, the flags
        # readbacks at their boundaries, and the most spans a view held
        # in flight (0 when the replica steps a tick at a time).
        "spans_committed": spans["committed"], "spans_by_view": spans["by_view"],
        "flags_readbacks_per_span": (spans["boundary_readbacks"] / spans["committed"]
                                     if spans["committed"] else None),
        "max_spans_in_flight": spans["max_inflight"],
        "host_sync_probe": syncs,
        "step_records": records,
        "h2d_batches_per_tick": h2d["batches"] / ticks,
        "h2d_copies_per_tick": h2d["copies"] / ticks,
        "h2d_bytes_per_tick": h2d["bytes"] / ticks,
        "persist_parts_written_churn": files1 - files0,
        "persist_bytes_written_churn": bytes1 - bytes0,
        "table_ms": table_ms,
        "selects": [sorted(r) for r in [first_q1, *span_selects]] + table_selects,
    }


def _record_view_ticks(src, views: dict) -> dict:
    """One source tick, each view's dataflow step of it recorded by
    ``analysis/step_lint.record_step`` on the replica's worker thread
    (the recorder is a dispatch mode of the thread that steps): the
    view's ``df.step`` is swapped for one call that records. Returns
    (record, recorded step's host ms) by view name."""
    from materialize_tpu_torch.analysis import step_lint

    records = {}

    def record_once(name, df):
        def step(inputs):
            del df.step  # one call: the recorder steps the class's method
            t = time.perf_counter()
            out, rec = step_lint.record_step(df, inputs)
            records[name] = (rec, (time.perf_counter() - t) * 1e3)
            return out

        df.step = step

    for name, v in views.items():
        record_once(name, v.df)
    target = src.t + 1
    src.tick_once()
    t_w = time.perf_counter()
    while min(v.upper for v in views.values()) < target:
        check(time.perf_counter() - t_w < 60, "recorded tick: a view did not step")
        time.sleep(0.0002)
    check(set(records) == set(views), f"recorded views {sorted(records)}")
    return records


def step_record_line(path: str, rec, ms: float, card: str) -> dict:
    """The printed summary of one recorded step (``analysis/step_lint``):
    device operations, the kernel's launches by shape, host reads by call
    site, data-dependent shapes, host-to-device bytes; every finding;
    the recorded step's host ms (the recorder's cost included)."""
    from materialize_tpu_torch.analysis import step_lint

    findings = step_lint.lint_record(rec)
    line = {"phase": "step_record", "path": path, "card": card, "recorded_step_ms": ms,
            **step_lint.summary(rec, findings),
            "sync_sites": dict(sorted(rec.sync_sites().items())),
            "census_top": dict(sorted(step_lint.op_census(rec).items(),
                                      key=lambda kv: -kv[1])[:12]),
            "finding_list": [str(f) for f in findings]}
    emit(line)
    return line


def _probe_site(filename: str, lineno: int, stack) -> str:
    """A synchronizing call's site as ``path:line`` relative to the repo.
    A warning raised in torch's own Python code is attributed to its
    innermost caller in the port, as ``analysis/step_lint.py`` attributes
    a recorded operation."""
    root = os.path.dirname(os.path.abspath(__file__))
    pkg = os.path.join(root, "materialize_tpu_torch") + os.sep
    if not os.path.abspath(filename).startswith(pkg):
        for fr in reversed(stack):
            if os.path.abspath(fr.filename).startswith(pkg):
                filename, lineno = fr.filename, fr.lineno
                break
    return f"{os.path.relpath(filename, root)}:{lineno}"


def _host_sync_probe(src, views: dict, ticks: int) -> dict:
    """Hidden host syncs of the replica's eager train: ``ticks`` source
    ticks, each waited for until every view stepped past it, with
    ``torch.cuda.set_sync_debug_mode("warn")`` on (outside any timed
    window). Every synchronizing CUDA call warns; the warnings are
    counted by the line that made them (a line of torch's own code by
    its caller in the port, ``_probe_site``), and divided by the spans
    the views committed (by the ticks, with no spans). A warning raised
    inside the probe's own mode switch is counted apart
    (``probe_own``)."""
    import traceback
    import warnings
    from collections import Counter

    import torch

    from materialize_tpu_torch.storage.persist import operators

    for k in operators.SPANS:
        operators.SPANS[k] = 0
    torch.cuda.synchronize()
    caught, raw, own = [], Counter(), Counter()

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        stack = traceback.extract_stack()
        if any(fr.name == "set_sync_debug_mode" for fr in stack):
            # Raised inside the probe's own switch of the debug mode,
            # on this thread: not the replica's train.
            own[f"{os.path.basename(filename)}:{lineno}"] += 1
            return
        site = _probe_site(filename, lineno, stack)
        caught.append(site)
        raw[(os.path.basename(filename), lineno, site)] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _i in range(ticks):
                target = src.t + 1
                src.tick_once()
                t_w = time.perf_counter()
                while min(v.upper for v in views.values()) < target:
                    check(time.perf_counter() - t_w < 60, "sync probe: a tick was not stepped")
                    time.sleep(0.0002)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = Counter(caught)
    spans = operators.SPANS["committed"]
    n = sum(syncs.values())
    return {"ticks": ticks, "spans": spans, "host_syncs": n,
            "host_syncs_per_span": n / spans if spans else None,
            "host_syncs_per_tick": n / ticks,
            "sites": dict(syncs.most_common()),
            # Warnings raised in torch's code, by (file, line) and the
            # port's line they are counted at.
            "attributed": [[f, ln, site, c] for (f, ln, site), c in raw.items()
                           if not site.endswith(f"{f}:{ln}")],
            "probe_own": dict(own)}


def phase_serve(torch, merge_kernel, card, bare_q1: dict, span_pipelining: bool = False,
                named_sites=()) -> dict:
    """TPC-H Q1 and point lookups served over pgwire by the port's own
    stack, the replica's dataflows on the card (module docstring). A tick
    at a time, one tick of each view is recorded (``step_record`` lines).
    Every call site the sync probe counts must be named by a recorded
    step (this run's, or ``named_sites`` of an earlier run) or by the
    host-sync linter's source findings."""
    import tempfile

    from materialize_tpu_torch.analysis.host_sync import lint_hot_path

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
                                span_pipelining=span_pipelining,
                                record=not span_pipelining)
            files, size = st.blob_files()
        finally:
            st.close()
    torch.cuda.synchronize()
    launches = merge_kernel.LAUNCHES
    by_shape = dict(merge_kernel.LAUNCHES_BY_SHAPE)
    check(launches > 0, "the serve path launched no merge-path kernel")
    out.pop("selects")
    # -- the lints name every sync the card counts ----------------------------
    by_record = set(named_sites)
    for name, (rec, ms) in (out.pop("step_records") or {}).items():
        line = step_record_line(f"serve.{name}", rec, ms, card)
        out.setdefault("step_record_kernel_count", {})[name] = line["kernel_count"]
        by_record |= set(rec.sync_sites())
    by_source = {f.site for f in lint_hot_path()}
    probe = set(out["host_sync_probe"]["sites"])
    unnamed = sorted(probe - by_record - by_source)
    check(not unnamed, f"serve: sync sites no lint names: {unnamed}")
    out["probe_sites_named"] = {
        "probe_sites": len(probe), "by_record": len(probe & by_record),
        "by_source": len(probe & by_source), "by_both": len(probe & by_record & by_source)}
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
    res["named_sites"] = by_record
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
                out = _serve_script(st, 0.002, 64, 8, 4, 32, q1_selects=2, probe_ticks=0)
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


def serve_phases(torch, merge_kernel, card, bare_q1: dict,
                 span_pipelining=(False, True)) -> tuple:
    """``serve`` once for each ``span_pipelining`` setting (a tick at a
    time, then the pipelined span path), the kernel at each merge shape
    the first run launched, and ``serve_vs_plain_path``."""
    runs, named = [], ()
    for sp in span_pipelining:
        runs.append(phase_serve(torch, merge_kernel, card, bare_q1, span_pipelining=sp,
                                named_sites=named))
        named = runs[-1].pop("named_sites")
    rows = phase_path_kernel(torch, merge_kernel, card, runs[0]["by_shape"],
                             "serve_kernel_shape", half_full)
    phase_serve_modes(torch, merge_kernel, card)
    return runs, rows


# -- a deployment: environmentd with a subprocess replica on the card -------------

DEPLOY_TICKS, DEPLOY_SPAN, DEPLOY_PACED, DEPLOY_RESUMED = 32, 16, 16, 4
# The query subscription's filter: 4,096 orders (the generator's keys are
# dense), so its snapshot stays inside subscribe_queue_depth's 8,192 rows.
DEPLOY_OL_MAX_KEY = 4096
# The collection aggregates' view: one group an order (~150,000 at SF
# 0.1), a STRING_AGG and an ARRAY_AGG over ~600,000 multiset rows each.
ORDER_FLAGS_SQL = (
    "CREATE MATERIALIZED VIEW order_flags AS SELECT l_orderkey, "
    "string_agg(l_returnflag, ',') AS flags, array_agg(l_linenumber) AS lines, "
    "count(*) AS n FROM lineitem GROUP BY l_orderkey"
)
DEPLOY_FLAG_LOOKUPS = 64


def _copy_lines(payload: bytes) -> tuple:
    """One COPY-out chunk of a SUBSCRIBE (``server/pgwire.py``): its
    kind, its events ``(vals..., time, diff)`` as text and its progress
    frontier."""
    kind, events, frontier = "deltas", [], None
    for line in payload.decode().split("\n"):
        if not line:
            continue
        f = line.split("\t")
        if f[1] == "0" and f[2] == "snapshot" and len(f) == 3:
            kind = "snapshot"
        elif f[1] == "0" and f[2] == "progress" and len(f) == 3:
            frontier = int(f[0])
        else:
            events.append((tuple(None if v == "\\N" else v for v in f[2:]),
                           int(f[0]), int(f[1])))
    return kind, events, frontier


class _Tail:
    """One subscription read on a thread: each chunk as ``(kind, events,
    frontier, monotonic arrival)``, events ``(vals as text, time,
    diff)``. ``pg`` speaks pgwire's COPY-out; otherwise it reads the
    HTTP SSE stream of ``/api/subscribe``."""

    def __init__(self, port: int, sql: str, pg: bool):
        import socket
        import struct
        import threading

        self.chunks, self.error = [], None
        self._lock = threading.Lock()
        self.sock = socket.create_connection(("127.0.0.1", port), 60)
        if pg:
            body = struct.pack("!I", 196608) + b"user\x00chip_smoke\x00\x00"
            self.sock.sendall(struct.pack("!I", len(body) + 4) + body)
            while self._msg()[0] != b"Z":
                pass
            q = sql.encode() + b"\x00"
            self.sock.sendall(b"Q" + struct.pack("!I", len(q) + 4) + q)
            tag, body = self._msg()
            check(tag == b"H", f"SUBSCRIBE over pgwire: {tag!r} {body[:200]!r}")
            target = self._pg_loop
        else:
            from urllib.parse import quote

            self.sock.sendall(f"GET /api/subscribe?query={quote(sql)} HTTP/1.1\r\n"
                              f"Host: 127.0.0.1\r\n\r\n".encode())
            self._file = self.sock.makefile("rb")
            status = self._file.readline()
            check(b" 200 " in status, f"SSE subscribe: {status!r}")
            while self._file.readline() not in (b"\r\n", b"\n", b""):
                pass
            target = self._sse_loop
        self._thread = threading.Thread(target=self._run, args=(target,), daemon=True)
        self._thread.start()

    def _msg(self) -> tuple:
        import struct

        def exact(n):
            buf = b""
            while len(buf) < n:
                chunk = self.sock.recv(n - len(buf))
                if not chunk:
                    raise EOFError("subscription stream closed")
                buf += chunk
            return buf

        tag = exact(1)
        (n,) = struct.unpack("!I", exact(4))
        return tag, exact(n - 4)

    def _run(self, loop) -> None:
        try:
            loop()
        except (EOFError, OSError, ValueError):
            pass
        except Exception as e:  # noqa: BLE001 - reported by check_ok
            self.error = repr(e)

    def _add(self, kind, events, frontier) -> None:
        with self._lock:
            self.chunks.append((kind, events, frontier, time.monotonic()))

    def _pg_loop(self) -> None:
        while True:
            tag, body = self._msg()
            if tag == b"d":
                self._add(*_copy_lines(body))
            elif tag == b"E":
                self.error = body.decode(errors="replace")
                return

    def _sse_loop(self) -> None:
        for raw in self._file:
            line = raw.decode().rstrip("\n")
            if line.startswith("event: error"):
                self.error = line
            if not line.startswith("data: "):
                continue
            msg = json.loads(line[6:])
            if "error" in msg:
                self.error = msg["error"]
                return
            events = [(tuple(None if v is None else str(v) for v in e[:-2]), int(e[-2]),
                       int(e[-1])) for e in msg["events"]]
            self._add("snapshot" if msg.get("snapshot") else "deltas", events,
                      int(msg["progress"]))

    def frontier(self) -> int:
        with self._lock:
            return max((c[2] for c in self.chunks), default=0)

    def arrival(self, frontier: int):
        """Monotonic arrival of the first chunk at or past ``frontier``."""
        with self._lock:
            return next((c[3] for c in self.chunks if c[2] >= frontier), None)

    def states(self) -> list:
        """(frontier, multiset of rows) after every chunk: a snapshot
        chunk replaces the state, a delta chunk adds to it."""
        from collections import Counter

        with self._lock:
            chunks = list(self.chunks)
        state, out = Counter(), []
        for kind, events, frontier, _at in chunks:
            if kind == "snapshot":
                state = Counter()
            for vals, _t, d in events:
                state[vals] += d
            out.append((frontier, +state))
        return out

    def close(self) -> None:
        import socket
        import struct

        try:
            if not hasattr(self, "_file"):
                self.sock.sendall(b"X" + struct.pack("!I", 4))  # Terminate
            # Wakes the reader thread out of its blocking read.
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._thread.join(30)
        check(not self._thread.is_alive(), "a subscription reader did not stop")
        if hasattr(self, "_file"):
            self._file.close()
        self.sock.close()


def _rows_of(state) -> list:
    return [vals for vals, n in sorted(state.items()) for _ in range(n)]


def _order_lines_small(parts) -> tuple:
    """(lines, sum qty at scale 2) by orderkey <= DEPLOY_OL_MAX_KEY over
    ``parts``; additive."""
    key, qty, diff = _cols_of(parts, (0, 4))
    small = key <= DEPLOY_OL_MAX_KEY
    n = DEPLOY_OL_MAX_KEY + 1
    return (np.bincount(key[small], weights=diff[small], minlength=n).astype(np.int64),
            np.bincount(key[small], weights=(qty * diff)[small], minlength=n).astype(np.int64))


def _check_order_lines(state, lines_qty, what: str) -> None:
    from decimal import Decimal

    lines, qty = lines_qty
    keys = np.nonzero(lines)[0]
    want = sorted((int(k), int(lines[k]), int(qty[k])) for k in keys)
    got = sorted((int(r[0]), int(r[1]), int(Decimal(r[2]) * 100)) for r in _rows_of(state))
    check(got == want, f"{what}: {len(got)} rows vs the oracle's {len(want)}")


def _order_flags_oracle(parts, keys=None) -> dict:
    """``order_flags`` over the live rows of ``parts`` (only the orders
    ``keys`` when given): {orderkey text: (flags, lines, n)} as the wire
    carries them: the return flags in string order joined by ',', the
    line numbers ascending in braces, each repeated by its multiplicity,
    and the row count."""
    from materialize_tpu_torch.repr.schema import GLOBAL_DICT

    key, line, flag, diff = _cols_of(parts, (0, 3, 8))
    if keys is not None:
        m = np.isin(key, np.asarray(keys, np.int64))
        key, line, flag, diff = key[m], line[m], flag[m], diff[m]
    codes = np.unique(flag)
    # Flags by string (the engine's dictionary codes are in string order,
    # in whichever process coded them); line numbers by value.
    rank = np.argsort(np.argsort([GLOBAL_DICT.decode(int(c)) for c in codes]))
    flag_rank = rank[np.searchsorted(codes, flag)]
    texts = {}
    for name, col, render in (
        ("flags", flag_rank, np.array(sorted(GLOBAL_DICT.decode(int(c)) for c in codes))),
        ("lines", line, None),
    ):
        # (order, value) pairs as one int64 (line numbers are 1..7, flag
        # ranks 0..2), their net multiplicities, in (order, value) order.
        pair, inv = np.unique(key * 16 + col, return_inverse=True)
        mult = np.bincount(inv.reshape(-1), weights=diff, minlength=len(pair)).astype(np.int64)
        check(bool((mult >= 0).all()), "order_flags oracle: a negative multiplicity")
        pair, mult = pair[mult > 0], mult[mult > 0]
        vals = pair % 16
        elems = render[vals] if render is not None else vals.astype(str)
        elems = np.repeat(elems, mult).tolist()
        ks = np.repeat(pair // 16, mult)
        starts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
        bounds = np.r_[starts, len(ks)].tolist()
        texts[name] = {int(ks[a]): elems[a:b] for a, b in zip(bounds, bounds[1:])}
    return {str(k): (",".join(f), "{" + ",".join(texts["lines"][k]) + "}", str(len(f)))
            for k, f in texts["flags"].items()}


def _check_order_flags(rows, want: dict, what: str) -> None:
    got = {r[0]: tuple(r[1:]) for r in rows}
    check(len(got) == len(rows), f"{what}: a key twice in order_flags")
    bad = [k for k in set(got) | set(want) if got.get(k) != want.get(k)]
    check(not bad, f"{what}: {len(bad)} of {len(want)} orders differ from the oracle, "
          f"e.g. {[(k, got.get(k), want.get(k)) for k in sorted(bad)[:3]]}")


def _flag_lookups(client, keys, want: dict, what: str) -> list:
    """``SELECT * FROM order_flags WHERE l_orderkey = k`` for each key,
    each against the oracle; returns the ms of each."""
    ms = []
    for k in keys:
        (_c, rows, _t), dt = _timed(client, f"SELECT * FROM order_flags WHERE l_orderkey = {k}")
        _check_order_flags(rows, {str(k): want[str(k)]} if str(k) in want else {},
                           f"{what}: order {k}")
        ms.append(dt)
    return ms


def _check_explain_analysis(text: str, views: tuple) -> dict:
    """EXPLAIN ANALYSIS of a SELECT over ``order_flags``: the plan types,
    and the live blocks cover every installed view: a donation line each
    with ``wired=false``, a sharding line each with ``spmd=false
    workers=1``, and the compile block names ``merge_path.cu``."""
    lines = text.splitlines()
    check(lines and lines[0].startswith("typecheck: ok"), f"EXPLAIN ANALYSIS: {lines[:1]}")
    blocks, cur = {}, None
    for ln in lines:
        if not ln.startswith(" "):
            cur = ln.split(":", 1)[0]
            blocks[cur] = []
        else:
            blocks[cur].append(ln.strip())
    for v in views:
        don = [x for x in blocks.get("donation", []) if x.startswith(f"{v}@")]
        check(don and all("wired=false" in x for x in don),
              f"EXPLAIN ANALYSIS: donation lines of {v}: {don}")
        sh = [x for x in blocks.get("sharding", []) if x.startswith(f"{v}@")]
        check(sh and all("spmd=false workers=1" in x for x in sh),
              f"EXPLAIN ANALYSIS: sharding lines of {v}: {sh}")
    check(any("merge_path.cu" in x for x in blocks.get("compiles", [])),
          f"EXPLAIN ANALYSIS: the compile block names no merge_path.cu: "
          f"{blocks.get('compiles')}")
    return {"lines": lines, "donation": blocks["donation"], "sharding": blocks["sharding"]}


def _metric_samples(http_port: int) -> dict:
    """``/metrics`` as {sample with its labels: value} (the deployment's
    one scrape: the coordinator's registry merged with each replica's
    last shipped snapshot)."""
    from urllib.request import urlopen

    text = urlopen(f"http://127.0.0.1:{http_port}/metrics", timeout=60).read().decode()
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            name, _, value = line.rpartition(" ")
            out[name] = float(value)
    return out


def _settled_metrics(http_port: int, key: str) -> dict:
    """``/metrics`` once ``key`` holds still across two scrapes 0.3 s
    apart: the replica ships a snapshot at most every
    ``metrics_report_ms``, so its last steps are in the settled one."""
    prev = _metric_samples(http_port)
    for _ in range(100):
        time.sleep(0.3)
        cur = _metric_samples(http_port)
        if cur.get(key) == prev.get(key) and key in cur:
            return cur
        prev = cur
    check(False, f"/metrics {key} did not settle")


def _http_sql(http_port: int, sql: str) -> list:
    from urllib.request import Request, urlopen

    req = Request(f"http://127.0.0.1:{http_port}/api/sql",
                  data=json.dumps({"query": sql}).encode())
    res = json.loads(urlopen(req, timeout=120).read())["results"][-1]
    check("rows" in res, f"/api/sql {sql[:60]!r}: {res}")
    return [tuple(None if v is None else str(v) for v in r) for r in res["rows"]]


def _replica_alive(env) -> None:
    for rid, rec in env.replica_records.items():
        p = rec.get("proc")
        check(p is not None and p.poll() is None,
              f"replica {rid} died (exit code {None if p is None else p.returncode})")


def _shutdown_checked(env) -> dict:
    """Shut the environment down; every replica process must have been
    alive until then and end on the SIGTERM (no escalation)."""
    _replica_alive(env)
    report = env.shutdown()
    for r in report["replicas"]:
        check(r["returncode"] in (0, -15) and not r["escalated"],
              f"replica process {r['pid']} ended with {r['returncode']}")
    return report


def _deploy_run(root: str, device: str, sf: float, churn: int, ticks: int, span: int,
                paced: int, resumed: int, span_pipelining: bool = True) -> dict:
    """The deployment script on ``device`` (module docstring, ``deploy``):
    an ``Environment`` in this process with one subprocess replica,
    served over pgwire and HTTP, then shut down and recovered on the same
    data directory. ``span_pipelining`` off (a durable SET before the
    DDL) steps the replica's views a tick at a time instead. Returns the
    phase's numbers; raises on any check."""
    from materialize_tpu_torch.coord.freshness import FRESHNESS, lag_ms
    from materialize_tpu_torch.server.environmentd import Environment
    from materialize_tpu_torch.storage.persist import COMPACTION_STATS

    # The recorder is process-global: start it empty, without the lag
    # of the serve phase's in-process replica (same view names).
    FRESHNESS.clear()
    out: dict = {}
    # Where the phase's seconds go, stage by stage.
    split, t_last = {}, [time.perf_counter()]

    def stage(name: str) -> None:
        now = time.perf_counter()
        split[name] = now - t_last[0]
        t_last[0] = now

    out["split_s"] = split
    t_boot = time.perf_counter()
    env = Environment(root, device=device, tick_interval=None)
    out["environment_boot_s"] = time.perf_counter() - t_boot
    out["replica_boot_s"] = env.replica_records["r0"]["boot_s"]
    try:
        http = env.http.port
        c = PgClient(env.pg.port)
        c.query("SET metrics_report_ms = 50")
        # order_flags' point lookups differ in their literal, so the
        # transient-SELECT cache never hits them; its default would keep 8
        # of their dataflows installed, stepping every tick.
        c.query("SET transient_peek_cache = 0")
        if not span_pipelining:
            c.query("SET span_pipelining = false")
        t = time.perf_counter()
        c.query(f"CREATE SOURCE tpch FROM LOAD GENERATOR TPCH "
                f"(SCALE FACTOR {sf}, CHURN ORDERS {churn})")
        c.query("CREATE MATERIALIZED VIEW q1 AS " + SERVE_Q1_SQL)
        c.query(SERVE_ORDER_LINES_SQL)
        c.query("CREATE INDEX order_lines_idx ON order_lines (l_orderkey)")
        c.query(ORDER_FLAGS_SQL)
        _cols, first_q1, _tag = c.query("SELECT * FROM q1")
        out["hydrate_s"] = time.perf_counter() - t
        stage("boot_and_hydrate")
        first = _settled_metrics(http, 'mz_merge_path_load_seconds{replica="r0"}')
        out["replica_library_load_s"] = first['mz_merge_path_load_seconds{replica="r0"}']
        _gen, snap, churn_parts = _serve_oracle_parts(sf, churn, ticks + paced + resumed)
        # The oracles at every frontier F (times < F: the snapshot and
        # churn ticks 1..F-1), built up a tick at a time.
        q1_at, ol_at = [None, _q1_sums(snap)], [None, _order_lines_small(snap)]
        for part in churn_parts:
            q1_at.append(_q1_add(q1_at[-1], _q1_sums([part])))
            lq = _order_lines_small([part])
            ol_at.append((ol_at[-1][0] + lq[0], ol_at[-1][1] + lq[1]))
        _check_q1_wire(first_q1, None, "deploy: Q1 after hydration", q1_at[1])
        # The collection aggregates after hydration: 64 seeded orders.
        snap_keys = np.unique(_cols_of(snap, (0,))[0])
        flag_keys = np.random.default_rng(12).choice(snap_keys, DEPLOY_FLAG_LOOKUPS,
                                                     replace=False).tolist()
        flag_ms = _flag_lookups(c, flag_keys, _order_flags_oracle(snap, flag_keys),
                                "deploy: order_flags after hydration")
        stage("oracle")
        ol_sql = (f"SUBSCRIBE TO (SELECT l_orderkey, lines, qty FROM order_lines "
                  f"WHERE l_orderkey <= {DEPLOY_OL_MAX_KEY})")
        tails = {
            "q1_pgwire": _Tail(env.pg.port, "SUBSCRIBE q1", pg=True),
            "order_lines_pgwire": _Tail(env.pg.port, ol_sql, pg=True),
            "order_lines_sse": _Tail(http, ol_sql, pg=False),
        }
        src = env.coord.sources["tpch"]
        f0 = src.t

        def wait_tails(frontier: int, what: str) -> None:
            t_w = time.perf_counter()
            while min(tl.frontier() for tl in tails.values()) < frontier:
                check(time.perf_counter() - t_w < 120, f"{what}: subscriptions stalled")
                for name, tl in tails.items():
                    check(tl.error is None, f"{name}: {tl.error}")
                time.sleep(0.001)

        wait_tails(f0, "deploy: subscription snapshots")
        stage("subscribe")
        hub = env.coord.subscribe_hub.snapshot()
        check(hub["installs"] == 1 and hub["sessions"] == 3,
              f"deploy: hub {hub['installs']} installs, {hub['sessions']} sessions")
        owned = [tl for tl in hub["tails"] if tl["owned"]]
        check(len(owned) == 1 and owned[0]["sessions"] == 2,
              f"deploy: the query subscriptions do not share one dataflow: {hub['tails']}")
        rows_written = sum(len(p[1]) for p in churn_parts[:ticks])
        t_first = time.perf_counter()
        for _s in range(ticks // span):
            for _i in range(span):
                src.tick_once()
            c.query("SELECT * FROM q1")
        wait_tails(src.t, "deploy: churn spans")
        served_s = time.perf_counter() - t_first
        stage("churn")
        step0 = _settled_metrics(http, "mz_replica_step_seconds_sum{replica=\"r0\"}")
        fresh_ms, deliver = [], {name: [] for name in tails}
        for _i in range(paced):
            target = src.t + 1
            t_tick = time.monotonic()
            src.tick_once()
            wait_tails(target, "deploy: a paced tick")
            fresh_ms.append(lag_ms(t_tick))
            for name, tl in tails.items():
                deliver[name].append(lag_ms(t_tick, tl.arrival(target)))
        stage("paced")
        step1 = _settled_metrics(http, "mz_replica_step_seconds_sum{replica=\"r0\"}")
        key = 'mz_replica_step_seconds_{}{{replica="r0"}}'
        # -- checks, off the clock -------------------------------------------
        for name, tl in tails.items():
            check(tl.error is None, f"{name}: {tl.error}")
            states = tl.states()
            check(states and states[-1][0] == src.t, f"{name}: ends at {states[-1][0]}")
            for frontier, state in states:
                if name.startswith("q1"):
                    _check_q1_wire(_rows_of(state), None, f"deploy: {name} at {frontier}",
                                   q1_at[frontier])
                else:
                    _check_order_lines(state, ol_at[frontier], f"deploy: {name} at {frontier}")
            out[f"{name}_frontiers_checked"] = len(states)
        last_q1 = tails["q1_pgwire"].states()[-1]
        _cols, wire_q1, _tag = c.query("SELECT * FROM q1")
        http_q1 = _http_sql(http, "SELECT * FROM q1")
        check(sorted(http_q1) == sorted(wire_q1), "deploy: /api/sql != pgwire for q1")
        _check_q1_wire(wire_q1, None, "deploy: Q1 at rest", q1_at[src.t])
        ol_where = f"SELECT * FROM order_lines WHERE l_orderkey <= {DEPLOY_OL_MAX_KEY}"
        check(sorted(_http_sql(http, ol_where)) == sorted(c.query(ol_where)[1]),
              "deploy: /api/sql != pgwire for order_lines")
        intro = {}
        for rel, sql in (
            ("mz_wallclock_lag_summary", "SELECT dataflow, replica, samples, p50_ms, p99_ms "
                                         "FROM mz_wallclock_lag_summary"),
            ("mz_hydration_statuses", "SELECT dataflow, replica, status FROM mz_hydration_statuses"),
            ("mz_subscriptions", "SELECT session, dataflow, sharers, frontier FROM mz_subscriptions"),
            ("mz_cluster_replicas", "SELECT name, connected, state FROM mz_cluster_replicas"),
            ("mz_compactions", "SELECT shard, replica, requests, merges_background, "
                               "merges_inline, blob_writes_inline FROM mz_compactions"),
            ("mz_span_epochs", "SELECT dataflow, replica, span_epoch FROM mz_span_epochs"),
            ("mz_compile_log", "SELECT process, kind, dataflow, fingerprint, tier, seconds, "
                               "cache FROM mz_compile_log"),
        ):
            intro[rel] = c.query(sql)[1]
        epochs = {(r[0], r[1]): int(r[2]) for r in intro["mz_span_epochs"]}
        check(all((epochs.get((v, "r0"), 0) > 0) == span_pipelining
                  for v in ("q1", "order_lines_idx")), f"deploy: span epochs {epochs}")
        check(any(r[0] == "r0" and r[1] == "nvcc" and r[2] == "merge_path.cu"
                  for r in intro["mz_compile_log"]),
              f"deploy: no merge_path build or load shipped: {intro['mz_compile_log']}")
        check(("r0", "1", "active") in intro["mz_cluster_replicas"], "deploy: r0 not connected")
        check({("q1", "r0", "hydrated"), ("order_lines_idx", "r0", "hydrated")}
              <= set(intro["mz_hydration_statuses"]), "deploy: views not hydrated")
        check(len(intro["mz_subscriptions"]) == 3, "deploy: mz_subscriptions")
        check(any(r[0] == "q1" and r[1] == "r0" and int(r[2]) > 0
                  for r in intro["mz_wallclock_lag_summary"]), "deploy: no lag samples for q1")
        # order_flags after the paced ticks: the same 64 orders, then the
        # whole view, against the oracle at the source's frontier.
        live_parts = snap + churn_parts[: src.t - 1]
        flag_ms += _flag_lookups(c, flag_keys, _order_flags_oracle(live_parts, flag_keys),
                                 "deploy: order_flags after the paced ticks")
        # The whole view: first until its frontier passes the source's
        # last tick (it steps a tick at a time), then the read itself over
        # /api/sql (one response body: pgwire's one message a row between
        # two threads of this interpreter took 43.5 s for 150,000 rows,
        # PERF.md).
        t_w = time.perf_counter()
        env.coord.controller.wait_frontier("order_flags", src.t - 1, timeout=300)
        catch_up_s = time.perf_counter() - t_w
        t_w = time.perf_counter()
        flag_rows = _http_sql(http, "SELECT * FROM order_flags")
        full_ms = (time.perf_counter() - t_w) * 1e3
        want_flags = _order_flags_oracle(live_parts)
        _check_order_flags(flag_rows, want_flags, "deploy: the whole of order_flags")
        _c, ex_rows, _t = c.query("EXPLAIN ANALYSIS SELECT * FROM order_flags")
        explain = _check_explain_analysis("\n".join(r[0] for r in ex_rows),
                                          ("q1", "order_lines_idx", "order_flags"))
        comp = intro["mz_compactions"]
        check(sum(int(r[3]) for r in comp) > 0, f"deploy: no background compaction: {comp}")
        check(all(int(r[4]) == 0 and int(r[5]) == 0 for r in comp),
              f"deploy: compaction work on the tick path: {comp}")
        from urllib.request import urlopen
        from urllib.error import HTTPError

        try:
            ready = json.loads(urlopen(f"http://127.0.0.1:{http}/api/readyz", timeout=60).read())
        except HTTPError as e:
            ready = json.loads(e.read())
        check(ready["ready"], f"deploy: readyz {ready}")
        stage("checks")
        summary = FRESHNESS.summary()
        out.update({
            "churn_ticks": ticks, "source_rows_written": rows_written, "served_s": served_s,
            "served_updates_per_s": rows_written / served_s,
            "paced_ticks": paced,
            "paced_tick_fresh_ms_p50": float(np.percentile(fresh_ms, 50)),
            "paced_tick_fresh_ms_p99": float(np.percentile(fresh_ms, 99)),
            "delivery_lag_ms": {name: {"p50": float(np.percentile(v, 50)),
                                       "p99": float(np.percentile(v, 99))}
                                for name, v in deliver.items()},
            "recorder_lag_ms": {f"{df}@{rep}": {"p50": s["p50_ms"], "p99": s["p99_ms"],
                                                "samples": s["samples"]}
                                for (df, rep), s in sorted(summary.items())},
            "replica_step_ms_per_tick": (step1[key.format("sum")] - step0[key.format("sum")])
            * 1e3 / paced,
            "replica_steps_per_tick": (step1[key.format("count")] - step0[key.format("count")])
            / paced,
            "hub": {k: hub[k] for k in ("installs", "shared_joins", "sessions")},
            "readbacks_per_span": env.coord.subscribe_hub.snapshot()["readbacks_per_span"],
            "compactions": {"requests": sum(int(r[2]) for r in comp),
                            "merges_background": sum(int(r[3]) for r in comp),
                            "merges_inline": sum(int(r[4]) for r in comp),
                            "coordinator": COMPACTION_STATS.totals()},
            "readyz": ready["checks"],
            "order_flags": {"groups": len(want_flags), "lookups": len(flag_ms),
                            "lookup_ms_p50": float(np.percentile(flag_ms, 50)),
                            "lookup_ms_p99": float(np.percentile(flag_ms, 99)),
                            "catch_up_s": catch_up_s, "whole_view_http_ms": full_ms},
            "explain_analysis": explain,
        })
        for tl in tails.values():
            tl.close()
        c.close()
        fin = _settled_metrics(http, 'mz_merge_path_launches_total{replica="r0"}')
        out["launches_first_boot"] = int(fin['mz_merge_path_launches_total{replica="r0"}'])
        out["replica_peak_device_bytes"] = int(fin['mz_device_peak_bytes{replica="r0"}'])
        # The replica process's span census (storage/persist/operators.SPANS,
        # shipped as gauges): its index view pipelines (span_pipelining is
        # on by default), its materialized view commits at its boundary.
        spans = {k: int(fin[f'{k}{{replica="r0"}}']) for k in (
            "mz_span_commits", "mz_span_boundary_readbacks", "mz_span_overflows",
            "mz_spans_in_flight_max")}
        if span_pipelining:
            check(spans["mz_span_commits"] > 0
                  and spans["mz_span_boundary_readbacks"] == spans["mz_span_commits"]
                  and spans["mz_spans_in_flight_max"] == 1, f"deploy: replica spans {spans}")
        else:
            check(spans["mz_span_commits"] == 0, f"deploy: spans stepped a tick at a time {spans}")
        out["span_pipelining"] = span_pipelining
        out["replica_spans"] = spans
        out["replica_flags_readbacks_per_span"] = (
            spans["mz_span_boundary_readbacks"] / spans["mz_span_commits"]
            if spans["mz_span_commits"] else None)
        out["mz_span_epochs"] = intro["mz_span_epochs"]
        out["mz_compile_log"] = intro["mz_compile_log"]
        last_frontier, last_state = last_q1
        stage("settle")
    finally:
        report = _shutdown_checked(env)
    stage("shutdown")
    # -- recovery: the same data directory, the catalog replayed -------------
    t = time.perf_counter()
    env = Environment(root, device=device, tick_interval=None)
    try:
        rec = env.await_recovery()
        out["recovery_s"] = time.perf_counter() - t
        stage("recovery")
        out["recovery_replica_boot_s"] = env.replica_records["r0"]["boot_s"]
        check(rec["coordinator"]["catalog_replayed"] >= 4 and
              rec["coordinator"]["replay_failures"] == 0, f"deploy: recovery {rec}")
        c = PgClient(env.pg.port)
        c.query("SET metrics_report_ms = 50")
        src = env.coord.sources["tpch"]
        check(src.t == last_frontier, f"deploy: source at {src.t} after recovery, "
              f"{last_frontier} before")
        _check_q1_wire(c.query("SELECT * FROM q1")[1], None, "deploy: Q1 after recovery",
                       q1_at[src.t])
        # Exactly-once resume of the Q1 subscription at its last frontier:
        # deltas from there on, no snapshot.
        sub = env.coord.subscribe_hub.resume("q1", last_frontier)
        state = last_state.copy()
        for _i in range(resumed):
            src.tick_once()
        deadline = time.perf_counter() + 120
        frontiers = []
        while sub.frontier < src.t:
            check(time.perf_counter() < deadline, "deploy: resumed subscription stalled")
            got = sub.poll(timeout=1.0)
            if got is None:
                continue
            events, frontier = got
            for ev in events:
                *vals, _t, d = ev
                state[tuple(None if v is None else str(v) for v in vals)] += d
            frontiers.append(frontier)
            _check_q1_wire(_rows_of(+state), None, f"deploy: resumed Q1 at {frontier}",
                           q1_at[frontier])
        sub.close()
        stage("resume")
        out["resumed_frontiers"] = frontiers
        c.close()
        fin = _settled_metrics(env.http.port, 'mz_merge_path_launches_total{replica="r0"}')
        out["launches_recovery_boot"] = int(fin['mz_merge_path_launches_total{replica="r0"}'])
    finally:
        report2 = _shutdown_checked(env)
    stage("settle_and_shutdown")
    out["launches"] = out["launches_first_boot"] + out["launches_recovery_boot"]
    out["shutdown"] = [report, report2]
    return out


def phase_deploy(torch, merge_kernel, card, serve: dict, span_pipelining: bool = True) -> dict:
    """``deploy``: the port deployed as users deploy it, the replica in a
    process of its own on the card (module docstring)."""
    import tempfile

    torch.cuda.synchronize()
    # Earlier phases' cached blocks stay with this process: hand them back
    # before the replica process takes its own share of the card.
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    from materialize_tpu_torch.utils.dyncfg import COMPUTE_CONFIGS

    try:
        with tempfile.TemporaryDirectory() as root:
            out = _deploy_run(root, "cuda", SERVE_SF, SERVE_CHURN, DEPLOY_TICKS, DEPLOY_SPAN,
                              DEPLOY_PACED, DEPLOY_RESUMED, span_pipelining=span_pipelining)
    finally:
        # The SETs landed in this process's flags too (the coordinator's).
        COMPUTE_CONFIGS.update({"span_pipelining": None, "transient_peek_cache": None})
    check(out["launches_first_boot"] > 0 and out["launches_recovery_boot"] > 0,
          f"deploy: the replica processes launched merge_path "
          f"{out['launches_first_boot']}/{out['launches_recovery_boot']} times")
    res = {"phase": "deploy", "sf": SERVE_SF, "churn_orders": SERVE_CHURN, "card": card,
           **out,
           "serve_paced_split_ms_p50": serve["paced_split_ms_p50"],
           "serve_paced_tick_fresh_ms_p50": serve["paced_tick_fresh_ms_p50"],
           "serve_churn_updates_per_s": serve["churn_updates_per_s"],
           "phase_s": time.perf_counter() - t0}
    emit(res)
    res["by_shape"] = {}
    return res


# -- kafka: a Debezium CDC deployment of TPC-H (phase 7c) ----------------------

KAFKA_TOPIC, KAFKA_OUT = "tpch.lineitem", "q1.out"
KAFKA_PARTITIONS = 4  # partition = l_orderkey % 4
# SF 0.05 (~300,000 lineitem rows), not serve's 0.1: with it the script
# took 1,111.2 s of its time limit (an NVIDIA H100 80GB HBM3 at 700 W,
# PERF.md §4).
KAFKA_SF = 0.05
# Churn ticks, paced ticks, and ticks appended while environmentd is down.
KAFKA_TICKS, KAFKA_PACED, KAFKA_DOWN = 32, 16, 4
KAFKA_KILL_AT = 8  # paced ticks before environmentd's kill -9
KAFKA_REPLICA_KILL_AT = 16  # churn ticks before the replica's SIGKILL
KAFKA_LOOKUPS = 64
KAFKA_TICK_S = 0.25  # environmentd's --tick-interval: the source's poll
KAFKA_CHUNK = 16384  # snapshot records a producer append
KAFKA_WAIT_S = 180.0

KAFKA_SOURCE_SQL = (
    "CREATE SOURCE li (l_orderkey bigint NOT NULL, l_partkey bigint NOT NULL, "
    "l_suppkey bigint NOT NULL, l_linenumber integer NOT NULL, "
    "l_quantity numeric(15,2) NOT NULL, l_extendedprice numeric(15,2) NOT NULL, "
    "l_discount numeric(15,2) NOT NULL, l_tax numeric(15,2) NOT NULL, "
    "l_returnflag text NOT NULL, l_linestatus text NOT NULL, l_shipdate date NOT NULL, "
    "l_commitdate date NOT NULL, l_receiptdate date NOT NULL) FROM KAFKA "
    "(BROKER '{broker}', TOPIC '" + KAFKA_TOPIC + "', FORMAT 'json', ENVELOPE 'debezium')")
KAFKA_Q1_SQL = "CREATE MATERIALIZED VIEW q1 AS " + SERVE_Q1_SQL.replace(
    "FROM lineitem", "FROM li")
KAFKA_INDEX_SQL = "CREATE INDEX li_by_order ON li (l_orderkey)"
# The offsets the source bound, read as an operator reads them: an index
# makes each read a fast-path scan, not a transient dataflow.
KAFKA_PROGRESS_INDEX_SQL = "CREATE INDEX li_progress_idx ON li_progress (partition)"
KAFKA_SINK_SQL = ("CREATE SINK q1_sink FROM q1 INTO KAFKA (BROKER '{broker}', TOPIC '"
                  + KAFKA_OUT + "', FORMAT 'json', ENVELOPE 'debezium')")


def _debezium_records(cols, diffs) -> tuple:
    """A lineitem part as Debezium change records, built in bulk: a
    delete (diff -1) is ``{"payload": {"before": row, "after": null}}``,
    an insert ``{"before": null, "after": row}``; DECIMALs as text at
    scale 2 (``decimal.handling.mode=string``), DATEs as days since the
    epoch (``io.debezium.time.Date``). Returns (partition per record,
    record values)."""
    from materialize_tpu_torch.repr.schema import GLOBAL_DICT

    check(bool(np.all(np.abs(diffs) == 1)), "kafka: a lineitem diff other than +-1")
    cl = [np.asarray(c).tolist() for c in cols]
    text = {c: GLOBAL_DICT.decode(c) for c in set(cl[8]) | set(cl[9])}

    def d2(v):
        return f"{v // 100}.{v % 100:02d}"

    rows = [
        f'{{"l_orderkey": {a}, "l_partkey": {b}, "l_suppkey": {c}, "l_linenumber": {d}, '
        f'"l_quantity": "{d2(e)}", "l_extendedprice": "{d2(f)}", "l_discount": "{d2(g)}", '
        f'"l_tax": "{d2(h)}", "l_returnflag": "{text[i]}", "l_linestatus": "{text[j]}", '
        f'"l_shipdate": {k}, "l_commitdate": {m}, "l_receiptdate": {n}}}'
        for a, b, c, d, e, f, g, h, i, j, k, m, n in zip(*cl)
    ]
    values = [
        (f'{{"payload": {{"before": {r}, "after": null}}}}' if d < 0
         else f'{{"payload": {{"before": null, "after": {r}}}}}').encode()
        for r, d in zip(rows, np.asarray(diffs).tolist())
    ]
    return np.asarray(cols[0]) % KAFKA_PARTITIONS, values


def _by_partition(parts_of, values) -> list:
    return [[values[i] for i in np.flatnonzero(parts_of == p)]
            for p in range(KAFKA_PARTITIONS)]


def _produce_snapshot(broker, snap) -> int:
    """The snapshot, after-only, a partition at a time in appends of
    ``KAFKA_CHUNK`` records (one committed index entry each)."""
    from materialize_tpu_torch.storage.kafka.broker import Record

    cols = [np.concatenate([p[0][i] for p in snap]) for i in range(13)]
    diffs = np.concatenate([p[1] for p in snap])
    parts_of, values = _debezium_records(cols, diffs)
    for p, vals in enumerate(_by_partition(parts_of, values)):
        for i in range(0, len(vals), KAFKA_CHUNK):
            broker.append(KAFKA_TOPIC, p, [Record(None, v) for v in vals[i:i + KAFKA_CHUNK]])
    return len(values)


def _produce_tick(broker, part) -> int:
    """One churn tick (before-only deletes, after-only inserts) as one
    transaction over the four partitions: an exactly-once producer's
    commit."""
    from materialize_tpu_torch.storage.kafka.broker import Record

    parts_of, values = _debezium_records(*part)
    broker.append_txn([(KAFKA_TOPIC, p, [Record(None, v) for v in vals])
                       for p, vals in enumerate(_by_partition(parts_of, values)) if vals])
    return len(values)


def _q1_sink_rows(sums) -> dict:
    """Q1's rows as the sink encodes them (DECIMALs as JSON floats of the
    engine's decimals), each once: the consolidated ``q1.out``."""
    from decimal import Decimal

    from materialize_tpu_torch.repr.schema import GLOBAL_DICT

    out = {}
    for (f, s), (qty, base, disc_price, charge, cnt, disc) in sums.items():
        if cnt == 0:
            continue
        row = {"l_returnflag": GLOBAL_DICT.decode(f), "l_linestatus": GLOBAL_DICT.decode(s),
               "sum_qty": float(Decimal(qty) / 100),
               "sum_base_price": float(Decimal(base) / 100),
               "sum_disc_price": float(Decimal(disc_price) / 10**4),
               "sum_charge": float(Decimal(charge) / 10**6),
               "avg_qty": float(Decimal(qty // cnt) / 100),
               "avg_price": float(Decimal(base // cnt) / 100),
               "avg_disc": float(Decimal(disc // cnt) / 100),
               "count_order": cnt}
        out[tuple(sorted(row.items()))] = 1
    return out


class _TopicTail:
    """``q1.out`` read as a consumer reads it: each new record once, the
    Debezium pairs consolidated (+1 after, -1 before), and every record's
    bytes counted, so that a record published twice shows."""

    def __init__(self, broker, topic: str):
        from collections import Counter

        self.broker, self.topic = broker, topic
        self.offset = 0
        self.state, self.seen = Counter(), Counter()

    def poll(self) -> dict:
        end = self.broker.end_offset(self.topic, 0)
        if end > self.offset:
            for r in self.broker.fetch(self.topic, 0, self.offset, end - self.offset):
                self.seen[r.value] += 1
                p = json.loads(r.value)["payload"]
                for side, d in (("before", -1), ("after", 1)):
                    if p[side] is not None:
                        self.state[tuple(sorted(p[side].items()))] += d
            self.offset = end
        return {k: n for k, n in self.state.items() if n}

    def republished(self) -> int:
        return sum(n - 1 for n in self.seen.values() if n > 1)


def _free_tcp_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _tgid(pid: int) -> int | None:
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith("Tgid:"):
                    return int(line.split()[1])
    except FileNotFoundError:
        return None
    return None


def _children(pid: int) -> list:
    """The child processes of ``pid`` (some kernels also list a child's
    threads there: only thread-group leaders are kept)."""
    out = set()
    for task in os.listdir(f"/proc/{pid}/task"):
        try:
            with open(f"/proc/{pid}/task/{task}/children") as f:
                out.update(int(c) for c in f.read().split())
        except FileNotFoundError:  # a thread that ended meanwhile
            continue
    return sorted(c for c in out if _tgid(c) == c)


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(") ", 1)[1][0] != "Z"
    except (FileNotFoundError, ProcessLookupError, IndexError):
        return False


def _sigkill(pid: int) -> None:
    try:
        os.kill(pid, 9)
    except ProcessLookupError:
        pass


def _kill_wait(proc) -> None:
    if proc is not None and proc.poll() is None:
        proc.kill()
        proc.wait(timeout=30)


class _Environmentd:
    """``python -m materialize_tpu_torch.server.environmentd`` in a process
    of its own (so that it can be killed with SIGKILL), its output (and
    its replica's) in a log file; up once it prints its listening line."""

    def __init__(self, root: str, device: str, recover: bool = False, n: int = 0):
        self.pg, self.http = _free_tcp_port(), _free_tcp_port()
        self.log_path = os.path.join(root, f"environmentd{n}.log")
        cmd = [sys.executable, "-m", "materialize_tpu_torch.server.environmentd",
               "--data-dir", os.path.join(root, "data"), "--pg-port", str(self.pg),
               "--http-port", str(self.http), "--replicas", "1",
               "--tick-interval", str(KAFKA_TICK_S), "--device", device]
        if recover:
            cmd.append("--recover")
        self._log = open(self.log_path, "w")
        self.proc = subprocess.Popen(
            cmd, stdout=self._log, stderr=subprocess.STDOUT,
            cwd=os.path.dirname(os.path.abspath(__file__)),
            env={**os.environ, "PYTHONUNBUFFERED": "1"})
        t0 = time.perf_counter()
        while "materialize_tpu_torch listening" not in self.log():
            check(self.proc.poll() is None,
                  f"kafka: environmentd exited {self.proc.returncode}: {self.log()[-3000:]}")
            check(time.perf_counter() - t0 < KAFKA_WAIT_S, "kafka: environmentd did not listen")
            time.sleep(0.05)
        self.boot_s = time.perf_counter() - t0
        self.recovery = None
        for line in self.log().splitlines():
            if line.startswith("recovery: "):
                self.recovery = json.loads(line[len("recovery: "):])

    def log(self) -> str:
        with open(self.log_path) as f:
            return f.read()

    def replica_pids(self) -> list:
        """Its replica processes (its other children are not)."""
        out = []
        for pid in _children(self.proc.pid):
            try:
                with open(f"/proc/{pid}/cmdline") as f:
                    if "materialize_tpu_torch.coord.replica" in f.read():
                        out.append(pid)
            except FileNotFoundError:
                continue
        return out

    def sql(self, sql: str) -> list:
        return _http_sql(self.http, sql)

    def metrics(self) -> dict:
        return _metric_samples(self.http)

    def stop(self) -> None:
        """SIGTERM: environmentd stops its replica processes and exits 0."""
        self.proc.terminate()
        rc = self.proc.wait(timeout=60)
        self._log.close()
        check(rc == 0, f"kafka: environmentd ended with {rc}: {self.log()[-3000:]}")


def _replica_counts(samples: dict) -> tuple:
    """(merge_path launches, launches by merge shape, peak device bytes)
    of the replica r0 that last shipped its metrics."""
    import re

    launches = int(samples.get('mz_merge_path_launches_total{replica="r0"}', 0))
    peak = int(samples.get('mz_device_peak_bytes{replica="r0"}', 0))
    shapes = {}
    for key, v in samples.items():
        if key.startswith("mz_merge_path_launches_by_shape{") and 'replica="r0"' in key:
            lab = dict(re.findall(r'(\w+)="([^"]*)"', key))
            shapes[(int(lab["cap_a"]), int(lab["cap_b"]), int(lab["out"]),
                    int(lab["lanes"]))] = int(v)
    return launches, shapes, peak


def _lookup_oracle(parts, keys) -> dict:
    """{l_orderkey: sorted live (linenumber, partkey, suppkey, qty, ext)}."""
    from collections import Counter

    key, part, supp, line, qty, ext, diff = _cols_of(parts, (0, 1, 2, 3, 4, 5))
    m = np.isin(key, keys)
    acc = Counter()
    for k, ln, p, s, q, e, d in zip(*(a[m].tolist() for a in (key, line, part, supp, qty,
                                                               ext, diff))):
        acc[(k, (ln, p, s, q, e))] += d
    out = {k: [] for k in keys}
    for (k, row), n in acc.items():
        check(n in (0, 1), f"kafka: oracle row {row} of order {k} counted {n}")
        if n:
            out[k].append(row)
    return {k: sorted(v) for k, v in out.items()}


def _check_lookups(c, keys, want: dict, what: str) -> list:
    from decimal import Decimal

    ms = []
    for k in keys:
        t = time.perf_counter()
        _cols, rows, _tag = c.query(
            "SELECT l_linenumber, l_partkey, l_suppkey, l_quantity, l_extendedprice "
            f"FROM li WHERE l_orderkey = {k}")
        ms.append((time.perf_counter() - t) * 1e3)
        got = sorted((int(a), int(b), int(s), int(Decimal(q) * 100), int(Decimal(e) * 100))
                     for a, b, s, q, e in rows)
        check(got == want[k], f"{what}: order {k}: {got} != {want[k]}")
    return ms


def _kafka_run(root: str, device: str, sf: float, churn: int) -> dict:
    """The ``kafka`` phase on ``device`` (module docstring, phase 7c);
    returns its numbers, raises on any check."""
    from materialize_tpu_torch.storage.kafka.broker import FileBroker

    out: dict = {"sf": sf, "churn_orders": churn, "partitions": KAFKA_PARTITIONS}
    split, t_last = {}, [time.perf_counter()]
    out["split_s"] = split

    def stage(name: str) -> None:
        now = time.perf_counter()
        split[name] = now - t_last[0]
        t_last[0] = now
        print(f"kafka: {name} {split[name]:.3f} s", file=sys.stderr, flush=True)

    n_ticks = KAFKA_TICKS + KAFKA_PACED + KAFKA_DOWN
    _gen, snap, churn_parts = _serve_oracle_parts(sf, churn, n_ticks)
    # Q1's sums after the snapshot and after each churn tick.
    q1_at = [_q1_sums(snap)]
    for part in churn_parts:
        q1_at.append(_q1_add(q1_at[-1], _q1_sums([part])))
    stage("oracle")
    broker_dir = os.path.join(root, "broker")
    broker = FileBroker(broker_dir)
    broker.create_topic(KAFKA_TOPIC, KAFKA_PARTITIONS)
    t = time.perf_counter()
    out["snapshot_records"] = _produce_snapshot(broker, snap)
    out["producer_snapshot_s"] = time.perf_counter() - t
    stage("produce_snapshot")
    produced = [0]  # churn ticks in the topic
    tick_records: list = []

    def produce(n: int) -> None:
        for _ in range(n):
            t_p = time.perf_counter()
            tick_records.append(_produce_tick(broker, churn_parts[produced[0]]))
            out["producer_churn_s"] = out.get("producer_churn_s", 0.0) + time.perf_counter() - t_p
            produced[0] += 1

    def ends() -> dict:
        return {p: broker.end_offset(KAFKA_TOPIC, p) for p in range(KAFKA_PARTITIONS)}

    tail = _TopicTail(broker, KAFKA_OUT)
    env = None
    replicas: list = []  # the replica processes this script respawned
    counted = []  # (launches, shapes, peak) of each replica generation
    snap_keys = np.unique(_cols_of(snap, (0,))[0])
    keys = np.random.default_rng(13).choice(snap_keys, KAFKA_LOOKUPS, replace=False).tolist()
    lookup_ms: list = []

    def caught_up(c, what: str) -> float:
        """Wait until li_progress binds the topic's end offsets; Q1 over
        pgwire then equals the oracle and the index answers the lookups."""
        want = ends()
        t_w = time.perf_counter()
        while True:
            got = {int(p): int(e) for p, e in c.query("SELECT * FROM li_progress")[1]}
            if got == want:
                break
            check(time.perf_counter() - t_w < KAFKA_WAIT_S,
                  f"{what}: li_progress {got} short of the topic's ends {want}")
            time.sleep(0.02)
        waited = time.perf_counter() - t_w
        t_q = time.perf_counter()
        _check_q1_wire(c.query("SELECT * FROM q1")[1], None, f"{what}: Q1", q1_at[produced[0]])
        q1_ms = (time.perf_counter() - t_q) * 1e3
        ms = _check_lookups(c, keys, _lookup_oracle(snap + churn_parts[:produced[0]], keys),
                            f"{what}: lookups")
        lookup_ms.extend(ms)
        print(f"{what}: progress {waited:.3f} s, Q1 {q1_ms:.1f} ms, lookups p50 "
              f"{np.percentile(ms, 50):.1f} ms", file=sys.stderr, flush=True)
        return waited

    def sink_caught_up(what: str) -> float:
        want = _q1_sink_rows(q1_at[produced[0]])
        t_w = time.perf_counter()
        while tail.poll() != want:
            check(time.perf_counter() - t_w < KAFKA_WAIT_S,
                  f"{what}: q1.out consolidated != Q1's rows")
            time.sleep(0.005)
        return time.perf_counter() - t_w

    def decode_counts(e) -> tuple:
        m = e.metrics()
        return (m.get("mz_kafka_source_records_total", 0.0),
                m.get("mz_kafka_source_decode_seconds_total", 0.0))

    try:
        env = _Environmentd(root, device)
        out["environmentd_boot_s"] = env.boot_s
        stage("boot")
        c = PgClient(env.pg)
        c.query("SET metrics_report_ms = 50")
        t_ddl = time.perf_counter()
        c.query(KAFKA_SOURCE_SQL.format(broker=broker_dir))
        c.query(KAFKA_Q1_SQL)
        c.query(KAFKA_INDEX_SQL)
        c.query(KAFKA_PROGRESS_INDEX_SQL)
        c.query(KAFKA_SINK_SQL.format(broker=broker_dir))
        out["ddl_s"] = time.perf_counter() - t_ddl
        # Hydration: the source binds the snapshot's offsets
        # (MAX_RECORDS_PER_TICK a tick), Q1 answers it.
        caught_up(c, "kafka: after hydration")
        out["first_ddl_to_q1_s"] = time.perf_counter() - t_ddl
        explain = "\n".join(r[0] for r in c.query(
            f"EXPLAIN ANALYSIS SELECT l_linenumber FROM li WHERE l_orderkey = {keys[0]}")[1])
        check("peek: fast path: index lookup on 'li'" in explain,
              f"kafka: the lookups do not read the index: {explain[:600]}")
        out["sink_hydrate_s"] = sink_caught_up("kafka: q1.out after hydration")
        rec0, dec0 = decode_counts(env)
        out["snapshot_decode"] = {"records": rec0, "host_s": dec0,
                                  "records_per_s": rec0 / dec0 if dec0 else None}
        stage("hydrate")
        # Churn, and the replica's SIGKILL mid-span: the first ticks go
        # in at once, the replica is killed while it steps them, and an
        # orchestrator's restart respawns it on the same port and rid.
        produce(KAFKA_REPLICA_KILL_AT)
        # Killed once the source bound churn past the snapshot: the
        # replica is stepping the churn's spans.
        t_w = time.perf_counter()
        while sum(int(e) for _p, e in c.query("SELECT * FROM li_progress")[1]) <= \
                out["snapshot_records"]:
            check(time.perf_counter() - t_w < KAFKA_WAIT_S, "kafka: churn not ingested")
            time.sleep(0.01)
        counted.append(_replica_counts(env.metrics()))
        pids = env.replica_pids()
        check(len(pids) == 1, f"kafka: environmentd's replica processes {pids}")
        (pid,) = pids
        with open(f"/proc/{pid}/cmdline") as f:
            argv = [a for a in f.read().split("\0") if a]
        os.kill(pid, 9)
        t_kill = time.perf_counter()
        while _alive(pid):  # its port is free once it is gone
            time.sleep(0.01)
        with open(os.path.join(root, "replica_respawned.log"), "w") as rlog:
            replicas.append(subprocess.Popen(
                argv, stdout=rlog, stderr=subprocess.STDOUT,
                cwd=os.path.dirname(os.path.abspath(__file__)),
                env={**os.environ, "PYTHONUNBUFFERED": "1"}))
        produce(KAFKA_TICKS - KAFKA_REPLICA_KILL_AT)
        caught_up(c, "kafka: after the replica's SIGKILL and the churn")
        out["replica_kill_to_exact_s"] = time.perf_counter() - t_kill
        sink_caught_up("kafka: q1.out after the churn")
        rows = env.sql("SELECT object, replica, metric, value FROM mz_recovery "
                       "WHERE scope = 'dataflow' AND metric = 'rebuilds'")
        out["rebuilds_after_replica_kill"] = {r[0]: float(r[3]) for r in rows}
        check(set(out["rebuilds_after_replica_kill"]) == {"q1", "li_by_order", "li_progress_idx"}
              and not any(out["rebuilds_after_replica_kill"].values()),
              f"kafka: rebuilds after the replica's SIGKILL: {rows}")
        rec1, dec1 = decode_counts(env)
        out["churn_decode"] = {"records": rec1 - rec0, "host_s": dec1 - dec0,
                               "records_per_s": (rec1 - rec0) / (dec1 - dec0)
                               if dec1 > dec0 else None}
        stage("churn_and_replica_kill")
        # Paced ticks: a tick's append to its Q1 change in q1.out.
        paced_ms = []

        def paced(n: int) -> None:
            for _ in range(n):
                t_p = time.perf_counter()
                produce(1)
                sink_caught_up("kafka: a paced tick")
                paced_ms.append((time.perf_counter() - t_p) * 1e3)

        paced(KAFKA_KILL_AT)
        stage("paced")
        counted.append(_replica_counts(env.metrics()))
        # environmentd's kill -9, more ticks while it is down, --recover.
        # The source has bound every record so far: the new process must
        # fetch exactly the records past these offsets.
        bound = ends()
        got = {int(p): int(e) for p, e in c.query("SELECT * FROM li_progress")[1]}
        check(got == bound, f"kafka: li_progress {got} != the topic's ends {bound} at the kill")
        orphans = env.replica_pids()
        os.kill(env.proc.pid, 9)
        env.proc.wait(timeout=30)
        env._log.close()
        for p in replicas:  # the replica it served with outlives it
            _kill_wait(p)
        for pid in orphans:
            _sigkill(pid)
        bound_before = tail.offset
        produce(KAFKA_DOWN)
        t_rec = time.perf_counter()
        env = _Environmentd(root, device, recover=True, n=1)
        out["recovery_boot_s"] = env.boot_s
        check(env.recovery is not None
              and env.recovery["coordinator"]["replay_failures"] == 0
              and env.recovery["coordinator"]["catalog_replayed"] >= 4,
              f"kafka: recovery report {env.recovery}")
        c.close()
        c = PgClient(env.pg)
        c.query("SET metrics_report_ms = 50")
        caught_up(c, "kafka: after environmentd's kill -9")
        sink_caught_up("kafka: q1.out after recovery")
        out["recovery_s"] = time.perf_counter() - t_rec
        out["q1_out_records_before_kill"] = bound_before
        stage("kill9_and_recover")
        paced(KAFKA_PACED - KAFKA_KILL_AT)
        stage("paced_after_recovery")
        caught_up(c, "kafka: at the end")
        sink_caught_up("kafka: q1.out at the end")
        out["republished"] = tail.republished()
        check(out["republished"] == 0,
              f"kafka: {out['republished']} q1.out records published twice")
        n_rows = int(c.query("SELECT count(*) FROM li")[1][0][0])
        want_rows = int(sum(p[1].sum() for p in snap + churn_parts[:produced[0]]))
        check(n_rows == want_rows, f"kafka: li holds {n_rows} rows, the topic {want_rows}")
        out["li_rows"] = n_rows
        # The last snapshot the replica shipped (it ships every 50 ms and
        # keeps stepping the source's ticks: the counts never hold still).
        time.sleep(0.2)
        counted.append(_replica_counts(env.metrics()))
        rec2, dec2 = decode_counts(env)
        out["recovered_decode"] = {"records": rec2, "host_s": dec2}
        past = sum(ends().values()) - sum(bound.values())
        check(rec2 == past, f"kafka: the recovered source fetched {rec2} records, "
              f"{past} lie past the offsets it had bound")
        out.update({
            "churn_ticks": KAFKA_TICKS, "paced_ticks": KAFKA_PACED, "down_ticks": KAFKA_DOWN,
            "topic_records": sum(ends().values()), "tick_records_mean":
                float(np.mean(tick_records)),
            "paced_append_to_q1_out_ms_p50": float(np.percentile(paced_ms, 50)),
            "paced_append_to_q1_out_ms_p99": float(np.percentile(paced_ms, 99)),
            "q1_out_records": tail.offset,
            "lookups": len(lookup_ms),
            "lookup_ms_p50": float(np.percentile(lookup_ms, 50)),
            "lookup_ms_p99": float(np.percentile(lookup_ms, 99)),
        })
        c.close()
        stage("checks")
        env.stop()
        env = None
        stage("shutdown")
    except BaseException:
        # What the deployment said, for the failure's reader.
        for name in sorted(os.listdir(root)):
            if name.endswith(".log"):
                with open(os.path.join(root, name), errors="replace") as f:
                    print(f"--- {name} (tail)\n{f.read()[-6000:]}", file=sys.stderr)
        if env is not None and env.proc.poll() is None:
            for rel in ("mz_source_statuses", "mz_hydration_statuses",
                        "mz_wallclock_lag_summary", "mz_recovery"):
                try:
                    print(f"--- {rel}", env.sql(f"SELECT * FROM {rel}"), file=sys.stderr)
                except Exception as e:  # noqa: BLE001 - a diagnostic only
                    print(f"--- {rel}:", repr(e), file=sys.stderr)
            try:
                print("--- metrics", {k: v for k, v in env.metrics().items()
                                      if "step" in k or "kafka" in k or "span" in k},
                      file=sys.stderr)
            except Exception as e:  # noqa: BLE001 - a diagnostic only
                print("--- metrics:", repr(e), file=sys.stderr)
        raise
    finally:
        if env is not None:
            for pid in env.replica_pids():
                _sigkill(pid)
            _kill_wait(env.proc)
        for p in replicas:
            _kill_wait(p)
    shapes: dict = {}
    for _n, by, _peak in counted:
        for k, v in by.items():
            shapes[k] = shapes.get(k, 0) + v
    out["launches_by_generation"] = [n for n, _by, _peak in counted]
    out["launches"] = sum(out["launches_by_generation"])
    out["replica_peak_device_bytes"] = max(peak for _n, _by, peak in counted)
    out["by_shape"] = shapes
    return out


def phase_kafka(torch, merge_kernel, card) -> dict:
    """``kafka``: a Debezium CDC feed of TPC-H's lineitem through a Kafka
    source, Q1 exported through an exactly-once Kafka sink, a replica's
    SIGKILL and environmentd's kill -9 (module docstring, phase 7c)."""
    import tempfile

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        out = _kafka_run(root, "cuda", KAFKA_SF, SERVE_CHURN)
    check(out["launches"] > 0, "kafka: the replica processes launched no merge_path")
    res = {"phase": "kafka", "card": card, **{k: v for k, v in out.items() if k != "by_shape"},
           "by_shape_count": len(out["by_shape"]), "phase_s": time.perf_counter() - t0}
    emit(res)
    res["by_shape"] = out["by_shape"]
    return res


def phase_chaos(torch, merge_kernel, card) -> dict:
    """``chaos``: the chaos harness's storm (``testing/chaos.py``) with its
    replica process on the card: seed 3, 30 ticks, one blob operation in
    11 failing, connection kills, a partition, a mid-storm DDL and one
    SIGKILL of the replica, respawned on its port; the storm's three
    exact invariants (module docstring, phase 7d)."""
    import tempfile

    from materialize_tpu_torch.testing.chaos import ChaosDriver, seeded_fault_plan

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        drv = ChaosDriver(root, seed=3, subprocess_replica=True, blob_fail_every=11,
                          device="cuda")
        try:
            # The replica ships its metrics (launches by shape) every 50 ms.
            drv.ctl.update_configuration({"metrics_report_ms": 50})
            plan = seeded_fault_plan(3, 30, replica_kills=1)
            drv.run_storm(ticks=30, fault_plan=plan)
            rep = drv.verify(timeout=120.0)
            fams = drv.ctl.replica_metrics.get("r0", [])
        finally:
            drv.shutdown()
    samples = {}
    for _name, _kind, _help, ss in fams:
        for name, labels, v in ss:
            lab = ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))
            samples[f"{name}{{{lab},replica=\"r0\"}}" if lab else f'{name}{{replica="r0"}}'] = v
    launches, shapes, peak = _replica_counts(samples)
    mv = rep.recovery["dataflows"]["mv_sums"]["r0"]
    check(rep.ok, f"chaos: {rep.failures}")
    check(rep.replica_kills == 1 and rep.conn_kills >= 1 and rep.partitions >= 1,
          f"chaos: faults landed {rep.replica_kills} kills, {rep.conn_kills} connection "
          f"kills, {rep.partitions} partitions")
    check(mv["rebuilds"] == 0, f"chaos: mv_sums rebuilt {mv}")
    check(launches > 0, "chaos: the respawned replica launched no merge_path")
    res = {"phase": "chaos", "card": card, "seed": 3, "ticks": rep.ops,
           "blob_fail_every": rep.blob_fail_every, "plan": {str(k): v for k, v in plan.items()},
           "inserts": rep.inserts, "retractions": rep.retractions, "late": rep.late,
           "acked_times": rep.acked_times, "replica_kills": rep.replica_kills,
           "conn_kills": rep.conn_kills, "partitions": rep.partitions,
           "recovery": rep.recovery, "oracle_groups": len(rep.oracle),
           "storm_s": rep.elapsed_s, "launches": launches, "replica_peak_device_bytes": peak,
           "by_shape_count": len(shapes), "phase_s": time.perf_counter() - t0}
    emit(res)
    res["by_shape"] = shapes
    return res


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Drive the port on one CUDA card.")
    ap.add_argument("--serve-only", action="store_true",
                    help="the build, the bare q1 cell, the serving phases (serve "
                         "also with span_pipelining on) and deploy; no kernels line, "
                         "no ok line")
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
        serve, _rows = serve_phases(torch, merge_kernel, card, q1)
        mark("serve")
        phase_deploy(torch, merge_kernel, card, serve[0])
        mark("deploy")
        kafka = phase_kafka(torch, merge_kernel, card)
        phase_path_kernel(torch, merge_kernel, card, kafka["by_shape"], "kafka_kernel_shape",
                          half_full)
        mark("kafka")
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
    paths["sharded"] = phase_sharded(torch, merge_kernel, card)
    rows_by_path["sharded"] = phase_path_kernel(torch, merge_kernel, card,
                                                paths["sharded"]["by_shape"],
                                                "sharded_kernel_shape", half_full)
    mark("sharded")
    (paths["serve"], paths["serve_pipelined"]), rows_by_path["serve"] = serve_phases(
        torch, merge_kernel, card, paths["q1"])
    mark("serve+kernel_shape+vs_plain")
    paths["deploy"] = phase_deploy(torch, merge_kernel, card, paths["serve"])
    mark("deploy")
    paths["kafka"] = phase_kafka(torch, merge_kernel, card)
    rows_by_path["kafka"] = phase_path_kernel(torch, merge_kernel, card,
                                              paths["kafka"]["by_shape"], "kafka_kernel_shape",
                                              half_full)
    mark("kafka")
    paths["chaos"] = phase_chaos(torch, merge_kernel, card)
    rows_by_path["chaos"] = phase_path_kernel(torch, merge_kernel, card,
                                              paths["chaos"]["by_shape"], "chaos_kernel_shape",
                                              half_full)
    mark("chaos")
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
    # One lineitem hydrate tick (4,096 orders hold SF 0.002's 3,000).
    phase_path_modes(torch, merge_kernel, card, "q9_vs_plain_path",
                     lambda **kw: q9_presized(churn_ticks=8, hydrate_orders=4096, **kw),
                     sf=0.002, span_ticks=8)
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
    # 4 churn ticks, not 16: the script's time limit (PERF.md §4).
    paths["pagerank"] = phase_pagerank(
        torch, merge_kernel, card, "pagerank", n_nodes=2000, n_edges=10000,
        per_tick=64, state_cap=1 << 14, ticks_churn=4, span_churn=4, profile_ticks=1,
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
                     lambda **kw: q21_presized(churn_ticks=8, hydrate_orders=4096, **kw),
                     sf=0.002, span_ticks=8)
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
