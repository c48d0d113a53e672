"""PageRank as WITH MUTUALLY RECURSIVE (the port of
``materialize_tpu/workloads/pagerank.py``) and ``pagerank_config``, the
port's counterpart of the reference bench's ``config_pagerank``
(``bench.py:347-391``).

    ranks(n, r) := SELECT n, SUM(c) FROM (
        SELECT n, 0.15 AS c FROM nodes
        UNION ALL
        SELECT e.dst, 0.85 * r.rank / d.deg
        FROM ranks r JOIN out_deg d ON r.n = d.n
                     JOIN edges  e ON r.n = e.src
    ) GROUP BY n

iterated to ``max_iters`` value evaluations (a float fixpoint stops on
the cap: RETURN AT RECURSION LIMIT). The bench renders the plan as it
is, without the optimizer, and so does the port. ``pagerank_tiers``
sizes the dataflow's tiers for a graph and a number of ticks up front,
so no tick doubles them one by one through a rollback and a replay of
up to ``max_iters`` evaluations apiece.
"""

from __future__ import annotations

import numpy as np

from ..arrangement.spine import Spine
from ..expr import relation as mir
from ..expr.relation import AggregateExpr, AggregateFunc
from ..expr.scalar import BinaryFunc, CallBinary, ColumnRef, col, lit
from ..plan.decisions import quantize_cap
from ..render.dataflow import Dataflow
from ..repr.batch import Batch, capacity_tier
from ..repr.schema import Column, ColumnType, Schema

EDGE_SCHEMA = Schema([Column("src", ColumnType.INT64), Column("dst", ColumnType.INT64)])


def pagerank_mir(edge_schema: Schema, max_iters: int = 25) -> mir.RelationExpr:
    """rank(n) = 0.15 + 0.85 * sum_{m->n} rank(m) / out_deg(m) over
    edges (src int64, dst int64). Output: (n, rank float64)."""
    edges = mir.Get("edges", edge_schema)
    out_deg = edges.reduce((0,), (AggregateExpr(AggregateFunc.COUNT, col(1)),))
    # Every node, sink-only ones included, gets the base rank.
    nodes = mir.Union((edges.project((0,)), edges.project((1,)))).distinct()
    base = nodes.map((lit(0.15),))
    rank_schema = Schema([edge_schema[0], Column("rank", ColumnType.FLOAT64, True)])
    ranks = mir.Get("ranks", rank_schema)
    # (n, r) ⋈ (n, deg) -> (n, r, n, deg); ⋈ (src, dst) on n = src -> 6 cols
    r_with_deg = mir.Join((ranks, out_deg), ((ColumnRef(0), ColumnRef(2)),))
    r_deg_edges = mir.Join((r_with_deg, edges), ((ColumnRef(0), ColumnRef(4)),))
    per_edge = CallBinary(BinaryFunc.DIV, col(1) * lit(0.85), col(3))
    contrib = r_deg_edges.map((per_edge,)).project((5, 6))
    value = mir.Union((base, contrib)).reduce(
        (0,), (AggregateExpr(AggregateFunc.SUM_FLOAT, col(1)),)
    )
    return mir.LetRec(
        names=("ranks",),
        values=(value,),
        value_schemas=(rank_schema,),
        body=mir.Get("ranks", rank_schema),
        max_iters=max_iters,
    )


def pagerank_tiers(df, n_nodes: int, n_edges: int, per_tick: int, ticks: int) -> dict:
    """Tiers (``apply_tiers``'s dict) for ``ticks`` ticks of pagerank over
    ``n_edges`` edges on ``n_nodes`` nodes, ``per_tick`` rewired a tick.

    Every rank can change in every evaluation, so a binding delta, the
    join on the degrees and the output delta hold up to 2 rows a node,
    and the join into the edges up to 2 rows an edge (plus the rewired
    edges against every rank row of their source). The ranks-side join
    spines grow by up to 2 rows a node a tick: a tick stopped by
    ``max_iters`` leaves its last evaluation's delta out of them (the
    reference's LetRec does the same), so last tick's retraction of a
    rank finds the value before it. Their tails hold ``ce`` ticks of
    that between folds plus two deltas in flight; their bases all of it.
    The edge spine's tail holds the hydrated edges until the first fold.
    The output holds one row a node, its tail two ticks' worth, and the
    run a slot ring flushes into ``ce`` ticks' worth."""
    ce = df._compact_every
    n, e, p = n_nodes, n_edges, per_tick
    tail, base = 2 * n * (ce + 2), n + 2 * n * (ticks + ce + 2)
    edges = e + 2 * p * (ce + 1)
    grow = []
    for slot, parts in enumerate(df.states):
        for part, sp in enumerate(parts):
            if not isinstance(sp, Spine):
                continue
            names = sp.schema.names
            if names == EDGE_SCHEMA.names:
                sizes = (edges, edges)
            elif ColumnType.FLOAT64 in (c.ctype for c in sp.schema.columns):
                sizes = (tail, base)
            else:  # the degrees: one row a node
                sizes = (2 * n, 2 * n)
            grow += [[("state", slot, (part, "tail")), sizes[0]],
                     [("state", slot, (part, sp.levels - 1)), sizes[1]]]
    # A slotted output flushes ``ce`` ticks of deltas into run 0 at once.
    out_runs = n + 2 * n * (ce + 1) if df.output.slots else 4 * n
    grow += [[("out", "tail"), 4 * n]]
    grow += [[("out", r), out_runs] for r in range(df.output.levels)]
    return {"grow": grow,
            "join_caps": [2 * n, 2 * e + 2 * p * (2 * ticks + 1)],
            "letrec_caps": [2 * n], "out_delta_cap": quantize_cap(2 * n)}


def pagerank_config(n_nodes: int = 2000, n_edges: int = 10000, per_tick: int = 64,
                    max_iters: int = 60, state_cap: int = 1 << 14, seed: int = 42,
                    device=None):
    """The bench's pagerank configuration (its defaults are the bench's
    sizes): ``n_edges`` random edges over ``n_nodes`` nodes from
    ``default_rng(seed)``; churn tick ``i`` rewires ``per_tick`` edges
    drawn by ``default_rng(1000 + i)``, each as a retraction and an
    insertion. Returns (df, hydrate, churn, edges): ``edges()`` is the
    current (src, dst) edge list on the host."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_nodes, n_edges).astype(np.int64)
    dst = rng.integers(0, n_nodes, n_edges).astype(np.int64)
    df = Dataflow(pagerank_mir(EDGE_SCHEMA, max_iters=max_iters), state_cap=state_cap,
                  device=device)

    def hydrate():
        return [{"edges": Batch.from_numpy(EDGE_SCHEMA, [src, dst], np.uint64(0),
                                           np.ones(n_edges, np.int64), device=device)}]

    def churn(i: int, t: int):
        rng2 = np.random.default_rng(1000 + i)
        idx = rng2.choice(n_edges, per_tick, replace=False)
        new_dst = rng2.integers(0, n_nodes, per_tick).astype(np.int64)
        cols = [np.concatenate([src[idx], src[idx]]),
                np.concatenate([dst[idx], new_dst])]
        diffs = np.concatenate([np.full(per_tick, -1, np.int64),
                                np.ones(per_tick, np.int64)])
        dst[idx] = new_dst
        b = Batch.from_numpy(EDGE_SCHEMA, cols, np.uint64(t), diffs,
                             capacity=capacity_tier(2 * per_tick), device=device)
        return {"edges": b}, 2 * per_tick

    def edges():
        return src.copy(), dst.copy()

    return df, hydrate, churn, edges
