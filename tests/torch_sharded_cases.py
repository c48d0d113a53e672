"""The cases of the sharded-dataflow parity tests (``test_torch_sharded``
and its 4-rank file), in a module the spawned ranks can import: it
imports neither JAX nor the reference at module level, so a rank loads
only torch and the port.

- ``ops_expr``: one dataflow whose union holds every exchange site of
  the render layer: SUM and COUNT by key, MIN and MAX, a Distinct, a
  TopK, a three-input delta join, a two-input linear join, a Constant
  under a Reduce, and a Threshold. One plan keeps the reference to one
  step program per world size.
- ``agg_expr``: a LetRec (transitive closure) joined with a table of
  names, under a STRING_AGG by source node.
- ``index_expr``: the bare ``Get`` index at ``state_cap`` 2^14 with an
  explicit slot ring (the multichip bench's configuration), whose
  ingest mode is ``append_slot``.

``*_ticks`` make seeded numpy ticks; ``batches`` turns a tick into
either package's batches. The MIN/MAX ticks carry a burst of one key
that overflows the exchange's 256-row send slot, so each world size
grows the slot tier once and replays.
"""

from __future__ import annotations

import importlib

import numpy as np

PKGS = {"ref": "materialize_tpu", "port": "materialize_tpu_torch"}


def _m(pkg: str, name: str):
    return importlib.import_module(f"{PKGS[pkg]}.{name}")


def schemas(pkg: str) -> dict:
    s = _m(pkg, "repr.schema")
    C, T = s.Column, s.ColumnType
    return {
        "in": s.Schema([C("k", T.INT64), C("v", T.INT64)]),
        "in2": s.Schema([C("k", T.INT64), C("w", T.INT64)]),
        "in3": s.Schema([C("k", T.INT64), C("z", T.INT64)]),
        "edges": s.Schema([C("src", T.INT64), C("dst", T.INT64)]),
        "names": s.Schema([C("id", T.INT64), C("name", T.STRING)]),
        "idx": s.Schema([C("k", T.INT64), C("v", T.INT64)]),
    }


def ops_expr(pkg: str, two_reduces: bool = False):
    """The union of every exchange site (see the module docstring). With
    ``two_reduces``: only SUM/COUNT and MIN/MAX by key over one input,
    the plan the reference's sharded dataflow gets wrong."""
    rel, sc = _m(pkg, "expr.relation"), _m(pkg, "expr.scalar")
    A, F = rel.AggregateExpr, rel.AggregateFunc
    S = schemas(pkg)
    i1, i2, i3 = (rel.Get(n, S[n]) for n in ("in", "in2", "in3"))
    zero = sc.lit(0)

    def tagged(tag, expr, cols):
        """(tag, a, b, c) rows: ``cols`` are column indices or None (0)."""
        n = expr.schema().arity
        scalars = [sc.lit(tag)] + [zero]
        m = expr.map(tuple(scalars))
        pick = [n] + [n + 1 if c is None else c for c in cols]
        return m.project(tuple(pick))

    k0 = sc.ColumnRef(0)
    if two_reduces:
        return rel.Union((
            tagged(1, i1.reduce((0,), (A(F.SUM_INT, sc.col(1)), A(F.COUNT, sc.col(1)))),
                   (0, 1, 2)),
            tagged(2, i1.reduce((0,), (A(F.MIN, sc.col(1)), A(F.MAX, sc.col(1)))),
                   (0, 1, 2)),
        ))
    branches = [
        tagged(1, i1.reduce((0,), (A(F.SUM_INT, sc.col(1)), A(F.COUNT, sc.col(1)))),
               (0, 1, 2)),
        tagged(3, i1.distinct(), (0, 1, None)),
        tagged(4, rel.TopK(i1, (0,), ((1, True, True),), 2), (0, 1, None)),
        tagged(5, rel.Join((i1, i2, i3), ((k0, sc.ColumnRef(2), sc.ColumnRef(4)),)),
               (1, 3, 5)),
        tagged(6, rel.Join((i1, i2), ((k0, sc.ColumnRef(2)),)), (0, 1, 3)),
        tagged(7, rel.Constant((((1, 10), 1), ((1, 20), 1), ((2, 5), 1)), S["in"])
               .reduce((0,), (A(F.SUM_INT, sc.col(1)),)), (0, 1, None)),
        tagged(8, rel.Union((i1.project((0,)), i2.project((0,)).negate())).threshold(),
               (0, None, None)),
    ]
    return rel.Union(tuple(branches))


def minmax_expr(pkg: str):
    """MIN and MAX by key. Its own plan: the reference's sharded dataflow
    goes wrong when this Reduce and the SUM/COUNT one read one input
    (``test_torch_sharded_fault.py``)."""
    rel, sc = _m(pkg, "expr.relation"), _m(pkg, "expr.scalar")
    A, F = rel.AggregateExpr, rel.AggregateFunc
    i1 = rel.Get("in", schemas(pkg)["in"])
    return i1.reduce((0,), (A(F.MIN, sc.col(1)), A(F.MAX, sc.col(1))))


def agg_expr(pkg: str):
    rel, sc = _m(pkg, "expr.relation"), _m(pkg, "expr.scalar")
    A, F = rel.AggregateExpr, rel.AggregateFunc
    S = schemas(pkg)
    edges, reach = rel.Get("edges", S["edges"]), rel.Get("reach", S["edges"])
    step = rel.Join((reach, edges), ((sc.ColumnRef(1), sc.ColumnRef(2)),)).project((0, 3))
    value = rel.Union((edges, step)).distinct()
    tc = rel.LetRec(names=("reach",), values=(value,), value_schemas=(S["edges"],),
                    body=rel.Get("reach", S["edges"]))
    named = rel.Join((tc, rel.Get("names", S["names"])),
                     ((sc.ColumnRef(1), sc.ColumnRef(2)),)).project((0, 3))
    return named.reduce((0,), (A(F.STRING_AGG, sc.col(1), params=(",",)),
                               A(F.COUNT, sc.col(1))))


def index_expr(pkg: str):
    rel = _m(pkg, "expr.relation")
    return rel.Get("idx", schemas(pkg)["idx"])


INDEX_KW = {"state_cap": 1 << 14, "out_levels": 3, "out_slots": 8}


def ops_ticks(world: int, seed: int = 29) -> list:
    """Three ticks of {input: (cols, diffs)} over keys 0-11: random rows,
    more rows, then retractions. Every tier holds."""
    rng = np.random.default_rng(seed)

    def rows(n, keys=12):
        return [rng.integers(0, keys, n), rng.integers(-40, 40, n)]

    t0 = {n: (rows(40), np.ones(40, np.int64)) for n in ("in", "in2", "in3")}
    t1 = {"in": (rows(30), np.ones(30, np.int64)), "in2": (rows(20), np.ones(20, np.int64))}
    k, v = t0["in"][0]
    t2 = {"in": ([k[:30], v[:30]], -np.ones(30, np.int64)),
          "in3": (rows(10), np.ones(10, np.int64))}
    return [t0, t1, t2]


def burst_ticks(world: int, seed: int = 37) -> list:
    """Three ticks over keys 0-11 with, on the second, a burst of key 99
    past every sender's 256-row send slot: the exchange overflows, the
    slot tier grows and the tick replays."""
    rng = np.random.default_rng(seed)
    burst = 260 * world
    k0, v0 = rng.integers(0, 12, 80), rng.integers(-40, 40, 80)
    return [
        {"in": ([k0, v0], np.ones(80, np.int64))},
        {"in": ([np.concatenate([np.full(burst, 99), rng.integers(0, 12, 20)]),
                 rng.integers(-40, 40, burst + 20)], np.ones(burst + 20, np.int64))},
        {"in": ([k0[:40], v0[:40]], -np.ones(40, np.int64))},
    ]


NAMES = ("ada", "bo", "cy", "di", "ed", "flo", "gus", "hal", "ivy", "jo", "kit", "lu")


def agg_ticks(seed: int = 31) -> list:
    """Edges over 12 nodes and their names: a random graph, more edges,
    then a retraction of the first tick's edges."""
    rng = np.random.default_rng(seed)
    e0 = np.unique(rng.integers(0, 12, (14, 2)), axis=0)
    e1 = np.unique(rng.integers(0, 12, (6, 2)), axis=0)
    names = (np.arange(12), np.asarray(NAMES, dtype=object))
    return [
        {"edges": ([e0[:, 0], e0[:, 1]], np.ones(len(e0), np.int64)),
         "names": ([names[0], names[1]], np.ones(12, np.int64))},
        {"edges": ([e1[:, 0], e1[:, 1]], np.ones(len(e1), np.int64))},
        {"edges": ([e0[:4, 0], e0[:4, 1]], -np.ones(4, np.int64))},
    ]


def index_ticks(seed: int = 42, ticks: int = 4, n: int = 96) -> list:
    """The multichip bench's stream: keys 0-1023, values 0-15, diffs
    drawn from {+1, +1, +1, -1}."""
    rng = np.random.default_rng(seed)
    return [{"idx": ([rng.integers(0, 1024, n), rng.integers(0, 16, n)],
                     rng.choice(np.asarray([1, 1, 1, -1]), n))} for _ in range(ticks)]


INPUTS = {"ops": ("in", "in2", "in3"), "minmax": ("in",), "agg": ("edges", "names"),
          "index": ("idx",)}


def batches(pkg: str, tick: dict, time: int, device=None, inputs=()) -> dict:
    """One tick as ``pkg``'s batches, an empty batch for each of
    ``inputs`` the tick leaves out; string columns are encoded in that
    package's dictionary."""
    b_mod, s_mod = _m(pkg, "repr.batch"), _m(pkg, "repr.schema")
    S = schemas(pkg)
    out = {}
    tick = dict(tick)
    for name in inputs:
        if name not in tick:
            tick[name] = ([np.zeros(0, col.dtype) for col in S[name].columns],
                          np.zeros(0, np.int64))
    for name, (cols, diffs) in tick.items():
        sch = S[name]
        cols = [
            s_mod.GLOBAL_DICT.encode_many(list(c)) if col.ctype is s_mod.ColumnType.STRING
            else np.asarray(c, dtype=col.dtype)
            for c, col in zip(cols, sch.columns)
        ]
        n = len(diffs)
        kw = {} if device is None else {"device": device}
        out[name] = b_mod.Batch.from_numpy(sch, cols, np.full(n, time, np.uint64),
                                           np.asarray(diffs, np.int64), **kw)
    return out


def net(rows) -> list:
    """(col..., time, diff) rows as sorted (col..., net diff), zero nets
    dropped (shards may hold one row at different times)."""
    acc: dict = {}
    for r in rows:
        acc[r[:-2]] = acc.get(r[:-2], 0) + r[-1]
    return sorted(k + (d,) for k, d in acc.items() if d != 0)


CASES = {
    "ops": (ops_expr, {"output_cap": 4096}, ops_ticks),
    "minmax": (minmax_expr, {}, burst_ticks),
    "agg": (agg_expr, {}, lambda world: agg_ticks()),
    "index": (index_expr, INDEX_KW, lambda world: index_ticks()),
}


# The plan the reference's sharded dataflow gets wrong (not a case of the
# parity suite: ``test_torch_sharded_fault.py``).
FAULT = (lambda pkg: ops_expr(pkg, two_reduces=True), {}, ops_ticks)
INPUTS["fault"] = ("in", "in2", "in3")


def run_port_rank(mesh, names: tuple) -> dict:
    """A spawned rank's run of the named cases: every tick through a
    port ``ShardedDataflow``, the net peek after each tick, then the
    sharding report, the grown tier keys and the collective calls."""
    import torch

    torch.set_num_threads(1)
    from materialize_tpu_torch.render.dataflow import ShardedDataflow

    out = {}
    for name in names:
        make, kw, ticks = FAULT if name == "fault" else CASES[name]
        sdf = ShardedDataflow(make("port"), mesh, name=name, **kw)
        peeks = []
        for t, tick in enumerate(ticks(mesh.world_size)):
            sdf.step(batches("port", tick, t, device="cpu", inputs=INPUTS[name]))
            peeks.append(net(sdf.peek()))
        out[name] = {
            "peeks": peeks,
            "errors": sdf.peek_errors(),
            "report": sdf.sharding_report(),
            "grown": list(sdf._grown),
            "letrec_evals": sdf._ctx.letrec_evals[-1] if sdf._ctx.letrec_evals else 0,
        }
    return out


# -- the exchange alone (``test_torch_parallel.py``) ---------------------------

EXCHANGE_CAP = 64


def exchange_schema(pkg: str):
    s = _m(pkg, "repr.schema")
    return s.Schema([s.Column("k", s.ColumnType.INT64, True),
                     s.Column("v", s.ColumnType.INT64)])


def exchange_inputs(world: int, seed: int) -> list:
    """Per worker: (keys, null flags, values, diffs), seeded, with NULL
    keys and retractions, at most ``EXCHANGE_CAP`` rows each."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(world):
        n = int(rng.integers(0, EXCHANGE_CAP - 3))
        out.append((rng.integers(0, 40, n), rng.random(n) < 0.15,
                    rng.integers(0, 1000, n), rng.choice(np.asarray([1, 1, -1]), n)))
    return out


def boundary_inputs(world: int, fill: int) -> list:
    """Every worker sends ``fill`` rows of one key (all to its owner)."""
    return [(np.full(fill, 3), np.zeros(fill, bool), np.arange(fill), np.ones(fill, np.int64))
            for _ in range(world)]


def exchange_rank(mesh, trials: list) -> list:
    """A spawned rank's exchanges: for each (inputs, slot_cap, key) of
    ``trials``, this rank's rows through the port's ``exchange``;
    returns (received keys, null flags, values, diffs, overflow)."""
    import torch

    torch.set_num_threads(1)
    from materialize_tpu_torch.parallel.exchange import exchange
    from materialize_tpu_torch.repr.batch import Batch

    sch = exchange_schema("port")
    out = []
    for inputs, slot_cap, null_aware in trials:
        k, nl, v, d = inputs[mesh.rank]
        b = Batch.from_numpy(sch, [k, v], np.zeros(len(d), np.uint64), d,
                             capacity=EXCHANGE_CAP, nulls=[nl, None], device="cpu")
        routed, ovf = exchange(b, (0,), mesh, mesh.world_size, slot_cap, null_aware)
        n = int(routed.count)
        out.append((routed.cols[0][:n].numpy(), routed.nulls[0][:n].numpy(),
                    routed.cols[1][:n].numpy(), routed.diff[:n].numpy(), bool(ovf)))
    return out


def failing_rank(mesh):
    """Rank 1 raises; rank 0 waits in a collective the launcher must not
    wait out."""
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    mesh.barrier()
