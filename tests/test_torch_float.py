"""Port parity for FLOAT64: lanes, scalar evaluation and SUM_FLOAT.

1. ``ops/lanes.py:column_lanes`` on FLOAT64 equals the reference's
   ``_f64_lanes`` bit for bit on seeded doubles across the whole
   exponent range and on the edges: +-0 (one bucket), +-inf, NaN of
   either sign, the subnormals, 2^-1022, 2^+-1023 and the largest
   double. The reference's eager function flushes the subnormals into
   the zero bucket; under ``jax.jit`` its fused code keeps that bucket's
   first lane but not its second, so the jitted function is held on
   every value but the subnormals. The port's ``host_lane_encode``
   equals the device lanes, null lane included.
2. ``eval_expr`` on FLOAT64 against the reference on the same seeded
   columns with NULLs, zero divisors, NaN and infinities: float
   ADD/SUB/MUL/DIV with INT64 and DECIMAL operands coerced (pagerank's
   ``0.85 * r / deg`` among them), MOD, POWER and LOG_BASE (their NULL
   rows), comparisons across types, and EXTRACT EPOCH and SECOND on
   DATE and TIMESTAMP. NULL masks and division-by-zero masks are
   compared exactly, padding rows included, and so are the values,
   but for POWER's: XLA's ``pow`` and torch's are different
   implementations (neither is correctly rounded, and numpy's differs
   from both), so its values hold within 2^-50 relative, a few ulp,
   after flushing subnormal results to zero (XLA's CPU code flushes
   them; torch keeps them).
3. ``ReduceOp.step`` with SUM_FLOAT beside COUNT over five steps of
   inserts and retractions on a nullable key, with NULL values: the
   state (float sums bit for bit) and the output delta equal the jitted
   reference op's after every step.
4. The same step with one key holding most rows (a hub, as a skewed
   graph's high in-degree node gives pagerank): equal to the reference
   at every hub size, and the port's eager operations grow by the same
   count for every row the hub gains, with one readback of the longest
   run per step. That is the cost of the row-order float sum.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from materialize_tpu.expr import errors as jerrors
from materialize_tpu.expr import relation as jmir
from materialize_tpu.expr import scalar as js
from materialize_tpu.ops.lanes import _f64_lanes
from materialize_tpu.ops.reduce import ReduceOp as JReduceOp
from materialize_tpu.repr import schema as jschema
from materialize_tpu.repr.batch import Batch as JBatch
from materialize_tpu_torch.expr import relation as tmir
from materialize_tpu_torch.expr import scalar as ts
from materialize_tpu_torch.ops.lanes import column_lanes, host_lane_encode, key_lanes, to_u64
from materialize_tpu_torch.ops import reduce as treduce
from materialize_tpu_torch.ops.reduce import ReduceOp as TReduceOp
from materialize_tpu_torch.repr import schema as tschema
from materialize_tpu_torch.repr.batch import Batch as TBatch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's eager ops here are small: one intra-op thread runs them
    about as fast, and does not contend with other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SUBNORMALS = np.array([5e-324, -5e-324, 1e-310, -1e-310, 2.0**-1023,
                       2.225073858507201e-308], dtype=np.float64)
EDGES = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 1.0, -1.0, 1.5, 0.1, -0.1,
                  2.0**-1022, -(2.0**-1022), 2.0**1023, -(2.0**1023),
                  np.finfo(np.float64).max, -np.finfo(np.float64).max], dtype=np.float64)


def _doubles(seed=5, n=2000):
    rng = np.random.default_rng(seed)
    mant = rng.standard_normal(n)
    vals = mant * 10.0 ** rng.integers(-323, 308, n).astype(np.float64)
    return np.concatenate([vals, EDGES, SUBNORMALS])


def test_f64_lanes_match_reference_bit_for_bit():
    vals = _doubles()
    t1, t2 = column_lanes(torch.from_numpy(vals), tschema.ColumnType.FLOAT64)
    j1, j2 = _f64_lanes(jnp.asarray(vals))
    assert np.array_equal(to_u64(t1), np.asarray(j1))
    assert np.array_equal(to_u64(t2), np.asarray(j2))
    # subnormals (the seeded ones among them) share the zero bucket
    sub = (np.abs(vals) < 2.0**-1022) & (vals != 0.0)
    assert sub.sum() > len(SUBNORMALS)
    zero = (vals == 0.0) | sub
    assert set(to_u64(t1)[zero].tolist()) == {2201}
    assert set(to_u64(t2)[zero].tolist()) == {0}
    normal = ~sub
    k1, k2 = jax.jit(_f64_lanes)(jnp.asarray(vals[normal]))
    assert np.array_equal(to_u64(t1)[normal], np.asarray(k1))
    assert np.array_equal(to_u64(t2)[normal], np.asarray(k2))


def test_f64_lanes_order_is_sql_order():
    vals = np.concatenate([_doubles(seed=9, n=500), EDGES])
    vals = vals[~np.isnan(vals)]
    l1, l2 = column_lanes(torch.from_numpy(vals), tschema.ColumnType.FLOAT64)
    order = np.lexsort((l2.numpy(), l1.numpy()))  # stored form: signed order
    # the subnormals sort as zeros
    ordered = np.where(np.abs(vals) < 2.0**-1022, 0.0, vals)[order]
    assert np.all(ordered[1:] >= ordered[:-1])


def test_host_lane_encode_matches_device_lanes():
    vals = _doubles(seed=6, n=300)
    nulls = np.random.default_rng(1).random(len(vals)) < 0.2
    col = tschema.Column("f", tschema.ColumnType.FLOAT64, True)
    b = TBatch.from_numpy(tschema.Schema([col]), [vals], np.zeros(len(vals), np.uint64),
                          np.ones(len(vals), np.int64), nulls=[nulls], device="cpu")
    n = len(vals)
    dev = [to_u64(l)[:n] for l in key_lanes(b, (0,))]
    host = host_lane_encode(vals, col, nulls)
    assert len(dev) == len(host) == 3
    for d, h in zip(dev, host):
        assert np.array_equal(d, h)
    plain = host_lane_encode(vals, tschema.Column("f", tschema.ColumnType.FLOAT64))
    assert len(plain) == 2
    for p, h in zip(plain, host[1:]):
        assert np.array_equal(p[~nulls], h[~nulls])


# -- scalar evaluation ----------------------------------------------------------

N, CAP = 300, 512
COLUMNS = [
    ("f", "FLOAT64", True, 0),
    ("i", "INT64", True, 0),
    ("d", "DECIMAL", True, 2),
    ("day", "DATE", True, 0),
    ("ts", "TIMESTAMP", True, 0),
    ("g", "FLOAT64", False, 0),
]


def _schema(mod):
    return mod.Schema([mod.Column(n, mod.ColumnType[t], nl, sc) for n, t, nl, sc in COLUMNS])


def _data(seed=13):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal(N) * 10.0 ** rng.integers(-3, 4, N)
    f[:12] = [0.0, -0.0, np.nan, np.inf, -np.inf, 1.0, 2.0, -2.0, 0.5, 1e300, -1e-300, 3.0]
    g = rng.uniform(-4.0, 4.0, N)
    g[:6] = [0.0, 1.0, 0.5, -0.5, 2.0, 0.0]
    cols = [
        f,
        rng.integers(-3, 4, N),                      # zero divisors
        rng.integers(-500, 500, N) * 25,             # zero divisors at scale 2
        rng.integers(-800_000, 800_000, N).astype(np.int32),
        rng.integers(-(1 << 41), 1 << 41, N),
        g,
    ]
    nulls = [rng.random(N) < 0.15 if nl else None for _, _, nl, _ in COLUMNS]
    return cols, nulls, rng.integers(0, 5, N).astype(np.uint64), np.ones(N, np.int64)


@pytest.fixture(scope="module")
def batches():
    cols, nulls, time, diff = _data()
    j = JBatch.from_numpy(_schema(jschema), cols, time, diff, capacity=CAP, nulls=nulls)
    t = TBatch.from_numpy(_schema(tschema), cols, time, diff, capacity=CAP, nulls=nulls,
                          device="cpu")
    return j, t


def _exprs(m):
    c, lit = m.col, m.lit
    F, U = m.BinaryFunc, m.UnaryFunc

    def call(f, a, b):
        return m.CallBinary(f, a, b)

    return {
        "pagerank_contrib": call(F.DIV, c(0) * lit(0.85), c(1)),
        "float_div_int": call(F.DIV, c(0), c(1)),
        "int_div_float": call(F.DIV, c(1), c(5)),
        "float_div_decimal": call(F.DIV, c(0), c(2)),
        "float_div_float": call(F.DIV, c(5), c(0)),
        "float_add_int": c(0) + c(1),
        "float_sub_decimal": c(5) - c(2),
        "float_mul_literal": c(5) * lit(0.15),
        "literal_float": lit(0.15) + c(0),
        "null_float_literal": c(0) + lit(None, m.ColumnType.FLOAT64),
        "float_mod_int": call(F.MOD, c(0), c(1)),
        "float_mod_float": call(F.MOD, c(5), c(0)),
        "power": call(F.POWER, c(5), lit(2.0)),
        "power_bad": call(F.POWER, c(5), c(0)),
        "log_base": call(F.LOG_BASE, c(5), c(0)),
        "log_base_int": call(F.LOG_BASE, lit(2.0), c(1)),
        "float_lt_int": c(0).lt(c(1)),
        "float_eq_decimal": c(5).eq(c(2)),
        "float_gte_literal": c(0).gte(lit(1.5)),
        "is_null_div": m.CallUnary(U.IS_NULL, call(F.DIV, c(0), c(1))),
        "epoch_date": m.CallUnary(U.EXTRACT_EPOCH, c(3)),
        "epoch_timestamp": m.CallUnary(U.EXTRACT_EPOCH, c(4)),
        "second_date": m.CallUnary(U.EXTRACT_SECOND, c(3)),
        "second_timestamp": m.CallUnary(U.EXTRACT_SECOND, c(4)),
    }


# XLA's pow and torch's differ in the last bits (see the docstring).
POW_REL = 2.0**-50


def _same(jv, tv):
    a, b = np.asarray(jv), tv.numpy()
    assert a.dtype == b.dtype
    if a.dtype == np.float64:
        # bit for bit, every NaN alike
        a = np.where(np.isnan(a), np.nan, a)
        b = np.where(np.isnan(b), np.nan, b)
        assert np.array_equal(a.view(np.int64), b.view(np.int64))
    else:
        assert np.array_equal(a, b)


@pytest.mark.parametrize("name", list(_exprs(js)))
def test_float_eval_expr_matches_reference(batches, name):
    jb, tb = batches
    jex, tex = _exprs(js)[name], _exprs(ts)[name]
    with jerrors.collect() as jmasks:
        jev = js.eval_expr(jex, jb)
    tmasks: list = []
    tev = ts.eval_expr(tex, tb, masks=tmasks)
    if name.startswith("power"):
        a, b = (np.where(np.abs(v) < 2.0**-1022, 0.0, v)
                for v in (np.asarray(jev.values), tev.values.numpy()))
        assert np.allclose(a, b, rtol=POW_REL, atol=0.0)
    else:
        _same(jev.values, tev.values)
    _same(jev.null_mask(), tev.null_mask())
    assert (jev.col.ctype.value, jev.col.nullable, jev.col.scale) == (
        tev.col.ctype.value, tev.col.nullable, tev.col.scale)
    assert [c for c, _ in jmasks] == [c for c, _ in tmasks]
    for (_, jm), (_, tm) in zip(jmasks, tmasks):
        _same(jm, tm)


# -- SUM_FLOAT ---------------------------------------------------------------------

RCAP = 256


def _rschema(mod):
    C, T = mod.Column, mod.ColumnType
    return mod.Schema([C("k", T.INT64, True), C("v", T.FLOAT64, True)])


def _raggs(rel, sc):
    A, F = rel.AggregateExpr, rel.AggregateFunc
    return (A(F.SUM_FLOAT, sc.col(1)), A(F.COUNT, sc.col(1)),
            A(F.SUM_FLOAT, sc.col(1) * sc.lit(0.85)))


def _rsteps():
    """Five steps of (cols, nulls, diff): inserts, retractions of earlier
    rows (so sums return through cancellation), a group that dies."""
    rng = np.random.default_rng(31)
    n = 120
    k = rng.integers(0, 9, n)
    v = rng.standard_normal(n) * 10.0 ** rng.integers(-8, 9, n)
    kn, vn = rng.random(n) < 0.1, rng.random(n) < 0.15

    def take(idx, d):
        return [k[idx], v[idx]], [kn[idx], vn[idx]], np.full(len(idx), d, np.int64)

    steps = [take(np.arange(0, 60), 1), take(np.arange(60, 120), 1),
             take(np.arange(10, 40), -1), take(np.arange(10, 25), 1)]
    live = np.ones(n, bool)
    live[25:40] = False
    dying = np.nonzero(live & (k == 4) & ~kn)[0]
    steps.append(take(dying, -1))
    return steps


def _jvalid(b):
    n = int(b.count)
    return [np.asarray(c)[:n] for c in b.cols], [
        None if x is None else np.asarray(x)[:n] for x in b.nulls], np.asarray(b.diff)[:n]


def _tvalid(b):
    n = int(b.count)
    return [c[:n].numpy() for c in b.cols], [
        None if x is None else x[:n].numpy() for x in b.nulls], b.diff[:n].numpy()


def _same_batch(jb, tb):
    jc, jn, jd = _jvalid(jb)
    tc, tn, td = _tvalid(tb)
    assert len(jd) == len(td)
    for a, b in zip(jc, tc):
        _same(a, torch.from_numpy(b))
    assert np.array_equal(jd, td)
    for a, b in zip(jn, tn):
        assert (a is None) == (b is None)
        assert a is None or np.array_equal(a, b)


def test_sum_float_reduce_steps_match_reference():
    jop = JReduceOp(_rschema(jschema), (0,), _raggs(jmir, js))
    top = TReduceOp(_rschema(tschema), (0,), _raggs(tmir, ts))
    assert [c.name for c in top.state_schema.columns] == [
        c.name for c in jop.state_schema.columns]
    assert [c.ctype.value for c in top.out_schema.columns] == [
        c.ctype.value for c in jop.out_schema.columns]
    jstep = jax.jit(jop.step)
    jstate = jop.init_state(RCAP)
    tstate = top.init_state(RCAP, device="cpu")
    sizes = []
    for t, (cols, nulls, diff) in enumerate(_rsteps(), start=1):
        time = np.full(len(diff), t, np.uint64)
        jb = JBatch.from_numpy(_rschema(jschema), cols, time, diff, capacity=RCAP, nulls=nulls)
        tb = TBatch.from_numpy(_rschema(tschema), cols, time, diff, capacity=RCAP,
                               nulls=nulls, device="cpu")
        jstate, jout, jovf = jstep(jstate, jb, jnp.asarray(t, jnp.uint64))
        tstate, tout, tovf = top.step(tstate, tb, t)
        assert bool(jovf[0]) == bool(tovf[0]) is False
        _same_batch(jstate[0].batch, tstate[0].batch)
        _same_batch(jout, tout)
        sizes.append(int(tstate[0].batch.count))
    assert sizes[-1] == sizes[-2] - 1  # the dying group left


class _OpCount(TorchDispatchMode):
    """Counts the aten operations run under it (each one launch on a
    card)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def _hub_step(h: int):
    """One step's (cols, nulls, diff): key 0 holds ``h`` rows, keys 1..8
    hold 4 rows each."""
    rng = np.random.default_rng(37)
    k = np.concatenate([np.zeros(h, np.int64), np.repeat(np.arange(1, 9), 4)])
    v = rng.standard_normal(len(k)) * 10.0 ** rng.integers(-8, 9, len(k))
    none = np.zeros(len(k), bool)
    return [k, v], [none, none], np.ones(len(k), np.int64)


def test_sum_float_passes_grow_with_the_largest_group():
    jop = JReduceOp(_rschema(jschema), (0,), _raggs(jmir, js))
    top = TReduceOp(_rschema(tschema), (0,), _raggs(tmir, ts))
    jstep = jax.jit(jop.step)
    ops, reads = [], []
    for h in (16, 80, 144):
        cols, nulls, diff = _hub_step(h)
        time = np.ones(len(diff), np.uint64)
        jb = JBatch.from_numpy(_rschema(jschema), cols, time, diff, capacity=RCAP, nulls=nulls)
        tb = TBatch.from_numpy(_rschema(tschema), cols, time, diff, capacity=RCAP,
                               nulls=nulls, device="cpu")
        jstate, jout, _ = jstep(jop.init_state(RCAP), jb, jnp.asarray(1, jnp.uint64))
        tstate = top.init_state(RCAP, device="cpu")
        before = treduce.RUN_READBACKS
        with _OpCount() as count:
            tstate, tout, tovf = top.step(tstate, tb, 1)
        reads.append(treduce.RUN_READBACKS - before)
        ops.append(count.n)
        assert not bool(tovf[0])
        _same_batch(jstate[0].batch, tstate[0].batch)
        _same_batch(jout, tout)
    assert reads == [1, 1, 1]
    # Both hub increments are 64 rows: 64 more lockstep passes each.
    assert ops[2] - ops[1] == ops[1] - ops[0] > 0
