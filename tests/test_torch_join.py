"""Port parity for the delta join (``ops/join.py``, ``ops/delta_join.py``
and the render arm of ``render/dataflow.py``). No reference dataflow is
built in this file.

- ``_plan_pipelines`` equals the reference's, pipeline order,
  arrangement specs and canonical projections included, for the join of
  the optimized TPC-H Q15 and Q9 plans and for the 3-way R ⋈ S ⋈ T of
  ``tests/test_delta_join.py``.
- ``expand_ranges`` and ``null_key_diffs`` equal the reference's on
  seeded ranges (overflow, empty ranges and invalid probes included),
  every output slot compared.
- The port's ``DeltaJoinOp.step`` over seeded steps with retractions
  and NULL keys: each step's output delta equals the change of
  ``_oracle_join``'s numpy oracle, and a 2-row output tier overflows.
- The port's ``DeltaJoinOp.step`` with slotted state spines
  (``ingest_slots=8``, the append-slot ring Q9's state tier selects)
  over 12 steps with retractions, the ring flushed into run 0 after 8
  (``compact_level(sp, 0)``): each step's output equals the oracle's
  change and, row for row, the reference op's; every spine's runs,
  slots, cached lanes and cursor equal the reference's after each step;
  the reference's state carried across mid-ring (cursor 2) steps onward
  to the same result.
- A port ``Dataflow`` over R ⋈ S ⋈ T against the same oracle over
  several seeded steps, concurrent deltas in one step counted once, and
  a join tier lowered by ``set_join_tiers`` between steps that
  overflows, grows and replays to the oracle's result.
Every value is an integer: tolerance 0.
"""

from __future__ import annotations

from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from materialize_tpu.arrangement import spine as jspine
from materialize_tpu.expr import relation as jmir
from materialize_tpu.expr.scalar import ColumnRef as JColumnRef
from materialize_tpu.ops import delta_join as jdj
from materialize_tpu.ops import join as jjoin
from materialize_tpu.repr import schema as jschema
from materialize_tpu.repr.batch import Batch as JBatch
from materialize_tpu.transform.optimizer import optimize
from materialize_tpu.workloads.tpch import q9_mir, q15_mir
from materialize_tpu_torch import interop
from materialize_tpu_torch.arrangement import spine as tspine
from materialize_tpu_torch.expr import relation as tmir
from materialize_tpu_torch.expr.scalar import ColumnRef
from materialize_tpu_torch.ops import delta_join as tdj
from materialize_tpu_torch.ops import join as tjoin
from materialize_tpu_torch.plan.decisions import quantize_cap
from materialize_tpu_torch.render.dataflow import Dataflow
from materialize_tpu_torch.repr import schema as tschema
from materialize_tpu_torch.repr.batch import Batch as TBatch
from materialize_tpu_torch.workloads.tpch import set_join_tiers
from tests.test_delta_join import _oracle_join
from tests.test_torch_dataflow import _jspine_dict


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's eager ops here are small: one intra-op thread runs them
    about as fast, and does not contend with other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _find_join(x):
    if isinstance(x, jmir.Join):
        return x
    for c in x.children():
        found = _find_join(c)
        if found is not None:
            return found
    return None


def _ref_join_shape(name):
    """(arities, reference equivalences) of a reference join."""
    if name == "three_way":
        return [2, 2, 2], ((JColumnRef(1), JColumnRef(2)), (JColumnRef(3), JColumnRef(4)))
    plan = optimize({"q15": q15_mir, "q9": q9_mir}[name]())
    join = _find_join(plan)
    assert join is not None and len(join.inputs) >= 3
    return [i.schema().arity for i in join.inputs], join.equivalences


@pytest.mark.parametrize("name", ["q15", "q9", "three_way"])
def test_plan_pipelines_equal_reference(name):
    arities, jeq = _ref_join_shape(name)
    teq = tuple(tuple(ColumnRef(e.index) for e in cls) for cls in jeq)
    want = jdj._plan_pipelines(len(arities), arities, jeq)
    got = tdj._plan_pipelines(len(arities), arities, teq)
    assert got == want
    if name == "q15":
        pipes, specs = got
        assert specs == [(1, (0,)), (2, (0,)), (0, (1,)), (0, (0,))]
        assert [steps for steps, _ in pipes] == [
            [(1, (1,), (0,), 0), (2, (0,), (0,), 1)],
            [(0, (0,), (1,), 2), (2, (1,), (0,), 1)],
            [(0, (0,), (0,), 3), (1, (3,), (0,), 0)],
        ]


def _ranges(case, rng):
    """(lo, hi, valid, out_capacity)."""
    n = 40
    lo = rng.integers(0, 500, n).astype(np.int32)
    size = rng.integers(0, 6, n).astype(np.int32)
    valid = rng.random(n) < 0.8
    if case == "empty_ranges":
        size[:] = 0
    if case == "some_empty":
        size[::3] = 0
    if case == "all_invalid":
        valid[:] = False
    cap = {"overflow": 32}.get(case, 256)
    return lo, lo + size, valid, cap


# One compile per output tier (eager jnp compiles every primitive).
_jexpand = jax.jit(jjoin.expand_ranges, static_argnums=3)


@pytest.mark.parametrize("case", ["fits", "overflow", "empty_ranges", "some_empty",
                                  "all_invalid"])
def test_expand_ranges_equal_reference(case):
    lo, hi, valid, cap = _ranges(case, np.random.default_rng(11))
    want = _jexpand(jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(valid), cap)
    got = tjoin.expand_ranges(torch.from_numpy(lo), torch.from_numpy(hi),
                              torch.from_numpy(valid), cap)
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy())
        assert str(g.dtype).split(".")[-1] == str(np.asarray(w).dtype)
    total = int(np.where(valid, hi - lo, 0).sum())
    assert bool(got[3]) == (total > cap)
    assert int(got[2].sum()) == min(total, cap)


def _schema(mod, nullable_keys: bool):
    C, T = mod.Column, mod.ColumnType
    return mod.Schema([C("k", T.INT64, nullable_keys), C("v", T.DECIMAL, True, 2)])


def test_null_key_diffs_equal_reference():
    rng = np.random.default_rng(5)
    n = 64
    cols = [rng.integers(0, 5, n), rng.integers(-100, 100, n)]
    nulls = [rng.random(n) < 0.3, rng.random(n) < 0.3]
    diff = rng.choice(np.array([-1, 1, 2]), n)
    time = np.zeros(n, np.uint64)
    jb = JBatch.from_numpy(_schema(jschema, True), cols, time, diff, nulls=nulls)
    tb = TBatch.from_numpy(_schema(tschema, True), cols, time, diff, nulls=nulls,
                           device="cpu")
    for key in ((0,), (1,), (0, 1), ()):
        assert np.array_equal(np.asarray(jjoin.null_key_diffs(jb, key)),
                              tjoin.null_key_diffs(tb, key).numpy())


# -- R(a, b) ⋈ S(b, c) ⋈ T(c, d), keys nullable --------------------------------


CAP = 1024  # the join's output tier in the op test


def _rst(mod):
    C, T = mod.Column, mod.ColumnType
    return (
        mod.Schema([C("a", T.INT64), C("b", T.INT64, True)]),
        mod.Schema([C("b", T.INT64, True), C("c", T.INT64, True)]),
        mod.Schema([C("c", T.INT64, True), C("d", T.INT64)]),
    )


def _step_data(rng, n=20, null_rate=0.15):
    """Per input: (x, y, x_nulls, y_nulls, diff) with retractions."""
    out = []
    for _ in range(3):
        x, y = rng.integers(0, 5, n), rng.integers(0, 5, n)
        d = rng.choice(np.array([-1, 1, 1, 2]), n)
        out.append((x, y, rng.random(n) < null_rate, rng.random(n) < null_rate, d))
    return out


def _batches(mod, Batch, data, time, device=None):
    kw = {} if device is None else {"device": device}
    out = []
    for sch, (x, y, xn, yn, d) in zip(_rst(mod), data):
        nulls = [xn if sch[0].nullable else None, yn if sch[1].nullable else None]
        out.append(Batch.from_numpy(sch, [x, y], np.full(len(d), time, np.uint64), d,
                                    nulls=nulls, **kw))
    return out


def _tvalid(b):
    n = int(b.count)
    rows = Counter()
    for i in range(n):
        rows[tuple(None if nl is not None and bool(nl[i]) else int(c[i])
                   for c, nl in zip(b.cols, b.nulls))] += int(b.diff[i])
    return {k: v for k, v in rows.items() if v}


def _eq(mod, ColumnRef_):
    return ((ColumnRef_(1), ColumnRef_(2)), (ColumnRef_(3), ColumnRef_(4)))


def _oracle_after(ms):
    return _oracle_join(*[{k: v for k, v in m.items() if v} for m in ms])


def _absorb(ms, data):
    """Fold one step's rows into the per-input multisets; a row with a
    NULL join key never matches (SQL), so it is left out."""
    for j, (x, y, xn, yn, d) in enumerate(data):
        nx = xn if j > 0 else np.zeros(len(x), bool)
        ny = yn if j < 2 else np.zeros(len(y), bool)
        for xx, yy, a, b, dd in zip(x, y, nx, ny, d):
            if not (a or b):
                ms[j][(int(xx), int(yy))] += int(dd)


def test_delta_join_op_steps_match_oracle():
    op = tdj.DeltaJoinOp(_rst(tschema), _eq(tschema, ColumnRef))
    assert op.arr_specs == [(1, (0,)), (2, (0,)), (0, (1,)), (1, (1,))]
    # key columns normalized non-nullable, the rest as they were
    assert [[c.nullable for c in s.columns] for s in op.arr_schemas] == [
        [False, True], [False, False], [False, False], [True, False]]
    state = op.init_state(256, 256, device="cpu")
    rng = np.random.default_rng(3)
    ms = [Counter(), Counter(), Counter()]
    for t in range(4):
        data = _step_data(rng, n=12)
        batches = _batches(tschema, TBatch, data, t, "cpu")
        # a tier of 2 rows overflows: the same step at 1024 fits
        _, _, _, tiny = op.step(state, batches, t, 2)
        state, out, st_ovf, ovf = op.step(state, batches, t, CAP)
        before = _oracle_after(ms)
        _absorb(ms, data)
        after = _oracle_after(ms)
        want = {k: after.get(k, 0) - before.get(k, 0) for k in set(after) | set(before)}
        assert _tvalid(out) == {k: v for k, v in want.items() if v}, t
        assert bool(tiny) and not bool(ovf) and not any(map(bool, st_ovf.values()))
        assert int(out.time[: int(out.count)].ne(t).sum()) == 0


def _same_out(jb, tb):
    """Equal valid rows (columns, NULL masks, time, diff), in order."""
    n = int(tb.count)
    assert int(jb.count) == n
    for a, b in zip(jb.cols + (jb.diff,), tb.cols + (tb.diff,)):
        assert np.array_equal(np.asarray(a)[:n], b[:n].numpy())
    assert np.array_equal(np.asarray(jb.time)[:n].view(np.int64), tb.time[:n].numpy())
    for a, b in zip(jb.nulls, tb.nulls):
        assert (a is None) == (b is None)
        if a is not None:
            assert np.array_equal(np.asarray(a)[:n], b[:n].numpy())


def _same_spine(jsp, tsp):
    """Runs, slots (rows at their capacities), cached lanes, cursor."""
    want = _jspine_dict(jsp)
    got = interop.spine_to_numpy(tsp)
    assert got["cursor"] == want["cursor"]
    for g, w in zip(got["runs"] + got["slots"], want["runs"] + want["slots"]):
        n = w["count"]
        assert g["count"] == n and len(g["diff"]) == len(w["diff"])
        for a, b in zip(g["cols"] + [g["diff"], g["time"]], w["cols"] + [w["diff"], w["time"]]):
            assert np.array_equal(a[:n], b[:n])
    for g, w, run in zip(got["lanes"] + got["slot_lanes"], want["lanes"] + want["slot_lanes"],
                         want["runs"] + want["slots"]):
        assert g.shape == w.shape and np.array_equal(g[: run["count"]], w[: run["count"]])


def _canonical(sp):
    """A reference spine whose nullable columns all carry a null mask, as
    a flush leaves them: one step program serves every step."""
    return jspine.Spine(tuple(b.canonicalize_nulls() for b in sp.runs_b), sp.key, sp.order,
                        tuple(b.canonicalize_nulls() for b in sp.slots), sp.cursor,
                        sp.lanes, sp.slot_lanes)


def test_slotted_delta_join_op_matches_oracle_and_reference():
    top = tdj.DeltaJoinOp(_rst(tschema), _eq(tschema, ColumnRef))
    jop = jdj.DeltaJoinOp(_rst(jschema), _eq(jschema, JColumnRef))
    tstate = top.init_state(256, 256, ingest_slots=8, device="cpu")
    jstate = tuple(_canonical(sp) for sp in jop.init_state(256, 256, ingest_slots=8))
    assert all(len(sp.slots) == 8 and sp.cursor == 0 for sp in tstate)
    jstep = jax.jit(lambda st, d, t: jop.step(st, d, t, CAP))
    jflush = jax.jit(lambda st: tuple(jspine.compact_level(sp, 0)[0] for sp in st))
    rng = np.random.default_rng(29)
    ms = [Counter(), Counter(), Counter()]
    carried = None

    def flush(state):
        return tuple(tspine.compact_level(sp, 0)[0] for sp in state)

    for t in range(12):
        data = _step_data(rng, n=12)
        tb = _batches(tschema, TBatch, data, t, "cpu")
        before = _oracle_after(ms)
        _absorb(ms, data)
        after = _oracle_after(ms)
        want = {k: after.get(k, 0) - before.get(k, 0) for k in set(after) | set(before)}
        jstate, jout, _, _ = jstep(jstate, _batches(jschema, JBatch, data, t), np.uint64(t))
        outs = []
        for state in (tstate, carried):
            if state is not None:
                state, out, st_ovf, ovf = top.step(state, tb, t, CAP)
                assert _tvalid(out) == {k: v for k, v in want.items() if v}, t
                _same_out(jout, out)
                assert not bool(ovf) and not any(map(bool, st_ovf.values()))
            outs.append(state)
        tstate, carried = outs
        if t == 7:  # the ring is full: flush it into run 0
            jstate = jflush(jstate)
            tstate = flush(tstate)
        for jsp, tsp in zip(jstate, tstate):
            _same_spine(jsp, tsp)
        assert all(sp.cursor == (t + 1) % 8 if t != 7 else sp.cursor == 0 for sp in tstate)
        if t == 9:  # carry the reference's state across mid-ring
            carried = tuple(interop.spine_from_numpy(_jspine_dict(jsp), tsp.schema, "cpu")
                            for jsp, tsp in zip(jstate, tstate))
            assert all(sp.cursor == 2 for sp in carried)
    for jsp, csp in zip(jstate, carried):
        _same_spine(jsp, csp)
    assert sum(int(s.count) for sp in tstate for s in sp.slots) > 0


def _three_way_df():
    A, B, C = _rst(tschema)
    plan = tmir.Join(
        (tmir.Get("R", A), tmir.Get("S", B), tmir.Get("T", C)),
        equivalences=_eq(tschema, ColumnRef),
    )
    return Dataflow(plan, device="cpu")


def _peek(df):
    acc = Counter()
    for r in df.peek():
        acc[r[:-2]] += r[-1]
    return {k: v for k, v in acc.items() if v}


def test_three_way_dataflow_matches_oracle_with_null_keys():
    df = _three_way_df()
    rng = np.random.default_rng(17)
    ms = [Counter(), Counter(), Counter()]
    for t in range(5):
        data = _step_data(rng)
        df.step(dict(zip("RST", _batches(tschema, TBatch, data, t, "cpu"))))
        _absorb(ms, data)
        assert _peek(df) == _oracle_after(ms), t
    assert _peek(df)


def test_concurrent_deltas_counted_once():
    df = _three_way_df()
    one = np.ones(1, np.int64)
    schemas = _rst(tschema)
    rows = {"R": (1, 2), "S": (2, 3), "T": (3, 4)}
    df.step({
        name: TBatch.from_numpy(sch, [np.array([x]), np.array([y])], np.zeros(1, np.uint64),
                                one, device="cpu")
        for (name, (x, y)), sch in zip(rows.items(), schemas)
    })
    assert _peek(df) == {(1, 2, 2, 3, 3, 4): 1}


def test_lowered_join_tier_overflows_grows_and_replays():
    """``set_join_tiers`` lowers every join tier between ticks (Q9's churn
    after a hydration in larger ticks): a tick beyond the lowered tier
    overflows, rolls back, grows it and replays to the oracle's result."""
    df = _three_way_df()
    rng = np.random.default_rng(23)
    ms = [Counter(), Counter(), Counter()]
    set_join_tiers(df, 5000)
    assert df._ctx.join_caps == [8192]
    for t in range(4):
        if t == 1:
            set_join_tiers(df, 1)
            assert df._ctx.join_caps == [quantize_cap(1)]
        data = _step_data(rng, n=80)
        before = df._readbacks
        df.step(dict(zip("RST", _batches(tschema, TBatch, data, t, "cpu"))))
        _absorb(ms, data)
        assert _peek(df) == _oracle_after(ms), t
        if t == 1:  # the lowered tier overflowed: one more readback, then the replay's
            assert df._readbacks - before > 1
    assert df._ctx.join_caps[0] > quantize_cap(1) and _peek(df)
