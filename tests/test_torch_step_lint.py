"""The step linter (``materialize_tpu_torch/analysis/step_lint.py``), the
port's counterpart of ``materialize_tpu/analysis/jaxpr_lint.py``.

- The same MIR dataflows go through the reference's ``lint_dataflow``
  (its step program, traced) and the port's (one recorded tick, seeded),
  and the finding kinds are compared: a float64 literal in a Map and in
  a Filter, the clean integer dataflow, the stateful operators, Q1 after
  the optimizer. The port does not flag the Map's literal: its plan
  declares the FLOAT64 column, which the card computes natively.
- The reference's jaxpr-level fixtures get eager counterparts, each
  flagged under its kind: shape- and dtype-varying carries, a host
  read, a large constant made from host data, a data-dependent shape.
- A recorded step's output, peek and every state tensor equal an
  unrecorded step's.
- On two gloo ranks, the record's collective census equals
  ``shard_prop.census_of`` of what ``ShardedDataflow`` logged.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tests import torch_sharded_cases as C
from tests.torch_serving import DEADLINE_S, deadline, mod, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.analysis


def _schema(pkg: str, name: str = "a"):
    s = mod(pkg, "repr.schema")
    return s.Schema((s.Column(name, s.ColumnType.INT64),))


def _exprs(pkg: str) -> dict:
    rel, sc, s = mod(pkg, "expr.relation"), mod(pkg, "expr.scalar"), mod(pkg, "repr.schema")
    F64 = s.ColumnType.FLOAT64
    t, u = rel.Get("t", _schema(pkg)), rel.Get("u", _schema(pkg, "x"))
    return {
        "f64_literal": rel.Map(t, (sc.lit(1.5, F64),)),
        "f64_filter": t.filter([sc.lit(1.5, F64).gt(sc.lit(0.5, F64))]),
        "clean_int": t.filter([sc.col(0).gt(sc.lit(1))]),
        "stateful": rel.Join((t, u), ((sc.col(0), sc.col(1)),)).reduce(
            (0,), (rel.AggregateExpr(rel.AggregateFunc.COUNT, sc.lit(True)),)),
    }


def _tick(names, seed: int, n: int = 24) -> dict:
    from materialize_tpu_torch.repr.batch import Batch

    rng = np.random.default_rng(seed)
    return {name: Batch.from_numpy(_schema("port", "a" if name == "t" else "x"),
                                   [rng.integers(0, 12, n)], np.full(n, seed, np.uint64),
                                   rng.choice([1, 1, 1, -1], n).astype(np.int64),
                                   device="cpu")
            for name in names}


def _port_record(expr, names):
    """A warm tick, then the recorded one (seeded): (findings, record)."""
    from materialize_tpu_torch.analysis import step_lint
    from materialize_tpu_torch.render.dataflow import Dataflow

    df = Dataflow(expr, device="cpu")
    df.step(_tick(names, 1))
    return step_lint.lint_dataflow(df, _tick(names, 2))


@pytest.fixture(scope="module")
def reference_lints():
    """The reference's lint and kernel count of each dataflow (traced
    with empty inputs; nothing steps or compiles)."""
    from materialize_tpu.analysis import kernel_count, lint_dataflow, trace_dataflow_step
    from materialize_tpu.render.dataflow import Dataflow

    out = {}
    for case, expr in _exprs("ref").items():
        df = Dataflow(expr)
        out[case] = (lint_dataflow(df), kernel_count(trace_dataflow_step(df)))
    return out


@pytest.mark.parametrize("case", ["f64_literal", "f64_filter", "clean_int", "stateful"])
def test_finding_kinds_match_the_reference(case, reference_lints):
    from materialize_tpu_torch.analysis import step_lint

    ref, ref_count = reference_lints[case]
    names = ("t", "u") if case == "stateful" else ("t",)
    findings, rec = _port_record(_exprs("port")[case], names)
    ref_kinds = {f.lint_id for f in ref}
    port_kinds = {f.lint_id for f in findings}
    if case == "f64_literal":
        # The plan declares the FLOAT64 column: native on the card.
        assert ref_kinds == {step_lint.F64_LEAK}
        assert port_kinds == set() and rec.plan_has_f64
    else:
        assert port_kinds == ref_kinds, findings
    assert ref_count > 0 and step_lint.kernel_count(rec) > 0
    if case == "f64_filter":
        msg = next(f.message for f in findings if f.lint_id == step_lint.F64_LEAK)
        assert "float64" in msg and "literal" in msg


def test_q1_after_optimize():
    """The reference's Q1 step program is clean. The port's steady Q1
    tick reads nothing back on the CPU (its flags readback carries the
    boundary pragma, and host copies dispatch nothing here); its debt on
    the CPU is the host scalars it makes into tensors, named by file and
    operation. Its first step after install materializes the output
    run's null masks: a carry whose structure changes once."""
    from materialize_tpu.analysis import lint_dataflow
    from materialize_tpu.render.dataflow import Dataflow as RefDataflow
    from materialize_tpu.transform.optimizer import optimize
    from materialize_tpu.workloads.tpch import q1_mir
    from materialize_tpu_torch.analysis import step_lint
    from materialize_tpu_torch.render.dataflow import Dataflow
    from materialize_tpu_torch.storage.generator.tpch import TpchGenerator
    from materialize_tpu_torch.workloads.tpch import q1_plan

    assert lint_dataflow(RefDataflow(optimize(q1_mir()), name="q1")) == []
    gen = TpchGenerator(sf=0.002)
    df = Dataflow(q1_plan(), device="cpu")
    first, rec0 = step_lint.lint_dataflow(
        df, {"lineitem": gen.churn_lineitem_batch(8, 1, 0, device="cpu")})
    assert {f.lint_id for f in first} == {step_lint.CARRY_VARY}
    assert sorted(f.where for f in first) == [
        f"output.runs_b[0].nulls[{i}]" for i in range(2, 6)]
    steady, rec = step_lint.lint_dataflow(
        df, {"lineitem": gen.churn_lineitem_batch(8, 2, 1, device="cpu")})
    assert steady == []
    assert rec.device == "cpu" and not any(o.host_read() for o in rec.ops)
    uploads = {(o.site.rsplit(":", 1)[0], o.name) for o in rec.ops if o.upload_bytes("cpu")}
    assert uploads == {
        ("materialize_tpu_torch/ops/consolidate.py", "aten.lift_fresh.default"),
        ("materialize_tpu_torch/ops/merge.py", "aten.lift_fresh.default"),
    }
    assert {s.rsplit(":", 1)[0] for s in rec.sync_sites()} == {f for f, _op in uploads}
    census = step_lint.op_census(rec)
    assert step_lint.kernel_count(rec) == sum(census.values()) > 0
    assert step_lint.intermediate_bytes(rec) > 0
    assert "merge_path" not in census  # the CPU runs the plain merge


# -- eager counterparts of the reference's jaxpr-level fixtures ---------------


class _Stepper:
    """A minimal carried loop: ``step`` replaces its one state tensor."""

    def __init__(self, update, grows: bool = False):
        self.states = [torch.zeros(8, dtype=torch.int64)]
        self._grown: list = []
        self._update, self._grows = update, grows

    def step(self, inputs):
        if self._grows:
            self._grown.append(("state", 0))
        self.states = [self._update(self.states[0])]
        return self.states[0]


@pytest.mark.parametrize("update", [
    lambda s: torch.cat([s, s]),
    lambda s: s.to(torch.float32),
], ids=["shape", "dtype"])
def test_varying_carry_flagged(update):
    from materialize_tpu_torch.analysis import step_lint

    _out, rec = step_lint.record_step(_Stepper(update), {})
    findings = step_lint.lint_record(rec)
    assert [(f.lint_id, f.where) for f in findings] == [(step_lint.CARRY_VARY, "states[0]")]
    assert "capacity tier" in findings[0].message
    # A change the render recorded as tier growth is no hazard.
    _out, rec = step_lint.record_step(_Stepper(update, grows=True), {})
    assert step_lint.lint_record(rec) == []


def test_invariant_carry_clean():
    from materialize_tpu_torch.analysis import step_lint

    _out, rec = step_lint.record_step(_Stepper(lambda s: s + 1), {})
    assert step_lint.lint_record(rec) == []


def _sanctioned_read(x):
    return x + int(x.sum())  # host-sync: ok(test boundary)


def test_host_read_flagged_and_pragma_honoured():
    from materialize_tpu_torch.analysis import step_lint

    x = torch.arange(4)
    findings, _rec = step_lint.lint_step_fn(lambda v: v + int(v.sum()), x)
    assert [f.lint_id for f in findings] == [step_lint.HOST_CALLBACK]
    assert "device->host" in findings[0].message
    assert findings[0].where.startswith("tests/test_torch_step_lint.py:")
    findings, rec = step_lint.lint_step_fn(_sanctioned_read, x)
    assert findings == [] and len(rec.sync_sites()) == 1


def test_dyn_shape_flagged():
    from materialize_tpu_torch.analysis import step_lint

    x = torch.arange(8)
    for fn in (lambda v: v.nonzero(), lambda v: v[v > 3]):
        findings, _rec = step_lint.lint_step_fn(fn, x)
        assert {f.lint_id for f in findings} == {step_lint.DYN_SHAPE, step_lint.HOST_CALLBACK}


def test_big_constant_flagged():
    from materialize_tpu_torch.analysis import step_lint

    big = np.arange(1 << 18, dtype=np.int64)  # 2 MiB
    x = torch.zeros(4, dtype=torch.int64)
    findings, rec = step_lint.lint_step_fn(lambda v: v + torch.tensor(big)[:4], x)
    assert [f.lint_id for f in findings] == [step_lint.BIG_CONST]
    assert rec.h2d_bytes() == big.nbytes
    small = np.arange(8, dtype=np.int64)
    findings, _rec = step_lint.lint_step_fn(lambda v: v + torch.tensor(small)[:4], x)
    assert findings == []


def test_findings_deterministic_order():
    from materialize_tpu_torch.analysis import step_lint

    def step(v):
        return v.nonzero(), v * torch.tensor(2.0, dtype=torch.float64), int(v.sum())

    a, _ = step_lint.lint_step_fn(step, torch.arange(4))
    b, _ = step_lint.lint_step_fn(step, torch.arange(4))
    assert a == b
    assert [f.lint_id for f in a] == sorted(f.lint_id for f in a)
    assert {f.lint_id for f in a} == {step_lint.DYN_SHAPE, step_lint.F64_LEAK,
                                      step_lint.HOST_CALLBACK}


def test_letrec_bindings_keep_their_tier():
    """The transitive closure's binding deltas, reported by the render at
    every evaluation, keep one signature: no carry-vary. The one host
    read of its steady tick is the stopping rule's pending count, once
    an evaluation (the reference's loop condition stays on its device)."""
    from materialize_tpu_torch.analysis import step_lint
    from materialize_tpu_torch.render.dataflow import Dataflow

    df = Dataflow(C.agg_expr("port"), device="cpu")
    t0, t1, _t2 = (C.batches("port", tick, t, device="cpu", inputs=C.INPUTS["agg"])
                   for t, tick in enumerate(C.agg_ticks()))
    df.step(t0)
    findings, rec = step_lint.lint_dataflow(df, t1)
    (site, sigs), = rec.letrec_carries.items()
    evals = df._ctx.letrec_evals[-1]
    assert site == ("letrec", 0) and len(sigs) == evals >= 2
    assert all(s == sigs[0] for s in sigs)
    (f,) = findings
    assert f.lint_id == step_lint.HOST_CALLBACK
    assert f.where.startswith("materialize_tpu_torch/render/dataflow.py:")
    assert f.message.startswith(f"{evals} device->host read(s)")


# -- recording changes nothing -----------------------------------------------


def _leaves(tree, out: list) -> list:
    import dataclasses

    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _leaves(x, out)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            _leaves(getattr(tree, f.name), out)
    return out


def test_recorded_step_equals_unrecorded():
    """Every exchange site's operator (the sharded suite's ``ops`` plan:
    reduces, a Distinct, a TopK, both joins, a Constant, a Threshold),
    two dataflows fed the same ticks, the second one's middle tick
    recorded: equal deltas, peeks and state tensors after it and after
    the next tick."""
    from materialize_tpu_torch.analysis import step_lint
    from materialize_tpu_torch.render.dataflow import Dataflow

    make, kw, ticks = C.CASES["ops"]
    kw = {k: v for k, v in kw.items() if k != "output_cap"}
    plain, recorded = (Dataflow(make("port"), device="cpu", **kw) for _ in range(2))

    def feed(t, tick):
        return C.batches("port", tick, t, device="cpu", inputs=C.INPUTS["ops"])

    t0, t1, t2 = ticks(2)
    plain.step(feed(0, t0))
    recorded.step(feed(0, t0))
    want = plain.step(feed(1, t1))
    got, rec = step_lint.record_step(recorded, feed(1, t1))
    assert got.to_rows() == want.to_rows()
    assert len(rec.ops) > 0 and rec.grown == []
    for df_a, df_b in ((plain, recorded),):
        a = _leaves([df_a.states, df_a.output, df_a.err_output], [])
        b = _leaves([df_b.states, df_b.output, df_b.err_output], [])
        assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    assert plain.step(feed(2, t2)).to_rows() == recorded.step(feed(2, t2)).to_rows()
    assert C.net(plain.peek()) == C.net(recorded.peek())


# -- the collective census on two gloo ranks ----------------------------------


def record_rank(mesh) -> dict:
    """A spawned rank: the ``ops`` plan's first tick recorded through a
    port ``ShardedDataflow``."""
    torch.set_num_threads(1)
    from materialize_tpu_torch.analysis import step_lint
    from materialize_tpu_torch.analysis.shard_prop import census_of
    from materialize_tpu_torch.render.dataflow import ShardedDataflow

    make, kw, ticks = C.CASES["ops"]
    sdf = ShardedDataflow(make("port"), mesh, name="ops", **kw)
    tick = C.batches("port", ticks(mesh.world_size)[0], 0, device="cpu",
                     inputs=C.INPUTS["ops"])
    _out, rec = step_lint.record_step(sdf, tick)
    census = step_lint.op_census(rec)
    return {"record": census_of(rec.collectives), "logged": census_of(sdf._census),
            "census": {k: census.get(k, 0) for k in ("all_to_all", "psum")},
            "kernel_count": step_lint.kernel_count(rec)}


def test_sharded_record_census_equals_the_logged_census():
    from materialize_tpu_torch.parallel.multihost import spawn_workers

    runs = spawn_workers(record_rank, 2, device="cpu", timeout=DEADLINE_S - 10)
    for r in runs:
        assert r["record"] == r["logged"]
        assert r["record"]["collectives"] > 0
        assert r["census"] == r["record"]["kinds"] | {
            k: 0 for k in ("all_to_all", "psum") if k not in r["record"]["kinds"]}
        assert r["kernel_count"] > r["record"]["collectives"]
