"""Port parity for TPC-H Q1 as a maintained dataflow.

- The port's ``workloads/tpch.py:q1_plan`` equals the reference
  optimizer's ``optimize(q1_mir())``, converted into the port's MIR
  classes by walking its attributes.
- Q1 in the reference bench's layout runs in both packages on the SAME
  numpy batches of ``TpchGenerator(sf=0.002)`` (string codes depend on
  each package's dictionary, so the port never regenerates them): 4
  hydrate ticks, then 2 churn spans of 4 ticks (the second crosses the
  tick-8 fold). ``peek()`` and ``peek_errors()`` must be equal after
  hydration and after each span, with one flags readback per span.
- The reference's state after hydration (reduce state, output spine,
  err arrangement, frontier), carried into a fresh port dataflow with
  ``interop.install_state``, churns onward to the same result.
One reference dataflow in the file: its compiles dominate the run time.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import bench
from materialize_tpu.expr import relation as jmir
from materialize_tpu.expr import scalar as js
from materialize_tpu.repr import schema as jschema
from materialize_tpu.transform.optimizer import optimize
from materialize_tpu.workloads.tpch import q1_mir
from materialize_tpu_torch import interop
from materialize_tpu_torch.expr import relation as tmir
from materialize_tpu_torch.expr import scalar as ts
from materialize_tpu_torch.repr import schema as tschema
from materialize_tpu_torch.storage.generator.tpch import LINEITEM_SCHEMA
from materialize_tpu_torch.workloads.tpch import build_q1_dataflow, q1_plan
from tests.test_torch_dataflow import _jbatch_dict, _jspine_dict


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's eager ops here are small: one intra-op thread runs them
    about as fast, and does not contend with other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

SF, ORDERS_PER_TICK, SPAN = 0.002, 16, 4

_CLASSES = {
    jmir.Get: tmir.Get, jmir.Project: tmir.Project, jmir.Map: tmir.Map,
    jmir.Filter: tmir.Filter, jmir.Reduce: tmir.Reduce, jmir.Let: tmir.Let,
    jmir.Join: tmir.Join, jmir.AggregateExpr: tmir.AggregateExpr,
    jmir.TopK: tmir.TopK, jmir.Union: tmir.Union, jmir.Negate: tmir.Negate,
    jmir.Threshold: tmir.Threshold, jmir.Constant: tmir.Constant,
    jmir.FlatMap: tmir.FlatMap, jmir.ArrangeBy: tmir.ArrangeBy,
    js.ColumnRef: ts.ColumnRef, js.Literal: ts.Literal, js.CallBinary: ts.CallBinary,
    js.CallUnary: ts.CallUnary, js.MzNow: ts.MzNow,
}


def _convert(x):
    """A reference plan (MIR, scalars, schemas, enums) as the port's
    objects, field by field; a class the port lacks fails the test. A
    STRING literal's code is carried by its string: each package codes
    strings in its own dictionary."""
    if isinstance(x, js.Literal) and x.ctype is jschema.ColumnType.STRING \
            and x.value is not None:
        code = tschema.GLOBAL_DICT.encode(jschema.GLOBAL_DICT.decode(x.value))
        return ts.Literal(code, tschema.ColumnType.STRING, x.scale)
    if isinstance(x, tuple):
        return tuple(_convert(v) for v in x)
    if isinstance(x, jschema.Schema):
        return tschema.Schema([_convert(c) for c in x.columns])
    if isinstance(x, jschema.Column):
        return tschema.Column(x.name, _convert(x.ctype), x.nullable, x.scale)
    if isinstance(x, jschema.ColumnType):
        return tschema.ColumnType(x.value)
    if isinstance(x, jmir.AggregateFunc):
        return tmir.AggregateFunc(x.value)
    if dataclasses.is_dataclass(x):
        cls = _CLASSES[type(x)]
        return cls(**{f.name: _convert(getattr(x, f.name)) for f in dataclasses.fields(x)})
    assert isinstance(x, (str, int, bool, type(None))), type(x)
    return x


def test_q1_plan_equals_the_reference_optimizer_output():
    want = _convert(optimize(q1_mir()))
    assert q1_plan() == want
    assert q1_plan().schema() == want.schema()


def _jdict_arrangement(arr):
    return {"batch": _jbatch_dict(arr.batch), "key": tuple(arr.key), "order": arr.order}


def test_q1_dataflow_matches_reference():
    jdf, _, _ = bench._tpch_lineitem_config(
        optimize(q1_mir()), sf=SF, n_orders_per_tick=ORDERS_PER_TICK
    )
    tdf, h_orders, churn_cap = build_q1_dataflow(ORDERS_PER_TICK, device="cpu")
    assert (tdf._compact_every, tdf._compact_ratio) == (jdf._compact_every, jdf._compact_ratio)
    assert [b.capacity for b in tdf.output.runs_b] == [b.capacity for b in jdf.output.runs_b]
    from materialize_tpu.storage.generator.tpch import TpchGenerator as JGen

    gen = JGen(sf=SF, seed=42)

    def port(jbatches):
        return [{"lineitem": interop.batch_from_numpy(_jbatch_dict(b), LINEITEM_SCHEMA, "cpu")}
                for b in jbatches]

    def feed(dfs, jbatches):
        tin = port(jbatches)
        jdf.run_steps([{"lineitem": b} for b in jbatches], defer_check=True)
        assert jdf.check_flags() is False
        for df in dfs:
            before = df._readbacks
            df.run_steps(tin, defer_check=True)
            assert df.check_flags() is False and df._readbacks - before == 1

    def same(df):
        got = df.peek()
        assert got == jdf.peek() and len(got) == 4
        assert df.peek_errors() == jdf.peek_errors() == []
        assert df.time == jdf.time

    hyd = list(gen.snapshot_lineitem_batches(batch_orders=h_orders))
    assert len(hyd) == 4
    feed([tdf], hyd)
    same(tdf)
    # the state in numpy, as the reference holds it
    state = interop.arrangement_to_numpy(tdf.states[0][0])
    want = _jdict_arrangement(jdf.states[0][0])
    n = want["batch"]["count"]
    assert state["batch"]["count"] == n and state["key"] == want["key"] == (0, 1)
    for a, b in zip(state["batch"]["cols"] + [state["batch"]["diff"]],
                    want["batch"]["cols"] + [want["batch"]["diff"]]):
        assert np.array_equal(a[:n], b[:n])

    # the reference's state carried into a fresh port dataflow
    cdf, _, _ = build_q1_dataflow(ORDERS_PER_TICK, device="cpu")
    interop.install_state(
        cdf, [[_jdict_arrangement(p) for p in parts] for parts in jdf.states],
        _jspine_dict(jdf.output), _jdict_arrangement(jdf.err_output), jdf.time,
        jdf._compact_tick,
    )
    assert cdf.peek() == jdf.peek()

    for first in (0, SPAN):
        span = [gen.churn_lineitem_batch(ORDERS_PER_TICK, tick=i,
                                         time=jdf.time + i - first, capacity=churn_cap)
                for i in range(first, first + SPAN)]
        feed([tdf, cdf], span)
        same(tdf)
        same(cdf)
    assert tdf._folds > 0 and jdf._compact_tick == tdf._compact_tick
