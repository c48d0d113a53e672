"""Port parity for TPC-H Q15 as a maintained dataflow (Let, the 3-input
delta join, the global MAX).

- The port's ``workloads/tpch.py:q15_plan`` equals the reference
  optimizer's ``optimize(q15_mir())``, converted into the port's MIR
  classes by walking its attributes.
- Q15 in the reference bench's layout (``state_cap`` 1024, the supplier
  table on the first hydrate tick) runs in both packages on the SAME
  numpy batches of ``TpchGenerator(sf=0.002)``: 4 hydrate ticks, then 2
  churn spans of 4 ticks (the first crosses the tick-8 fold of the
  output and of the join's four spines). The port runs with its join
  tier at 16: the hydrate span overflows it, rolls back, doubles it and
  replays. ``peek()`` must equal the reference's and
  ``tests/test_q15.py:q15_oracle`` after hydration and after each span,
  with one flags readback per churn span; every state part (revenue
  accumulators, join spines, MAX multiset) must hold the same capacity
  tiers.
- The reference's state after hydration (the accumulators, the four join
  spines, the MAX multiset, the output spine, the err arrangement, the
  frontier, the join tier), carried into a fresh port dataflow with
  ``interop.install_state``, churns onward to the same result.
The reference runs at its default join tier: a second tier would cost a
second compile of its step program. One reference dataflow in the file:
its compiles dominate the run time.
"""

from __future__ import annotations

from collections import Counter

import pytest
import torch

import bench
from materialize_tpu.arrangement.spine import Spine as JSpine
from materialize_tpu.storage.generator.tpch import TpchGenerator as JGen
from materialize_tpu.transform.optimizer import optimize
from materialize_tpu.workloads.tpch import q15_mir
from materialize_tpu_torch import interop
from materialize_tpu_torch.repr.batch import Batch
from materialize_tpu_torch.storage.generator.tpch import LINEITEM_SCHEMA, SUPPLIER_SCHEMA
from materialize_tpu_torch.workloads.tpch import build_q15_dataflow, q15_plan
from tests.test_q15 import q15_oracle
from tests.test_torch_dataflow import _jbatch_dict, _jspine_dict
from tests.test_torch_q1 import _convert, _jdict_arrangement


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's eager ops here are small: one intra-op thread runs them
    about as fast, and does not contend with other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

SF, ORDERS_PER_TICK, SPAN, PORT_JOIN_CAP = 0.002, 16, 4, 16


def test_q15_plan_equals_the_reference_optimizer_output():
    want = _convert(optimize(q15_mir()))
    assert q15_plan() == want
    assert q15_plan().schema() == want.schema()


def _jpart(p):
    return _jspine_dict(p) if isinstance(p, JSpine) else _jdict_arrangement(p)


def _tiers(df):
    """Capacity tiers of every state part (runs of a spine)."""
    return [[[b.capacity for b in p.runs_b] if hasattr(p, "runs_b") else [p.batch.capacity]
             for p in parts] for parts in df.states]


def _multiset(rows):
    acc = Counter()
    for r in rows:
        acc[r[:-2]] += r[-1]
    return sorted(k for k, v in acc.items() if v > 0)


def test_q15_dataflow_matches_reference():
    gen = JGen(sf=SF, seed=42)
    jdf, _, _ = bench._tpch_lineitem_config(
        optimize(q15_mir()), sf=SF, n_orders_per_tick=ORDERS_PER_TICK,
        extra_inputs_fn=lambda g: {"supplier": g.table_batch("supplier")}, state_cap=1024,
    )
    tdf, h_orders, churn_cap = build_q15_dataflow(ORDERS_PER_TICK, device="cpu")
    tdf._ctx.join_caps[0] = PORT_JOIN_CAP
    assert (tdf._compact_every, tdf._compact_ratio) == (jdf._compact_every, jdf._compact_ratio)
    assert _tiers(tdf) == _tiers(jdf)
    assert tdf._covf_keys == jdf._covf_keys

    jsup = gen.table_batch("supplier")
    tsup = interop.batch_from_numpy(_jbatch_dict(jsup), SUPPLIER_SCHEMA, "cpu")
    jempty = type(jsup).empty(jsup.schema, 256)
    fed_rows: list = []

    def feed(dfs, jbatches, first_sup=False, readbacks=1):
        jin = [{"lineitem": b, "supplier": jsup if first_sup and k == 0 else jempty}
               for k, b in enumerate(jbatches)]
        jdf.run_steps(jin, defer_check=True)
        assert jdf.check_flags() is False
        for b in jbatches:
            fed_rows.extend(b.to_rows())
        for df in dfs:
            tin = [{"lineitem": interop.batch_from_numpy(_jbatch_dict(b), LINEITEM_SCHEMA,
                                                         "cpu"),
                    "supplier": tsup if first_sup and k == 0
                    else Batch.empty(SUPPLIER_SCHEMA, 256, device="cpu")}
                   for k, b in enumerate(jbatches)]
            before = df._readbacks
            df.run_steps(tin, defer_check=True)
            assert df.check_flags() is (readbacks > 1)
            assert df._readbacks - before == readbacks

    def same(df):
        got = df.peek()
        assert got == jdf.peek()
        assert _multiset(got) == q15_oracle(fed_rows, gen) != []
        assert df.peek_errors() == jdf.peek_errors() == []
        assert df.time == jdf.time and df._compact_tick == jdf._compact_tick
        assert _tiers(df) == _tiers(jdf)

    hyd = list(gen.snapshot_lineitem_batches(batch_orders=h_orders))
    assert len(hyd) == 4
    # the port's join tier overflows: one readback, then the replay's
    feed([tdf], hyd, first_sup=True, readbacks=2)
    assert tdf._ctx.join_caps == [2 * PORT_JOIN_CAP] and jdf._ctx.join_caps == [1024]
    same(tdf)

    # the reference's state carried into a fresh port dataflow
    cdf, _, _ = build_q15_dataflow(ORDERS_PER_TICK, device="cpu")
    interop.install_state(
        cdf, [[_jpart(p) for p in parts] for parts in jdf.states],
        _jspine_dict(jdf.output), _jdict_arrangement(jdf.err_output), jdf.time,
        jdf._compact_tick, jdf._ctx.join_caps,
    )
    assert cdf.peek() == jdf.peek()

    for first in (0, SPAN):
        span = [gen.churn_lineitem_batch(ORDERS_PER_TICK, tick=i,
                                         time=jdf.time + i - first, capacity=churn_cap)
                for i in range(first, first + SPAN)]
        feed([tdf, cdf], span)
        same(tdf)
        same(cdf)
    assert tdf._folds > 0
