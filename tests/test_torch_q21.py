"""Port parity for TPC-H Q21 as a maintained dataflow (EXISTS as a
semijoin, NOT EXISTS as ``Threshold(Union(cse13, Negate(...)))``).

- ``q21_plan()`` equals the reference's plan of the Q21 text,
  ``optimize(plan_statement(Q21_SQL, catalog).expr)``, converted into the
  port's MIR classes (string literals by their strings: each package
  codes strings in its own dictionary).
- Q21 runs in the reference and in the port on the SAME numpy batches of
  ``TpchGenerator(sf=0.002, seed=17)`` (``tests/test_decorrelate.py``'s
  fixture, whose view holds a row; the port's plan takes its string
  literals from the reference's dictionary, which codes the shared
  batches): supplier, nation, all orders and the
  whole lineitem snapshot in one tick, then 2 churn spans of 4 ticks of
  48 orders, the second crossing the tick-8 fold. Both run at state tier
  4096 (merge ingest; the bench's slotted layout would take the
  reference minutes to compile), every input at one capacity on every
  tick and both pre-sized by the same tiers (``q21_tiers``), so the
  reference compiles one program a span length. The port's delta-join
  tier starts at 1/8 of the reference's: it alone overflows, rolls back,
  grows and replays, three times, back to the reference's tier. After every span every state part (each run of
  every join spine, each Reduce's and the Threshold's arrangement), the
  output and the peek equal the reference's, and the peek equals a numpy
  oracle (the peek, which folds every spine, after the second span);
  one flags readback a churn span. The reference's state after
  hydration, carried into a fresh port dataflow with
  ``interop.install_state``, churns onward to the same states.
- The port alone in Q9's slotted layout: ``test_torch_q21_slotted.py``
  (a file of its own, so that parallel test workers spread the two).
Every value is an integer: tolerance 0. One reference dataflow is
stepped in the file: its compiles dominate the run time.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import bench
from materialize_tpu.arrangement.spine import Spine as JSpine
from materialize_tpu.render.dataflow import Dataflow as JDataflow
from materialize_tpu.repr.batch import Batch as JBatch
from materialize_tpu.repr.schema import GLOBAL_DICT as JDICT
from materialize_tpu.sql.catalog import Catalog, CatalogItem
from materialize_tpu.sql.plan import plan_statement
from materialize_tpu.storage.generator import tpch as jtpch
from materialize_tpu.transform.optimizer import optimize
from materialize_tpu_torch import interop
from materialize_tpu_torch.arrangement.spine import Spine
from materialize_tpu_torch.render.dataflow import Dataflow
from materialize_tpu_torch.repr.batch import Batch
from materialize_tpu_torch.repr.schema import GLOBAL_DICT as TDICT
from materialize_tpu_torch.storage.generator import tpch as ttpch
from materialize_tpu_torch.workloads.tpch import (
    Q21_SQL,
    Q21_TABLES,
    apply_tiers,
    q21_plan,
    q21_tiers,
)
from tests.test_torch_auction import _same
from tests.test_torch_dataflow import _jbatch_dict, _jspine_dict
from tests.test_torch_q1 import _convert, _jdict_arrangement
from tests.test_torch_q9 import _materialize_null_masks

SF, SEED, ORDERS_PER_TICK, SPAN, STATE_CAP = 0.002, 17, 48, 4, 4096
SCHEMAS = {"lineitem": ttpch.LINEITEM_SCHEMA, "supplier": ttpch.SUPPLIER_SCHEMA,
           "nation": ttpch.NATION_SCHEMA, "orders": ttpch.ORDERS_SCHEMA}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's eager ops here are small: one intra-op thread runs them
    about as fast, and does not contend with other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jplan():
    cat = Catalog()
    for name in ("lineitem", "orders", "supplier", "nation"):
        cat.create(CatalogItem(name, "source", getattr(jtpch, f"{name.upper()}_SCHEMA")))
    return optimize(plan_statement(Q21_SQL, cat).expr)


def test_q21_plan_equals_the_reference_optimizer_output():
    want = _convert(_jplan())
    assert q21_plan() == want
    assert q21_plan().schema() == want.schema()


def q21_oracle(lineitems: list, tables: dict, dictionary=TDICT) -> dict:
    """TPC-H Q21 over every lineitem row fed, each weighted by its diff,
    in plain Python (``tests/test_decorrelate.py``'s oracle, by counts):
    {(s_name code, numwait): 1}. Per order and per (order, supplier), the
    rows and the late rows; a row counts when it is late, its order 'F',
    its supplier Saudi, another supplier has a row of the order and none
    a late one. ``tables`` holds port batches, their strings coded by
    ``dictionary``."""
    def rows(name):
        b = tables[name]
        n = int(b.count)
        return list(zip(*[c[:n].tolist() for c in b.cols]))

    f_code, sa_code = dictionary.encode("F"), dictionary.encode("SAUDI ARABIA")
    status = {r[0]: r[2] for r in rows("orders")}
    saudi = {r[0] for r in rows("nation") if r[2] == sa_code}
    name = {r[0]: r[2] for r in rows("supplier") if r[1] in saudi}
    live = []
    for b in lineitems:
        n = int(b.count)
        cols = [c[:n].tolist() for c in b.cols]
        live += list(zip(cols[0], cols[2], cols[11], cols[12], b.diff[:n].tolist()))
    count: dict = {}
    for okey, skey, commit, receipt, d in live:
        for k in ((okey,), (okey, skey)):
            r, late = count.get(k, (0, 0))
            count[k] = (r + d, late + d * (receipt > commit))
    want: dict = {}
    for okey, skey, commit, receipt, d in live:
        if receipt <= commit or status.get(okey) != f_code or skey not in name:
            continue
        (r_o, l_o), (r_os, l_os) = count[(okey,)], count[(okey, skey)]
        if r_o - r_os > 0 and l_o - l_os == 0:
            want[name[skey]] = want.get(name[skey], 0) + d
    return {(s, c): 1 for s, c in want.items() if c}


def _peek_multiset(rows) -> dict:
    acc: dict = {}
    for r in rows:
        acc[r[:-2]] = acc.get(r[:-2], 0) + r[-1]
    return {k: v for k, v in acc.items() if v}


def _same_parts(jdf, tdf) -> None:
    """Every state part equal, row for row: each run and slot of a join
    spine (cursor included), each arrangement; then the output spine."""
    for jparts, tparts in zip(jdf.states, tdf.states):
        for jp, tp in zip(jparts, tparts):
            if isinstance(tp, Spine):
                assert isinstance(jp, JSpine) and int(jp.cursor or 0) == tp.cursor
                for jb, tb in zip(jp.runs_b + jp.slots, tp.runs_b + tp.slots):
                    assert jb.capacity == tb.capacity
                    _same(jb, tb)
            else:
                assert jp.capacity == tp.capacity
                _same(jp.batch, tp.batch)
    for jb, tb in zip(jdf.output.runs_b, tdf.output.runs_b):
        _same(jb, tb)


def _jpart(p):
    return _jspine_dict(p) if isinstance(p, JSpine) else _jdict_arrangement(p)


def test_q21_dataflow_matches_reference():
    gen = jtpch.TpchGenerator(sf=SF, seed=SEED)
    okeys = np.arange(1, gen.n_orders + 1)
    jt = {name: gen.table_batch(name) for name in ("supplier", "nation")}
    jt["orders"] = JBatch.from_numpy(jtpch.ORDERS_SCHEMA, gen.orders_rows(okeys),
                                     np.zeros(len(okeys), np.uint64),
                                     np.ones(len(okeys), np.int64))
    assert set(jt) == set(Q21_TABLES)
    (hyd,) = gen.snapshot_lineitem_batches(batch_orders=gen.n_orders, time=0)
    li_cap = hyd.capacity
    jempty = {n: JBatch.empty(b.schema, b.capacity) for n, b in jt.items()}

    def port(b, name):
        return interop.batch_from_numpy(_jbatch_dict(b), SCHEMAS[name], "cpu")

    tt = {n: port(b, n) for n, b in jt.items()}
    tempty = {n: Batch.empty(SCHEMAS[n], b.capacity, device="cpu") for n, b in jt.items()}
    h_port = [{"lineitem": port(hyd, "lineitem"), **tt}]

    jdf = JDataflow(_jplan(), state_cap=STATE_CAP)
    tdf = Dataflow(q21_plan(JDICT), state_cap=STATE_CAP, device="cpu")
    assert jdf._ctx.ingest_slots == tdf._ctx.ingest_slots == 0
    assert tdf._covf_keys == jdf._covf_keys and len(tdf.states) == len(jdf.states) == 11
    tiers = q21_tiers(tdf, h_port, ORDERS_PER_TICK, 2 * SPAN, JDICT)
    bench.apply_tiers(jdf, tiers)
    apply_tiers(tdf, tiers)
    _materialize_null_masks(jdf)
    assert tdf._ctx.join_caps == jdf._ctx.join_caps
    # The port's delta-join tier at 1/8 of the reference's: it alone
    # overflows.
    tdf._ctx.join_caps[0] //= 8
    fed: list = []
    dfs = {"tdf": tdf}

    def feed(jbatches, first=False):
        """One span of the same batches into every dataflow; returns
        each port dataflow's (overflowed, flags readbacks)."""
        jdf.run_steps([{"lineitem": b, **(jt if first else jempty)} for b in jbatches],
                      defer_check=True)
        assert jdf.check_flags() is False
        tin = [{"lineitem": port(b, "lineitem"), **(tt if first else tempty)}
               for b in jbatches]
        fed.extend(tin)
        out = {}
        for name, df in dfs.items():
            before = df._readbacks
            df.run_steps(tin, defer_check=True)
            out[name] = (df.check_flags(), df._readbacks - before)
        return out

    def same(peek=True):
        # The states first: a peek folds every spine into its base.
        for name, df in dfs.items():
            _same_parts(jdf, df)
            assert (df.time, df._compact_tick) == (jdf.time, jdf._compact_tick), name
        if not peek:
            return
        want = q21_oracle([x["lineitem"] for x in fed], tt, JDICT)
        got = jdf.peek()
        assert _peek_multiset(got) == want and len(want) >= 1
        for name, df in dfs.items():
            assert df.peek() == got, name
            assert df.peek_errors() == jdf.peek_errors() == [], name

    # three doublings: a readback, then each replay's
    assert feed([hyd], first=True) == {"tdf": (True, 4)}
    assert tdf._ctx.join_caps == jdf._ctx.join_caps
    _same_parts(jdf, tdf)

    cdf = Dataflow(q21_plan(JDICT), state_cap=STATE_CAP, device="cpu")
    interop.install_state(
        cdf, [[_jpart(p) for p in parts] for parts in jdf.states],
        _jspine_dict(jdf.output), _jdict_arrangement(jdf.err_output), jdf.time,
        jdf._compact_tick, jdf._ctx.join_caps,
    )
    _same_parts(jdf, cdf)
    dfs["cdf"] = cdf

    def churn(first):
        return [gen.churn_lineitem_batch(ORDERS_PER_TICK, tick=i, time=jdf.time + i - first,
                                         capacity=li_cap)
                for i in range(first, first + SPAN)]

    assert feed(churn(0)) == {name: (False, 1) for name in dfs}
    same(peek=False)
    # the second span passes tick 8: every spine's level-0 fold
    folds = tdf._folds
    assert feed(churn(SPAN)) == {name: (False, 1) for name in dfs}
    assert jdf._compact_tick == 2 * SPAN + 1 and tdf._folds > folds
    same()
