"""Port parity for TPC-H Q7 planned from its text (``Q7_SQL``) by the
port's own SQL frontend and optimizer: a 6-input delta join with nation
twice and a Filter inside the lineitem input (the BETWEEN as one AND),
then the OR of the two nation pairs, EXTRACT(YEAR) and the volume summed
by (supp_nation, cust_nation, l_year).

- ``q7_expr()``, planned by the port, equals the reference's
  ``optimize(plan_statement(Q7_SQL, catalog).expr)`` converted into the
  port's classes (the port plans with the reference's dictionary here,
  so the string codes compare literally).
- The port's customer and region tables equal the reference generator's
  (strings compared decoded: each package keeps its own dictionary).
- Q7 runs in the reference and in the port on the SAME numpy batches of
  ``TpchGenerator(sf=0.002, seed=42)`` (seed 42: the view holds two
  rows, GERMANY to FRANCE in 1995 and 1996; the port's plan takes its
  string literals from the reference's dictionary, which codes the
  shared batches), staggered as ``q7_stagger`` feeds them: nation and
  supplier on the first tick, customer on the second, every order and
  the whole lineitem snapshot on the third; then 2 churn spans of 3
  ticks of 48 orders, the second passing the tick-8 fold (every span 3
  ticks: the reference compiles one step program). Both run at state tier
  1024 (merge ingest; the bench's slotted layout would take the
  reference minutes to compile), pre-sized by the same tiers
  (``q7_tiers``). The port's join tier starts at half the reference's:
  it alone overflows, rolls back, grows and replays, back to the
  reference's tier. After every span every state part (each run
  of every join spine) and the output equal the reference's; after the
  last, the peek equals the reference's and a plain-Python oracle. The
  reference's state after hydration, carried into a fresh port dataflow
  with ``interop.install_state``, churns onward to the same states.
- The port alone in Q9's slotted layout (``q7_config``: every spine a
  ring of 8 slots, the tables staggered, tiers from ``q7_tiers``) at SF
  0.001 (seed 26: the view holds three rows) against the oracle over 4
  hydrate ticks (2 of lineitem) and 4 churn ticks, the last flushing
  every ring.
Every value is an integer: tolerance 0. One reference dataflow is
stepped in the file: its compiles dominate the run time.
"""

from __future__ import annotations

import datetime

import numpy as np
import pytest
import torch

import bench
from materialize_tpu.repr.batch import Batch as JBatch
from materialize_tpu.repr.schema import GLOBAL_DICT as JDICT
from materialize_tpu.sql import catalog as jcatalog
from materialize_tpu.sql.plan import plan_statement
from materialize_tpu.storage.generator import tpch as jtpch
from materialize_tpu.transform.optimizer import optimize
from materialize_tpu_torch import interop
from materialize_tpu_torch.arrangement.spine import Spine
from materialize_tpu_torch.repr.batch import Batch
from materialize_tpu_torch.repr.schema import GLOBAL_DICT as TDICT
from materialize_tpu_torch.storage.generator import tpch as ttpch
from materialize_tpu_torch.workloads.index import build_lineitem_dataflow
from materialize_tpu_torch.workloads.tpch import (
    Q7_HI,
    Q7_LO,
    Q7_SQL,
    Q7_TABLES,
    apply_tiers,
    q7_config,
    q7_expr,
    q7_stagger,
    q7_tiers,
)
from tests.test_torch_dataflow import _jbatch_dict, _jspine_dict
from tests.test_torch_q1 import _jdict_arrangement
from tests.test_torch_q9 import MERGE_LAYOUT, _decoded, _materialize_null_masks
from tests.test_torch_q21 import _jpart, _peek_multiset, _same_parts
from tests.test_torch_sql import to_port

SF, SEED, ORDERS_PER_TICK, SPAN = 0.002, 42, 48, 3
SCHEMAS = {n: getattr(ttpch, f"{n.upper()}_SCHEMA")
           for n in ("lineitem", "supplier", "nation", "customer", "orders", "region")}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's eager ops here are small: one intra-op thread runs them
    about as fast, and does not contend with other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jexpr():
    cat = jcatalog.Catalog()
    for name in ("lineitem", "orders", "part", "partsupp", "supplier", "customer",
                 "nation", "region"):
        cat.create(jcatalog.CatalogItem(name, "source",
                                        getattr(jtpch, f"{name.upper()}_SCHEMA")))
    return optimize(plan_statement(Q7_SQL, cat).expr)


def test_q7_plan_equals_the_reference_planner_output():
    want = to_port(_jexpr())
    got = q7_expr(JDICT)
    assert got == want and got.schema() == want.schema()
    # the shape the slice was written for: one 6-input delta join with
    # nation twice, the BETWEEN as one AND inside the lineitem input, the
    # OR after the join
    from materialize_tpu_torch.expr import relation as mir

    def find(e, cls):
        if isinstance(e, cls):
            yield e
        for c in e.children():
            yield from find(c, cls)

    (join,) = find(got, mir.Join)
    assert join.implementation == "delta" and len(join.inputs) == 6
    assert len(join.equivalences) == 5
    assert [getattr(i, "name", None) for i in join.inputs].count("nation") == 2
    funcs = {getattr(p, "func", None) for f in find(got, mir.Filter) for p in f.predicates}
    assert {"and", "or"} <= funcs


@pytest.mark.parametrize("name", ["customer", "region"])
def test_customer_and_region_tables_equal_reference(name):
    jb = jtpch.TpchGenerator(sf=0.01, seed=SEED).table_batch(name)
    tb = ttpch.TpchGenerator(sf=0.01, seed=SEED).table_batch(name, device="cpu")
    schema = SCHEMAS[name]
    assert [(c.name, c.ctype.value, c.scale) for c in jb.schema.columns] == [
        (c.name, c.ctype.value, c.scale) for c in schema.columns]
    n = int(jb.count)
    assert int(tb.count) == n > 0 and tb.capacity == jb.capacity
    jcols = _decoded([np.asarray(c)[:n] for c in jb.cols], schema,
                     lambda c: JDICT.decode_many(np.asarray(c)))
    tcols = _decoded([c[:n].numpy() for c in tb.cols], schema,
                     lambda c: [TDICT.decode(int(x)) for x in c])
    assert jcols == tcols
    assert np.array_equal(np.asarray(jb.diff)[:n], tb.diff[:n].numpy())


def q7_oracle(lineitems: list, tables: dict, dictionary=TDICT) -> dict:
    """TPC-H Q7 over every lineitem row fed, each weighted by its diff,
    in plain Python: {(supp_nation code, cust_nation code, l_year,
    revenue at scale 4): 1} for the groups whose sum is nonzero.
    ``tables`` holds port batches, their strings coded by
    ``dictionary``."""
    def rows(name):
        b = tables[name]
        n = int(b.count)
        return list(zip(*[c[:n].tolist() for c in b.cols]))

    fr, de = dictionary.encode("FRANCE"), dictionary.encode("GERMANY")
    nation = {r[0]: r[2] for r in rows("nation")}
    supp = {r[0]: nation[r[1]] for r in rows("supplier")}
    cust = {r[0]: nation[r[1]] for r in rows("customer")}
    order_cust = {r[0]: r[1] for r in rows("orders")}
    total: dict = {}
    epoch = datetime.date(1970, 1, 1)
    for b in lineitems:
        n = int(b.count)
        cols = [c[:n].tolist() for c in b.cols]
        for okey, skey, ext, disc, ship, d in zip(cols[0], cols[2], cols[5], cols[6],
                                                  cols[10], b.diff[:n].tolist()):
            if not Q7_LO <= ship <= Q7_HI:
                continue
            pair = (supp[skey], cust[order_cust[okey]])
            if pair not in ((fr, de), (de, fr)):
                continue
            g = (*pair, (epoch + datetime.timedelta(days=ship)).year)
            total[g] = total.get(g, 0) + d * ext * (100 - disc)
    return {(*g, v): 1 for g, v in total.items() if v}


def test_q7_dataflow_matches_reference():
    gen = jtpch.TpchGenerator(sf=SF, seed=SEED)
    okeys = np.arange(1, gen.n_orders + 1)
    jt = {name: gen.table_batch(name) for name in ("supplier", "nation", "customer")}
    jt["orders"] = JBatch.from_numpy(jtpch.ORDERS_SCHEMA, gen.orders_rows(okeys),
                                     np.zeros(len(okeys), np.uint64),
                                     np.ones(len(okeys), np.int64))
    assert set(jt) == set(Q7_TABLES)
    (hyd,) = gen.snapshot_lineitem_batches(batch_orders=gen.n_orders, time=0)
    li_cap = hyd.capacity
    jempty = {n: JBatch.empty(b.schema, b.capacity) for n, b in jt.items()}
    jempty["lineitem"] = JBatch.empty(hyd.schema, li_cap)
    # q7_stagger's order: nation and supplier, customer, then orders with
    # the lineitem snapshot
    jhydrate = [{**jempty, "nation": jt["nation"], "supplier": jt["supplier"]},
                {**jempty, "customer": jt["customer"]},
                {**jempty, "orders": jt["orders"], "lineitem": hyd}]

    def port(b, name):
        return interop.batch_from_numpy(_jbatch_dict(b), SCHEMAS[name], "cpu")

    tempty = {n: Batch.empty(SCHEMAS[n], b.capacity, device="cpu") for n, b in jempty.items()}
    tt = {n: port(b, n) for n, b in jt.items()}

    jdf, _, _ = bench._tpch_lineitem_config(_jexpr(), sf=SF, n_orders_per_tick=ORDERS_PER_TICK,
                                            state_cap=MERGE_LAYOUT["state_cap"])
    tdf, _, _ = build_lineitem_dataflow(q7_expr(JDICT), ORDERS_PER_TICK, device="cpu",
                                        **MERGE_LAYOUT)
    assert jdf._ctx.ingest_slots == tdf._ctx.ingest_slots == 0
    assert tdf._covf_keys == jdf._covf_keys
    thydrate = q7_stagger([{"lineitem": port(hyd, "lineitem"), **tt}])
    assert [sorted(n for n, b in inp.items() if int(b.count)) for inp in thydrate] == [
        sorted(n for n, b in inp.items() if int(b.count)) for inp in jhydrate]
    tiers = q7_tiers(tdf, thydrate, ORDERS_PER_TICK, 2 * SPAN)
    bench.apply_tiers(jdf, tiers)
    apply_tiers(tdf, tiers)
    _materialize_null_masks(jdf)
    assert tdf._ctx.join_caps == jdf._ctx.join_caps == [4096]
    # The port's delta-join tier at half the reference's: it alone
    # overflows.
    tdf._ctx.join_caps[0] //= 2
    fed: list = []
    dfs = {"tdf": tdf}

    def feed(jinputs):
        """One span of the same inputs into every dataflow; returns each
        port dataflow's (overflowed, flags readbacks)."""
        jdf.run_steps(jinputs, defer_check=True)
        assert jdf.check_flags() is False
        tin = [{n: port(b, n) if int(b.count) else tempty[n] for n, b in inp.items()}
               for inp in jinputs]
        fed.extend(tin)
        out = {}
        for name, df in dfs.items():
            before = df._readbacks
            df.run_steps(tin, defer_check=True)
            out[name] = (df.check_flags(), df._readbacks - before)
        return out

    def same():
        for name, df in dfs.items():
            _same_parts(jdf, df)
            assert (df.time, df._compact_tick) == (jdf.time, jdf._compact_tick), name

    # one doubling: a readback, then the replay's
    assert feed(jhydrate) == {"tdf": (True, 2)}
    assert tdf._ctx.join_caps == jdf._ctx.join_caps
    same()

    cdf, _, _ = build_lineitem_dataflow(q7_expr(JDICT), ORDERS_PER_TICK, device="cpu",
                                        **MERGE_LAYOUT)
    interop.install_state(
        cdf, [[_jpart(p) for p in parts] for parts in jdf.states],
        _jspine_dict(jdf.output), _jdict_arrangement(jdf.err_output), jdf.time,
        jdf._compact_tick, jdf._ctx.join_caps,
    )
    dfs["cdf"] = cdf
    same()

    def churn(first):
        return [{**jempty, "lineitem": gen.churn_lineitem_batch(
            ORDERS_PER_TICK, tick=i, time=jdf.time + i - first, capacity=li_cap)}
            for i in range(first, first + SPAN)]

    assert feed(churn(0)) == {name: (False, 1) for name in dfs}
    same()
    # the second span passes tick 8: every spine's level-0 fold
    folds = tdf._folds
    assert feed(churn(SPAN)) == {name: (False, 1) for name in dfs}
    assert tdf._folds > folds
    same()
    want = q7_oracle([x["lineitem"] for x in fed], tt, JDICT)
    got = jdf.peek()
    assert _peek_multiset(got) == want and len(want) == 2
    for name, df in dfs.items():
        assert df.peek() == got, name
        assert df.peek_errors() == jdf.peek_errors() == [], name


# Seed 26: the view holds three rows at SF 0.001.
SLOT_SF, SLOT_SEED, SLOT_HYDRATE = 0.001, 26, 896


def test_q7_slotted_layout_matches_oracle():
    df, hydrate, churn = q7_config(sf=SLOT_SF, n_orders_per_tick=16,
                                   hydrate_orders=SLOT_HYDRATE, seed=SLOT_SEED, device="cpu")
    h = hydrate()
    assert len(h) == 4 and df._ctx.ingest_slots == 8
    spines = [sp for parts in df.states for sp in parts if isinstance(sp, Spine)]
    assert len(spines) == 10 and all(len(sp.slots) == 8 for sp in spines)
    apply_tiers(df, q7_tiers(df, h, 16, 4))
    assert df._ctx.join_caps == [2048]
    before = df._readbacks
    df.run_steps(h, defer_check=True)
    assert df.check_flags() is False and df._readbacks - before == 1
    # 4 churn ticks: the eighth tick flushes every ring into run 0.
    c = [churn(i, len(h) + i)[0] for i in range(4)]
    df.run_steps(c, defer_check=True)
    assert df.check_flags() is False
    assert all(sp.cursor == 0 for parts in df.states for sp in parts if isinstance(sp, Spine))
    tables = {n: next(inp[n] for inp in h if int(inp[n].count)) for n in Q7_TABLES}
    want = q7_oracle([x["lineitem"] for x in h + c], tables)
    got = {r[:4]: r[-1] for r in df.peek()}
    assert got == want and len(want) == 3
    assert df.peek_errors() == []
