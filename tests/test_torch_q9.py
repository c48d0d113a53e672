"""Port parity for TPC-H Q9 as a maintained dataflow (the 6-input delta
join, EXTRACT(YEAR), the (n_name, o_year) group key).

- The port's ``workloads/tpch.py:q9_plan`` equals the reference
  optimizer's ``optimize(q9_mir())``, converted into the port's MIR
  classes by walking its attributes.
- The port's part, supplier, partsupp, nation and orders tables equal
  the reference generator's at SF 0.01, strings compared decoded (the
  two packages keep separate string dictionaries).
- Q9 runs in the reference and in the port on the SAME numpy batches of
  ``TpchGenerator(sf=0.002)``: 4 hydrate ticks of 896 orders (the five
  static tables ride the first), then 2 churn spans of 4 ticks, the
  first ending on the tick-8 fold. The reference runs at state tier
  1024, where the join's ten spines take merge ingest: in the bench's
  layout (tier 2^16, a ring of 8 slots per spine) one reference step
  program takes ~275 s to compile on a CPU, beyond any test budget.
  Beside it run ``mdf``, the port in the same layout, whose join tier
  starts at half the reference's, so it alone overflows, rolls back and
  replays, and ``cdf``, carrying the reference's state after hydration
  (``install_state``). Every input keeps one capacity on every tick and
  both packages are pre-sized to the same tiers (``bench.apply_tiers``
  and the port's ``apply_tiers`` on ``q9_tiers``), so the reference
  compiles one step program. After hydration and the first span the
  maintained output (every run, not compacted, so the fold schedule
  runs on) must equal the reference's and a numpy oracle's; after the
  second span ``peek()`` must. ``mdf`` must hold the reference's tiers,
  with one flags readback per churn span.
- The bench's layout rendered by the reference (built, never stepped)
  and by the port: the same ten slotted spines, fold keys and tiers,
  before and after the same ``apply_tiers`` dict.
- The port in the bench's slotted layout (``q9_config``: ten spines with
  a ring of 8 slots each) against the same oracle at SF 0.0005, in
  hydrate ticks of 200 orders (a join tier of 1024: the probes of ten
  runs and slots each cost the CPU per row of the tier): the orders
  ring, left at its default tier, overflows on the first tick, grows
  and replays; every ring flushes into run 0 at tick 8 and takes the
  next ticks from slot 0 on; the state mid-ring (cursor 3), carried as
  numpy by ``install_state``, reads the same.
Every value is an integer: tolerance 0. One reference dataflow is
stepped in the file: its compiles dominate the run time.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import pytest
import torch

import bench
from materialize_tpu.arrangement.spine import Spine as JSpine
from materialize_tpu.repr.batch import Batch as JBatch
from materialize_tpu.repr.schema import GLOBAL_DICT as JDICT
from materialize_tpu.storage.generator import tpch as jtpch
from materialize_tpu.transform.optimizer import optimize
from materialize_tpu.workloads.tpch import q9_mir
from materialize_tpu_torch import interop
from materialize_tpu_torch.repr.batch import Batch
from materialize_tpu_torch.repr.schema import GLOBAL_DICT as TDICT
from materialize_tpu_torch.repr.schema import ColumnType
from materialize_tpu_torch.storage.generator import tpch as ttpch
from materialize_tpu_torch.workloads.index import build_lineitem_dataflow
from materialize_tpu_torch.workloads.tpch import (
    Q9_LAYOUT,
    Q9_TABLES,
    apply_tiers,
    _spine_table,
    q9_config,
    q9_plan,
    q9_tables,
    q9_tiers,
)
from tests.test_torch_dataflow import _jbatch_dict, _jmultiset, _jspine_dict, _tmultiset
from tests.test_torch_q1 import _convert, _jdict_arrangement
from tests.test_torch_q15 import _tiers

SF, ORDERS_PER_TICK, SPAN = 0.002, 16, 4
# The reference's layout here: Q9's, at a state tier below 8x the ingest
# tier (merge ingest, no slot ring).
MERGE_LAYOUT = dict(Q9_LAYOUT, state_cap=1024)
SCHEMAS = {"lineitem": ttpch.LINEITEM_SCHEMA, "part": ttpch.PART_SCHEMA,
           "supplier": ttpch.SUPPLIER_SCHEMA, "partsupp": ttpch.PARTSUPP_SCHEMA,
           "nation": ttpch.NATION_SCHEMA, "orders": ttpch.ORDERS_SCHEMA}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's eager ops here are small: one intra-op thread runs them
    about as fast, and does not contend with other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_q9_plan_equals_the_reference_optimizer_output():
    want = _convert(optimize(q9_mir()))
    assert q9_plan() == want
    assert q9_plan().schema() == want.schema()


def _jtables(gen) -> dict:
    """The reference bench's Q9 side tables (``bench.py:config_q9``)."""
    okeys = np.arange(1, gen.n_orders + 1, dtype=np.int64)
    out = {name: gen.table_batch(name) for name in Q9_TABLES[:4]}
    out["orders"] = JBatch.from_numpy(jtpch.ORDERS_SCHEMA, gen.orders_rows(okeys),
                                      np.uint64(0), np.ones(len(okeys), np.int64))
    return out


def _decoded(cols, schema, decode) -> list:
    return [decode(c) if col.ctype is ColumnType.STRING else np.asarray(c).tolist()
            for c, col in zip(cols, schema.columns)]


@pytest.mark.parametrize("name", Q9_TABLES)
def test_q9_tables_equal_reference(name):
    jb = _jtables(jtpch.TpchGenerator(sf=0.01, seed=42))[name]
    tb = q9_tables(ttpch.TpchGenerator(sf=0.01, seed=42), device="cpu")[name]
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
    assert np.array_equal(np.asarray(jb.time)[:n].view(np.int64), tb.time[:n].numpy())


def _year(days: int) -> int:
    return int(str((np.datetime64("1970-01-01") + np.timedelta64(days, "D"))
                   .astype("datetime64[Y]")))


def q9_oracle(lineitems: list, tables: dict) -> dict:
    """TPC-H Q9 over every lineitem row fed, each weighted by its diff,
    in plain Python (as ``tests/test_delta_join.py:TestQ9``): {(n_name
    code, o_year, sum_profit scale 4): 1} for the groups whose rows net
    to a nonzero count."""
    def rows(name):
        b = tables[name]
        n = int(b.count)
        return list(zip(*[np.asarray(c)[:n].tolist() for c in b.cols]))

    parts = {r[0] for r in rows("part")}
    supp = {r[0]: r[1] for r in rows("supplier")}
    cost = {(r[0], r[1]): r[2] for r in rows("partsupp")}
    odate = {r[0]: r[4] for r in rows("orders")}
    nation = {r[0]: r[2] for r in rows("nation")}
    total, count = defaultdict(int), defaultdict(int)
    for b in lineitems:
        n = int(b.count)
        cols = [np.asarray(c)[:n].tolist() for c in b.cols]
        for okey, pkey, skey, qty, ext, disc, d in zip(*cols[:3], *cols[4:7],
                                                        np.asarray(b.diff)[:n].tolist()):
            if pkey not in parts or skey not in supp or (pkey, skey) not in cost \
                    or okey not in odate:
                continue
            g = (nation[supp[skey]], _year(odate[okey]))
            total[g] += d * (ext * (100 - disc) - cost[(pkey, skey)] * qty)
            count[g] += d
    return {(*g, total[g]): 1 for g in total if count[g]}


def test_q9_dataflow_matches_reference():
    gen = jtpch.TpchGenerator(sf=SF, seed=42)
    jdf, _, _ = bench._tpch_lineitem_config(
        optimize(q9_mir()), sf=SF, n_orders_per_tick=ORDERS_PER_TICK,
        extra_inputs_fn=_jtables, state_cap=MERGE_LAYOUT["state_cap"],
    )
    mdf, h_orders, churn_cap = build_lineitem_dataflow(
        q9_plan(), ORDERS_PER_TICK, device="cpu", **MERGE_LAYOUT)
    assert jdf._ctx.ingest_slots == mdf._ctx.ingest_slots == 0
    assert mdf._covf_keys == jdf._covf_keys
    tiers = q9_tiers(mdf, ttpch.TpchGenerator(sf=SF, seed=42), h_orders, ORDERS_PER_TICK,
                     2 * SPAN)
    bench.apply_tiers(jdf, tiers)
    apply_tiers(mdf, tiers)
    assert _tiers(mdf) == _tiers(jdf) and mdf._ctx.join_caps == jdf._ctx.join_caps
    _materialize_null_masks(jdf)
    # The port's join tier at half the reference's: it alone overflows.
    mdf._ctx.join_caps[0] //= 2

    jt = _jtables(gen)
    jempty = {n: JBatch.empty(b.schema, b.capacity) for n, b in jt.items()}
    tt = {n: interop.batch_from_numpy(_jbatch_dict(b), SCHEMAS[n], "cpu") for n, b in jt.items()}
    tempty = {n: Batch.empty(SCHEMAS[n], b.capacity, device="cpu") for n, b in jt.items()}
    fed: list = []
    dfs = {"mdf": mdf}

    def feed(jbatches, first=False):
        """One span of the same batches into every dataflow; returns
        each port dataflow's (overflowed, flags readbacks)."""
        jdf.run_steps([{"lineitem": b, **(jt if first and k == 0 else jempty)}
                       for k, b in enumerate(jbatches)], defer_check=True)
        assert jdf.check_flags() is False
        fed.extend(jbatches)
        tin = [{"lineitem": interop.batch_from_numpy(_jbatch_dict(b), SCHEMAS["lineitem"],
                                                     "cpu"),
                **(tt if first and k == 0 else tempty)} for k, b in enumerate(jbatches)]
        out = {}
        for name, df in dfs.items():
            before = df._readbacks
            df.run_steps(tin, defer_check=True)
            out[name] = (df.check_flags(), df._readbacks - before)
        return out

    def same_output(want):
        assert _jmultiset(jdf.output) == want
        for name, df in dfs.items():
            assert _tmultiset(df.output) == want, name
            assert (df.time, df._compact_tick) == (jdf.time, jdf._compact_tick), name
        assert _tiers(mdf) == _tiers(jdf)

    hyd = list(gen.snapshot_lineitem_batches(batch_orders=h_orders, capacity=churn_cap))
    assert len(hyd) == 4
    # mdf's join tier overflows: one readback, then the replay's
    assert feed(hyd, first=True) == {"mdf": (True, 2)}
    assert mdf._ctx.join_caps == jdf._ctx.join_caps
    want = q9_oracle(fed, jt)
    assert len(want) > 50
    same_output(want)

    # the reference's state after hydration, carried into a fresh port dataflow
    cdf, _, _ = build_lineitem_dataflow(q9_plan(), ORDERS_PER_TICK, device="cpu",
                                        **MERGE_LAYOUT)
    interop.install_state(
        cdf, [[_jpart(p) for p in parts] for parts in jdf.states],
        _jspine_dict(jdf.output), _jdict_arrangement(jdf.err_output), jdf.time,
        jdf._compact_tick,
        jdf._ctx.join_caps,
    )
    assert _tiers(cdf) == _tiers(jdf)
    dfs["cdf"] = cdf

    def churn(first):
        return [gen.churn_lineitem_batch(ORDERS_PER_TICK, tick=i,
                                         time=jdf.time + i - first, capacity=churn_cap)
                for i in range(first, first + SPAN)]

    # span 1 ends on tick 8: the output's and the join spines' level-0 fold
    assert feed(churn(0)) == {name: (False, 1) for name in dfs}
    assert jdf._compact_tick == 2 * SPAN
    assert all(int(sp.runs_b[0].count) == 0 for sp in mdf.states[1])
    same_output(q9_oracle(fed, jt))
    assert feed(churn(SPAN)) == {name: (False, 1) for name in dfs}
    want = sorted(r[:3] for r in q9_oracle(fed, jt))
    got = jdf.peek()
    assert sorted(r[:3] for r in got) == want and all(r[-1] == 1 for r in got)
    assert jdf.peek_errors() == []
    for name, df in dfs.items():
        assert df.peek() == got, name
        assert df.peek_errors() == [], name
    assert _tiers(mdf) == _tiers(jdf)



def _materialize_null_masks(jdf) -> None:
    """Give every nullable column of the reference's state a null mask
    (all False where it had none): the masks an insert or fold would
    materialize later, which would change the step program's input
    structure and recompile it mid-test. Rows and tiers are unchanged."""
    def canon(p):
        if isinstance(p, JSpine):
            return JSpine(tuple(b.canonicalize_nulls() for b in p.runs_b), p.key, p.order,
                          tuple(s.canonicalize_nulls() for s in p.slots), p.cursor,
                          p.lanes, p.slot_lanes)
        return p.map_batches(lambda b: b.canonicalize_nulls())

    jdf.states = [tuple(canon(p) for p in parts) for parts in jdf.states]
    jdf.output = canon(jdf.output)
    jdf.err_output = canon(jdf.err_output)


def _jpart(p):
    return _jspine_dict(p) if isinstance(p, JSpine) else _jdict_arrangement(p)


SLOT_SF, SLOT_HYDRATE = 0.0008, 200


def _slot_tiers(df):
    return [[len(sp.slots), sp.slots[0].capacity, int(sp.cursor or 0)]
            for sp in df.states[1]]


def test_q9_bench_layout_renders_as_the_reference():
    """The bench's layout (state tier 2^16), rendered by the reference and
    never stepped: the same ten slotted spines, fold keys and tiers, and
    the same growth of every slot of a ring by ``(part, "tail")`` under
    the same ``apply_tiers`` dict."""
    jdf, _, _ = bench._tpch_lineitem_config(
        optimize(q9_mir()), sf=SLOT_SF, n_orders_per_tick=ORDERS_PER_TICK,
        extra_inputs_fn=_jtables, state_cap=Q9_LAYOUT["state_cap"],
    )
    tdf, hydrate, _ = q9_config(sf=SLOT_SF, n_orders_per_tick=ORDERS_PER_TICK, device="cpu",
                                hydrate_orders=SLOT_HYDRATE)
    assert jdf._ctx.ingest_slots == tdf._ctx.ingest_slots == 8
    assert tdf._covf_keys == jdf._covf_keys and len(tdf._covf_keys) == 21
    assert _tiers(tdf) == _tiers(jdf) and _slot_tiers(tdf) == _slot_tiers(jdf)
    tiers = q9_tiers(tdf, ttpch.TpchGenerator(sf=SLOT_SF, seed=42), SLOT_HYDRATE,
                     ORDERS_PER_TICK, 5)
    bench.apply_tiers(jdf, tiers)
    apply_tiers(tdf, tiers)
    assert _tiers(tdf) == _tiers(jdf) and _slot_tiers(tdf) == _slot_tiers(jdf)
    assert {s.capacity for s in tdf.states[1][3].slots} == {2048}  # the orders ring
    assert tdf._ctx.join_caps == jdf._ctx.join_caps == [1024]


def test_q9_slotted_layout_matches_oracle():
    df, hydrate, churn = q9_config(sf=SLOT_SF, n_orders_per_tick=ORDERS_PER_TICK,
                                   device="cpu", hydrate_orders=SLOT_HYDRATE)
    gen = ttpch.TpchGenerator(sf=SLOT_SF, seed=42)
    tiers = q9_tiers(df, gen, SLOT_HYDRATE, ORDERS_PER_TICK, 5)
    orders_ring = ("state", 1, (3, "tail"))
    assert _spine_table(df.states[1][3]) == "orders"
    apply_tiers(df, {**tiers, "grow": [g for g in tiers["grow"] if g[0] != orders_ring]})
    rings = df.states[1]
    assert df._ctx.ingest_slots == 8 and all(len(sp.slots) == 8 for sp in rings)
    assert rings[3].slots[0].capacity < gen.n_orders and df._ctx.join_caps == [1024]
    h = hydrate()
    c = [churn(i, len(h) + i)[0] for i in range(5)]
    assert len(h) == 6
    tables = {n: b for n, b in h[0].items() if n != "lineitem"}

    def oracle(inputs):
        return q9_oracle([i["lineitem"] for i in inputs], tables)

    before = df._readbacks
    df.run_span(h + c[:2])
    # the orders ring overflowed on the first tick: rolled back, grown
    # (every slot of the ring), replayed
    assert df.check_flags() is True and df._readbacks - before == 2
    rings = df.states[1]
    assert {s.capacity for s in rings[3].slots} == {2048}
    # tick 8 flushed every ring into run 0
    assert df._compact_tick == 8
    assert all(sp.cursor == 0 and not any(int(s.count) for s in sp.slots) for sp in rings)
    assert int(rings[3].runs_b[0].count) == gen.n_orders
    assert _tmultiset(df.output) == oracle(h + c[:2])
    df.run_steps(c[2:], defer_check=True)
    assert df.check_flags() is False
    rings = df.states[1]
    assert all(sp.cursor == 3 for sp in rings)
    assert all(int(sp.slots[0].count) > 0 for sp in rings[5:9])  # lineitem's
    # the state mid-ring (slots, slot lanes, cursors) carried as numpy
    # into a fresh dataflow by install_state
    cdf, _, _ = q9_config(sf=SLOT_SF, n_orders_per_tick=ORDERS_PER_TICK, device="cpu",
                          hydrate_orders=SLOT_HYDRATE)
    interop.install_state(
        cdf, [[interop.spine_to_numpy(p) if hasattr(p, "runs_b")
               else interop.arrangement_to_numpy(p) for p in parts] for parts in df.states],
        interop.spine_to_numpy(df.output), interop.arrangement_to_numpy(df.err_output),
        df.time, df._compact_tick, df._ctx.join_caps,
    )
    assert [sp.cursor for sp in cdf.states[1]] == [3] * 10
    want = oracle(h + c)
    got = df.peek()
    assert len(want) > 20 and {r[:3]: r[-1] for r in got} == want
    assert df.peek_errors() == []
    assert cdf.peek() == got
