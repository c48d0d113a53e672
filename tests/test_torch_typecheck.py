"""Port parity for the plan checkers: ``analysis/typecheck.py``, the
optimizer's ``optimizer_typecheck`` hook, the coordinator's durable-plan
gate and ``analysis.report`` (EXPLAIN ANALYSIS's static half).

- The negative fixtures of ``tests/test_analysis_typecheck.py`` (and
  LIR ones): the port's ``typecheck`` and ``typecheck_lir`` raise the
  same code on the same node path with the same message as the
  reference's; the accepted plans type to the same schema.
- With ``optimizer_typecheck`` on (set here, not by the suite's
  conftest, which sets only the reference's flags), a transform that
  corrupts the plan is blamed by the same name in both packages, and a
  clean optimize gives the plan it gives with the flag off.
- ``report()``'s text equals the reference's for Q1, Q7 and Q15
  (``tests/test_torch_sql.py`` compares it for every plan of the SLT
  corpus).
- A durable plan that does not typecheck is refused by the port's
  coordinator before it reaches the replica; a transient one is not
  checked there.
"""

from __future__ import annotations

import pytest

from tests.test_torch_sql import JDICT, _hand_mir, _tpch_catalogs, jplan, tplan, to_port
from tests.torch_serving import mod

PKGS = ("ref", "port")


def _m(pkg):
    S = mod(pkg, "repr.schema")
    return mod(pkg, "expr.relation"), mod(pkg, "expr.scalar"), S


def _schemas(pkg):
    _mir, _ms, S = _m(pkg)
    C, T = S.Column, S.ColumnType
    return (S.Schema((C("a", T.INT64), C("b", T.INT64))), S.Schema((C("a", T.INT64),)),
            S.Schema((C("a", T.FLOAT64),)))


# name -> (check, build(mir, ms, T2, T1, F1) -> (expr, kwargs))
CASES = {
    "project_oob": ("tc", lambda m, s, T2, T1, F1: (m.Project(m.Get("t", T2), (0, 5)), {})),
    "map_oob": ("tc", lambda m, s, T2, T1, F1: (m.Map(m.Get("t", T2), (s.col(7),)), {})),
    "filter_not_bool": ("tc", lambda m, s, T2, T1, F1: (
        m.Filter(m.Get("t", T2), (s.col(0) + s.col(1),)), {})),
    "union_arity": ("tc", lambda m, s, T2, T1, F1: (
        m.Union((m.Get("t", T2), m.Get("u", T1))), {})),
    "union_type": ("tc", lambda m, s, T2, T1, F1: (
        m.Union((m.Get("t", T1), m.Get("u", F1))), {})),
    "let_shadowing": ("tc", lambda m, s, T2, T1, F1: (
        m.Let("x", m.Get("u", T2), m.Let("x", m.Get("t", T2), m.Get("x", T2))), {})),
    "get_vs_binding": ("tc", lambda m, s, T2, T1, F1: (
        m.Let("x", m.Get("t", T2), m.Get("x", T1)), {})),
    "dangling_get": ("tc", lambda m, s, T2, T1, F1: (
        m.Union((m.Let("x", m.Get("t", T2), m.Get("x", T2)), m.Get("x", T2))), {})),
    "letrec_schema": ("tc", lambda m, s, T2, T1, F1: (
        m.LetRec(("r",), (m.Get("t", T2),), (T1,), m.Get("r", T1)), {})),
    "reduce_key_oob": ("tc", lambda m, s, T2, T1, F1: (m.Reduce(m.Get("t", T2), (4,), ()), {})),
    "reduce_agg_arg_oob": ("tc", lambda m, s, T2, T1, F1: (
        m.Reduce(m.Get("t", T2), (0,), (m.AggregateExpr(m.AggregateFunc.SUM_INT, s.col(3)),)),
        {})),
    "topk_order_oob": ("tc", lambda m, s, T2, T1, F1: (
        m.TopK(m.Get("t", T2), (0,), ((9, False, False),), 1), {})),
    "topk_negative_limit": ("tc", lambda m, s, T2, T1, F1: (
        m.TopK(m.Get("t", T2), (0,), ((1, False, False),), -1), {})),
    "join_singleton_class": ("tc", lambda m, s, T2, T1, F1: (
        m.Join((m.Get("t", T2), m.Get("u", T2)), ((s.col(0),),)), {})),
    "join_unknown_impl": ("tc", lambda m, s, T2, T1, F1: (
        m.Join((m.Get("t", T2), m.Get("u", T2)), ((s.col(0), s.col(2)),),
               implementation="hash"), {})),
    "arrange_key_oob": ("tc", lambda m, s, T2, T1, F1: (m.ArrangeBy(m.Get("t", T2), (3,)), {})),
    "sources_mapping": ("tc", lambda m, s, T2, T1, F1: (m.Get("t", T1), {"sources": {"t": T2}})),
    "lir_join_key": ("lir", lambda m, s, T2, T1, F1: (
        m.Join((m.Get("t", T2), m.Get("u", T2), m.Get("v", T2)),
               ((s.col(0) + s.col(2), s.col(4)),), implementation="delta"), {})),
    "ok_pipeline": ("tc", lambda m, s, T2, T1, F1: (
        m.Get("t", T2).filter([s.col(0).gt(s.lit(1))]).map([s.col(0) + s.col(1)])
        .project([2, 0]).reduce((1,), (m.AggregateExpr(m.AggregateFunc.SUM_INT, s.col(0)),)),
        {})),
    "ok_let": ("tc", lambda m, s, T2, T1, F1: (
        m.Let("x", m.Get("t", T2).filter([s.col(0).gt(s.lit(0))]),
              m.Union((m.Get("x", T2), m.Get("x", T2)))), {})),
}


def _outcome(pkg, name):
    mir, ms, _S = _m(pkg)
    an = mod(pkg, "analysis")
    kind, build = CASES[name]
    expr, kw = build(mir, ms, *_schemas(pkg))
    try:
        if kind == "tc":
            sch = an.typecheck(expr, **kw)
            return ("ok", [(c.ctype.value, c.nullable, c.scale) for c in sch.columns])
        an.typecheck_lir(expr)
        return ("ok", None)
    except an.TypecheckError as e:
        return (e.code, e.path, str(e))


@pytest.mark.parametrize("name", sorted(CASES))
def test_typecheck_codes_and_paths_match_reference(name):
    got = {pkg: _outcome(pkg, name) for pkg in PKGS}
    assert got["port"] == got["ref"]
    assert (got["port"][0] == "ok") == name.startswith("ok_"), got["port"]


def _corrupt(pkg, how):
    mir = mod(pkg, "expr.relation")

    def evil_transform(e):
        return mir.Project(e, (99,))

    def drops_a_column(e):
        return mir.Project(e, (0,))

    return {"evil": evil_transform, "drop": drops_a_column}[how]


@pytest.mark.parametrize("how", ["evil", "drop"])
def test_a_corrupting_transform_is_blamed_by_name(how, monkeypatch):
    """Under ``optimizer_typecheck`` a transform inserted into the
    logical set that breaks the plan (a projection out of bounds; one
    that drops a column) raises TransformTypecheckError naming it, in
    both packages, with the same text."""
    msgs = {}
    for pkg in PKGS:
        opt = mod(pkg, "transform.optimizer")
        an = mod(pkg, "analysis")
        cfg = mod(pkg, "utils.dyncfg").COMPUTE_CONFIGS
        T2 = _schemas(pkg)[0]
        monkeypatch.setattr(opt, "LOGICAL_TRANSFORMS",
                            opt.LOGICAL_TRANSFORMS + (_corrupt(pkg, how),))
        prior = cfg.get("optimizer_typecheck")
        cfg.update({"optimizer_typecheck": True})
        try:
            with pytest.raises(an.TransformTypecheckError) as ei:
                opt.optimize(mod(pkg, "expr.relation").Get("t", T2))
        finally:
            cfg.update({"optimizer_typecheck": prior})
        assert ei.value.transform == {"evil": "evil_transform", "drop": "drops_a_column"}[how]
        msgs[pkg] = str(ei.value)
    assert msgs["port"] == msgs["ref"]


def _tpch_exprs():
    """Q1 and Q15 (the reference's hand MIR, converted) and Q7 (its text
    planned by each package's frontend), optimized by each package."""
    from materialize_tpu.transform import optimizer as joptimizer
    from materialize_tpu_torch.transform import optimizer as toptimizer
    from materialize_tpu_torch.workloads.tpch import Q7_SQL

    out = {}
    for name in ("q1", "q15"):
        mir = _hand_mir()[name]()
        out[name] = (joptimizer.optimize(mir), toptimizer.optimize(to_port(mir)))
    jcat, tcat = _tpch_catalogs()
    out["q7"] = (joptimizer.optimize(jplan.plan_statement(Q7_SQL, jcat).expr),
                 toptimizer.optimize(tplan.plan_statement(Q7_SQL, tcat,
                                                          dictionary=JDICT).expr))
    return out


def test_report_and_flagged_optimize_match_reference():
    """``report()`` of Q1, Q7 and Q15 is the reference's text; with
    ``optimizer_typecheck`` on the port optimizes each to the plan it
    gives with the flag off, blaming no transform."""
    from materialize_tpu.analysis import report as jreport
    from materialize_tpu_torch.analysis import report as treport
    from materialize_tpu_torch.transform import optimizer as toptimizer
    from materialize_tpu_torch.utils.dyncfg import COMPUTE_CONFIGS

    exprs = _tpch_exprs()
    for name, (j, t) in exprs.items():
        text = treport(t)
        assert text == jreport(j), name
        assert text.startswith("typecheck: ok") and text.endswith("lir: ok"), text
    mir = _hand_mir()["q1"]()
    COMPUTE_CONFIGS.update({"optimizer_typecheck": True})
    try:
        checked = toptimizer.optimize(to_port(mir))
    finally:
        COMPUTE_CONFIGS.update({"optimizer_typecheck": None})
    assert checked == exprs["q1"][1]


def test_coordinator_refuses_a_durable_plan_that_does_not_typecheck(tmp_path, monkeypatch):
    from tests.torch_serving import Cluster

    coord_mod = mod("port", "coord.coordinator")
    an = mod("port", "analysis")
    cl = Cluster("port", str(tmp_path))
    try:
        c = cl.coordinator()
        c.execute("CREATE TABLE tt (a bigint NOT NULL, b bigint NOT NULL)")
        c.execute("INSERT INTO tt VALUES (1, 2)")
        real = coord_mod.optimize

        def broken(expr):
            out = real(expr)
            return mod("port", "expr.relation").Project(out, (0, 7))

        monkeypatch.setattr(coord_mod, "optimize", broken)
        with pytest.raises(an.TypecheckError, match="T-ARITY"):
            c.execute("CREATE MATERIALIZED VIEW bad AS SELECT a FROM tt")
        monkeypatch.setattr(coord_mod, "optimize", real)
        assert "bad" not in c.catalog.items
        c.execute("CREATE MATERIALIZED VIEW good AS SELECT a FROM tt")
        assert c.execute("SELECT * FROM good").rows == [(1,)]
    finally:
        cl.shutdown()
