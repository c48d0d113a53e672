"""Port parity for the SQL frontend and the optimizer: the port's
``sql/`` (lexer, parser, HIR planning, decorrelation, statement
planning), ``transform/`` (optimizer, CSE) and ``analysis/monotonic.py``
against the reference's.

- Every ``statement`` and ``query`` record of ``tests/slt/*.slt`` is one
  case. Each file's records are planned in order in both packages, each
  package with a catalog of its own built from the file's DDL (CREATE
  TABLE, CREATE [MATERIALIZED] VIEW, DROP). A plan that carries a
  relation is held equal after ``optimize``, converted into the port's
  classes; every other plan field by field. Where the reference raises
  (``PlanError``, a parse error, ``NotImplementedError`` of an
  unsupported form), the port must raise the same type with the same
  message. EXPLAIN PHYSICAL and ANALYSIS are not ported: the port
  raises ``NotImplementedError`` naming its ROADMAP item there.
- The texts ``Q21_SQL`` and ``Q7_SQL`` over the TPC-H schemas.
- The reference's unoptimized hand MIR (``q1_mir``, ``q15_mir``,
  ``q9_mir``, the auction's and pagerank's) through both optimizers.

The port plans with the reference's dictionary (``plan_statement``'s
``dictionary``), so both planners see the same string codes and the
trees compare literally. Planning is host Python: no tensor is made.
"""

from __future__ import annotations

import dataclasses
import functools
import glob
import importlib
import os

import pytest

from materialize_tpu.repr.schema import GLOBAL_DICT as JDICT
from materialize_tpu.sql import catalog as jcatalog
from materialize_tpu.sql import plan as jplan
from materialize_tpu.testing.slt import parse_slt
from materialize_tpu.transform import optimizer as joptimizer
from materialize_tpu_torch.sql import catalog as tcatalog
from materialize_tpu_torch.sql import plan as tplan
from materialize_tpu_torch.transform import optimizer as toptimizer

SLT_DIR = os.path.join(os.path.dirname(__file__), "slt")
SLT_FILES = sorted(glob.glob(os.path.join(SLT_DIR, "*.slt")))
KINDS = ("statement_ok", "statement_error", "query")
EXPR_PLANS = ("SelectPlan", "CreateViewPlan", "DeletePlan", "UpdatePlan", "SubscribePlan")


def to_port(x):
    """A reference object (plan, MIR, scalar, schema, enum) as the port's:
    each reference dataclass or enum becomes the class of the same name
    in the port's module of the same path; a class the port lacks fails
    the test. String codes are kept (both planned with one dictionary)."""
    if isinstance(x, tuple):
        return tuple(to_port(v) for v in x)
    if isinstance(x, list):
        return [to_port(v) for v in x]
    if isinstance(x, dict):
        return {to_port(k): to_port(v) for k, v in x.items()}
    mod = type(x).__module__
    if mod.startswith("materialize_tpu."):
        cls = getattr(importlib.import_module("materialize_tpu_torch." + mod.split(".", 1)[1]),
                      type(x).__name__)
        if dataclasses.is_dataclass(x):
            return cls(**{f.name: to_port(getattr(x, f.name))
                          for f in dataclasses.fields(x) if f.init})
        return cls(x.value)
    return x


def _records(path):
    with open(path) as f:
        return [r for r in parse_slt(f.read()) if r.kind in KINDS]


def _apply_ddl(pkg, cat, plan) -> None:
    """What sequencing the plan does to the catalog (the coordinator's
    ``_sequence_create_*`` and DROP, less the dataflows)."""
    name = type(plan).__name__
    if name == "CreateTablePlan":
        cat.create(pkg.CatalogItem(plan.name, "table", plan.schema))
    elif name == "CreateViewPlan":
        kind = "materialized-view" if plan.materialized else "view"
        cat.create(pkg.CatalogItem(plan.name, kind,
                                   plan.expr.schema().rename(plan.column_names),
                                   plan.expr, plan.column_names),
                   or_replace=plan.or_replace)
    elif name == "DropPlan":
        cat.drop(plan.name, plan.if_exists)


def _run(planner, optimize, pkg, cat, sql, **kw):
    """(plan with its relation optimized, or the exception) for one
    record; the catalog follows the plan's DDL."""
    try:
        plan = planner.plan_statement(sql, cat, **kw)
        if type(plan).__name__ in EXPR_PLANS:
            plan.expr = optimize(plan.expr)
        _apply_ddl(pkg, cat, plan)
        return plan
    except Exception as e:  # noqa: BLE001 - the error is the result compared
        return e


@functools.lru_cache(maxsize=None)
def _planned(path):
    """Both packages' results for every record of one file, in order."""
    jcat, tcat = jcatalog.Catalog(), tcatalog.Catalog()
    out = []
    for r in _records(path):
        j = _run(jplan, joptimizer.optimize, jcatalog, jcat, r.sql)
        t = _run(tplan, toptimizer.optimize, tcatalog, tcat, r.sql, dictionary=JDICT)
        out.append((r, j, t))
    return out


CASES = [(os.path.basename(p), i) for p in SLT_FILES for i in range(len(_records(p)))]


def test_corpus_counts():
    kinds = [r.kind for p in SLT_FILES for r in _records(p)]
    assert kinds.count("query") == 344
    assert kinds.count("statement_ok") + kinds.count("statement_error") == 274


@pytest.mark.parametrize("path,i", CASES, ids=[f"{p}:{i}" for p, i in CASES])
def test_slt_record_plans_like_the_reference(path, i):
    r, j, t = _planned(os.path.join(SLT_DIR, path))[i]
    if isinstance(j, Exception):
        assert isinstance(t, Exception), (r.sql, j, t)
        assert (type(t).__name__, str(t)) == (type(j).__name__, str(j)), r.sql
        return
    if type(j).__name__ == "ExplainPlan" and j.stage in ("physical", "analysis"):
        assert isinstance(t, NotImplementedError) and "ROADMAP" in str(t), (r.sql, t)
        return
    assert not isinstance(t, Exception), (r.sql, t)
    assert t == to_port(j), r.sql
    if type(j).__name__ in EXPR_PLANS:
        assert t.expr.schema() == to_port(j.expr.schema())


def _tpch_catalogs():
    from materialize_tpu.storage.generator import tpch as jtpch
    from materialize_tpu_torch.storage.generator import tpch as ttpch

    jcat, tcat = jcatalog.Catalog(), tcatalog.Catalog()
    for name in ("lineitem", "orders", "supplier", "nation", "customer", "part",
                 "partsupp", "region"):
        schema = f"{name.upper()}_SCHEMA"
        jcat.create(jcatalog.CatalogItem(name, "source", getattr(jtpch, schema)))
        tcat.create(tcatalog.CatalogItem(name, "source", getattr(ttpch, schema)))
    return jcat, tcat


@pytest.mark.parametrize("text", ["Q21_SQL", "Q7_SQL"])
def test_tpch_text_plans_like_the_reference(text):
    from materialize_tpu_torch.workloads import tpch

    sql = getattr(tpch, text)
    jcat, tcat = _tpch_catalogs()
    want = to_port(joptimizer.optimize(jplan.plan_statement(sql, jcat).expr))
    got = toptimizer.optimize(tplan.plan_statement(sql, tcat, dictionary=JDICT).expr)
    assert got == want and got.schema() == want.schema()


def _hand_mir():
    from materialize_tpu.repr.schema import Column, ColumnType, Schema
    from materialize_tpu.workloads.auction import auction_topk_mir, auction_winning_bidders_mir
    from materialize_tpu.workloads.pagerank import pagerank_mir
    from materialize_tpu.workloads.tpch import q1_mir, q9_mir, q15_mir

    return {"q1": q1_mir, "q15": q15_mir, "q9": q9_mir,
            "auction_topk": auction_topk_mir, "auction": auction_winning_bidders_mir,
            "pagerank": lambda: pagerank_mir(Schema([Column("src", ColumnType.INT64),
                                                     Column("dst", ColumnType.INT64)]),
                                             max_iters=60)}


@pytest.mark.parametrize("name", ["q1", "q15", "q9", "auction_topk", "auction", "pagerank"])
def test_hand_mir_optimizes_like_the_reference(name):
    mir = _hand_mir()[name]()
    assert toptimizer.optimize(to_port(mir)) == to_port(joptimizer.optimize(mir))
