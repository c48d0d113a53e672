"""Statement planning: AST → Plan (the adapter's unit of sequencing).

Analog of the reference's ``plan()`` dispatch (sql/src/plan/statement.rs:288)
producing per-statement ``Plan`` variants (sql/src/plan.rs:133), and the
EXPLAIN stage pipeline (EXPLAIN RAW|DECORRELATED|OPTIMIZED|PHYSICAL PLAN,
sql-parser statement.rs ExplainStage).

The port's copy of ``materialize_tpu/sql/plan.py``: its relative imports reach the port's
``expr/`` and ``repr/``; it differs from the reference only where noted.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..expr import relation as mir
from ..repr.schema import GLOBAL_DICT, ColumnType, Schema
from . import ast
from .hir import CatalogInterface, HirRelation, PlanError
from .lowering import lower
from .parser import parse_statement
from .plan_query import QueryPlanner


class Plan:
    pass


@dataclass
class SelectPlan(Plan):
    expr: mir.RelationExpr
    column_names: tuple
    # RowSetFinishing ordering: (col_idx, desc, nulls_last) triples,
    # applied adapter-side to peek results (coord/peek.rs:910 analog).
    order_by: tuple = ()
    # host-side LIMIT/OFFSET finishing: used when a top-level TopK
    # orders by a text column (device TopK cannot key on string ranks)
    limit: object = None
    offset: int = 0
    # COPY (query) TO STDOUT: stream the result over the COPY-out
    # subprotocol instead of DataRows
    copy_out: bool = False
    # SELECT ... AS OF <t>: read at an explicit timestamp inside the
    # multiversion window (read_policy.rs lag analog); None = latest
    as_of: Optional[int] = None


@dataclass
class CreateViewPlan(Plan):
    name: str
    expr: mir.RelationExpr
    column_names: tuple
    materialized: bool
    or_replace: bool


@dataclass
class CreateIndexPlan(Plan):
    name: str
    on: str


@dataclass
class CreateSourcePlan(Plan):
    name: str
    generator: str
    options: dict
    # declared Schema for external-format sources (kafka); None for
    # generators whose schemas are intrinsic
    schema: object = None


@dataclass
class CreateSinkPlan(Plan):
    name: str
    from_obj: str
    options: dict


@dataclass
class DropPlan(Plan):
    kind: str
    name: str
    if_exists: bool


@dataclass
class CreateTablePlan(Plan):
    name: str
    schema: Schema


@dataclass
class CreateWebhookPlan(Plan):
    name: str
    schema: Schema


@dataclass
class InsertPlan(Plan):
    table: str
    rows: list  # python value tuples, coerced to the table schema


@dataclass
class CopyFromPlan(Plan):
    """COPY table FROM STDIN: the wire layer drives row collection and
    hands text rows back to the coordinator (pgwire COPY-in;
    reference protocol.rs COPY subprotocol)."""

    table: str
    columns: tuple  # optional column-name subset (empty = all)


@dataclass
class DeletePlan(Plan):
    """Read-then-write: the expr selects the rows to retract."""

    table: str
    expr: mir.RelationExpr


@dataclass
class UpdatePlan(Plan):
    """Read-then-write: expr = SELECT *, new_values... FROM t WHERE p;
    set_positions maps target column index -> appended column index."""

    table: str
    expr: mir.RelationExpr
    set_positions: dict
    expr_schema: Schema


@dataclass
class SetVarPlan(Plan):
    name: str
    value: object  # None = RESET to default


@dataclass
class ShowVarPlan(Plan):
    name: str


@dataclass
class SubscribePlan(Plan):
    expr: mir.RelationExpr
    column_names: tuple
    as_of: Optional[int] = None


@dataclass
class ExplainPlan(Plan):
    stage: str
    text: str


@dataclass
class ShowPlan(Plan):
    kind: str


def plan_statement(
    sql_or_stmt, catalog: CatalogInterface, dictionary=GLOBAL_DICT
) -> Plan:
    """Port: ``dictionary`` codes the string literals (the one that
    codes the data the plan runs over; the port's own by default)."""
    stmt = (
        parse_statement(sql_or_stmt)
        if isinstance(sql_or_stmt, str)
        else sql_or_stmt
    )
    return _plan(stmt, catalog, dictionary)


def _plan(
    stmt: ast.Statement, catalog: CatalogInterface, dictionary=GLOBAL_DICT
) -> Plan:
    qp = QueryPlanner(catalog, dictionary)
    if isinstance(stmt, ast.SelectStatement):
        hir_rel, scope = qp.plan_query(stmt.query)
        m = lower(hir_rel)
        plan = SelectPlan(
            m,
            tuple(it.name for it in scope.items),
            getattr(qp, "finishing_order", ()),
        )
        plan.as_of = stmt.as_of
        # A top-level LIMIT ordered by text cannot run as a device TopK
        # (string ranks shift as the dictionary grows; ops/topk.py):
        # strip it and finish host-side with the peek's RowSetFinishing.
        if (
            isinstance(m, mir.TopK)
            and m.group_key == ()
            and any(
                m.input.schema()[i].ctype is ColumnType.STRING
                for i, _, _ in m.order_by
            )
        ):
            plan.expr = m.input
            plan.limit = m.limit
            plan.offset = m.offset
        return plan
    if isinstance(stmt, ast.CreateView):
        hir_rel, scope = qp.plan_query(stmt.query)
        return CreateViewPlan(
            stmt.name,
            lower(hir_rel),
            tuple(it.name for it in scope.items),
            stmt.materialized,
            stmt.or_replace,
        )
    if isinstance(stmt, ast.CreateIndex):
        return CreateIndexPlan(
            stmt.name or f"{stmt.on}_primary_idx", stmt.on
        )
    if isinstance(stmt, ast.CreateSource):
        return CreateSourcePlan(
            stmt.name,
            stmt.generator,
            stmt.options,
            _table_schema(stmt.columns) if stmt.columns else None,
        )
    if isinstance(stmt, ast.CreateSink):
        return CreateSinkPlan(stmt.name, stmt.from_obj, stmt.options)
    if isinstance(stmt, ast.DropObject):
        return DropPlan(stmt.kind, stmt.name, stmt.if_exists)
    if isinstance(stmt, ast.CreateTable):
        return CreateTablePlan(stmt.name, _table_schema(stmt.columns))
    if isinstance(stmt, ast.CreateWebhook):
        return CreateWebhookPlan(stmt.name, _table_schema(stmt.columns))
    if isinstance(stmt, ast.Insert):
        return _plan_insert(stmt, catalog)
    if isinstance(stmt, ast.CopyFrom):
        return CopyFromPlan(stmt.table, stmt.columns)
    if isinstance(stmt, ast.CopyTo):
        hir_rel, scope = qp.plan_query(stmt.query)
        plan = SelectPlan(
            lower(hir_rel),
            tuple(it.name for it in scope.items),
            getattr(qp, "finishing_order", ()),
        )
        plan.copy_out = True
        return plan
    if isinstance(stmt, ast.Delete):
        hir_rel, _ = qp.plan_query(_table_query(stmt.table, stmt.where))
        return DeletePlan(stmt.table, lower(hir_rel))
    if isinstance(stmt, ast.Update):
        return _plan_update(stmt, catalog, qp)
    if isinstance(stmt, ast.SetVar):
        return SetVarPlan(stmt.name, stmt.value)
    if isinstance(stmt, ast.ShowVar):
        return ShowVarPlan(stmt.name)
    if isinstance(stmt, ast.Subscribe):
        hir_rel, scope = qp.plan_query(stmt.query)
        return SubscribePlan(
            lower(hir_rel),
            tuple(it.name for it in scope.items),
            stmt.as_of,
        )
    if isinstance(stmt, ast.Explain):
        return _explain(stmt, catalog, dictionary)
    if isinstance(stmt, ast.ShowObjects):
        return ShowPlan(stmt.kind)
    raise PlanError(f"cannot plan {type(stmt).__name__}")


def _table_schema(columns) -> Schema:
    """CREATE TABLE column list -> Schema (type parsing: hir.parse_type)."""
    from ..repr.schema import Column
    from .hir import parse_type

    cols = []
    for name, type_name, nullable in columns:
        ty, scale = parse_type(type_name)
        cols.append(Column(name, ty, nullable, scale))
    return Schema(cols)


def _eval_insert_value(e: ast.Expr, col):
    """INSERT literal coerced to the target column: string literals
    parse per the column type (DATE '1994-01-01', decimal text), and
    CAST(lit AS type) / typed literals evaluate at plan time — the same
    coercions the COPY text path applies (parse_text_value)."""
    from ..repr.schema import Column, ColumnType, parse_text_value
    from .hir import parse_type

    if isinstance(e, ast.Cast):
        ty, scale = parse_type(e.to_type)
        v = _eval_insert_value(
            e.expr, Column(col.name, ty, True, scale)
        )
        if v is None:
            return None
        # Re-coerce into the DESTINATION column when the cast type
        # differs: a text-valued cast result parses per the column
        # (CAST('1994-01-01' AS text) into a date column).
        if ty != col.ctype and isinstance(v, str):
            return parse_text_value(v, col)
        return v
    if isinstance(e, ast.StringLit) and col.ctype is not ColumnType.STRING:
        return parse_text_value(e.value, col)
    return _eval_literal(e)


def _eval_literal(e: ast.Expr):
    if isinstance(e, ast.NumberLit):
        return float(e.text) if "." in e.text or "e" in e.text.lower() \
            else int(e.text)
    if isinstance(e, ast.StringLit):
        return e.value
    if isinstance(e, ast.BoolLit):
        return e.value
    if isinstance(e, ast.NullLit):
        return None
    if isinstance(e, ast.UnaryOp) and e.op == "-":
        v = _eval_literal(e.expr)
        return -v if v is not None else None
    raise PlanError(
        f"INSERT values must be constants, got {type(e).__name__}"
    )


def _table_query(
    table: str, where, extra_items: tuple = ()
) -> ast.Query:
    """Build `SELECT *, extra... FROM table WHERE ...` programmatically
    (read-then-write DML plans over the ordinary query planner)."""
    items = (ast.SelectItem(ast.Star(None)),) + tuple(
        ast.SelectItem(e) for e in extra_items
    )
    return ast.Query(
        body=ast.SelectExpr(
            ast.Select(
                items=items,
                from_=(ast.FromItem(ast.TableName(table)),),
                where=where,
            )
        )
    )


def _plan_update(
    stmt: ast.Update, catalog: CatalogInterface, qp
) -> Plan:
    schema = catalog.resolve_item(stmt.table)
    names = list(schema.names)
    set_positions = {}
    exprs = []
    for j, (col, e) in enumerate(stmt.assignments):
        if col not in names:
            raise PlanError(
                f"unknown column {col!r} in table {stmt.table!r}"
            )
        if names.index(col) in set_positions:
            raise PlanError(f"column {col!r} assigned more than once")
        set_positions[names.index(col)] = schema.arity + j
        exprs.append(e)
    hir_rel, _ = qp.plan_query(
        _table_query(stmt.table, stmt.where, tuple(exprs))
    )
    expr = lower(hir_rel)
    return UpdatePlan(stmt.table, expr, set_positions, expr.schema())


def _plan_insert(stmt: ast.Insert, catalog: CatalogInterface) -> Plan:
    schema = catalog.resolve_item(stmt.table)
    names = list(schema.names)
    if stmt.columns:
        if len(set(stmt.columns)) != len(stmt.columns):
            raise PlanError(
                f"column specified more than once in INSERT: "
                f"{list(stmt.columns)}"
            )
        order = []
        for c in stmt.columns:
            if c not in names:
                raise PlanError(
                    f"unknown column {c!r} in table {stmt.table!r}"
                )
            order.append(names.index(c))
    else:
        order = list(range(len(names)))
    rows = []
    for r in stmt.rows:
        if len(r) != len(order):
            raise PlanError(
                f"INSERT row has {len(r)} values, expected {len(order)}"
            )
        full = [None] * len(names)
        for slot, e in zip(order, r):
            full[slot] = _eval_insert_value(e, schema.columns[slot])
        for i, col in enumerate(schema.columns):
            if full[i] is None and not col.nullable:
                raise PlanError(
                    f"null value in non-nullable column {col.name!r}"
                )
        rows.append(tuple(full))
    return InsertPlan(stmt.table, rows)


def _explain(
    stmt: ast.Explain, catalog: CatalogInterface, dictionary=GLOBAL_DICT
) -> Plan:
    inner = stmt.statement
    if isinstance(inner, ast.SelectStatement):
        query = inner.query
    elif isinstance(inner, ast.CreateView):
        query = inner.query
    else:
        raise PlanError("EXPLAIN supports queries and views")
    if stmt.stage == "raw":
        return ExplainPlan("raw", _fmt(query))
    qp = QueryPlanner(catalog, dictionary)
    hir_rel, _ = qp.plan_query(query)
    if stmt.stage == "decorrelated":
        return ExplainPlan("decorrelated", explain_mir(lower(hir_rel)))
    m = lower(hir_rel)
    if stmt.stage in ("optimized", "physical", "analysis"):
        from ..transform.optimizer import optimize

        m = optimize(m)
    if stmt.stage in ("physical", "analysis"):
        # Port: LIR (plan/lir.py, plan/lowering.py) and the analysis
        # report are not ported.
        raise NotImplementedError(
            f"EXPLAIN {stmt.stage.upper()} PLAN is not ported (ROADMAP "
            "Queue 1 item 13: plan/{lir,lowering}.py)"
        )
    return ExplainPlan(stmt.stage, explain_mir(m))


def _fmt(node, indent: int = 0) -> str:
    pad = "  " * indent
    name = type(node).__name__
    return f"{pad}{name}"


def explain_mir(expr: mir.RelationExpr, indent: int = 0) -> str:
    """Readable MIR tree, one operator per line (EXPLAIN output;
    reference sql-pretty / explain API)."""
    pad = "  " * indent
    name = type(expr).__name__
    detail = ""
    if isinstance(expr, mir.Get):
        detail = f" {expr.name}"
    elif isinstance(expr, mir.Project):
        detail = f" outputs={list(expr.outputs)}"
    elif isinstance(expr, mir.Filter):
        detail = f" predicates={len(expr.predicates)}"
    elif isinstance(expr, mir.Map):
        detail = f" scalars={len(expr.scalars)}"
    elif isinstance(expr, mir.Join):
        detail = (
            f" implementation={expr.implementation}"
            f" equivalences={len(expr.equivalences)}"
        )
    elif isinstance(expr, mir.Reduce):
        detail = (
            f" group_key={list(expr.group_key)}"
            f" aggregates={[a.func.value for a in expr.aggregates]}"
        )
    elif isinstance(expr, mir.TopK):
        detail = f" group_key={list(expr.group_key)} limit={expr.limit}"
    elif isinstance(expr, mir.LetRec):
        detail = f" bindings={list(expr.names)}"
    elif isinstance(expr, mir.Let):
        detail = f" name={expr.name}"
    lines = [f"{pad}{name}{detail}"]
    for c in expr.children():
        lines.append(explain_mir(c, indent + 1))
    return "\n".join(lines)
