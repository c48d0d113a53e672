"""SQL abstract syntax tree.

Analog of the reference's ``sql-parser`` AST (src/sql-parser/src/ast/defs;
``Statement`` has 74 variants there — statement.rs:43). This covers the
statement subset the TPU framework serves: queries, view/index/source DDL,
EXPLAIN, SUBSCRIBE; the shape (Query/SetExpr/TableFactor split) mirrors
the reference so later statements slot in naturally.

The port's copy of ``materialize_tpu/sql/ast.py``: its relative imports reach the port's
``expr/`` and ``repr/``; it differs from the reference only where noted.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

# -- scalar expressions ------------------------------------------------------


class Expr:
    pass


@dataclass(frozen=True)
class Ident(Expr):
    """Possibly-qualified name: a / t.a."""

    parts: tuple  # ("t", "a") or ("a",)


@dataclass(frozen=True)
class NumberLit(Expr):
    text: str  # original digits; planner decides int vs decimal


@dataclass(frozen=True)
class StringLit(Expr):
    value: str


@dataclass(frozen=True)
class IntervalLit(Expr):
    """INTERVAL '...' literal, normalized to (months, days, ms)."""

    months: int = 0
    days: int = 0
    ms: int = 0


@dataclass(frozen=True)
class BoolLit(Expr):
    value: bool


@dataclass(frozen=True)
class NullLit(Expr):
    pass


@dataclass(frozen=True)
class BinaryOp(Expr):
    op: str  # +,-,*,/,%,=,<>,<,<=,>,>=,and,or,||
    left: Expr
    right: Expr


@dataclass(frozen=True)
class UnaryOp(Expr):
    op: str  # -, not
    expr: Expr


@dataclass(frozen=True)
class IsNull(Expr):
    expr: Expr
    negated: bool


@dataclass(frozen=True)
class Like(Expr):
    expr: Expr
    pattern: Expr  # must plan to a string literal
    negated: bool = False
    case_insensitive: bool = False  # ILIKE


@dataclass(frozen=True)
class InList(Expr):
    expr: Expr
    items: tuple
    negated: bool


@dataclass(frozen=True)
class Between(Expr):
    expr: Expr
    low: Expr
    high: Expr
    negated: bool


@dataclass(frozen=True)
class Case(Expr):
    operand: Optional[Expr]
    whens: tuple  # (cond, result) pairs
    else_: Optional[Expr]


@dataclass(frozen=True)
class Cast(Expr):
    expr: Expr
    to_type: str


@dataclass(frozen=True)
class FuncCall(Expr):
    name: str
    args: tuple
    distinct: bool = False
    star: bool = False  # count(*)


@dataclass(frozen=True)
class Extract(Expr):
    part: str  # "year"
    expr: Expr


@dataclass(frozen=True)
class Exists(Expr):
    query: "Query"
    negated: bool = False


@dataclass(frozen=True)
class ScalarSubquery(Expr):
    query: "Query"


@dataclass(frozen=True)
class InSubquery(Expr):
    expr: Expr
    query: "Query"
    negated: bool


@dataclass(frozen=True)
class Star(Expr):
    """SELECT * or t.*"""

    qualifier: Optional[str] = None


# -- query structure ---------------------------------------------------------


@dataclass(frozen=True)
class SelectItem:
    expr: Expr
    alias: Optional[str] = None


@dataclass(frozen=True)
class OrderByItem:
    expr: Expr
    desc: bool = False
    nulls_last: Optional[bool] = None  # None = dialect default


@dataclass(frozen=True)
class TableAlias:
    name: str
    columns: tuple = ()


class TableFactor:
    pass


@dataclass(frozen=True)
class TableName(TableFactor):
    name: str
    alias: Optional[TableAlias] = None


@dataclass(frozen=True)
class DerivedTable(TableFactor):
    query: "Query"
    alias: Optional[TableAlias] = None


@dataclass(frozen=True)
class JoinClause:
    kind: str  # inner/left/right/full/cross
    factor: TableFactor
    on: Optional[Expr] = None
    using: tuple = ()


@dataclass(frozen=True)
class FromItem:
    factor: TableFactor
    joins: tuple = ()  # JoinClause


@dataclass(frozen=True)
class Select:
    items: tuple  # SelectItem
    from_: tuple = ()  # FromItem (comma list)
    where: Optional[Expr] = None
    group_by: tuple = ()
    having: Optional[Expr] = None
    distinct: bool = False


class SetExpr:
    pass


@dataclass(frozen=True)
class SelectExpr(SetExpr):
    select: Select


@dataclass(frozen=True)
class SetOp(SetExpr):
    op: str  # union/except/intersect
    all: bool
    left: SetExpr
    right: SetExpr


@dataclass(frozen=True)
class Cte:
    name: str
    columns: tuple  # (name, type) pairs for WMR; plain names for WITH
    query: "Query"


@dataclass(frozen=True)
class Query:
    body: SetExpr
    ctes: tuple = ()
    mutually_recursive: bool = False
    recursion_limit: Optional[int] = None
    order_by: tuple = ()  # OrderByItem
    limit: Optional[int] = None
    offset: int = 0


# -- statements --------------------------------------------------------------


class Statement:
    pass


@dataclass(frozen=True)
class SelectStatement(Statement):
    query: Query
    # SELECT ... AS OF <time>: read at an explicit timestamp inside the
    # multiversion window (reference: sql-parser AS OF on SELECT/
    # SUBSCRIBE, adapter/src/coord/read_policy.rs lag windows)
    as_of: Optional[int] = None


@dataclass(frozen=True)
class CreateView(Statement):
    name: str
    query: Query
    materialized: bool = False
    or_replace: bool = False


@dataclass(frozen=True)
class CreateIndex(Statement):
    name: Optional[str]
    on: str
    key: tuple = ()  # expressions; empty = default key (all columns)


@dataclass(frozen=True)
class CreateSource(Statement):
    name: str
    generator: str  # tpch/auction/counter/... or "kafka"
    options: dict = field(default_factory=dict)
    # declared columns for external-format sources (kafka):
    # (name, type_name, nullable) triples, like CreateTable
    columns: tuple = ()


@dataclass(frozen=True)
class CreateSink(Statement):
    """CREATE SINK name FROM obj INTO KAFKA (options...)."""

    name: str
    from_obj: str
    options: dict = field(default_factory=dict)


@dataclass(frozen=True)
class CreateTable(Statement):
    name: str
    columns: tuple  # (name, type_name, nullable) triples


@dataclass(frozen=True)
class CreateWebhook(Statement):
    """CREATE SOURCE ... FROM WEBHOOK (cols): HTTP-ingested source
    (the reference's webhook sources, adapter/src/webhook.rs)."""

    name: str
    columns: tuple  # (name, type_name, nullable) triples


@dataclass(frozen=True)
class Insert(Statement):
    table: str
    rows: tuple  # tuple of tuples of Expr (constant values)
    columns: tuple = ()  # optional explicit column list


@dataclass(frozen=True)
class Delete(Statement):
    table: str
    where: Optional[Expr] = None


@dataclass(frozen=True)
class Update(Statement):
    table: str
    assignments: tuple  # (column_name, Expr)
    where: Optional[Expr] = None


@dataclass(frozen=True)
class SetVar(Statement):
    name: str
    value: object  # python scalar or None (RESET)


@dataclass(frozen=True)
class ShowVar(Statement):
    name: str


@dataclass(frozen=True)
class DropObject(Statement):
    kind: str  # view/index/source
    name: str
    if_exists: bool = False


@dataclass(frozen=True)
class Explain(Statement):
    stage: str  # raw/decorrelated/optimized/physical/analysis
    statement: Statement


@dataclass(frozen=True)
class Subscribe(Statement):
    query: Query
    as_of: Optional[int] = None


@dataclass(frozen=True)
class CopyFrom(Statement):
    """COPY table [(cols)] FROM STDIN (text format)."""

    table: str
    columns: tuple = ()


@dataclass(frozen=True)
class CopyTo(Statement):
    """COPY (query) TO STDOUT / COPY table TO STDOUT."""

    query: Query


@dataclass(frozen=True)
class ShowObjects(Statement):
    kind: str  # sources/views/indexes
