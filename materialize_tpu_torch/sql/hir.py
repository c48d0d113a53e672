"""HIR: high-level relational IR + AST→HIR planning (name resolution).

Analog of the reference's ``sql`` crate planning layer: scope/column
resolution (sql/src/plan/scope.rs), ``plan()`` producing HIR
(sql/src/plan/hir.rs:109). HIR differs from MIR in that joins are binary
with arbitrary ON predicates (incl. outer kinds) and scalar expressions
may contain subqueries (Exists/ScalarSubquery) — lowering.py removes both
(the decorrelation step, sql/src/plan/lowering.rs:188 analog).

v1 scope: uncorrelated subqueries only (correlated ones raise — the
reference's full decorrelation is future work); no outer-level columns in
scalar exprs.

The port's copy of ``materialize_tpu/sql/hir.py``: its relative imports reach the port's
``expr/`` and ``repr/``; it differs from the reference only where noted.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..expr.relation import AggregateFunc
from ..expr.scalar import (
    BinaryFunc,
    UnaryFunc,
    VariadicFunc,
)
from ..repr.schema import Column, ColumnType, Schema
from . import ast


class PlanError(ValueError):
    pass


# -- HIR scalar expressions --------------------------------------------------


class HirScalar:
    pass


@dataclass(frozen=True)
class HColumn(HirScalar):
    index: int  # position in the current relation


@dataclass(frozen=True)
class HOuterColumn(HirScalar):
    """A correlated reference to an enclosing query's relation.

    ``level`` counts query nestings outward (1 = the immediately
    enclosing query); ``index`` is the column position in that query's
    relation; ``column`` carries the resolved type so typing needs no
    outer-schema context. The analog of the reference HIR's leveled
    ``ColumnRef {level, column}`` (sql/src/plan/hir.rs), removed by
    decorrelation in lowering.py."""

    level: int
    index: int
    column: "Column"


@dataclass(frozen=True)
class HLiteral(HirScalar):
    value: object  # python scalar; None = NULL
    ctype: ColumnType
    scale: int = 0


@dataclass(frozen=True)
class HMzNow(HirScalar):
    """mz_now(): the current virtual timestamp (temporal filters)."""


@dataclass(frozen=True)
class HCallUnary(HirScalar):
    func: str
    expr: HirScalar


@dataclass(frozen=True)
class HCallBinary(HirScalar):
    func: str
    left: HirScalar
    right: HirScalar


@dataclass(frozen=True)
class HCallVariadic(HirScalar):
    func: str
    exprs: tuple


@dataclass(frozen=True)
class HIf(HirScalar):
    cond: HirScalar
    then: HirScalar
    els: HirScalar


@dataclass(frozen=True)
class HExists(HirScalar):
    rel: "HirRelation"


@dataclass(frozen=True)
class HScalarSubquery(HirScalar):
    rel: "HirRelation"


@dataclass(frozen=True)
class HInSubquery(HirScalar):
    """x IN (SELECT ...): lowered to a semijoin (lowering.py)."""

    expr: HirScalar
    rel: "HirRelation"
    negated: bool


# -- HIR relation expressions ------------------------------------------------


class HirRelation:
    def schema(self) -> Schema:
        raise NotImplementedError


@dataclass(frozen=True)
class HGet(HirRelation):
    name: str
    _schema: Schema

    def schema(self):
        return self._schema


@dataclass(frozen=True)
class HConstant(HirRelation):
    rows: tuple
    _schema: Schema

    def schema(self):
        return self._schema


@dataclass(frozen=True)
class HProject(HirRelation):
    input: HirRelation
    outputs: tuple

    def schema(self):
        return self.input.schema().project(self.outputs)


@dataclass(frozen=True)
class HMap(HirRelation):
    input: HirRelation
    scalars: tuple  # (HirScalar, Column) — the planner types every expr

    def schema(self):
        return Schema(
            tuple(self.input.schema().columns)
            + tuple(c for _, c in self.scalars)
        )


@dataclass(frozen=True)
class HFilter(HirRelation):
    input: HirRelation
    predicates: tuple

    def schema(self):
        return self.input.schema()


@dataclass(frozen=True)
class HJoin(HirRelation):
    """Binary join with an ON predicate; kind in
    inner/left/right/full/cross (hir.rs HirRelationExpr::Join)."""

    left: HirRelation
    right: HirRelation
    on: tuple  # conjunction of HirScalar over concat(left, right) columns
    kind: str

    def schema(self):
        lcols = list(self.left.schema().columns)
        rcols = list(self.right.schema().columns)
        if self.kind in ("left", "full"):
            rcols = [Column(c.name, c.ctype, True, c.scale) for c in rcols]
        if self.kind in ("right", "full"):
            lcols = [Column(c.name, c.ctype, True, c.scale) for c in lcols]
        return Schema(lcols + rcols)


@dataclass(frozen=True)
class HAggregate:
    func: AggregateFunc
    expr: HirScalar
    distinct: bool
    out: Column
    # Host-side plan parameters (string_agg separator).
    params: tuple = ()


@dataclass(frozen=True)
class HReduce(HirRelation):
    input: HirRelation
    group_key: tuple  # column indices
    aggregates: tuple  # HAggregate

    def schema(self):
        in_s = self.input.schema()
        return Schema(
            [in_s[i] for i in self.group_key]
            + [a.out for a in self.aggregates]
        )


@dataclass(frozen=True)
class HDistinct(HirRelation):
    input: HirRelation

    def schema(self):
        return self.input.schema()


@dataclass(frozen=True)
class HTopK(HirRelation):
    input: HirRelation
    group_key: tuple
    order_by: tuple  # (col, desc, nulls_last)
    limit: Optional[int]
    offset: int

    def schema(self):
        return self.input.schema()


@dataclass(frozen=True)
class HNegate(HirRelation):
    input: HirRelation

    def schema(self):
        return self.input.schema()


@dataclass(frozen=True)
class HThreshold(HirRelation):
    input: HirRelation

    def schema(self):
        return self.input.schema()


@dataclass(frozen=True)
class HUnion(HirRelation):
    inputs: tuple

    def schema(self):
        return self.inputs[0].schema()


@dataclass(frozen=True)
class HRename(HirRelation):
    """Identity on rows; output columns renamed (alias application)."""

    input: HirRelation
    _schema: Schema

    def schema(self):
        return self._schema


@dataclass(frozen=True)
class HLet(HirRelation):
    name: str
    value: HirRelation
    body: HirRelation

    def schema(self):
        return self.body.schema()


@dataclass(frozen=True)
class HLetRec(HirRelation):
    names: tuple
    values: tuple
    value_schemas: tuple
    body: HirRelation
    max_iters: Optional[int]

    def schema(self):
        return self.body.schema()


# -- scopes ------------------------------------------------------------------


@dataclass(frozen=True)
class ScopeItem:
    table: Optional[str]  # alias the column is reachable under
    name: str
    # JOIN ... USING merges the shared column: the non-preferred side's
    # copy stays addressable by qualified name but is skipped by
    # unqualified lookup and bare `*` (pg join-USING scope semantics).
    hidden: bool = False
    # pg emits USING-merged columns FIRST in unqualified `*` expansion
    # (outermost join's columns first, then USING-clause order). Items
    # with a star_rank sort ascending before unranked items, which keep
    # positional order.
    star_rank: Optional[int] = None


@dataclass
class Scope:
    """Column-name resolution for one relation (scope.rs analog).

    ``columns`` optionally carries the relation's Column types in
    parallel with ``items`` — needed when this scope serves as an OUTER
    scope for a correlated subquery (the resolved type rides on the
    HOuterColumn node)."""

    items: list
    columns: Optional[list] = None

    def maybe_resolve(self, parts: tuple) -> Optional[int]:
        """Index for the name, None if unknown; ambiguity still raises."""
        if len(parts) == 1:
            hits = [
                i for i, it in enumerate(self.items) if it.name == parts[0]
            ]
            visible = [i for i in hits if not self.items[i].hidden]
            if visible:
                hits = visible
        elif len(parts) == 2:
            hits = [
                i
                for i, it in enumerate(self.items)
                if it.table == parts[0] and it.name == parts[1]
            ]
        else:
            raise PlanError(f"too many name parts: {'.'.join(parts)}")
        if not hits:
            return None
        if len(hits) > 1:
            raise PlanError(f"ambiguous column {'.'.join(parts)!r}")
        return hits[0]

    def resolve(self, parts: tuple) -> int:
        idx = self.maybe_resolve(parts)
        if idx is None:
            raise PlanError(f"unknown column {'.'.join(parts)!r}")
        return idx

    def concat(self, other: "Scope") -> "Scope":
        cols = None
        if self.columns is not None and other.columns is not None:
            cols = self.columns + other.columns
        return Scope(self.items + other.items, cols)


# -- catalog interface -------------------------------------------------------


class CatalogInterface:
    """What planning needs from the catalog: name -> relation schema."""

    def resolve_item(self, name: str) -> Schema:
        raise NotImplementedError


_TYPE_NAMES = {
    "int": ColumnType.INT64,
    "integer": ColumnType.INT64,
    "bigint": ColumnType.INT64,
    "int4": ColumnType.INT32,
    "int8": ColumnType.INT64,
    "smallint": ColumnType.INT32,
    "double precision": ColumnType.FLOAT64,
    "double": ColumnType.FLOAT64,
    "float": ColumnType.FLOAT64,
    "float8": ColumnType.FLOAT64,
    "real": ColumnType.FLOAT64,
    "bool": ColumnType.BOOL,
    "boolean": ColumnType.BOOL,
    "text": ColumnType.STRING,
    "varchar": ColumnType.STRING,
    "string": ColumnType.STRING,
    "date": ColumnType.DATE,
    "timestamp": ColumnType.TIMESTAMP,
    "numeric": ColumnType.DECIMAL,
    "decimal": ColumnType.DECIMAL,
}


def type_from_name(name: str) -> ColumnType:
    try:
        return _TYPE_NAMES[name]
    except KeyError:
        raise PlanError(f"unknown type {name!r}") from None


def parse_type(name: str) -> tuple:
    """'decimal(12,2)' -> (ColumnType.DECIMAL, 2); the single home of
    type-name parameter parsing (precision is accepted and ignored —
    decimals are scaled int64)."""
    t = name.strip().lower()
    base, args = t, []
    if "(" in t:
        if ")" not in t:
            raise PlanError(f"malformed type name {name!r}")
        base = t[: t.index("(")].strip()
        args = [
            a.strip()
            for a in t[t.index("(") + 1 : t.rindex(")")].split(",")
        ]
    ty = type_from_name(base)
    scale = 0
    if ty is ColumnType.DECIMAL and len(args) > 1:
        try:
            scale = int(args[1])
        except ValueError:
            raise PlanError(f"malformed type name {name!r}") from None
    return ty, scale


# -- typing HIR scalars ------------------------------------------------------

from ..expr import scalar as mscalar


def _to_mir_shape(e: HirScalar):
    """Structural HIR->MIR scalar conversion for TYPING only (subqueries
    unsupported here; lowering replaces them with columns first)."""
    if isinstance(e, HColumn):
        return mscalar.ColumnRef(e.index)
    if isinstance(e, HMzNow):
        return mscalar.MzNow()
    if isinstance(e, HLiteral):
        return mscalar.Literal(e.value, e.ctype, e.scale)
    if isinstance(e, HCallUnary):
        return mscalar.CallUnary(e.func, _to_mir_shape(e.expr))
    if isinstance(e, HCallBinary):
        return mscalar.CallBinary(
            e.func, _to_mir_shape(e.left), _to_mir_shape(e.right)
        )
    if isinstance(e, HCallVariadic):
        return mscalar.CallVariadic(
            e.func, [_to_mir_shape(x) for x in e.exprs]
        )
    if isinstance(e, HIf):
        return mscalar.If(
            _to_mir_shape(e.cond),
            _to_mir_shape(e.then),
            _to_mir_shape(e.els),
        )
    if isinstance(e, (HExists, HScalarSubquery)):
        raise PlanError("subquery not lowered before typing")
    if isinstance(e, HOuterColumn):
        raise PlanError(
            "correlated reference not decorrelated before MIR conversion"
        )
    raise NotImplementedError(type(e).__name__)


def _strip_outer_for_typing(e: HirScalar) -> HirScalar:
    """Replace correlated references with typed NULL placeholders so the
    expression can be typed against the inner schema alone (nullability
    is pessimistic: an outer reference types as nullable)."""
    if isinstance(e, HOuterColumn):
        return HLiteral(None, e.column.ctype, e.column.scale)
    if isinstance(e, HCallUnary):
        return HCallUnary(e.func, _strip_outer_for_typing(e.expr))
    if isinstance(e, HCallBinary):
        return HCallBinary(
            e.func,
            _strip_outer_for_typing(e.left),
            _strip_outer_for_typing(e.right),
        )
    if isinstance(e, HCallVariadic):
        return HCallVariadic(
            e.func, tuple(_strip_outer_for_typing(x) for x in e.exprs)
        )
    if isinstance(e, HIf):
        return HIf(
            _strip_outer_for_typing(e.cond),
            _strip_outer_for_typing(e.then),
            _strip_outer_for_typing(e.els),
        )
    return e


def typ_of(e: HirScalar, schema: Schema) -> Column:
    if isinstance(e, HScalarSubquery):
        sub = e.rel.schema()
        if sub.arity != 1:
            raise PlanError("scalar subquery must return one column")
        c = sub[0]
        return Column(c.name, c.ctype, True, c.scale)
    if isinstance(e, HExists):
        return Column("exists", ColumnType.BOOL, False)
    if isinstance(e, HOuterColumn):
        c = e.column
        return Column(c.name, c.ctype, c.nullable, c.scale)
    return _to_mir_shape(_strip_outer_for_typing(e)).typ(schema)


# -- correlation analysis -----------------------------------------------------


def scalar_subqueries(e: HirScalar):
    """The subquery-bearing nodes directly inside a scalar."""
    if isinstance(e, (HExists, HScalarSubquery, HInSubquery)):
        yield e
    elif isinstance(e, HCallUnary):
        yield from scalar_subqueries(e.expr)
    elif isinstance(e, HCallBinary):
        yield from scalar_subqueries(e.left)
        yield from scalar_subqueries(e.right)
    elif isinstance(e, HCallVariadic):
        for x in e.exprs:
            yield from scalar_subqueries(x)
    elif isinstance(e, HIf):
        yield from scalar_subqueries(e.cond)
        yield from scalar_subqueries(e.then)
        yield from scalar_subqueries(e.els)
    if isinstance(e, HInSubquery):
        yield from scalar_subqueries(e.expr)


def _relation_scalars(rel: HirRelation):
    if isinstance(rel, HMap):
        return [s for s, _ in rel.scalars]
    if isinstance(rel, HFilter):
        return list(rel.predicates)
    if isinstance(rel, HJoin):
        return list(rel.on)
    if isinstance(rel, HReduce):
        return [a.expr for a in rel.aggregates]
    return []


def _relation_children(rel: HirRelation):
    if isinstance(rel, (HProject, HMap, HFilter, HReduce, HDistinct,
                        HTopK, HNegate, HThreshold, HRename)):
        return [rel.input]
    if isinstance(rel, HJoin):
        return [rel.left, rel.right]
    if isinstance(rel, HUnion):
        return list(rel.inputs)
    if isinstance(rel, HLet):
        return [rel.value, rel.body]
    if isinstance(rel, HLetRec):
        return list(rel.values) + [rel.body]
    return []


# Identity-keyed memo: HIR nodes are immutable (frozen dataclasses), and
# decorrelation calls free_outer_refs/is_correlated at every _apply
# recursion level — without memoization lowering is O(n^2) in subquery
# size. The cache entry keeps a strong reference to the node so an id()
# can never be reused while its entry is live.
_FREE_CACHE: dict = {}


def _scalar_free(e: HirScalar) -> frozenset:
    """Free (level, index, Column) refs of one scalar, relative to the
    relation it is evaluated over."""
    if isinstance(e, HOuterColumn):
        return frozenset({(e.level, e.index, e.column)})
    if isinstance(e, (HExists, HScalarSubquery, HInSubquery)):
        # Refs inside the subquery: level 1 refers to OUR relation (not
        # free here), deeper levels shift down by one.
        out = {
            (lvl - 1, idx, col)
            for lvl, idx, col in free_outer_refs(e.rel)
            if lvl >= 2
        }
        if isinstance(e, HInSubquery):
            out |= _scalar_free(e.expr)
        return frozenset(out)
    if isinstance(e, HCallUnary):
        return _scalar_free(e.expr)
    if isinstance(e, HCallBinary):
        return _scalar_free(e.left) | _scalar_free(e.right)
    if isinstance(e, HCallVariadic):
        out: frozenset = frozenset()
        for x in e.exprs:
            out |= _scalar_free(x)
        return out
    if isinstance(e, HIf):
        return (
            _scalar_free(e.cond)
            | _scalar_free(e.then)
            | _scalar_free(e.els)
        )
    return frozenset()


def free_outer_refs(rel: HirRelation) -> frozenset:
    """(level, index, Column) triples of correlated references escaping
    ``rel``, with level counted relative to rel's immediately enclosing
    query (level 1 = that query's relation)."""
    hit = _FREE_CACHE.get(id(rel))
    if hit is not None and hit[0] is rel:
        return hit[1]
    out: frozenset = frozenset()
    for s in _relation_scalars(rel):
        out |= _scalar_free(s)
    for c in _relation_children(rel):
        out |= free_outer_refs(c)
    _FREE_CACHE[id(rel)] = (rel, out)
    return out


def is_correlated(rel: HirRelation) -> bool:
    return bool(free_outer_refs(rel))
