"""Relation expressions (MIR) and the aggregate vocabulary: the copy of
``materialize_tpu/expr/relation.py`` that the port renders.

All fifteen variants of the reference: ``Constant``, ``Get``, ``Let``,
``LetRec``, ``Project``, ``Map``, ``FlatMap``, ``Filter``, ``Join``,
``Reduce`` (``distinct()`` is a Reduce without aggregates), ``TopK``,
``Negate``, ``Threshold``, ``Union`` and ``ArrangeBy``, with the
chaining helpers and ``AggregateFunc``/``AggregateExpr``.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Sequence

from ..repr.schema import Column, ColumnType, Schema
from .scalar import ScalarExpr


class AggregateFunc(enum.Enum):
    """Aggregates: accumulable ones fold into per-group accumulators,
    hierarchical ones (min/max) keep a sorted multiset, basic ones
    (collection aggregates) keep a multiset finalized at read time."""

    COUNT = "count"
    SUM_INT = "sum_int"
    SUM_FLOAT = "sum_float"
    MIN = "min"
    MAX = "max"
    ANY = "any"
    ALL = "all"
    STRING_AGG = "string_agg"
    ARRAY_AGG = "array_agg"
    LIST_AGG = "list_agg"

    @property
    def is_accumulable(self) -> bool:
        return self in (
            AggregateFunc.COUNT,
            AggregateFunc.SUM_INT,
            AggregateFunc.SUM_FLOAT,
            AggregateFunc.ANY,
            AggregateFunc.ALL,
        )

    @property
    def is_hierarchical(self) -> bool:
        return self in (AggregateFunc.MIN, AggregateFunc.MAX)

    @property
    def is_basic(self) -> bool:
        return self in (
            AggregateFunc.STRING_AGG,
            AggregateFunc.ARRAY_AGG,
            AggregateFunc.LIST_AGG,
        )


@dataclass(frozen=True)
class AggregateExpr:
    """func applied to a scalar expression over the group."""

    func: AggregateFunc
    expr: ScalarExpr
    distinct: bool = False
    params: tuple = ()

    def output_col(self, input_schema: Schema) -> Column:
        inner = self.expr.typ(input_schema)
        if self.func is AggregateFunc.COUNT:
            return Column("count", ColumnType.INT64, False)
        if self.func is AggregateFunc.SUM_INT:
            return Column("sum", inner.ctype, True, inner.scale)
        if self.func is AggregateFunc.SUM_FLOAT:
            return Column("sum", ColumnType.FLOAT64, True)
        if self.func in (AggregateFunc.MIN, AggregateFunc.MAX):
            return Column(self.func.value, inner.ctype, True, inner.scale)
        if self.func in (AggregateFunc.ANY, AggregateFunc.ALL):
            return Column(self.func.value, ColumnType.BOOL, True)
        if self.func.is_basic:
            return Column(self.func.value, ColumnType.STRING, True)
        raise NotImplementedError(self.func)


class RelationExpr:
    """Base class for MIR relation expressions."""

    def schema(self) -> Schema:
        raise NotImplementedError

    def children(self) -> list:
        return []

    # builder sugar
    def project(self, outputs: Sequence[int]) -> "Project":
        return Project(self, tuple(outputs))

    def map(self, exprs: Sequence[ScalarExpr]) -> "Map":
        return Map(self, tuple(exprs))

    def filter(self, preds: Sequence[ScalarExpr]) -> "Filter":
        return Filter(self, tuple(preds))

    def reduce(self, group_key, aggregates) -> "Reduce":
        return Reduce(self, tuple(group_key), tuple(aggregates))

    def distinct(self) -> "Reduce":
        return Reduce(self, tuple(range(self.schema().arity)), ())

    def negate(self) -> "Negate":
        return Negate(self)

    def threshold(self) -> "Threshold":
        return Threshold(self)

    def union(self, *others) -> "Union":
        return Union((self, *others))

    def arrange_by(self, key) -> "ArrangeBy":
        return ArrangeBy(self, tuple(key))


@dataclass(frozen=True)
class Constant(RelationExpr):
    """A literal collection: ``rows`` holds (row tuple, diff) pairs."""

    rows: tuple
    _schema: Schema

    def schema(self) -> Schema:
        return self._schema


@dataclass(frozen=True)
class Get(RelationExpr):
    """Reference to a named collection (a source)."""

    name: str
    _schema: Schema

    def schema(self) -> Schema:
        return self._schema


@dataclass(frozen=True)
class Let(RelationExpr):
    """``body`` with ``Get(name)`` bound to ``value`` (computed once)."""

    name: str
    value: RelationExpr
    body: RelationExpr

    def schema(self):
        return self.body.schema()

    def children(self):
        return [self.value, self.body]


@dataclass(frozen=True)
class LetRec(RelationExpr):
    """WITH MUTUALLY RECURSIVE: bindings may reference each other and
    themselves, iterated to a fixpoint or to ``max_iters`` value
    evaluations (None: the reference's cap of 100,000)."""

    names: tuple
    values: tuple
    value_schemas: tuple
    body: RelationExpr
    max_iters: int | None = None

    def schema(self):
        return self.body.schema()

    def children(self):
        return list(self.values) + [self.body]


@dataclass(frozen=True)
class Project(RelationExpr):
    input: RelationExpr
    outputs: tuple

    def schema(self):
        return self.input.schema().project(self.outputs)

    def children(self):
        return [self.input]


@dataclass(frozen=True)
class Map(RelationExpr):
    input: RelationExpr
    scalars: tuple

    def schema(self):
        cols = list(self.input.schema().columns)
        for e in self.scalars:
            c = e.typ(Schema(cols))
            cols.append(Column(f"c{len(cols)}", c.ctype, c.nullable, c.scale))
        return Schema(cols)

    def children(self):
        return [self.input]


@dataclass(frozen=True)
class FlatMap(RelationExpr):
    """A table function (``generate_series``) applied to every row; its
    ``output_cols`` are appended to the input's columns."""

    input: RelationExpr
    func: str
    exprs: tuple
    output_cols: tuple

    def schema(self):
        return Schema(tuple(self.input.schema().columns) + tuple(self.output_cols))

    def children(self):
        return [self.input]


@dataclass(frozen=True)
class Filter(RelationExpr):
    input: RelationExpr
    predicates: tuple

    def schema(self):
        return self.input.schema()

    def children(self):
        return [self.input]


@dataclass(frozen=True)
class Join(RelationExpr):
    """Multiway equi-join. ``equivalences``: classes of scalar
    expressions over the concatenated columns of all inputs, asserted
    equal. ``implementation``: "auto" | "linear" | "delta" (auto: delta
    for at least ``plan.decisions.DELTA_JOIN_MIN_INPUTS`` inputs)."""

    inputs: tuple
    equivalences: tuple  # tuple of tuples of ScalarExpr
    implementation: str = "auto"

    def schema(self):
        cols = []
        for inp in self.inputs:
            cols.extend(inp.schema().columns)
        return Schema(cols)

    def children(self):
        return list(self.inputs)


@dataclass(frozen=True)
class Reduce(RelationExpr):
    input: RelationExpr
    group_key: tuple  # column indices
    aggregates: tuple  # AggregateExpr

    def schema(self):
        in_schema = self.input.schema()
        cols = [in_schema[i] for i in self.group_key]
        for j, agg in enumerate(self.aggregates):
            c = agg.output_col(in_schema)
            cols.append(Column(f"{c.name}_{j}", c.ctype, c.nullable, c.scale))
        return Schema(cols)

    def children(self):
        return [self.input]


@dataclass(frozen=True)
class TopK(RelationExpr):
    """Per-group top ``limit`` rows (after ``offset``) by ``order_by``:
    ``(col_index, desc, nulls_last)`` per ordering column."""

    input: RelationExpr
    group_key: tuple
    order_by: tuple
    limit: int | None
    offset: int = 0

    def schema(self):
        return self.input.schema()

    def children(self):
        return [self.input]


@dataclass(frozen=True)
class Negate(RelationExpr):
    """Every diff negated."""

    input: RelationExpr

    def schema(self):
        return self.input.schema()

    def children(self):
        return [self.input]


@dataclass(frozen=True)
class Threshold(RelationExpr):
    """Rows with positive multiplicity, at that multiplicity."""

    input: RelationExpr

    def schema(self):
        return self.input.schema()

    def children(self):
        return [self.input]


@dataclass(frozen=True)
class Union(RelationExpr):
    """Multiset union. Names, types and scales come from the first
    input; a column is nullable when it is in any input."""

    inputs: tuple

    def schema(self):
        cols = list(self.inputs[0].schema().columns)
        for inp in self.inputs[1:]:
            for i, c in enumerate(inp.schema().columns):
                if i < len(cols) and c.nullable and not cols[i].nullable:
                    old = cols[i]
                    cols[i] = Column(old.name, old.ctype, True, old.scale)
        return Schema(tuple(cols))

    def children(self):
        return list(self.inputs)


@dataclass(frozen=True)
class ArrangeBy(RelationExpr):
    """Asserts an arrangement by ``key`` (column indices): a planner hint
    that renders as the identity."""

    input: RelationExpr
    key: tuple

    def schema(self):
        return self.input.schema()

    def children(self):
        return [self.input]
