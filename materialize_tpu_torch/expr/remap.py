"""Rewrite string-dictionary codes embedded in MIR after a rebalance
(the port's copy of ``materialize_tpu/expr/remap.py``).

A ``StringDictionary.rebalance()`` (repr/schema.py) relabels every code.
Installed ``DataflowDescription``s hold MIR whose string ``Literal``s and
``Constant`` rows carry OLD codes; before rebuilding dataflows from those
descriptions, the codes must be remapped. Durable state needs no rewrite
(persist parts store actual strings, storage/persist/codec.py) — this is
purely a host-side fixup of in-memory plans.
"""

from __future__ import annotations

import dataclasses

from ..repr.schema import ColumnType
from . import relation as mir
from . import scalar as ms


def remap_scalar(e, remap: dict):
    if isinstance(e, ms.Literal):
        if (
            e.ctype is ColumnType.STRING
            and e.value is not None
            and int(e.value) in remap
        ):
            return ms.Literal(remap[int(e.value)], e.ctype, e.scale)
        return e
    if not dataclasses.is_dataclass(e):
        return e
    changes = {}
    for f in dataclasses.fields(e):
        v = getattr(e, f.name)
        if isinstance(v, ms.ScalarExpr):
            nv = remap_scalar(v, remap)
            if nv is not v:
                changes[f.name] = nv
        elif isinstance(v, tuple) and any(
            isinstance(x, ms.ScalarExpr) for x in v
        ):
            nv = tuple(
                remap_scalar(x, remap)
                if isinstance(x, ms.ScalarExpr)
                else x
                for x in v
            )
            if nv != v:
                changes[f.name] = nv
    return dataclasses.replace(e, **changes) if changes else e


def _remap_aggregate(a, remap: dict):
    ne = remap_scalar(a.expr, remap)
    return dataclasses.replace(a, expr=ne) if ne is not a.expr else a


def remap_relation(expr, remap: dict):
    """Return ``expr`` with every embedded string code remapped."""
    if isinstance(expr, mir.Constant):
        str_cols = [
            i
            for i, c in enumerate(expr._schema.columns)
            if c.ctype is ColumnType.STRING
        ]
        if not str_cols or not expr.rows:
            return expr
        new_rows = []
        for vals, diff in expr.rows:
            vals = tuple(
                remap.get(int(v), v)
                if i in str_cols and v is not None
                else v
                for i, v in enumerate(vals)
            )
            new_rows.append((vals, diff))
        return mir.Constant(tuple(new_rows), expr._schema)
    if not dataclasses.is_dataclass(expr):
        return expr
    changes = {}
    for f in dataclasses.fields(expr):
        v = getattr(expr, f.name)
        if isinstance(v, mir.RelationExpr):
            nv = remap_relation(v, remap)
            if nv is not v:
                changes[f.name] = nv
        elif isinstance(v, mir.AggregateExpr):
            nv = _remap_aggregate(v, remap)
            if nv is not v:
                changes[f.name] = nv
        elif isinstance(v, ms.ScalarExpr):
            nv = remap_scalar(v, remap)
            if nv is not v:
                changes[f.name] = nv
        elif isinstance(v, tuple):
            nv = tuple(
                remap_relation(x, remap)
                if isinstance(x, mir.RelationExpr)
                else _remap_aggregate(x, remap)
                if isinstance(x, mir.AggregateExpr)
                else remap_scalar(x, remap)
                if isinstance(x, ms.ScalarExpr)
                else tuple(
                    remap_scalar(y, remap)
                    if isinstance(y, ms.ScalarExpr)
                    else y
                    for y in x
                )
                if isinstance(x, tuple)
                else x
                for x in v
            )
            if nv != v:
                changes[f.name] = nv
    return dataclasses.replace(expr, **changes) if changes else expr
