"""MapFilterProject: the fused linear operator (the port of
``materialize_tpu/expr/linear.py``).

Scalar expressions appended as new columns (map), predicates that drop
rows (filter), and a final column selection (project), evaluated over a
whole batch and ending in one compaction for the filter. Temporal
predicates (comparisons with ``mz_now()``) are split out of a Filter by
the render layer into ``ops/temporal.py``; any other ``mz_now()``
evaluates here to the step's ``time``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.sort import compact
from ..repr.batch import Batch
from ..repr.schema import ERR_SCHEMA, Column, Schema
from . import errors as _errors
from .scalar import eval_expr


@dataclass(frozen=True)
class MapFilterProject:
    """input_arity -> map expressions -> predicates -> projection.

    Expressions may reference input columns and previously mapped columns
    (by position input_arity + i)."""

    input_arity: int
    expressions: tuple = ()
    predicates: tuple = ()
    projection: tuple | None = None  # None = identity over all columns

    def __init__(self, input_arity, expressions=(), predicates=(), projection=None):
        object.__setattr__(self, "input_arity", input_arity)
        object.__setattr__(self, "expressions", tuple(expressions))
        object.__setattr__(self, "predicates", tuple(predicates))
        object.__setattr__(
            self, "projection", tuple(projection) if projection is not None else None
        )

    @property
    def is_identity(self) -> bool:
        return (
            not self.expressions
            and not self.predicates
            and (
                self.projection is None
                or self.projection == tuple(range(self.input_arity))
            )
        )

    def output_schema(self, schema: Schema) -> Schema:
        full = list(schema.columns)
        for e in self.expressions:
            full.append(e.typ(Schema(full)))
        proj = self.projection if self.projection is not None else range(len(full))
        cols = []
        for i, j in enumerate(proj):
            c = full[j]
            cols.append(Column(f"c{i}" if c.name == "f" else c.name,
                               c.ctype, c.nullable, c.scale))
        return Schema(cols)


def apply_mfp(mfp: MapFilterProject, batch: Batch, time=None, errs=None) -> Batch:
    """Evaluate the MFP over a batch: map, filter, project, compacted.

    Scalar evaluation errors become error update rows appended to
    ``errs`` (the step's err collection, ``expr/errors.py``); with
    ``errs`` None, erroring rows only become NULL."""
    if batch.schema.arity != mfp.input_arity:
        raise ValueError(
            f"mfp arity {mfp.input_arity} != batch arity {batch.schema.arity}"
        )
    if mfp.is_identity:
        return batch
    masks: list = []
    out = _apply_mfp_inner(mfp, batch, time, masks)
    if masks and errs is not None:
        valid = batch.valid_mask()
        for code, mask in masks:
            errs.append(_err_batch(code, mask & valid, batch))
    return out


def _err_batch(code: int, mask: torch.Tensor, batch: Batch) -> Batch:
    """Error update rows: (err_code, time, diff) for masked rows."""
    return Batch(
        cols=(torch.full((batch.capacity,), code, dtype=torch.int64,
                         device=batch.device),),
        nulls=(None,),
        time=batch.time,
        diff=torch.where(mask, batch.diff, 0),
        count=batch.count,
        schema=ERR_SCHEMA,
    )


def _with_columns(batch: Batch, cols, nulls, schema: Schema) -> Batch:
    return Batch(cols=tuple(cols), nulls=tuple(nulls), time=batch.time,
                 diff=batch.diff, count=batch.count, schema=schema)


def _apply_mfp_inner(mfp: MapFilterProject, batch: Batch, time, masks: list) -> Batch:
    # Working set: input columns + mapped columns, with growing schema.
    work_cols = list(batch.cols)
    work_nulls = list(batch.nulls)
    work_schema = list(batch.schema.columns)
    for e in mfp.expressions:
        tmp = _with_columns(batch, work_cols, work_nulls, Schema(work_schema))
        ev = eval_expr(e, tmp, time, masks)
        work_cols.append(ev.values)
        work_nulls.append(ev.nulls)
        work_schema.append(ev.col)
    full = _with_columns(batch, work_cols, work_nulls, Schema(work_schema))

    # Filter: predicate TRUE (not false, not NULL) keeps the row.
    # Predicates short-circuit left to right for ERRORS: a predicate's
    # evaluation errors only count for rows every earlier predicate
    # kept. Map expressions above evaluate unconditionally.
    keep = None
    for p in mfp.predicates:
        pmasks: list = []
        ev = eval_expr(p, full, time, pmasks)
        for code, mask in pmasks:
            _errors.emit(masks, code, mask if keep is None else mask & keep)
        ok = ev.values & ~ev.null_mask()
        keep = ok if keep is None else keep & ok

    proj = (
        mfp.projection if mfp.projection is not None
        else tuple(range(len(work_schema)))
    )
    projected = _with_columns(
        batch, [work_cols[j] for j in proj], [work_nulls[j] for j in proj],
        mfp.output_schema(batch.schema),
    )
    if keep is None:
        return projected
    return compact(projected, keep)
