"""FlatMap: table functions with a data-dependent fan-out (the port of
``materialize_tpu/ops/flat_map.py``).

Two passes, as the join's probe expansion: each row's output count, then
one ``expand_ranges`` into a fixed-capacity tier. A fan-out beyond the
tier raises the overflow flag; the host grows the tier and replays.

Table functions: ``generate_series(start, stop)`` (step 1, inclusive).
"""

from __future__ import annotations

import torch

from ..expr.scalar import eval_expr
from ..ops.join import expand_ranges
from ..repr.batch import Batch
from ..repr.schema import Schema


def flat_map(batch: Batch, func: str, exprs: tuple, out_schema: Schema, out_time: int,
             out_capacity: int):
    """Apply a table function to every row. Returns (out_batch,
    overflow); the output's columns are the input's, then the
    function's."""
    if func != "generate_series":
        raise NotImplementedError(f"table function {func}")
    start = eval_expr(exprs[0], batch, out_time)
    stop = eval_expr(exprs[1], batch, out_time)
    null = start.null_mask() | stop.null_mask()
    s64 = start.values.to(torch.int64)
    n = torch.clamp(stop.values.to(torch.int64) - s64 + 1, min=0)
    n = torch.where(null, 0, n)
    valid = batch.valid_mask() & (batch.diff != 0)
    probe, k, out_valid, overflow = expand_ranges(torch.zeros_like(n), n, valid,
                                                  out_capacity)
    probe = probe.to(torch.int64)

    def g(a):
        return None if a is None else a[probe]

    series = s64[probe] + k.to(torch.int64)
    out = Batch(
        cols=tuple(g(c) for c in batch.cols) + (series,),
        nulls=tuple(g(nl) for nl in batch.nulls) + (None,),
        time=torch.full((out_capacity,), out_time, dtype=torch.int64, device=batch.device),
        diff=torch.where(out_valid, batch.diff[probe], 0),
        count=out_valid.sum(dtype=torch.int32),
        schema=out_schema,
    )
    return out, overflow
