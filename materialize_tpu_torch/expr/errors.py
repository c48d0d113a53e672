"""Error streams: the ok/err collection pair (the port of
``materialize_tpu/expr/errors.py``).

A scalar evaluation site over a data-dependent domain (division,
modulo) reports a per-row error mask; the step turns the masks into
error update rows ``(err_code, time, diff)`` kept in a second output
arrangement beside the data output. Reads consult it first: nonempty
means the maintained result is an error. Deleting the offending row
feeds the same mask with the opposite diff and retracts the error.

The reference collects through thread-local sinks that are active
while a step program is traced. The port runs eagerly and passes its
sinks as arguments instead:

- ``masks``: a list of ``(code, mask)`` pairs that ``eval_expr``
  appends to. ``None`` means no sink: erroring rows only become NULL
  (the reference's behaviour outside a collecting scope).
- ``errs``: a list of error update batches that ``apply_mfp`` and the
  Reduce append to; the dataflow step unions and consolidates them
  into its err arrangement. ``None`` means no step sink.
"""

from __future__ import annotations

# error codes (the reference's EvalError analog)
DIVISION_BY_ZERO = 1
NUMERIC_OUT_OF_RANGE = 2

MESSAGES = {
    DIVISION_BY_ZERO: "division by zero",
    NUMERIC_OUT_OF_RANGE: "numeric field overflow",
}

# Per-code count vectors (a LetRec carries one through its iterations)
# are indexed by code: codes stay small and dense.
N_CODES = max(MESSAGES) + 1


def emit(masks, code: int, mask) -> None:
    """Publish a per-row error mask into ``masks`` (no-op when None)."""
    if masks is not None:
        masks.append((code, mask))
