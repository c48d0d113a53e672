"""Scalar expressions and their evaluation over a batch's columns (the
port of the part of ``materialize_tpu/expr/scalar.py`` that TPC-H Q1,
Q15, Q9 and Q21 and the temporal filters reach).

Where the reference builds one fused XLA computation per expression at
trace time, ``eval_expr`` here runs eager torch ops over whole columns.
SQL NULLs ride as an optional bool mask per intermediate (three-valued
logic), exactly as in the reference.

Ported: column references, literals (FLOAT64 ones included),
``CallUnary`` NOT, IS_NULL and the EXTRACT family on DATE and TIMESTAMP
(YEAR, MONTH, DAY, QUARTER, DOW, ISODOW, DOY, WEEK, HOUR, MINUTE,
MILLENNIUM, CENTURY, DECADE, and the FLOAT64 EPOCH and SECOND), and
``CallBinary`` for the six comparisons, for integer, DECIMAL and FLOAT64
``add``/``sub``/``mul``/``div``/``mod`` (with their division-by-zero
masks; an INT64 or DECIMAL operand of a float operation is coerced as
the reference's ``_as_float`` does) and for ``power``/``log_base``, and
``mz_now()`` (the step's time; a comparison with it in a Filter is a
temporal filter, ``ops/temporal.py``). Everything else raises
``NotImplementedError`` naming the missing piece: the other unary
functions and casts, ``AND``/``OR`` and the other variadic functions,
``If``, date_trunc and the string families and
``round_to``/``cast_decimal`` (ROADMAP Queue 1).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from ..repr.batch import Batch
from ..repr.schema import Column, ColumnType, Schema, torch_dtype
from . import errors as _err


class ScalarExpr:
    """Base class. Subclasses are immutable dataclasses."""

    def typ(self, schema: Schema) -> Column:
        raise NotImplementedError

    # convenience builders
    def __add__(self, other):
        return CallBinary(BinaryFunc.ADD, self, _lift(other))

    def __sub__(self, other):
        return CallBinary(BinaryFunc.SUB, self, _lift(other))

    def __mul__(self, other):
        return CallBinary(BinaryFunc.MUL, self, _lift(other))

    def eq(self, other):
        return CallBinary(BinaryFunc.EQ, self, _lift(other))

    def lt(self, other):
        return CallBinary(BinaryFunc.LT, self, _lift(other))

    def lte(self, other):
        return CallBinary(BinaryFunc.LTE, self, _lift(other))

    def gt(self, other):
        return CallBinary(BinaryFunc.GT, self, _lift(other))

    def gte(self, other):
        return CallBinary(BinaryFunc.GTE, self, _lift(other))


def _lift(x) -> "ScalarExpr":
    if isinstance(x, ScalarExpr):
        return x
    if isinstance(x, bool):
        return Literal(x, ColumnType.BOOL)
    if isinstance(x, int):
        return Literal(x, ColumnType.INT64)
    if isinstance(x, float):
        return Literal(x, ColumnType.FLOAT64)
    raise TypeError(x)


@dataclass(frozen=True)
class MzNow(ScalarExpr):
    """The current virtual timestamp: evaluates to the step's time.
    Predicates over it are temporal filters (``ops/temporal.py``)."""

    def typ(self, schema: Schema) -> Column:
        return Column("mz_now", ColumnType.TIMESTAMP)


def contains_mz_now(expr: ScalarExpr) -> bool:
    if isinstance(expr, MzNow):
        return True
    for f in getattr(expr, "__dataclass_fields__", {}):
        v = getattr(expr, f)
        if isinstance(v, ScalarExpr) and contains_mz_now(v):
            return True
        if isinstance(v, tuple) and any(
            isinstance(x, ScalarExpr) and contains_mz_now(x) for x in v
        ):
            return True
    return False


@dataclass(frozen=True)
class ColumnRef(ScalarExpr):
    """Column reference by position."""

    index: int

    def typ(self, schema):
        return schema[self.index]


@dataclass(frozen=True)
class Literal(ScalarExpr):
    value: Any  # python scalar; None = NULL
    ctype: ColumnType
    scale: int = 0

    def typ(self, schema):
        return Column("literal", self.ctype, self.value is None, self.scale)


class UnaryFunc:
    """The unary functions the port names (the reference's strings);
    every other name of the reference's ``UnaryFunc`` raises
    ``NotImplementedError``."""

    NOT = "not"
    IS_NULL = "is_null"
    # date parts (DATE = days since epoch; TIMESTAMP = ms since epoch)
    EXTRACT_YEAR = "extract_year"
    EXTRACT_MONTH = "extract_month"
    EXTRACT_DAY = "extract_day"
    EXTRACT_QUARTER = "extract_quarter"
    EXTRACT_DOW = "extract_dow"
    EXTRACT_ISODOW = "extract_isodow"
    EXTRACT_DOY = "extract_doy"
    EXTRACT_WEEK = "extract_week"
    EXTRACT_EPOCH = "extract_epoch"
    EXTRACT_HOUR = "extract_hour"
    EXTRACT_MINUTE = "extract_minute"
    EXTRACT_SECOND = "extract_second"
    EXTRACT_MILLENNIUM = "extract_millennium"
    EXTRACT_CENTURY = "extract_century"
    EXTRACT_DECADE = "extract_decade"


_EXTRACT_INT_FUNCS = frozenset(
    {
        UnaryFunc.EXTRACT_YEAR,
        UnaryFunc.EXTRACT_MONTH,
        UnaryFunc.EXTRACT_DAY,
        UnaryFunc.EXTRACT_QUARTER,
        UnaryFunc.EXTRACT_DOW,
        UnaryFunc.EXTRACT_ISODOW,
        UnaryFunc.EXTRACT_DOY,
        UnaryFunc.EXTRACT_WEEK,
        UnaryFunc.EXTRACT_HOUR,
        UnaryFunc.EXTRACT_MINUTE,
        UnaryFunc.EXTRACT_MILLENNIUM,
        UnaryFunc.EXTRACT_CENTURY,
        UnaryFunc.EXTRACT_DECADE,
    }
)


_EXTRACT_FLOAT_FUNCS = frozenset({UnaryFunc.EXTRACT_EPOCH, UnaryFunc.EXTRACT_SECOND})


def _unported_unary(func: str):
    return NotImplementedError(
        f"unary function {func!r} is not ported (ROADMAP Queue 1 item 9)"
    )


@dataclass(frozen=True)
class CallUnary(ScalarExpr):
    func: str
    expr: ScalarExpr

    def typ(self, schema):
        inner = self.expr.typ(schema)
        if self.func == UnaryFunc.NOT:
            return Column("f", ColumnType.BOOL, inner.nullable)
        if self.func == UnaryFunc.IS_NULL:
            return Column("f", ColumnType.BOOL, False)
        if self.func in _EXTRACT_INT_FUNCS:
            return Column("f", ColumnType.INT64, inner.nullable)
        if self.func in _EXTRACT_FLOAT_FUNCS:
            return Column("f", ColumnType.FLOAT64, inner.nullable)
        raise _unported_unary(self.func)


class BinaryFunc:
    ADD = "add"
    SUB = "sub"
    MUL = "mul"
    DIV = "div"
    MOD = "mod"
    POWER = "power"
    LOG_BASE = "log_base"
    ROUND_TO = "round_to"
    CAST_DECIMAL = "cast_decimal"
    EQ = "eq"
    NEQ = "neq"
    LT = "lt"
    LTE = "lte"
    GT = "gt"
    GTE = "gte"


_ARITHMETIC = (BinaryFunc.ADD, BinaryFunc.SUB, BinaryFunc.MUL, BinaryFunc.DIV,
               BinaryFunc.MOD)

_COMPARISONS = {
    BinaryFunc.EQ: torch.eq,
    BinaryFunc.NEQ: torch.ne,
    BinaryFunc.LT: torch.lt,
    BinaryFunc.LTE: torch.le,
    BinaryFunc.GT: torch.gt,
    BinaryFunc.GTE: torch.ge,
}


@dataclass(frozen=True)
class CallBinary(ScalarExpr):
    func: str
    left: ScalarExpr
    right: ScalarExpr

    def typ(self, schema):
        lt_, rt = self.left.typ(schema), self.right.typ(schema)
        nullable = lt_.nullable or rt.nullable
        if self.func in _COMPARISONS:
            return Column("f", ColumnType.BOOL, nullable)
        if self.func in (BinaryFunc.POWER, BinaryFunc.LOG_BASE):
            return Column("f", ColumnType.FLOAT64, True)
        if self.func not in _ARITHMETIC:
            raise NotImplementedError(f"binary function {self.func!r} is not ported")
        if self.func == BinaryFunc.DIV:
            # int/int is integer division truncating toward zero;
            # decimals keep the left scale; anything else goes float.
            if lt_.ctype is ColumnType.DECIMAL:
                return Column("f", ColumnType.DECIMAL, True, lt_.scale)
            if lt_.ctype in (
                ColumnType.INT32, ColumnType.INT64
            ) and rt.ctype in (ColumnType.INT32, ColumnType.INT64):
                return Column("f", ColumnType.INT64, True)
            return Column("f", ColumnType.FLOAT64, True)
        ctype, scale = _unify_arith(lt_, rt, self.func)
        return Column("f", ctype, nullable, scale)


def _unify_arith(lt_: Column, rt: Column, func: str) -> tuple:
    a, b = lt_.ctype, rt.ctype
    if ColumnType.FLOAT64 in (a, b):
        return ColumnType.FLOAT64, 0
    if a is ColumnType.DECIMAL or b is ColumnType.DECIMAL:
        if func == BinaryFunc.MUL:
            return ColumnType.DECIMAL, lt_.scale + rt.scale
        return ColumnType.DECIMAL, max(lt_.scale, rt.scale)
    if a is ColumnType.DATE and b in (ColumnType.INT32, ColumnType.INT64):
        return ColumnType.DATE, 0
    if ColumnType.INT64 in (a, b):
        return ColumnType.INT64, 0
    return a, 0


# ---------------------------------------------------------------------------
# Evaluation


@dataclass
class Evaled:
    """An evaluated intermediate: column values + optional null mask."""

    values: torch.Tensor
    nulls: torch.Tensor | None
    col: Column  # type info

    def null_mask(self) -> torch.Tensor:
        if self.nulls is None:
            return torch.zeros(self.values.shape, dtype=torch.bool,
                               device=self.values.device)
        return self.nulls


def _floordiv(a: torch.Tensor, b) -> torch.Tensor:
    """jnp's ``//`` on integers: floor division."""
    return torch.div(a, b, rounding_mode="floor")


def _civil_from_days(days: torch.Tensor):
    """Howard Hinnant's civil_from_days, vectorized: (year, month, day)
    int64 tensors from days since the epoch (proleptic Gregorian). Every
    division floors, as jnp's ``//`` does."""
    z = days + 719468
    era = _floordiv(torch.where(z >= 0, z, z - 146096), 146097)
    doe = z - era * 146097
    yoe = _floordiv(
        doe - _floordiv(doe, 1460) + _floordiv(doe, 36524) - _floordiv(doe, 146096), 365
    )
    y = yoe + era * 400
    doy = doe - (365 * yoe + _floordiv(yoe, 4) - _floordiv(yoe, 100))
    mp = _floordiv(5 * doy + 2, 153)
    d = doy - _floordiv(153 * mp + 2, 5) + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    return torch.where(m <= 2, y + 1, y), m, d


def _days_from_civil_jan1(y: torch.Tensor) -> torch.Tensor:
    """Days since the epoch of January 1st of year ``y``: the reference's
    ``_days_from_civil(y, 1, 1)`` (month 1 counts in the previous
    March-based year)."""
    y = y - 1
    era = _floordiv(torch.where(y >= 0, y, y - 399), 400)
    yoe = y - era * 400
    doy = (153 * 10 + 2) // 5  # month 1 is the 11th month from March
    doe = yoe * 365 + _floordiv(yoe, 4) - _floordiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


_MS_PER_DAY = 86_400_000


def _days_and_ms(e: "Evaled"):
    """(days since the epoch, ms of the day) of a DATE or TIMESTAMP."""
    if e.col.ctype is ColumnType.TIMESTAMP:
        ms = e.values.to(torch.int64)
        return _floordiv(ms, _MS_PER_DAY), torch.remainder(ms, _MS_PER_DAY)
    days = e.values.to(torch.int64)
    return days, torch.zeros_like(days)


def _eval_extract(f: str, e: "Evaled", col: Column) -> "Evaled":
    """The reference's ``_eval_extract``."""
    days, msod = _days_and_ms(e)
    if f == UnaryFunc.EXTRACT_EPOCH:
        if e.col.ctype is ColumnType.TIMESTAMP:
            return Evaled(e.values.to(torch.float64) / 1000.0, e.nulls, col)
        return Evaled(days.to(torch.float64) * 86400.0, e.nulls, col)
    if f == UnaryFunc.EXTRACT_SECOND:
        return Evaled(torch.remainder(msod, 60_000).to(torch.float64) / 1000.0,
                      e.nulls, col)
    if f == UnaryFunc.EXTRACT_HOUR:
        return Evaled(_floordiv(msod, 3_600_000), e.nulls, col)
    if f == UnaryFunc.EXTRACT_MINUTE:
        return Evaled(torch.remainder(_floordiv(msod, 60_000), 60), e.nulls, col)
    if f == UnaryFunc.EXTRACT_DOW:
        # pg: Sunday=0..Saturday=6; 1970-01-01 was a Thursday
        return Evaled(torch.remainder(days + 4, 7), e.nulls, col)
    if f == UnaryFunc.EXTRACT_ISODOW:
        return Evaled(torch.remainder(days + 3, 7) + 1, e.nulls, col)
    y, m, d = _civil_from_days(days)
    if f == UnaryFunc.EXTRACT_YEAR:
        return Evaled(y, e.nulls, col)
    if f == UnaryFunc.EXTRACT_MONTH:
        return Evaled(m, e.nulls, col)
    if f == UnaryFunc.EXTRACT_DAY:
        return Evaled(d, e.nulls, col)
    if f == UnaryFunc.EXTRACT_QUARTER:
        return Evaled(_floordiv(m + 2, 3), e.nulls, col)
    if f == UnaryFunc.EXTRACT_DOY:
        return Evaled(days - _days_from_civil_jan1(y) + 1, e.nulls, col)
    if f == UnaryFunc.EXTRACT_WEEK:
        # ISO 8601 week: the week holding this date's Thursday
        thursday = days + (3 - torch.remainder(days + 3, 7))
        ty, _, _ = _civil_from_days(thursday)
        week = _floordiv(thursday - _days_from_civil_jan1(ty), 7) + 1
        return Evaled(week, e.nulls, col)
    if f == UnaryFunc.EXTRACT_MILLENNIUM:
        return Evaled(_floordiv(y - 1, 1000) + 1, e.nulls, col)
    if f == UnaryFunc.EXTRACT_CENTURY:
        return Evaled(_floordiv(y - 1, 100) + 1, e.nulls, col)
    if f == UnaryFunc.EXTRACT_DECADE:
        return Evaled(_floordiv(y, 10), e.nulls, col)
    raise _unported_unary(f)


def _to_decimal_scale(e: Evaled, scale: int) -> torch.Tensor:
    """Rescale a decimal (or int) value array to the given decimal scale."""
    shift = scale - e.col.scale if e.col.ctype is ColumnType.DECIMAL else scale
    v = e.values.to(torch.int64)
    if shift > 0:
        return v * (10**shift)
    if shift < 0:
        return _floordiv(v, 10 ** (-shift))
    return v


def _merge_nulls(l: Evaled, r: Evaled):
    if l.nulls is None and r.nulls is None:
        return None
    return l.null_mask() | r.null_mask()


def _or_nulls(nulls, extra):
    return extra if nulls is None else nulls | extra


def _as_float(e: Evaled) -> torch.Tensor:
    """A numeric operand as float64 (a DECIMAL divided by its scale)."""
    if e.col.ctype is ColumnType.DECIMAL:
        return e.values.to(torch.float64) / (10.0**e.col.scale)
    return e.values.to(torch.float64)


def _coerce_comparable(l: Evaled, r: Evaled):
    """Align decimal scales / numeric types for comparison."""
    if ColumnType.FLOAT64 in (l.col.ctype, r.col.ctype):
        return _as_float(l), _as_float(r)
    if ColumnType.DECIMAL in (l.col.ctype, r.col.ctype):
        scale = max(l.col.scale, r.col.scale)
        return _to_decimal_scale(l, scale), _to_decimal_scale(r, scale)
    return l.values, r.values


def _div_zero_mask(zero, l: Evaled, r: Evaled) -> torch.Tensor:
    """Rows whose division errs: a zero divisor where neither operand is
    NULL (pg: a NULL operand yields NULL, no error)."""
    return zero & ~(r.null_mask() | l.null_mask())


def _trunc_quotient(li: torch.Tensor, ri: torch.Tensor) -> torch.Tensor:
    """Integer quotient truncating toward zero (pg int8div)."""
    q = _floordiv(torch.abs(li), torch.abs(ri))
    return torch.where(torch.sign(li) == torch.sign(ri), q, -q)


def eval_expr(expr: ScalarExpr, batch: Batch, time=None, masks=None) -> Evaled:
    """Evaluate ``expr`` over every row (padding included) of ``batch``.
    Division-by-zero masks go to ``masks`` (see ``expr/errors.py``);
    ``time`` is the step's timestamp, the value of ``mz_now()`` (None
    outside a timed step, where ``mz_now()`` raises)."""
    schema = batch.schema
    cap = batch.capacity
    dev = batch.device

    if isinstance(expr, MzNow):
        if time is None:
            raise ValueError("mz_now() evaluated outside a timed dataflow step")
        return Evaled(torch.full((cap,), int(time), dtype=torch.int64, device=dev), None,
                      expr.typ(schema))

    if isinstance(expr, ColumnRef):
        return Evaled(
            batch.cols[expr.index], batch.nulls[expr.index], schema[expr.index]
        )

    if isinstance(expr, Literal):
        col = expr.typ(schema)
        dtype = torch_dtype(col.dtype)
        if expr.value is None:
            return Evaled(
                torch.zeros(cap, dtype=dtype, device=dev),
                torch.ones(cap, dtype=torch.bool, device=dev),
                col,
            )
        return Evaled(torch.full((cap,), expr.value, dtype=dtype, device=dev),
                      None, col)

    if isinstance(expr, CallUnary):
        col = expr.typ(schema)
        e = eval_expr(expr.expr, batch, time, masks)
        if expr.func == UnaryFunc.NOT:
            # NOT keeps its operand's NULLs (three-valued logic).
            return Evaled(torch.logical_not(e.values), e.nulls, col)
        if expr.func == UnaryFunc.IS_NULL:
            # IS NULL is never NULL.
            return Evaled(e.null_mask(), None, col)
        return _eval_extract(expr.func, e, col)

    if not isinstance(expr, CallBinary):
        raise NotImplementedError(
            f"scalar expression {type(expr).__name__} is not ported"
        )

    l = eval_expr(expr.left, batch, time, masks)
    r = eval_expr(expr.right, batch, time, masks)
    col = expr.typ(schema)
    nulls = _merge_nulls(l, r)
    f = expr.func
    if f in _COMPARISONS:
        # Strings compare directly: dictionary codes are order-preserving
        # labels, so integer order is lexicographic order.
        lv, rv = _coerce_comparable(l, r)
        return Evaled(_COMPARISONS[f](lv, rv), nulls, col)
    if f in (BinaryFunc.POWER, BinaryFunc.LOG_BASE):
        return _eval_float_fn(f, l, r, nulls, col)
    if col.ctype is ColumnType.DECIMAL:
        if f == BinaryFunc.MUL:
            # No rescale: the product's scale is the sum of the scales.
            return Evaled(l.values.to(torch.int64) * r.values.to(torch.int64),
                          nulls, col)
        lv = _to_decimal_scale(l, col.scale)
        rv = _to_decimal_scale(r, col.scale)
        if f == BinaryFunc.ADD:
            return Evaled(lv + rv, nulls, col)
        if f == BinaryFunc.SUB:
            return Evaled(lv - rv, nulls, col)
        if f == BinaryFunc.DIV:
            # Both operands are at col.scale after rescaling, so the
            # scale-preserving quotient multiplies by 10^col.scale.
            zero = rv == 0
            _err.emit(masks, _err.DIVISION_BY_ZERO, _div_zero_mask(zero, l, r))
            safe = torch.where(zero, 1, rv)
            return Evaled(_floordiv(lv * (10**col.scale), safe),
                          _or_nulls(nulls, zero), col)
    if f == BinaryFunc.ADD:
        return Evaled(l.values + r.values, nulls, col)
    if f == BinaryFunc.SUB:
        return Evaled(l.values - r.values, nulls, col)
    if f == BinaryFunc.MUL:
        return Evaled(l.values * r.values, nulls, col)
    if f == BinaryFunc.DIV and col.ctype is ColumnType.FLOAT64:
        lv, rv = _as_float(l), _as_float(r)
        zero = rv == 0.0
        _err.emit(masks, _err.DIVISION_BY_ZERO, _div_zero_mask(zero, l, r))
        return Evaled(lv / torch.where(zero, 1.0, rv), _or_nulls(nulls, zero), col)
    if f == BinaryFunc.DIV:
        li = l.values.to(torch.int64)
        ri = r.values.to(torch.int64)
        zero = ri == 0
        _err.emit(masks, _err.DIVISION_BY_ZERO, _div_zero_mask(zero, l, r))
        v = _trunc_quotient(li, torch.where(zero, 1, ri))
        return Evaled(v, _or_nulls(nulls, zero), col)
    if f == BinaryFunc.MOD:
        # pg mod truncates toward zero: the result takes the dividend's
        # sign. The integer path also covers DECIMAL (scaled-int mod is
        # decimal mod at that scale).
        zero = r.values == 0
        _err.emit(masks, _err.DIVISION_BY_ZERO, _div_zero_mask(zero, l, r))
        if col.ctype is ColumnType.FLOAT64:
            # fmod truncates, as pg's float mod does.
            v = torch.fmod(_as_float(l), torch.where(zero, 1.0, _as_float(r)))
            return Evaled(torch.where(zero, 0.0, v), _or_nulls(nulls, zero), col)
        li = l.values.to(torch.int64)
        ri = torch.where(zero, 1, r.values.to(torch.int64))
        v = torch.where(zero, 0, li - _trunc_quotient(li, ri) * ri)
        if l.values.dtype != torch.int64:
            v = v.to(l.values.dtype)
        return Evaled(v, _or_nulls(nulls, zero), col)
    raise NotImplementedError(f"binary function {f!r} is not ported")


def _eval_float_fn(f: str, l: Evaled, r: Evaled, nulls, col: Column) -> Evaled:
    """POWER and LOG_BASE: a NaN or infinite power, and a base <= 0, a
    base of 1 or an argument <= 0 of a logarithm, give NULL (no err
    row), as in the reference."""
    lv, rv = _as_float(l), _as_float(r)
    if f == BinaryFunc.POWER:
        v = torch.pow(lv, rv)
        bad = torch.isnan(v) | torch.isinf(v)
        return Evaled(torch.where(bad, 0.0, v), _or_nulls(nulls, bad), col)
    bad = (lv <= 0.0) | (lv == 1.0) | (rv <= 0.0)
    v = torch.log(torch.where(bad, 2.0, rv)) / torch.log(torch.where(bad, 2.0, lv))
    return Evaled(v, _or_nulls(nulls, bad), col)


# Convenience helpers for building expressions in tests/plans.
def col(i: int) -> ColumnRef:
    return ColumnRef(i)


def lit(value, ctype: ColumnType | None = None, scale: int = 0) -> Literal:
    if ctype is None:
        return _lift(value)
    return Literal(value, ctype, scale)
