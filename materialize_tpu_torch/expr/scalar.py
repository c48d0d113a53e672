"""Scalar expressions and their evaluation over a batch's columns (the
port of ``materialize_tpu/expr/scalar.py``).

Where the reference builds one fused XLA computation per expression at
trace time, ``eval_expr`` here runs eager torch ops over whole columns.
SQL NULLs ride as an optional bool mask per intermediate (three-valued
logic), exactly as in the reference.

Ported, all of the reference's vocabulary: column references, literals,
``mz_now()`` (the step's time; a comparison with it in a Filter is a
temporal filter, ``ops/temporal.py``), ``If``; ``CallUnary`` NOT, NEG,
ABS, IS_NULL, the math family (FLOOR, CEIL, ROUND, TRUNC, SQRT, CBRT,
EXP, LN, LOG10, LOG2, SIGN and the trigonometric ones), the casts, the
EXTRACT family and the DATE_TRUNC family on DATE and TIMESTAMP;
``CallBinary`` for the six comparisons, the arithmetic with its
division-by-zero masks, POWER, LOG_BASE, ROUND_TO and CAST_DECIMAL;
``CallVariadic`` AND and OR (three-valued), COALESCE, GREATEST, LEAST,
ADD_INTERVAL and the string functions (``expr/strings.py``: dictionary
side tables on the host and a device gather). A string function with a
non-literal argument raises ``NotImplementedError``, as in the
reference.
"""

from __future__ import annotations

import math
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
    NOT = "not"
    NEG = "neg"
    IS_NULL = "is_null"
    ABS = "abs"
    # math family (scalar func library analog, expr/src/scalar/func/impls)
    FLOOR = "floor"
    CEIL = "ceil"
    ROUND = "round"
    TRUNC = "trunc"
    SQRT = "sqrt"
    CBRT = "cbrt"
    EXP = "exp"
    LN = "ln"
    LOG10 = "log10"
    LOG2 = "log2"
    SIGN = "sign"
    SIN = "sin"
    COS = "cos"
    TAN = "tan"
    ASIN = "asin"
    ACOS = "acos"
    ATAN = "atan"
    RADIANS = "radians"
    DEGREES = "degrees"
    # cast family
    CAST_INT64 = "cast_int64"
    CAST_INT32 = "cast_int32"
    CAST_FLOAT64 = "cast_float64"
    CAST_BOOL = "cast_bool"
    CAST_DATE = "cast_date"
    CAST_TIMESTAMP = "cast_timestamp"
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
    # date_trunc family: value-preserving truncation to a boundary
    DATE_TRUNC_YEAR = "date_trunc_year"
    DATE_TRUNC_QUARTER = "date_trunc_quarter"
    DATE_TRUNC_MONTH = "date_trunc_month"
    DATE_TRUNC_WEEK = "date_trunc_week"
    DATE_TRUNC_DAY = "date_trunc_day"
    DATE_TRUNC_HOUR = "date_trunc_hour"
    DATE_TRUNC_MINUTE = "date_trunc_minute"
    DATE_TRUNC_SECOND = "date_trunc_second"

    EXTRACTS = {}  # filled below
    DATE_TRUNCS = {}  # filled below


UnaryFunc.EXTRACTS = {
    "year": UnaryFunc.EXTRACT_YEAR,
    "month": UnaryFunc.EXTRACT_MONTH,
    "day": UnaryFunc.EXTRACT_DAY,
    "quarter": UnaryFunc.EXTRACT_QUARTER,
    "dow": UnaryFunc.EXTRACT_DOW,
    "isodow": UnaryFunc.EXTRACT_ISODOW,
    "doy": UnaryFunc.EXTRACT_DOY,
    "week": UnaryFunc.EXTRACT_WEEK,
    "epoch": UnaryFunc.EXTRACT_EPOCH,
    "hour": UnaryFunc.EXTRACT_HOUR,
    "minute": UnaryFunc.EXTRACT_MINUTE,
    "second": UnaryFunc.EXTRACT_SECOND,
    "millennium": UnaryFunc.EXTRACT_MILLENNIUM,
    "century": UnaryFunc.EXTRACT_CENTURY,
    "decade": UnaryFunc.EXTRACT_DECADE,
}

UnaryFunc.DATE_TRUNCS = {
    "year": UnaryFunc.DATE_TRUNC_YEAR,
    "quarter": UnaryFunc.DATE_TRUNC_QUARTER,
    "month": UnaryFunc.DATE_TRUNC_MONTH,
    "week": UnaryFunc.DATE_TRUNC_WEEK,
    "day": UnaryFunc.DATE_TRUNC_DAY,
    "hour": UnaryFunc.DATE_TRUNC_HOUR,
    "minute": UnaryFunc.DATE_TRUNC_MINUTE,
    "second": UnaryFunc.DATE_TRUNC_SECOND,
}


class BinaryFunc:
    ADD = "add"
    SUB = "sub"
    MUL = "mul"
    DIV = "div"
    MOD = "mod"
    POWER = "power"
    LOG_BASE = "log_base"
    ROUND_TO = "round_to"  # round(x, n): n must be a literal
    CAST_DECIMAL = "cast_decimal"  # cast(x as decimal(p, s)): s a literal
    EQ = "eq"
    NEQ = "neq"
    LT = "lt"
    LTE = "lte"
    GT = "gt"
    GTE = "gte"


# String functions evaluate as dictionary side-table gathers (see
# expr/strings.py): CallVariadic("str:<fn>", (col, literal params...)).
STRING_FUNC_PREFIX = "str:"


def string_call(func: str, expr: "ScalarExpr", *params) -> "CallVariadic":
    return CallVariadic(
        STRING_FUNC_PREFIX + func, (expr,) + tuple(params)
    )


def _string_func_key(func: str, param_exprs) -> str:
    """Trace/render-time env key: literal params decoded to text (in the
    dictionary in scope, ``strings.dictionary_scope``)."""
    from . import strings

    vals = []
    for p in param_exprs:
        if not isinstance(p, Literal):
            raise NotImplementedError(
                f"{func}: non-literal string-function arguments are "
                "not supported (the mapping table is precomputed per "
                "distinct dictionary entry)"
            )
        if p.value is None:
            raise NotImplementedError(
                f"{func}: NULL parameters are not supported"
            )
        if p.ctype is ColumnType.STRING:
            vals.append(strings.current_dictionary().decode(int(p.value)))
        else:
            vals.append(p.value)
    return strings.env_key(func, *vals)


class VariadicFunc:
    AND = "and"
    OR = "or"
    COALESCE = "coalesce"
    GREATEST = "greatest"
    LEAST = "least"
    # (expr, months, days, ms) with literal interval parts; subtraction
    # negates the parts at plan time
    ADD_INTERVAL = "add_interval"


@dataclass(frozen=True)
class CallUnary(ScalarExpr):
    func: str
    expr: ScalarExpr

    def typ(self, schema):
        inner = self.expr.typ(schema)
        f = self.func
        if f in (UnaryFunc.NOT,):
            return Column("f", ColumnType.BOOL, inner.nullable)
        if f == UnaryFunc.IS_NULL:
            return Column("f", ColumnType.BOOL, False)
        if f == UnaryFunc.CAST_INT64:
            return Column("f", ColumnType.INT64, inner.nullable)
        if f == UnaryFunc.CAST_INT32:
            return Column("f", ColumnType.INT32, inner.nullable)
        if f == UnaryFunc.CAST_FLOAT64:
            return Column("f", ColumnType.FLOAT64, inner.nullable)
        if f == UnaryFunc.CAST_BOOL:
            return Column("f", ColumnType.BOOL, inner.nullable)
        if f == UnaryFunc.CAST_DATE:
            return Column("f", ColumnType.DATE, inner.nullable)
        if f == UnaryFunc.CAST_TIMESTAMP:
            return Column("f", ColumnType.TIMESTAMP, inner.nullable)
        if f in _EXTRACT_INT_FUNCS:
            return Column("f", ColumnType.INT64, inner.nullable)
        if f in (UnaryFunc.EXTRACT_EPOCH, UnaryFunc.EXTRACT_SECOND):
            return Column("f", ColumnType.FLOAT64, inner.nullable)
        if f in (UnaryFunc.FLOOR, UnaryFunc.CEIL, UnaryFunc.TRUNC,
                 UnaryFunc.ROUND):
            # type-preserving on numerics (floor(numeric) is numeric)
            return inner
        if f in _FLOAT_UNARY_FUNCS:
            # domain errors (sqrt of negative, ln of nonpositive) yield
            # NULL here where the reference raises an EvalError
            nullable = inner.nullable or f in (
                UnaryFunc.SQRT, UnaryFunc.LN, UnaryFunc.LOG10,
                UnaryFunc.LOG2, UnaryFunc.ASIN, UnaryFunc.ACOS,
            )
            return Column("f", ColumnType.FLOAT64, nullable)
        if f == UnaryFunc.SIGN:
            return Column("f", ColumnType.INT64, inner.nullable)
        if f in UnaryFunc.DATE_TRUNCS.values():
            return Column("f", inner.ctype, inner.nullable)
        return inner  # NEG, ABS preserve type


@dataclass(frozen=True)
class CallBinary(ScalarExpr):
    func: str
    left: ScalarExpr
    right: ScalarExpr

    def typ(self, schema):
        lt_, rt = self.left.typ(schema), self.right.typ(schema)
        nullable = lt_.nullable or rt.nullable
        if self.func in (
            BinaryFunc.EQ,
            BinaryFunc.NEQ,
            BinaryFunc.LT,
            BinaryFunc.LTE,
            BinaryFunc.GT,
            BinaryFunc.GTE,
        ):
            return Column("f", ColumnType.BOOL, nullable)
        if self.func in (BinaryFunc.POWER, BinaryFunc.LOG_BASE):
            return Column("f", ColumnType.FLOAT64, True)
        if self.func == BinaryFunc.ROUND_TO:
            return Column("f", lt_.ctype, nullable, lt_.scale)
        if self.func == BinaryFunc.CAST_DECIMAL:
            assert isinstance(self.right, Literal)
            return Column(
                "f", ColumnType.DECIMAL, lt_.nullable, int(self.right.value)
            )
        if self.func == BinaryFunc.DIV:
            # SQL: division may produce NULL (div by zero -> error in MZ;
            # we produce NULL for now). int/int is INTEGER division
            # truncating toward zero (pg int4div/int8div); decimals keep
            # the left scale; anything float goes float.
            if lt_.ctype is ColumnType.DECIMAL:
                return Column("f", ColumnType.DECIMAL, True, lt_.scale)
            if lt_.ctype in (
                ColumnType.INT32, ColumnType.INT64
            ) and rt.ctype in (ColumnType.INT32, ColumnType.INT64):
                return Column("f", ColumnType.INT64, True)
            return Column("f", ColumnType.FLOAT64, True)
        # arithmetic: unify types
        ctype, scale = _unify_arith(lt_, rt, self.func)
        return Column("f", ctype, nullable, scale)


@dataclass(frozen=True)
class CallVariadic(ScalarExpr):
    func: str
    exprs: tuple

    def __init__(self, func, exprs):
        object.__setattr__(self, "func", func)
        object.__setattr__(self, "exprs", tuple(exprs))

    def typ(self, schema):
        if self.func.startswith(STRING_FUNC_PREFIX):
            from . import strings

            kind = strings.RESULT_KINDS[
                self.func[len(STRING_FUNC_PREFIX):]
            ]
            inner = self.exprs[0].typ(schema)
            if inner.ctype is not ColumnType.STRING:
                # gathering a non-code column through a dictionary
                # table would silently produce unrelated strings
                raise TypeError(
                    f"{self.func} requires a text operand, got "
                    f"{inner.ctype.value}"
                )
            ctype = {
                "str": ColumnType.STRING,
                "int": ColumnType.INT64,
                "bool": ColumnType.BOOL,
            }[kind]
            return Column("f", ctype, inner.nullable)
        if self.func in (VariadicFunc.AND, VariadicFunc.OR):
            nullable = any(e.typ(schema).nullable for e in self.exprs)
            return Column("f", ColumnType.BOOL, nullable)
        if self.func == VariadicFunc.COALESCE:
            first = self.exprs[0].typ(schema)
            nullable = all(e.typ(schema).nullable for e in self.exprs)
            return Column("f", first.ctype, nullable, first.scale)
        if self.func == VariadicFunc.ADD_INTERVAL:
            x = self.exprs[0].typ(schema)
            ms = self.exprs[3]
            has_ms = not (isinstance(ms, Literal) and ms.value == 0)
            if x.ctype is ColumnType.DATE and not has_ms:
                return Column("f", ColumnType.DATE, x.nullable)
            return Column("f", ColumnType.TIMESTAMP, x.nullable)
        if self.func in (VariadicFunc.GREATEST, VariadicFunc.LEAST):
            # unified numeric type; NULL inputs are skipped (pg semantics)
            typs = [e.typ(schema) for e in self.exprs]
            out = typs[0]
            for t in typs[1:]:
                ctype, scale = _unify_arith(out, t, BinaryFunc.ADD)
                out = Column("f", ctype, False, scale)
            nullable = all(t.nullable for t in typs)
            return Column("f", out.ctype, nullable, out.scale)
        raise NotImplementedError(self.func)


@dataclass(frozen=True)
class If(ScalarExpr):
    cond: ScalarExpr
    then: ScalarExpr
    els: ScalarExpr

    def _principal(self) -> str:
        """Which branch determines the result type: an untyped NULL
        literal defers to the other branch (CASE WHEN c THEN NULL
        ELSE 1.5 END is float, not int)."""
        if (
            isinstance(self.then, Literal)
            and self.then.value is None
            and not (
                isinstance(self.els, Literal) and self.els.value is None
            )
        ):
            return "els"
        return "then"

    def typ(self, schema):
        t = self.then.typ(schema)
        e = self.els.typ(schema)
        p = t if self._principal() == "then" else e
        return Column("f", p.ctype, t.nullable or e.nullable, p.scale)


def _unify_arith(lt_: Column, rt: Column, func: str) -> tuple[ColumnType, int]:
    a, b = lt_.ctype, rt.ctype
    if ColumnType.FLOAT64 in (a, b):
        return ColumnType.FLOAT64, 0
    if a is ColumnType.DECIMAL or b is ColumnType.DECIMAL:
        if func == BinaryFunc.MUL:
            return ColumnType.DECIMAL, lt_.scale + rt.scale
        scale = max(lt_.scale, rt.scale)
        return ColumnType.DECIMAL, scale
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


def _to_decimal_scale(e: Evaled, scale: int) -> torch.Tensor:
    """Rescale a decimal (or int) value array to the given decimal scale."""
    shift = scale - e.col.scale if e.col.ctype is ColumnType.DECIMAL else scale
    v = e.values.to(torch.int64)
    if shift > 0:
        return v * (10**shift)
    if shift < 0:
        return _floordiv(v, 10 ** (-shift))
    return v


def _sub_masks(masks):
    """A fresh sink for a guarded subexpression's error masks, or None
    when the caller collects none."""
    return None if masks is None else []


def _emit_guarded(masks, sub, guard: torch.Tensor) -> None:
    """Re-publish a guarded subexpression's masks, each only for the rows
    that reach it (``guard``)."""
    for code, m in sub or ():
        _err.emit(masks, code, m & guard)


def eval_expr(expr: ScalarExpr, batch: Batch, time=None, masks=None) -> Evaled:
    """Evaluate ``expr`` over every row (padding included) of ``batch``.
    Per-row error masks (division by zero, out-of-range casts) go to
    ``masks`` (see ``expr/errors.py``); ``time`` is the step's
    timestamp, the value of ``mz_now()`` (None outside a timed step,
    where ``mz_now()`` raises)."""
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
        return _eval_unary(expr, eval_expr(expr.expr, batch, time, masks),
                           expr.typ(schema), masks)

    if isinstance(expr, CallBinary):
        return _eval_binary(expr, batch, time, masks)

    if isinstance(expr, CallVariadic):
        return _eval_variadic(expr, batch, time, masks)

    if isinstance(expr, If):
        c = eval_expr(expr.cond, batch, time, masks)
        # CASE/If is SQL's error guard: both branches evaluate over every
        # row, but a branch's errors count only for the rows that select
        # it.
        cond = c.values & ~c.null_mask()
        t_masks, e_masks = _sub_masks(masks), _sub_masks(masks)
        t = eval_expr(expr.then, batch, time, t_masks)
        e = eval_expr(expr.els, batch, time, e_masks)
        _emit_guarded(masks, t_masks, cond)
        _emit_guarded(masks, e_masks, ~cond)
        col = expr.typ(schema)
        tv, ev = t.values, e.values
        # Branches of different dtypes (an untyped NULL literal): the
        # principal branch (If.typ) gives the type; the NULL branch's
        # zeros are cast to it (masked anyway).
        if ev.dtype != tv.dtype:
            if expr._principal() == "then":
                ev = ev.to(tv.dtype)
            else:
                tv = tv.to(ev.dtype)
        return Evaled(torch.where(cond, tv, ev),
                      torch.where(cond, t.null_mask(), e.null_mask()), col)

    raise NotImplementedError(f"scalar expression {type(expr).__name__} is not ported")


def _out_of_range(masks, e: Evaled, bad: torch.Tensor) -> None:
    _err.emit(masks, _err.NUMERIC_OUT_OF_RANGE, bad & ~e.null_mask())


def _eval_unary(expr: CallUnary, e: Evaled, col: Column, masks) -> Evaled:
    f = expr.func
    if f == UnaryFunc.NOT:
        # NOT keeps its operand's NULLs (three-valued logic).
        return Evaled(torch.logical_not(e.values), e.nulls, col)
    if f == UnaryFunc.NEG:
        return Evaled(-e.values, e.nulls, col)
    if f == UnaryFunc.ABS:
        return Evaled(torch.abs(e.values), e.nulls, col)
    if f == UnaryFunc.IS_NULL:
        # IS NULL is never NULL.
        return Evaled(e.null_mask(), None, col)
    if f == UnaryFunc.CAST_INT64:
        if e.col.ctype is ColumnType.DECIMAL:
            return Evaled(_floordiv(e.values, 10**e.col.scale), e.nulls, col)
        if e.col.ctype is ColumnType.FLOAT64:
            x = e.values
            # asymmetric bounds: -2^63 is exactly representable
            bad = torch.isnan(x) | (x >= float(2**63)) | (x < -float(2**63))
            _out_of_range(masks, e, bad)
            v = torch.where(bad, 0.0, x).to(torch.int64)
            return Evaled(v, _or_nulls(e.nulls, bad), col)
        return Evaled(e.values.to(torch.int64), e.nulls, col)
    if f == UnaryFunc.CAST_FLOAT64:
        return Evaled(_as_float(e), e.nulls, col)
    if f == UnaryFunc.CAST_INT32:
        if e.col.ctype is ColumnType.DECIMAL:
            return Evaled(_floordiv(e.values, 10**e.col.scale).to(torch.int32), e.nulls,
                          col)
        x = e.values
        if e.col.ctype is ColumnType.FLOAT64:
            bad = torch.isnan(x) | (x >= float(2**31)) | (x < -float(2**31))
            x = torch.where(bad, 0.0, x)
        else:
            xi = x.to(torch.int64)
            bad = (xi >= 2**31) | (xi < -(2**31))
        _out_of_range(masks, e, bad)
        v = torch.where(bad, 0, x.to(torch.int32))
        return Evaled(v, _or_nulls(e.nulls, bad), col)
    if f == UnaryFunc.CAST_BOOL:
        return Evaled(e.values != 0, e.nulls, col)
    if f == UnaryFunc.CAST_DATE:
        if e.col.ctype is ColumnType.TIMESTAMP:
            v = _floordiv(e.values.to(torch.int64), _MS_PER_DAY).to(torch.int32)
        else:
            v = e.values.to(torch.int32)
        return Evaled(v, e.nulls, col)
    if f == UnaryFunc.CAST_TIMESTAMP:
        v = e.values.to(torch.int64)
        if e.col.ctype is ColumnType.DATE:
            v = v * _MS_PER_DAY
        return Evaled(v, e.nulls, col)
    if f in _EXTRACT_INT_FUNCS or f in (UnaryFunc.EXTRACT_EPOCH,
                                        UnaryFunc.EXTRACT_SECOND):
        return _eval_extract(f, e, col)
    if f in UnaryFunc.DATE_TRUNCS.values():
        return _eval_date_trunc(f, e, col)
    if f in (UnaryFunc.FLOOR, UnaryFunc.CEIL, UnaryFunc.TRUNC, UnaryFunc.ROUND):
        return _eval_round_family(f, e, col)
    if f in _FLOAT_UNARY_FUNCS:
        return _eval_float_unary(f, e, col)
    if f == UnaryFunc.SIGN:
        if e.col.ctype is ColumnType.FLOAT64:
            return Evaled(_float_to_int(torch.sign(e.values)), e.nulls, col)
        return Evaled(torch.sign(e.values).to(torch.int64), e.nulls, col)
    raise NotImplementedError(f"unary function {f!r} is not ported")


_INT_RANGES = {torch.int64: (-(2**63), 2**63 - 1), torch.int32: (-(2**31), 2**31 - 1)}


def _float_to_int(x: torch.Tensor, dtype=torch.int64) -> torch.Tensor:
    """A float to an integer dtype as XLA converts: truncating, NaN to 0,
    and out of range saturated to the dtype's ends (a bare ``.to`` is
    undefined there, and differs between the CPU and the card)."""
    lo, hi = _INT_RANGES[dtype]
    low, high = x < float(lo), x >= float(hi) + 1.0
    v = torch.where(torch.isnan(x) | low | high, 0.0, x).to(dtype)
    return torch.where(high, hi, torch.where(low, lo, v))


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    """Real cube root (torch has none): |x|^(1/3) with x's sign, then one
    Newton step, which takes it to within an ulp or two of a correctly
    rounded cube root."""
    y = torch.sign(x) * torch.pow(torch.abs(x), 1.0 / 3.0)
    safe = torch.where(y == 0.0, 1.0, y)
    y2 = y - (y * y * y - x) / (3.0 * safe * safe)
    return torch.where(torch.isfinite(y) & (y != 0.0), y2, x)


def _eval_float_unary(f: str, e: Evaled, col: Column) -> Evaled:
    """The float math family. A domain error (sqrt of a negative, a log
    of a non-positive, asin/acos beyond 1) gives NULL, as in the
    reference (no err row)."""
    x = _as_float(e)
    if f == UnaryFunc.SQRT:
        bad = x < 0.0
        return Evaled(torch.sqrt(torch.where(bad, 0.0, x)), _or_nulls(e.nulls, bad), col)
    if f in (UnaryFunc.LN, UnaryFunc.LOG10, UnaryFunc.LOG2):
        bad = x <= 0.0
        safe = torch.where(bad, 1.0, x)
        if f == UnaryFunc.LN:
            v = torch.log(safe)
        elif f == UnaryFunc.LOG10:
            v = torch.log(safe) / math.log(10.0)
        else:
            v = torch.log2(safe)
        return Evaled(v, _or_nulls(e.nulls, bad), col)
    if f in (UnaryFunc.ASIN, UnaryFunc.ACOS):
        bad = torch.abs(x) > 1.0
        safe = torch.where(bad, 0.0, x)
        op = torch.asin if f == UnaryFunc.ASIN else torch.acos
        return Evaled(op(safe), _or_nulls(e.nulls, bad), col)
    op = {
        UnaryFunc.CBRT: _cbrt,
        UnaryFunc.EXP: torch.exp,
        UnaryFunc.SIN: torch.sin,
        UnaryFunc.COS: torch.cos,
        UnaryFunc.TAN: torch.tan,
        UnaryFunc.ATAN: torch.atan,
        UnaryFunc.RADIANS: torch.deg2rad,
        UnaryFunc.DEGREES: torch.rad2deg,
    }[f]
    return Evaled(op(x), e.nulls, col)


def _div_zero_mask(zero, l: Evaled, r: Evaled) -> torch.Tensor:
    """Rows whose division errs: a zero divisor where neither operand is
    NULL (pg: a NULL operand yields NULL, no error)."""
    return zero & ~(r.null_mask() | l.null_mask())


def _trunc_quotient(li: torch.Tensor, ri: torch.Tensor) -> torch.Tensor:
    """Integer quotient truncating toward zero (pg int8div)."""
    q = _floordiv(torch.abs(li), torch.abs(ri))
    return torch.where(torch.sign(li) == torch.sign(ri), q, -q)


_COMPARISONS = {
    BinaryFunc.EQ: torch.eq,
    BinaryFunc.NEQ: torch.ne,
    BinaryFunc.LT: torch.lt,
    BinaryFunc.LTE: torch.le,
    BinaryFunc.GT: torch.gt,
    BinaryFunc.GTE: torch.ge,
}


def _eval_binary(expr: CallBinary, batch: Batch, time, masks) -> Evaled:
    l = eval_expr(expr.left, batch, time, masks)
    r = eval_expr(expr.right, batch, time, masks)
    col = expr.typ(batch.schema)
    nulls = _merge_nulls(l, r)
    f = expr.func
    if f in _COMPARISONS:
        # Strings compare directly: dictionary codes are order-preserving
        # labels, so integer order is lexicographic order.
        lv, rv = _coerce_comparable(l, r)
        return Evaled(_COMPARISONS[f](lv, rv), nulls, col)
    if col.ctype is ColumnType.DECIMAL and f in (BinaryFunc.ADD, BinaryFunc.SUB,
                                                 BinaryFunc.MUL, BinaryFunc.DIV):
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
        # Both operands are at col.scale after rescaling, so the
        # scale-preserving quotient multiplies by 10^col.scale.
        zero = rv == 0
        _err.emit(masks, _err.DIVISION_BY_ZERO, _div_zero_mask(zero, l, r))
        safe = torch.where(zero, 1, rv)
        return Evaled(_floordiv(lv * (10**col.scale), safe), _or_nulls(nulls, zero),
                      col)
    if f == BinaryFunc.ADD:
        return Evaled(l.values + r.values, nulls, col)
    if f == BinaryFunc.SUB:
        return Evaled(l.values - r.values, nulls, col)
    if f == BinaryFunc.MUL:
        return Evaled(l.values * r.values, nulls, col)
    if f == BinaryFunc.DIV:
        if col.ctype is ColumnType.INT64:
            li = l.values.to(torch.int64)
            ri = r.values.to(torch.int64)
            zero = ri == 0
            _err.emit(masks, _err.DIVISION_BY_ZERO, _div_zero_mask(zero, l, r))
            v = _trunc_quotient(li, torch.where(zero, 1, ri))
            return Evaled(v, _or_nulls(nulls, zero), col)
        lv, rv = _as_float(l), _as_float(r)
        zero = rv == 0.0
        _err.emit(masks, _err.DIVISION_BY_ZERO, _div_zero_mask(zero, l, r))
        return Evaled(lv / torch.where(zero, 1.0, rv), _or_nulls(nulls, zero), col)
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
    if f == BinaryFunc.POWER:
        # A NaN or infinite power gives NULL (no err row).
        v = torch.pow(_as_float(l), _as_float(r))
        bad = torch.isnan(v) | torch.isinf(v)
        return Evaled(torch.where(bad, 0.0, v), _or_nulls(nulls, bad), col)
    if f == BinaryFunc.LOG_BASE:
        # A base <= 0 or of 1, or an argument <= 0, gives NULL.
        b, x = _as_float(l), _as_float(r)
        bad = (b <= 0.0) | (b == 1.0) | (x <= 0.0)
        v = torch.log(torch.where(bad, 2.0, x)) / torch.log(torch.where(bad, 2.0, b))
        return Evaled(v, _or_nulls(nulls, bad), col)
    if f == BinaryFunc.CAST_DECIMAL:
        scale = col.scale
        if l.col.ctype is ColumnType.FLOAT64:
            v = _float_to_int(torch.round(l.values * (10.0**scale)))
        elif l.col.ctype is ColumnType.DECIMAL and l.col.scale > scale:
            # narrowing rescale rounds half away from zero (pg numeric)
            v = _round_half_away(l.values, 10 ** (l.col.scale - scale), rescale=True)
        else:
            v = _to_decimal_scale(l, scale)
        return Evaled(v, l.nulls, col)
    if f == BinaryFunc.ROUND_TO:
        if not isinstance(expr.right, Literal):
            raise NotImplementedError("round(x, n): n must be a literal")
        n = int(expr.right.value)
        if l.col.ctype is ColumnType.FLOAT64:
            factor = 10.0**n
            return Evaled(torch.round(l.values * factor) / factor, nulls, col)
        if l.col.ctype is ColumnType.DECIMAL:
            drop = l.col.scale - n
            if drop <= 0:
                return Evaled(l.values, nulls, col)
            return Evaled(_round_half_away(l.values, 10**drop), nulls, col)
        if n < 0:  # integers: round(123, -1) = 120 (pg numeric)
            v = _round_half_away(l.values.to(torch.int64), 10 ** (-n))
            return Evaled(v.to(l.values.dtype), nulls, col)
        return Evaled(l.values, nulls, col)
    raise NotImplementedError(f"binary function {f!r} is not ported")


def _eval_variadic(expr: CallVariadic, batch: Batch, time, masks) -> Evaled:
    col = expr.typ(batch.schema)
    cap = batch.capacity
    dev = batch.device
    if expr.func.startswith(STRING_FUNC_PREFIX):
        from . import strings

        fn = expr.func[len(STRING_FUNC_PREFIX):]
        key = _string_func_key(fn, expr.exprs[1:])
        e = eval_expr(expr.exprs[0], batch, time, masks)
        return Evaled(strings.lookup(strings.table(key, dev), e.values), e.nulls, col)
    if expr.func == VariadicFunc.COALESCE:
        # pg evaluates COALESCE's arguments in order up to the first
        # non-NULL: an argument's errors count only for the rows that
        # reach it (every earlier argument NULL).
        evaled, masksets = [], []
        for x in expr.exprs:
            sub = _sub_masks(masks)
            evaled.append(eval_expr(x, batch, time, sub))
            masksets.append(sub)
        reached = torch.ones(cap, dtype=torch.bool, device=dev)
        for p, sub in zip(evaled, masksets):
            _emit_guarded(masks, sub, reached)
            reached = reached & p.null_mask()
        out_v = evaled[-1].values
        out_n = evaled[-1].null_mask()
        for p in reversed(evaled[:-1]):
            take = ~p.null_mask()
            out_v = torch.where(take, p.values, out_v)
            out_n = out_n & ~take
        return Evaled(out_v, out_n, col)
    parts = [eval_expr(e, batch, time, masks) for e in expr.exprs]
    if expr.func == VariadicFunc.AND:
        # SQL three-valued logic: FALSE dominates NULL.
        val = torch.ones(cap, dtype=torch.bool, device=dev)
        known_false = torch.zeros(cap, dtype=torch.bool, device=dev)
        any_null = torch.zeros(cap, dtype=torch.bool, device=dev)
        for p in parts:
            pn = p.null_mask()
            val = val & p.values
            known_false = known_false | (~p.values & ~pn)
            any_null = any_null | pn
        return Evaled(val & ~known_false, any_null & ~known_false, col)
    if expr.func == VariadicFunc.OR:
        # SQL three-valued logic: TRUE dominates NULL.
        val = torch.zeros(cap, dtype=torch.bool, device=dev)
        known_true = torch.zeros(cap, dtype=torch.bool, device=dev)
        any_null = torch.zeros(cap, dtype=torch.bool, device=dev)
        for p in parts:
            pn = p.null_mask()
            val = val | p.values
            known_true = known_true | (p.values & ~pn)
            any_null = any_null | pn
        return Evaled(val, any_null & ~known_true, col)
    if expr.func == VariadicFunc.ADD_INTERVAL:
        e = parts[0]
        months, days, ms = (int(x.value) for x in expr.exprs[1:])  # plan-time literals
        dd, msod = _days_and_ms(e)
        if months:
            y, m, d = _civil_from_days(dd)
            m0 = m - 1 + months
            y2 = y + _floordiv(m0, 12)
            m2 = torch.remainder(m0, 12) + 1
            # clamp to the target month's last day (pg semantics)
            next_month_start = _days_from_civil(
                y2 + (m2 == 12).to(torch.int64), torch.where(m2 == 12, 1, m2 + 1), 1)
            month_len = next_month_start - _days_from_civil(y2, m2, 1)
            dd = _days_from_civil(y2, m2, torch.minimum(d, month_len))
        dd = dd + days
        if col.ctype is ColumnType.DATE:
            return Evaled(dd.to(torch_dtype(col.dtype)), e.nulls, col)
        return Evaled(dd * _MS_PER_DAY + msod + ms, e.nulls, col)
    if expr.func in (VariadicFunc.GREATEST, VariadicFunc.LEAST):
        # pg: NULL arguments are skipped; the result is NULL only when
        # every argument is.
        if col.ctype is ColumnType.FLOAT64:
            coerced = [_as_float(p) for p in parts]
        elif col.ctype is ColumnType.DECIMAL:
            coerced = [_to_decimal_scale(p, col.scale) for p in parts]
        else:
            coerced = [p.values.to(torch_dtype(col.dtype)) for p in parts]
        better = torch.gt if expr.func == VariadicFunc.GREATEST else torch.lt
        acc_v = coerced[0]
        acc_n = parts[0].null_mask()
        for p, v in zip(parts[1:], coerced[1:]):
            pn = p.null_mask()
            take = ~pn & (acc_n | better(v, acc_v))
            acc_v = torch.where(take, v, acc_v)
            acc_n = acc_n & pn
        return Evaled(acc_v, acc_n, col)
    raise NotImplementedError(f"variadic function {expr.func!r} is not ported")


def _merge_nulls(l: Evaled, r: Evaled):
    if l.nulls is None and r.nulls is None:
        return None
    return l.null_mask() | r.null_mask()


def _or_nulls(nulls, extra):
    return extra if nulls is None else nulls | extra


def _round_half_away(v: torch.Tensor, step: int, rescale: bool = False) -> torch.Tensor:
    """Round a scaled integer to a multiple of ``step``, half away from
    zero (pg numeric). ``rescale`` divides the result by step (narrowing
    a decimal's scale) instead of keeping the original scale."""
    mag = _floordiv(torch.abs(v) + step // 2, step)
    if not rescale:
        mag = mag * step
    return torch.sign(v) * mag


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


def _days_from_civil(y: torch.Tensor, m, d) -> torch.Tensor:
    """Inverse of _civil_from_days, vectorized (proleptic Gregorian);
    ``m`` and ``d`` are tensors like ``y`` or Python ints."""
    if not isinstance(m, torch.Tensor):
        m = torch.full_like(y, m)
    y = y - (m <= 2).to(y.dtype)
    era = _floordiv(torch.where(y >= 0, y, y - 399), 400)
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = _floordiv(153 * mp + 2, 5) + d - 1
    doe = yoe * 365 + _floordiv(yoe, 4) - _floordiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


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

_FLOAT_UNARY_FUNCS = frozenset(
    {
        UnaryFunc.SQRT,
        UnaryFunc.CBRT,
        UnaryFunc.EXP,
        UnaryFunc.LN,
        UnaryFunc.LOG10,
        UnaryFunc.LOG2,
        UnaryFunc.SIN,
        UnaryFunc.COS,
        UnaryFunc.TAN,
        UnaryFunc.ASIN,
        UnaryFunc.ACOS,
        UnaryFunc.ATAN,
        UnaryFunc.RADIANS,
        UnaryFunc.DEGREES,
    }
)

_MS_PER_DAY = 86_400_000


def _days_and_ms(e: Evaled):
    """(days since the epoch, ms of the day) of a DATE or TIMESTAMP."""
    if e.col.ctype is ColumnType.TIMESTAMP:
        ms = e.values.to(torch.int64)
        return _floordiv(ms, _MS_PER_DAY), torch.remainder(ms, _MS_PER_DAY)
    days = e.values.to(torch.int64)
    return days, torch.zeros_like(days)


def _eval_extract(f: str, e: Evaled, col: Column) -> Evaled:
    days, msod = _days_and_ms(e)
    if f == UnaryFunc.EXTRACT_EPOCH:
        if e.col.ctype is ColumnType.TIMESTAMP:
            return Evaled(e.values.to(torch.float64) / 1000.0, e.nulls, col)
        return Evaled(days.to(torch.float64) * 86400.0, e.nulls, col)
    if f == UnaryFunc.EXTRACT_HOUR:
        return Evaled(_floordiv(msod, 3_600_000), e.nulls, col)
    if f == UnaryFunc.EXTRACT_MINUTE:
        return Evaled(torch.remainder(_floordiv(msod, 60_000), 60), e.nulls, col)
    if f == UnaryFunc.EXTRACT_SECOND:
        return Evaled(torch.remainder(msod, 60_000).to(torch.float64) / 1000.0,
                      e.nulls, col)
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
        return Evaled(days - _days_from_civil(y, 1, 1) + 1, e.nulls, col)
    if f == UnaryFunc.EXTRACT_WEEK:
        # ISO 8601 week: the week holding this date's Thursday
        thursday = days + (3 - torch.remainder(days + 3, 7))
        ty, _, _ = _civil_from_days(thursday)
        week = _floordiv(thursday - _days_from_civil(ty, 1, 1), 7) + 1
        return Evaled(week, e.nulls, col)
    if f == UnaryFunc.EXTRACT_MILLENNIUM:
        return Evaled(_floordiv(y - 1, 1000) + 1, e.nulls, col)
    if f == UnaryFunc.EXTRACT_CENTURY:
        return Evaled(_floordiv(y - 1, 100) + 1, e.nulls, col)
    if f == UnaryFunc.EXTRACT_DECADE:
        return Evaled(_floordiv(y, 10), e.nulls, col)
    raise NotImplementedError(f"unary function {f!r} is not ported")


def _eval_date_trunc(f: str, e: Evaled, col: Column) -> Evaled:
    days, msod = _days_and_ms(e)
    T = UnaryFunc
    if f in (T.DATE_TRUNC_YEAR, T.DATE_TRUNC_QUARTER, T.DATE_TRUNC_MONTH):
        y, m, _ = _civil_from_days(days)
        if f == T.DATE_TRUNC_YEAR:
            tdays = _days_from_civil(y, 1, 1)
        elif f == T.DATE_TRUNC_QUARTER:
            tdays = _days_from_civil(y, 3 * _floordiv(m - 1, 3) + 1, 1)
        else:
            tdays = _days_from_civil(y, m, 1)
        tmsod = torch.zeros_like(msod)
    elif f == T.DATE_TRUNC_WEEK:
        tdays = days - torch.remainder(days + 3, 7)  # back to Monday
        tmsod = torch.zeros_like(msod)
    elif f == T.DATE_TRUNC_DAY:
        tdays, tmsod = days, torch.zeros_like(msod)
    else:
        step = {
            T.DATE_TRUNC_HOUR: 3_600_000,
            T.DATE_TRUNC_MINUTE: 60_000,
            T.DATE_TRUNC_SECOND: 1_000,
        }[f]
        tdays, tmsod = days, msod - torch.remainder(msod, step)
    if e.col.ctype is ColumnType.TIMESTAMP:
        return Evaled(tdays * _MS_PER_DAY + tmsod, e.nulls, col)
    return Evaled(tdays.to(e.values.dtype), e.nulls, col)


def _eval_round_family(f: str, e: Evaled, col: Column) -> Evaled:
    T = UnaryFunc
    if e.col.ctype is ColumnType.FLOAT64:
        op = {
            T.FLOOR: torch.floor,
            T.CEIL: torch.ceil,
            T.TRUNC: torch.trunc,
            T.ROUND: torch.round,  # half-even, like pg float8
        }[f]
        return Evaled(op(e.values), e.nulls, col)
    if e.col.ctype is ColumnType.DECIMAL and e.col.scale > 0:
        step = 10**e.col.scale
        v = e.values
        if f == T.FLOOR:
            out = _floordiv(v, step) * step
        elif f == T.CEIL:
            out = -_floordiv(-v, step) * step
        elif f == T.TRUNC:
            out = torch.where(v >= 0, _floordiv(v, step), -_floordiv(-v, step)) * step
        else:  # ROUND: half away from zero, like pg numeric
            out = _round_half_away(v, step)
        return Evaled(out, e.nulls, col)
    return Evaled(e.values, e.nulls, col)  # integers unchanged


# Convenience helpers for building expressions in tests/plans.
def col(i: int) -> ColumnRef:
    return ColumnRef(i)


def lit(value, ctype: ColumnType | None = None, scale: int = 0) -> Literal:
    if ctype is None:
        return _lift(value)
    return Literal(value, ctype, scale)


def and_(*exprs) -> CallVariadic:
    return CallVariadic(VariadicFunc.AND, [_lift(e) for e in exprs])


def or_(*exprs) -> CallVariadic:
    return CallVariadic(VariadicFunc.OR, [_lift(e) for e in exprs])
