"""Port parity for scalar evaluation and MapFilterProject: the port's
``expr/scalar.py:eval_expr`` and ``expr/linear.py:apply_mfp`` against the
reference's, on the same seeded numpy columns (DECIMAL at scales 2 and
4, DATE, INT64 and INT32, with NULLs and zero divisors), including the
unary NOT and IS NULL over columns with NULLs (Q15's ``NOT IS NULL``
filters), and every integer EXTRACT (Q9's ``EXTRACT(YEAR FROM
o_orderdate)`` among them) over seeded DATE and TIMESTAMP columns with
NULLs, dates before 1970, leap days and ISO week 53. Every value is
an integer, so everything is compared exactly (tolerance 0), padding
rows included: both evaluate every row.

The rest of scalar evaluation (the functions no TPC-H path of the port
reaches) on seeded columns of every type with NULLs, NaN, infinities,
signed zeros, half-way rows and the int32/int64 cast edges: NEG, ABS,
the FLOOR..DEGREES math family, SIGN, the casts (with their
out-of-range error masks), the DATE_TRUNC family, ROUND_TO,
CAST_DECIMAL, AND/OR (three-valued, with NULL literals), COALESCE (an
erroring argument counts only for the rows that reach it), GREATEST,
LEAST, ADD_INTERVAL, ``If`` (an erroring branch counts only for the
rows that select it) and the string functions (dictionary side tables;
strings compared decoded, each package coding in its own dictionary).
Valid values are exact, floats within 2 ulp (CBRT within rel 2e-14,
subnormals within the least normal: see ``FLOAT_RTOL``); NULL masks,
types and error masks exact."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from materialize_tpu.expr import errors as jerrors
from materialize_tpu.expr import linear as jlinear
from materialize_tpu.expr import scalar as js
from materialize_tpu.repr import schema as jschema
from materialize_tpu.repr.batch import Batch as JBatch
from materialize_tpu_torch.expr import linear as tlinear
from materialize_tpu_torch.expr import scalar as ts
from materialize_tpu_torch.repr import schema as tschema
from materialize_tpu_torch.repr.batch import Batch as TBatch

from tests.torch_dict import reference_dict_restored  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's eager ops here are small: one intra-op thread runs them
    about as fast, and does not contend with other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

N, CAP = 300, 512
# (name, type, nullable, scale)
COLUMNS = [
    ("price", "DECIMAL", True, 2),
    ("disc", "DECIMAL", True, 2),
    ("rate", "DECIMAL", False, 4),
    ("ship", "DATE", True, 0),
    ("i64", "INT64", True, 0),
    ("i32", "INT32", False, 0),
]
CUTOFF = 10471


def _schema(mod):
    return mod.Schema([
        mod.Column(n, mod.ColumnType[t], nl, sc) for n, t, nl, sc in COLUMNS
    ])


def _data(seed=7):
    rng = np.random.default_rng(seed)
    cols = [
        rng.integers(-10**7, 10**7, N),
        rng.integers(-3, 4, N) * 50,             # zero divisors among them
        rng.integers(-10**6, 10**6, N),
        rng.integers(CUTOFF - 60, CUTOFF + 60, N).astype(np.int32),
        rng.integers(-1000, 1000, N),
        rng.integers(-5, 6, N).astype(np.int32),  # zero divisors
    ]
    nulls = [rng.random(N) < 0.15 if nl else None for _, _, nl, _ in COLUMNS]
    diff = rng.choice(np.array([-2, -1, 1, 3]), N)
    time = rng.integers(0, 5, N).astype(np.uint64)
    return cols, nulls, time, diff


@pytest.fixture(scope="module")
def batches():
    cols, nulls, time, diff = _data()
    j = JBatch.from_numpy(_schema(jschema), cols, time, diff, capacity=CAP, nulls=nulls)
    t = TBatch.from_numpy(_schema(tschema), cols, time, diff, capacity=CAP, nulls=nulls,
                          device="cpu")
    return j, t


def _exprs(m):
    """Q1's expressions, comparisons across scales and types, the
    dividing functions, and NOT / IS NULL."""
    c, lit, T = m.col, m.lit, m.ColumnType
    one = lit(100, T.DECIMAL, 2)
    disc_price = c(0) * (one - c(1))

    def call(f, a, b):
        return m.CallBinary(f, a, b)

    F = m.BinaryFunc
    return {
        "q1_disc_price": disc_price,
        "q1_charge": disc_price * (one + c(1)),
        "q1_cutoff": c(3).lte(lit(CUTOFF, T.DATE)),
        "date_vs_int64": c(3).gt(lit(CUTOFF)),
        "dec_lt_rescaled": c(0).lt(c(2)),
        "dec_eq_int": c(1).eq(c(4)),
        "int_neq": call(F.NEQ, c(4), c(5)),
        "int_gte": c(4).gte(c(5)),
        "dec_add_rescale": c(0) + c(2),
        "dec_sub_rescale": c(2) - c(1),
        "int_mixed_mul": c(4) * c(5),
        "int_sub": c(5) - c(4),
        "dec_div": call(F.DIV, c(0), c(1)),
        "dec_div_int": call(F.DIV, c(2), c(5)),
        "int_div": call(F.DIV, c(4), c(5)),
        "int_mod": call(F.MOD, c(4), c(5)),
        "dec_mod": call(F.MOD, c(0), c(1)),
        "null_literal": c(0) + lit(None, T.DECIMAL, 2),
        "not_nullable_cmp": m.CallUnary(m.UnaryFunc.NOT, c(3).lte(lit(CUTOFF, T.DATE))),
        "is_null_decimal": m.CallUnary(m.UnaryFunc.IS_NULL, c(0)),
        "is_null_non_nullable": m.CallUnary(m.UnaryFunc.IS_NULL, c(5)),
        "q15_not_is_null": m.CallUnary(m.UnaryFunc.NOT,
                                       m.CallUnary(m.UnaryFunc.IS_NULL, c(4))),
        "is_null_of_div": m.CallUnary(m.UnaryFunc.IS_NULL, call(F.DIV, c(4), c(5))),
    }


def _same(jv, tv):
    assert np.array_equal(np.asarray(jv), tv.numpy())


@pytest.mark.parametrize("name", list(_exprs(js)))
def test_eval_expr_matches_reference(batches, name):
    jb, tb = batches
    jex, tex = _exprs(js)[name], _exprs(ts)[name]
    with jerrors.collect() as jmasks:
        jev = js.eval_expr(jex, jb)
    tmasks: list = []
    tev = ts.eval_expr(tex, tb, masks=tmasks)
    _same(jev.values, tev.values)
    assert str(tev.values.dtype).split(".")[-1] == str(np.asarray(jev.values).dtype)
    _same(jev.null_mask(), tev.null_mask())
    assert (jev.col.ctype.value, jev.col.nullable, jev.col.scale) == (
        tev.col.ctype.value, tev.col.nullable, tev.col.scale)
    assert [c for c, _ in jmasks] == [c for c, _ in tmasks]
    for (_, jm), (_, tm) in zip(jmasks, tmasks):
        _same(jm, tm)
    # without a sink, the erroring rows are NULL all the same
    _same(jev.null_mask(), ts.eval_expr(tex, tb).null_mask())


def _mfp(m, lin):
    """Q1's map, then a date filter and a dividing predicate (its errors
    count only for rows the date filter kept), then a projection."""
    c, lit, T = m.col, m.lit, m.ColumnType
    one = lit(100, T.DECIMAL, 2)
    return lin.MapFilterProject(
        6,
        expressions=[c(0) * (one - c(1)), c(6) * (one + c(1)),
                     m.CallBinary(m.BinaryFunc.DIV, c(2), c(5))],
        predicates=[c(3).lte(lit(CUTOFF, T.DATE)),
                    m.CallBinary(m.BinaryFunc.DIV, c(4), c(5)).gte(lit(0))],
        projection=[8, 6, 7, 3, 0],
    )


def _rows(b):
    n = int(b.count)
    cols = [np.asarray(x)[:n] if not isinstance(x, torch.Tensor) else x[:n].numpy()
            for x in (*b.cols, b.time, b.diff)]
    nulls = [None if x is None else (np.asarray(x)[:n] if not isinstance(x, torch.Tensor)
                                     else x[:n].numpy()) for x in b.nulls]
    return n, cols, nulls


def _same_batch(jb, tb):
    jn, jcols, jnulls = _rows(jb)
    tn, tcols, tnulls = _rows(tb)
    assert jn == tn
    for a, b in zip(jcols, tcols):
        assert np.array_equal(a.view(np.int64) if a.dtype == np.uint64 else a, b)
    for a, b in zip(jnulls, tnulls):
        assert (a is None) == (b is None)
        if a is not None:
            assert np.array_equal(a, b)


def test_apply_mfp_filter_and_div_errors_match_reference(batches):
    jb, tb = batches
    with jerrors.step_scope() as jerrs:
        jout = jlinear.apply_mfp(_mfp(js, jlinear), jb)
    terrs: list = []
    tout = tlinear.apply_mfp(_mfp(ts, tlinear), tb, errs=terrs)
    assert 0 < int(tout.count) < N  # the filter dropped and kept rows
    _same_batch(jout, tout)
    assert [c.name for c in jout.schema.columns] == [c.name for c in tout.schema.columns]
    # one err batch per erroring site: the map's DIV, the predicate's DIV
    assert len(jerrs) == len(terrs) == 2
    for je, te in zip(jerrs, terrs):
        _same(je.cols[0], te.cols[0])
        _same(je.diff, te.diff)
        assert int(je.count) == int(te.count)
    # the predicate's errors count only rows the first predicate kept
    ship = tb.cols[3]
    pred_err_rows = terrs[1].diff != 0
    assert bool(pred_err_rows.any())
    assert bool((ship[pred_err_rows] <= CUTOFF).all())
    assert int((terrs[0].diff != 0).sum()) > int(pred_err_rows.sum())
    # without a step sink no err batch is made, the output is the same
    _same_batch(jout, tlinear.apply_mfp(_mfp(ts, tlinear), tb))


def test_apply_mfp_identity_and_projection(batches):
    jb, tb = batches
    ident = tlinear.MapFilterProject(6, projection=range(6))
    assert ident.is_identity and tlinear.apply_mfp(ident, tb) is tb
    jout = jlinear.apply_mfp(jlinear.MapFilterProject(6, projection=(5, 0, 0)), jb)
    tout = tlinear.apply_mfp(tlinear.MapFilterProject(6, projection=(5, 0, 0)), tb)
    _same_batch(jout, tout)
    assert int(tout.count) == N


def test_unported_scalar_pieces_raise(batches):
    """What the port still refuses, as the reference does: a string
    function with a non-literal or NULL argument, ``round(x, n)`` with a
    non-literal ``n``, a function name neither package knows, and an
    object that is no expression."""
    _, tb = batches
    with pytest.raises(NotImplementedError, match="non-literal"):
        ts.eval_expr(ts.string_call("substr", ts.lit(tschema.GLOBAL_DICT.encode("ab"),
                                                      ts.ColumnType.STRING), ts.col(5)), tb)
    with pytest.raises(NotImplementedError, match="n must be a literal"):
        ts.eval_expr(ts.CallBinary(ts.BinaryFunc.ROUND_TO, ts.col(4), ts.col(5)), tb)
    with pytest.raises(NotImplementedError, match="not ported"):
        ts.eval_expr(object(), tb)
    with pytest.raises(NotImplementedError, match="unary function 'no_such'"):
        ts.eval_expr(ts.CallUnary("no_such", ts.col(4)), tb)
    with pytest.raises(NotImplementedError, match="binary function 'no_such'"):
        ts.eval_expr(ts.CallBinary("no_such", ts.col(4), ts.col(5)), tb)
    with pytest.raises(NotImplementedError):
        ts.eval_expr(ts.CallVariadic("no_such", (ts.col(4),)), tb)


# -- the integer EXTRACT family ---------------------------------------------------

EXTRACTS = ("year", "month", "day", "quarter", "dow", "isodow", "doy", "week",
            "hour", "minute", "millennium", "century", "decade")
DAY_MS = 86_400_000
# Days since 1970-01-01: leap days (1972-02-29, 2000-02-29, 1600-02-29,
# -0004-02-29), 1900-03-01 (1900 is not leap), the days around 1970-01-01,
# and the ISO week 53 of 2015, 2020 and 1976 with the days beside them.
EDGE_DAYS = np.array([789, 11016, -135081, -719469, -25508, -1, 0, 1, 16800, 16801,
                      18627, 18628, 18629, 2556, 2557, 2558, -719468, -1000000,
                      1000000, -146097, 146097], dtype=np.int64)


def _date_data(seed=11):
    """(DATE days, TIMESTAMP ms, their NULL masks): seeded values across
    +-2700 years and +-34 years, negatives included, then the edges."""
    rng = np.random.default_rng(seed)
    days = np.concatenate([rng.integers(-1_000_000, 1_000_000, N - 2 * len(EDGE_DAYS)),
                           EDGE_DAYS, EDGE_DAYS])
    ms = np.concatenate([rng.integers(-(1 << 40), 1 << 40, N - 2 * len(EDGE_DAYS)),
                         EDGE_DAYS * DAY_MS, EDGE_DAYS * DAY_MS - 1])
    return (days.astype(np.int32), ms, rng.random(N) < 0.15, rng.random(N) < 0.15)


def _date_schema(mod):
    T = mod.ColumnType
    return mod.Schema([mod.Column("d", T.DATE, True), mod.Column("ts", T.TIMESTAMP, True)])


@pytest.fixture(scope="module")
def date_batches():
    days, ms, dn, tn = _date_data()
    time, diff = np.zeros(N, np.uint64), np.ones(N, np.int64)
    j = JBatch.from_numpy(_date_schema(jschema), [days, ms], time, diff, capacity=CAP,
                          nulls=[dn, tn])
    t = TBatch.from_numpy(_date_schema(tschema), [days, ms], time, diff, capacity=CAP,
                          nulls=[dn, tn], device="cpu")
    return j, t


@pytest.mark.parametrize("column", [0, 1], ids=["date", "timestamp"])
@pytest.mark.parametrize("part", EXTRACTS)
def test_extract_matches_reference(date_batches, part, column):
    jb, tb = date_batches
    func = js.UnaryFunc.EXTRACTS[part]
    jev = js.eval_expr(js.CallUnary(func, js.col(column)), jb)
    tev = ts.eval_expr(ts.CallUnary(func, ts.col(column)), tb)
    _same(jev.values, tev.values)
    assert tev.values.dtype == torch.int64
    _same(jev.null_mask(), tev.null_mask())
    assert (jev.col.ctype.value, jev.col.nullable) == (tev.col.ctype.value, tev.col.nullable)


def test_extract_year_week_against_the_calendar(date_batches):
    """YEAR and ISO WEEK of the DATE column against Python's calendar,
    independent of both packages (year 1 onwards: ``datetime`` starts
    there)."""
    import datetime

    _, tb = date_batches
    days = tb.cols[0][:N].numpy()
    year = ts.eval_expr(ts.CallUnary(ts.UnaryFunc.EXTRACT_YEAR, ts.col(0)), tb).values
    week = ts.eval_expr(ts.CallUnary(ts.UnaryFunc.EXTRACT_WEEK, ts.col(0)), tb).values
    epoch = datetime.date(1970, 1, 1)
    checked = 0
    for i, d in enumerate(days):
        if d < -719162:  # before 0001-01-01
            continue
        day = epoch + datetime.timedelta(days=int(d))
        assert (int(year[i]), int(week[i])) == (day.year, day.isocalendar()[1]), day
        checked += 1
    assert checked > N // 2
    assert 53 in set(week[:N].tolist())


# -- the rest of scalar evaluation: math, casts, date_trunc, rounding, the
# variadic functions, If, and the string functions ---------------------------

# (name, type, nullable, scale)
WIDE = [
    ("f", "FLOAT64", True, 0),
    ("d2", "DECIMAL", True, 2),
    ("i64", "INT64", True, 0),
    ("i32", "INT32", False, 0),
    ("day", "DATE", True, 0),
    ("ts", "TIMESTAMP", True, 0),
    ("b1", "BOOL", True, 0),
    ("b2", "BOOL", True, 0),
    ("s", "STRING", True, 0),
    ("g", "FLOAT64", False, 0),
    ("d4", "DECIMAL", False, 4),
    ("b3", "BOOL", False, 0),
]
STRINGS = ["", "a", "Abc", "  padded  ", "hello world", "HELLO", "x_y%z", "banana",
           "a,b,,c", "zeta", "\u00e9t\u00e9", "mixed Case words"]
# floats: NaN, +-inf, +-0, the int32/int64 cast edges and either side
F_EDGES = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 2.0**31, 2.0**31 - 1, -2.0**31,
                    -2.0**31 - 1, 2.0**63, -2.0**63, 1e19, 0.5, 1.5, 2.5, -0.5, -2.5,
                    1.0, -1.0, 1e-300])
I_EDGES = np.array([2**31, 2**31 - 1, -(2**31), -(2**31) - 1, 0, 5, -5, 15, -15, 25])


def _wide_schema(mod):
    return mod.Schema([mod.Column(n, mod.ColumnType[t], nl, sc) for n, t, nl, sc in WIDE])


def _wide_data(seed=23):
    rng = np.random.default_rng(seed)
    f = np.concatenate([rng.uniform(-4, 4, N // 3), rng.uniform(-1.5, 1.5, N // 3),
                        F_EDGES])
    f = np.concatenate([f, rng.normal(0, 1e3, N - len(f))])
    i64 = np.concatenate([I_EDGES, rng.integers(-10**6, 10**6, N - len(I_EDGES))])
    cols = [
        f,
        rng.integers(-10**5, 10**5, N) * rng.choice([1, 5, 50], N),  # half-way rows
        i64,
        rng.integers(-100, 100, N).astype(np.int32),
        rng.integers(-40000, 40000, N).astype(np.int32),
        rng.integers(-(1 << 41), 1 << 41, N),
        rng.random(N) < 0.5,
        rng.random(N) < 0.5,
        rng.integers(0, len(STRINGS), N),  # indices, coded per package below
        rng.uniform(-3, 3, N),
        rng.integers(-10**7, 10**7, N),
        rng.random(N) < 0.5,
    ]
    nulls = [rng.random(N) < 0.15 if nl else None for _, _, nl, _ in WIDE]
    return cols, nulls


@pytest.fixture(scope="module")
def wide_batches():
    cols, nulls = _wide_data()
    time, diff = np.zeros(N, np.uint64), np.ones(N, np.int64)

    def coded(dictionary):
        return cols[:8] + [dictionary.encode_many(STRINGS)[cols[8]]] + cols[9:]

    j = JBatch.from_numpy(_wide_schema(jschema), coded(jschema.GLOBAL_DICT), time, diff,
                          capacity=CAP, nulls=nulls)
    t = TBatch.from_numpy(_wide_schema(tschema), coded(tschema.GLOBAL_DICT), time, diff,
                          capacity=CAP, nulls=nulls, device="cpu")
    return j, t


def _wide_exprs(m, dictionary):
    """Every function of the reference's scalar vocabulary that Q1-Q21 do
    not reach, over the wide columns (0 f, 1 d2, 2 i64, 3 i32, 4 day,
    5 ts, 6-7 nullable bools, 8 s, 9 g, 10 d4, 11 bool)."""
    c, lit, T, U, B, V = m.col, m.lit, m.ColumnType, m.UnaryFunc, m.BinaryFunc, m.VariadicFunc

    def un(f, i):
        return m.CallUnary(f, c(i))

    def text(v):
        return lit(dictionary.encode(v), T.STRING)

    out = {}
    for f in ("neg", "abs", "floor", "ceil", "round", "trunc"):
        for i in (0, 1, 2, 3, 10):
            out[f"{f}_{WIDE[i][0]}"] = un(f, i)
    for f in ("sqrt", "cbrt", "exp", "ln", "log10", "log2", "sin", "cos", "tan", "asin",
              "acos", "atan", "radians", "degrees"):
        out[f"{f}_f"] = un(f, 0)
        out[f"{f}_g"] = un(f, 9)
    for f in ("sqrt", "ln", "exp"):
        out[f"{f}_d2"] = un(f, 1)
        out[f"{f}_i64"] = un(f, 2)
    out["sign_f"], out["sign_i64"], out["sign_d2"] = un(U.SIGN, 0), un(U.SIGN, 2), un(U.SIGN, 1)
    for f, cols in ((U.CAST_INT64, (0, 1, 3, 4)), (U.CAST_INT32, (0, 1, 2)),
                    (U.CAST_FLOAT64, (1, 2, 3, 10)), (U.CAST_BOOL, (2, 3)),
                    (U.CAST_DATE, (5, 2)), (U.CAST_TIMESTAMP, (4, 2))):
        for i in cols:
            out[f"{f}_{WIDE[i][0]}"] = un(f, i)
    for part, f in U.DATE_TRUNCS.items():
        out[f"trunc_{part}_day"] = un(f, 4)
        out[f"trunc_{part}_ts"] = un(f, 5)
    for i, n in ((0, 2), (0, -1), (1, 1), (1, 3), (10, 2), (2, -1), (2, 2), (3, -2)):
        out[f"round_to_{WIDE[i][0]}_{n}"] = m.CallBinary(B.ROUND_TO, c(i), lit(n))
    for i, sc in ((0, 2), (1, 1), (1, 4), (10, 2), (2, 2), (3, 0)):
        out[f"cast_decimal_{WIDE[i][0]}_{sc}"] = m.CallBinary(B.CAST_DECIMAL, c(i), lit(sc))
    out["and_2"] = m.and_(c(6), c(7))
    out["and_3"] = m.and_(c(6), c(7), c(11))
    out["or_2"] = m.or_(c(6), c(7))
    out["or_3"] = m.or_(c(6), c(11), c(7))
    out["and_or_nested"] = m.or_(m.and_(c(6), c(2).gt(lit(0))), m.and_(c(7), c(11)))
    out["and_null_lit"] = m.and_(c(6), lit(None, T.BOOL))
    out["or_null_lit"] = m.or_(c(7), lit(None, T.BOOL))
    div0 = m.CallBinary(B.DIV, c(3), c(3) - c(3))  # errs on every row
    out["coalesce_i64"] = m.CallVariadic(V.COALESCE, (c(2), lit(7)))
    out["coalesce_3"] = m.CallVariadic(V.COALESCE, (c(1), c(1) + lit(100, T.DECIMAL, 2),
                                                    lit(5, T.DECIMAL, 2)))
    out["coalesce_guards_errors"] = m.CallVariadic(V.COALESCE, (c(2), div0))
    out["coalesce_null_first"] = m.CallVariadic(V.COALESCE, (lit(None, T.INT64), c(2)))
    for f in (V.GREATEST, V.LEAST):
        out[f"{f}_ints"] = m.CallVariadic(f, (c(2), c(3)))
        out[f"{f}_decs"] = m.CallVariadic(f, (c(1), c(10), c(2)))
        out[f"{f}_floats"] = m.CallVariadic(f, (c(0), c(9), c(2)))
        out[f"{f}_all_null"] = m.CallVariadic(f, (c(2), lit(None, T.INT64)))
    for name, (i, mo, d, ms) in {"day_month": (4, 1, 0, 0), "day_neg": (4, -13, 3, 0),
                                  "day_ms": (4, 0, 1, 5000), "ts_month": (5, 14, -2, 0),
                                  "ts_ms": (5, -1, 0, -86_399_999)}.items():
        out[f"add_interval_{name}"] = m.CallVariadic(V.ADD_INTERVAL,
                                                     (c(i), lit(mo), lit(d), lit(ms)))
    out["if_ints"] = m.If(c(6), c(2), c(3))
    out["if_decimal_null_then"] = m.If(c(7), lit(None, T.INT64), c(1))
    out["if_null_else"] = m.If(c(11), c(0), lit(None, T.INT64))
    out["if_guards_errors"] = m.If(c(3).eq(lit(0)), lit(0), m.CallBinary(B.DIV, c(2), c(3)))
    out["if_cast_errors"] = m.If(c(6), m.CallUnary(U.CAST_INT32, c(0)), lit(1, T.INT32))
    s = m.string_call
    out["upper"] = s("upper", c(8))
    out["lower"] = s("lower", c(8))
    out["initcap"] = s("initcap", c(8))
    out["reverse"] = s("reverse", c(8))
    out["trim"] = s("trim", c(8))
    out["ltrim_x"] = s("ltrim", c(8), text("a"))
    out["length"] = s("length", c(8))
    out["octet_length"] = s("octet_length", c(8))
    out["ascii"] = s("ascii", c(8))
    out["substr_2_3"] = s("substr", c(8), lit(2), lit(3))
    out["substr_0"] = s("substr", c(8), lit(0))
    out["left_neg"] = s("left", c(8), lit(-2))
    out["right_3"] = s("right", c(8), lit(3))
    out["replace"] = s("replace", c(8), text("a"), text("AA"))
    out["concat_r"] = s("concat_r", c(8), text("!"))
    out["lpad"] = s("lpad", c(8), lit(6), text("*"))
    out["like"] = s("like", c(8), text("%a%"))
    out["ilike"] = s("ilike", c(8), text("h%"))
    out["regex"] = s("regex", c(8), text("^[a-z]+$"))
    out["position"] = s("position", c(8), text("a"))
    out["split_part"] = s("split_part", c(8), text(","), lit(2))
    out["upper_of_trim"] = s("upper", s("trim", c(8)))
    out["string_eq_after_upper"] = s("upper", c(8)).eq(text("HELLO"))
    return out


WIDE_NAMES = list(_wide_exprs(ts, tschema.GLOBAL_DICT))
# Float results: XLA's and torch's math libraries differ in the last bit,
# so floats are held within 2 ulp (rel 2^-51); CBRT within rel 2e-14:
# XLA's cube root is up to 1.28e-14 from numpy's (seeded probe of 2*10^5
# values), the port's (torch has none: a power refined by one Newton
# step) within 2.3e-16 of numpy's. Everything else is exact.
FLOAT_RTOL = 2.0**-51
CBRT_RTOL = 2e-14
# The reference's XLA code flushes subnormal results to zero, the port
# keeps them (ROADMAP Queue 3): floats agree within the least normal.
TINY = np.finfo(np.float64).tiny


def _jeval(expr, jb):
    """The reference's eval with its string tables in scope."""
    from materialize_tpu.expr import strings as jstrings

    keys: set = set()

    def walk(e):
        if isinstance(e, js.CallVariadic) and e.func.startswith(js.STRING_FUNC_PREFIX):
            keys.add(js._string_func_key(e.func[len(js.STRING_FUNC_PREFIX):], e.exprs[1:]))
        for f in getattr(e, "__dataclass_fields__", {}):
            v = getattr(e, f)
            for x in (v if isinstance(v, tuple) else (v,)):
                if isinstance(x, js.ScalarExpr):
                    walk(x)

    walk(expr)
    with jstrings.trace_scope(jstrings.build_env(keys, depth=2)):
        return js.eval_expr(expr, jb)


def _decoded(values, col, nulls, dictionary):
    v = np.asarray(values)[:N]
    if col.ctype.value == "string":
        return [None if n else dictionary.decode(int(x)) for x, n in zip(v, nulls[:N])]
    return v


@pytest.mark.parametrize("name", WIDE_NAMES)
def test_rest_of_scalar_eval_matches_reference(wide_batches, name):
    """Every function outside Q1-Q21's vocabulary on seeded columns with
    NULLs, NaN, infinities, signed zeros, half-way rows and the int32 and
    int64 cast edges: values (the valid ones; a NULL row's value is
    garbage in both), NULL masks, types and error masks against the
    reference's ``eval_expr``."""
    jb, tb = wide_batches
    jex = _wide_exprs(js, jschema.GLOBAL_DICT)[name]
    tex = _wide_exprs(ts, tschema.GLOBAL_DICT)[name]
    with jerrors.collect() as jmasks:
        jev = _jeval(jex, jb)
    tmasks: list = []
    tev = ts.eval_expr(tex, tb, masks=tmasks)
    jn, tn = np.asarray(jev.null_mask())[:N], tev.null_mask()[:N].numpy()
    assert np.array_equal(jn, tn)
    assert (jev.col.ctype.value, jev.col.nullable, jev.col.scale) == (
        tev.col.ctype.value, tev.col.nullable, tev.col.scale)
    assert str(tev.values.dtype).split(".")[-1] == str(np.asarray(jev.values).dtype)
    jv = _decoded(jev.values, jev.col, jn, jschema.GLOBAL_DICT)
    tv = _decoded(tev.values.numpy(), tev.col, tn, tschema.GLOBAL_DICT)
    if jev.col.ctype.value == "string":
        assert jv == tv
    elif jev.col.ctype.value == "float64":
        ok = ~jn
        rtol = CBRT_RTOL if name.startswith("cbrt") else FLOAT_RTOL
        assert np.allclose(tv[ok], jv[ok], rtol=rtol, atol=TINY, equal_nan=True)
        ok &= ~np.isnan(jv)
        assert np.array_equal(np.signbit(tv[ok]), np.signbit(jv[ok]))
    else:
        assert np.array_equal(tv[~jn], jv[~jn])
    assert [c for c, _ in jmasks] == [c for c, _ in tmasks]
    for (_, jm), (_, tm) in zip(jmasks, tmasks):
        _same(jm, tm)


def test_error_guards_and_overflow_rows_are_exercised(wide_batches):
    """The seeded data reaches what the cases above hold: rows where a
    cast overflows or meets NaN, a COALESCE whose erroring argument is
    reached by some rows and not others, and a CASE that guards a
    division by zero."""
    _, tb = wide_batches
    ex = _wide_exprs(ts, tschema.GLOBAL_DICT)
    for name, lo in (("cast_int32_f", 5), ("cast_int64_f", 3), ("cast_int32_i64", 2),
                     ("coalesce_guards_errors", 10)):
        masks: list = []
        ts.eval_expr(ex[name], tb, masks=masks)
        hit = int(sum(int(m[:N].sum()) for _, m in masks))
        assert lo <= hit < N, (name, hit)
    masks = []
    ts.eval_expr(ex["if_guards_errors"], tb, masks=masks)
    assert masks and not any(bool(m[:N].any()) for _, m in masks)


def test_string_dictionary_bulk_insert_and_exhaustion():
    """The port's dictionary keeps code order equal to string order
    across ``encode`` and ``encode_bulk`` (which the string tables use),
    bumps its version on each insert, and raises ``DictExhausted`` where
    a gap runs out (its holders then rebalance it:
    ``tests/test_torch_dict_rebalance.py``)."""
    class Tiny(tschema.StringDictionary):
        MIN_LABEL, MAX_LABEL = 0, 12

    d = Tiny()
    d.encode("m")
    v = d.version
    d.encode_bulk(["c", "a", "x", "m", "b"])
    assert d.version == v + 1
    items = d.items_sorted()
    assert [s for _, s in items] == sorted(["a", "b", "c", "m", "x"])
    assert [c for c, _ in items] == sorted(c for c, _ in items)
    with pytest.raises(tschema.DictExhausted, match="does not fit in gap"):
        d.encode_bulk(["n", "o", "p", "q", "r", "s"])
    with pytest.raises(tschema.DictExhausted, match="exhausted between"):
        for s in ("ma", "mb", "mc", "md", "me", "mf"):
            d.encode(s)


def test_planned_string_functions_run_on_reference_coded_batches():
    """A plan whose string literals the port's planner coded in the
    reference's dictionary (``plan_statement(..., dictionary=)``) runs on
    batches the reference coded, under ``strings.dictionary_scope``: LIKE,
    substr, upper, replace and a concatenation, each against the
    reference's plan evaluated by the reference's ``eval_expr``."""
    from materialize_tpu.sql import catalog as jcatalog
    from materialize_tpu.sql import plan as jplan
    from materialize_tpu.transform import optimizer as joptimizer
    from materialize_tpu_torch.expr import strings as tstrings
    from materialize_tpu_torch.sql import catalog as tcatalog
    from materialize_tpu_torch.sql import plan as tplan
    from materialize_tpu_torch.transform import optimizer as toptimizer

    sql = ("SELECT s LIKE '%an%', substr(s, 2, 3), upper(s), replace(s, 'a', 'qq'), "
           "s || '-tail' FROM t")

    def maps(mod, catalog, planner, optimizer, **kw):
        cat = catalog.Catalog()
        cat.create(catalog.CatalogItem("t", "table", mod.Schema(
            [mod.Column("s", mod.ColumnType.STRING, True)])))
        e = optimizer.optimize(planner.plan_statement(sql, cat, **kw).expr)
        while not hasattr(e, "scalars"):
            e = e.input
        return list(e.scalars)

    jmaps = maps(jschema, jcatalog, jplan, joptimizer)
    tmaps = maps(tschema, tcatalog, tplan, toptimizer, dictionary=jschema.GLOBAL_DICT)
    assert len(jmaps) == len(tmaps) == 5
    rng = np.random.default_rng(5)
    codes = jschema.GLOBAL_DICT.encode_many(STRINGS + ["another", "plan"])
    cols = [codes[rng.integers(0, len(codes), N)]]
    nulls = [rng.random(N) < 0.15]
    time, diff = np.zeros(N, np.uint64), np.ones(N, np.int64)
    jb = JBatch.from_numpy(jschema.Schema([jschema.Column("s", jschema.ColumnType.STRING, True)]),
                           cols, time, diff, capacity=CAP, nulls=nulls)
    tb = TBatch.from_numpy(tschema.Schema([tschema.Column("s", tschema.ColumnType.STRING, True)]),
                           cols, time, diff, capacity=CAP, nulls=nulls, device="cpu")
    for jex, tex in zip(jmaps, tmaps):
        jev = _jeval(jex, jb)
        with tstrings.dictionary_scope(jschema.GLOBAL_DICT):
            tev = ts.eval_expr(tex, tb)
        jn, tn = np.asarray(jev.null_mask())[:N], tev.null_mask()[:N].numpy()
        assert np.array_equal(jn, tn)
        # both sides' strings are codes of the reference's dictionary
        jv = _decoded(jev.values, jev.col, jn, jschema.GLOBAL_DICT)
        tv = _decoded(tev.values.numpy(), tev.col, tn, jschema.GLOBAL_DICT)
        if jev.col.ctype.value == "string":
            assert jv == tv, tex
        else:
            assert np.array_equal(tv[~jn], jv[~jn]), tex
