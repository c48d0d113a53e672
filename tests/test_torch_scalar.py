"""Port parity for scalar evaluation and MapFilterProject: the port's
``expr/scalar.py:eval_expr`` and ``expr/linear.py:apply_mfp`` against the
reference's, on the same seeded numpy columns (DECIMAL at scales 2 and
4, DATE, INT64 and INT32, with NULLs and zero divisors), including the
unary NOT and IS NULL over columns with NULLs (Q15's ``NOT IS NULL``
filters), and every integer EXTRACT (Q9's ``EXTRACT(YEAR FROM
o_orderdate)`` among them) over seeded DATE and TIMESTAMP columns with
NULLs, dates before 1970, leap days and ISO week 53. Every value is
an integer, so everything is compared exactly (tolerance 0), padding
rows included: both evaluate every row."""

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
    _, tb = batches
    with pytest.raises(NotImplementedError, match="cast_decimal"):
        ts.eval_expr(ts.CallBinary(ts.BinaryFunc.CAST_DECIMAL, ts.col(4), ts.lit(2)), tb)
    with pytest.raises(NotImplementedError, match="round_to"):
        ts.eval_expr(ts.CallBinary(ts.BinaryFunc.ROUND_TO, ts.col(4), ts.col(5)), tb)
    with pytest.raises(NotImplementedError, match="not ported"):
        ts.eval_expr(object(), tb)
    with pytest.raises(NotImplementedError, match="item 9"):
        ts.eval_expr(ts.CallUnary("neg", ts.col(4)), tb)
    for f in ("cast_float64", "sqrt"):
        with pytest.raises(NotImplementedError, match="item 9"):
            ts.eval_expr(ts.CallUnary(f, ts.col(4)), tb)


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
