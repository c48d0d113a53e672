"""AST → HIR query planning: scopes, name resolution, aggregate planning.

Analog of the reference's ``plan_query``/``plan_select`` path
(sql/src/plan/query.rs, dispatched from sql/src/plan/statement.rs:288):
FROM clause folding with binary joins, WHERE, GROUP BY/HAVING with
aggregate extraction, SELECT item planning, DISTINCT, set operations,
CTEs (Let) and WITH MUTUALLY RECURSIVE (LetRec), ORDER BY/LIMIT as TopK.

The port's copy of ``materialize_tpu/sql/plan_query.py``: its relative imports reach the port's
``expr/`` and ``repr/``; it differs from the reference only where noted.
"""

from __future__ import annotations

from typing import Optional

from ..expr.relation import AggregateFunc
from ..expr.scalar import BinaryFunc, UnaryFunc, VariadicFunc
from ..repr.schema import GLOBAL_DICT, Column, ColumnType, Schema
from . import ast
from .hir import (
    CatalogInterface,
    HAggregate,
    HCallBinary,
    HCallUnary,
    HCallVariadic,
    HColumn,
    HConstant,
    HDistinct,
    HExists,
    HFilter,
    HGet,
    HIf,
    HInSubquery,
    HJoin,
    HLet,
    HLetRec,
    HLiteral,
    HMap,
    HNegate,
    HProject,
    HReduce,
    HRename,
    HScalarSubquery,
    HTopK,
    HUnion,
    HirRelation,
    PlanError,
    Scope,
    ScopeItem,
    typ_of,
)

# string functions lower to dictionary side-table gathers
# (expr/strings.py): HCallVariadic("str:<fn>", (col, literal params...))
_STR = "str:"

# name -> (env func, n_args incl. the string column, param positions)
_STRING_FUNCS_1 = {
    "upper": "upper",
    "lower": "lower",
    "initcap": "initcap",
    "reverse": "reverse",
    "length": "length",
    "char_length": "length",
    "character_length": "length",
    "ascii": "ascii",
    "bit_length": "bit_length",
    "octet_length": "octet_length",
    "trim": "trim",
    "btrim": "trim",
    "ltrim": "ltrim",
    "rtrim": "rtrim",
}

_UNARY_FUNC_NAMES = {
    "abs": UnaryFunc.ABS,
    "floor": UnaryFunc.FLOOR,
    "ceil": UnaryFunc.CEIL,
    "ceiling": UnaryFunc.CEIL,
    "trunc": UnaryFunc.TRUNC,
    "sqrt": UnaryFunc.SQRT,
    "cbrt": UnaryFunc.CBRT,
    "exp": UnaryFunc.EXP,
    "ln": UnaryFunc.LN,
    "log2": UnaryFunc.LOG2,
    "log10": UnaryFunc.LOG10,
    "sign": UnaryFunc.SIGN,
    "sin": UnaryFunc.SIN,
    "cos": UnaryFunc.COS,
    "tan": UnaryFunc.TAN,
    "asin": UnaryFunc.ASIN,
    "acos": UnaryFunc.ACOS,
    "atan": UnaryFunc.ATAN,
    "radians": UnaryFunc.RADIANS,
    "degrees": UnaryFunc.DEGREES,
}


def _parse_datetime_literal(text: str, ty: ColumnType) -> int:
    """'1994-01-01' -> days since epoch; with a time part -> ms since
    epoch. Plan-time analog of the reference's string-to-date casts."""
    import datetime as _dt

    s = text.strip()
    try:
        if ty is ColumnType.DATE:
            d = _dt.date.fromisoformat(s)
            return (d - _dt.date(1970, 1, 1)).days
        if " " in s or "T" in s:
            dt = _dt.datetime.fromisoformat(s.replace("T", " "))
        else:
            d = _dt.date.fromisoformat(s)
            dt = _dt.datetime(d.year, d.month, d.day)
        epoch = _dt.datetime(1970, 1, 1)
        return int((dt - epoch).total_seconds() * 1000)
    except ValueError as exc:
        raise PlanError(f"invalid {ty.value} literal {text!r}") from exc


_BINOPS = {
    "+": BinaryFunc.ADD,
    "-": BinaryFunc.SUB,
    "*": BinaryFunc.MUL,
    "/": BinaryFunc.DIV,
    "%": BinaryFunc.MOD,
    "=": BinaryFunc.EQ,
    "<>": BinaryFunc.NEQ,
    "<": BinaryFunc.LT,
    "<=": BinaryFunc.LTE,
    ">": BinaryFunc.GT,
    ">=": BinaryFunc.GTE,
}

_VAR_AGGS = {
    "stddev",
    "stddev_samp",
    "stddev_pop",
    "variance",
    "var_samp",
    "var_pop",
}
_BASIC_AGGS = {"string_agg", "array_agg", "list_agg"}
_AGG_FUNCS = (
    {"count", "sum", "min", "max", "avg", "bool_and", "bool_or", "every"}
    | _VAR_AGGS
    | _BASIC_AGGS
)


def _number_literal(text: str) -> HLiteral:
    if "." in text:
        frac = text.split(".", 1)[1]
        scale = len(frac)
        return HLiteral(
            int(text.replace(".", "")), ColumnType.DECIMAL, scale
        )
    return HLiteral(int(text), ColumnType.INT64)


class QueryPlanner:
    def __init__(self, catalog: CatalogInterface, dictionary=GLOBAL_DICT):
        self.catalog = catalog
        # Port: the dictionary that codes the string literals, the one
        # that codes the data the plan will run over (the reference
        # always codes into its process-global dictionary).
        self.dictionary = dictionary
        self._ctes: dict[str, Schema] = {}
        # Stack of enclosing queries' scopes (innermost last): pushed
        # around subquery planning so correlated names resolve to
        # HOuterColumn(level, index) (the reference's leveled ColumnRef,
        # sql/src/plan/scope.rs resolution order).
        self._outer_scopes: list[Scope] = []

    # -- queries ---------------------------------------------------------
    def plan_query(self, q: ast.Query) -> tuple[HirRelation, Scope]:
        saved = dict(self._ctes)
        try:
            if q.mutually_recursive:
                rel, scope = self._plan_wmr(q)
            else:
                lets = []
                for cte in q.ctes:
                    value, vscope = self.plan_query(cte.query)
                    vschema = value.schema()
                    if cte.columns:
                        names = [c[0] for c in cte.columns]
                        if len(names) != vschema.arity:
                            raise PlanError(
                                f"cte {cte.name}: {len(names)} aliases for "
                                f"{vschema.arity} columns"
                            )
                        vschema = vschema.rename(names)
                        value = _rebrand(value, vschema)
                    self._ctes[cte.name] = vschema
                    lets.append((cte.name, value))
                rel, scope = self._plan_set_expr(q.body)
                for name, value in reversed(lets):
                    rel = HLet(name, value, rel)
            rel, scope = self._apply_finishing(rel, scope, q)
            return rel, scope
        finally:
            self._ctes = saved

    def _apply_finishing(self, rel, scope, q: ast.Query):
        # Result-order finishing (RowSetFinishing): recorded for the
        # adapter to apply to peek results. Nested plan_query calls run
        # before the outermost _apply_finishing, so the last write is
        # the top-level query's ordering.
        self.finishing_order = ()
        if q.order_by:
            order = []
            for ob in q.order_by:
                if isinstance(ob.expr, ast.NumberLit):
                    ordinal = int(ob.expr.text)  # ORDER BY 2
                    if not 1 <= ordinal <= len(scope.items):
                        raise PlanError(
                            f"ORDER BY position {ordinal} is not in "
                            f"the select list (1..{len(scope.items)})"
                        )
                    idx = ordinal - 1
                else:
                    idx = scope.resolve(_ident_parts(ob.expr))
                nulls_last = (
                    ob.nulls_last
                    if ob.nulls_last is not None
                    else not ob.desc  # PG default: ASC->LAST, DESC->FIRST
                )
                order.append((idx, ob.desc, nulls_last))
            self.finishing_order = tuple(order)
            if q.limit is not None or q.offset:
                rel = HTopK(rel, (), tuple(order), q.limit, q.offset)
            # bare ORDER BY on an unordered collection is a no-op (the
            # peek finishing layer re-sorts; reference RowSetFinishing)
        elif q.limit is not None or q.offset:
            rel = HTopK(rel, (), (), q.limit, q.offset)
        return rel, scope

    def _plan_wmr(self, q: ast.Query):
        names, value_schemas = [], []
        for cte in q.ctes:
            if not cte.columns or any(t is None for _, t in cte.columns):
                raise PlanError(
                    "WITH MUTUALLY RECURSIVE bindings need (name type, ...)"
                )
            from .hir import parse_type

            cols = []
            for n, t in cte.columns:
                ty, scale = parse_type(t)
                cols.append(Column(n, ty, True, scale))
            sch = Schema(cols)
            names.append(cte.name)
            value_schemas.append(sch)
            self._ctes[cte.name] = sch
        values = []
        for cte, sch in zip(q.ctes, value_schemas):
            v, _ = self.plan_query(cte.query)
            vs = v.schema()
            if vs.arity != sch.arity:
                raise PlanError(
                    f"binding {cte.name}: arity {vs.arity} != declared "
                    f"{sch.arity}"
                )
            values.append(_rebrand(v, sch))
        body, scope = self._plan_set_expr(q.body)
        return (
            HLetRec(
                tuple(names), tuple(values), tuple(value_schemas), body,
                q.recursion_limit,
            ),
            scope,
        )

    def _plan_set_expr(self, se: ast.SetExpr):
        if isinstance(se, ast.SelectExpr):
            return self._plan_select(se.select)
        if isinstance(se, ast.SetOp):
            left, lscope = self._plan_set_expr(se.left)
            right, _ = self._plan_set_expr(se.right)
            ls, rs = left.schema(), right.schema()
            if ls.arity != rs.arity:
                raise PlanError("set operation arity mismatch")
            if se.op == "union":
                rel = HUnion((left, right))
                if not se.all:
                    rel = HDistinct(rel)
                return rel, lscope
            if se.op == "except":
                if not se.all:
                    left, right = HDistinct(left), HDistinct(right)
                from .hir import HNegate, HThreshold

                return HThreshold(HUnion((left, HNegate(right)))), lscope
            if se.op == "intersect":
                from .hir import HNegate, HThreshold

                if not se.all:
                    left, right = HDistinct(left), HDistinct(right)
                # a ∩ b = a - (a - b)
                a_minus_b = HThreshold(HUnion((left, HNegate(right))))
                return (
                    HThreshold(HUnion((left, HNegate(a_minus_b)))),
                    lscope,
                )
        raise NotImplementedError(type(se).__name__)

    # -- FROM ------------------------------------------------------------
    def _plan_table_factor(self, f: ast.TableFactor):
        if isinstance(f, ast.TableName):
            if f.name in self._ctes:
                sch = self._ctes[f.name]
            else:
                sch = self.catalog.resolve_item(f.name)
            rel = HGet(f.name, sch)
            alias = f.alias.name if f.alias else f.name
            names = (
                list(f.alias.columns)
                if f.alias and f.alias.columns
                else list(sch.names)
            )
            scope = Scope(
                [ScopeItem(alias, n) for n in names],
                [
                    Column(n, c.ctype, c.nullable, c.scale)
                    for n, c in zip(names, sch.columns)
                ],
            )
            return rel, scope
        if isinstance(f, ast.DerivedTable):
            rel, inner_scope = self.plan_query(f.query)
            sch = rel.schema()
            if f.alias is None:
                raise PlanError("subquery in FROM requires an alias")
            names = (
                list(f.alias.columns)
                if f.alias.columns
                else [it.name for it in inner_scope.items]
            )
            scope = Scope(
                [ScopeItem(f.alias.name, n) for n in names],
                [
                    Column(n, c.ctype, c.nullable, c.scale)
                    for n, c in zip(names, sch.columns)
                ],
            )
            return rel, scope
        raise NotImplementedError(type(f).__name__)

    def _plan_from(self, from_: tuple):
        rel, scope = None, None
        for item in from_:
            r, s = self._plan_table_factor(item.factor)
            for jc in item.joins:
                jr, js = self._plan_table_factor(jc.factor)
                combined = s.concat(js)
                on: list = []
                if jc.using:
                    larity = len(s.items)
                    from .hir import ScopeItem as _SI

                    # pg `*` order: USING-merged columns first, outermost
                    # join first. Later joins get smaller (more negative)
                    # rank bases so their merged columns sort ahead.
                    self._using_join_seq = getattr(
                        self, "_using_join_seq", 0
                    ) + 1
                    rank_base = -(self._using_join_seq << 16)
                    for uidx, name in enumerate(jc.using):
                        li = s.resolve((name,))
                        ri = js.resolve((name,))
                        on.append(
                            HCallBinary(
                                BinaryFunc.EQ,
                                HColumn(li),
                                HColumn(larity + ri),
                            )
                        )
                        # Merge the shared column: hide the copy whose
                        # side can be NULL on unmatched rows, so the
                        # surviving unqualified column carries the
                        # merged value (pg USING semantics). FULL
                        # would need a COALESCE column — refuse rather
                        # than return wrong NULLs.
                        if jc.kind == "full":
                            raise PlanError(
                                "FULL JOIN ... USING is not supported; "
                                "use ON with explicit COALESCE"
                            )
                        hide = (
                            li if jc.kind == "right" else larity + ri
                        )
                        keep = (
                            larity + ri if jc.kind == "right" else li
                        )
                        it = combined.items[hide]
                        combined.items[hide] = _SI(
                            it.table, it.name, hidden=True
                        )
                        kt = combined.items[keep]
                        combined.items[keep] = _SI(
                            kt.table, kt.name, hidden=kt.hidden,
                            star_rank=rank_base + uidx,
                        )
                elif jc.on is not None:
                    on = self._conjuncts(jc.on, combined)
                r = HJoin(r, jr, tuple(on), jc.kind)
                s = combined
            if rel is None:
                rel, scope = r, s
            else:
                rel = HJoin(rel, r, (), "cross")
                scope = scope.concat(s)
        return rel, scope

    def _conjuncts(self, e: ast.Expr, scope: Scope) -> list:
        if isinstance(e, ast.BinaryOp) and e.op == "and":
            return self._conjuncts(e.left, scope) + self._conjuncts(
                e.right, scope
            )
        return [self.plan_expr(e, scope)]

    # -- SELECT ----------------------------------------------------------
    def _plan_select(self, sel: ast.Select):
        if sel.from_:
            rel, scope = self._plan_from(sel.from_)
        else:
            rel = HConstant(((tuple(), 1),), Schema([]))
            scope = Scope([], [])

        if sel.where is not None:
            rel = HFilter(rel, tuple(self._conjuncts(sel.where, scope)))

        # Expand stars and name outputs.
        items: list[tuple[ast.Expr, str]] = []
        for it in sel.items:
            if isinstance(it.expr, ast.Star):
                # pg column order for unqualified `*` over USING joins:
                # merged join columns first (outermost join first, then
                # USING-clause order), remaining columns positionally.
                expand = [
                    (i, sc) for i, sc in enumerate(scope.items)
                ]
                if not it.expr.qualifier:
                    expand.sort(
                        key=lambda t: (
                            t[1].star_rank
                            if t[1].star_rank is not None
                            else t[0]
                        )
                    )
                for i, sc in expand:
                    if it.expr.qualifier and sc.table != it.expr.qualifier:
                        continue
                    if not it.expr.qualifier and sc.hidden:
                        continue  # USING-merged duplicate
                    items.append((ast.Ident((sc.table, sc.name)), sc.name))
            else:
                items.append((it.expr, it.alias or _default_name(it.expr)))

        has_aggs = bool(sel.group_by) or any(
            _contains_agg(e) for e, _ in items
        ) or (sel.having is not None and _contains_agg(sel.having))

        if has_aggs:
            rel, scope, items, having = self._plan_aggregation(
                rel, scope, sel, items
            )
            if having is not None:
                rel = HFilter(rel, (having,))
        elif sel.having is not None:
            raise PlanError("HAVING without aggregation")

        # Map select expressions, project to output columns.
        schema = rel.schema()
        scalars, outputs = [], []
        for e, name in items:
            h = self.plan_expr(e, scope)
            if isinstance(h, HColumn):
                outputs.append(h.index)
            else:
                c = typ_of(h, schema_with(schema, scalars))
                scalars.append((h, Column(name, c.ctype, c.nullable, c.scale)))
                outputs.append(schema.arity + len(scalars) - 1)
        if scalars:
            rel = HMap(rel, tuple(scalars))
        rel = HProject(rel, tuple(outputs))
        out_scope = Scope(
            [ScopeItem(None, n) for _, n in items],
            list(rel.schema().columns),
        )
        # Rename projected columns to their aliases.
        rel = _rebrand(rel, rel.schema().rename([n for _, n in items]))
        if sel.distinct:
            rel = HDistinct(rel)
        return rel, out_scope

    def _plan_aggregation(self, rel, scope, sel: ast.Select, items):
        schema = rel.schema()
        # 1. group key expressions -> map non-column exprs first
        key_sources: list[ast.Expr] = list(sel.group_by)
        pre_scalars: list = []
        key_indices: list[int] = []
        resolved_keys: list[ast.Expr] = []
        aliases = {name: e for e, name in items}
        for ge in key_sources:
            if isinstance(ge, ast.NumberLit):  # GROUP BY 1
                e, _ = items[int(ge.text) - 1]
            elif (
                isinstance(ge, ast.Ident)
                and len(ge.parts) == 1
                and scope.maybe_resolve(ge.parts) is None
                and ge.parts[0] in aliases
            ):
                # GROUP BY <select alias> (a real column wins, pg-style)
                e = aliases[ge.parts[0]]
            else:
                e = ge
            resolved_keys.append(e)
            h = self.plan_expr(e, scope)
            if isinstance(h, HColumn):
                key_indices.append(h.index)
            else:
                c = typ_of(h, schema_with(schema, pre_scalars))
                pre_scalars.append((h, c))
                key_indices.append(schema.arity + len(pre_scalars) - 1)
        if pre_scalars:
            rel = HMap(rel, tuple(pre_scalars))
            schema = rel.schema()

        # 2. collect aggregate calls from items + having
        aggs: list[HAggregate] = []

        def plan_agg(fc: ast.FuncCall) -> tuple:
            """Returns (kind, [agg indices]) — composite aggregates
            (avg, stddev/variance) decompose into sums and counts, like
            the reference's sql func library (sql/src/func.rs)."""
            name = fc.name
            dist = fc.distinct
            if fc.star or (name == "count" and not fc.args):
                inner = HLiteral(True, ColumnType.BOOL)
            else:
                inner = self.plan_expr(fc.args[0], scope)
            ityp = typ_of(inner, schema)
            if name == "count":
                func, out = AggregateFunc.COUNT, Column(
                    "count", ColumnType.INT64, False
                )
                aggs.append(HAggregate(func, inner, dist, out))
                return ("plain", [len(aggs) - 1])
            if name == "sum":
                if ityp.ctype is ColumnType.FLOAT64:
                    func = AggregateFunc.SUM_FLOAT
                    out = Column("sum", ColumnType.FLOAT64, True)
                elif ityp.ctype is ColumnType.BOOL:
                    raise PlanError("sum over boolean is not defined")
                else:
                    func = AggregateFunc.SUM_INT
                    out = Column("sum", ityp.ctype, True, ityp.scale)
                aggs.append(HAggregate(func, inner, dist, out))
                return ("plain", [len(aggs) - 1])
            if name in ("min", "max"):
                # STRING included: order-preserving dictionary codes
                # make min/max over text a plain hierarchical reduce.
                func = (
                    AggregateFunc.MIN if name == "min" else AggregateFunc.MAX
                )
                out = Column(name, ityp.ctype, True, ityp.scale)
                aggs.append(HAggregate(func, inner, False, out))
                return ("plain", [len(aggs) - 1])
            if name in ("bool_and", "every", "bool_or"):
                if ityp.ctype is not ColumnType.BOOL:
                    raise PlanError(f"{name} requires a boolean argument")
                func = (
                    AggregateFunc.ANY
                    if name == "bool_or"
                    else AggregateFunc.ALL
                )
                out = Column(name, ColumnType.BOOL, True)
                aggs.append(HAggregate(func, inner, False, out))
                return ("plain", [len(aggs) - 1])
            if name in _BASIC_AGGS:
                # Basic (collection) aggregates: maintained as a sorted
                # (key, value) multiset + change digest on device,
                # materialized at the serving edge (ops/reduce.py;
                # render/reduce.rs:369 build_basic_aggregate analog).
                if dist:
                    raise PlanError(
                        f"{name}(DISTINCT ...) is not supported"
                    )
                params: tuple = ()
                if name == "string_agg":
                    if len(fc.args) != 2:
                        raise PlanError(
                            "string_agg requires (value, separator)"
                        )
                    sep_ast = fc.args[1]
                    if not isinstance(sep_ast, ast.StringLit):
                        raise PlanError(
                            "string_agg separator must be a string "
                            "literal"
                        )
                    params = (sep_ast.value,)
                    if ityp.ctype is not ColumnType.STRING:
                        raise PlanError(
                            "string_agg requires a text argument"
                        )
                    func = AggregateFunc.STRING_AGG
                else:
                    if ityp.ctype is ColumnType.FLOAT64:
                        raise PlanError(
                            f"{name} over double precision is not "
                            "supported yet (int64-lane values only)"
                        )
                    func = (
                        AggregateFunc.ARRAY_AGG
                        if name == "array_agg"
                        else AggregateFunc.LIST_AGG
                    )
                out = Column(name, ColumnType.STRING, True)
                aggs.append(
                    HAggregate(func, inner, False, out, params)
                )
                return ("plain", [len(aggs) - 1])
            if name == "avg":
                _, s = plan_agg(
                    ast.FuncCall("sum", fc.args, distinct=dist)
                )
                _, c = plan_agg(
                    ast.FuncCall("count", fc.args, distinct=dist)
                )
                return ("avg", s + c)
            if name in _VAR_AGGS:
                if dist:
                    # sum(DISTINCT x*x) dedups on x*x, not on x, so the
                    # decomposition would be wrong for {-a, a} inputs
                    raise PlanError(
                        f"{name}(DISTINCT ...) is not supported"
                    )
                dbl = ast.Cast(fc.args[0], "double")
                sq = ast.BinaryOp("*", dbl, dbl)
                _, s = plan_agg(ast.FuncCall("sum", (dbl,), distinct=dist))
                _, ss = plan_agg(ast.FuncCall("sum", (sq,), distinct=dist))
                _, c = plan_agg(
                    ast.FuncCall("count", (dbl,), distinct=dist)
                )
                return (name, s + ss + c)
            raise PlanError(f"unknown aggregate {name}")

        n_key = len(key_indices)
        agg_refs: dict[int, list] = {}

        def rewrite(e: ast.Expr):
            """Replace aggregate calls with post-reduce column refs;
            a select item STRUCTURALLY equal to a GROUP BY expression
            references that key column (the reference's group-key
            matching in sql/src/plan/query.rs)."""
            for kpos, ke in enumerate(resolved_keys):
                if e == ke and not isinstance(e, ast.NumberLit):
                    return _PostAggColumn(kpos)
            if isinstance(e, ast.FuncCall) and (
                e.name in _AGG_FUNCS or e.star
            ):
                # Structural dedup: count(*) in SELECT and HAVING is
                # ONE aggregate in the reduce (frozen AST nodes hash).
                key = e
                if key not in agg_refs:
                    agg_refs[key] = plan_agg(e)
                kind, idxs = agg_refs[key]
                cols_ = [_PostAggColumn(n_key + i) for i in idxs]
                if kind == "plain":
                    return cols_[0]
                if kind == "avg":
                    # avg(int) divides as double (pg returns numeric;
                    # `/` on two ints is INTEGER division since the
                    # int8div fix). Decimal sums keep decimal division.
                    s_col = aggs[idxs[0]].out
                    if s_col.ctype in (
                        ColumnType.INT32, ColumnType.INT64
                    ):
                        return ast.BinaryOp(
                            "/", ast.Cast(cols_[0], "double"), cols_[1]
                        )
                    return ast.BinaryOp("/", cols_[0], cols_[1])
                # variance family: E[x^2] and E[x]^2 from (sum, sum_sq,
                # count); sample variants divide by (count - 1), whose
                # zero denominator yields NULL (matching pg's NULL for
                # n<2); numeric noise is clamped at 0 before sqrt
                s, ss, c = cols_
                num = ast.BinaryOp(
                    "-",
                    ss,
                    ast.BinaryOp("/", ast.BinaryOp("*", s, s), c),
                )
                num = ast.FuncCall("greatest", (num, ast.NumberLit("0.0")))
                denom = (
                    ast.BinaryOp("-", c, ast.NumberLit("1"))
                    if kind in ("stddev", "stddev_samp", "var_samp",
                                "variance")
                    else c
                )
                # n<2 (or empty-group) denominators are NULL, not a
                # division-by-zero error: CASE is SQL's error guard and
                # the eval layer suppresses unselected-branch errors
                var = ast.Case(
                    None,
                    (
                        (
                            ast.BinaryOp("=", denom, ast.NumberLit("0")),
                            ast.NullLit(),
                        ),
                    ),
                    ast.BinaryOp("/", num, denom),
                )
                if kind in ("stddev", "stddev_samp", "stddev_pop"):
                    var = ast.FuncCall("sqrt", (var,))
                # all-NULL groups: sum is NULL and must stay NULL (the
                # greatest() clamp above would otherwise turn it into 0)
                return ast.Case(
                    None,
                    ((ast.IsNull(s, negated=True), var),),
                    ast.NullLit(),
                )
            if isinstance(e, ast.BinaryOp):
                return ast.BinaryOp(e.op, rewrite(e.left), rewrite(e.right))
            if isinstance(e, ast.UnaryOp):
                return ast.UnaryOp(e.op, rewrite(e.expr))
            if isinstance(e, ast.Cast):
                return ast.Cast(rewrite(e.expr), e.to_type)
            if isinstance(e, ast.IsNull):
                return ast.IsNull(rewrite(e.expr), e.negated)
            if isinstance(e, ast.Extract):
                return ast.Extract(e.part, rewrite(e.expr))
            if isinstance(e, ast.InList):
                return ast.InList(
                    rewrite(e.expr),
                    tuple(rewrite(x) for x in e.items),
                    e.negated,
                )
            if isinstance(e, ast.Between):
                return ast.Between(
                    rewrite(e.expr), rewrite(e.low), rewrite(e.high),
                    e.negated,
                )
            if isinstance(e, ast.Case):
                return ast.Case(
                    rewrite(e.operand) if e.operand is not None else None,
                    tuple(
                        (rewrite(c), rewrite(r)) for c, r in e.whens
                    ),
                    rewrite(e.else_) if e.else_ is not None else None,
                )
            if isinstance(e, ast.FuncCall):
                return ast.FuncCall(
                    e.name, tuple(rewrite(a) for a in e.args), e.distinct
                )
            return e

        new_items = []
        for e, name in items:
            re_ = rewrite(e)
            new_items.append((re_, name))
        having = None
        if sel.having is not None:
            having_ast = rewrite(sel.having)
            rel2 = self._reduce_with_defaults(rel, key_indices, aggs)
            post_scope = self._post_agg_scope(scope, key_indices, aggs)
            having = self.plan_expr(having_ast, post_scope)
            return rel2, post_scope, new_items, having
        rel2 = self._reduce_with_defaults(rel, key_indices, aggs)
        post_scope = self._post_agg_scope(scope, key_indices, aggs)
        return rel2, post_scope, new_items, None

    def _reduce_with_defaults(self, rel, key_indices, aggs):
        """HReduce, plus — for GLOBAL aggregates (no group key) — the SQL
        default row over empty input (COUNT -> 0, others NULL): the
        reference's lowering emits reduce ∪ (defaults ∖ nonempty-flag)
        (sql/src/plan/lowering.rs reduce defaults)."""
        red = HReduce(rel, tuple(key_indices), tuple(aggs))
        if key_indices:
            return red
        from .hir import is_correlated

        # Check the REDUCE, not just its input: correlation can live in
        # aggregate argument expressions alone.
        if is_correlated(red):
            # Correlated global aggregate: under decorrelation the
            # reduce becomes per-outer-key and this one-row defaults
            # union would be wrong; the branch lowering pads missing
            # keys with per-aggregate defaults instead (lowering.py).
            return red
        # Let-bind the reduce: it appears twice in the union (directly
        # and inside the nonempty flag) and must be computed ONCE (the
        # render layer shares Let bindings; without it the whole
        # upstream pipeline would be maintained twice).
        self._defaults_seq = getattr(self, "_defaults_seq", 0) + 1
        bind = f"__agg{self._defaults_seq}"
        red_get = HGet(bind, red.schema())
        flag_col = Column("f", ColumnType.INT64)
        flag_schema = Schema([flag_col])
        # One (1,) row iff the reduce output is nonempty.
        has = HProject(
            HMap(red_get, ((HLiteral(1, ColumnType.INT64), flag_col),)),
            (len(aggs),),
        )
        miss = HUnion(
            (
                HConstant((((1,), 1),), flag_schema),
                HNegate(has),
            )
        )
        defaults = []
        for a in aggs:
            if a.func is AggregateFunc.COUNT:
                defaults.append((HLiteral(0, ColumnType.INT64), a.out))
            else:
                defaults.append(
                    (HLiteral(None, a.out.ctype, a.out.scale), a.out)
                )
        deflt = HProject(
            HMap(miss, tuple(defaults)),
            tuple(range(1, len(aggs) + 1)),
        )
        return HLet(bind, red, HUnion((red_get, deflt)))

    def _post_agg_scope(self, scope, key_indices, aggs):
        items = []
        cols = []
        for i in key_indices:
            if i < len(scope.items):
                items.append(
                    ScopeItem(scope.items[i].table, scope.items[i].name)
                )
                cols.append(
                    scope.columns[i]
                    if scope.columns is not None and i < len(scope.columns)
                    else None
                )
            else:
                # GROUP BY <expression>: the key is a pre-mapped column
                # beyond the input scope; positionally addressable only.
                # '#' cannot appear in identifiers, so the name can
                # never capture a real column reference.
                items.append(ScopeItem(None, f"#gkey{i}"))
                cols.append(None)
        items += [ScopeItem(None, a.out.name) for a in aggs]
        cols += [a.out for a in aggs]
        return Scope(items, cols if all(c is not None for c in cols) else None)

    # -- scalar expressions ----------------------------------------------
    def plan_expr(self, e: ast.Expr, scope: Scope):
        if isinstance(e, _PostAggColumn):
            return HColumn(e.index)
        if isinstance(e, ast.Ident):
            idx = scope.maybe_resolve(e.parts)
            if idx is not None:
                return HColumn(idx)
            # Correlated reference: resolve against enclosing scopes,
            # innermost first.
            from .hir import HOuterColumn

            for level, oscope in enumerate(
                reversed(self._outer_scopes), start=1
            ):
                oidx = oscope.maybe_resolve(e.parts)
                if oidx is not None:
                    if oscope.columns is None:
                        raise PlanError(
                            "correlated reference into an untyped scope"
                        )
                    return HOuterColumn(level, oidx, oscope.columns[oidx])
            raise PlanError(f"unknown column {'.'.join(e.parts)!r}")
        if isinstance(e, ast.NumberLit):
            return _number_literal(e.text)
        if isinstance(e, ast.StringLit):
            return HLiteral(
                self.dictionary.encode(e.value), ColumnType.STRING
            )
        if isinstance(e, ast.BoolLit):
            return HLiteral(e.value, ColumnType.BOOL)
        if isinstance(e, ast.NullLit):
            return HLiteral(None, ColumnType.INT64)
        if isinstance(e, ast.IntervalLit):
            raise PlanError(
                "interval literals are only supported in +/- expressions"
            )
        if isinstance(e, ast.BinaryOp):
            if e.op in ("+", "-") and isinstance(e.right, ast.IntervalLit):
                iv = e.right
                sgn = 1 if e.op == "+" else -1
                return HCallVariadic(
                    VariadicFunc.ADD_INTERVAL,
                    (
                        self.plan_expr(e.left, scope),
                        HLiteral(sgn * iv.months, ColumnType.INT64),
                        HLiteral(sgn * iv.days, ColumnType.INT64),
                        HLiteral(sgn * iv.ms, ColumnType.INT64),
                    ),
                )
            if e.op == "+" and isinstance(e.left, ast.IntervalLit):
                return self.plan_expr(
                    ast.BinaryOp("+", e.right, e.left), scope
                )
            if e.op == "and":
                return HCallVariadic(
                    VariadicFunc.AND,
                    (
                        self.plan_expr(e.left, scope),
                        self.plan_expr(e.right, scope),
                    ),
                )
            if e.op == "or":
                return HCallVariadic(
                    VariadicFunc.OR,
                    (
                        self.plan_expr(e.left, scope),
                        self.plan_expr(e.right, scope),
                    ),
                )
            if e.op == "||":
                return self._plan_concat(e, scope)
            if e.op in _BINOPS:
                return HCallBinary(
                    _BINOPS[e.op],
                    self.plan_expr(e.left, scope),
                    self.plan_expr(e.right, scope),
                )
            raise PlanError(f"unsupported operator {e.op!r}")
        if isinstance(e, ast.UnaryOp):
            inner = self.plan_expr(e.expr, scope)
            if e.op == "-":
                if (
                    isinstance(inner, HLiteral)
                    and inner.value is not None
                    and inner.ctype is not ColumnType.STRING
                ):
                    # fold -literal so literal-argument positions
                    # (round(x, -1), LIMIT arithmetic) see a Literal
                    return HLiteral(
                        -inner.value, inner.ctype, inner.scale
                    )
                return HCallUnary(UnaryFunc.NEG, inner)
            if e.op == "not":
                return HCallUnary(UnaryFunc.NOT, inner)
        if isinstance(e, ast.Like):
            x = self.plan_expr(e.expr, scope)
            pat = self.plan_expr(e.pattern, scope)
            if not (
                isinstance(pat, HLiteral)
                and pat.ctype is ColumnType.STRING
            ):
                raise PlanError(
                    "LIKE patterns must be string literals (the match "
                    "table is precomputed per dictionary entry)"
                )
            fn = "ilike" if e.case_insensitive else "like"
            out = HCallVariadic(_STR + fn, (x, pat))
            return HCallUnary(UnaryFunc.NOT, out) if e.negated else out
        if isinstance(e, ast.IsNull):
            inner = HCallUnary(
                UnaryFunc.IS_NULL, self.plan_expr(e.expr, scope)
            )
            return (
                HCallUnary(UnaryFunc.NOT, inner) if e.negated else inner
            )
        if isinstance(e, ast.Between):
            x = self.plan_expr(e.expr, scope)
            lo = self.plan_expr(e.low, scope)
            hi = self.plan_expr(e.high, scope)
            within = HCallVariadic(
                VariadicFunc.AND,
                (
                    HCallBinary(BinaryFunc.GTE, x, lo),
                    HCallBinary(BinaryFunc.LTE, x, hi),
                ),
            )
            return (
                HCallUnary(UnaryFunc.NOT, within) if e.negated else within
            )
        if isinstance(e, ast.InList):
            x = self.plan_expr(e.expr, scope)
            eqs = tuple(
                HCallBinary(BinaryFunc.EQ, x, self.plan_expr(i, scope))
                for i in e.items
            )
            anyeq = HCallVariadic(VariadicFunc.OR, eqs)
            return HCallUnary(UnaryFunc.NOT, anyeq) if e.negated else anyeq
        if isinstance(e, ast.Case):
            if e.operand is not None:
                op = self.plan_expr(e.operand, scope)
                whens = [
                    (
                        HCallBinary(
                            BinaryFunc.EQ, op, self.plan_expr(c, scope)
                        ),
                        self.plan_expr(r, scope),
                    )
                    for c, r in e.whens
                ]
            else:
                whens = [
                    (self.plan_expr(c, scope), self.plan_expr(r, scope))
                    for c, r in e.whens
                ]
            els = (
                self.plan_expr(e.else_, scope)
                if e.else_ is not None
                else HLiteral(None, ColumnType.INT64)
            )
            out = els
            for cond, res in reversed(whens):
                out = HIf(cond, res, out)
            return out
        if isinstance(e, ast.Cast):
            return self._plan_cast(e, scope)
        if isinstance(e, ast.Extract):
            if e.part not in UnaryFunc.EXTRACTS:
                raise PlanError(f"EXTRACT({e.part}) unsupported")
            return HCallUnary(
                UnaryFunc.EXTRACTS[e.part], self.plan_expr(e.expr, scope)
            )
        if isinstance(e, ast.FuncCall):
            if e.name in _AGG_FUNCS or e.star:
                raise PlanError(
                    f"aggregate {e.name} in a non-aggregated context"
                )
            return self._plan_func(e, scope)
        if isinstance(e, ast.Exists):
            rel, _ = self._plan_subquery(e.query, scope)
            return HExists(rel)
        if isinstance(e, ast.ScalarSubquery):
            rel, _ = self._plan_subquery(e.query, scope)
            return HScalarSubquery(rel)
        if isinstance(e, ast.InSubquery):
            rel, _ = self._plan_subquery(e.query, scope)
            x = self.plan_expr(e.expr, scope)
            return HInSubquery(x, rel, e.negated)
        raise NotImplementedError(type(e).__name__)

    def _plan_subquery(self, q: ast.Query, scope: Scope):
        """Plan a subquery with ``scope`` available as an outer scope for
        correlated name resolution."""
        self._outer_scopes.append(scope)
        try:
            return self.plan_query(q)
        finally:
            self._outer_scopes.pop()

    def _plan_cast(self, e: ast.Cast, scope: Scope):
        """CAST(expr AS type) — the typeconv analog (sql/src/plan/typeconv.rs).

        String literals cast to DATE/TIMESTAMP are parsed at plan time;
        decimal(p,s) casts carry the target scale as a literal operand."""
        from .hir import parse_type

        ty, cast_scale = parse_type(e.to_type)
        inner_ast = e.expr
        if ty in (ColumnType.DATE, ColumnType.TIMESTAMP) and isinstance(
            inner_ast, ast.StringLit
        ):
            return HLiteral(_parse_datetime_literal(inner_ast.value, ty), ty)
        inner = self.plan_expr(inner_ast, scope)
        if ty is ColumnType.INT64:
            return HCallUnary(UnaryFunc.CAST_INT64, inner)
        if ty is ColumnType.INT32:
            return HCallUnary(UnaryFunc.CAST_INT32, inner)
        if ty is ColumnType.FLOAT64:
            return HCallUnary(UnaryFunc.CAST_FLOAT64, inner)
        if ty is ColumnType.BOOL:
            return HCallUnary(UnaryFunc.CAST_BOOL, inner)
        if ty is ColumnType.DATE:
            return HCallUnary(UnaryFunc.CAST_DATE, inner)
        if ty is ColumnType.TIMESTAMP:
            return HCallUnary(UnaryFunc.CAST_TIMESTAMP, inner)
        if ty is ColumnType.DECIMAL:
            return HCallBinary(
                BinaryFunc.CAST_DECIMAL,
                inner,
                HLiteral(cast_scale, ColumnType.INT64),
            )
        if ty is ColumnType.STRING and isinstance(inner, HLiteral):
            if inner.ctype is ColumnType.STRING:
                return inner
        raise PlanError(f"unsupported cast to {e.to_type}")

    def _plan_func(self, e: ast.FuncCall, scope: Scope):
        """Scalar function dispatch (the func.rs library analog)."""
        name = e.name

        def arg(i: int):
            return self.plan_expr(e.args[i], scope)

        def allargs():
            return tuple(self.plan_expr(a, scope) for a in e.args)

        if name == "coalesce":
            return HCallVariadic(VariadicFunc.COALESCE, allargs())
        if name in ("greatest", "least"):
            return HCallVariadic(
                VariadicFunc.GREATEST
                if name == "greatest"
                else VariadicFunc.LEAST,
                allargs(),
            )
        if name == "nullif":
            a, b = arg(0), arg(1)
            # NULL only when a = b is TRUE (an unknown comparison —
            # either side NULL — returns a, per pg); the untyped NULL
            # branch defers typing to a (If._principal)
            return HIf(
                HCallBinary(BinaryFunc.EQ, a, b),
                HLiteral(None, ColumnType.INT64),
                a,
            )
        if name in _STRING_FUNCS_1 or name in (
            "substr", "substring", "left", "right", "replace", "lpad",
            "rpad", "strpos", "position", "split_part",
        ):
            return self._plan_string_func(name, e, scope)
        if name in _UNARY_FUNC_NAMES:
            if len(e.args) != 1:
                raise PlanError(f"{name} takes one argument")
            return HCallUnary(_UNARY_FUNC_NAMES[name], arg(0))
        if name == "round":
            if len(e.args) == 1:
                return HCallUnary(UnaryFunc.ROUND, arg(0))
            return HCallBinary(BinaryFunc.ROUND_TO, arg(0), arg(1))
        if name == "log":
            if len(e.args) == 1:
                return HCallUnary(UnaryFunc.LOG10, arg(0))
            return HCallBinary(BinaryFunc.LOG_BASE, arg(0), arg(1))
        if name in ("power", "pow"):
            return HCallBinary(BinaryFunc.POWER, arg(0), arg(1))
        if name == "mod":
            return HCallBinary(BinaryFunc.MOD, arg(0), arg(1))
        if name == "pi":
            import math

            return HLiteral(math.pi, ColumnType.FLOAT64)
        if name in ("date_trunc", "date_part"):
            part_ast = e.args[0]
            if not isinstance(part_ast, ast.StringLit):
                raise PlanError(f"{name}: part must be a string literal")
            part = part_ast.value.lower()
            if name == "date_trunc":
                table = UnaryFunc.DATE_TRUNCS
            else:
                table = UnaryFunc.EXTRACTS
            if part not in table:
                raise PlanError(f"{name}({part!r}) unsupported")
            return HCallUnary(table[part], arg(1))
        if name == "mz_now":
            if e.args:
                raise PlanError("mz_now() takes no arguments")
            from .hir import HMzNow

            return HMzNow()
        raise PlanError(f"unknown function {name}")

    def _require_literal(self, h, what: str) -> HLiteral:
        if not isinstance(h, HLiteral):
            raise PlanError(
                f"{what} must be a literal (string-function parameters "
                "are baked into the dictionary side-table)"
            )
        return h

    def _plan_string_func(self, name: str, e: ast.FuncCall, scope):
        """String function library (the dictionary-gather lowering;
        reference: expr/src/scalar/func/impls/string.rs)."""
        args = [self.plan_expr(a, scope) for a in e.args]
        if name in _STRING_FUNCS_1:
            if len(args) == 1:
                return HCallVariadic(
                    _STR + _STRING_FUNCS_1[name], (args[0],)
                )
            if name in ("trim", "btrim", "ltrim", "rtrim") and len(
                args
            ) == 2:
                chars = self._require_literal(args[1], f"{name} chars")
                return HCallVariadic(
                    _STR + _STRING_FUNCS_1[name], (args[0], chars)
                )
            raise PlanError(f"wrong argument count for {name}")
        def need(n_min: int, n_max: int):
            if not (n_min <= len(args) <= n_max):
                raise PlanError(
                    f"wrong argument count for {name} "
                    f"(got {len(args)})"
                )

        if name in ("substr", "substring"):
            need(2, 3)
            params = tuple(
                self._require_literal(a, "substr bounds")
                for a in args[1:]
            )
            return HCallVariadic(_STR + "substr", (args[0],) + params)
        if name in ("left", "right"):
            need(2, 2)
            n = self._require_literal(args[1], f"{name} count")
            return HCallVariadic(_STR + name, (args[0], n))
        if name == "replace":
            need(3, 3)
            p = self._require_literal(args[1], "replace from")
            q = self._require_literal(args[2], "replace to")
            return HCallVariadic(_STR + "replace", (args[0], p, q))
        if name in ("lpad", "rpad"):
            need(2, 3)
            params = tuple(
                self._require_literal(a, f"{name} params")
                for a in args[1:]
            )
            return HCallVariadic(_STR + name, (args[0],) + params)
        if name in ("strpos", "position"):
            need(2, 2)
            sub = self._require_literal(args[1], "substring")
            return HCallVariadic(_STR + "position", (args[0], sub))
        if name == "split_part":
            need(3, 3)
            d = self._require_literal(args[1], "delimiter")
            i = self._require_literal(args[2], "field index")
            return HCallVariadic(_STR + "split_part", (args[0], d, i))
        raise PlanError(f"unknown string function {name}")

    def _plan_concat(self, e: ast.BinaryOp, scope):
        """a || b: string concatenation. One side must be a literal
        (the side-table maps each dictionary entry through the append);
        literal||literal folds at plan time; column||column requires
        materializing the cross product of dictionaries and is not
        supported."""
        left = self.plan_expr(e.left, scope)
        right = self.plan_expr(e.right, scope)

        def lit_text(h: HLiteral) -> str:
            if h.ctype is ColumnType.STRING:
                return self.dictionary.decode(int(h.value))
            return str(h.value)

        lish = isinstance(left, HLiteral)
        rish = isinstance(right, HLiteral)
        # NULL || anything is NULL (pg)
        if (lish and left.value is None) or (
            rish and right.value is None
        ):
            return HLiteral(None, ColumnType.STRING)
        if lish and rish:
            return HLiteral(
                self.dictionary.encode(lit_text(left) + lit_text(right)),
                ColumnType.STRING,
            )
        if rish:
            return HCallVariadic(
                _STR + "concat_r",
                (left, HLiteral(
                    self.dictionary.encode(lit_text(right)),
                    ColumnType.STRING,
                )),
            )
        if lish:
            return HCallVariadic(
                _STR + "concat_l",
                (right, HLiteral(
                    self.dictionary.encode(lit_text(left)),
                    ColumnType.STRING,
                )),
            )
        raise PlanError(
            "column || column concatenation is not supported (one side "
            "must be a literal; see expr/strings.py)"
        )


from dataclasses import dataclass


@dataclass(frozen=True)
class _PostAggColumn(ast.Expr):
    """Internal AST marker: a column of the post-reduce relation."""

    index: int


def schema_with(schema: Schema, scalars) -> Schema:
    return Schema(tuple(schema.columns) + tuple(c for _, c in scalars))


def _rebrand(rel: HirRelation, schema: Schema) -> HirRelation:
    return HRename(rel, schema)


def _default_name(e: ast.Expr) -> str:
    if isinstance(e, ast.Ident):
        return e.parts[-1]
    if isinstance(e, ast.FuncCall):
        return e.name
    return "column"


def _contains_agg(e: ast.Expr) -> bool:
    if isinstance(e, ast.FuncCall):
        if e.name in _AGG_FUNCS or e.star:
            return True
        return any(_contains_agg(a) for a in e.args)
    if isinstance(e, ast.BinaryOp):
        return _contains_agg(e.left) or _contains_agg(e.right)
    if isinstance(e, ast.UnaryOp):
        return _contains_agg(e.expr)
    if isinstance(e, ast.Cast):
        return _contains_agg(e.expr)
    if isinstance(e, ast.Case):
        parts = [c for c, _ in e.whens] + [r for _, r in e.whens]
        if e.operand:
            parts.append(e.operand)
        if e.else_:
            parts.append(e.else_)
        return any(_contains_agg(p) for p in parts)
    return False


def _ident_parts(e: ast.Expr) -> tuple:
    if isinstance(e, ast.Ident):
        return e.parts
    raise PlanError("ORDER BY supports columns and output positions only")
