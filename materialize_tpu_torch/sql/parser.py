"""SQL parser: hand-written recursive descent over the lexer's tokens.

Analog of the reference's ``sql-parser`` crate (forked from sqlparser-rs;
doc/developer/life-of-a-query.md:104-107). Precedence climbing for scalar
expressions; the statement grammar covers queries (joins, subqueries,
CTEs, WITH MUTUALLY RECURSIVE), CREATE SOURCE ... FROM LOAD GENERATOR,
CREATE [MATERIALIZED] VIEW, CREATE [DEFAULT] INDEX, DROP, EXPLAIN
[RAW|DECORRELATED|OPTIMIZED|PHYSICAL] PLAN FOR, SUBSCRIBE, SHOW.

The port's copy of ``materialize_tpu/sql/parser.py``: its relative imports reach the port's
``expr/`` and ``repr/``; it differs from the reference only where noted.
"""

from __future__ import annotations

from typing import Optional

from . import ast
from .lexer import Token, TokKind, lex


class ParseError(ValueError):
    pass


# binding powers, loosest to tightest (the reference's precedence ladder)
_BINARY_PREC = {
    "or": 10,
    "and": 20,
    # NOT handled as prefix at 25
    "=": 40, "<>": 40, "!=": 40, "<": 40, "<=": 40, ">": 40, ">=": 40,
    "like": 40, "ilike": 40, "between": 40, "in": 40, "is": 40,
    "||": 50,
    "+": 60, "-": 60,
    "*": 70, "/": 70, "%": 70,
}


class Parser:
    def __init__(self, sql: str):
        self.toks = lex(sql)
        self.i = 0

    # -- token helpers -----------------------------------------------------
    def peek(self, ahead: int = 0) -> Token:
        j = self.i + ahead
        return self.toks[min(j, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.i]
        self.i += 1
        return t

    def accept_kw(self, *kws: str) -> Optional[str]:
        t = self.peek()
        if t.kind is TokKind.KEYWORD and t.text in kws:
            self.i += 1
            return t.text
        return None

    def expect_kw(self, *kws: str) -> str:
        got = self.accept_kw(*kws)
        if got is None:
            raise ParseError(
                f"expected {'/'.join(kws).upper()}, got "
                f"{self.peek().text!r} at {self.peek().pos}"
            )
        return got

    def accept_sym(self, sym: str) -> bool:
        t = self.peek()
        if t.kind is TokKind.SYMBOL and t.text == sym:
            self.i += 1
            return True
        return False

    def expect_sym(self, sym: str) -> None:
        if not self.accept_sym(sym):
            raise ParseError(
                f"expected {sym!r}, got {self.peek().text!r} at "
                f"{self.peek().pos}"
            )

    def expect_ident(self) -> str:
        t = self.peek()
        # Allow non-reserved keywords as identifiers where unambiguous.
        if t.kind in (TokKind.IDENT, TokKind.KEYWORD):
            self.i += 1
            return t.text
        raise ParseError(f"expected identifier, got {t.text!r} at {t.pos}")

    # -- entry -------------------------------------------------------------
    def parse_statement(self) -> ast.Statement:
        stmt = self._statement()
        self.accept_sym(";")
        t = self.peek()
        if t.kind is not TokKind.EOF:
            raise ParseError(f"trailing input at {t.pos}: {t.text!r}")
        return stmt

    def _statement(self) -> ast.Statement:
        if self.accept_kw("explain"):
            return self._explain()
        if self.accept_kw("create"):
            return self._create()
        if self.accept_kw("drop"):
            return self._drop()
        if self.accept_kw("insert"):
            return self._insert()
        if self.accept_kw("delete"):
            self.expect_kw("from")
            table = self.expect_ident()
            where = None
            if self.accept_kw("where"):
                where = self.parse_expr()
            return ast.Delete(table, where)
        if self.accept_kw("update"):
            table = self.expect_ident()
            self.expect_kw("set")
            assignments = []
            while True:
                col = self.expect_ident()
                self.expect_sym("=")
                assignments.append((col, self.parse_expr()))
                if not self.accept_sym(","):
                    break
            where = None
            if self.accept_kw("where"):
                where = self.parse_expr()
            return ast.Update(table, tuple(assignments), where)
        if self.accept_kw("set"):
            name = self.expect_ident()
            if not self.accept_sym("="):
                self.expect_kw("to")
            t = self.peek()
            if t.kind is TokKind.NUMBER:
                self.next()
                value = float(t.text) if "." in t.text else int(t.text)
            elif t.kind is TokKind.STRING:
                self.next()
                value = t.text
            elif t.is_kw("default"):
                self.next()
                value = None
            elif t.is_kw("true") or t.is_kw("false"):
                self.next()
                value = t.text == "true"
            else:
                value = self.expect_ident()
            return ast.SetVar(name, value)
        if self.accept_kw("copy"):
            if self.accept_sym("("):
                q = self.parse_query()
                self.expect_sym(")")
                self.expect_kw("to")
                self.expect_kw("stdout")
                return ast.CopyTo(q)
            table = self.expect_ident()
            cols: list = []
            if self.accept_sym("("):
                cols.append(self.expect_ident())
                while self.accept_sym(","):
                    cols.append(self.expect_ident())
                self.expect_sym(")")
            if self.accept_kw("to"):
                self.expect_kw("stdout")
                # build the query as AST (no SQL-text round trip: quoted
                # / case-preserving identifiers must survive)
                items = (
                    tuple(
                        ast.SelectItem(ast.Ident((c,))) for c in cols
                    )
                    if cols
                    else (ast.SelectItem(ast.Star()),)
                )
                q = ast.Query(
                    ast.SelectExpr(
                        ast.Select(
                            items,
                            (ast.FromItem(ast.TableName(table)),),
                        )
                    )
                )
                return ast.CopyTo(q)
            self.expect_kw("from")
            self.expect_kw("stdin")
            # optional WITH (FORMAT TEXT) — text is the only format
            if self.accept_kw("with"):
                self.expect_sym("(")
                depth = 1
                while depth:
                    t = self.next()
                    if t.kind is TokKind.EOF:
                        raise ParseError("unterminated COPY options")
                    if t.text == "(":
                        depth += 1
                    elif t.text == ")":
                        depth -= 1
            return ast.CopyFrom(table, tuple(cols))
        if self.accept_kw("subscribe"):
            self.accept_kw("to")
            t = self.peek()
            # A bare relation name (keywords double as identifiers here,
            # as everywhere expect_ident does — relations may be named
            # 'counter' etc.): SUBSCRIBE r == SUBSCRIBE (SELECT * FROM r)
            if (
                t.kind is TokKind.IDENT
                or (
                    t.kind is TokKind.KEYWORD
                    and t.text not in ("select", "with", "values")
                )
            ):
                name = self.expect_ident()
                return ast.Subscribe(
                    Parser(f"SELECT * FROM {name}").parse_query(),
                    self._parse_as_of(),
                )
            q = self.parse_query()
            return ast.Subscribe(q, self._parse_as_of())
        if self.accept_kw("show"):
            kind = self.expect_ident()
            if kind.lower() in (
                "objects", "sources", "views", "indexes", "tables",
                "source", "view", "index", "table",
            ):
                return ast.ShowObjects(kind)
            return ast.ShowVar(kind)  # SHOW <system variable>
        q = self.parse_query()
        return ast.SelectStatement(q, self._parse_as_of())

    def _parse_as_of(self):
        """Optional statement-level ``AS OF <int>`` (reference:
        sql-parser AS OF on SELECT/SUBSCRIBE). Only legal AFTER a full
        query — table-alias AS never reaches here."""
        if not self.accept_kw("as"):
            return None
        self.expect_kw("of")
        t = self.next()
        if t.kind is not TokKind.NUMBER:
            raise ParseError(
                f"AS OF expects an integer timestamp at {t.pos}"
            )
        return int(t.text)

    # -- DDL ---------------------------------------------------------------
    def _create(self) -> ast.Statement:
        or_replace = False
        if self.accept_kw("or"):
            self.expect_kw("replace")
            or_replace = True
        if self.accept_kw("materialized"):
            self.expect_kw("view")
            return self._create_view(materialized=True, or_replace=or_replace)
        if self.accept_kw("view"):
            return self._create_view(materialized=False, or_replace=or_replace)
        if self.accept_kw("source"):
            return self._create_source()
        if self.accept_kw("sink"):
            return self._create_sink()
        if self.accept_kw("table"):
            return self._create_table()
        if self.accept_kw("default"):
            self.expect_kw("index")
            self.expect_kw("on")
            return ast.CreateIndex(None, self.expect_ident())
        if self.accept_kw("index"):
            name = None
            if not self.peek().is_kw("on"):
                name = self.expect_ident()
            self.expect_kw("on")
            on = self.expect_ident()
            key = ()
            if self.accept_sym("("):
                exprs = [self.parse_expr()]
                while self.accept_sym(","):
                    exprs.append(self.parse_expr())
                self.expect_sym(")")
                key = tuple(exprs)
            return ast.CreateIndex(name, on, key)
        raise ParseError(f"unsupported CREATE at {self.peek().pos}")

    def _create_table(self) -> ast.Statement:
        name = self.expect_ident()
        return ast.CreateTable(name, self._column_defs())

    def _column_defs(self) -> tuple:
        """'(' col type [NOT NULL|NULL], ... ')' — shared by CREATE
        TABLE and CREATE SOURCE ... FROM WEBHOOK."""
        self.expect_sym("(")
        columns = []
        while True:
            col = self.expect_ident()
            ty = self._type_name()
            nullable = True
            if self.accept_kw("not"):
                self.expect_kw("null")
                nullable = False
            elif self.accept_kw("null"):
                pass
            columns.append((col, ty, nullable))
            if not self.accept_sym(","):
                break
        self.expect_sym(")")
        return tuple(columns)

    def expect_ident_or_number(self) -> str:
        t = self.peek()
        if t.kind is TokKind.NUMBER:
            self.next()
            return t.text
        return self.expect_ident()

    def _insert(self) -> ast.Statement:
        self.expect_kw("into")
        table = self.expect_ident()
        columns: tuple = ()
        if self.accept_sym("("):
            cols = [self.expect_ident()]
            while self.accept_sym(","):
                cols.append(self.expect_ident())
            self.expect_sym(")")
            columns = tuple(cols)
        self.expect_kw("values")
        rows = []
        while True:
            self.expect_sym("(")
            vals = [self.parse_expr()]
            while self.accept_sym(","):
                vals.append(self.parse_expr())
            self.expect_sym(")")
            rows.append(tuple(vals))
            if not self.accept_sym(","):
                break
        return ast.Insert(table, tuple(rows), columns)

    def _create_view(self, materialized: bool, or_replace: bool):
        name = self.expect_ident()
        self.expect_kw("as")
        q = self.parse_query()
        return ast.CreateView(name, q, materialized, or_replace)

    def _create_source(self):
        name = self.expect_ident()
        columns: tuple = ()
        if self.peek().text == "(":
            columns = self._column_defs()
        self.expect_kw("from")
        if self.peek().text == "webhook":
            self.next()
            if columns:
                raise ParseError(
                    "webhook columns go after FROM WEBHOOK"
                )
            return ast.CreateWebhook(name, self._column_defs())
        if self.peek().text == "kafka":
            self.next()
            options = self._source_options()
            return ast.CreateSource(name, "kafka", options, columns)
        self.expect_kw("load")
        self.expect_kw("generator")
        gen = self.expect_ident()
        return ast.CreateSource(name, gen, self._source_options())

    def _source_options(self) -> dict:
        """'(' KEY [WORDS...] value, ... ')' — shared by LOAD GENERATOR,
        KAFKA sources, and sinks (SCALE FACTOR 0.1 / TOPIC 'events')."""
        options: dict = {}
        if not self.accept_sym("("):
            return options
        while True:
            key_parts = [self.expect_ident()]
            while self.peek().kind in (TokKind.IDENT, TokKind.KEYWORD) \
                    and not self.peek().is_kw("for"):
                # multi-word option names (SCALE FACTOR, TICK INTERVAL)
                if self.peek().kind is TokKind.SYMBOL:
                    break
                nxt = self.peek()
                if nxt.kind is TokKind.SYMBOL:
                    break
                if nxt.text in (",",):
                    break
                # value follows as number/string; stop if next is value
                if nxt.kind is TokKind.IDENT and len(key_parts) >= 2:
                    break
                if nxt.kind in (TokKind.NUMBER, TokKind.STRING):
                    break
                key_parts.append(self.expect_ident())
            key = " ".join(key_parts)
            t = self.peek()
            if t.kind is TokKind.NUMBER:
                self.next()
                val = float(t.text) if "." in t.text else int(t.text)
            elif t.kind is TokKind.STRING:
                self.next()
                val = t.text
            else:
                val = True
            options[key] = val
            if not self.accept_sym(","):
                break
        self.expect_sym(")")
        return options

    def _create_sink(self):
        name = self.expect_ident()
        self.expect_kw("from")
        from_obj = self.expect_ident()
        self.expect_kw("into")
        if self.peek().text != "kafka":
            raise ParseError("CREATE SINK supports INTO KAFKA")
        self.next()
        return ast.CreateSink(name, from_obj, self._source_options())

    def _drop(self):
        kind = self.expect_ident()
        if_exists = False
        if self.accept_kw("if"):
            self.expect_ident()  # "exists"
            if_exists = True
        name = self.expect_ident()
        return ast.DropObject(kind, name, if_exists)

    def _explain(self):
        stage = self.accept_kw(
            "raw", "decorrelated", "optimized", "physical", "analysis"
        )
        if stage is None:
            stage = "optimized"
        self.accept_kw("plan")
        self.accept_kw("for")
        return ast.Explain(stage, self._statement())

    # -- queries -----------------------------------------------------------
    def parse_query(self) -> ast.Query:
        ctes: list = []
        mutually_recursive = False
        recursion_limit = None
        if self.accept_kw("with"):
            if self.accept_kw("mutually"):
                self.expect_kw("recursive")
                mutually_recursive = True
                if self.accept_sym("("):  # (RETURN AT RECURSION LIMIT n)
                    self.expect_kw("return")
                    self.expect_kw("at")
                    self.expect_kw("recursion")
                    self.expect_kw("limit")
                    recursion_limit = int(self.next().text)
                    self.expect_sym(")")
            while True:
                name = self.expect_ident()
                cols: list = []
                if self.accept_sym("("):
                    while True:
                        cname = self.expect_ident()
                        ctype = None
                        if mutually_recursive:
                            ctype = self._type_name()
                        cols.append((cname, ctype))
                        if not self.accept_sym(","):
                            break
                    self.expect_sym(")")
                self.expect_kw("as")
                self.expect_sym("(")
                q = self.parse_query()
                self.expect_sym(")")
                ctes.append(ast.Cte(name, tuple(cols), q))
                if not self.accept_sym(","):
                    break
        body = self._set_expr()
        order_by: list = []
        if self.accept_kw("order"):
            self.expect_kw("by")
            while True:
                e = self.parse_expr()
                desc = False
                if self.accept_kw("desc"):
                    desc = True
                else:
                    self.accept_kw("asc")
                nulls_last = None
                if self.accept_kw("nulls"):
                    nulls_last = self.expect_kw("first", "last") == "last"
                order_by.append(ast.OrderByItem(e, desc, nulls_last))
                if not self.accept_sym(","):
                    break
        limit = None
        offset = 0
        if self.accept_kw("limit"):
            limit = int(self.next().text)
        if self.accept_kw("offset"):
            offset = int(self.next().text)
        return ast.Query(
            body, tuple(ctes), mutually_recursive, recursion_limit,
            tuple(order_by), limit, offset,
        )

    def _type_name(self) -> str:
        parts = [self.expect_ident()]
        # e.g. double precision / timestamp with time zone (one word here)
        if parts[0] == "double" and self.peek().text == "precision":
            parts.append(self.expect_ident())
        name = " ".join(parts)
        # parameterized types: decimal(12,2), varchar(10), ...
        if self.accept_sym("("):
            args = [self.expect_ident_or_number()]
            while self.accept_sym(","):
                args.append(self.expect_ident_or_number())
            self.expect_sym(")")
            name += "(" + ",".join(args) + ")"
        return name

    def _set_expr(self) -> ast.SetExpr:
        left = self._set_atom()
        while True:
            op = self.accept_kw("union", "except", "intersect")
            if op is None:
                return left
            all_ = bool(self.accept_kw("all"))
            if not all_:
                self.accept_kw("distinct")
            right = self._set_atom()
            left = ast.SetOp(op, all_, left, right)

    def _set_atom(self) -> ast.SetExpr:
        if self.accept_sym("("):
            inner = self._set_expr()
            self.expect_sym(")")
            return inner
        self.expect_kw("select")
        return ast.SelectExpr(self._select_body())

    def _select_body(self) -> ast.Select:
        distinct = bool(self.accept_kw("distinct"))
        if not distinct:
            self.accept_kw("all")
        items = [self._select_item()]
        while self.accept_sym(","):
            items.append(self._select_item())
        from_: list = []
        if self.accept_kw("from"):
            from_.append(self._from_item())
            while self.accept_sym(","):
                from_.append(self._from_item())
        where = None
        if self.accept_kw("where"):
            where = self.parse_expr()
        group_by: list = []
        if self.accept_kw("group"):
            self.expect_kw("by")
            group_by.append(self.parse_expr())
            while self.accept_sym(","):
                group_by.append(self.parse_expr())
        having = None
        if self.accept_kw("having"):
            having = self.parse_expr()
        return ast.Select(
            tuple(items), tuple(from_), where, tuple(group_by), having,
            distinct,
        )

    def _select_item(self) -> ast.SelectItem:
        if self.accept_sym("*"):
            return ast.SelectItem(ast.Star())
        e = self.parse_expr()
        alias = None
        if self.accept_kw("as"):
            alias = self.expect_ident()
        elif self.peek().kind is TokKind.IDENT:
            alias = self.expect_ident()
        return ast.SelectItem(e, alias)

    def _from_item(self) -> ast.FromItem:
        factor = self._table_factor()
        joins: list = []
        while True:
            kind = None
            if self.accept_kw("cross"):
                self.expect_kw("join")
                kind = "cross"
            elif self.accept_kw("inner"):
                self.expect_kw("join")
                kind = "inner"
            elif self.accept_kw("left"):
                self.accept_kw("outer")
                self.expect_kw("join")
                kind = "left"
            elif self.accept_kw("right"):
                self.accept_kw("outer")
                self.expect_kw("join")
                kind = "right"
            elif self.accept_kw("full"):
                self.accept_kw("outer")
                self.expect_kw("join")
                kind = "full"
            elif self.accept_kw("join"):
                kind = "inner"
            if kind is None:
                return ast.FromItem(factor, tuple(joins))
            f = self._table_factor()
            on = None
            using: tuple = ()
            if kind != "cross":
                if self.accept_kw("on"):
                    on = self.parse_expr()
                elif self.accept_kw("using"):
                    self.expect_sym("(")
                    names = [self.expect_ident()]
                    while self.accept_sym(","):
                        names.append(self.expect_ident())
                    self.expect_sym(")")
                    using = tuple(names)
            joins.append(ast.JoinClause(kind, f, on, using))

    def _table_factor(self) -> ast.TableFactor:
        if self.accept_sym("("):
            # subquery or parenthesized join tree (only subquery supported)
            q = self.parse_query()
            self.expect_sym(")")
            alias = self._table_alias()
            return ast.DerivedTable(q, alias)
        name = self.expect_ident()
        alias = self._table_alias()
        return ast.TableName(name, alias)

    def _table_alias(self) -> Optional[ast.TableAlias]:
        # `AS OF <n>` after a table factor is the statement-level
        # timestamp clause, never an alias named "of" (OF is reserved
        # in alias position, as in the reference's parser).
        if self.peek().is_kw("as") and self.peek(1).is_kw("of") \
                and self.peek(2).kind is TokKind.NUMBER:
            return None
        if self.accept_kw("as"):
            name = self.expect_ident()
        elif self.peek().kind is TokKind.IDENT:
            name = self.expect_ident()
        else:
            return None
        cols: tuple = ()
        if self.accept_sym("("):
            names = [self.expect_ident()]
            while self.accept_sym(","):
                names.append(self.expect_ident())
            self.expect_sym(")")
            cols = tuple(names)
        return ast.TableAlias(name, cols)

    # -- scalar expressions (precedence climbing) --------------------------
    def parse_expr(self, min_prec: int = 0) -> ast.Expr:
        left = self._prefix()
        while True:
            t = self.peek()
            op = None
            if t.kind is TokKind.SYMBOL and t.text in _BINARY_PREC:
                op = t.text
            elif t.kind is TokKind.KEYWORD and t.text in (
                "and", "or", "like", "ilike", "between", "in", "is",
                "not",
            ):
                op = t.text
            if op is None:
                return left
            # NOT IN / NOT LIKE / NOT BETWEEN
            negated = False
            if op == "not":
                nxt = self.toks[self.i + 1]
                if nxt.kind is TokKind.KEYWORD and nxt.text in (
                    "in", "like", "ilike", "between",
                ):
                    negated = True
                    op = nxt.text
                else:
                    return left
            prec = _BINARY_PREC[op]
            if prec < min_prec:
                return left
            self.next()
            if negated:
                self.next()
            if op == "is":
                neg = bool(self.accept_kw("not"))
                self.expect_kw("null")
                left = ast.IsNull(left, neg)
                continue
            if op == "between":
                low = self.parse_expr(_BINARY_PREC["between"] + 1)
                self.expect_kw("and")
                high = self.parse_expr(_BINARY_PREC["between"] + 1)
                left = ast.Between(left, low, high, negated)
                continue
            if op == "in":
                self.expect_sym("(")
                if self.peek().is_kw("select") or self.peek().is_kw("with"):
                    q = self.parse_query()
                    self.expect_sym(")")
                    left = ast.InSubquery(left, q, negated)
                else:
                    items = [self.parse_expr()]
                    while self.accept_sym(","):
                        items.append(self.parse_expr())
                    self.expect_sym(")")
                    left = ast.InList(left, tuple(items), negated)
                continue
            right = self.parse_expr(prec + 1)
            if op in ("like", "ilike"):
                left = ast.Like(left, right, negated, op == "ilike")
                continue
            if op == "!=":
                op = "<>"
            left = ast.BinaryOp(op, left, right)

    def _prefix(self) -> ast.Expr:
        t = self.peek()
        if self.accept_sym("-"):
            return ast.UnaryOp("-", self.parse_expr(65))
        if self.accept_sym("+"):
            return self.parse_expr(65)
        if self.accept_kw("not"):
            return ast.UnaryOp("not", self.parse_expr(25))
        if self.accept_sym("("):
            if self.peek().is_kw("select") or self.peek().is_kw("with"):
                q = self.parse_query()
                self.expect_sym(")")
                return ast.ScalarSubquery(q)
            e = self.parse_expr()
            self.expect_sym(")")
            return self._postfix(e)
        if self.accept_kw("exists"):
            self.expect_sym("(")
            q = self.parse_query()
            self.expect_sym(")")
            return ast.Exists(q)
        if self.accept_kw("case"):
            operand = None
            if not self.peek().is_kw("when"):
                operand = self.parse_expr()
            whens = []
            while self.accept_kw("when"):
                cond = self.parse_expr()
                self.expect_kw("then")
                whens.append((cond, self.parse_expr()))
            else_ = None
            if self.accept_kw("else"):
                else_ = self.parse_expr()
            self.expect_kw("end")
            return ast.Case(operand, tuple(whens), else_)
        if self.accept_kw("cast"):
            self.expect_sym("(")
            e = self.parse_expr()
            self.expect_kw("as")
            ty = self._type_name()
            self.expect_sym(")")
            return self._postfix(ast.Cast(e, ty))
        if self.accept_kw("extract"):
            self.expect_sym("(")
            part = self.expect_ident()
            self.expect_kw("from")
            e = self.parse_expr()
            self.expect_sym(")")
            return ast.Extract(part, e)
        if self.accept_kw("true"):
            return ast.BoolLit(True)
        if self.accept_kw("false"):
            return ast.BoolLit(False)
        if self.accept_kw("null"):
            return ast.NullLit()
        if t.kind is TokKind.NUMBER:
            self.next()
            return self._postfix(ast.NumberLit(t.text))
        if t.kind is TokKind.STRING:
            self.next()
            return self._postfix(ast.StringLit(t.text))
        if self.accept_kw("interval"):
            s = self.peek()
            if s.kind is not TokKind.STRING:
                raise ParseError("INTERVAL requires a string literal")
            self.next()
            unit = None
            u = self.peek()
            if u.kind in (TokKind.IDENT, TokKind.KEYWORD) and (
                u.text.lower().rstrip("s") in _INTERVAL_UNITS
            ):
                unit = u.text.lower().rstrip("s")
                self.next()
            return _interval_literal(s.text, unit)
        if t.kind in (TokKind.IDENT, TokKind.KEYWORD):
            # typed literal (DATE '1994-01-01', TIMESTAMP '...')
            if t.text.lower() in ("date", "timestamp") and (
                self.peek(1).kind is TokKind.STRING
            ):
                ty = t.text.lower()
                self.next()
                s = self.peek()
                self.next()
                return self._postfix(ast.Cast(ast.StringLit(s.text), ty))
            # function call or (qualified) column reference
            name = self.expect_ident()
            if self.accept_sym("("):
                if self.accept_sym("*"):
                    self.expect_sym(")")
                    return ast.FuncCall(name, (), star=True)
                distinct = bool(self.accept_kw("distinct"))
                args: list = []
                if not self.accept_sym(")"):
                    args.append(self.parse_expr())
                    while self.accept_sym(","):
                        args.append(self.parse_expr())
                    self.expect_sym(")")
                return ast.FuncCall(name, tuple(args), distinct)
            parts = [name]
            while self.accept_sym("."):
                if self.accept_sym("*"):
                    return ast.Star(qualifier=".".join(parts))
                parts.append(self.expect_ident())
            return self._postfix(ast.Ident(tuple(parts)))
        raise ParseError(f"unexpected token {t.text!r} at {t.pos}")

    def _postfix(self, e: ast.Expr) -> ast.Expr:
        while self.accept_sym("::"):
            e = ast.Cast(e, self._type_name())
        return e


_INTERVAL_UNITS = {
    "year": ("months", 12),
    "quarter": ("months", 3),
    "month": ("months", 1),
    "week": ("days", 7),
    "day": ("days", 1),
    "hour": ("ms", 3_600_000),
    "minute": ("ms", 60_000),
    "second": ("ms", 1_000),
    "millisecond": ("ms", 1),
}


def _interval_literal(text: str, unit: str | None) -> ast.IntervalLit:
    """INTERVAL '1' YEAR / INTERVAL '3 months' / INTERVAL '1 day 2:30'
    -> normalized (months, days, ms), like the reference's interval
    parsing (repr/src/adt/interval.rs). Bare numbers are SECONDS and
    H[:M[:S]] groups are time-of-day, both as in pg; fractional months
    spill into days (30/month) and fractional days into ms."""
    monthsf = daysf = 0.0
    msf = 0.0

    def add(qty: float, u: str) -> None:
        nonlocal monthsf, daysf, msf
        field, mult = _INTERVAL_UNITS[u]
        if field == "months":
            monthsf += qty * mult
        elif field == "days":
            daysf += qty * mult
        else:
            msf += qty * mult

    def num(word: str) -> float:
        try:
            return float(word)
        except ValueError:
            raise ParseError(
                f"bad interval literal {text!r}"
            ) from None

    def add_clock(word: str) -> None:
        nonlocal msf
        segs = word.split(":")
        if len(segs) not in (2, 3) or not segs[0]:
            raise ParseError(f"bad interval literal {text!r}")
        sign = -1 if segs[0].lstrip().startswith("-") else 1
        h = abs(num(segs[0]))
        m = num(segs[1])
        s = num(segs[2]) if len(segs) == 3 else 0.0
        msf += sign * (h * 3_600_000 + m * 60_000 + s * 1_000)

    words = text.strip().split()
    if not words:
        raise ParseError(f"bad interval literal {text!r}")
    if unit is not None:
        if len(words) != 1:
            raise ParseError(f"bad interval literal {text!r}")
        add(num(words[0]), unit)
    else:
        i = 0
        while i < len(words):
            w = words[i]
            if ":" in w:
                add_clock(w)
                i += 1
                continue
            qty = num(w)
            if i + 1 < len(words):
                if ":" in words[i + 1]:
                    # pg day-then-clock shorthand: '1 2:30' = 1 day 02:30
                    daysf += qty
                    i += 1
                    continue
                u = words[i + 1].lower().rstrip("s")
                if u not in _INTERVAL_UNITS:
                    raise ParseError(
                        f"unknown interval unit {words[i + 1]!r}"
                    )
                add(qty, u)
                i += 2
            else:
                msf += qty * 1_000  # bare number: seconds (pg)
                i += 1
    # spill fractional months -> days (30/month), days -> ms
    months = int(monthsf)
    daysf += (monthsf - months) * 30
    days = int(daysf)
    msf += (daysf - days) * 86_400_000
    return ast.IntervalLit(months, days, int(round(msf)))


def parse_statement(sql: str) -> ast.Statement:
    return Parser(sql).parse_statement()


def parse_query(sql: str) -> ast.Query:
    p = Parser(sql)
    q = p.parse_query()
    p.accept_sym(";")
    if p.peek().kind is not TokKind.EOF:
        raise ParseError(f"trailing input at {p.peek().pos}")
    return q
