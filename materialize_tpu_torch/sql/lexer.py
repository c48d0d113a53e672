"""SQL lexer.

Analog of the reference's ``sql-lexer`` crate (src/sql-lexer): a small,
hand-written tokenizer producing keyword/ident/literal/symbol tokens with
positions for error messages. Keywords are case-insensitive; identifiers
are lower-cased unless double-quoted (PostgreSQL rules, which the
reference follows).

The port's copy of ``materialize_tpu/sql/lexer.py``: its relative imports reach the port's
``expr/`` and ``repr/``; it differs from the reference only where noted.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass


class TokKind(enum.Enum):
    KEYWORD = "keyword"
    IDENT = "ident"
    NUMBER = "number"
    STRING = "string"
    SYMBOL = "symbol"
    EOF = "eof"


KEYWORDS = {
    "select", "from", "where", "group", "by", "having", "order", "limit",
    "offset", "asc", "desc", "nulls", "first", "last", "as", "on", "using",
    "join", "inner", "left", "right", "full", "outer", "cross", "and",
    "or", "not", "in", "exists", "between", "like", "ilike", "is", "null", "true",
    "false", "case", "when", "then", "else", "end", "cast", "distinct",
    "union", "all", "except", "intersect", "with", "recursive", "mutually",
    "create", "drop", "view", "materialized", "index", "source", "sink",
    "table", "cluster", "load", "generator", "for", "if", "replace",
    "explain", "plan", "raw", "decorrelated", "optimized", "physical",
    "analysis",
    "show", "insert", "into", "values", "subscribe", "count", "sum",
    "min", "max", "avg", "coalesce", "interval", "extract", "year",
    "default", "return", "at", "recursion", "tpch", "auction", "counter",
    "scale", "factor", "up", "to", "tick", "in", "columns", "of",
    "delete", "update", "set",
    "copy", "stdin", "stdout",
}

SYMBOLS = (
    "<=", ">=", "<>", "!=", "||", "::", "(", ")", ",", ";", ".", "+",
    "-", "*", "/", "%", "<", ">", "=",
)


@dataclass(frozen=True)
class Token:
    kind: TokKind
    text: str  # normalized: keywords/idents lower-cased
    pos: int   # byte offset for error messages

    def is_kw(self, kw: str) -> bool:
        return self.kind is TokKind.KEYWORD and self.text == kw


class LexError(ValueError):
    pass


def lex(sql: str) -> list[Token]:
    toks: list[Token] = []
    i, n = 0, len(sql)
    while i < n:
        c = sql[i]
        if c.isspace():
            i += 1
            continue
        if c == "-" and sql[i : i + 2] == "--":  # line comment
            j = sql.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if c == "/" and sql[i : i + 2] == "/*":  # block comment
            j = sql.find("*/", i)
            if j < 0:
                raise LexError(f"unterminated block comment at {i}")
            i = j + 2
            continue
        if c == "'":  # string literal, '' escapes a quote
            j = i + 1
            buf = []
            while True:
                if j >= n:
                    raise LexError(f"unterminated string at {i}")
                if sql[j] == "'":
                    if sql[j : j + 2] == "''":
                        buf.append("'")
                        j += 2
                        continue
                    break
                buf.append(sql[j])
                j += 1
            toks.append(Token(TokKind.STRING, "".join(buf), i))
            i = j + 1
            continue
        if c == '"':  # quoted identifier (case-preserving)
            j = sql.find('"', i + 1)
            if j < 0:
                raise LexError(f"unterminated quoted identifier at {i}")
            toks.append(Token(TokKind.IDENT, sql[i + 1 : j], i))
            i = j + 1
            continue
        if c.isdigit() or (
            c == "." and i + 1 < n and sql[i + 1].isdigit()
        ):
            j = i
            seen_dot = False
            while j < n and (sql[j].isdigit() or (sql[j] == "." and not seen_dot)):
                seen_dot = seen_dot or sql[j] == "."
                j += 1
            toks.append(Token(TokKind.NUMBER, sql[i:j], i))
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (sql[j].isalnum() or sql[j] == "_"):
                j += 1
            word = sql[i:j].lower()
            kind = TokKind.KEYWORD if word in KEYWORDS else TokKind.IDENT
            toks.append(Token(kind, word, i))
            i = j
            continue
        for sym in SYMBOLS:
            if sql.startswith(sym, i):
                toks.append(Token(TokKind.SYMBOL, sym, i))
                i += len(sym)
                break
        else:
            raise LexError(f"unexpected character {c!r} at {i}")
    toks.append(Token(TokKind.EOF, "", n))
    return toks
