"""Relational CSE + let normalization.

Analog of the reference's ``transform/src/cse/relation_cse.rs`` and
``transform/src/normalize_lets/mod.rs``: identical relational subplans
are bound once in ``Let``s so the render layer computes each shared
delta once (a Let binding renders a single time and every ``Get``
shares it — render/dataflow.py's Let case). The TPU angle is stronger
than the CPU one: a shared subplan is a shared fixed-shape device
program and a shared HBM arrangement, so CSE saves compile time and
device memory, not just work.

Differences from the reference: relation_cse there binds EVERY subtree
and lets NormalizeLets inline the single-use ones; here only subtrees
that occur >= 2 times are bound, which keeps single-occurrence plans
byte-identical through the transform (cheaper on the common path, and
EXPLAIN stays familiar).

The port's copy of ``materialize_tpu/transform/cse.py``: its relative imports reach the port's
``expr/`` and ``repr/``; it differs from the reference only where noted.
"""

from __future__ import annotations

import itertools

from ..expr import relation as mir
from .optimizer import _children_replaced


def _bound_names(e: mir.RelationExpr, out: set) -> None:
    if isinstance(e, mir.Let):
        out.add(e.name)
    if isinstance(e, mir.LetRec):
        out.update(e.names)
    for c in e.children():
        _bound_names(c, out)


def _count_gets(e: mir.RelationExpr, acc: dict) -> None:
    if isinstance(e, mir.Get):
        acc[e.name] = acc.get(e.name, 0) + 1
    for c in e.children():
        _count_gets(c, acc)


def _substitute(
    e: mir.RelationExpr, name: str, value: mir.RelationExpr
) -> mir.RelationExpr:
    """Replace Get(name) with value, honoring shadowing."""
    if isinstance(e, mir.Get):
        return value if e.name == name else e
    if isinstance(e, mir.Let) and e.name == name:
        # Inner binding shadows: substitute only in the value.
        return mir.Let(e.name, _substitute(e.value, name, value), e.body)
    if isinstance(e, mir.LetRec) and name in e.names:
        return e
    return _children_replaced(e, lambda c: _substitute(c, name, value))


def inline_lets(e: mir.RelationExpr) -> mir.RelationExpr:
    """Substitute every Let binding into its body: a let-free tree so
    CSE's structural equality sees through binding names. LetRec scopes
    are opaque (recursive references are not inlinable)."""
    if isinstance(e, mir.Let):
        value = inline_lets(e.value)
        body = inline_lets(e.body)
        return _substitute(body, e.name, value)
    if isinstance(e, mir.LetRec):
        return e
    return _children_replaced(e, inline_lets)


def normalize_lets(expr: mir.RelationExpr) -> mir.RelationExpr:
    """NormalizeLets: drop unused bindings, inline bindings referenced
    at most once or whose value is trivial (Get/Constant). Operates on
    the top-level Let chain (where relation_cse puts bindings)."""
    bindings: list = []
    e = expr
    while isinstance(e, mir.Let):
        bindings.append((e.name, e.value))
        e = e.body
    if not bindings:
        return expr
    body = e
    while True:
        acc: dict = {}
        for _, v in bindings:
            _count_gets(v, acc)
        _count_gets(body, acc)
        victim = None
        for i, (n, v) in enumerate(bindings):
            uses = acc.get(n, 0)
            if uses <= 1 or isinstance(v, (mir.Get, mir.Constant)):
                victim = (i, n, v, uses)
                break
        if victim is None:
            break
        i, n, v, uses = victim
        bindings.pop(i)
        if uses > 0:
            bindings = [
                (m, _substitute(w, n, v)) for m, w in bindings
            ]
            body = _substitute(body, n, v)
    out = body
    for n, v in reversed(bindings):
        out = mir.Let(n, v, out)
    return out


def _eligible(e: mir.RelationExpr, bound: set) -> bool:
    """A subtree is CSE-eligible if binding it saves work (not a bare
    leaf) and hoisting it to the top cannot capture a scoped name."""
    if isinstance(e, (mir.Get, mir.Constant, mir.ArrangeBy)):
        return False
    refs: dict = {}
    _count_gets(e, refs)
    return not (set(refs) & bound)


def relation_cse(expr: mir.RelationExpr) -> mir.RelationExpr:
    """Bind every relational subtree occurring >= 2 times in a Let, so
    the shared plan renders once (relation_cse.rs analog)."""
    expr = inline_lets(expr)
    bound: set = set()
    _bound_names(expr, bound)  # only LetRec names survive inlining

    counts: dict = {}

    def count(e):
        if not isinstance(e, mir.LetRec):  # recursive scopes opaque
            for c in e.children():
                count(c)
        counts[e] = counts.get(e, 0) + 1

    count(expr)
    if all(v < 2 for v in counts.values()):
        return expr

    # Fresh binding names: must not collide with catalog relations or
    # LetRec bindings referenced anywhere in the tree.
    used: dict = {}
    _count_gets(expr, used)
    taken = set(used) | bound
    seq = itertools.count()

    def fresh() -> str:
        while True:
            name = f"cse{next(seq)}"
            if name not in taken:
                return name

    bindings: list = []  # (name, value-with-Get-children), dep order
    by_key: dict = {}  # original subtree -> shared Get

    def rebuild(e):
        e2 = (
            e
            if isinstance(e, mir.LetRec)
            else _children_replaced(e, rebuild)
        )
        if counts.get(e, 0) >= 2 and _eligible(e, bound):
            got = by_key.get(e)
            if got is None:
                name = fresh()
                bindings.append((name, e2))
                got = mir.Get(name, e.schema())
                by_key[e] = got
            return got
        return e2

    body = rebuild(expr)
    out = body
    for name, value in reversed(bindings):
        out = mir.Let(name, value, out)
    return normalize_lets(out)
