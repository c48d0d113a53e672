"""MIR→MIR optimizer: a fixpoint pipeline of rewrite transforms.

Analog of the reference's ``transform`` crate ``Optimizer``
(transform/src/lib.rs:742; logical_optimizer :752, physical_optimizer
:822): each transform is a small pure rewrite run to fixpoint with an
iteration bound. The v1 set covers the transforms that matter most for
the TPU execution model (fewer operators = fewer kernels; narrower rows =
fewer sort lanes):

- FuseFilters / FuseProjects / FuseMaps  (transform/src/fusion)
- PredicatePushdown                      (transform/src/predicate_pushdown.rs)
- FoldConstants: trivial predicate elimination
- ThresholdElision: Threshold over provably-nonnegative input
- JoinImplementation: linear vs delta    (transform/src/join_implementation.rs)

The port's copy of ``materialize_tpu/transform/optimizer.py``: its relative imports reach the port's
``expr/`` and ``repr/``; it differs from the reference only where noted.
"""

from __future__ import annotations

from dataclasses import replace

from ..expr import relation as mir
from ..expr import scalar as ms
from ..expr.relation import AggregateExpr, AggregateFunc
from ..repr.schema import ColumnType


def _children_replaced(expr: mir.RelationExpr, f):
    """Rebuild expr with f applied to every relational child."""
    if isinstance(expr, mir.Project):
        return mir.Project(f(expr.input), expr.outputs)
    if isinstance(expr, mir.Map):
        return mir.Map(f(expr.input), expr.scalars)
    if isinstance(expr, mir.Filter):
        return mir.Filter(f(expr.input), expr.predicates)
    if isinstance(expr, mir.FlatMap):
        return mir.FlatMap(
            f(expr.input), expr.func, expr.exprs, expr.output_cols
        )
    if isinstance(expr, mir.Join):
        return mir.Join(
            tuple(f(i) for i in expr.inputs),
            expr.equivalences,
            expr.implementation,
        )
    if isinstance(expr, mir.Reduce):
        return mir.Reduce(f(expr.input), expr.group_key, expr.aggregates)
    if isinstance(expr, mir.TopK):
        return mir.TopK(
            f(expr.input), expr.group_key, expr.order_by, expr.limit,
            expr.offset,
        )
    if isinstance(expr, mir.Negate):
        return mir.Negate(f(expr.input))
    if isinstance(expr, mir.Threshold):
        return mir.Threshold(f(expr.input))
    if isinstance(expr, mir.Union):
        return mir.Union(tuple(f(i) for i in expr.inputs))
    if isinstance(expr, mir.ArrangeBy):
        return mir.ArrangeBy(f(expr.input), expr.key)
    if isinstance(expr, mir.Let):
        return mir.Let(expr.name, f(expr.value), f(expr.body))
    if isinstance(expr, mir.LetRec):
        return mir.LetRec(
            expr.names,
            tuple(f(v) for v in expr.values),
            expr.value_schemas,
            f(expr.body),
            expr.max_iters,
        )
    return expr  # Get, Constant


def _bottom_up(expr, rewrite):
    expr = _children_replaced(expr, lambda c: _bottom_up(c, rewrite))
    return rewrite(expr)


# -- transforms --------------------------------------------------------------


def fuse(expr: mir.RelationExpr) -> mir.RelationExpr:
    """Filter∘Filter, Project∘Project, Map∘Map fusion
    (transform/src/fusion/{filter,project,map}.rs)."""

    def rw(e):
        if isinstance(e, mir.Filter) and isinstance(e.input, mir.Filter):
            return mir.Filter(
                e.input.input, e.input.predicates + e.predicates
            )
        if isinstance(e, mir.Project) and isinstance(e.input, mir.Project):
            inner = e.input
            return mir.Project(
                inner.input, tuple(inner.outputs[i] for i in e.outputs)
            )
        if isinstance(e, mir.Map) and isinstance(e.input, mir.Map):
            inner = e.input
            return mir.Map(inner.input, inner.scalars + e.scalars)
        if isinstance(e, mir.Project) and e.outputs == tuple(
            range(e.input.schema().arity)
        ):
            return e.input  # identity project
        return e

    return _bottom_up(expr, rw)


def _shift_scalar(e: ms.ScalarExpr, mapping: dict) -> ms.ScalarExpr | None:
    """Remap column references; None if any ref is unmapped."""
    if isinstance(e, ms.ColumnRef):
        if e.index not in mapping:
            return None
        return ms.ColumnRef(mapping[e.index])
    if isinstance(e, (ms.Literal, ms.MzNow)):
        return e
    if isinstance(e, ms.CallUnary):
        inner = _shift_scalar(e.expr, mapping)
        return None if inner is None else ms.CallUnary(e.func, inner)
    if isinstance(e, ms.CallBinary):
        l = _shift_scalar(e.left, mapping)
        r = _shift_scalar(e.right, mapping)
        if l is None or r is None:
            return None
        return ms.CallBinary(e.func, l, r)
    if isinstance(e, ms.CallVariadic):
        parts = [_shift_scalar(x, mapping) for x in e.exprs]
        if any(p is None for p in parts):
            return None
        return ms.CallVariadic(e.func, parts)
    if isinstance(e, ms.If):
        c = _shift_scalar(e.cond, mapping)
        t = _shift_scalar(e.then, mapping)
        f = _shift_scalar(e.els, mapping)
        if c is None or t is None or f is None:
            return None
        return ms.If(c, t, f)
    return None


def _refs(e: ms.ScalarExpr, out: set) -> None:
    if isinstance(e, ms.ColumnRef):
        out.add(e.index)
    elif isinstance(e, ms.CallUnary):
        _refs(e.expr, out)
    elif isinstance(e, ms.CallBinary):
        _refs(e.left, out)
        _refs(e.right, out)
    elif isinstance(e, ms.CallVariadic):
        for x in e.exprs:
            _refs(x, out)
    elif isinstance(e, ms.If):
        _refs(e.cond, out)
        _refs(e.then, out)
        _refs(e.els, out)


def predicate_pushdown(expr: mir.RelationExpr) -> mir.RelationExpr:
    """Push Filters toward sources (transform/src/predicate_pushdown.rs):
    through Project/Map (when refs stay within the inner columns), into
    Union branches, and into the owning input of a Join."""

    def rw(e):
        if not isinstance(e, mir.Filter):
            return e
        inp = e.input
        if isinstance(inp, mir.Project):
            mapping = {
                pos: src for pos, src in enumerate(inp.outputs)
            }
            shifted = [
                _shift_scalar(p, mapping) for p in e.predicates
            ]
            if all(s is not None for s in shifted):
                return mir.Project(
                    mir.Filter(inp.input, tuple(shifted)), inp.outputs
                )
        if isinstance(inp, mir.Map):
            base = inp.input.schema().arity
            inner_preds, kept = [], []
            ident = {i: i for i in range(base)}
            for p in e.predicates:
                s = _shift_scalar(p, ident)
                (inner_preds if s is not None else kept).append(
                    s if s is not None else p
                )
            if inner_preds:
                new = mir.Map(
                    mir.Filter(inp.input, tuple(inner_preds)), inp.scalars
                )
                return mir.Filter(new, tuple(kept)) if kept else new
        if isinstance(inp, mir.Union):
            return mir.Union(
                tuple(mir.Filter(i, e.predicates) for i in inp.inputs)
            )
        if isinstance(inp, mir.Negate):
            return mir.Negate(mir.Filter(inp.input, e.predicates))
        if isinstance(inp, mir.Join):
            offsets = [0]
            for i in inp.inputs:
                offsets.append(offsets[-1] + i.schema().arity)

            def input_of(r: int) -> int:
                for k in range(len(inp.inputs)):
                    if offsets[k] <= r < offsets[k + 1]:
                        return k
                raise AssertionError(r)

            def in_equivs(equivs, a: int, b: int) -> bool:
                for cls in equivs:
                    idxs = {
                        c.index
                        for c in cls
                        if isinstance(c, ms.ColumnRef)
                    }
                    if a in idxs and b in idxs:
                        return True
                return False

            per_input: list = [[] for _ in inp.inputs]
            kept = []
            new_equivs = list(inp.equivalences)
            for p in e.predicates:
                refs: set = set()
                _refs(p, refs)
                homes = [
                    k
                    for k in range(len(inp.inputs))
                    if refs and all(
                        offsets[k] <= r < offsets[k + 1] for r in refs
                    )
                ]
                if homes:
                    k = homes[0]
                    shifted = _shift_scalar(
                        p, {r: r - offsets[k] for r in refs}
                    )
                    if shifted is None:
                        kept.append(p)  # unpushable: keep at the join
                    else:
                        per_input[k].append(shifted)
                    continue
                # Cross-input column equality: lift into the join's
                # equivalences so it becomes a JOIN KEY instead of a
                # post-cross-product filter (the reference folds these
                # during PredicatePushdown/equivalence extraction;
                # decorrelation's keys⋈branch joins depend on it — a
                # cross join of outer keys × subquery input explodes).
                # SQL EQ and join-key equality agree: both drop NULLs.
                if (
                    isinstance(p, ms.CallBinary)
                    and p.func is ms.BinaryFunc.EQ
                    and isinstance(p.left, ms.ColumnRef)
                    and isinstance(p.right, ms.ColumnRef)
                    and input_of(p.left.index) != input_of(p.right.index)
                ):
                    a, b = sorted((p.left.index, p.right.index))
                    if not in_equivs(new_equivs, a, b):
                        new_equivs.append(
                            (ms.ColumnRef(a), ms.ColumnRef(b))
                        )
                        continue
                    # already implied: drop the predicate
                    continue
                kept.append(p)
            if any(per_input) or len(new_equivs) != len(
                inp.equivalences
            ) or len(kept) != len(e.predicates):
                new_inputs = tuple(
                    mir.Filter(i, tuple(ps)) if ps else i
                    for i, ps in zip(inp.inputs, per_input)
                )
                new = mir.Join(
                    new_inputs, tuple(new_equivs), inp.implementation
                )
                return mir.Filter(new, tuple(kept)) if kept else new
        return e

    return _bottom_up(expr, rw)


def _fold_scalar(e: ms.ScalarExpr) -> ms.ScalarExpr:
    """Evaluate literal-only scalar subtrees host-side (FoldConstants'
    scalar interpreter, transform/src/fold_constants.rs). Conservative:
    only operators with obvious host semantics fold; everything else is
    rebuilt with folded children."""
    if isinstance(e, ms.CallUnary):
        x = _fold_scalar(e.expr)
        if isinstance(x, ms.Literal):
            if x.value is None:
                if e.func == ms.UnaryFunc.IS_NULL:
                    return ms.Literal(True, ColumnType.BOOL)
                if e.func in (ms.UnaryFunc.NOT, ms.UnaryFunc.NEG):
                    return ms.Literal(None, x.ctype, x.scale)
            elif e.func == ms.UnaryFunc.NOT and isinstance(x.value, bool):
                return ms.Literal(not x.value, ColumnType.BOOL)
            elif e.func == ms.UnaryFunc.IS_NULL:
                return ms.Literal(False, ColumnType.BOOL)
            elif e.func == ms.UnaryFunc.NEG and isinstance(
                x.value, (int, float)
            ):
                return ms.Literal(-x.value, x.ctype, x.scale)
        return ms.CallUnary(e.func, x)
    if isinstance(e, ms.CallBinary):
        l, r = _fold_scalar(e.left), _fold_scalar(e.right)
        if isinstance(l, ms.Literal) and isinstance(r, ms.Literal):
            lv, rv = l.value, r.value
            f = e.func
            cmp = {
                ms.BinaryFunc.EQ: lambda a, b: a == b,
                ms.BinaryFunc.NEQ: lambda a, b: a != b,
                ms.BinaryFunc.LT: lambda a, b: a < b,
                ms.BinaryFunc.LTE: lambda a, b: a <= b,
                ms.BinaryFunc.GT: lambda a, b: a > b,
                ms.BinaryFunc.GTE: lambda a, b: a >= b,
            }
            if f in cmp:
                if lv is None or rv is None:
                    return ms.Literal(None, ColumnType.BOOL)
                if l.scale == r.scale and not isinstance(lv, str):
                    return ms.Literal(
                        bool(cmp[f](lv, rv)), ColumnType.BOOL
                    )
            arith = {
                ms.BinaryFunc.ADD: lambda a, b: a + b,
                ms.BinaryFunc.SUB: lambda a, b: a - b,
                ms.BinaryFunc.MUL: lambda a, b: a * b,
            }
            # Fold only when the result type is unambiguous (equal
            # operand ctypes): typing the fold by one side's ctype
            # would silently change the expression's schema when
            # operand types differ (mixed int/float, int32/int64).
            if (
                f in arith
                and l.ctype == r.ctype
                and isinstance(lv, int)
                and not isinstance(lv, bool)
                and isinstance(rv, int)
                and not isinstance(rv, bool)
                and l.scale == 0
                and r.scale == 0
            ):
                # Wrap to int64 so folded constants match the device's
                # wrapping arithmetic (unbounded Python ints would
                # diverge on overflow, and could not materialize).
                v = arith[f](lv, rv)
                if l.ctype is ColumnType.INT32:
                    v = ((v + (1 << 31)) % (1 << 32)) - (1 << 31)
                elif l.ctype is not ColumnType.FLOAT64:
                    v = ((v + (1 << 63)) % (1 << 64)) - (1 << 63)
                return ms.Literal(v, l.ctype)
            if (
                f in arith
                and l.ctype == r.ctype
                and l.scale == r.scale
                and (lv is None or rv is None)
            ):
                return ms.Literal(None, l.ctype, l.scale)
        return ms.CallBinary(e.func, l, r)
    if isinstance(e, ms.CallVariadic):
        parts = [_fold_scalar(x) for x in e.exprs]
        if e.func == ms.VariadicFunc.AND:
            if any(
                isinstance(p, ms.Literal) and p.value is False
                for p in parts
            ):
                return ms.Literal(False, ColumnType.BOOL)
            parts = [
                p
                for p in parts
                if not (isinstance(p, ms.Literal) and p.value is True)
            ]
            if not parts:
                return ms.Literal(True, ColumnType.BOOL)
            if len(parts) == 1:
                return parts[0]
        elif e.func == ms.VariadicFunc.OR:
            if any(
                isinstance(p, ms.Literal) and p.value is True
                for p in parts
            ):
                return ms.Literal(True, ColumnType.BOOL)
            parts = [
                p
                for p in parts
                if not (isinstance(p, ms.Literal) and p.value is False)
            ]
            if not parts:
                return ms.Literal(False, ColumnType.BOOL)
            if len(parts) == 1:
                return parts[0]
        elif e.func == ms.VariadicFunc.COALESCE:
            out = []
            for p in parts:
                if isinstance(p, ms.Literal) and p.value is None:
                    continue
                out.append(p)
                if isinstance(p, ms.Literal):
                    break  # later args unreachable
            if not out:
                return parts[0] if parts else e
            if len(out) == 1:
                return out[0]
            parts = out
        return ms.CallVariadic(e.func, parts)
    if isinstance(e, ms.If):
        c = _fold_scalar(e.cond)
        t, f = _fold_scalar(e.then), _fold_scalar(e.els)
        if isinstance(c, ms.Literal):
            if c.value is True:
                return t
            return f  # False and NULL both take the else branch
        return ms.If(c, t, f)
    return e


def fold_constants(expr: mir.RelationExpr) -> mir.RelationExpr:
    """Fold literal scalar subtrees; drop literal-TRUE predicates; empty
    out literal-FALSE/NULL filters (FoldConstants,
    transform/src/fold_constants.rs — value-level subset)."""

    def rw(e):
        if isinstance(e, mir.Map) and e.scalars:
            folded = tuple(_fold_scalar(s) for s in e.scalars)
            if folded != e.scalars:
                return mir.Map(e.input, folded)
            return e
        if isinstance(e, mir.Filter):
            preds = []
            for p in e.predicates:
                p = _fold_scalar(p)
                if isinstance(p, ms.Literal):
                    if p.value is True:
                        continue
                    # False or NULL: no row passes.
                    return mir.Constant((), e.schema())
                preds.append(p)
            if not preds:
                return e.input
            if tuple(preds) != e.predicates:
                return mir.Filter(e.input, tuple(preds))
            return e
        return e

    return _bottom_up(expr, rw)


def column_knowledge(expr: mir.RelationExpr) -> mir.RelationExpr:
    """ColumnKnowledge (transform/src/column_knowledge.rs), narrow form:
    per-column non-nullability derived from schemas and filters folds
    IS_NULL(col) -> false and unwraps COALESCE whose first argument is
    known non-null. (Constant-value propagation is left to
    fold_constants + literal Maps.)"""

    def simplify(s: ms.ScalarExpr, sch) -> ms.ScalarExpr:
        if isinstance(s, ms.CallUnary):
            inner = simplify(s.expr, sch)
            if (
                s.func == ms.UnaryFunc.IS_NULL
                and isinstance(inner, ms.ColumnRef)
                and not sch[inner.index].nullable
            ):
                return ms.Literal(False, ColumnType.BOOL)
            return ms.CallUnary(s.func, inner)
        if isinstance(s, ms.CallBinary):
            return ms.CallBinary(
                s.func, simplify(s.left, sch), simplify(s.right, sch)
            )
        if isinstance(s, ms.CallVariadic):
            parts = [simplify(x, sch) for x in s.exprs]
            if s.func == ms.VariadicFunc.COALESCE and parts:
                first = parts[0]
                if (
                    isinstance(first, ms.ColumnRef)
                    and not sch[first.index].nullable
                ) or (
                    isinstance(first, ms.Literal)
                    and first.value is not None
                ):
                    return first
            return ms.CallVariadic(s.func, parts)
        if isinstance(s, ms.If):
            return ms.If(
                simplify(s.cond, sch),
                simplify(s.then, sch),
                simplify(s.els, sch),
            )
        return s

    def rw(e):
        if isinstance(e, mir.Filter):
            sch = e.input.schema()
            preds = tuple(simplify(p, sch) for p in e.predicates)
            if preds != e.predicates:
                return mir.Filter(e.input, preds)
        if isinstance(e, mir.Map):
            sch = e.input.schema()
            # Simplify against the progressively extended schema (later
            # scalars may reference earlier ones).
            scalars = []
            ext = list(sch.columns)
            from ..repr.schema import Column as _Column
            from ..repr.schema import Schema as _Schema

            changed = False
            for s in e.scalars:
                s2 = simplify(s, _Schema(tuple(ext)))
                changed = changed or (s2 != s)
                scalars.append(s2)
                c = s2.typ(_Schema(tuple(ext)))
                ext.append(
                    _Column(
                        f"c{len(ext)}", c.ctype, c.nullable, c.scale
                    )
                )
            if changed:
                return mir.Map(e.input, tuple(scalars))
        return e

    return _bottom_up(expr, rw)


def threshold_elision(expr: mir.RelationExpr) -> mir.RelationExpr:
    """Remove Threshold over inputs that cannot go negative
    (transform/src/threshold_elision.rs), using the monotonicity
    lattice (analysis/monotonic.py). Facts flow through Let/LetRec via
    an environment, so a ``Get`` of a binding whose value contains a
    ``Negate`` is correctly NOT assumed non-negative (the unsoundness
    the previous ad-hoc closure had; regression in
    tests/test_analysis_typecheck.py)."""
    from ..analysis.monotonic import analyze

    def go(e, env):
        if isinstance(e, mir.Threshold):
            inner = go(e.input, env)
            if analyze(inner, env=env).nonneg:
                return inner
            return mir.Threshold(inner)
        if isinstance(e, mir.Let):
            value = go(e.value, env)
            env2 = dict(env)
            env2[e.name] = analyze(value, env=env)
            return mir.Let(e.name, value, go(e.body, env2))
        if isinstance(e, mir.LetRec):
            from ..analysis.monotonic import BOTTOM

            env2 = dict(env)
            for n in e.names:
                env2[n] = BOTTOM
            return mir.LetRec(
                e.names,
                tuple(go(v, env2) for v in e.values),
                e.value_schemas,
                go(e.body, env2),
                e.max_iters,
            )
        return _children_replaced(e, lambda c: go(c, env))

    return go(expr, {})


def join_implementation(expr: mir.RelationExpr) -> mir.RelationExpr:
    """Resolve implementation="auto" (JoinImplementation analog): delta
    for 3+ inputs (no intermediate arrangements — delta_join.rs:10-12),
    linear for binary joins."""

    def rw(e):
        if isinstance(e, mir.Join) and e.implementation == "auto":
            impl = "delta" if len(e.inputs) >= 3 else "linear"
            return mir.Join(e.inputs, e.equivalences, impl)
        return e

    return _bottom_up(expr, rw)


def plan_distinct_aggregates(expr: mir.RelationExpr) -> mir.RelationExpr:
    """Rewrite Reduce nodes containing DISTINCT aggregates into a join of
    plain reduces (the reference plans distinct aggs via per-aggregate
    Distinct stages, compute-types/src/plan/reduce.rs; here the rewrite
    happens MIR->MIR so the render layer never sees a distinct flag):

        Reduce(R, K, [..nd.., agg_d(e) DISTINCT])
     => Project(Join(
            Reduce(R', K', nd),                       -- nd reduce
            Reduce(Distinct(Project(R', K'+[e])), K', [agg_d(e)]),
            on K'), restore-order)

    K' is a null-safe key encoding: a nullable key column k becomes
    (coalesce(k, 0), is_null(k)) so NULL-key groups survive the join
    (the device equijoin drops NULL keys, ops/join.py null_key_diffs);
    the original key value is re-derived afterwards. NULL values of e
    stay in the distinct set; downstream aggregates skip NULLs (the
    accumulator masks, ops/reduce.py delta_contributions)."""

    def rw(e):
        if not isinstance(e, mir.Reduce):
            return e
        if not any(a.distinct for a in e.aggregates):
            return e
        aggs = [
            AggregateExpr(a.func, a.expr, False, a.params)
            if a.distinct
            and a.func in (AggregateFunc.MIN, AggregateFunc.MAX)
            else a
            for a in e.aggregates
        ]
        if not any(a.distinct for a in aggs):
            return mir.Reduce(e.input, e.group_key, tuple(aggs))

        inp = e.input
        in_schema = inp.schema()
        arity = in_schema.arity

        # 1. null-safe key encoding appended via one Map
        scalars = []
        key_exprs: list[tuple] = []  # per original key: encoded col idxs
        decode: list = []  # scalar exprs over the joined K' to recover keys
        kp = 0  # position within K'
        for ki in e.group_key:
            c = in_schema[ki]
            if c.nullable:
                zero = ms.Literal(
                    False if c.ctype is ColumnType.BOOL else 0,
                    c.ctype,
                    c.scale,
                )
                scalars.append(
                    ms.CallVariadic(
                        ms.VariadicFunc.COALESCE, (ms.ColumnRef(ki), zero)
                    )
                )
                scalars.append(
                    ms.CallUnary(ms.UnaryFunc.IS_NULL, ms.ColumnRef(ki))
                )
                v_idx = arity + len(scalars) - 2
                n_idx = arity + len(scalars) - 1
                key_exprs.append((v_idx, n_idx))
                decode.append(
                    ms.If(
                        ms.ColumnRef(kp + 1),
                        ms.Literal(None, c.ctype, c.scale),
                        ms.ColumnRef(kp),
                    )
                )
                kp += 2
            else:
                key_exprs.append((ki,))
                decode.append(ms.ColumnRef(kp))
                kp += 1
        enc = mir.Map(inp, tuple(scalars)) if scalars else inp
        kprime = tuple(i for ks in key_exprs for i in ks)
        nk = len(kprime)

        # 2. partition aggregates (tracking original positions)
        nd = [(p, a) for p, a in enumerate(aggs) if not a.distinct]
        d_groups: list[tuple] = []  # (expr, [(pos, agg)...]) structural
        for p, a in enumerate(aggs):
            if not a.distinct:
                continue
            for ge, lst in d_groups:
                if ge == a.expr:
                    lst.append((p, a))
                    break
            else:
                d_groups.append((a.expr, [(p, a)]))

        parts = []  # (relation, [original agg positions])
        if nd:
            parts.append(
                (
                    mir.Reduce(enc, kprime, tuple(a for _, a in nd)),
                    [p for p, _ in nd],
                )
            )
        enc_arity = enc.schema().arity
        for ge, lst in d_groups:
            with_e = mir.Map(enc, (ge,))
            dedup = mir.Reduce(
                mir.Project(with_e, kprime + (enc_arity,)),
                tuple(range(nk + 1)),
                (),
            )
            red = mir.Reduce(
                dedup,
                tuple(range(nk)),
                tuple(
                    AggregateExpr(
                        a.func, ms.ColumnRef(nk), False, a.params
                    )
                    for _, a in lst
                ),
            )
            parts.append((red, [p for p, _ in lst]))

        if len(parts) == 1:
            joined, layout = parts[0]
            base = nk
            positions = {p: base + i for i, p in enumerate(layout)}
        else:
            # equi-join all parts on K' (each part's first nk columns)
            offs, cols_so_far, inputs = [], 0, []
            for rel, _ in parts:
                offs.append(cols_so_far)
                cols_so_far += rel.schema().arity
                inputs.append(rel)
            equivs = tuple(
                tuple(
                    ms.ColumnRef(off + j) for off in offs
                )
                for j in range(nk)
            )
            joined = mir.Join(tuple(inputs), equivs)
            positions = {}
            for (rel, layout), off in zip(parts, offs):
                for i, p in enumerate(layout):
                    positions[p] = off + nk + i
        # 3. restore output order: decoded keys, then aggregates
        out_scalars = tuple(decode) + tuple(
            ms.ColumnRef(positions[p]) for p in range(len(aggs))
        )
        jarity = joined.schema().arity
        return mir.Project(
            mir.Map(joined, out_scalars),
            tuple(range(jarity, jarity + len(out_scalars))),
        )

    return _bottom_up(expr, rw)


def _lit_class_unsat(lits) -> bool:
    """True when an equivalence class of literals cannot be satisfied:
    any NULL member (SQL NULL = x is never true, so the join is empty —
    NOT a cross product) or two numerically distinct values. Decimal
    literals compare by scaled value so 1.50 (scale 2) == 1.5 (scale 1);
    string literals compare by dictionary code (code equality == string
    equality)."""
    from fractions import Fraction

    if any(l.value is None for l in lits):
        return True

    def norm(l):
        if l.scale:
            return Fraction(int(l.value), 10**l.scale)
        return l.value

    first = norm(lits[0])
    return any(norm(l) != first for l in lits[1:])


def canonicalize_join_equivalences(
    expr: mir.RelationExpr,
) -> mir.RelationExpr:
    """Normalize Join equivalence classes so every class is consumable
    as a cross-input join key (the JoinImplementation precondition the
    render layer asserts; transform/src/canonicalization +
    equivalence_propagation.rs):

    - two members in the SAME input -> a local Filter on that input
      (col_a = col_b), keeping one representative;
    - a literal member -> a local Filter (col = lit) on every input
      owning a column member, dropping the literal from the class;
    - classes left with < 2 members are dropped (their constraint now
      lives in Filters).
    """

    def rw(e):
        if not isinstance(e, mir.Join):
            return e
        offsets = [0]
        for i in e.inputs:
            offsets.append(offsets[-1] + i.schema().arity)

        def owner(g: int) -> int:
            for j in range(len(e.inputs)):
                if offsets[j] <= g < offsets[j + 1]:
                    return j
            raise IndexError(g)

        per_input_filters: list = [[] for _ in e.inputs]
        new_classes = []
        changed = False
        for cls in e.equivalences:
            if not all(
                isinstance(m, (ms.ColumnRef, ms.Literal)) for m in cls
            ):
                # Non-column members: leave the class untouched (the
                # planner handles what it can; no silent constraint loss).
                new_classes.append(cls)
                continue
            cols: dict = {}  # input -> representative local ColumnRef
            lits: list = []
            for m in cls:
                if isinstance(m, ms.ColumnRef):
                    j = owner(m.index)
                    local = ms.ColumnRef(m.index - offsets[j])
                    if j in cols:
                        # intra-input equality -> local filter
                        per_input_filters[j].append(
                            ms.CallBinary(ms.BinaryFunc.EQ, cols[j], local)
                        )
                        changed = True
                    else:
                        cols[j] = local
                else:
                    lits.append(m)
            if lits:
                # col = literal: a local filter on every owning input;
                # the class collapses entirely (all members equal the
                # literal, transitively local).
                if _lit_class_unsat(lits):
                    return mir.Constant((), e.schema())  # unsatisfiable
                lit = lits[0]
                changed = True
                for j, local in cols.items():
                    per_input_filters[j].append(
                        ms.CallBinary(ms.BinaryFunc.EQ, local, lit)
                    )
                continue
            if len(cols) >= 2:
                kept = tuple(
                    ms.ColumnRef(c.index + offsets[j])
                    for j, c in sorted(cols.items())
                )
                if len(kept) != len(cls):
                    changed = True
                new_classes.append(kept)
            else:
                changed = True  # class fully collapsed into filters
        if not changed:
            return e
        new_inputs = tuple(
            mir.Filter(i, tuple(ps)) if ps else i
            for i, ps in zip(e.inputs, per_input_filters)
        )
        return mir.Join(
            new_inputs, tuple(new_classes), e.implementation
        )

    return _bottom_up(expr, rw)


def union_cancel(expr: mir.RelationExpr) -> mir.RelationExpr:
    """UnionBranchCancellation + trivial-branch elision
    (transform/src/union_cancel.rs): A ∪ Negate(A) cancels; empty
    Constant branches vanish; a one-branch Union is its branch."""

    def is_empty(b) -> bool:
        return isinstance(b, mir.Constant) and not b.rows

    def rw(e):
        if not isinstance(e, mir.Union):
            return e
        branches = list(e.inputs)
        # cancel A with Negate(A) pairwise
        used = [True] * len(branches)
        for a in range(len(branches)):
            if not used[a]:
                continue
            for b in range(a + 1, len(branches)):
                if not used[b]:
                    continue
                x, y = branches[a], branches[b]
                if (
                    isinstance(y, mir.Negate) and y.input == x
                ) or (
                    isinstance(x, mir.Negate) and x.input == y
                ):
                    used[a] = used[b] = False
                    break
        kept = [
            b for b, u in zip(branches, used) if u and not is_empty(b)
        ]
        if len(kept) == len(branches):
            return e
        if not kept:
            return mir.Constant((), e.schema())
        if len(kept) == 1:
            return kept[0]
        return mir.Union(tuple(kept))

    return _bottom_up(expr, rw)


def reduce_elision(expr: mir.RelationExpr) -> mir.RelationExpr:
    """ReduceElision (transform/src/reduce_elision.rs), narrow form:
    a Distinct (Reduce with no aggregates) whose input is already
    distinct on the same key — e.g. another Reduce keyed identically —
    is the identity."""

    def distinct_on(e, key: tuple) -> bool:
        if isinstance(e, mir.Reduce):
            return tuple(range(len(e.group_key))) == key or (
                key == tuple(range(e.schema().arity))
            )
        return False

    def rw(e):
        if (
            isinstance(e, mir.Reduce)
            and not e.aggregates
            and distinct_on(e.input, e.group_key)
            and e.group_key == tuple(range(e.input.schema().arity))
        ):
            return e.input
        return e

    return _bottom_up(expr, rw)


def redundant_join(expr: mir.RelationExpr) -> mir.RelationExpr:
    """RedundantJoin (transform/src/redundant_join.rs), narrow form:
    eliminate single-row Constant inputs from a join — the shape
    decorrelated scalar subqueries and literal-lifted inputs produce.
    The constant's columns become Map literals; equivalences touching
    them become Filters."""

    def rw(e):
        if not isinstance(e, mir.Join) or len(e.inputs) < 2:
            return e
        offsets = [0]
        for i in e.inputs:
            offsets.append(offsets[-1] + i.schema().arity)
        victim = None
        for j, inp in enumerate(e.inputs):
            if (
                isinstance(inp, mir.Constant)
                and len(inp.rows) == 1
                and inp.rows[0][1] == 1
            ):
                victim = j
                break
        if victim is None:
            return e
        vals, _d = e.inputs[victim].rows[0]
        vschema = e.inputs[victim].schema()
        lo, hi = offsets[victim], offsets[victim + 1]

        def lit_for(g: int) -> ms.Literal:
            c = vschema[g - lo]
            return ms.Literal(vals[g - lo], c.ctype, c.scale)

        rest = [i for j, i in enumerate(e.inputs) if j != victim]
        # Global remap: columns after the victim shift left; victim
        # columns become appended Map literals at the end.
        rest_arity = offsets[-1] - (hi - lo)
        mapping = {}
        for g in range(offsets[-1]):
            if g < lo:
                mapping[g] = g
            elif g >= hi:
                mapping[g] = g - (hi - lo)
            else:
                mapping[g] = rest_arity + (g - lo)
        filters = []
        new_equivs = []
        for cls in e.equivalences:
            kept_members = []
            lit_members = []
            for m in cls:
                if isinstance(m, ms.ColumnRef) and lo <= m.index < hi:
                    lit_members.append(lit_for(m.index))
                else:
                    kept_members.append(m)
            if lit_members and _lit_class_unsat(lit_members):
                # A class whose victim-constant members are NULL or
                # mutually distinct can never be satisfied: the join is
                # empty, not unconstrained.
                return mir.Constant((), e.schema())
            if lit_members and kept_members:
                for m in kept_members:
                    shifted = _shift_scalar(m, mapping)
                    if shifted is None:
                        return e  # give up, keep original join
                    filters.append(
                        ms.CallBinary(
                            ms.BinaryFunc.EQ, shifted, lit_members[0]
                        )
                    )
            elif len(kept_members) >= 2:
                shifted = [
                    _shift_scalar(m, mapping) for m in kept_members
                ]
                if any(s is None for s in shifted):
                    return e
                new_equivs.append(tuple(shifted))
        if len(rest) == 1:
            base = rest[0]
        else:
            base = mir.Join(tuple(rest), tuple(new_equivs),
                            e.implementation)
            new_equivs = []
        if new_equivs:
            return e  # single remaining input can't host equivalences
        out = mir.Map(
            base, tuple(lit_for(g) for g in range(lo, hi))
        )
        if filters:
            out = mir.Filter(out, tuple(filters))
        # Restore the original column order.
        out = mir.Project(
            out, tuple(mapping[g] for g in range(offsets[-1]))
        )
        return out

    return _bottom_up(expr, rw)


def projection_pushdown(expr: mir.RelationExpr) -> mir.RelationExpr:
    """Demand / ProjectionPushdown
    (transform/src/movement/projection_pushdown.rs, demand.rs): move
    column pruning toward sources so arrangements and exchanges carry
    only live columns. On TPU this is a first-order win: row width =
    sort-lane count = HBM traffic per merge/probe.

    Multiset-correct everywhere it fires: Project sums multiplicities of
    rows that collapse, which is exactly SQL projection; it is NOT
    pushed through row-identity-sensitive operators (Threshold, TopK,
    FlatMap)."""

    def out_refs(outputs) -> set:
        return set(outputs)

    def rw(e):
        # Demand from Reduce: prune its input to key + aggregate refs.
        if isinstance(e, mir.Reduce):
            arity = e.input.schema().arity
            needed: set = set(e.group_key)
            for a in e.aggregates:
                _refs(a.expr, needed)
            if not needed:
                # Zero-column relations are not representable on device
                # (a Batch needs >=1 column); keep one.
                needed = {0}
            if len(needed) < arity:
                keep = sorted(needed)
                remap = {src: i for i, src in enumerate(keep)}
                aggs = []
                ok = True
                for a in e.aggregates:
                    sh = _shift_scalar(a.expr, remap)
                    if sh is None:
                        ok = False
                        break
                    aggs.append(
                        AggregateExpr(a.func, sh, a.distinct, a.params)
                    )
                if ok:
                    return mir.Reduce(
                        mir.Project(e.input, tuple(keep)),
                        tuple(remap[k] for k in e.group_key),
                        tuple(aggs),
                    )
            return e
        if not isinstance(e, mir.Project):
            return e
        inp, outputs = e.input, e.outputs
        arity = inp.schema().arity

        if isinstance(inp, mir.Constant):
            rows = tuple(
                (tuple(vals[i] for i in outputs), d)
                for vals, d in inp.rows
            )
            return mir.Constant(rows, e.schema())

        if isinstance(inp, mir.Negate):
            return mir.Negate(mir.Project(inp.input, outputs))

        if isinstance(inp, mir.Union):
            if len(set(outputs)) < arity:
                return mir.Union(
                    tuple(
                        mir.Project(b, outputs) for b in inp.inputs
                    )
                )
            return e

        if isinstance(inp, mir.Filter):
            needed: set = out_refs(outputs)
            for p in inp.predicates:
                _refs(p, needed)
            if not needed:
                needed = {0}
            if len(needed) < arity:
                keep = sorted(needed)
                remap = {src: i for i, src in enumerate(keep)}
                preds = tuple(
                    _shift_scalar(p, remap) for p in inp.predicates
                )
                if all(p is not None for p in preds):
                    return mir.Project(
                        mir.Filter(
                            mir.Project(inp.input, tuple(keep)), preds
                        ),
                        tuple(remap[o] for o in outputs),
                    )
            return e

        if isinstance(inp, mir.Map):
            base = inp.input.schema().arity
            # Transitive demand: kept scalars may reference earlier ones.
            needed: set = out_refs(outputs)
            for i in range(len(inp.scalars) - 1, -1, -1):
                if base + i in needed:
                    _refs(inp.scalars[i], needed)
            kept_scalars = [
                i for i in range(len(inp.scalars)) if base + i in needed
            ]
            needed_base = sorted(c for c in needed if c < base)
            if not needed_base:
                needed_base = [0]  # zero-column relations unrepresentable
            if len(needed_base) == base and len(kept_scalars) == len(
                inp.scalars
            ):
                return e
            remap = {src: i for i, src in enumerate(needed_base)}
            for pos, i in enumerate(kept_scalars):
                remap[base + i] = len(needed_base) + pos
            scalars = []
            for i in kept_scalars:
                sh = _shift_scalar(inp.scalars[i], remap)
                if sh is None:
                    return e
                scalars.append(sh)
            new_in = (
                mir.Project(inp.input, tuple(needed_base))
                if len(needed_base) < base
                else inp.input
            )
            new_map = (
                mir.Map(new_in, tuple(scalars)) if scalars else new_in
            )
            return mir.Project(
                new_map, tuple(remap[o] for o in outputs)
            )

        if isinstance(inp, mir.Join):
            offsets = [0]
            for i in inp.inputs:
                offsets.append(offsets[-1] + i.schema().arity)
            needed: set = out_refs(outputs)
            for cls in inp.equivalences:
                for m in cls:
                    _refs(m, needed)
            if len(needed) == offsets[-1]:
                return e
            # per-input keep lists + global remap
            keeps = []
            remap = {}
            new_pos = 0
            for j in range(len(inp.inputs)):
                keep_j = sorted(
                    c - offsets[j]
                    for c in needed
                    if offsets[j] <= c < offsets[j + 1]
                )
                if not keep_j:
                    # zero-column relations are not representable
                    keep_j = [0]
                keeps.append(keep_j)
                for local in keep_j:
                    remap[offsets[j] + local] = new_pos
                    new_pos += 1
            new_inputs = []
            for j, (i_j, keep_j) in enumerate(zip(inp.inputs, keeps)):
                a_j = i_j.schema().arity
                new_inputs.append(
                    mir.Project(i_j, tuple(keep_j))
                    if len(keep_j) < a_j
                    else i_j
                )
            equivs = []
            for cls in inp.equivalences:
                shifted = tuple(
                    _shift_scalar(m, remap) for m in cls
                )
                if any(s is None for s in shifted):
                    return e
                equivs.append(shifted)
            return mir.Project(
                mir.Join(
                    tuple(new_inputs), tuple(equivs), inp.implementation
                ),
                tuple(remap[o] for o in outputs),
            )

        if isinstance(inp, mir.Reduce):
            nk = len(inp.group_key)
            used_aggs = sorted(
                {o - nk for o in outputs if o >= nk}
            )
            if len(used_aggs) < len(inp.aggregates):
                remap = {i: i for i in range(nk)}
                for pos, a in enumerate(used_aggs):
                    remap[nk + a] = nk + pos
                return mir.Project(
                    mir.Reduce(
                        inp.input,
                        inp.group_key,
                        tuple(inp.aggregates[a] for a in used_aggs),
                    ),
                    tuple(remap[o] for o in outputs),
                )
            return e

        return e

    return _bottom_up(expr, rw)


def _null_filtered(e: mir.RelationExpr, col: int) -> bool:
    """True if the input spine already rejects NULLs in ``col`` (a
    NOT(IS_NULL(col)) predicate at any level pushdown can have sunk it
    to: Filter/Project/Map/Negate)."""
    cur, c = e, col
    while True:
        if isinstance(cur, mir.Filter):
            for p in cur.predicates:
                if (
                    isinstance(p, ms.CallUnary)
                    and p.func == ms.UnaryFunc.NOT
                    and isinstance(p.expr, ms.CallUnary)
                    and p.expr.func == ms.UnaryFunc.IS_NULL
                    and isinstance(p.expr.expr, ms.ColumnRef)
                    and p.expr.expr.index == c
                ):
                    return True
            cur = cur.input
        elif isinstance(cur, mir.Project):
            c = cur.outputs[c]
            cur = cur.input
        elif isinstance(cur, mir.Map):
            if c >= cur.input.schema().arity:
                return False  # a mapped scalar: stop
            cur = cur.input
        elif isinstance(cur, mir.Negate):
            cur = cur.input
        else:
            return False


def non_null_requirements(expr: mir.RelationExpr) -> mir.RelationExpr:
    """NonNullRequirements (transform/src/non_null_requirements.rs),
    join form: join-key equality never matches NULL, so every nullable
    column in a >=2-member equivalence class gets an IS NOT NULL filter
    on its owning input — pruning NULL rows BEFORE they enter join
    arrangements (smaller device state, fewer merge lanes). Run ONCE
    ahead of the logical fixpoint; predicate pushdown then sinks the
    filters toward sources, and _null_filtered keeps re-optimization
    idempotent."""

    def rw(e):
        if not isinstance(e, mir.Join):
            return e
        offsets = [0]
        for i in e.inputs:
            offsets.append(offsets[-1] + i.schema().arity)
        need: list = [set() for _ in e.inputs]
        for cls in e.equivalences:
            if len(cls) < 2:
                continue
            for s in cls:
                if not isinstance(s, ms.ColumnRef):
                    continue
                for k in range(len(e.inputs)):
                    if offsets[k] <= s.index < offsets[k + 1]:
                        local = s.index - offsets[k]
                        sch = e.inputs[k].schema()
                        if sch[local].nullable and not _null_filtered(
                            e.inputs[k], local
                        ):
                            need[k].add(local)
                        break
        if not any(need):
            return e
        new_inputs = []
        for k, inp in enumerate(e.inputs):
            if need[k]:
                preds = tuple(
                    ms.CallUnary(
                        ms.UnaryFunc.NOT,
                        ms.CallUnary(
                            ms.UnaryFunc.IS_NULL, ms.ColumnRef(c)
                        ),
                    )
                    for c in sorted(need[k])
                )
                inp = mir.Filter(inp, preds)
            new_inputs.append(inp)
        return mir.Join(
            tuple(new_inputs), e.equivalences, e.implementation
        )

    return _bottom_up(expr, rw)


def literal_lifting(expr: mir.RelationExpr) -> mir.RelationExpr:
    """LiteralLifting (transform/src/literal_lifting.rs), union form:
    when every Union branch ends in a Map of the SAME literal scalars,
    lift the Map above the Union — the union then moves narrower rows
    (fewer device lanes) and the literals are computed once."""

    def tail_literals(e):
        if isinstance(e, mir.Map) and e.scalars and all(
            isinstance(s, ms.Literal) for s in e.scalars
        ):
            return e.input, e.scalars
        return None, None

    def rw(e):
        if not isinstance(e, mir.Union) or len(e.inputs) < 2:
            return e
        stripped, lits = [], None
        for b in e.inputs:
            inner, ls = tail_literals(b)
            if inner is None:
                return e
            if lits is None:
                lits = ls
            elif ls != lits:
                return e
            stripped.append(inner)
        return mir.Map(mir.Union(tuple(stripped)), lits)

    return _bottom_up(expr, rw)


def join_fusion(expr: mir.RelationExpr) -> mir.RelationExpr:
    """Join fusion (transform/src/fusion/join.rs): flatten a Join whose
    input is itself a Join into one multiway Join. The splice preserves
    the global column order (the inner join's columns occupy the same
    contiguous range), so outer equivalences stay valid and inner ones
    shift by the inner's global offset. Flattening is what lets
    join_ordering and the delta-join planner see SQL's nested binary
    join chains as the multiway joins they are."""

    def rw(e):
        if not isinstance(e, mir.Join) or e.implementation != "auto":
            return e
        new_inputs: list = []
        extra_equivs: list = []
        changed = False
        offset = 0
        for inp in e.inputs:
            fused = False
            if (
                isinstance(inp, mir.Join)
                and inp.implementation == "auto"
            ):
                shift = {
                    r: r + offset for r in range(inp.schema().arity)
                }
                shifted_all: list = []
                ok = True
                for cls in inp.equivalences:
                    shifted = tuple(
                        _shift_scalar(s, shift) for s in cls
                    )
                    if any(s is None for s in shifted):
                        # non-columnar member we cannot remap: keep
                        # the nested join intact
                        ok = False
                        break
                    shifted_all.append(shifted)
                if ok:
                    new_inputs.extend(inp.inputs)
                    extra_equivs.extend(shifted_all)
                    changed = fused = True
            if not fused:
                new_inputs.append(inp)
            offset += inp.schema().arity
        if not changed:
            return e
        return mir.Join(
            tuple(new_inputs),
            tuple(e.equivalences) + tuple(extra_equivs),
            e.implementation,
        )

    return _bottom_up(expr, rw)


def join_ordering(expr: mir.RelationExpr) -> mir.RelationExpr:
    """JoinImplementation's input-ordering half
    (transform/src/join_implementation.rs optimize_orders): permute
    join inputs so the chain starts at the most filtered input and
    every later input shares an equivalence with the already-joined
    prefix (no accidental cross products), then restore the original
    column order with an outer Project so parents are unaffected."""

    def selectivity(e) -> int:
        score, cur = 0, e
        while True:
            if isinstance(cur, mir.Filter):
                score += len(cur.predicates)
                cur = cur.input
            elif isinstance(cur, (mir.Project, mir.Map)):
                cur = cur.input
            elif isinstance(cur, mir.Constant):
                return score + 10  # known-tiny relation
            else:
                return score

    def rw(e):
        if (
            not isinstance(e, mir.Join)
            or e.implementation != "auto"
            or len(e.inputs) < 3
        ):
            # Binary joins: order is decided by arrangement reuse at
            # render time; only 3+ chains benefit from reordering.
            return e
        n = len(e.inputs)
        offsets = [0]
        for i in e.inputs:
            offsets.append(offsets[-1] + i.schema().arity)

        def input_of(r: int) -> int:
            for k in range(n):
                if offsets[k] <= r < offsets[k + 1]:
                    return k
            raise AssertionError(r)

        cls_inputs = []
        for cls in e.equivalences:
            touched: set = set()
            for s in cls:
                refs: set = set()
                _refs(s, refs)
                touched |= {input_of(r) for r in refs}
            cls_inputs.append(touched)
        scores = [selectivity(i) for i in e.inputs]
        order = [max(range(n), key=lambda k: (scores[k], -k))]
        remaining = set(range(n)) - set(order)
        while remaining:
            connected = [
                k
                for k in remaining
                if any(
                    k in t and (t & set(order)) for t in cls_inputs
                )
            ]
            pool = connected or sorted(remaining)
            nxt = max(pool, key=lambda k: (scores[k], -k))
            order.append(nxt)
            remaining.discard(nxt)
        if order == list(range(n)):
            return e
        new_offsets: dict = {}
        pos = 0
        for k in order:
            new_offsets[k] = pos
            pos += e.inputs[k].schema().arity
        total = offsets[-1]
        mapping = {
            r: new_offsets[input_of(r)] + (r - offsets[input_of(r)])
            for r in range(total)
        }
        new_equivs = []
        for cls in e.equivalences:
            shifted = tuple(
                _shift_scalar(s, mapping) for s in cls
            )
            if any(s is None for s in shifted):
                return e  # non-columnar member we cannot remap: bail
            new_equivs.append(shifted)
        permuted = mir.Join(
            tuple(e.inputs[k] for k in order),
            tuple(new_equivs),
            e.implementation,
        )
        return mir.Project(
            permuted, tuple(mapping[r] for r in range(total))
        )

    return _bottom_up(expr, rw)


LOGICAL_TRANSFORMS = (
    plan_distinct_aggregates,
    fuse,
    join_fusion,
    fold_constants,
    column_knowledge,
    predicate_pushdown,
    canonicalize_join_equivalences,
    union_cancel,
    reduce_elision,
    redundant_join,
    projection_pushdown,
    threshold_elision,
    literal_lifting,
)
# Join ordering runs before implementation selection (both halves of
# the reference's JoinImplementation), then equivalences re-canonicalize
# over the permuted column space.
PHYSICAL_TRANSFORMS = (
    join_ordering,
    canonicalize_join_equivalences,
    join_implementation,
)


def logical_optimizer(
    expr: mir.RelationExpr, max_iters: int = 10
) -> mir.RelationExpr:
    """Run the logical transform set to fixpoint (transform/src/lib.rs:752
    analog; bounded like the reference's fuel limits).
    NonNullRequirements runs once ahead of the loop (its added filters
    are then pushed/fused by the fixpoint; _null_filtered keeps a
    second optimize() over the same tree from re-adding them).

    Port: the reference's ``optimizer_typecheck`` hook (a dyncfg that
    typechecks every transform's output, analysis/typecheck.py) is left
    out: the port carries no dyncfg and no typechecker (ROADMAP Queue
    3)."""
    expr = non_null_requirements(expr)
    for _ in range(max_iters):
        before = expr
        for t in LOGICAL_TRANSFORMS:
            expr = t(expr)
        if expr == before:
            break
    return expr


def physical_optimizer(expr: mir.RelationExpr) -> mir.RelationExpr:
    for t in PHYSICAL_TRANSFORMS:
        expr = t(expr)
    return expr


def optimize(expr: mir.RelationExpr) -> mir.RelationExpr:
    """logical fixpoint -> relational CSE (shared subplans bound in
    Lets, rendered once) -> physical decisions."""
    from .cse import relation_cse

    expr = logical_optimizer(expr)
    expr = relation_cse(expr)
    return physical_optimizer(expr)
