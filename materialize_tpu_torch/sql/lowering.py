"""HIR → MIR lowering: subquery decorrelation and outer-join expansion.

Analog of the reference's ``sql/src/plan/lowering.rs:188`` ("rewriting all
correlated subqueries ... into flat queries";
doc/developer/101-query-compilation.md:51-62), re-designed around the same
apply/branch scheme:

- Every correlated subquery is lowered against the DISTINCT KEYS of the
  columns it references in its enclosing queries (``_branch``): the
  subquery is recursively "applied" to that keys relation (``_apply``),
  producing ``keys ++ subquery_columns``; the enclosing relation then
  joins against it on those keys.
- scalar subquery  -> left-join semantics: matched rows take the
  subquery value, unmatched rows take the aggregate's default (COUNT -> 0,
  otherwise NULL — the reference's aggregate defaults).
- EXISTS           -> semijoin on the keys (NOT EXISTS -> antijoin).
- x IN (SELECT..)  -> rewritten to EXISTS(sub WHERE sub.col = x) with x
  shifted into the subquery as a correlated reference, then handled by
  the EXISTS machinery (so correlated and uncorrelated IN share a path).
- LEFT/RIGHT/FULL  -> inner join ∪ null-padded antijoin remainders.

Known deviations (documented, acceptable for the TPCH-class workloads):
- A scalar subquery returning >1 row multiplies rows instead of raising
  (error streams are the ok/err collection work).
- NOT IN with NULLs on either side uses antijoin semantics, not SQL
  three-valued logic.
- Correlated references through outer joins / CTE values raise.

The port's copy of ``materialize_tpu/sql/lowering.py``: its relative imports reach the port's
``expr/`` and ``repr/``; it differs from the reference only where noted.
"""

from __future__ import annotations

import itertools

from ..expr import relation as mir
from ..expr import scalar as ms
from ..expr.relation import AggregateExpr, AggregateFunc
from ..repr.schema import Column, ColumnType, Schema
from . import hir as h
from .hir import PlanError

_IDS = itertools.count()


def lower(rel: h.HirRelation) -> mir.RelationExpr:
    """Public entry: lower one HIR relation to MIR, scoping the
    free-ref memo (hir._FREE_CACHE) to this pass — the memo keys by
    id() and keeps strong references, so leaving it populated across
    statements grows coordinator memory without bound."""
    try:
        return _lower(rel)
    finally:
        h._FREE_CACHE.clear()


def _lower(rel: h.HirRelation) -> mir.RelationExpr:
    if isinstance(rel, h.HGet):
        return mir.Get(rel.name, rel._schema)
    if isinstance(rel, h.HConstant):
        return mir.Constant(rel.rows, rel._schema)
    if isinstance(rel, h.HRename):
        inner = _lower(rel.input)
        return _rename(inner, rel._schema)
    if isinstance(rel, h.HProject):
        return mir.Project(_lower(rel.input), tuple(rel.outputs))
    if isinstance(rel, h.HMap):
        return _lower_map(_lower(rel.input), rel, shift=0, cmap={})
    if isinstance(rel, h.HFilter):
        cur = _lower(rel.input)
        base = _arity(cur)
        return _lower_filter_preds(
            cur, rel.predicates, keep_arity=base, shift=0, cmap={}
        )
    if isinstance(rel, h.HJoin):
        return _lower_join(rel)
    if isinstance(rel, h.HReduce):
        return _lower_reduce(_lower(rel.input), rel, shift=0, cmap={})
    if isinstance(rel, h.HDistinct):
        inner = _lower(rel.input)
        return mir.Reduce(
            inner, tuple(range(rel.input.schema().arity)), ()
        )
    if isinstance(rel, h.HTopK):
        return mir.TopK(
            _lower(rel.input),
            tuple(rel.group_key),
            tuple(rel.order_by),
            rel.limit,
            rel.offset,
        )
    if isinstance(rel, h.HNegate):
        return mir.Negate(_lower(rel.input))
    if isinstance(rel, h.HThreshold):
        return mir.Threshold(_lower(rel.input))
    if isinstance(rel, h.HUnion):
        return mir.Union(tuple(_lower(i) for i in rel.inputs))
    if isinstance(rel, h.HLet):
        return mir.Let(rel.name, _lower(rel.value), _lower(rel.body))
    if isinstance(rel, h.HLetRec):
        return mir.LetRec(
            tuple(rel.names),
            tuple(_lower(v) for v in rel.values),
            tuple(rel.value_schemas),
            _lower(rel.body),
            rel.max_iters,
        )
    raise NotImplementedError(type(rel).__name__)


def _arity(m: mir.RelationExpr) -> int:
    return m.schema().arity


def _rename(inner: mir.RelationExpr, schema: Schema) -> mir.RelationExpr:
    """MIR has no rename: Get/Constant carry schemas, everything else
    derives names structurally. A no-op Project keeps the tree shape and
    downstream code reads names off the HIR side."""
    if isinstance(inner, mir.Get):
        return mir.Get(inner.name, schema)
    if isinstance(inner, mir.Constant):
        return mir.Constant(inner.rows, schema)
    return inner


# -- shared node lowerings (uncorrelated shift=0 / applied shift=ka) ---------


def _lower_map(inner, rel: h.HMap, shift: int, cmap: dict):
    base = shift + rel.input.schema().arity
    inner2, scalars = _lower_scalars(
        inner, [s for s, _ in rel.scalars], shift=shift, cmap=cmap
    )
    cur = mir.Map(inner2, tuple(scalars))
    if _arity(inner2) != base:
        # subquery columns appended: map exprs then project them away
        n = len(scalars)
        keep = list(range(base)) + list(
            range(_arity(cur) - n, _arity(cur))
        )
        return mir.Project(cur, tuple(keep))
    return cur


def _lower_reduce(inner, rel: h.HReduce, shift: int, cmap: dict):
    inner2, agg_exprs = _lower_scalars(
        inner, [a.expr for a in rel.aggregates], shift=shift, cmap=cmap
    )
    aggs = tuple(
        AggregateExpr(a.func, e, a.distinct, getattr(a, "params", ()))
        for a, e in zip(rel.aggregates, agg_exprs)
    )
    gk = tuple(range(shift)) + tuple(shift + i for i in rel.group_key)
    return mir.Reduce(inner2, gk, aggs)


# -- scalar lowering with subquery decorrelation ------------------------------


def _scalar_at(e: h.HirScalar, shift: int, cmap: dict) -> ms.ScalarExpr:
    """HIR scalar -> MIR scalar with column shift and correlated-ref map;
    raises on embedded subqueries (use _lower_scalars for those)."""
    if isinstance(e, h.HColumn):
        return ms.ColumnRef(shift + e.index)
    if isinstance(e, h.HOuterColumn):
        try:
            return ms.ColumnRef(cmap[(e.level, e.index)])
        except KeyError:
            raise PlanError(
                f"unbound correlated reference (level {e.level})"
            ) from None
    if isinstance(e, h.HMzNow):
        return ms.MzNow()
    if isinstance(e, h.HLiteral):
        return ms.Literal(e.value, e.ctype, e.scale)
    if isinstance(e, h.HCallUnary):
        return ms.CallUnary(e.func, _scalar_at(e.expr, shift, cmap))
    if isinstance(e, h.HCallBinary):
        return ms.CallBinary(
            e.func,
            _scalar_at(e.left, shift, cmap),
            _scalar_at(e.right, shift, cmap),
        )
    if isinstance(e, h.HCallVariadic):
        return ms.CallVariadic(
            e.func, [_scalar_at(x, shift, cmap) for x in e.exprs]
        )
    if isinstance(e, h.HIf):
        return ms.If(
            _scalar_at(e.cond, shift, cmap),
            _scalar_at(e.then, shift, cmap),
            _scalar_at(e.els, shift, cmap),
        )
    if isinstance(e, (h.HExists, h.HScalarSubquery, h.HInSubquery)):
        raise PlanError("subquery in an unsupported scalar position")
    raise NotImplementedError(type(e).__name__)


def _scalar(e: h.HirScalar) -> ms.ScalarExpr:
    """Subquery-free, uncorrelated HIR scalar -> MIR scalar."""
    return _scalar_at(e, 0, {})


def _lower_scalars(cur, exprs, shift: int = 0, cmap: dict | None = None):
    """Lower scalars that may contain subqueries: each subquery's value
    columns are appended to `cur` (cross join when uncorrelated,
    key-branch left-join when correlated) and replaced by column
    references. Returns (new_relation, mir scalar exprs over it)."""
    cmap = cmap or {}
    state = {"cur": cur}

    def walk(e):
        if isinstance(e, h.HScalarSubquery):
            if e.rel.schema().arity != 1:
                raise PlanError("scalar subquery must return one column")
            # Uncorrelated subqueries go through the same branch (with
            # an empty key set): a zero-row subquery then correctly
            # pads NULL for every outer row instead of annihilating
            # the relation via an empty cross join.
            state["cur"], pos = _branch(
                state["cur"], shift, cmap, e.rel, mode="scalar"
            )
            return ms.ColumnRef(pos)
        if isinstance(e, h.HExists):
            state["cur"], pos = _branch(
                state["cur"], shift, cmap, e.rel, mode="exists"
            )
            return ms.ColumnRef(pos)
        if isinstance(e, h.HInSubquery):
            ex = _in_to_exists(e, state["cur"], shift)
            state["cur"], pos = _branch(
                state["cur"], shift, cmap, ex.rel, mode="exists"
            )
            ref = ms.ColumnRef(pos)
            if e.negated:
                return ms.CallUnary(ms.UnaryFunc.NOT, ref)
            return ref
        if isinstance(e, h.HColumn):
            return ms.ColumnRef(shift + e.index)
        if isinstance(e, h.HOuterColumn):
            try:
                return ms.ColumnRef(cmap[(e.level, e.index)])
            except KeyError:
                raise PlanError(
                    f"unbound correlated reference (level {e.level})"
                ) from None
        if isinstance(e, h.HMzNow):
            return ms.MzNow()
        if isinstance(e, h.HLiteral):
            return ms.Literal(e.value, e.ctype, e.scale)
        if isinstance(e, h.HCallUnary):
            return ms.CallUnary(e.func, walk(e.expr))
        if isinstance(e, h.HCallBinary):
            return ms.CallBinary(e.func, walk(e.left), walk(e.right))
        if isinstance(e, h.HCallVariadic):
            return ms.CallVariadic(e.func, [walk(x) for x in e.exprs])
        if isinstance(e, h.HIf):
            return ms.If(walk(e.cond), walk(e.then), walk(e.els))
        raise NotImplementedError(type(e).__name__)

    out = [walk(e) for e in exprs]
    return state["cur"], out


def _shift_into_subquery(e: h.HirScalar, cur_schema: Schema, shift: int):
    """Rewrite a scalar over the enclosing relation into a scalar valid
    INSIDE a subquery of that relation: columns become level-1 outer
    references; existing outer references go one level further out."""
    if isinstance(e, h.HColumn):
        col = cur_schema[shift + e.index]
        return h.HOuterColumn(1, e.index, col)
    if isinstance(e, h.HOuterColumn):
        return h.HOuterColumn(e.level + 1, e.index, e.column)
    if isinstance(e, h.HLiteral):
        return e
    if isinstance(e, h.HMzNow):
        return e
    if isinstance(e, h.HCallUnary):
        return h.HCallUnary(
            e.func, _shift_into_subquery(e.expr, cur_schema, shift)
        )
    if isinstance(e, h.HCallBinary):
        return h.HCallBinary(
            e.func,
            _shift_into_subquery(e.left, cur_schema, shift),
            _shift_into_subquery(e.right, cur_schema, shift),
        )
    if isinstance(e, h.HCallVariadic):
        return h.HCallVariadic(
            e.func,
            tuple(
                _shift_into_subquery(x, cur_schema, shift) for x in e.exprs
            ),
        )
    if isinstance(e, h.HIf):
        return h.HIf(
            _shift_into_subquery(e.cond, cur_schema, shift),
            _shift_into_subquery(e.then, cur_schema, shift),
            _shift_into_subquery(e.els, cur_schema, shift),
        )
    raise PlanError("unsupported IN-subquery left side")


def _in_to_exists(p: h.HInSubquery, cur, shift: int) -> h.HExists:
    """x IN (sub) -> EXISTS(sub WHERE sub.col0 = x), with x shifted into
    the subquery as a correlated reference. The shared EXISTS machinery
    then handles correlated and uncorrelated IN uniformly."""
    if p.rel.schema().arity != 1:
        raise PlanError("IN subquery must return one column")
    x = _shift_into_subquery(p.expr, cur.schema(), shift)
    eq = h.HCallBinary(ms.BinaryFunc.EQ, h.HColumn(0), x)
    return h.HExists(h.HFilter(p.rel, (eq,)))


# -- the branch: correlated subquery -> keys-applied left join ---------------


def _correlation_map(cur, shift: int, cmap: dict, subrel):
    """Positions in `cur` for each of subrel's free outer refs.

    Returns (corr_positions sorted, inner_cmap for lowering subrel over
    the keys relation)."""
    free = sorted(
        h.free_outer_refs(subrel), key=lambda t: (t[0], t[1])
    )
    pos_of = {}
    for lvl, idx, _col in free:
        if lvl == 1:
            pos = shift + idx
        else:
            try:
                pos = cmap[(lvl - 1, idx)]
            except KeyError:
                raise PlanError(
                    f"unbound correlated reference (level {lvl})"
                ) from None
        pos_of[(lvl, idx)] = pos
    corr = sorted(set(pos_of.values()))
    rank = {p: j for j, p in enumerate(corr)}
    inner_cmap = {key: rank[pos] for key, pos in pos_of.items()}
    return corr, inner_cmap


class _BranchKeys:
    """Shared setup for _branch/_branch_semi: the outer-keys relation
    plus NULL-safe join machinery.

    The branch join must treat NULL outer-key values as EQUAL (an outer
    row with a NULL correlated column still gets ITS key's subquery
    result — IS NOT DISTINCT FROM semantics, as in the reference's
    applied_to), but the device equijoin drops NULL keys like SQL `=`.
    So for nullable correlated columns the join runs on an appended
    (coalesce(c, 0), is_null(c)) encoding — the same trick as
    plan_distinct_aggregates — while the keys relation's LEADING columns
    stay the RAW values (which is what the applied subquery reads
    through `cmap`)."""

    def __init__(self, cur, shift: int, cmap: dict, subrel):
        self.corr, self.inner_cmap = _correlation_map(
            cur, shift, cmap, subrel
        )
        self.cur = cur
        self.cur_arity = _arity(cur)
        schema = cur.schema()
        n = next(_IDS)
        self.cname = f"__dc_cur{n}"
        self.kname = f"__dc_keys{n}"
        self.aname = f"__dc_app{n}"
        self.cur_get = mir.Get(self.cname, schema)

        enc_exprs: list = []
        # Per corr col: positions of its join columns on the cur side
        # (raw col, or the two encoded cols appended by the Map).
        cur_join_cols: list = []
        for p in self.corr:
            c = schema[p]
            if c.nullable:
                zero = ms.Literal(
                    False if c.ctype is ColumnType.BOOL else 0,
                    c.ctype,
                    c.scale,
                )
                a = self.cur_arity + len(enc_exprs)
                enc_exprs.append(
                    ms.CallVariadic(
                        ms.VariadicFunc.COALESCE,
                        (ms.ColumnRef(p), zero),
                    )
                )
                enc_exprs.append(
                    ms.CallUnary(ms.UnaryFunc.IS_NULL, ms.ColumnRef(p))
                )
                cur_join_cols.append((a, a + 1))
            else:
                cur_join_cols.append((p,))
        self.n_enc = len(enc_exprs)
        self.cur_enc = (
            mir.Map(self.cur_get, tuple(enc_exprs))
            if enc_exprs
            else self.cur_get
        )
        self.enc_arity = self.cur_arity + self.n_enc
        # keys = DISTINCT(raw corr cols ++ encoded join cols).
        k0 = len(self.corr)
        extra = [
            c for cols in cur_join_cols if len(cols) == 2 for c in cols
        ]
        key_proj = tuple(self.corr) + tuple(extra)
        self.ka = len(key_proj)
        self.keys = mir.Reduce(
            mir.Project(self.cur_enc, key_proj),
            tuple(range(self.ka)),
            (),
        )
        # Key-side positions of each corr col's join columns.
        key_join_cols: list = []
        next_extra = k0
        for j, cols in enumerate(cur_join_cols):
            if len(cols) == 2:
                key_join_cols.append((next_extra, next_extra + 1))
                next_extra += 2
            else:
                key_join_cols.append((j,))
        self.cur_join_cols = cur_join_cols
        self.key_join_cols = key_join_cols

    def equivs(self, right_offset: int):
        """Join equivalences cur_enc ⋈ (keys-prefixed right side)."""
        out = []
        for cc, kc in zip(self.cur_join_cols, self.key_join_cols):
            for a, b in zip(cc, kc):
                out.append(
                    (ms.ColumnRef(a), ms.ColumnRef(right_offset + b))
                )
        return tuple(out)


def _branch(cur, shift: int, cmap: dict, subrel, mode: str):
    """Append the subquery's value column(s) to every row of `cur` with
    left-join semantics (lowering.rs's branch + left join + defaults):

      keys    = DISTINCT(project(cur, correlated columns))
      applied = subrel applied over keys            (keys ++ sub cols)
      matched = cur JOIN applied ON corr = keys     (NULL-safe)
      missing = (cur ∖ cur ⋉ applied's keys) ++ defaults
      result  = matched ∪ missing

    mode 'scalar': appended col = the subquery's single output; default =
    0 for a COUNT output, NULL otherwise. mode 'exists': appended col =
    TRUE for keys with >=1 row, default FALSE. Works for uncorrelated
    subqueries too (empty key set: the keys relation is the nonempty
    flag and a zero-row subquery pads every outer row with the default).

    Returns (new_relation, appended column position)."""
    bk = _BranchKeys(cur, shift, cmap, subrel)
    ka = bk.ka
    cur_arity = bk.cur_arity
    applied = _apply(bk.kname, bk.keys.schema(), subrel, bk.inner_cmap)
    if mode == "exists":
        applied = mir.Map(
            mir.Reduce(
                mir.Project(applied, tuple(range(ka))),
                tuple(range(ka)),
                (),
            ),
            (ms.Literal(True, ColumnType.BOOL),),
        )
        defaults = (ms.Literal(False, ColumnType.BOOL),)
    else:
        n_out = _arity(applied) - ka
        defaults = tuple(
            _output_default(subrel, j) for j in range(n_out)
        )
    applied_get = mir.Get(bk.aname, applied.schema())
    n_out = _arity(applied_get) - ka
    equivs = bk.equivs(bk.enc_arity)
    matched = mir.Project(
        mir.Join((bk.cur_enc, applied_get), equivalences=equivs),
        tuple(range(cur_arity))
        + tuple(bk.enc_arity + ka + t for t in range(n_out)),
    )
    present = mir.Reduce(
        mir.Project(applied_get, tuple(range(ka))), tuple(range(ka)), ()
    )
    semi = mir.Project(
        mir.Join((bk.cur_enc, present), equivalences=equivs),
        tuple(range(cur_arity)),
    )
    unmatched = mir.Threshold(
        mir.Union((bk.cur_get, mir.Negate(semi)))
    )
    padded = mir.Map(unmatched, defaults)
    body = mir.Union((matched, padded))
    out = mir.Let(
        bk.cname,
        cur,
        mir.Let(bk.kname, bk.keys, mir.Let(bk.aname, applied, body)),
    )
    return out, cur_arity


def _branch_semi(cur, shift: int, cmap: dict, subrel, negated: bool):
    """Semijoin (EXISTS) / antijoin (NOT EXISTS) of `cur` against a
    correlated (or not) subquery, keeping cur's columns. NULL-safe on
    the correlated key columns (see _BranchKeys)."""
    bk = _BranchKeys(cur, shift, cmap, subrel)
    ka = bk.ka
    cur_arity = bk.cur_arity
    applied = _apply(bk.kname, bk.keys.schema(), subrel, bk.inner_cmap)
    present = mir.Reduce(
        mir.Project(applied, tuple(range(ka))), tuple(range(ka)), ()
    )
    equivs = bk.equivs(bk.enc_arity)
    semi = mir.Project(
        mir.Join((bk.cur_enc, present), equivalences=equivs),
        tuple(range(cur_arity)),
    )
    if negated:
        body = mir.Threshold(mir.Union((bk.cur_get, mir.Negate(semi))))
    else:
        body = semi
    return mir.Let(bk.cname, cur, mir.Let(bk.kname, bk.keys, body))


def _output_default(rel: h.HirRelation, col: int) -> ms.Literal:
    """Default value for a subquery output column over an empty group:
    COUNT aggregates default to 0, everything else to NULL (the
    reference's AggregateFunc::default)."""
    sch = rel.schema()
    c = sch[col]
    if isinstance(rel, h.HRename):
        return _output_default(rel.input, col)
    if isinstance(rel, h.HProject):
        return _output_default(rel.input, rel.outputs[col])
    if isinstance(rel, h.HMap):
        ia = rel.input.schema().arity
        if col < ia:
            return _output_default(rel.input, col)
        return ms.Literal(None, c.ctype, c.scale)
    if isinstance(rel, h.HReduce):
        nk = len(rel.group_key)
        if (
            col >= nk
            and rel.aggregates[col - nk].func is AggregateFunc.COUNT
        ):
            return ms.Literal(0, ColumnType.INT64)
        return ms.Literal(None, c.ctype, c.scale)
    return ms.Literal(None, c.ctype, c.scale)


# -- apply: lower a subquery over an outer-keys relation ----------------------


def _apply(kname: str, kschema: Schema, rel: h.HirRelation, cmap: dict):
    """Lower `rel` so every row is computed per outer key: the result's
    schema is ``keys ++ rel_columns``. ``cmap`` maps rel's free outer
    references (level, index) to key positions. The applied analog of
    lowering.rs ``HirRelationExpr::applied_to``."""
    ka = kschema.arity
    kget = mir.Get(kname, kschema)
    if not h.is_correlated(rel):
        return mir.Join((kget, _lower(rel)), equivalences=())
    if isinstance(rel, h.HRename):
        return _apply(kname, kschema, rel.input, cmap)
    if isinstance(rel, h.HProject):
        inner = _apply(kname, kschema, rel.input, cmap)
        return mir.Project(
            inner,
            tuple(range(ka)) + tuple(ka + i for i in rel.outputs),
        )
    if isinstance(rel, h.HMap):
        inner = _apply(kname, kschema, rel.input, cmap)
        return _lower_map(inner, rel, shift=ka, cmap=cmap)
    if isinstance(rel, h.HFilter):
        inner = _apply(kname, kschema, rel.input, cmap)
        keep = ka + rel.input.schema().arity
        return _lower_filter_preds(
            inner, rel.predicates, keep_arity=keep, shift=ka, cmap=cmap
        )
    if isinstance(rel, h.HReduce):
        inner = _apply(kname, kschema, rel.input, cmap)
        return _lower_reduce(inner, rel, shift=ka, cmap=cmap)
    if isinstance(rel, h.HDistinct):
        inner = _apply(kname, kschema, rel.input, cmap)
        return mir.Reduce(inner, tuple(range(_arity(inner))), ())
    if isinstance(rel, h.HTopK):
        inner = _apply(kname, kschema, rel.input, cmap)
        gk = tuple(range(ka)) + tuple(ka + i for i in rel.group_key)
        ob = tuple((ka + c, d, nl) for c, d, nl in rel.order_by)
        return mir.TopK(inner, gk, ob, rel.limit, rel.offset)
    if isinstance(rel, h.HNegate):
        return mir.Negate(_apply(kname, kschema, rel.input, cmap))
    if isinstance(rel, h.HThreshold):
        return mir.Threshold(_apply(kname, kschema, rel.input, cmap))
    if isinstance(rel, h.HUnion):
        return mir.Union(
            tuple(_apply(kname, kschema, i, cmap) for i in rel.inputs)
        )
    if isinstance(rel, h.HJoin):
        if rel.kind not in ("inner", "cross"):
            raise NotImplementedError(
                "correlated references through outer joins"
            )
        left = _apply(kname, kschema, rel.left, cmap)
        right = _apply(kname, kschema, rel.right, cmap)
        la = rel.left.schema().arity
        ra = rel.right.schema().arity
        # Join the two applied sides on key equality, drop the duplicate
        # key copy: [keys, L, keys', R] -> [keys, L, R].
        join = mir.Join(
            (left, right),
            equivalences=tuple(
                (ms.ColumnRef(j), ms.ColumnRef(ka + la + j))
                for j in range(ka)
            ),
        )
        out = mir.Project(
            join,
            tuple(range(ka + la))
            + tuple(range(ka + la + ka, ka + la + ka + ra)),
        )
        if rel.on:
            keep = ka + la + ra
            out = _lower_filter_preds(
                out, rel.on, keep_arity=keep, shift=ka, cmap=cmap
            )
        return out
    if isinstance(rel, h.HLet):
        if h.is_correlated(rel.value):
            raise NotImplementedError("correlated CTE value")
        return mir.Let(
            rel.name,
            _lower(rel.value),
            _apply(kname, kschema, rel.body, cmap),
        )
    raise NotImplementedError(
        f"apply: {type(rel).__name__} under correlation"
    )


# -- filters ------------------------------------------------------------------


def _lower_filter_preds(
    cur, predicates, keep_arity: int, shift: int, cmap: dict
):
    """Lower filter conjuncts over `cur`: EXISTS/NOT EXISTS/IN/NOT IN
    conjuncts become semijoins/antijoins; remaining predicates (possibly
    containing scalar subqueries) become a Filter; any appended subquery
    columns are projected away down to `keep_arity`.

    Subquery-FREE conjuncts are applied FIRST (conjunct order is
    semantically free): the correlated branches then key off the
    filtered, equality-constrained relation — in particular the plain
    join equalities of the enclosing WHERE land as a Filter directly
    over the join, where predicate pushdown lifts them into join
    equivalences BEFORE the branch machinery snapshots `cur` into a Let
    (a filter above the Let could no longer be pushed into it, leaving
    the join a cross product)."""
    semis: list = []
    subq_preds: list = []
    pure: list = []
    for p in predicates:
        if isinstance(p, (h.HInSubquery, h.HExists)) or (
            isinstance(p, h.HCallUnary)
            and p.func is ms.UnaryFunc.NOT
            and isinstance(p.expr, h.HExists)
        ):
            semis.append(p)
        elif any(True for _ in h.scalar_subqueries(p)):
            subq_preds.append(p)
        else:
            pure.append(p)
    if pure:
        cur = mir.Filter(
            cur, tuple(_scalar_at(p, shift, cmap) for p in pure)
        )
    for p in semis:
        if isinstance(p, h.HInSubquery):
            ex = _in_to_exists(p, cur, shift)
            cur = _branch_semi(cur, shift, cmap, ex.rel, p.negated)
        elif isinstance(p, h.HExists):
            cur = _branch_semi(cur, shift, cmap, p.rel, negated=False)
        else:
            cur = _branch_semi(
                cur, shift, cmap, p.expr.rel, negated=True
            )
    if subq_preds:
        cur, preds = _lower_scalars(
            cur, subq_preds, shift=shift, cmap=cmap
        )
        cur = mir.Filter(cur, tuple(preds))
    if _arity(cur) != keep_arity:
        cur = mir.Project(cur, tuple(range(keep_arity)))
    return cur


# -- join lowering -----------------------------------------------------------


def _split_on(on, l_arity: int, r_arity: int):
    """Partition ON conjuncts into column-equivalence pairs and residual
    predicates (over the concatenated columns)."""
    equivs: list = []
    residual: list = []
    for c in on:
        if (
            isinstance(c, h.HCallBinary)
            and c.func == ms.BinaryFunc.EQ
            and isinstance(c.left, h.HColumn)
            and isinstance(c.right, h.HColumn)
        ):
            a, b = c.left.index, c.right.index
            if (a < l_arity) != (b < l_arity):
                equivs.append(
                    (ms.ColumnRef(min(a, b)), ms.ColumnRef(max(a, b)))
                )
                continue
        residual.append(c)
    return equivs, residual


def _lower_join(rel: h.HJoin) -> mir.RelationExpr:
    left = _lower(rel.left)
    right = _lower(rel.right)
    la, ra = _arity(left), _arity(right)
    equivs, residual = _split_on(rel.on, la, ra)
    inner = mir.Join((left, right), equivalences=tuple(equivs))
    if residual:
        inner = mir.Filter(
            inner, tuple(_scalar(c) for c in residual)
        )
    if rel.kind in ("inner", "cross"):
        return inner
    out_schema = rel.schema()

    def pad(unmatched, null_ctypes_cols, nulls_first: bool):
        """Append (or prepend, via projection) NULL columns."""
        scalars = tuple(
            ms.Literal(None, c.ctype, c.scale) for c in null_ctypes_cols
        )
        m = mir.Map(unmatched, scalars)
        if not nulls_first:
            return m
        n_u = _arity(unmatched)
        n_n = len(null_ctypes_cols)
        perm = tuple(range(n_u, n_u + n_n)) + tuple(range(n_u))
        return mir.Project(m, perm)

    def antijoin(side, side_arity, inner_proj):
        """Rows of `side` with no match: side - (side ⋉ matched-rows)."""
        matched = mir.Reduce(
            mir.Project(inner, inner_proj), tuple(range(side_arity)), ()
        )
        semi = mir.Project(
            mir.Join(
                (side, matched),
                equivalences=tuple(
                    (ms.ColumnRef(i), ms.ColumnRef(side_arity + i))
                    for i in range(side_arity)
                ),
            ),
            tuple(range(side_arity)),
        )
        return mir.Threshold(mir.Union((side, mir.Negate(semi))))

    parts = [inner]
    if rel.kind in ("left", "full"):
        lu = antijoin(left, la, tuple(range(la)))
        parts.append(pad(lu, out_schema.columns[la:], nulls_first=False))
    if rel.kind in ("right", "full"):
        ru = antijoin(right, ra, tuple(range(la, la + ra)))
        parts.append(pad(ru, out_schema.columns[:la], nulls_first=True))
    return mir.Union(tuple(parts))
