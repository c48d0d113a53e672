"""MIR/LIR typechecker: bottom-up plan validation.

Analog of the reference's ``transform/src/typecheck.rs``: a pass that
re-derives every node's type from its children and refuses plans that
violate the invariants the render layer assumes. The reference runs it
between optimizer transforms under a feature flag so a transform that
corrupts schemas is caught AT the transform that introduced it; the
``optimizer_typecheck`` dyncfg (utils/dyncfg.py) wires this checker the
same way into transform/optimizer.py.

Checked invariants (catalogued with rationale in doc/analysis.md):

  T-ARITY    column references (scalar exprs, group keys, projections,
             order keys, arrangement keys) are in bounds
  T-SCHEMA   every node's derived schema is consistent with its
             children (Union branches agree on arity/type/scale, and a
             branch may not be nullable where the declared schema
             isn't — downstream null-folding would be unsound)
  T-SCALAR   scalar expressions type (``.typ()`` succeeds) and Filter
             predicates are BOOL
  T-BIND     Let/LetRec binding discipline: no shadowing, no dangling
             ``Get`` of a binding-style name, ``Get`` schemas match the
             binding's value schema (ctype/scale/nullability)
  T-REDUCE   Reduce/TopK keys and aggregate positions valid
  T-PRESERVE (between transforms) a rewrite preserves the relation
             type: same arity, same ctype/scale per column, and
             nullability may only tighten
  T-LIR      the plan decisions (plan/decisions.py) the render layer
             will execute succeed and partition correctly

Column NAMES are explicitly not compared anywhere: operators are
positional and transforms rename freely (Map's ``c{i}``, view renames).

The port's copy of ``materialize_tpu/analysis/typecheck.py``: its
relative imports reach the port's ``expr/``, ``repr/`` and
``plan/decisions.py``; the checks, codes and messages are the
reference's.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..expr import relation as mir
from ..expr import scalar as ms
from ..repr.schema import ColumnType, Schema


class TypecheckError(Exception):
    """A plan violates a typechecker invariant. ``path`` names the node
    trail from the root so the offending operator is findable in
    EXPLAIN output."""

    def __init__(self, code: str, path: str, message: str):
        self.code = code
        self.path = path
        super().__init__(f"[{code}] at {path or '<root>'}: {message}")


class TransformTypecheckError(Exception):
    """An optimizer transform produced an invalid plan — blame
    attribution, not just detection (the reference's typecheck names
    the transform the same way)."""

    def __init__(self, transform: str, cause: Exception):
        self.transform = transform
        self.cause = cause
        super().__init__(
            f"optimizer transform {transform!r} produced an invalid "
            f"plan: {cause}"
        )


def _err(code: str, path: list, message: str):
    raise TypecheckError(code, "/".join(path), message)


# -- scalar expressions ------------------------------------------------------


def check_scalar(
    expr: ms.ScalarExpr, schema: Schema, path: list, what: str
):
    """Column refs in bounds + the expression types against ``schema``.
    Returns the derived Column so callers don't re-run typ() — scalar
    typing dominates the cost of the pass, and under the
    optimizer_typecheck dyncfg the pass runs after every transform."""

    def refs(e):
        if isinstance(e, ms.ColumnRef):
            if not (0 <= e.index < schema.arity):
                _err(
                    "T-ARITY",
                    path,
                    f"{what}: column reference #{e.index} out of "
                    f"bounds for arity {schema.arity}",
                )
            return
        for f in getattr(e, "__dataclass_fields__", {}):
            v = getattr(e, f)
            if isinstance(v, ms.ScalarExpr):
                refs(v)
            elif isinstance(v, tuple):
                for x in v:
                    if isinstance(x, ms.ScalarExpr):
                        refs(x)

    refs(expr)
    try:
        return expr.typ(schema)
    except TypecheckError:
        raise
    except Exception as e:  # noqa: BLE001 — any typ() failure is a plan bug
        _err("T-SCALAR", path, f"{what} does not type: {e}")


# -- relation schemas --------------------------------------------------------


def columns_compatible(declared, actual) -> str | None:
    """None if ``actual`` can flow where ``declared`` is expected:
    same ctype and scale, and actual may be nullable only where
    declared is. Returns a description of the first mismatch."""
    if declared.ctype is not actual.ctype:
        return (
            f"type {actual.ctype.value} where "
            f"{declared.ctype.value} expected"
        )
    if declared.scale != actual.scale:
        return f"scale {actual.scale} where {declared.scale} expected"
    if actual.nullable and not declared.nullable:
        return "nullable where non-nullable expected"
    return None


def schemas_compatible(declared: Schema, actual: Schema) -> str | None:
    if declared.arity != actual.arity:
        return f"arity {actual.arity} where {declared.arity} expected"
    for i, (d, a) in enumerate(zip(declared.columns, actual.columns)):
        m = columns_compatible(d, a)
        if m is not None:
            return f"column #{i}: {m}"
    return None


def check_type_preserved(
    before: Schema, after: Schema, transform: str
) -> None:
    """T-PRESERVE: a rewrite must not change the relation type (arity,
    ctype, scale); nullability may tighten (a transform can PROVE a
    column non-null) but never loosen."""
    m = schemas_compatible(before, after)
    if m is not None:
        raise TransformTypecheckError(
            transform,
            TypecheckError(
                "T-PRESERVE", "", f"output schema changed: {m}"
            ),
        )


# -- the main pass -----------------------------------------------------------


def typecheck(
    expr: mir.RelationExpr,
    sources: dict | None = None,
) -> Schema:
    """Validate ``expr`` bottom-up; returns its schema. ``sources``
    optionally maps known source/view names to schemas — ``Get``s of
    those are checked against it; unknown unbound names are assumed to
    be sources (planning cannot always see the catalog) UNLESS the name
    is bound by a Let/LetRec elsewhere in the tree, which makes the Get
    a dangling binding reference."""
    sources = sources or {}
    binders: set = set()

    def collect(e):
        if isinstance(e, mir.Let):
            binders.add(e.name)
        elif isinstance(e, mir.LetRec):
            binders.update(e.names)
        for c in e.children():
            collect(c)

    collect(expr)

    def go(e: mir.RelationExpr, env: dict, path: list) -> Schema:
        p = path + [type(e).__name__]

        if isinstance(e, mir.Constant):
            sch = e._schema
            for i, (vals, diff) in enumerate(e.rows):
                if len(vals) != sch.arity:
                    _err(
                        "T-SCHEMA",
                        p,
                        f"constant row #{i} has {len(vals)} values for "
                        f"arity {sch.arity}",
                    )
                if not isinstance(diff, int):
                    _err(
                        "T-SCHEMA",
                        p,
                        f"constant row #{i} diff {diff!r} is not an int",
                    )
            return sch

        if isinstance(e, mir.Get):
            declared = e._schema
            bound = env.get(e.name)
            if bound is None and e.name in binders:
                # The name is bound by a Let/LetRec somewhere in this
                # tree but not in scope here: a transform dropped or
                # moved the binder and left the Get dangling. Without
                # this check the node would be mistaken for a source
                # and the bug would surface as a render/hydration
                # failure on a nonexistent input.
                _err(
                    "T-BIND",
                    p,
                    f"dangling Get({e.name!r}): bound by a Let/LetRec "
                    "elsewhere in the plan but not in scope here",
                )
            if bound is None:
                bound = sources.get(e.name)
            if bound is not None:
                m = schemas_compatible(declared, bound)
                if m is not None:
                    _err(
                        "T-BIND",
                        p,
                        f"Get({e.name!r}) schema disagrees with its "
                        f"binding: {m}",
                    )
            return declared

        if isinstance(e, mir.Let):
            if e.name in env:
                _err(
                    "T-BIND", p, f"Let rebinds in-scope name {e.name!r}"
                )
            vsch = go(e.value, env, p + ["value"])
            env2 = dict(env)
            env2[e.name] = vsch
            return go(e.body, env2, p + ["body"])

        if isinstance(e, mir.LetRec):
            if len(set(e.names)) != len(e.names):
                _err("T-BIND", p, f"duplicate LetRec names {e.names}")
            if len(e.values) != len(e.names) or len(
                e.value_schemas
            ) != len(e.names):
                _err(
                    "T-BIND",
                    p,
                    "LetRec names/values/value_schemas lengths differ",
                )
            for n in e.names:
                if n in env:
                    _err(
                        "T-BIND",
                        p,
                        f"LetRec rebinds in-scope name {n!r}",
                    )
            env2 = dict(env)
            for n, sch in zip(e.names, e.value_schemas):
                env2[n] = sch
            for i, (n, v, sch) in enumerate(
                zip(e.names, e.values, e.value_schemas)
            ):
                vsch = go(v, env2, p + [f"value:{n}"])
                m = schemas_compatible(sch, vsch)
                if m is not None:
                    _err(
                        "T-BIND",
                        p,
                        f"LetRec binding {n!r} value schema disagrees "
                        f"with its declared schema: {m}",
                    )
            return go(e.body, env2, p + ["body"])

        if isinstance(e, mir.Project):
            in_sch = go(e.input, env, p)
            for o in e.outputs:
                if not (0 <= o < in_sch.arity):
                    _err(
                        "T-ARITY",
                        p,
                        f"projection output #{o} out of bounds for "
                        f"arity {in_sch.arity}",
                    )
            return in_sch.project(e.outputs)

        if isinstance(e, mir.Map):
            in_sch = go(e.input, env, p)
            cols = list(in_sch.columns)
            from ..repr.schema import Column

            for i, s in enumerate(e.scalars):
                ext = Schema(tuple(cols))
                c = check_scalar(s, ext, p, f"map scalar #{i}")
                cols.append(
                    Column(f"c{len(cols)}", c.ctype, c.nullable, c.scale)
                )
            return Schema(tuple(cols))

        if isinstance(e, mir.Filter):
            in_sch = go(e.input, env, p)
            for i, pred in enumerate(e.predicates):
                t = check_scalar(pred, in_sch, p, f"predicate #{i}")
                if t.ctype is not ColumnType.BOOL:
                    _err(
                        "T-SCALAR",
                        p,
                        f"predicate #{i} has type {t.ctype.value}, "
                        "not bool",
                    )
            return in_sch

        if isinstance(e, mir.FlatMap):
            in_sch = go(e.input, env, p)
            for i, s in enumerate(e.exprs):
                check_scalar(s, in_sch, p, f"flat_map arg #{i}")
            return Schema(
                tuple(in_sch.columns) + tuple(e.output_cols)
            )

        if isinstance(e, mir.Join):
            schemas = [
                go(inp, env, p + [f"input:{j}"])
                for j, inp in enumerate(e.inputs)
            ]
            if not e.inputs:
                _err("T-SCHEMA", p, "join with no inputs")
            cols = []
            for s in schemas:
                cols.extend(s.columns)
            joined = Schema(tuple(cols))
            for ci, cls in enumerate(e.equivalences):
                if len(cls) < 2:
                    _err(
                        "T-SCHEMA",
                        p,
                        f"equivalence class #{ci} has {len(cls)} "
                        "member(s); classes relate at least two "
                        "expressions",
                    )
                for mi, member in enumerate(cls):
                    check_scalar(
                        member,
                        joined,
                        p,
                        f"equivalence class #{ci} member #{mi}",
                    )
            if e.implementation not in ("auto", "linear", "delta"):
                _err(
                    "T-SCHEMA",
                    p,
                    f"unknown join implementation "
                    f"{e.implementation!r}",
                )
            return joined

        if isinstance(e, mir.Reduce):
            in_sch = go(e.input, env, p)
            for k in e.group_key:
                if not (0 <= k < in_sch.arity):
                    _err(
                        "T-ARITY",
                        p,
                        f"group key column #{k} out of bounds for "
                        f"arity {in_sch.arity}",
                    )
            for i, agg in enumerate(e.aggregates):
                check_scalar(
                    agg.expr, in_sch, p, f"aggregate #{i} argument"
                )
                try:
                    agg.output_col(in_sch)
                except Exception as exc:  # noqa: BLE001
                    _err(
                        "T-REDUCE",
                        p,
                        f"aggregate #{i} ({agg.func.value}) does not "
                        f"type: {exc}",
                    )
            return e.schema()

        if isinstance(e, mir.TopK):
            in_sch = go(e.input, env, p)
            for k in e.group_key:
                if not (0 <= k < in_sch.arity):
                    _err(
                        "T-ARITY",
                        p,
                        f"group key column #{k} out of bounds for "
                        f"arity {in_sch.arity}",
                    )
            for oi, (c, _desc, _nl) in enumerate(e.order_by):
                if not (0 <= c < in_sch.arity):
                    _err(
                        "T-ARITY",
                        p,
                        f"order_by #{oi} column #{c} out of bounds "
                        f"for arity {in_sch.arity}",
                    )
            if e.limit is not None and e.limit < 0:
                _err("T-REDUCE", p, f"negative limit {e.limit}")
            if e.offset < 0:
                _err("T-REDUCE", p, f"negative offset {e.offset}")
            return in_sch

        if isinstance(e, (mir.Negate, mir.Threshold)):
            return go(e.input, env, p)

        if isinstance(e, mir.Union):
            if not e.inputs:
                _err("T-SCHEMA", p, "union with no inputs")
            # The union's schema is branch 0's with nullability the
            # least upper bound across branches (Union.schema); every
            # branch must agree on arity/ctype/scale and flow into
            # that lub.
            branch0 = go(e.inputs[0], env, p + ["input:0"])
            from ..repr.schema import Column

            cols = list(branch0.columns)
            for j, inp in enumerate(e.inputs[1:], 1):
                bsch = go(inp, env, p + [f"input:{j}"])
                if bsch.arity != branch0.arity:
                    _err(
                        "T-SCHEMA",
                        p,
                        f"union branch #{j} has arity {bsch.arity} "
                        f"where branch #0 has {branch0.arity}",
                    )
                for i, c in enumerate(bsch.columns):
                    if c.ctype is not cols[i].ctype:
                        _err(
                            "T-SCHEMA",
                            p,
                            f"union branch #{j} column #{i} has type "
                            f"{c.ctype.value} where branch #0 has "
                            f"{cols[i].ctype.value}",
                        )
                    if c.scale != cols[i].scale:
                        _err(
                            "T-SCHEMA",
                            p,
                            f"union branch #{j} column #{i} has scale "
                            f"{c.scale} where branch #0 has "
                            f"{cols[i].scale}",
                        )
                    if c.nullable and not cols[i].nullable:
                        old = cols[i]
                        cols[i] = Column(
                            old.name, old.ctype, True, old.scale
                        )
            return Schema(tuple(cols))

        if isinstance(e, mir.ArrangeBy):
            in_sch = go(e.input, env, p)
            for k in e.key:
                if not (0 <= k < in_sch.arity):
                    _err(
                        "T-ARITY",
                        p,
                        f"arrangement key column #{k} out of bounds "
                        f"for arity {in_sch.arity}",
                    )
            return in_sch

        _err(
            "T-SCHEMA", p, f"unknown MIR node {type(e).__name__}"
        )

    return go(expr, {}, [])


# -- LIR consistency ---------------------------------------------------------


def typecheck_lir(
    expr: mir.RelationExpr, source_monotonic=frozenset()
) -> None:
    """T-LIR: every plan decision the render layer will take on this
    (optimized) MIR succeeds and is internally consistent — the LIR
    annotations (ReducePlan/JoinPlan/TopKPlan) match the MIR node they
    describe. Catches at EXPLAIN/typecheck time what would otherwise
    surface as a render-time NotImplementedError or a wrong plan."""
    from ..plan import decisions

    def go(e, path):
        p = path + [type(e).__name__]
        if isinstance(e, mir.Reduce):
            try:
                rp = decisions.plan_reduce(e.aggregates)
            except Exception as exc:  # noqa: BLE001
                _err("T-LIR", p, f"no reduce plan: {exc}")
            covered = sorted(rp.accumulable + rp.hierarchical + rp.basic)
            if rp.kind != "Distinct" and covered != list(
                range(len(e.aggregates))
            ):
                _err(
                    "T-LIR",
                    p,
                    f"ReducePlan {rp.describe()} does not "
                    f"partition aggregate positions "
                    f"0..{len(e.aggregates) - 1} (got {covered})",
                )
        if isinstance(e, mir.Join):
            try:
                jp = decisions.plan_join(e)
            except Exception as exc:  # noqa: BLE001
                _err("T-LIR", p, f"no join plan: {exc}")
            offsets = [0]
            for i in e.inputs:
                offsets.append(offsets[-1] + i.schema().arity)
            if jp.kind == "Linear":
                if len(jp.stages) != len(e.inputs) - 1:
                    _err(
                        "T-LIR",
                        p,
                        f"Linear JoinPlan has {len(jp.stages)} stages "
                        f"for {len(e.inputs)} inputs",
                    )
                for si, st in enumerate(jp.stages):
                    for c in st.left_key:
                        if not (0 <= c < offsets[si + 1]):
                            _err(
                                "T-LIR",
                                p,
                                f"stage #{si} left key column #{c} "
                                "out of accumulated-prefix bounds",
                            )
                    a = e.inputs[si + 1].schema().arity
                    for c in st.right_key:
                        if not (0 <= c < a):
                            _err(
                                "T-LIR",
                                p,
                                f"stage #{si} right key column #{c} "
                                f"out of bounds for arity {a}",
                            )
            else:
                for j, key in jp.arrangements:
                    if not (0 <= j < len(e.inputs)):
                        _err(
                            "T-LIR",
                            p,
                            f"Delta arrangement on input #{j} of "
                            f"{len(e.inputs)}",
                        )
                    a = e.inputs[j].schema().arity
                    for c in key:
                        if not (0 <= c < a):
                            _err(
                                "T-LIR",
                                p,
                                f"Delta arrangement key column #{c} "
                                f"out of bounds for input #{j} "
                                f"arity {a}",
                            )
        if isinstance(e, mir.TopK):
            try:
                tp = decisions.plan_topk(
                    e,
                    decisions.monotonic(e.input, source_monotonic),
                )
            except Exception as exc:  # noqa: BLE001
                _err("T-LIR", p, f"no topk plan: {exc}")
            if tuple(tp.group_key) != tuple(e.group_key):
                _err(
                    "T-LIR",
                    p,
                    f"TopKPlan group key {list(tp.group_key)} "
                    f"disagrees with the MIR node's "
                    f"{list(e.group_key)}",
                )
            if tp.limit != e.limit or tp.offset != e.offset:
                _err(
                    "T-LIR",
                    p,
                    "TopKPlan limit/offset disagrees with the MIR "
                    "node",
                )
        for c in e.children():
            go(c, p)

    go(expr, [])
