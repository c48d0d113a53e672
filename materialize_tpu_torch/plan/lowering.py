"""MIR → LIR lowering: build the physical plan tree (the port's copy of
``materialize_tpu/plan/lowering.py``).

Analog of ``compute-types/src/plan/lowering.rs:338``: walk the optimized
MIR, resolve each operator's physical plan via the shared decision
functions (decisions.py — the same ones render executes), and emit a
post-order-numbered LirNode tree (LirId analog) that EXPLAIN PHYSICAL
PLAN prints.
"""

from __future__ import annotations

from ..expr import relation as mir
from .decisions import (
    monotonic,
    plan_join,
    plan_reduce,
    plan_threshold,
    plan_topk,
)
from .lir import LirNode


def lower_mir(
    expr: mir.RelationExpr, source_monotonic=frozenset()
) -> LirNode:
    counter = {"n": 0}

    def nid() -> int:
        counter["n"] += 1
        return counter["n"]

    def walk(e) -> LirNode:
        if isinstance(e, mir.Get):
            return LirNode(nid(), "Get", e.name)
        if isinstance(e, mir.Constant):
            return LirNode(nid(), "Constant", f"rows={len(e.rows)}")
        if isinstance(e, mir.Project):
            c = walk(e.input)
            return LirNode(
                nid(), "Mfp", f"project={list(e.outputs)}", [c]
            )
        if isinstance(e, mir.Map):
            c = walk(e.input)
            return LirNode(nid(), "Mfp", f"map={len(e.scalars)}", [c])
        if isinstance(e, mir.Filter):
            c = walk(e.input)
            return LirNode(
                nid(), "Mfp", f"filter={len(e.predicates)}", [c]
            )
        if isinstance(e, mir.FlatMap):
            c = walk(e.input)
            return LirNode(nid(), "FlatMap", str(e.func), [c])
        if isinstance(e, mir.Join):
            children = [walk(i) for i in e.inputs]
            return LirNode(
                nid(), "Join", plan_join(e).describe(), children
            )
        if isinstance(e, mir.Reduce):
            c = walk(e.input)
            rp = plan_reduce(e.aggregates)
            return LirNode(
                nid(),
                "Reduce",
                f"{rp.describe()} group={list(e.group_key)}",
                [c],
            )
        if isinstance(e, mir.TopK):
            c = walk(e.input)
            tp = plan_topk(e, monotonic(e.input, source_monotonic))
            return LirNode(nid(), "TopK", tp.describe(), [c])
        if isinstance(e, mir.Negate):
            c = walk(e.input)
            return LirNode(nid(), "Negate", "", [c])
        if isinstance(e, mir.Threshold):
            c = walk(e.input)
            return LirNode(
                nid(), "Threshold", plan_threshold(e).describe(), [c]
            )
        if isinstance(e, mir.Union):
            children = [walk(i) for i in e.inputs]
            return LirNode(nid(), "Union", "", children)
        if isinstance(e, mir.ArrangeBy):
            c = walk(e.input)
            return LirNode(nid(), "ArrangeBy", f"key={list(e.key)}", [c])
        if isinstance(e, mir.Let):
            v = walk(e.value)
            b = walk(e.body)
            return LirNode(nid(), "Let", e.name, [v, b])
        if isinstance(e, mir.LetRec):
            vs = [walk(v) for v in e.values]
            b = walk(e.body)
            return LirNode(
                nid(),
                "LetRec",
                f"bindings={list(e.names)} max_iters={e.max_iters}",
                vs + [b],
            )
        raise NotImplementedError(type(e).__name__)

    return walk(expr)


def explain_lir(node: LirNode, indent: int = 0) -> str:
    pad = "  " * indent
    detail = f" {node.detail}" if node.detail else ""
    lines = [f"{pad}%{node.lir_id} {node.op}{detail}"]
    for c in node.children:
        lines.append(explain_lir(c, indent + 1))
    return "\n".join(lines)
