"""Render a MIR expression into a maintained dataflow with an output index
(the port of ``materialize_tpu/render/dataflow.py`` for every MIR node:
``Constant``, ``Get``, ``Let``, ``LetRec``, ``Project``, ``Map``,
``FlatMap``, ``Filter`` (temporal predicates included), ``Union``,
``Negate``, ``Threshold``, ``ArrangeBy``, the delta and the linear
``Join``, ``TopK`` and the ``Reduce`` with accumulable, MIN/MAX,
float-sum and basic collection aggregates, the last finalized at the
serving edge: ``finalize_basic_columns``).

The reference compiles one XLA step program and runs a span of steps
as one ``lax.scan``; PyTorch runs eagerly, so here a span is a host
loop over ticks, with the due spine levels folded after every
``_compact_every`` ticks (``_due_levels``). What carries over exactly:

- the output index is a hash-ordered ``Spine`` (every column the key),
  fed by ``insert_tail`` and folded on the geometric schedule;
- operator state lives in state slots: a Reduce's or a TopK's
  arrangements (overflow key ``("state", slot, part)``) and a join's
  exact-order spines (``("state", slot, (part, run))``, folded on the
  output's schedule; a linear join takes one slot per stage);
- a ``Let`` binding's delta is computed once per tick and shared by
  every ``Get`` of it;
- each join site has an output-capacity tier (default 1024, overflow
  key ``("join", site)``), read from the render context at every tick,
  so the replay after a doubling runs at the new tier;
- a temporal Filter and a FlatMap take a join site too, for their
  output tier, in the reference's order (after their input's sites);
  a temporal Filter's buffer and a Threshold's arrangement are state
  slots (overflow key ``("state", slot, 0)``);
- a ``Constant`` emits its rows once, at the dataflow's first processed
  time (``_RenderContext.first_time``, set by the first dispatch);
- a LetRec site has a binding-delta tier (default 2048, overflow key
  ``("lr", site, binding)``) and iterates as ``_build_letrec`` says;
- the err collection: scalar-evaluation and sum-overflow errors are
  kept in a second arrangement beside the output (``err_output``,
  overflow key ``("errout",)``), read by ``peek_errors``;
- overflow flags are OR-ed ON THE DEVICE and read back once per span
  (``check_flags``; the ``_readbacks`` counter keeps that invariant);
- on overflow the span is rolled back to its checkpoint (states, the
  output spine and the err arrangement are immutable values, so the
  checkpoint holds references), the flagged tiers grow, and the logged
  spans replay exactly;
- capacities follow the same pow2 tiers as the reference, so overflow,
  rollback and replay happen on the same ticks.

Under SPMD (``ShardedDataflow``, one process per rank) every stateful
operator's input is first exchanged to the rank owning its key
(``_RenderContext.maybe_exchange``, at the reference's sites), a
``Constant`` emits on rank 0 only, and a LetRec's pending count and
every step's flags are summed over the ranks, so every rank stops,
rolls back and replays together. On one device the exchanges are the
identity.

Left out: donation, the compile ledger and the program bank.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..arrangement.spine import (
    Arrangement,
    Spine,
    clone_state_tree,
    compact_depth,
    compact_level,
    insert,
    insert_tail,
    lookup_range,
)
from ..expr import relation as mir
from ..expr.linear import MapFilterProject, apply_mfp
from ..ops.consolidate import consolidate
from ..expr import errors as _errors
from ..expr.scalar import contains_mz_now
from ..ops.delta_join import DeltaJoinOp
from ..ops.flat_map import flat_map
from ..ops.join import JoinOp
from ..ops.reduce import ReduceOp
from ..ops.sort import concat_batches, shrink
from ..ops.temporal import TemporalFilterOp, canonicalize_temporal
from ..ops.threshold import ThresholdOp
from ..ops.topk import TopKOp
from ..plan.decisions import (
    INGEST_RING_SLOTS,
    ingest_mode,
    join_implementation,
    join_stage_keys,
    plan_threshold,
    quantize_cap,
    state_ingest_mode,
)
from ..plan.lir import JoinPlan, LinearStagePlan
from ..repr.batch import Batch, capacity_tier
from ..repr.schema import DIFF_DTYPE, ERR_SCHEMA, Schema

# Error deltas are shrunk to this tier before the err arrangement insert.
ERR_DELTA_CAP = 2048


def _donation_supported() -> bool:
    """Whether a span's carry can be donated to the next span. Eager
    torch has no donation: every step returns fresh state tensors (the
    reference answers false on its CPU backend too)."""
    return False


class _RenderContext:
    """Collects state slots while walking the MIR tree (each stateful
    operator's initial state, at the dataflow's state tier) and holds
    the join sites' output tiers, which overflow growth doubles."""

    def __init__(self, state_cap: int, device, join_cap: int = 1024, mesh=None,
                 slot_cap: int = 256, spmd_safe=None, force_merge_ingest: bool = False):
        self.state_cap = state_cap
        self.device = device
        self.slots: list = []
        # SPMD (``ShardedDataflow``): the rank's mesh. Each stateful
        # operator's input is exchanged to its key's owner first
        # (``maybe_exchange``); one rank is the identity.
        self.mesh = mesh
        self.num_shards = mesh.world_size if mesh is not None else 1
        self.rank = mesh.rank if mesh is not None else 0
        # Per-destination send-slot tier of every exchange, doubled on
        # an ("x", site) overflow and read at every tick.
        self.slot_cap = quantize_cap(slot_cap)
        self.n_exchanges = 0
        # Append slots of operator-state spines (0: merge ingest). Under
        # SPMD a ring needs a shard-local cursor (``spmd_safe``): each
        # rank's cursor lives in its own process, so a sharded render
        # passes True. ``force_merge_ingest``: the generic layout an
        # async install serves first (``compile/worker.py``), merge
        # ingest whatever the decision.
        self.ingest_slots = (
            INGEST_RING_SLOTS
            if not force_merge_ingest
            and state_ingest_mode(state_cap, spmd=self.num_shards > 1,
                                  spmd_safe=spmd_safe) == "append_slot"
            else 0
        )
        self.join_caps: list = []
        self.default_join_cap = quantize_cap(join_cap)
        # Per-LetRec-site binding-delta tier, doubled on overflow.
        self.letrec_caps: list = []
        self.default_letrec_cap = 2048
        # Census of the LetRec sites: the value evaluations of each run
        # (one entry per site and tick, replays included) and the
        # device->host readbacks of the pending-row count.
        self.letrec_evals: list = []
        self.letrec_readbacks = 0
        # A step recorder's hook (``analysis/step_lint.py``), called with
        # (("letrec", site), binding deltas) after every evaluation.
        self.carry_probe = None
        # While a LetRec's values are built: its binding names. While its
        # evaluations after the first run: True (their sources are empty).
        self.letrec_names: frozenset = frozenset()
        self.sources_quiet = False
        # The dataflow's first processed time (its as_of), where a
        # Constant emits its rows; set by the first dispatch.
        self.first_time: int | None = None
        # The physical plan each Reduce and Join rendered, read from the
        # operators built (op, plan text as EXPLAIN PHYSICAL PLAN prints
        # it): the runtime side of plan/lowering.py's LIR.
        self.lir: list = []
        # Reduce sites with basic (collection) aggregates: (MIR node id,
        # state slot, ReduceOp). The dataflow resolves them against its
        # top-level expression into edge finalizers
        # (``_resolve_basic_sites``).
        self.basic_sites: list = []

    def new_slot(self, init: tuple) -> int:
        self.slots.append(init)
        return len(self.slots) - 1

    def new_join_site(self) -> int:
        self.join_caps.append(self.default_join_cap)
        return len(self.join_caps) - 1

    @property
    def sharded(self) -> bool:
        return self.num_shards > 1

    def new_exchange_site(self) -> int:
        self.n_exchanges += 1
        return self.n_exchanges - 1

    def maybe_exchange(self, batch: Batch, key, site: int, ovf: dict,
                       null_aware: bool = True):
        """Route ``batch`` by ``key`` to the owning ranks (the identity on
        one rank); records the site's flag under ``("x", site)``."""
        if not self.sharded:
            return batch, ovf
        from ..parallel.exchange import exchange

        routed, overflow = exchange(batch, key, self.mesh, self.num_shards,
                                    self.slot_cap, null_aware)
        ovf = dict(ovf)
        ovf[("x", site)] = overflow
        return routed, ovf

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over the ranks (the identity on one)."""
        return self.mesh.psum(t) if self.sharded else t


def _gets(expr: mir.RelationExpr) -> set:
    """Names of every collection a subtree reads."""
    if isinstance(expr, mir.Get):
        return {expr.name}
    out = set()
    for c in expr.children():
        out |= _gets(c)
    return out


def _source_only(expr: mir.RelationExpr, ctx: _RenderContext):
    """A subtree of a LetRec value that reads no binding. After the first
    evaluation of a tick its sources are empty, and a stateful operator
    stepped on an empty delta keeps its state and emits nothing, so the
    subtree is not run then: it yields an empty batch and false flags
    under the keys of its first run, and a linear join taking it as a
    side skips that side's insert and probe (the closure's
    ``source_only``). The reference runs it on count-0 deltas to the
    same states and rows."""
    names, ctx.letrec_names = ctx.letrec_names, frozenset()
    inner = _build(expr, ctx)
    ctx.letrec_names = names
    schema = expr.schema()
    keys: list = []

    def run(states, inputs, time, errs):
        if not ctx.sources_quiet:
            b, upd, ovf = inner(states, inputs, time, errs)
            keys[:] = list(ovf)
            return b, upd, ovf
        false = torch.zeros((), dtype=torch.bool, device=ctx.device)
        return Batch.empty(schema, 256, device=ctx.device), {}, {k: false for k in keys}

    run.source_only = True
    return run


def _build(expr: mir.RelationExpr, ctx: _RenderContext):
    """A closure (states, inputs, time, errs) -> (delta batch,
    {slot: new state}, {overflow key: device flag}); ``errs`` is the
    step's err sink (``expr/errors.py``)."""
    if ctx.letrec_names and not (_gets(expr) & ctx.letrec_names):
        return _source_only(expr, ctx)
    if isinstance(expr, mir.Get):
        name = expr.name

        def run(states, inputs, time, errs):
            return inputs[name], {}, {}

        return run

    if isinstance(expr, mir.Constant):
        return _build_constant(expr, ctx)

    if isinstance(expr, mir.Filter) and any(contains_mz_now(p) for p in expr.predicates):
        return _build_temporal_filter(expr, ctx)

    if isinstance(expr, (mir.Project, mir.Map, mir.Filter)):
        inner = _build(expr.input, ctx)
        arity = expr.input.schema().arity
        if isinstance(expr, mir.Project):
            mfp = MapFilterProject(arity, projection=expr.outputs)
        elif isinstance(expr, mir.Map):
            mfp = MapFilterProject(arity, expressions=expr.scalars)
        else:
            mfp = MapFilterProject(arity, predicates=expr.predicates)
        # MIR's naming (c{i}) is authoritative for a Map's output.
        out_schema = expr.schema() if isinstance(expr, mir.Map) else None

        def run(states, inputs, time, errs):
            b, upd, ovf = inner(states, inputs, time, errs)
            out = apply_mfp(mfp, b, time, errs)
            return (out if out_schema is None else out.replace(schema=out_schema)), upd, ovf

        return run

    if isinstance(expr, mir.Negate):
        inner = _build(expr.input, ctx)

        def run(states, inputs, time, errs):
            b, upd, ovf = inner(states, inputs, time, errs)
            return b.replace(diff=-b.diff), upd, ovf

        return run

    if isinstance(expr, mir.ArrangeBy):
        # Arrangements are shared implicitly (a Let's delta is computed
        # once): ArrangeBy is a planner hint.
        return _build(expr.input, ctx)

    if isinstance(expr, mir.Threshold):
        if plan_threshold(expr).kind != "Basic":
            raise NotImplementedError(f"threshold plan {plan_threshold(expr).kind}")
        op = ThresholdOp(expr.input.schema())
        slot = ctx.new_slot(op.init_state(ctx.state_cap, ctx.device))
        site = ctx.new_exchange_site()
        inner = _build(expr.input, ctx)
        all_cols = tuple(range(expr.input.schema().arity))

        def run(states, inputs, time, errs):
            b, upd, ovf = inner(states, inputs, time, errs)
            b, ovf = ctx.maybe_exchange(b, all_cols, site, ovf)
            new_state, out, overflow = op.step(states[slot], b, time)
            upd = dict(upd)
            upd[slot] = new_state
            ovf = dict(ovf)
            for part, flag in overflow.items():
                ovf[("state", slot, part)] = flag
            return out, upd, ovf

        return run

    if isinstance(expr, mir.FlatMap):
        inner = _build(expr.input, ctx)
        fsite = ctx.new_join_site()  # the fan-out's tier, like a join's
        out_schema = expr.schema()

        def run(states, inputs, time, errs):
            b, upd, ovf = inner(states, inputs, time, errs)
            out, overflow = flat_map(b, expr.func, expr.exprs, out_schema, time,
                                     ctx.join_caps[fsite])
            ovf = dict(ovf)
            ovf[("join", fsite)] = overflow
            return out, upd, ovf

        return run

    if isinstance(expr, mir.Reduce):
        op = ReduceOp(expr.input.schema(), expr.group_key, expr.aggregates)
        ctx.lir.append(("Reduce", f"{op.plan.describe()} group={list(expr.group_key)}"))
        slot = ctx.new_slot(op.init_state(ctx.state_cap, ctx.device))
        if op.basic_aggs:
            ctx.basic_sites.append((id(expr), slot, op))
        site = ctx.new_exchange_site()
        inner = _build(expr.input, ctx)
        group_key = expr.group_key

        def run(states, inputs, time, errs):
            b, upd, ovf = inner(states, inputs, time, errs)
            b, ovf = ctx.maybe_exchange(b, group_key, site, ovf)
            new_state, out, overflow = op.step(states[slot], b, time, errs)
            upd = dict(upd)
            upd[slot] = new_state
            ovf = dict(ovf)
            for part, flag in overflow.items():
                ovf[("state", slot, part)] = flag
            return out, upd, ovf

        return run

    if isinstance(expr, mir.Let):
        val = _build(expr.value, ctx)
        body = _build(expr.body, ctx)
        name = expr.name

        def run(states, inputs, time, errs):
            vb, upd, ovf = val(states, inputs, time, errs)
            # The binding's delta is computed once and shared by every Get.
            ob, u2, o2 = body(states, {**inputs, name: vb}, time, errs)
            return ob, {**upd, **u2}, {**ovf, **o2}

        return run

    if isinstance(expr, mir.Union):
        inners = [_build(i, ctx) for i in expr.inputs]

        def run(states, inputs, time, errs):
            parts, upd, ovf = [], {}, {}
            for f in inners:
                b, u, o = f(states, inputs, time, errs)
                parts.append(b)
                upd.update(u)
                ovf.update(o)
            return concat_batches(parts), upd, ovf

        return run

    if isinstance(expr, mir.TopK):
        op = TopKOp(expr.input.schema(), expr.group_key, expr.order_by, expr.limit,
                    expr.offset)
        slot = ctx.new_slot(op.init_state(ctx.state_cap, ctx.device))
        site = ctx.new_exchange_site()
        inner = _build(expr.input, ctx)
        group_key = expr.group_key

        def run(states, inputs, time, errs):
            b, upd, ovf = inner(states, inputs, time, errs)
            b, ovf = ctx.maybe_exchange(b, group_key, site, ovf)
            new_state, out, overflow = op.step(states[slot], b, time)
            upd = dict(upd)
            upd[slot] = new_state
            ovf = dict(ovf)
            for part, flag in overflow.items():
                ovf[("state", slot, part)] = flag
            return out, upd, ovf

        return run

    if isinstance(expr, mir.Join):
        if join_implementation(expr) == "delta":
            return _build_join_delta(expr, ctx)
        return _build_join_linear(expr, ctx)

    if isinstance(expr, mir.LetRec):
        return _build_letrec(expr, ctx)

    raise NotImplementedError(f"render of {type(expr).__name__} is not ported")


def _build_constant(expr: mir.Constant, ctx: _RenderContext):
    """The literal rows, emitted once: at the dataflow's first processed
    time (a hydrated dataflow never processes time 0), nothing after."""
    schema = expr.schema()
    rows = expr.rows
    n = len(rows)
    full = Batch.from_numpy(
        schema,
        [np.asarray([r[0][j] for r in rows], dtype=c.dtype) if n
         else np.zeros(0, dtype=c.dtype) for j, c in enumerate(schema.columns)],
        np.zeros(n, np.uint64), np.asarray([r[1] for r in rows], dtype=DIFF_DTYPE),
        capacity=capacity_tier(max(n, 1)), device=ctx.device,
    )
    none = full.replace(count=torch.zeros_like(full.count))

    def run(states, inputs, time, errs):
        # Under SPMD rank 0 alone emits the rows; the exchange in front
        # of a stateful consumer routes them to their owners.
        b = full if time == ctx.first_time and ctx.rank == 0 else none
        return b.replace(time=torch.full_like(b.time, time)), {}, {}

    return run


def _build_temporal_filter(expr: mir.Filter, ctx: _RenderContext):
    """The plain predicates first, then the window operator over the
    temporal ones. Its buffer is a state slot, its output tier a join
    site, both taken after the input's."""
    temporal = [p for p in expr.predicates if contains_mz_now(p)]
    plain = [p for p in expr.predicates if not contains_mz_now(p)]
    inner = _build(expr.input, ctx)
    mfp = MapFilterProject(expr.input.schema().arity, predicates=plain)
    from ..utils.dyncfg import COMPUTE_CONFIGS, ENABLE_TEMPORAL_FILTERS

    if not ENABLE_TEMPORAL_FILTERS(COMPUTE_CONFIGS):
        raise NotImplementedError(
            "temporal filters disabled by dyncfg enable_temporal_filters"
        )
    lo_exprs, hi_exprs = canonicalize_temporal(temporal)
    op = TemporalFilterOp(expr.input.schema(), tuple(lo_exprs), tuple(hi_exprs))
    slot = ctx.new_slot(op.init_state(ctx.state_cap, ctx.device))
    osite = ctx.new_join_site()

    def run(states, inputs, time, errs):
        b, upd, ovf = inner(states, inputs, time, errs)
        b = apply_mfp(mfp, b, time, errs)
        new_state, out, overflow, out_ovf = op.step(states[slot], b, time,
                                                    ctx.join_caps[osite])
        upd = dict(upd)
        upd[slot] = new_state
        ovf = dict(ovf)
        for part, flag in overflow.items():
            ovf[("state", slot, part)] = flag
        ovf[("join", osite)] = out_ovf
        return out, upd, ovf

    return run


def _build_join_delta(expr: mir.Join, ctx: _RenderContext):
    """Per-input update pipelines over shared arrangements. The state
    slot and the join site are taken before the inputs are built, as
    the reference takes them."""
    op = DeltaJoinOp(tuple(i.schema() for i in expr.inputs), expr.equivalences)
    ctx.lir.append(("Join", JoinPlan(
        "Delta", n_pipelines=len(op.pipelines),
        arrangements=tuple((j, tuple(k)) for j, k in op.arr_specs)).describe()))
    slot = ctx.new_slot(op.init_state(ctx.state_cap, ingest_slots=ctx.ingest_slots,
                                      device=ctx.device))
    jsite = ctx.new_join_site()
    inners = [_build(i, ctx) for i in expr.inputs]
    # Under SPMD every arrangement insert and every probe is preceded by
    # an exchange on its key (the half-join exchange).
    ex_sites = {("ins", p): ctx.new_exchange_site() for p in range(len(op.arr_specs))}
    for i, (steps, _) in enumerate(op.pipelines):
        for _j, _acc_key, _j_key, ap in steps:
            ex_sites[("probe", i, ap)] = ctx.new_exchange_site()

    def run(states, inputs, time, errs):
        deltas, upd, ovf = [], {}, {}
        for f in inners:
            b, u, o = f(states, inputs, time, errs)
            deltas.append(b)
            upd.update(u)
            ovf.update(o)

        def exchange_fn(b, key, tag):
            b2, ovf2 = ctx.maybe_exchange(b, key, ex_sites[tag], ovf, null_aware=False)
            ovf.update(ovf2)
            return b2

        new_state, out, st_ovf, j_ovf = op.step(
            states[slot], deltas, time, ctx.join_caps[jsite],
            exchange_fn if ctx.sharded else None)
        upd[slot] = new_state
        for part, flag in st_ovf.items():
            ovf[("state", slot, part)] = flag
        ovf[("join", jsite)] = j_ovf
        return out, upd, ovf

    return run


def _build_join_linear(expr: mir.Join, ctx: _RenderContext):
    """Left-fold binary ``JoinOp`` stages. The inputs are built first,
    then each stage takes its state slot and join site, as the
    reference takes them."""
    schemas = [i.schema() for i in expr.inputs]
    offsets = [0]
    for sch in schemas:
        offsets.append(offsets[-1] + sch.arity)
    inners = [_build(i, ctx) for i in expr.inputs]
    stages = []
    acc_schema = schemas[0]
    consumed_all: set = set()
    for i in range(1, len(expr.inputs)):
        left_key, right_key, consumed = join_stage_keys(expr, offsets, i)
        consumed_all.update(consumed)
        op = JoinOp(acc_schema, schemas[i], left_key, right_key)
        slot = ctx.new_slot(op.init_state(ctx.state_cap, ingest_slots=ctx.ingest_slots,
                                          device=ctx.device))
        jsite = ctx.new_join_site()
        # Both sides are exchanged on the stage key under SPMD.
        stages.append((op, slot, jsite, ctx.new_exchange_site(), ctx.new_exchange_site()))
        acc_schema = op.out_schema
    ctx.lir.append(("Join", JoinPlan("Linear", stages=tuple(
        LinearStagePlan(st[0].left_key, st[0].right_key) for st in stages)).describe()))
    if len(consumed_all) != len(expr.equivalences):
        # An equality inside one input would go unenforced.
        raise NotImplementedError(
            "equivalence class not consumable as a join key "
            "(intra-input equality: rewrite as Filter)"
        )

    # Inputs that are a LetRec's source-only subtrees: empty once the
    # LetRec's sources are (``_source_only``).
    source_only = [getattr(f, "source_only", False) for f in inners]

    def run(states, inputs, time, errs):
        deltas, upd, ovf = [], {}, {}
        for f in inners:
            b, u, o = f(states, inputs, time, errs)
            deltas.append(b)
            upd.update(u)
            ovf.update(o)
        quiet = [q and ctx.sources_quiet for q in source_only]
        acc, acc_quiet = deltas[0], quiet[0]
        for (op, slot, jsite, lsite, rsite), d_right, r_quiet in zip(
                stages, deltas[1:], quiet[1:]):
            if ctx.sharded:
                # A quiet side is empty on every rank alike: it skips
                # its exchange, and its flag stays false.
                false = torch.zeros((), dtype=torch.bool, device=ctx.device)
                if acc_quiet:
                    ovf[("x", lsite)] = false
                else:
                    acc, ovf = ctx.maybe_exchange(acc, op.left_key, lsite, ovf,
                                                  null_aware=False)
                if r_quiet:
                    ovf[("x", rsite)] = false
                else:
                    d_right, ovf = ctx.maybe_exchange(d_right, op.right_key, rsite, ovf,
                                                      null_aware=False)
            new_state, acc, st_ovf, j_ovf = op.step(states[slot], acc, d_right, time,
                                                   ctx.join_caps[jsite],
                                                   quiet=(acc_quiet, r_quiet))
            acc_quiet = acc_quiet and r_quiet
            upd[slot] = new_state
            for part, flag in st_ovf.items():
                ovf[("state", slot, part)] = flag
            ovf[("join", jsite)] = j_ovf
        return acc, upd, ovf

    return run


def _err_counts(err_batches: list, device) -> torch.Tensor:
    """An iteration's err batches as a per-code count vector."""
    counts = torch.zeros(_errors.N_CODES, dtype=torch.int64, device=device)
    for eb in err_batches:
        code = torch.clamp(eb.cols[0].to(torch.int64), 0, _errors.N_CODES - 1)
        counts.index_add_(0, code, torch.where(eb.valid_mask(), eb.diff, 0))
    return counts


def _build_letrec(expr: mir.LetRec, ctx: _RenderContext):
    """WITH MUTUALLY RECURSIVE as semi-naive fixpoint iteration, the
    reference's ``jax.lax.while_loop`` run as a host loop:

    - evaluation 0 sees the tick's source deltas and empty binding
      deltas; evaluation k sees empty source deltas and evaluation k-1's
      binding deltas. Stateful operators inside the values carry their
      state through the iterations;
    - the values are evaluated again while fewer than ``max_iters``
      evaluations have run (None: the reference's cap of 100,000) and
      some binding delta is non-empty: the port evaluates them exactly
      as often as the reference, and when a float fixpoint is not
      reached that count decides the answer (RETURN AT RECURSION LIMIT);
    - stopping rule: the pending-row count (the binding deltas' counts,
      summed on the device) is read back once per iteration, before the
      next evaluation, and never once ``max_iters`` is reached. An
      iteration is hundreds of eager launches over the bindings' tiers,
      so one readback each drains little, and reading less often would
      run empty evaluations; they would change no state, but would cost
      a full iteration each. The readbacks are counted in
      ``ctx.letrec_readbacks`` apart from the span's one overflow-flags
      readback, which they leave as it is: every flag of the loop is
      OR-ed on the device;
    - binding deltas and the per-tick totals the body reads are shrunk
      to the site's tier (overflow key ``("lr", site, binding)``);
    - errors raised inside the loop ride it as a per-code count vector
      and reach the step's err sink once, after the loop;
    - the subtrees of the values that read no binding run only in the
      first evaluation (``_source_only``);
    - the spines of the joins inside the values take merge ingest, never
      a slot ring: a ring of 8 slots cannot hold the inserts of up to
      ``max_iters`` evaluations in one tick, and the reference's ring
      overwrites its unflushed slots when its cursor wraps there. With
      merge ingest a spine's tail grows, rolls back and replays instead.
    """
    names = expr.names
    schemas = expr.value_schemas
    ring, outer = ctx.ingest_slots, ctx.letrec_names
    # A subtree reading an enclosing LetRec's binding is no source either.
    ctx.ingest_slots, ctx.letrec_names = 0, outer | frozenset(names)
    value_fns = [_build(v, ctx) for v in expr.values]
    ctx.ingest_slots, ctx.letrec_names = ring, outer
    body_fn = _build(expr.body, ctx)
    site = len(ctx.letrec_caps)
    ctx.letrec_caps.append(ctx.default_letrec_cap)
    max_iters = expr.max_iters if expr.max_iters is not None else 100_000

    def run(states, inputs, time, errs):
        cap = ctx.letrec_caps[site]
        dev = ctx.device

        def run_values(states_l, it_inputs):
            """One evaluation: (states, binding deltas, flags, err counts)."""
            states_l = list(states_l)
            ovf, deltas, it_errs = {}, [], []
            for i, fn in enumerate(value_fns):
                d, upd, o = fn(states_l, it_inputs, time, it_errs)
                for k, v in upd.items():
                    states_l[k] = v
                ovf.update(o)
                d = consolidate(d, include_time=False)
                d, so = shrink(d, cap)
                if d.capacity != cap:
                    d = d.with_capacity(cap)
                ovf[("lr", site, i)] = so
                deltas.append(d.replace(schema=schemas[i]).canonicalize_nulls())
            return states_l, deltas, ovf, _err_counts(it_errs, dev)

        it0_inputs = dict(inputs)
        for nm, sch in zip(names, schemas):
            it0_inputs[nm] = Batch.empty(sch, cap, device=dev)
        states_l, deltas, ovf, err_counts = run_values(states, it0_inputs)
        if ctx.carry_probe is not None:
            ctx.carry_probe(("letrec", site), deltas)
        accums = list(deltas)
        ovf_keys = sorted(ovf)

        def pack(o):
            return torch.stack([o[k].reshape(()).to(torch.bool) for k in ovf_keys])

        flags = pack(ovf)
        # The sources are empty from here on; ``_source_only`` subtrees
        # do not even run.
        empty_inputs = {k: b.replace(count=torch.zeros_like(b.count))
                        for k, b in inputs.items()}
        it = 1
        while it < max_iters:
            ctx.letrec_readbacks += 1
            pending = sum(d.count.to(torch.int32) for d in deltas).reshape(1)
            # Under SPMD every rank stops at the same evaluation.
            if int(ctx.psum(pending)) == 0:
                break
            it_inputs = dict(empty_inputs)
            it_inputs.update(zip(names, deltas))
            quiet, ctx.sources_quiet = ctx.sources_quiet, True
            states_l, deltas, o, errs_n = run_values(states_l, it_inputs)
            ctx.sources_quiet = quiet
            if ctx.carry_probe is not None:
                ctx.carry_probe(("letrec", site), deltas)
            new_accums = []
            for i, (a, d) in enumerate(zip(accums, deltas)):
                m = consolidate(concat_batches([a, d]), include_time=False)
                m, so = shrink(m, cap)
                o[("lr", site, i)] = o[("lr", site, i)] | so
                new_accums.append(m.canonicalize_nulls())
            if sorted(o) != ovf_keys:
                raise AssertionError("LetRec overflow keys drifted")
            accums = new_accums
            flags = flags | pack(o)
            err_counts = err_counts + errs_n
            it += 1
        ctx.letrec_evals.append(it)
        if errs is not None:
            # Zero-count codes consolidate away downstream.
            errs.append(Batch(
                cols=(torch.arange(_errors.N_CODES, dtype=torch.int64, device=dev),),
                nulls=(None,),
                time=torch.full((_errors.N_CODES,), time, dtype=torch.int64, device=dev),
                diff=err_counts,
                count=torch.tensor(_errors.N_CODES, dtype=torch.int32, device=dev),
                schema=ERR_SCHEMA,
            ))
        # The body reads the real inputs and the tick's total binding deltas.
        body_inputs = dict(inputs)
        body_inputs.update(zip(names, accums))
        out, upd_b, ovf_b = body_fn(states_l, body_inputs, time, errs)
        upd = dict(enumerate(states_l))
        upd.update(upd_b)
        ovf_out = {k: flags[i] for i, k in enumerate(ovf_keys)}
        ovf_out.update(ovf_b)
        return out, upd, ovf_out

    return run


def _scalar_col_refs(e, out: set) -> None:
    from ..expr import scalar as ms

    if isinstance(e, ms.ColumnRef):
        out.add(e.index)
        return
    for f in getattr(e, "__dataclass_fields__", {}):
        v = getattr(e, f)
        if isinstance(v, ms.ScalarExpr):
            _scalar_col_refs(v, out)
        elif isinstance(v, tuple):
            for x in v:
                if isinstance(x, ms.ScalarExpr):
                    _scalar_col_refs(x, out)


def _resolve_basic_sites(expr: mir.RelationExpr, ctx) -> list:
    """Resolve basic-aggregate Reduce sites against the dataflow's
    top-level expression.

    A basic aggregate's device column is an opaque digest; its real
    (variable-width) value exists only at the serving edge. The digest
    may flow to the output through Project/Map/Filter layers that do
    not COMPUTE on it; anything else would leak digests into real
    operators, so it raises. Returns
    [(output col, state slot, state part, AggregateExpr, value Column,
      key_out_cols)] where key_out_cols maps each group-key column to
    its position in the OUTPUT schema (None if any key column was
    projected away — finalization then falls back to digest-only
    lookup).
    """
    if not ctx.basic_sites:
        return []
    chain = []
    node = expr
    while isinstance(node, (mir.Project, mir.Map, mir.Filter)):
        chain.append(node)
        node = node.input
    sites = {nid: (slot, op) for (nid, slot, op) in ctx.basic_sites}
    finalizers: list = []
    if id(node) in sites:
        slot, op = sites.pop(id(node))
        pos: dict = {}
        # Track the group-key columns through the chain too: when they
        # all survive to the output, finalization keys its lookup by
        # group key (digest demoted to a consistency check) — a 64-bit
        # digest collision between two groups then raises instead of
        # silently serving one group's result for the other.
        keypos: dict = {k: k for k in range(op.n_key)}
        for b, (j, agg) in enumerate(op.basic_aggs):
            part = 1 + len(op.hier_aggs) + b
            vcol = agg.expr.typ(op.input_schema)
            pos[op.n_key + j] = (slot, part, agg, vcol)
        for layer in reversed(chain):
            if isinstance(layer, (mir.Map, mir.Filter)):
                exprs = (
                    layer.scalars
                    if isinstance(layer, mir.Map)
                    else layer.predicates
                )
                refs: set = set()
                for e in exprs:
                    _scalar_col_refs(e, refs)
                if refs & set(pos):
                    raise NotImplementedError(
                        "string_agg/array_agg/list_agg results cannot "
                        "feed scalar expressions or filters: the "
                        "maintained device column is a digest, "
                        "finalized only at the serving edge"
                    )
            else:  # Project
                pos = {
                    o: pos[srcidx]
                    for o, srcidx in enumerate(layer.outputs)
                    if srcidx in pos
                }
                inv = {}
                for o, srcidx in enumerate(layer.outputs):
                    for k, p in keypos.items():
                        if p == srcidx and k not in inv:
                            inv[k] = o
                keypos = inv
        key_out = (
            tuple(keypos[k] for k in range(op.n_key))
            if len(keypos) == op.n_key
            else None
        )
        finalizers = [(o, *v, key_out) for o, v in pos.items()]
    if sites:
        raise NotImplementedError(
            "string_agg/array_agg/list_agg must sit at the dataflow "
            "output (optionally under Project/Map/Filter); composing "
            "them into joins, further reduces, or other operators is "
            "not supported"
        )
    return finalizers


def _element_strings(vcol, vals: np.ndarray, vnulls, gdict) -> np.ndarray:
    """The text of each multiset element (host side): each distinct
    value rendered once, NULL elements (array_agg/list_agg keep them)
    as pg's array NULL. ``gdict`` is the caller's dictionary snapshot."""
    from ..repr.schema import ColumnType, days_to_date, ms_to_ts

    def render(v) -> str:
        if vcol.ctype is ColumnType.STRING:
            return gdict.decode(int(v))
        if vcol.ctype is ColumnType.BOOL:
            return "t" if v else "f"
        if vcol.ctype is ColumnType.DECIMAL and vcol.scale:
            q = 10 ** vcol.scale
            sign = "-" if v < 0 else ""
            v = abs(int(v))
            return f"{sign}{v // q}.{v % q:0{vcol.scale}d}"
        if vcol.ctype is ColumnType.DATE:
            return str(days_to_date(v))
        if vcol.ctype is ColumnType.TIMESTAMP:
            return str(ms_to_ts(v))
        return str(int(v))

    live = np.ones(len(vals), bool) if vnulls is None else ~np.asarray(vnulls, bool)
    uniq, inv = np.unique(vals[live], return_inverse=True)
    table = np.empty(len(uniq), dtype=object)
    table[:] = [render(v) for v in uniq.tolist()]
    out = np.empty(len(vals), dtype=object)
    out[live] = table[inv.reshape(-1)]
    out[~live] = "NULL"
    return out


def _finalize_basic_value(agg, parts: list) -> str:
    """One group's result from its elements' text in multiset order,
    each repeated by its multiplicity: string_agg joins them with its
    separator, array_agg and list_agg render pg's ``{a,b}``."""
    if agg.func is mir.AggregateFunc.STRING_AGG:
        sep = agg.params[0] if agg.params else ""
        return sep.join(parts)
    return "{" + ",".join(parts) + "}"


def _host_rows(b: Batch, idx=None) -> dict:
    """Host view of a multiset batch's valid rows (or of the rows at
    ``idx``, a device index tensor): columns, null flags and diffs,
    brought over in one stacked copy (each tensor as int64 bits)."""
    if idx is None:
        n = int(b.count)
        take = lambda t: t[:n]  # noqa: E731
    else:
        take = lambda t: t[idx]  # noqa: E731
    parts = list(b.cols) + [x for x in b.nulls if x is not None] + [b.diff]
    host = torch.stack([
        take(t).view(torch.int64) if t.dtype == torch.float64 else take(t).to(torch.int64)
        for t in parts
    ]).cpu().numpy()
    out = []
    for row, t in zip(host, parts):
        dtype = torch.empty(0, dtype=t.dtype).numpy().dtype
        out.append(row.view(np.float64) if t.dtype == torch.float64 else row.astype(dtype))
    cols = out[: len(b.cols)]
    flags = iter(out[len(b.cols):-1])
    return {
        "cols": cols,
        "nulls": [None if x is None else next(flags) for x in b.nulls],
        "diff": out[-1],
    }


def _key_tuples(kcols: list, knulls: list, rows) -> list:
    """The group-key tuple of each of ``rows`` (None for a NULL key)."""
    cols = []
    for kc, nl in zip(kcols, knulls):
        vals = kc[rows].tolist()
        if nl is not None:
            vals = [None if n else v for v, n in zip(vals, nl[rows].tolist())]
        cols.append(vals)
    return list(zip(*cols)) if cols else [() for _ in range(len(rows))]


def _group_results(rows: dict, n_key: int, agg, vcol, gdict) -> tuple:
    """(keys, digests, results) of the groups of key-sorted multiset
    rows: groups are contiguous (rows sort by key, NULL keys first); a
    group's digest is the wrapping sum of mix64(value) * diff the reduce
    keeps (``_NULL_DIGEST`` for a NULL element), its result the text of
    its elements in multiset order."""
    from ..ops.reduce import _NULL_DIGEST, _mix64_host

    cols, nulls, diffs = rows["cols"], rows["nulls"], rows["diff"]
    keep = diffs != 0
    vals = cols[n_key][keep].astype(np.int64)
    if not len(vals):
        return [], [], []
    vnl = nulls[n_key]
    vnl = vnl[keep] if vnl is not None else None
    mult = diffs[keep]
    kcols = [cols[k][keep] for k in range(n_key)]
    knulls = [None if nulls[k] is None else nulls[k][keep] for k in range(n_key)]
    change = np.zeros(len(vals), dtype=bool)
    change[0] = True
    for kc, nl in zip(kcols, knulls):
        if nl is None:
            change[1:] |= kc[1:] != kc[:-1]
        else:
            both = ~nl[1:] & ~nl[:-1]
            change[1:] |= (nl[1:] != nl[:-1]) | (both & (kc[1:] != kc[:-1]))
    starts = np.flatnonzero(change)
    m = _mix64_host(vals).astype(np.uint64)
    if vnl is not None:
        m = np.where(vnl, np.int64(_NULL_DIGEST).astype(np.uint64), m)
    digests = np.add.reduceat(m * mult.astype(np.uint64), starts).astype(np.int64)
    # Each element repeated by its multiplicity, then each group's span.
    rep = np.maximum(mult, 0)
    elems = np.repeat(_element_strings(vcol, vals, vnl, gdict), rep).tolist()
    edge = np.concatenate([[0], np.cumsum(rep)])
    bounds = edge[np.append(starts, len(vals))].tolist()
    results = [_finalize_basic_value(agg, elems[a:b]) for a, b in zip(bounds, bounds[1:])]
    return _key_tuples(kcols, knulls, starts), digests.tolist(), results


class Dataflow:
    """A maintained dataflow on one device: install once, feed update
    batches (``step``/``run_steps``/``run_span``), peek."""

    def __init__(self, expr: mir.RelationExpr, name: str = "df",
                 state_cap: int = 256, out_levels: int = 2,
                 out_slots: int | None = None, device=None,
                 force_merge_ingest: bool = False):
        self.device = resolve_device(device)
        self.expr = expr
        self.name = name
        self.out_schema = expr.schema()
        self.state_cap = quantize_cap(state_cap)
        # Output deltas are shrunk to this tier before the index insert.
        self.out_delta_cap = 4096
        # The generic layout of an async install: merge ingest for the
        # state spines and the output index.
        self.force_merge_ingest = force_merge_ingest
        if force_merge_ingest:
            out_slots = 0
        if out_slots is None:
            out_slots = (
                INGEST_RING_SLOTS
                if ingest_mode(self.state_cap, self.out_delta_cap) == "append_slot"
                else 0
            )
        ctx = self._new_context()
        self._ctx = ctx
        self._run = _build(expr, ctx)
        self._basic_finalizers = _resolve_basic_sites(expr, ctx)
        # One tuple of state parts per stateful operator (slot).
        self.states = list(ctx.slots)
        self.output = Spine.empty(
            self.out_schema, tuple(range(self.out_schema.arity)), self._output_cap,
            tail_capacity=self.out_delta_cap, order="hash", levels=out_levels,
            ingest_slots=out_slots, device=self.device,
        )
        # The err collection beside the data output: (err_code, time,
        # diff) rows; nonempty means reads of this dataflow must raise.
        self.err_output = Arrangement.empty(ERR_SCHEMA, (0,), 256, device=self.device)
        # Whether a step can push errors (its plan has an err site): a
        # fact of the plan, learnt at the first step.
        self._has_errors = False
        # Step overflow keys in the reference's sorted order (set by the
        # first step: they are a fact of the plan).
        self._ovf_keys: list = []
        self._time = 0
        # Compaction schedule: every `_compact_every` ticks fold level 0;
        # level l every `_compact_every * _compact_ratio**l` ticks.
        self._compact_every = 8
        self._compact_ratio = 8
        self._compact_tick = 0
        self._covf_keys = self._compact_keys()
        # Census: device->host flag readbacks, and spine folds run (each
        # fold is at least one merge, i.e. one merge-search launch).
        self._readbacks = 0
        self._folds = 0
        # Every tier key grown on overflow, in order (replays included).
        self._grown: list = []
        # The corrected per-step deltas of the last rollback and replay
        # (``check_flags``), in dispatch order: a sink must forward
        # these, not the provisional deltas of the overflowed span.
        self.replayed_deltas: list = []
        self._defer_ck = None
        self._defer_log: list = []
        self._defer_flags = None
        self._defer_cflags = None
        # The pipelined span executor (render/span_exec.py) or a
        # maintained view's span pipeline, when one is attached: state
        # reads sequence through its barrier (``span_barrier``).
        self._span_exec = None

    # Base capacity of the output index.
    _output_cap = 256

    def _new_context(self) -> _RenderContext:
        return _RenderContext(self.state_cap, self.device,
                              force_merge_ingest=self.force_merge_ingest)

    # -- schedule -----------------------------------------------------------
    @staticmethod
    def _state_run_key(slot: int, part: int):
        """Flag key of a state spine's run: ``("state", slot, (part, run))``."""
        return lambda run: ("state", slot, (part, run))

    @staticmethod
    def _out_run_key(run) -> tuple:
        return ("out", run)

    def _spines(self) -> list:
        """(run flag key, spine) of every state spine, then the output's."""
        out = [
            (self._state_run_key(slot, p), sp)
            for slot, parts in enumerate(self.states)
            for p, sp in enumerate(parts)
            if isinstance(sp, Spine)
        ]
        return out + [(self._out_run_key, self.output)]

    def _compact_keys(self) -> list:
        """The fold flags' keys, in the reference's order: every state
        spine's target runs, then the output's. A slotted spine's level-0
        flush targets run 0, a slotless spine's first fold run 1."""
        keys = []
        for key, sp in self._spines():
            first = 0 if sp.slots else 1
            keys += [key(first + lvl) for lvl in range(compact_depth(sp))]
        return keys

    @property
    def time(self) -> int:
        """Frontier: every tick < time is complete."""
        return self._time

    @time.setter
    def time(self, v: int) -> None:
        # External assignment (a MaintainedView aligning the dataflow to
        # a shard's as_of). The port keeps no device copy of the time.
        self._time = v

    def gather_delta(self, out: Batch) -> Batch:
        """A step's output delta as the sink reads it: one device holds
        it whole, so this is the delta itself (the reference's sharded
        dataflow gathers per-worker shards here)."""
        return out

    # -- basic-aggregate edge finalization -----------------------------------
    def capture_basic_multisets(self) -> dict:
        """The pre-step multiset of every basic-aggregate finalizer: the
        sink finalizes retraction rows against the state their digests
        describe, which the post-step multiset no longer holds. A state
        part is an immutable value (a step returns new tensors), so the
        capture is the part itself: no copy, no readback."""
        return {
            fi: self.states[slot][part]
            for fi, (_oc, slot, part, *_rest) in enumerate(self._basic_finalizers)
        }

    def _basic_group_maps(self, multisets: dict | None = None) -> list:
        """Per finalizer, {digest: result} over every group of the
        multiset (or of a capture): the lookup of outputs that project
        the group key away."""
        from ..repr.schema import GLOBAL_DICT

        gdict = GLOBAL_DICT.snapshot()
        maps = []
        for fi, (_oc, slot, part, agg, vcol, _ko) in enumerate(self._basic_finalizers):
            arr = multisets[fi] if multisets is not None else self.states[slot][part]
            _keys, digests, results = _group_results(
                _host_rows(arr.batch), len(arr.key), agg, vcol, gdict)
            maps.append(dict(zip(digests, results)))
        return maps

    def _basic_key_map(self, arr, keys: list, agg, vcol, gdict) -> dict:
        """{group key: (digest, result)} of the groups ``keys`` name,
        read from the multiset ``arr``: one search of the multiset for
        the keys' row ranges, one gather of those rows."""
        n_key = len(arr.key)
        if n_key == 0:
            rows = _host_rows(arr.batch)
        else:
            sch = Schema(tuple(arr.schema.columns[:n_key]))
            cols, nulls = [], []
            for k, col in enumerate(sch.columns):
                nl = np.array([key[k] is None for key in keys], dtype=bool)
                cols.append(np.array([0 if v is None else v for v in (key[k] for key in keys)],
                                     dtype=col.dtype))
                nulls.append(nl if col.nullable else None)
            probe = Batch.from_numpy(sch, cols, np.zeros(len(keys), np.int64),
                                     np.ones(len(keys), np.int64), nulls=nulls,
                                     device=arr.batch.device)
            lo, hi = lookup_range(arr, arr.probe_lanes(probe, range(n_key)))
            lo, hi = torch.stack([lo[: len(keys)], hi[: len(keys)]]).cpu().numpy().astype(np.int64)
            n = hi - lo
            # Each key's rows in ascending order, keys in multiset order.
            order = np.argsort(lo, kind="stable")
            lo, n = lo[order], n[order]
            idx = np.repeat(lo - np.cumsum(n) + n, n) + np.arange(int(n.sum()))
            rows = _host_rows(arr.batch, torch.from_numpy(idx).to(arr.batch.device))
        got_keys, digests, results = _group_results(rows, n_key, agg, vcol, gdict)
        return dict(zip(got_keys, zip(digests, results)))

    def finalize_basic_columns(self, cols, nulls, diffs=None,
                               old_multisets=None) -> list:
        """Edge finalization of basic aggregates: each digest value of
        the host output columns becomes its group's result string (an
        object column; ``decode_result_rows`` passes it through), made
        from the maintained (key, value) multiset.

        Where every group-key column reaches the output, only the groups
        of the given rows are finalized, found by a search of the
        multiset, and the lookup is by group key with the digest as a
        consistency check (a digest collision between groups raises
        instead of serving another group's result). Outputs that project
        the key away look up by digest over every group.

        With ``diffs`` and ``old_multisets`` (the sink's delta path),
        retraction rows (diff < 0) resolve against the captured pre-step
        multisets: their digests describe group states the current
        multiset no longer holds."""
        if not self._basic_finalizers:
            return list(cols)
        from ..repr.schema import GLOBAL_DICT

        gdict = GLOBAL_DICT.snapshot()
        cols = list(cols)
        digest_maps: dict = {}  # pre-step (True) or current: {digest: result}s
        for fi, (out_col, slot, part, agg, vcol, key_out) in enumerate(
            self._basic_finalizers
        ):
            src = np.asarray(cols[out_col])
            out = np.empty(len(src), dtype=object)
            nl = nulls[out_col] if nulls else None
            live = np.ones(len(src), dtype=bool) if nl is None else ~np.asarray(nl, bool)
            retract = (
                np.asarray(diffs) < 0
                if diffs is not None and old_multisets is not None
                else np.zeros(len(src), dtype=bool)
            )
            for old in (False, True):
                rows_i = np.flatnonzero(live & (retract if old else ~retract))
                if not len(rows_i):
                    continue
                arr = old_multisets[fi] if old else self.states[slot][part]
                if key_out is None:
                    if old not in digest_maps:
                        digest_maps[old] = self._basic_group_maps(
                            old_multisets if old else None)
                    by_digest = digest_maps[old][fi]
                    for i in rows_i:
                        d = int(src[i])
                        if d not in by_digest:
                            raise RuntimeError(
                                "basic-aggregate digest has no multiset "
                                "group (digest/multiset divergence)"
                            )
                        out[i] = by_digest[d]
                    continue
                row_keys = _key_tuples(
                    [np.asarray(cols[ko]) for ko in key_out],
                    [None if nulls[ko] is None else np.asarray(nulls[ko], bool)
                     for ko in key_out],
                    rows_i)
                by_key = self._basic_key_map(arr, list(dict.fromkeys(row_keys)),
                                             agg, vcol, gdict)
                for i, kt, d in zip(rows_i.tolist(), row_keys, src[rows_i].tolist()):
                    hit = by_key.get(kt)
                    if hit is None:
                        raise RuntimeError(
                            "basic-aggregate group has no multiset "
                            "entry (state divergence)"
                        )
                    dig, res = hit
                    if dig != d:
                        raise RuntimeError(
                            "basic-aggregate digest mismatch for group "
                            f"{kt!r} (digest/multiset divergence)"
                        )
                    out[i] = res
            cols[out_col] = out
        return cols

    def _due_levels(self, tick: int) -> int:
        """Highest spine level due at compaction tick ``tick``."""
        lvl = 0
        period = self._compact_every * self._compact_ratio
        while tick % period == 0:
            lvl += 1
            period *= self._compact_ratio
        return lvl

    def _max_compact_level(self) -> int:
        """Deepest fold index any spine of this dataflow can take."""
        return max(compact_depth(sp) for _, sp in self._spines()) - 1

    def _check_slot_ring(self) -> None:
        """A slot ring must hold every insert between level-0 flushes
        (a wrapped cursor would overwrite unflushed slots silently)."""
        for _, sp in self._spines():
            if sp.slots and len(sp.slots) < self._compact_every:
                raise ValueError(
                    f"ingest slot ring ({len(sp.slots)}) smaller than "
                    f"compact_every ({self._compact_every}): inserts would "
                    "overwrite unflushed slots"
                )

    # -- growth -------------------------------------------------------------
    def _grow_for(self, key, target: int | None = None) -> None:
        """Grow the capacity tier behind an overflowed key: one doubling,
        or straight to ``target`` (snapped to the pow2 menu)."""
        if target is not None:
            target = quantize_cap(target)
        else:
            self._grown.append(key)

        def grow(b):
            return self._grow_batch(b, target)

        if key[0] == "state":
            _, slot, part = key
            parts = list(self.states[slot])
            if isinstance(part, tuple):  # a spine's run: (part, which)
                p, which = part
                parts[p] = self._grow_spine(parts[p], which, target)
            else:
                parts[part] = parts[part].map_batches(grow)
            self.states[slot] = tuple(parts)
        elif key[0] == "out":
            self.output = self._grow_spine(self.output, key[1], target)
        elif key[0] == "join":
            # Read by the join's closure at every tick: the replay runs
            # at the doubled tier.
            self._ctx.join_caps[key[1]] *= 2
        elif key[0] == "lr":
            self._ctx.letrec_caps[key[1]] *= 2
        elif key[0] == "outd":
            self.out_delta_cap *= 2
        elif key[0] == "errout":
            self.err_output = self.err_output.map_batches(grow)
        else:
            raise ValueError(f"unknown overflow key {key}")

    @staticmethod
    def _grow_batch(b: Batch, target: int | None = None) -> Batch:
        cap = target if target is not None else b.capacity * 2
        return b.with_capacity(cap) if cap > b.capacity else b

    @staticmethod
    def _pad_lanes(lanes: torch.Tensor, new_cap: int) -> torch.Tensor:
        """Zero-pad cached lanes to a grown run (pad lanes are garbage by
        contract; every lane reader bounds itself by the count)."""
        if lanes.shape[0] >= new_cap:
            return lanes
        return torch.cat([lanes, lanes.new_zeros((new_cap - lanes.shape[0], lanes.shape[1]))])

    def _grow_spine(self, spine: Spine, which, target: int | None = None) -> Spine:
        """Grow one run (index, "base" or "tail"; "tail" is the slot ring
        when there is one)."""
        if which == "tail" and spine.slots:
            new_slots = tuple(self._grow_batch(s, target) for s in spine.slots)
            slot_lanes = spine.slot_lanes
            if slot_lanes:
                slot_lanes = tuple(
                    self._pad_lanes(l, nb.capacity)
                    for l, nb in zip(slot_lanes, new_slots)
                )
            return spine._with(slots=new_slots, slot_lanes=slot_lanes)
        if which == "base":
            which = spine.levels - 1
        elif which == "tail":
            which = 0
        grown = self._grow_batch(spine.runs_b[which], target)
        lanes = None
        if spine.lanes:
            lanes = self._pad_lanes(spine.lanes[which], grown.capacity)
        return spine.with_run(which, grown, lanes)

    # -- one tick and one fold ----------------------------------------------
    def _step_core(self, states: list, output: Spine, err_output: Arrangement,
                   inputs: dict):
        """One tick: returns (output delta, states, output spine, err
        arrangement, step flags in ``_ovf_keys`` order)."""
        errs: list = []
        out, upd, ovf = self._run(states, inputs, self._time, errs)
        new_states = list(states)
        for k, v in upd.items():
            new_states[k] = v
        # The delta is what sinks would see: consolidate it.
        out = consolidate(out, include_time=True)
        out, shrink_ovf = shrink(out, self.out_delta_cap)
        new_output, out_ovf = insert_tail(output, out)
        ovf = dict(ovf)
        ovf[("outd",)] = shrink_ovf
        ovf[("out", "tail")] = out_ovf
        new_err = self._apply_err_delta(err_output, errs, ovf)
        self._ovf_keys = sorted(ovf)
        flags = torch.stack([ovf[k].reshape(()).to(torch.bool) for k in self._ovf_keys])
        return out, new_states, new_output, new_err, flags

    def _apply_err_delta(self, err_output: Arrangement, errs: list, ovf: dict):
        """Fold a step's err batches into the err arrangement (zero-diff
        rows, such as a Reduce's step with no sum crossing its bound,
        vanish in the consolidation). Adds the ``("errout",)`` flag."""
        self._has_errors = bool(errs)
        if not errs:
            return err_output
        delta = consolidate(concat_batches(errs), include_time=False)
        delta, shrink_ovf = shrink(delta, ERR_DELTA_CAP)
        new_err, err_ovf = insert(err_output, delta, out_capacity=err_output.capacity)
        ovf[("errout",)] = shrink_ovf | err_ovf
        return new_err

    def _fold(self, sp: Spine, max_level: int, key, flags: dict) -> Spine:
        """Fold levels [0, max_level] of one spine; records each target
        run's overflow flag under ``key(target run)``."""
        first = 0 if sp.slots else 1
        for lvl in range(min(max_level + 1, compact_depth(sp))):
            sp, flags[key(first + lvl)] = compact_level(sp, lvl)
            self._folds += 1
        return sp

    def _compact(self, max_level: int) -> torch.Tensor:
        """Fold levels [0, max_level] of every state spine and of the
        output spine; returns the per-target-run flags in
        ``_covf_keys`` order (False for levels not folded)."""
        flags: dict = {}
        self.states = [
            tuple(
                self._fold(sp, max_level, self._state_run_key(slot, p), flags)
                if isinstance(sp, Spine) else sp
                for p, sp in enumerate(parts)
            )
            for slot, parts in enumerate(self.states)
        ]
        self.output = self._fold(self.output, max_level, self._out_run_key, flags)
        false = torch.zeros((), dtype=torch.bool, device=self.device)
        return torch.stack([flags.get(k, false) for k in self._covf_keys])

    @staticmethod
    def _or(acc, fl):
        return fl if acc is None else acc | fl

    def _check_inputs(self, inputs: dict) -> None:
        for name, b in inputs.items():
            if b.device != self.device:
                raise ValueError(
                    f"input {name!r} is on {b.device}, dataflow on {self.device}"
                )

    def _dispatch(self, inputs_list: list, flush_first: bool):
        """Run ticks with the scheduled folds, issuing no device->host
        transfer: flags stay on the device, OR-accumulated. Returns
        (deltas, step-flag OR, compaction-flag OR)."""
        if self._ctx.first_time is None:
            self._ctx.first_time = self._time
        sfl, cfl = None, None
        if flush_first and self._compact_tick % self._compact_every:
            # Flush (full cascade) so the span's schedule starts clean.
            cfl = self._compact(self._max_compact_level())
            self._compact_tick = 0
        deltas = []
        for inputs in inputs_list:
            self._check_inputs(inputs)
            out, self.states, self.output, self.err_output, fl = self._step_core(
                self.states, self.output, self.err_output, inputs  # donated: ok(step operands)
            )
            deltas.append(out)
            sfl = self._or(sfl, fl)
            self._time += 1
            self._compact_tick += 1
            if self._compact_tick % self._compact_every == 0:
                cfl = self._or(
                    cfl,
                    self._compact(
                        min(self._due_levels(self._compact_tick),
                            self._max_compact_level())
                    ),
                )
        return deltas, sfl, cfl

    def _read_flags(self, sfl, cfl) -> list:
        """ONE device->host readback of both flag groups; returns the
        overflowed tier keys."""
        parts, keys = [], []
        if sfl is not None:
            parts.append(sfl)
            keys += self._ovf_keys
        if cfl is not None:
            parts.append(cfl)
            keys += self._covf_keys
        if not parts:
            return []
        self._readbacks += 1
        host = torch.cat(parts).cpu().tolist()  # host-sync: ok(the ONE flags readback)
        return [k for k, over in zip(keys, host) if over]

    # -- checkpoints --------------------------------------------------------
    def _checkpoint(self):
        return (list(self.states), self.output, self.err_output, self._time,
                self._compact_tick)

    def _clone_checkpoint(self):
        """A rollback checkpoint whose tensors are fresh copies. The
        reference needs it before a donated span, whose carry buffers
        die at dispatch. The port's steps return fresh state tensors, so
        a reference checkpoint (``_checkpoint``) is already safe; this
        one is taken when donation is requested, and is what a carry
        updated in place would need."""
        states, out, err = clone_state_tree(
            (tuple(self.states), self.output, self.err_output)
        )
        return (list(states), out, err, self._time, self._compact_tick)

    def _window_checkpoint(self, donate: bool) -> None:
        """Open a defer window's checkpoint before its first dispatch."""
        if self._defer_ck is None:
            self._defer_ck = (
                self._clone_checkpoint() if donate else self._checkpoint()
            )

    def _restore(self, ck) -> None:
        states, self.output, self.err_output, self._time, self._compact_tick = ck
        self.states = list(states)

    # -- public stepping ----------------------------------------------------
    def step(self, inputs: dict) -> Batch:
        """Feed one micro-batch per source; returns the output delta."""
        return self.run_steps([inputs])[-1]

    def run_steps(self, inputs_list: list, defer_check: bool = False,
                  donate: bool = False) -> list:
        """Feed several micro-batches. Synchronous by default: one flags
        readback at the end, and on overflow rollback, growth and replay.
        With ``defer_check`` even that readback waits for
        ``check_flags``; the returned deltas are provisional until then.
        ``donate`` asks for a cloned window checkpoint (see
        ``render/span_exec.py``: nothing is donated in eager torch)."""
        from ..utils.lockcheck import device_dispatch

        self.span_barrier()
        device_dispatch("run_steps")
        self._check_slot_ring()
        if defer_check:
            return self._defer(inputs_list, flush_first=False, donate=donate)
        self.check_flags()
        while True:
            ck = self._checkpoint()
            deltas, sfl, cfl = self._dispatch(inputs_list, flush_first=False)
            over = self._read_flags(sfl, cfl)
            if not over:
                return deltas
            self._restore(ck)
            for k in over:
                self._grow_for(k)

    def run_span(self, inputs_list: list, donate: bool = False) -> list:
        """Feed a span of micro-batches with deferred overflow checks.
        The span length must be a multiple of ``_compact_every``; the due
        folds run between its chunks. Returns the per-step output deltas
        (provisional until ``check_flags``)."""
        from ..utils.lockcheck import device_dispatch

        self.span_barrier()
        device_dispatch("run_span")
        ce = self._compact_every
        if len(inputs_list) % ce:
            raise ValueError(
                f"span length {len(inputs_list)} must be a multiple of "
                f"compact_every={ce}"
            )
        self._check_slot_ring()
        return self._defer(inputs_list, flush_first=True, donate=donate)

    def _defer(self, inputs_list: list, flush_first: bool,
               donate: bool = False) -> list:
        if donate:
            from ..analysis.donation import guard_read

            # Re-dispatching a donated buffer as an operand is itself a
            # use-after-donate (``buffer_sanitizer``; no-op when off).
            guard_read(inputs_list, f"{self.name}.run_steps operands")
        self._window_checkpoint(donate)
        deltas, sfl, cfl = self._dispatch(inputs_list, flush_first)
        self._defer_log.append((inputs_list, flush_first))
        if sfl is not None:
            self._defer_flags = self._or(self._defer_flags, sfl)
        if cfl is not None:
            self._defer_cflags = self._or(self._defer_cflags, cfl)
        return deltas

    def check_flags(self) -> bool:
        """Resolve deferred overflow checks with ONE flags readback. On
        overflow: roll back to the pre-defer checkpoint, grow the flagged
        tiers, replay the logged spans (synchronously, growing again if
        needed). Returns whether any overflow occurred."""
        sfl, cfl = self._defer_flags, self._defer_cflags
        log, ck = self._defer_log, self._defer_ck
        self._defer_flags = self._defer_cflags = None
        self._defer_log, self._defer_ck = [], None
        if sfl is None and cfl is None:
            return False
        over = self._read_flags(sfl, cfl)
        if not over:
            return False
        self._restore(ck)
        for k in over:
            self._grow_for(k)
        self.replayed_deltas = []
        for inputs_list, flush_first in log:
            while True:
                ck2 = self._checkpoint()
                deltas, s2, c2 = self._dispatch(inputs_list, flush_first)
                again = self._read_flags(s2, c2)
                if not again:
                    self.replayed_deltas.extend(deltas)
                    break
                self._restore(ck2)
                for k in again:
                    self._grow_for(k)
        return True

    # -- pipelined span boundaries (render/span_exec.py) ----------------------
    #
    # Dispatch span K+1, THEN read span K's accumulated overflow flags:
    # the copy of K's flags was queued on the stream right after K's
    # work, so waiting for it blocks exactly until K finished while K+1
    # is already queued behind it. One snapshot readback per span is the
    # span's whole device->host traffic.

    def flags_snapshot(self):
        """The OR-accumulated deferred overflow flags AS OF NOW, their
        copy to the host already queued. Flags accumulate monotonically,
        so a snapshot taken after dispatching span K covers every span
        <= K and nothing after. On a card the copy goes into pinned host
        memory without blocking, and an event marks its completion."""
        parts = [f for f in (self._defer_flags, self._defer_cflags)
                 if f is not None]
        if not parts:
            return None
        fused = torch.cat(parts) if len(parts) > 1 else parts[0]
        if fused.device.type != "cuda":
            return (fused, None)
        host = torch.empty(fused.shape, dtype=fused.dtype, pin_memory=True)
        host.copy_(fused, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return (host, event)

    def read_flags_snapshot(self, snap) -> bool:
        """ONE device->host readback of a flags snapshot; True if any
        overflow occurred up to the snapshot point (the caller then runs
        :meth:`check_flags` for the rollback and replay). Blocks until
        the snapshot's span has finished: the pipelined executor's one
        sync point a span."""
        if snap is None:
            return False
        host, event = snap
        if event is not None:
            event.synchronize()  # host-sync: ok(the ONE boundary readback per span)
        self._readbacks += 1
        return bool(host.any())  # host-sync: ok(pinned host copy of the flags)

    def span_barrier(self) -> None:
        """Sequence a state read against span boundaries: with a
        pipelined span executor attached, an in-flight span's frontier
        is provisional, so complete and commit it before reading
        dataflow state. No-op without an executor or from the
        executor's own dispatch."""
        ex = self._span_exec
        if ex is not None and not ex.in_dispatch:
            ex.sync()

    # -- reads --------------------------------------------------------------
    def _compact_now(self) -> None:
        """Fold every slot and run into the base, growing on overflow."""
        while True:
            ck = self._checkpoint()
            cfl = self._compact(self._max_compact_level())
            self._compact_tick = 0
            over = self._read_flags(None, cfl)
            if not over:
                return
            self._restore(ck)
            for k in over:
                self._grow_for(k)

    def output_batch(self) -> Batch:
        """Consolidated single-run view of the output index (forces a full
        compaction first)."""
        self.span_barrier()
        self.check_flags()
        self._compact_now()
        return self.output.base

    def output_records(self) -> int:
        """Approximate maintained row count (every run and ingest slot;
        rows whose diffs cancel across runs count until the next fold).
        Introspection only: one small device->host read. Not behind the
        span barrier, as in the reference: the replica reports it with
        every frontier change, and syncing there would serialize the
        double buffer; it may count rows an in-flight span inserts."""
        counts = [b.count for b in self.output.runs_b + tuple(self.output.slots)]
        return int(torch.stack(counts).sum().item())

    def peek(self) -> list:
        """The full maintained result (SELECT * FROM the index), with
        basic-aggregate columns finalized into their result strings."""
        b = self.output_batch()
        if not self._basic_finalizers:
            return b.to_rows()
        n = int(b.count)
        cols = [c[:n].cpu().numpy() for c in b.cols]
        nulls = [None if x is None else x[:n].cpu().numpy() for x in b.nulls]
        cols = self.finalize_basic_columns(cols, nulls)
        cols = cols + [b.time[:n].cpu().numpy(), b.diff[:n].cpu().numpy()]
        return [
            tuple(x.item() if isinstance(x, np.generic) else x for x in row)
            for row in zip(*cols)
        ]

    def peek_errors(self) -> list:
        """The maintained err collection: [(err_code, count)] with count
        != 0. Nonempty means reads of this dataflow must raise (the
        reference picks an arbitrary error). A dataflow whose plan has
        no err site skips the readback."""
        if not self._has_errors:
            return []
        self.span_barrier()
        self.check_flags()
        acc: dict = {}
        for row in self.err_output.batch.to_rows():
            acc[row[0]] = acc.get(row[0], 0) + row[-1]
        return sorted((c, n) for c, n in acc.items() if n != 0)


def _shard_rows(arrays, n: int, num_shards: int, shard_cap: int, rank: int,
                device) -> tuple:
    """Deal ``n`` rows round-robin across the ranks: rank ``r`` keeps rows
    ``r, r + P, ...`` (the reference's ``_shard_rows``, which packs every
    rank's share into one global array). Returns this rank's
    ``[shard_cap]`` tensors (None stays None) and the ``[P]`` counts.
    Ingestion balance only: the exchanges route by key inside the step."""
    base, extra = divmod(n, num_shards)
    counts = np.full(num_shards, base, dtype=np.int32)
    counts[:extra] += 1

    def pack(a):
        if a is None:
            return None
        rows = a[:n][rank::num_shards].to(device)
        out = torch.zeros(shard_cap, dtype=a.dtype, device=device)
        out[: rows.shape[0]] = rows
        return out

    return [pack(a) for a in arrays], counts


def _collective(fn):
    """Mark a ``ShardedDataflow`` method every rank must run together.
    A replica's rank 0 forwards the call to its follower ranks first
    (``coord/spmd.py``); a call made inside another is not forwarded
    again."""
    import functools

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        bus = self._bus
        if bus is None or self._forwarding:
            return fn(self, *args, **kwargs)
        self._forwarding = True
        try:
            call = bus.forward(self, fn.__name__, args, kwargs)
            out = fn(self, *args, **kwargs)
            bus.remember(call, out, self)
            return out
        finally:
            self._forwarding = False

    return wrapper


class ShardedDataflow(Dataflow):
    """A maintained dataflow over a worker mesh, one process per rank
    (the port of the reference's ``ShardedDataflow``, which drives every
    device from one process through ``shard_map``).

    Every rank builds the same dataflow and is handed the same host rows
    each tick; it keeps its round-robin share (``_shard_rows``), and the
    exchanges route rows by key inside the step, so each rank holds a
    disjoint shard of every operator state. Each rank also keeps its
    own shard of the output index and of the err arrangement; reads
    gather every rank's rows and combine them as the reference does.
    Every public method is collective: all ranks call it together, in
    the same order.

    - Capacities snap to the pow2 menu; a state part's tier is per rank.
    - Each step's overflow flags are summed over the ranks before they
      join the span's accumulator, and so are a fold's: an overflow
      anywhere rolls back, grows and replays on every rank at the same
      tier.
    - An exchange slot overflow (``("x", site)``) doubles the slot tier.
    - Ingest: a slot ring's cursor is a host int of the rank's own
      process, shard-local by construction, so the render passes
      ``spmd_safe=True`` where the reference proves it over its step
      program.
    - ``run_span`` raises, as the reference's does.
    """

    def __init__(self, expr: mir.RelationExpr, mesh, name: str = "df",
                 slot_cap: int = 256, input_shard_cap: int = 1024,
                 output_cap: int = 256, state_cap: int = 256,
                 out_levels: int = 2, out_slots: int | None = None):
        self.mesh = mesh
        self.axis_name = mesh.axis
        self.num_shards = mesh.world_size
        self.rank = mesh.rank
        self.input_shard_cap = quantize_cap(input_shard_cap)
        self._slot_cap0 = quantize_cap(slot_cap)
        self._output_cap = quantize_cap(output_cap)
        # A replica's rank 0 forwards collective calls to its followers.
        self._bus = None
        self._forwarding = False
        # The collectives of the last step: [(kind, bytes per device)].
        self._census: list | None = None
        # The output's ingest takes the single-device decision: with a
        # shard-local cursor the SPMD gate passes it through.
        super().__init__(expr, name=name, state_cap=state_cap, out_levels=out_levels,
                         out_slots=out_slots, device=mesh.device)

    def _new_context(self) -> _RenderContext:
        return _RenderContext(self.state_cap, self.device, mesh=self.mesh,
                              slot_cap=self._slot_cap0, spmd_safe=True)

    @property
    def time(self) -> int:
        return self._time

    @time.setter
    def time(self, v: int) -> None:
        if self._bus is not None and not self._forwarding:
            self._bus.forward(self, "time", (v,), {})
        self._time = v

    # -- the SPMD step -------------------------------------------------------
    def _step_core(self, states, output, err_output, inputs):
        record, self.mesh.record = self.mesh.record, []
        try:
            out, states, output, err_output, flags = super()._step_core(
                states, output, err_output, inputs)
            # An overflow anywhere aborts the step on every rank.
            flags = self.mesh.psum(flags.to(torch.int32)) > 0
            self._census = self.mesh.record
        finally:
            self.mesh.record = record
        return out, states, output, err_output, flags

    def _compact(self, max_level: int) -> torch.Tensor:
        return self.mesh.psum(super()._compact(max_level).to(torch.int32)) > 0

    def _grow_for(self, key, target: int | None = None) -> None:
        if key[0] == "x":
            self._grown.append(key)
            self._ctx.slot_cap *= 2
            return
        super()._grow_for(key, target)

    def _pack_inputs(self, inputs: dict) -> dict:
        """This rank's share of every host-global input batch, through the
        reference's ``input_shard_cap`` tier loop."""
        P_ = self.num_shards
        packed = {}
        for name, b in inputs.items():
            n = getattr(b, "_host_count", None)
            if n is None:
                n = int(b.count)
            cap = self.input_shard_cap
            while cap * P_ < n or capacity_tier(max(-(-n // P_), 1)) > cap:
                cap *= 2
            fields, counts = _shard_rows(
                list(b.cols) + list(b.nulls) + [b.time, b.diff], n, P_, cap,
                self.rank, self.device)
            k = len(b.cols)
            sb = Batch(
                cols=tuple(fields[:k]),
                nulls=tuple(fields[k: 2 * k]),
                time=fields[2 * k],
                diff=fields[2 * k + 1],
                count=torch.tensor(int(counts[self.rank]), dtype=torch.int32,
                                   device=self.device),
                schema=b.schema,
            )
            sb._host_count = int(counts[self.rank])
            packed[name] = sb
        return packed

    def _dispatch(self, inputs_list: list, flush_first: bool):
        return super()._dispatch([self._pack_inputs(i) for i in inputs_list],
                                 flush_first)

    # -- collective entry points ---------------------------------------------
    @_collective
    def step(self, inputs: dict) -> Batch:
        return super().step(inputs)

    @_collective
    def run_steps(self, inputs_list: list, defer_check: bool = False,
                  donate: bool = False) -> list:
        return super().run_steps(inputs_list, defer_check=defer_check, donate=donate)

    def run_span(self, inputs_list: list, donate: bool = False):
        raise NotImplementedError(
            "span execution is single-device: a sharded dataflow pipelines "
            "through run_steps(defer_check=True) and flags snapshots, as "
            "the reference's does"
        )

    @_collective
    def check_flags(self) -> bool:
        return super().check_flags()

    @_collective
    def record_collectives(self) -> list:
        """One step of empty inputs recorded on every rank
        (``analysis/step_lint.py``), then undone: the dataflow's states,
        time and census are as before. Returns every rank's record of
        its collectives, in rank order (``analysis/shard_prop.py``)."""
        from ..analysis.shard_prop import empty_inputs
        from ..analysis.step_lint import _COLLECTIVES, StepRecord, record_step

        self.span_barrier()
        self.check_flags()
        ck, census, first = self._checkpoint(), self._census, self._ctx.first_time
        try:
            _out, rec = record_step(self, empty_inputs(self.expr, self.device))
        finally:
            self._restore(ck)
            self._census, self._ctx.first_time = census, first
        mine = StepRecord(ops=[op for op in rec.ops if op.name in _COLLECTIVES])
        return self.mesh.gather_objects(mine)

    @_collective
    def flags_snapshot(self):
        return super().flags_snapshot()

    @_collective
    def read_flags_snapshot(self, snap) -> bool:
        return super().read_flags_snapshot(snap)

    @_collective
    def capture_basic_multisets(self) -> dict:
        return super().capture_basic_multisets()

    @_collective
    def output_batch(self) -> Batch:
        """This rank's shard of the output index, consolidated (every rank
        folds together); ``gather_delta`` of it is the whole index."""
        return super().output_batch()

    @_collective
    def output_records(self) -> int:
        counts = [b.count for b in self.output.runs_b + tuple(self.output.slots)]
        local = torch.stack(counts).sum().to(torch.int32).reshape(1)
        return int(self.mesh.psum(local))

    # -- reads: gathered over the ranks --------------------------------------
    def _gather_rows(self, b: Batch) -> dict:
        """Every rank's valid rows of ``b``, concatenated in rank order,
        on the host: cols, nulls (None where no rank has a mask), time
        and diff as numpy."""
        n = int(b.count)
        mine = {
            "cols": [c[:n].cpu().numpy() for c in b.cols],
            "nulls": [None if x is None else x[:n].cpu().numpy() for x in b.nulls],
            "time": b.time[:n].cpu().numpy(),
            "diff": b.diff[:n].cpu().numpy(),
        }
        parts = self.mesh.gather_objects(mine)

        def cat(get, dtype):
            return np.concatenate([get(p) for p in parts]).astype(dtype, copy=False)

        cols = [cat(lambda p, i=i: p["cols"][i], c.dtype) for i, c in enumerate(mine["cols"])]
        nulls = []
        for i in range(len(b.nulls)):
            if all(p["nulls"][i] is None for p in parts):
                nulls.append(None)
            else:
                nulls.append(np.concatenate([
                    p["nulls"][i] if p["nulls"][i] is not None
                    else np.zeros(len(p["diff"]), dtype=bool) for p in parts]))
        return {"cols": cols, "nulls": nulls, "time": cat(lambda p: p["time"], np.int64),
                "diff": cat(lambda p: p["diff"], np.int64)}

    def _gather_batch(self, b: Batch) -> Batch:
        """Every rank's shard rows as one batch on this rank's device."""
        rows = self._gather_rows(b)
        return Batch.from_numpy(b.schema, rows["cols"], rows["time"].view(np.uint64),
                                rows["diff"], nulls=rows["nulls"], device=self.device)

    @_collective
    def gather_delta(self, out: Batch) -> Batch:
        """Every rank's output delta of one step, as one batch."""
        return self._gather_batch(out)

    def _basic_rows(self, arr) -> dict:
        """A sharded basic-aggregate multiset, gathered: the reduce's
        keyed exchange puts each group on one rank, so the concatenation
        keeps every group contiguous."""
        rows = self._gather_rows(arr.batch)
        return {"cols": rows["cols"], "nulls": rows["nulls"], "diff": rows["diff"]}

    def _basic_group_maps(self, multisets: dict | None = None) -> list:
        from ..repr.schema import GLOBAL_DICT

        gdict = GLOBAL_DICT.snapshot()
        maps = []
        for fi, (_oc, slot, part, agg, vcol, _ko) in enumerate(self._basic_finalizers):
            arr = multisets[fi] if multisets is not None else self.states[slot][part]
            _keys, digests, results = _group_results(
                self._basic_rows(arr), len(arr.key), agg, vcol, gdict)
            maps.append(dict(zip(digests, results)))
        return maps

    def _basic_key_map(self, arr, keys: list, agg, vcol, gdict) -> dict:
        got_keys, digests, results = _group_results(
            self._basic_rows(arr), len(arr.key), agg, vcol, gdict)
        return dict(zip(got_keys, zip(digests, results)))

    @_collective
    def finalize_basic_columns(self, cols, nulls, diffs=None, old_multisets=None) -> list:
        return super().finalize_basic_columns(cols, nulls, diffs, old_multisets)

    @_collective
    def peek_errors(self) -> list:
        """Every rank's err shard, summed per code: [(err_code, count)]."""
        if not self._has_errors:
            return []
        self.span_barrier()
        self.check_flags()
        rows = self._gather_rows(self.err_output.batch)
        acc: dict = {}
        for code, d in zip(rows["cols"][0].tolist(), rows["diff"].tolist()):
            acc[code] = acc.get(code, 0) + d
        return sorted((c, n) for c, n in acc.items() if n != 0)

    @_collective
    def peek(self) -> list:
        """Every rank's output shard, gathered and combined: ranks may hold
        the same row (outputs stay where they were computed), so diffs
        are summed by value columns; rows come back at time 0, as the
        reference's do."""
        rows = self._gather_rows(self.output_batch())
        cols = rows["cols"]
        if self._basic_finalizers:
            cols = self.finalize_basic_columns(cols, rows["nulls"])
        acc: dict = {}
        for i, d in enumerate(rows["diff"].tolist()):
            key = tuple(x.item() if isinstance(x, np.generic) else x
                        for x in (c[i] for c in cols))
            acc[key] = acc.get(key, 0) + d
        return [k + (0, d) for k, d in acc.items() if d != 0]

    def sharding_report(self) -> dict:
        """The sharding report under the reference's keys
        (``analysis/shard_prop.py``): the census is what the last step
        issued."""
        from ..analysis.shard_prop import sharded_step_report

        return sharded_step_report(self)
