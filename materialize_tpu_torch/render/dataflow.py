"""Render a MIR expression into a maintained dataflow with an output index
(the port of ``materialize_tpu/render/dataflow.py`` for every MIR node:
``Constant``, ``Get``, ``Let``, ``LetRec``, ``Project``, ``Map``,
``FlatMap``, ``Filter`` (temporal predicates included), ``Union``,
``Negate``, ``Threshold``, ``ArrangeBy``, the delta and the linear
``Join``, ``TopK`` and the ``Reduce`` with accumulable, MIN/MAX and
float-sum aggregates).

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

Left out: donation, the compile ledger, the program bank, and SPMD (the
exchanges are the identity on one device).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..arrangement.spine import (
    Arrangement,
    Spine,
    compact_depth,
    compact_level,
    insert,
    insert_tail,
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
from ..repr.batch import Batch, capacity_tier
from ..repr.schema import DIFF_DTYPE, ERR_SCHEMA

# Error deltas are shrunk to this tier before the err arrangement insert.
ERR_DELTA_CAP = 2048


class _RenderContext:
    """Collects state slots while walking the MIR tree (each stateful
    operator's initial state, at the dataflow's state tier) and holds
    the join sites' output tiers, which overflow growth doubles."""

    def __init__(self, state_cap: int, device, join_cap: int = 1024):
        self.state_cap = state_cap
        self.device = device
        self.slots: list = []
        # Append slots of operator-state spines (0: merge ingest).
        self.ingest_slots = (
            INGEST_RING_SLOTS if state_ingest_mode(state_cap) == "append_slot" else 0
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
        # While a LetRec's values are built: its binding names. While its
        # evaluations after the first run: True (their sources are empty).
        self.letrec_names: frozenset = frozenset()
        self.sources_quiet = False
        # The dataflow's first processed time (its as_of), where a
        # Constant emits its rows; set by the first dispatch.
        self.first_time: int | None = None

    def new_slot(self, init: tuple) -> int:
        self.slots.append(init)
        return len(self.slots) - 1

    def new_join_site(self) -> int:
        self.join_caps.append(self.default_join_cap)
        return len(self.join_caps) - 1


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
        inner = _build(expr.input, ctx)

        def run(states, inputs, time, errs):
            # The exchange on every column is the identity on one device.
            b, upd, ovf = inner(states, inputs, time, errs)
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
        slot = ctx.new_slot(op.init_state(ctx.state_cap, ctx.device))
        inner = _build(expr.input, ctx)

        def run(states, inputs, time, errs):
            b, upd, ovf = inner(states, inputs, time, errs)
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
        inner = _build(expr.input, ctx)

        def run(states, inputs, time, errs):
            # The exchange on the group key is the identity on one device.
            b, upd, ovf = inner(states, inputs, time, errs)
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
        b = full if time == ctx.first_time else none
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
    slot = ctx.new_slot(op.init_state(ctx.state_cap, ingest_slots=ctx.ingest_slots,
                                      device=ctx.device))
    jsite = ctx.new_join_site()
    inners = [_build(i, ctx) for i in expr.inputs]

    def run(states, inputs, time, errs):
        deltas, upd, ovf = [], {}, {}
        for f in inners:
            b, u, o = f(states, inputs, time, errs)
            deltas.append(b)
            upd.update(u)
            ovf.update(o)
        new_state, out, st_ovf, j_ovf = op.step(states[slot], deltas, time,
                                                ctx.join_caps[jsite])
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
        stages.append((op, slot, ctx.new_join_site()))
        acc_schema = op.out_schema
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
        for (op, slot, jsite), d_right, r_quiet in zip(stages, deltas[1:], quiet[1:]):
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
            if int(sum(d.count.to(torch.int64) for d in deltas)) == 0:
                break
            it_inputs = dict(empty_inputs)
            it_inputs.update(zip(names, deltas))
            quiet, ctx.sources_quiet = ctx.sources_quiet, True
            states_l, deltas, o, errs_n = run_values(states_l, it_inputs)
            ctx.sources_quiet = quiet
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


class Dataflow:
    """A maintained dataflow on one device: install once, feed update
    batches (``step``/``run_steps``/``run_span``), peek."""

    def __init__(self, expr: mir.RelationExpr, name: str = "df",
                 state_cap: int = 256, out_levels: int = 2,
                 out_slots: int | None = None, device=None):
        self.device = resolve_device(device)
        self.expr = expr
        self.name = name
        self.out_schema = expr.schema()
        self.state_cap = quantize_cap(state_cap)
        # Output deltas are shrunk to this tier before the index insert.
        self.out_delta_cap = 4096
        if out_slots is None:
            out_slots = (
                INGEST_RING_SLOTS
                if ingest_mode(self.state_cap, self.out_delta_cap) == "append_slot"
                else 0
            )
        ctx = _RenderContext(self.state_cap, self.device)
        self._ctx = ctx
        self._run = _build(expr, ctx)
        # One tuple of state parts per stateful operator (slot).
        self.states = list(ctx.slots)
        self.output = Spine.empty(
            self.out_schema, tuple(range(self.out_schema.arity)), 256,
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

    def capture_basic_multisets(self):
        raise NotImplementedError(
            "basic aggregates (string_agg/array_agg/list_agg) are not "
            "ported (ROADMAP Queue 1 item 15)"
        )

    def finalize_basic_columns(self, *args, **kwargs):
        raise NotImplementedError(
            "basic aggregates (string_agg/array_agg/list_agg) are not "
            "ported (ROADMAP Queue 1 item 15)"
        )

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
                self.states, self.output, self.err_output, inputs
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
        host = torch.cat(parts).cpu().tolist()
        return [k for k, over in zip(keys, host) if over]

    # -- checkpoints --------------------------------------------------------
    def _checkpoint(self):
        return (list(self.states), self.output, self.err_output, self._time,
                self._compact_tick)

    def _restore(self, ck) -> None:
        states, self.output, self.err_output, self._time, self._compact_tick = ck
        self.states = list(states)

    # -- public stepping ----------------------------------------------------
    def step(self, inputs: dict) -> Batch:
        """Feed one micro-batch per source; returns the output delta."""
        return self.run_steps([inputs])[-1]

    def run_steps(self, inputs_list: list, defer_check: bool = False) -> list:
        """Feed several micro-batches. Synchronous by default: one flags
        readback at the end, and on overflow rollback, growth and replay.
        With ``defer_check`` even that readback waits for
        ``check_flags``; the returned deltas are provisional until then."""
        self._check_slot_ring()
        if defer_check:
            return self._defer(inputs_list, flush_first=False)
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

    def run_span(self, inputs_list: list) -> list:
        """Feed a span of micro-batches with deferred overflow checks.
        The span length must be a multiple of ``_compact_every``; the due
        folds run between its chunks. Returns the per-step output deltas
        (provisional until ``check_flags``)."""
        ce = self._compact_every
        if len(inputs_list) % ce:
            raise ValueError(
                f"span length {len(inputs_list)} must be a multiple of "
                f"compact_every={ce}"
            )
        self._check_slot_ring()
        return self._defer(inputs_list, flush_first=True)

    def _defer(self, inputs_list: list, flush_first: bool) -> list:
        if self._defer_ck is None:
            self._defer_ck = self._checkpoint()
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
        self.check_flags()
        self._compact_now()
        return self.output.base

    def output_records(self) -> int:
        """Approximate maintained row count (every run and ingest slot;
        rows whose diffs cancel across runs count until the next fold).
        Introspection only: one small device->host read."""
        counts = [b.count for b in self.output.runs_b + tuple(self.output.slots)]
        return int(torch.stack(counts).sum().item())

    def peek(self) -> list:
        """The full maintained result (SELECT * FROM the index)."""
        return self.output_batch().to_rows()

    def peek_errors(self) -> list:
        """The maintained err collection: [(err_code, count)] with count
        != 0. Nonempty means reads of this dataflow must raise (the
        reference picks an arbitrary error). A dataflow whose plan has
        no err site skips the readback."""
        if not self._has_errors:
            return []
        self.check_flags()
        acc: dict = {}
        for row in self.err_output.batch.to_rows():
            acc[row[0]] = acc.get(row[0], 0) + row[-1]
        return sorted((c, n) for c, n in acc.items() if n != 0)
