"""Delta join: one update pipeline per input, probing the other inputs'
arrangements, with no intermediate join state (the port of
``materialize_tpu/ops/delta_join.py``).

For a k-way join the step's output delta is

    d(I_0 ⋈ ... ⋈ I_{k-1}) = Σ_i  dI_i ⋈ (⋈_{j<i} I_j^new) ⋈ (⋈_{j>i} I_j^old)

Pipeline i extends input i's delta through every other input, using the
post-update arrangement of the inputs before it and the pre-update one
of the inputs after it, so each combination of concurrent deltas counts
exactly once. The only state is one exact-order ``Spine`` per (input,
probe key), shared by every pipeline that probes it.

Each probe is a binary search of every run (and slot) of the probed
spine for each accumulated row's key (``lookup_range``), then the range
expansion of ``ops/join.py`` into the join's output tier; the tier's
overflow flag makes the dataflow roll back, double it and replay.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import reduce

import torch

from ..arrangement.spine import Arrangement, Spine, insert_tail, lookup_range
from ..expr.scalar import ColumnRef
from ..repr.batch import Batch
from ..repr.schema import Column, Schema
from .join import expand_ranges, null_key_diffs
from .lanes import SIGN, column_lanes, hash_pair
from .sort import concat_batches


def _plan_pipelines(n_inputs: int, arities, equivalences):
    """Per-pipeline probe plans, exactly as the reference plans them.

    Returns (pipelines, arrangement_specs):
      pipelines[i] = (steps, proj): steps is a list of (j,
        acc_key_positions, j_key_locals, arr_index): probe input j's
        arrangement keyed by j_key_locals, matching the accumulated
        columns at acc_key_positions (positions in the concatenation of
        the bound inputs' columns, in probe order); proj maps the global
        column order onto the accumulated positions;
      arrangement_specs = list of (input j, key tuple of j-local cols).
    """
    offsets = [0]
    for a in arities:
        offsets.append(offsets[-1] + a)

    def owner(g):
        for j in range(n_inputs):
            if offsets[j] <= g < offsets[j + 1]:
                return j
        raise IndexError(g)

    classes = []
    for cls in equivalences:
        cols = []
        for e in cls:
            if not isinstance(e, ColumnRef):
                raise NotImplementedError(
                    "delta join equivalences must be column references"
                )
            cols.append(e.index)
        per_input: dict = {}
        for g in cols:
            per_input.setdefault(owner(g), []).append(g)
        for members in per_input.values():
            if len(members) > 1:
                raise NotImplementedError(
                    "intra-input equality in join equivalence: rewrite "
                    "as a Filter before planning"
                )
        if len(per_input) < 2:
            raise NotImplementedError("equivalence class confined to one input")
        classes.append({j: ms[0] for j, ms in per_input.items()})

    arrangement_specs: list = []
    arr_index: dict = {}

    def get_arr(j, key):
        k = (j, tuple(key))
        if k not in arr_index:
            arr_index[k] = len(arrangement_specs)
            arrangement_specs.append(k)
        return arr_index[k]

    pipelines = []
    for i in range(n_inputs):
        bound = [i]
        acc_pos = {offsets[i] + c: c for c in range(arities[i])}
        steps = []
        remaining = [j for j in range(n_inputs) if j != i]
        while remaining:
            picked = None
            for j in remaining:
                pairs = []
                for cls in classes:
                    if j in cls and any(b in cls for b in bound):
                        b = next(b for b in bound if b in cls)
                        pairs.append((acc_pos[cls[b]], cls[j] - offsets[j]))
                if pairs:
                    picked = (j, pairs)
                    break
            if picked is None:
                # Disconnected join graph: cross-join the next input.
                picked = (remaining[0], [])
            j, pairs = picked
            acc_key = tuple(p for p, _ in pairs)
            j_key = tuple(q for _, q in pairs)
            n_acc = len(acc_pos)
            for c in range(arities[j]):
                acc_pos[offsets[j] + c] = n_acc + c
            steps.append((j, acc_key, j_key, get_arr(j, j_key)))
            bound.append(j)
            remaining.remove(j)
        proj = tuple(acc_pos[g] for g in range(offsets[-1]))
        pipelines.append((steps, proj))
    return pipelines, arrangement_specs


@dataclass
class DeltaJoinOp:
    """State: one Spine per (input, probe key), shared by all pipelines.
    Output schema: the inputs' schemas concatenated (MIR Join)."""

    input_schemas: tuple
    equivalences: tuple

    def __post_init__(self):
        self.n_inputs = len(self.input_schemas)
        arities = [s.arity for s in self.input_schemas]
        self.pipelines, self.arr_specs = _plan_pipelines(
            self.n_inputs, arities, self.equivalences
        )
        self.out_schema = Schema(
            tuple(c for s in self.input_schemas for c in s.columns)
        )
        # Key columns normalized non-nullable (null keys never join).
        self.arr_schemas = []
        for j, key in self.arr_specs:
            self.arr_schemas.append(Schema([
                Column(c.name, c.ctype, False, c.scale) if ci in key else c
                for ci, c in enumerate(self.input_schemas[j].columns)
            ]))
        self.n_parts = len(self.arr_specs)

    def init_state(self, capacity: int = 256, tail_capacity: int = 1024,
                   ingest_slots: int = 0, device=None) -> tuple:
        return tuple(
            Spine.empty(sch, key, capacity, tail_capacity,
                        ingest_slots=ingest_slots, device=device)
            for (_, key), sch in zip(self.arr_specs, self.arr_schemas)
        )

    def _probe(self, acc: Batch, spine: Spine, acc_key, out_time: int,
               out_capacity: int):
        """acc ⋈ spine on acc_key: returns (extended acc, overflow).

        The arrangement's key columns are non-nullable, so the probe
        encodes value lanes only and zeroes the diff of null-key rows
        instead of emitting a null lane. Probes every run and slot."""
        probe_lanes = []
        diff = acc.diff
        for i in acc_key:
            nl = acc.nulls[i]
            if nl is not None:
                diff = torch.where(nl, 0, diff)
            probe_lanes.extend(column_lanes(acc.cols[i], acc.schema[i].ctype))
        if not probe_lanes:
            # No key: one constant lane (u64 zero), like an empty key's.
            probe_lanes = [torch.full((acc.capacity,), SIGN, dtype=torch.int64,
                                      device=acc.device)]
        if spine.order == "hash":
            probe_lanes = list(hash_pair(probe_lanes))
        acc = acc.replace(diff=diff)
        outs, ovfs = [], []
        for arr in spine.runs():
            out, ovf = self._probe_run(acc, arr, probe_lanes, out_time, out_capacity)
            outs.append(out)
            ovfs.append(ovf)
        return concat_batches(outs), reduce(torch.logical_or, ovfs)

    @staticmethod
    def _probe_run(acc: Batch, arr: Arrangement, probe_lanes, out_time: int,
                   out_capacity: int):
        lo, hi = lookup_range(arr, probe_lanes)
        valid = acc.valid_mask() & (acc.diff != 0)
        probe_idx, match, out_valid, overflow = expand_ranges(lo, hi, valid, out_capacity)
        pi = probe_idx.to(torch.int64)
        # Past the output the match positions are garbage that may leave
        # the run; the reference's gather clamps, torch's raises.
        mi = torch.clamp(match.to(torch.int64), 0, max(arr.capacity - 1, 0))

        def g_acc(a):
            return None if a is None else a[pi]

        def g_arr(a):
            return None if a is None else a[mi]

        out = Batch(
            cols=tuple(g_acc(c) for c in acc.cols) + tuple(g_arr(c) for c in arr.batch.cols),
            nulls=tuple(g_acc(n) for n in acc.nulls)
            + tuple(g_arr(n) for n in arr.batch.nulls),
            time=torch.full((out_capacity,), out_time, dtype=torch.int64,
                            device=acc.device),
            diff=torch.where(out_valid, acc.diff[pi] * arr.batch.diff[mi], 0),
            count=out_valid.sum().to(torch.int32),
            schema=Schema(tuple(acc.schema.columns) + tuple(arr.batch.schema.columns)),
        )
        return out, overflow

    def step(self, state: tuple, deltas: list, out_time: int, out_capacity: int,
             exchange_fn=None):
        """One delta batch per input. ``exchange_fn(batch, key, tag)`` is
        the SPMD routing hook, applied before every arrangement insert
        (tag ``("ins", part)``) and every probe (``("probe", pipeline,
        part)``); None is the identity. Returns (new_state, output delta,
        state overflow {(part, "tail"): flag}, probe overflow flag)."""
        route = exchange_fn or (lambda b, key, tag: b)
        new_state = list(state)
        st_ovf = {}
        for p, ((j, key), sch) in enumerate(zip(self.arr_specs, self.arr_schemas)):
            d = deltas[j].replace(diff=null_key_diffs(deltas[j], key), schema=sch)
            d = route(d, key, ("ins", p))
            new_state[p], st_ovf[(p, "tail")] = insert_tail(state[p], d)

        probe_ovf = None
        outs = []
        for i, (steps, proj) in enumerate(self.pipelines):
            acc = deltas[i]
            for j, acc_key, _, ap in steps:
                # Before/after discipline: inputs already processed as
                # pipelines (j < i) probe post-update arrangements.
                arr = new_state[ap] if j < i else state[ap]
                acc = route(acc, acc_key, ("probe", i, ap))
                acc, ovf = self._probe(acc, arr, acc_key, out_time, out_capacity)
                probe_ovf = ovf if probe_ovf is None else probe_ovf | ovf
            outs.append(Batch(
                cols=tuple(acc.cols[p] for p in proj),
                nulls=tuple(acc.nulls[p] for p in proj),
                time=acc.time,
                diff=acc.diff,
                count=acc.count,
                schema=self.out_schema,
            ))
        if probe_ovf is None:
            probe_ovf = torch.zeros((), dtype=torch.bool, device=deltas[0].device)
        return tuple(new_state), concat_batches(outs), st_ovf, probe_ovf
