"""The linear (binary, arranged) join and the two pieces every join
probe uses (the port of ``materialize_tpu/ops/join.py``): the range
expansion (flatten per-probe match ranges into a fixed-capacity output
tier) and the null-key diff mask.

A ``JoinOp`` stage keeps both sides in spines keyed by the join key and
emits, per update,

    d(A ⋈ B) = dA ⋈ B_old  +  A_new ⋈ dB        (A_new = A_old + dA)

which counts every new-new pair once. Each probe binary-searches every
run of the other side's spine, sizes the output with a cumulative sum
and expands it into the join's output tier; the tier's overflow flag
makes the dataflow roll back, double it and replay.

SQL semantics: NULL join keys match nothing (NULL != NULL), so null-key
rows are dropped from both state and probes by zeroing their diffs.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import reduce

import torch

from ..arrangement.spine import Arrangement, Spine, insert_tail, lookup_range
from ..repr.batch import Batch
from ..repr.schema import Column, Schema
from .sort import concat_batches


def expand_ranges(lo: torch.Tensor, hi: torch.Tensor, valid: torch.Tensor,
                  out_capacity: int):
    """Flatten per-probe match ranges ``[lo, hi)`` into (probe_idx,
    match_pos) pairs occupying a contiguous prefix of length ``total =
    sum(hi - lo)`` over the valid probes.

    Returns (probe_idx int32, match_pos int32, out_valid, overflow).
    Slots past ``total`` hold garbage masked by ``out_valid``; their
    ``match_pos`` may lie outside the probed run, so a caller gathering
    with it clamps first (the reference's gathers clamp by themselves).
    """
    n = lo.shape[0]
    dev = lo.device
    j = torch.arange(out_capacity, dtype=torch.int64, device=dev)
    if n == 0:
        zero = torch.zeros(out_capacity, dtype=torch.int32, device=dev)
        return zero, zero, torch.zeros(out_capacity, dtype=torch.bool, device=dev), \
            torch.zeros((), dtype=torch.bool, device=dev)
    sizes = torch.where(valid, (hi - lo).to(torch.int64), 0)
    csum = torch.cumsum(sizes, 0)  # inclusive
    offs = csum - sizes  # exclusive
    total = csum[-1]
    probe = torch.searchsorted(csum, j, right=True)
    probe_c = torch.clamp(probe, 0, n - 1)
    match = lo[probe_c].to(torch.int64) + (j - offs[probe_c])
    out_valid = j < torch.clamp(total, max=out_capacity)
    return probe_c.to(torch.int32), match.to(torch.int32), out_valid, total > out_capacity


def null_key_diffs(batch: Batch, key) -> torch.Tensor:
    """The diff column with NULL-key rows zeroed (they never join)."""
    d = batch.diff
    for i in key:
        nl = batch.nulls[i]
        if nl is not None:
            d = torch.where(nl, 0, d)
    return d


@dataclass
class JoinOp:
    """One binary linear-join stage. State: (left, right) spines keyed
    by the join key columns. Output: left columns ++ right columns."""

    left_schema: Schema
    right_schema: Schema
    left_key: tuple
    right_key: tuple

    def __post_init__(self):
        if len(self.left_key) != len(self.right_key):
            raise ValueError("join keys of different lengths")

        def state_schema(schema: Schema, key) -> Schema:
            # Key columns non-nullable (null keys are dropped), so both
            # sides' key lanes encode alike.
            return Schema([Column(c.name, c.ctype, False, c.scale) if i in key else c
                           for i, c in enumerate(schema.columns)])

        self.left_state_schema = state_schema(self.left_schema, self.left_key)
        self.right_state_schema = state_schema(self.right_schema, self.right_key)
        for li, ri in zip(self.left_key, self.right_key):
            lc, rc = self.left_state_schema[li], self.right_state_schema[ri]
            if lc.ctype is not rc.ctype:
                raise TypeError(f"join key type mismatch: {lc} vs {rc}")
        self.out_schema = Schema(
            tuple(self.left_schema.columns) + tuple(self.right_schema.columns)
        )

    def init_state(self, capacity: int = 256, tail_capacity: int = 1024,
                   ingest_slots: int = 0, device=None) -> tuple:
        return (
            Spine.empty(self.left_state_schema, self.left_key, capacity, tail_capacity,
                        ingest_slots=ingest_slots, device=device),
            Spine.empty(self.right_state_schema, self.right_key, capacity,
                        tail_capacity, ingest_slots=ingest_slots, device=device),
        )

    @staticmethod
    def _clean(delta: Batch, key, schema: Schema) -> Batch:
        """Zero null-key rows and rewrap with the state schema."""
        return delta.replace(diff=null_key_diffs(delta, key), schema=schema)

    def _probe(self, spine: Spine, delta: Batch, delta_key, delta_is_left: bool,
               out_time: int, out_capacity: int):
        """delta ⋈ spine, in output column order. Probes every run (and
        slot); a row present in two runs with cancelling diffs matches
        in both, which downstream consolidation cancels."""
        probe_lanes = spine.runs()[0].probe_lanes(delta, delta_key)
        outs, ovfs = [], []
        for arr in spine.runs():
            out, ovf = self._probe_run(arr, probe_lanes, delta, delta_is_left,
                                       out_time, out_capacity)
            outs.append(out)
            ovfs.append(ovf)
        return concat_batches(outs), reduce(torch.logical_or, ovfs)

    def _probe_run(self, arr: Arrangement, probe_lanes, delta: Batch,
                   delta_is_left: bool, out_time: int, out_capacity: int):
        lo, hi = lookup_range(arr, probe_lanes)
        valid = delta.valid_mask() & (delta.diff != 0)
        probe_idx, match, out_valid, overflow = expand_ranges(lo, hi, valid, out_capacity)
        pi = probe_idx.to(torch.int64)
        # Past the output the match positions are garbage that may leave
        # the run; the reference's gather clamps, torch's raises.
        mi = torch.clamp(match.to(torch.int64), 0, max(arr.capacity - 1, 0))

        def g_delta(a):
            return None if a is None else a[pi]

        def g_arr(a):
            return None if a is None else a[mi]

        d_cols = [g_delta(c) for c in delta.cols]
        d_nulls = [g_delta(n) for n in delta.nulls]
        a_cols = [g_arr(c) for c in arr.batch.cols]
        a_nulls = [g_arr(n) for n in arr.batch.nulls]
        if delta_is_left:
            cols, nulls = d_cols + a_cols, d_nulls + a_nulls
        else:
            cols, nulls = a_cols + d_cols, a_nulls + d_nulls
        return Batch(
            cols=tuple(cols),
            nulls=tuple(nulls),
            time=torch.full((out_capacity,), out_time, dtype=torch.int64,
                            device=delta.device),
            diff=torch.where(out_valid, delta.diff[pi] * arr.batch.diff[mi], 0),
            count=out_valid.sum().to(torch.int32),
            schema=self.out_schema,
        ), overflow

    def step(self, state: tuple, d_left: Batch, d_right: Batch, out_time: int,
             out_capacity: int, quiet: tuple = (False, False)):
        """Returns (new_state, output delta, state overflow {(part,
        "tail"): flag}, join overflow flag). ``quiet`` marks the sides
        that are a LetRec's quiet sources, empty by construction
        (``render/dataflow.py:_source_only``): such a side inserts
        nothing and probes nothing."""
        A, B = state
        dev = d_left.device
        false = torch.zeros((), dtype=torch.bool, device=dev)
        overflow = {(0, "tail"): false, (1, "tail"): false}
        new_A, new_B, outs, join_ovf = A, B, [], false
        if not quiet[0]:
            dl = self._clean(d_left, self.left_key, self.left_state_schema)
            new_A, overflow[(0, "tail")] = insert_tail(A, dl)
            out1, join_ovf = self._probe(B, dl, self.left_key, True, out_time, out_capacity)
            outs.append(out1)
        if not quiet[1]:
            dr = self._clean(d_right, self.right_key, self.right_state_schema)
            new_B, overflow[(1, "tail")] = insert_tail(B, dr)
            out2, ovf2 = self._probe(new_A, dr, self.right_key, False, out_time,
                                     out_capacity)
            outs.append(out2)
            join_ovf = join_ovf | ovf2
        if not outs:
            outs.append(Batch.empty(self.out_schema, 256, device=dev))
        # No consolidation: each pair comes out once, and downstream
        # arrangement inserts consolidate.
        return (new_A, new_B), concat_batches(outs), overflow, join_ovf
