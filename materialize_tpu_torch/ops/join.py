"""The two pieces of ``materialize_tpu/ops/join.py`` every join probe
uses: the range expansion (flatten per-probe match ranges into a
fixed-capacity output tier) and the null-key diff mask. The linear
``JoinOp`` is not ported (ROADMAP Queue 1).

SQL semantics: NULL join keys match nothing (NULL != NULL), so null-key
rows are dropped from both state and probes by zeroing their diffs.
"""

from __future__ import annotations

import torch

from ..repr.batch import Batch


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
