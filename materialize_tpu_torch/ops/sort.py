"""Sorting and compaction (the port of ``materialize_tpu/ops/sort.py``).

The reference sorts with XLA's variadic ``lax.sort``; torch has no
multi-operand sort, so ``sort_perm`` is a cascade of stable sorts, last
key first (a least-significant-key-first radix over the operands).
Padding rows stay at the tail through a validity key that sorts valid
rows first.
"""

from __future__ import annotations

import torch

from ..repr.batch import Batch


def sort_perm(lanes, count, capacity: int) -> torch.Tensor:
    """Permutation sorting valid rows lexicographically by stored-form
    ``lanes`` (signed int64 order), padding rows last. Stable."""
    dev = lanes[0].device if lanes else count.device
    idx = torch.arange(capacity, dtype=torch.int64, device=dev)
    invalid = (idx >= count).to(torch.int8)
    perm = idx
    for key in list(reversed(list(lanes))) + [invalid]:
        order = torch.sort(key[perm], stable=True).indices
        perm = perm[order]
    return perm


def apply_perm(batch: Batch, perm: torch.Tensor) -> Batch:
    """Reorder rows by ``perm`` — one row gather per dtype family."""
    from .rows2d import from_groups, gather_rows, to_groups

    return from_groups(gather_rows(to_groups(batch), perm), batch, batch.count)


def compact(batch: Batch, keep: torch.Tensor) -> Batch:
    """Drop rows where ``keep`` is False (and padding), moving the
    survivors to a contiguous prefix. Stable."""
    from .rows2d import from_groups, scatter_rows, to_groups

    if keep.shape[0] == 0:
        return batch
    keep = keep & batch.valid_mask()
    pos = torch.cumsum(keep, 0, dtype=torch.int32) - 1
    new_count = pos[-1] + 1
    cap = batch.capacity
    dest = torch.where(keep, pos.to(torch.int64), cap)
    groups = scatter_rows(to_groups(batch), dest, cap)
    return from_groups(groups, batch, new_count)


def concat_batches(batches: list) -> Batch:
    """Concatenate batches of one schema (capacity = sum of caps) and
    compact the valid rows to a prefix."""
    if not batches:
        raise ValueError("concat_batches needs at least one batch")
    if len(batches) == 1:
        return batches[0]
    schema = batches[0].schema
    cap = sum(b.capacity for b in batches)
    dev = batches[0].device

    def cat(parts, caps):
        if any(p is None for p in parts):
            parts = [
                p if p is not None
                else torch.zeros(c, dtype=torch.bool, device=dev)
                for p, c in zip(parts, caps)
            ]
        return torch.cat(parts)

    caps = [b.capacity for b in batches]
    keep = torch.cat([b.valid_mask() for b in batches])
    out = Batch(
        cols=tuple(
            cat([b.cols[i] for b in batches], caps)
            for i in range(schema.arity)
        ),
        nulls=tuple(
            None
            if all(b.nulls[i] is None for b in batches)
            else cat([b.nulls[i] for b in batches], caps)
            for i in range(schema.arity)
        ),
        time=torch.cat([b.time for b in batches]),
        diff=torch.cat([b.diff for b in batches]),
        count=torch.tensor(cap, dtype=torch.int32, device=dev),
        schema=schema,
    )
    return compact(out, keep)


def shrink(batch: Batch, capacity: int):
    """Slice a batch down to a smaller capacity tier (valid rows are a
    prefix, so this is a free view). Returns (batch, overflow): on
    overflow the tail was dropped and the host must retry larger."""
    if capacity >= batch.capacity:
        return batch, torch.zeros((), dtype=torch.bool, device=batch.device)

    def sl(a):
        return None if a is None else a[:capacity]

    out = Batch(
        cols=tuple(sl(c) for c in batch.cols),
        nulls=tuple(sl(n) for n in batch.nulls),
        time=sl(batch.time),
        diff=sl(batch.diff),
        count=torch.clamp(batch.count, max=capacity),
        schema=batch.schema,
        # A prefix slice preserves every sortedness hint.
        hints=batch.hints,
    )
    return out, batch.count > capacity


def segment_starts(lanes, count, capacity: int) -> torch.Tensor:
    """Given rows sorted by ``lanes``, a mask of the first row of each
    run of equal keys (padding rows excluded)."""
    dev = lanes[0].device
    idx = torch.arange(capacity, dtype=torch.int32, device=dev)
    differs = idx == 0
    for lane in lanes:
        prev = torch.cat([lane[:1], lane[:-1]])
        differs = differs | (lane != prev)
    return (idx < count) & differs


def segment_ids(starts: torch.Tensor) -> torch.Tensor:
    """0-based segment id (int64) per row from a segment-start mask. Rows
    before the first start (every row, when there is none) get -1."""
    return torch.cumsum(starts, 0, dtype=torch.int64) - 1
