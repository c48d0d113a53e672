"""Merge of two sorted batches, carrying their stacked lanes (the port of
``materialize_tpu/ops/merge.py``).

1. the merged run's source map ``src`` (an index into ``concat(a, b)``
   per output slot) and its lanes: on the card one launch of the
   merge-path kernel (``ops/merge_kernel.py:merge_path``); its plain
   version ``merge_source_map_torch`` (right insertion point of every
   ``b`` row, a mark/cumsum inversion, a lanes gather) on the CPU;
2. one row gather per dtype family from ``concat(a, b)`` on ``src``.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

from ..repr.batch import Batch
from .lanes import stack_lanes
from .rows2d import concat_groups, from_groups, gather_rows, to_groups
from .search import lex_searchsorted_2d

_MODES = ("kernel", "torch")
_MODE: contextvars.ContextVar = contextvars.ContextVar("merge_mode", default=None)


@contextlib.contextmanager
def merge_mode(mode):
    """Run the enclosed code with every ``merge_sorted_cached`` using
    ``mode`` ("kernel", "torch" or None for the device rule: the kernel
    for CUDA tensors, the plain version for CPU tensors) — how a whole
    dataflow is run once per implementation to compare them. "kernel" on
    CPU tensors raises."""
    if mode not in _MODES + (None,):
        raise ValueError(f"merge mode {mode!r} not in {_MODES}")
    token = _MODE.set(mode)
    try:
        yield
    finally:
        _MODE.reset(token)


def search_right_torch(a_lanes_2d, a_count, b_lanes_2d) -> torch.Tensor:
    """The kernel's plain version: for each ``b`` row, the count of rows
    of ``a``'s valid prefix that are lexicographically <= it (int32)."""
    return lex_searchsorted_2d(a_lanes_2d, a_count, b_lanes_2d, side="right")


def _kernel_mode(lanes: torch.Tensor) -> bool:
    mode = _MODE.get()
    if mode is None:
        return lanes.is_cuda
    return mode == "kernel"


def merge_source_map_torch(
    a_lanes_2d: torch.Tensor, a_count, cap_a: int, b_lanes_2d: torch.Tensor,
    b_count, cap_b: int, out_capacity: int,
):
    """The merge-path kernel's plain version: ``src`` (int64
    [out_capacity], an index into ``concat(a, b)``) and the merged lanes
    (``concat(a_lanes, b_lanes)[src]``) of the stable merge of
    ``a[:a_count]`` and ``b[:b_count]`` (ties keep ``a`` first; past the
    output the tail is dropped). Slots past the merge take clamped ``a``
    padding rows. The reference's inversion
    (``materialize_tpu/ops/merge.py:merge_sorted_cached``) is the spec."""
    ins = search_right_torch(a_lanes_2d, a_count, b_lanes_2d)
    return source_map_from_points(
        ins, a_lanes_2d, cap_a, b_lanes_2d, b_count, cap_b, out_capacity
    )


def source_map_from_points(
    ins: torch.Tensor, a_lanes_2d: torch.Tensor, cap_a: int,
    b_lanes_2d: torch.Tensor, b_count, cap_b: int, out_capacity: int,
):
    """``merge_source_map_torch`` from the insertion points ``ins`` of
    ``b``'s rows (only those below ``b_count`` are read): the mark/cumsum
    inversion and the lanes gather."""
    dev = a_lanes_2d.device
    ib = torch.arange(cap_b, dtype=torch.int64, device=dev)
    pos_b = ib + ins
    # Padding rows and rows past the output are dropped: they write the
    # spare slot at out_capacity (the reference's mode="drop").
    pos_b = torch.where(ib < b_count, pos_b, out_capacity)
    pos_b = torch.clamp(pos_b, max=out_capacity)
    mark = torch.zeros(out_capacity + 1, dtype=torch.int32, device=dev)
    mark[pos_b] = 1
    mark = mark[:out_capacity]
    cum_b = torch.cumsum(mark, 0, dtype=torch.int64)
    take_b = mark == 1
    j = torch.arange(out_capacity, dtype=torch.int64, device=dev)
    src = torch.where(
        take_b,
        cap_a + torch.clamp(cum_b - 1, 0, cap_b - 1),
        torch.clamp(j - cum_b, 0, max(cap_a - 1, 0)),
    )
    return src, torch.cat([a_lanes_2d, b_lanes_2d])[src]


def _normalize_nulls(a: Batch, b: Batch):
    """Give both batches the same null-mask presence (union)."""

    def widen(x: Batch, other: Batch) -> Batch:
        nulls = list(x.nulls)
        changed = False
        for i, (mine, theirs) in enumerate(zip(x.nulls, other.nulls)):
            if mine is None and theirs is not None:
                nulls[i] = torch.zeros(x.capacity, dtype=torch.bool, device=x.device)
                changed = True
        return x.replace(nulls=tuple(nulls)) if changed else x

    return widen(a, b), widen(b, a)


def merge_sorted_cached(
    a: Batch, a_lanes_2d: torch.Tensor, b: Batch, b_lanes_2d: torch.Tensor,
    out_capacity: int,
):
    """Merge sorted ``a`` and ``b`` into one sorted batch of capacity
    ``out_capacity``, carrying the lanes. Stable: ties keep ``a`` rows
    first. Does not consolidate.

    Returns (batch, lanes_2d, overflowed): if a.count + b.count >
    out_capacity the tail is dropped, count is clamped and
    ``overflowed`` (a device bool) is True."""
    if tuple(c.dtype for c in a.schema.columns) != tuple(
        c.dtype for c in b.schema.columns
    ):
        raise ValueError(f"schemas differ: {a.schema.names} vs {b.schema.names}")
    a, b = _normalize_nulls(a, b)
    cap_a, cap_b = a.capacity, b.capacity
    dev = a.device
    if _kernel_mode(a_lanes_2d):
        from .merge_kernel import merge_path

        src, merged_lanes = merge_path(
            a_lanes_2d, a.count, cap_a, b_lanes_2d, b.count, out_capacity
        )
    else:
        src, merged_lanes = merge_source_map_torch(
            a_lanes_2d, a.count, cap_a, b_lanes_2d, b.count, cap_b, out_capacity
        )
    merged_groups = gather_rows(concat_groups(to_groups(a), to_groups(b)), src)

    total = a.count + b.count
    overflowed = total > out_capacity
    count = torch.clamp(total, max=out_capacity).to(torch.int32)
    merged = from_groups(merged_groups, a, count)
    # Padding hygiene: slots >= count got clamped garbage rows; zero
    # their diff and time. Lane padding stays garbage by contract.
    valid = torch.arange(out_capacity, dtype=torch.int64, device=dev) < count
    merged = merged.replace(
        diff=torch.where(valid, merged.diff, torch.zeros_like(merged.diff)),
        time=torch.where(valid, merged.time, torch.zeros_like(merged.time)),
    )
    return merged, merged_lanes, overflowed


def merge_sorted(a: Batch, a_lanes, b: Batch, b_lanes, out_capacity: int):
    """Lane-list form of merge_sorted_cached (drops the carried lanes)."""

    def as_2d(lanes):
        return lanes if getattr(lanes, "ndim", None) == 2 else stack_lanes(lanes)

    merged, _, overflowed = merge_sorted_cached(
        a, as_2d(a_lanes), b, as_2d(b_lanes), out_capacity
    )
    return merged, overflowed
