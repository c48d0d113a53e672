"""The card's peaks and the operations and bytes of the kernels whose
roofline the benchmark reports."""

from __future__ import annotations

# NVIDIA H100 SXM, NVIDIA's data sheet: HBM3 bandwidth (the constant of
# chip_smoke.py, frozen here).
HBM_BYTES_PER_S = 3.35e12
LANE_BYTES = 8  # a lane is one int64
SRC_BYTES = 8  # the merged run's source map, one int64 a row


def merge_bytes(a_count: int, b_count: int, out_capacity: int, lanes: int) -> int:
    """The least bytes a merge of two sorted runs moves: the rows it
    consumes, ``min(a_count + b_count, out_capacity)`` of the two runs'
    valid rows, read once, and the merged lanes and source map of those
    rows written once. Counted from the valid rows, never from tier
    capacities, so a kernel that moves less than the tiers hold still
    reads at or under its roofline."""
    rows = min(a_count + b_count, out_capacity)
    return rows * lanes * LANE_BYTES + rows * (lanes * LANE_BYTES + SRC_BYTES)


def least_seconds(n_bytes: float) -> float:
    """The time the card needs to move ``n_bytes`` at its HBM peak."""
    return n_bytes / HBM_BYTES_PER_S
