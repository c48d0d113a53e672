"""Order-preserving key lanes and the hash pair (the port of
``materialize_tpu/ops/lanes.py``).

The reference encodes every key column as a u64 *lane* whose unsigned
order is SQL order, and hashes lane tuples into a 2-lane hash order.
torch's uint64 has no ordered compare, shifts or searchsorted, so the
port carries every lane as int64 in ONE storage form:

    stored = u64_bits ^ (1 << 63)        (SIGN below)

A signed int64 compare of stored values orders exactly as the u64
compare of the reference's lanes. Conveniently, an integer column's
reference lane is ``int64(v) ^ (1 << 63)``, so its stored lane is the
value itself.

Hash mixing runs on the raw u64 bits held in int64: additions and
multiplications wrap identically, and the logical right shift is an
arithmetic shift followed by a mask. ``hash_pair`` is bit-identical to
``hash_pair_host`` (numpy u64), which host producers use to presort
batches into the device hash order.
"""

from __future__ import annotations

import numpy as np
import torch

from ..repr.batch import Batch
from ..repr.schema import Column, ColumnType

SIGN = -(1 << 63)  # int64 with only the top bit set


def _s64(u: int) -> int:
    """A u64 constant as the int64 with the same bits."""
    return u - (1 << 64) if u >= 1 << 63 else u


_GOLDEN = 0x9E3779B97F4A7C15
_MIX_MUL = _s64(0xBF58476D1CE4E5B9)
# Second-stream seed for the hash-pair order (the reference's value).
_HASH2_SEED = 0xC2B2AE3D27D4EB4F


def _shr(h: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64-held u64 bits."""
    return (h >> k) & ((1 << (64 - k)) - 1)


def _f64_lanes(arr: torch.Tensor) -> tuple:
    """The reference's order-preserving (class and exponent, mantissa)
    lane pair of a FLOAT64 column, in stored form.

    The reference reaches it with ~24 greedy power-of-two ``where``
    rungs (a TPU cannot bitcast 64 bits); the port reads the IEEE fields
    off a bit view, ~15 eager ops for the same lanes:

    - lane 1: NaN 5001, +inf 5000, -inf 0, the zero bucket 2201, a
      positive value ``2201 + (biased exponent + 52)``, a negative one
      ``2201 - (biased exponent + 52)``;
    - lane 2: the 52 mantissa bits of a nonzero finite value (flipped
      for negatives), else 0.

    -0.0 and 0.0 share the zero bucket, and so do the subnormals: the
    reference's arithmetic runs with denormals flushed to zero on its
    CPU and TPU backends, and its eager function gives them the lanes
    of 0.0. A card does not flush doubles, so the port assigns them by
    their exponent field (0) instead. Every NaN, whatever its sign and
    payload, gets one lane pair."""
    bits = arr.to(torch.float64).contiguous().view(torch.int64)
    expf = _shr(bits, 52) & 0x7FF
    mant = bits & ((1 << 52) - 1)
    neg = bits < 0
    special = expf == 0x7FF
    isnan = special & (mant != 0)
    normal = (expf != 0) & ~special
    biased = expf + 52
    lane1 = torch.where(neg, 2201 - biased, 2201 + biased)
    lane1 = torch.where(normal, lane1, 2201)
    lane1 = torch.where(special, torch.where(isnan, 5001, torch.where(neg, 0, 5000)), lane1)
    lane2 = torch.where(normal, torch.where(neg, ((1 << 52) - 1) - mant, mant), 0)
    return lane1 ^ SIGN, lane2 ^ SIGN


def column_lanes(arr: torch.Tensor, ctype: ColumnType) -> tuple:
    """One column as stored-form lane(s): one lane, or two for FLOAT64
    (``_f64_lanes``)."""
    if ctype is ColumnType.BOOL:
        return (arr.to(torch.int64) + SIGN,)
    if ctype in (
        ColumnType.INT32,
        ColumnType.INT64,
        ColumnType.DATE,
        ColumnType.TIMESTAMP,
        ColumnType.DECIMAL,
        ColumnType.STRING,
    ):
        # reference lane: int64(v) ^ SIGN as u64; stored: that ^ SIGN = v
        return (arr.to(torch.int64),)
    if ctype is ColumnType.FLOAT64:
        return _f64_lanes(arr)
    raise NotImplementedError(f"lanes for {ctype}")


def lane_count(ctype: ColumnType, nullable: bool) -> int:
    n = 2 if ctype is ColumnType.FLOAT64 else 1
    return n + (1 if nullable else 0)


def key_lanes(batch: Batch, key_indices) -> list:
    """Stored-form lanes for the given columns. A nullable column (per
    SCHEMA) contributes a leading null lane (0 = NULL, 1 = non-NULL in
    u64 terms) so NULLs sort first and group together; a NULL row's
    value lanes are 0."""
    lanes = []
    for i in key_indices:
        col = batch.schema[i]
        arr = batch.cols[i]
        nulls = batch.nulls[i]
        val_lanes = column_lanes(arr, col.ctype)
        if col.nullable:
            if nulls is None:
                lanes.append(torch.full_like(arr, SIGN + 1, dtype=torch.int64))
                lanes.extend(val_lanes)
            else:
                lanes.append(torch.where(nulls, SIGN, SIGN + 1))
                lanes.extend(torch.where(nulls, SIGN, vl) for vl in val_lanes)
        else:
            lanes.extend(val_lanes)
    if not lanes:
        # Empty key: one constant lane (u64 zero) keeps the machinery
        # uniform.
        lanes.append(
            torch.full((batch.capacity,), SIGN, dtype=torch.int64,
                       device=batch.device)
        )
    return lanes


def key_lane_width(schema, key_indices) -> int:
    """Static lane count key_lanes emits for these columns."""
    w = sum(lane_count(schema[i].ctype, schema[i].nullable) for i in key_indices)
    return w if w else 1


def row_lanes(batch: Batch, include_time: bool = True) -> list:
    """Lanes over every column (plus optionally time)."""
    lanes = key_lanes(batch, range(batch.schema.arity))
    if include_time:
        lanes.append(batch.time ^ SIGN)
    return lanes


def _mix_lane(h: torch.Tensor, raw_lane: torch.Tensor) -> torch.Tensor:
    """One mixing stage of hash_lanes on raw u64 bits (wrapping)."""
    h = h ^ (raw_lane + _s64(_GOLDEN) + (h << 6) + _shr(h, 2))
    h = h * _MIX_MUL
    return h ^ _shr(h, 27)


def hash_lanes(lanes, seed: int = _GOLDEN) -> torch.Tensor:
    """Mix stored-form lanes into one hash, returned in stored form."""
    h = torch.full_like(lanes[0], _s64(seed))
    for lane in lanes:
        h = _mix_lane(h, lane ^ SIGN)
    return h ^ SIGN


def hash_pair(lanes) -> tuple:
    """Two independent 64-bit hashes of a lane tuple — the HASH ORDER
    of consolidation and big arrangements — in stored form. Both mix
    chains run together as one ``[2, cap]`` tensor (half the launches
    of two chains); bit-identical to the reference's ``hash_pair``."""
    h = torch.stack(
        [
            torch.full_like(lanes[0], _s64(_GOLDEN)),
            torch.full_like(lanes[0], _s64(_HASH2_SEED)),
        ]
    )
    for lane in lanes:
        h = _mix_lane(h, (lane ^ SIGN)[None, :])
    h = h ^ SIGN
    return h[0], h[1]


def stack_lanes(lanes) -> torch.Tensor:
    """Row-stack a lane tuple into one contiguous ``[cap, L]`` int64
    tensor (one row gather then moves every lane of a row)."""
    return torch.stack([l.to(torch.int64) for l in lanes], dim=1)


def unstack_lanes(stacked: torch.Tensor) -> list:
    return [stacked[:, j] for j in range(stacked.shape[1])]


# -- stored form <-> the reference's u64 (host side) -------------------------


def to_u64(stored) -> np.ndarray:
    """Stored-form lanes (tensor or int64 array) -> the reference's u64."""
    if isinstance(stored, torch.Tensor):
        stored = stored.cpu().numpy()
    return (np.asarray(stored, dtype=np.int64) ^ np.int64(SIGN)).view(np.uint64)


def from_u64(u) -> np.ndarray:
    """The reference's u64 lanes -> stored-form int64 (numpy)."""
    return np.asarray(u, dtype=np.uint64).view(np.int64) ^ np.int64(SIGN)


# -- numpy replicas for host producers ---------------------------------------


def hash_pair_host(cols_u64: list) -> tuple:
    """Numpy replica of hash_pair over pre-encoded u64 lane arrays (the
    reference's function, copied): host producers emit batches
    PRE-SORTED in the device hash order."""

    def mix(seed):
        h = np.full(cols_u64[0].shape, np.uint64(seed))
        with np.errstate(over="ignore"):
            for lane in cols_u64:
                lane = lane.astype(np.uint64)
                h = h ^ (
                    lane
                    + np.uint64(_GOLDEN)
                    + (h << np.uint64(6))
                    + (h >> np.uint64(2))
                )
                h = h * np.uint64(0xBF58476D1CE4E5B9)
                h = h ^ (h >> np.uint64(27))
        return h

    return mix(_GOLDEN), mix(_HASH2_SEED)


def _f64_lanes_host(col) -> list:
    """Numpy replica of ``_f64_lanes`` in the reference's u64 form."""
    bits = np.ascontiguousarray(np.asarray(col, dtype=np.float64)).view(np.uint64)
    expf = ((bits >> np.uint64(52)) & np.uint64(0x7FF)).astype(np.int64)
    mant = (bits & np.uint64((1 << 52) - 1)).astype(np.int64)
    neg = (bits >> np.uint64(63)) != 0
    special = expf == 0x7FF
    normal = (expf != 0) & ~special
    biased = expf + 52
    lane1 = np.where(normal, np.where(neg, 2201 - biased, 2201 + biased), 2201)
    lane1 = np.where(special, np.where(mant != 0, 5001, np.where(neg, 0, 5000)), lane1)
    lane2 = np.where(normal, np.where(neg, ((1 << 52) - 1) - mant, mant), 0)
    return [lane1.astype(np.uint64), lane2.astype(np.uint64)]


def host_lane_encode(col, column: Column, nulls=None) -> list:
    """Numpy replica of key_lanes' per-column encoding, in the
    reference's u64 form."""
    ctype = column.ctype
    if ctype is ColumnType.FLOAT64:
        vals = _f64_lanes_host(col)
    elif ctype is ColumnType.BOOL:
        vals = [col.astype(np.uint64)]
    else:
        vals = [col.astype(np.int64).astype(np.uint64) ^ np.uint64(1 << 63)]
    if not column.nullable:
        return vals
    if nulls is None:
        return [np.ones(len(col), dtype=np.uint64)] + vals
    nl = nulls.astype(bool)
    return [np.where(nl, np.uint64(0), np.uint64(1))] + [
        np.where(nl, np.uint64(0), v) for v in vals
    ]
