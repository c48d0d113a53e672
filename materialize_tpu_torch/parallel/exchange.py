"""Exchange: route update rows to the rank that owns their key (the port
of ``materialize_tpu/parallel/exchange.py``).

Every stateful operator's input is routed so that the rank owning
``hash(key) % P`` sees every update of that key (timely's Exchange
pact). The reference routes with ``lax.all_to_all`` inside its SPMD
step; here each rank calls ``dist.all_to_all_single`` on its own
tensors, one collective per field as the reference's program has one
per field, so the communication census compares one to one.

Fixed shapes, as in the reference: a sender packs rows into ``P``
destination slots of ``slot_cap`` rows each (a ``[P * slot_cap]`` send
buffer per field). A destination slot can overflow on skewed keys; the
flag is all-reduced so that every rank retries the step together at a
larger slot tier.
"""

from __future__ import annotations

import torch

from ..ops.lanes import SIGN, column_lanes, hash_lanes, key_lanes
from ..ops.sort import compact
from ..repr.batch import Batch


def _u64_mod(raw: torch.Tensor, n: int) -> torch.Tensor:
    """``u64 % n`` of u64 bits held in int64 (torch has no unsigned
    64-bit remainder): split into 32-bit halves, each reduced mod n."""
    hi = (raw >> 32) & 0xFFFFFFFF
    lo = raw & 0xFFFFFFFF
    return ((hi % n) * ((1 << 32) % n) + lo % n) % n


def shard_of(batch: Batch, key, num_shards: int,
             null_aware: bool = True) -> torch.Tensor:
    """Destination rank per row: the key columns' hash mod the workers,
    bit-identical to the reference's. ``null_aware=False`` hashes the
    raw value lanes only (no null lanes), so both sides of a join route
    equal keys alike even where their key columns differ in
    nullability (a join drops NULL keys anyway)."""
    if null_aware:
        lanes = key_lanes(batch, key)
    else:
        lanes = []
        for i in key:
            lanes.extend(column_lanes(batch.cols[i], batch.schema[i].ctype))
        if not lanes:
            lanes = [torch.full((batch.capacity,), SIGN, dtype=torch.int64,
                                device=batch.device)]
    raw = hash_lanes(lanes) ^ SIGN
    return _u64_mod(raw, num_shards).to(torch.int32)


def partition(batch: Batch, route: torch.Tensor, num_shards: int,
              slot_cap: int):
    """Pack rows into ``[num_shards * slot_cap]`` send buffers grouped by
    destination (rows for rank d occupy ``[d * slot_cap, d * slot_cap +
    count_d)``). Returns (fields dict, counts [P] int32, overflow flag).
    Rows beyond ``slot_cap`` for one destination go to a spare row that
    is cut off, and set the flag."""
    cap = batch.capacity
    dev = batch.device
    valid = batch.valid_mask()
    route = torch.where(valid, route.to(torch.int64), num_shards)  # padding last
    sroute, perm = torch.sort(route, stable=True)
    idx = torch.arange(cap, dtype=torch.int64, device=dev)
    starts = torch.ones(cap, dtype=torch.bool, device=dev)
    starts[1:] = sroute[1:] != sroute[:-1]
    group_start = torch.cummax(torch.where(starts, idx, 0), 0).values
    rank = idx - group_start
    live = sroute < num_shards
    spare = num_shards * slot_cap
    dest = torch.where(live & (rank < slot_cap), sroute * slot_cap + rank, spare)
    overflow = (live & (rank >= slot_cap)).any()
    counts = torch.zeros(num_shards + 1, dtype=torch.int32, device=dev)
    counts.index_add_(0, route, valid.to(torch.int32))
    counts = torch.clamp(counts[:num_shards], max=slot_cap)

    def scatter(a):
        if a is None:
            return None
        out = torch.zeros(spare + 1, dtype=a.dtype, device=dev)
        out[dest] = a[perm]
        return out[:spare]

    fields = {
        "cols": tuple(scatter(c) for c in batch.cols),
        "nulls": tuple(scatter(n) for n in batch.nulls),
        "time": scatter(batch.time),
        "diff": scatter(batch.diff),
    }
    return fields, counts, overflow


def exchange(batch: Batch, key, mesh, num_shards: int, slot_cap: int,
             null_aware: bool = True):
    """Route rows to their key's owning rank; every rank of ``mesh``
    calls it together. Returns (routed batch, overflow flag): the routed
    batch has capacity ``num_shards * slot_cap`` with its valid rows
    compacted to the front, and the flag is the same on every rank."""
    route = shard_of(batch, key, num_shards, null_aware)
    fields, counts, overflow = partition(batch, route, num_shards, slot_cap)
    recv_counts = mesh.all_to_all(counts)

    def a2a(a):
        return None if a is None else mesh.all_to_all(a)

    dev = batch.device
    out = Batch(
        cols=tuple(a2a(c) for c in fields["cols"]),
        nulls=tuple(a2a(n) for n in fields["nulls"]),
        time=a2a(fields["time"]),
        diff=a2a(fields["diff"]),
        count=torch.tensor(num_shards * slot_cap, dtype=torch.int32, device=dev),
        schema=batch.schema,
    )
    # Row (p, i) of the receive buffer is valid iff i < recv_counts[p].
    slot_idx = torch.arange(slot_cap, dtype=torch.int32, device=dev).repeat(num_shards)
    keep = slot_idx < torch.repeat_interleave(recv_counts, slot_cap)
    out = compact(out, keep)
    # Rows were dropped if any sender overflowed: all ranks retry.
    overflow = mesh.psum(overflow.to(torch.int32).reshape(1)).reshape(()) > 0
    return out, overflow
