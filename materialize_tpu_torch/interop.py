"""Carry state between the reference package and the port as plain numpy.

The state counterpart of carrying weights across: a reference ``Batch``
or ``Spine`` is read out with ``np.asarray`` into a dict, and these
functions rebuild the port's objects from it (and back). u64 values
(``time``, cached sort lanes) are mapped into the port's int64 storage:
``time`` keeps its 64 bits, lanes take the stored form of
``ops/lanes.py`` (``u64 ^ (1 << 63)``).

Batch dict: ``cols`` (list of [cap] arrays), ``nulls`` (list of [cap]
bool arrays or None), ``time`` ([cap] u64), ``diff`` ([cap] int64),
``count`` (int) and optionally ``hints``.
Spine dict: ``runs`` and ``slots`` (lists of batch dicts), ``lanes`` and
``slot_lanes`` (lists of [cap, L] u64, empty when not cached),
``cursor`` (int), ``key`` (tuple) and ``order`` ("hash" | "exact").
Arrangement dict: ``batch`` (a batch dict), ``key`` and ``order``.

``install_state`` puts a reference dataflow's whole state into a port
``Dataflow`` of the same plan: its operator states (arrangements, and
the spines of a join, a Threshold's arrangement, a temporal Filter's
buffer of future updates with their release times in its u64 time
column), output spine, err arrangement, frontier, first processed time,
and join and LetRec tiers.
"""

from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .arrangement.spine import Arrangement, Spine
from .ops.lanes import from_u64, to_u64
from .repr.batch import Batch
from .repr.schema import ERR_SCHEMA, Schema


def batch_from_numpy(d: dict, schema: Schema, device=None) -> Batch:
    """A port Batch holding exactly the rows and padding of ``d``."""
    dev = resolve_device(device)

    def put(a, np_dtype):
        a = np.ascontiguousarray(np.asarray(a, dtype=np_dtype))
        if a.dtype == np.uint64:
            a = a.view(np.int64)
        return torch.from_numpy(a.copy()).to(dev)

    nulls = d.get("nulls") or [None] * schema.arity
    b = Batch(
        cols=tuple(put(c, col.dtype) for c, col in zip(d["cols"], schema.columns)),
        nulls=tuple(None if nl is None else put(nl, np.bool_) for nl in nulls),
        time=put(d["time"], np.uint64),
        diff=put(d["diff"], np.int64),
        count=torch.tensor(int(d["count"]), dtype=torch.int32, device=dev),
        schema=schema,
        hints=tuple(d.get("hints", ())),
    )
    b._host_count = int(d["count"])
    return b


def batch_to_numpy(b: Batch) -> dict:
    """The inverse of batch_from_numpy (whole capacity, time as u64)."""
    return {
        "cols": [c.cpu().numpy() for c in b.cols],
        "nulls": [None if n is None else n.cpu().numpy() for n in b.nulls],
        "time": b.time.cpu().numpy().view(np.uint64),
        "diff": b.diff.cpu().numpy(),
        "count": int(b.count),
        "hints": tuple(b.hints),
    }


def _lanes_from_u64(u, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(from_u64(u))).to(dev)


def spine_from_numpy(d: dict, schema: Schema, device=None) -> Spine:
    """A port Spine with the runs, slots, cached lanes and cursor of ``d``."""
    dev = resolve_device(device)
    return Spine(
        runs_b=tuple(batch_from_numpy(r, schema, dev) for r in d["runs"]),
        key=tuple(d["key"]),
        order=d["order"],
        slots=tuple(batch_from_numpy(s, schema, dev) for s in d.get("slots", ())),
        cursor=int(d.get("cursor", 0) or 0),
        lanes=tuple(_lanes_from_u64(l, dev) for l in d.get("lanes", ())),
        slot_lanes=tuple(_lanes_from_u64(l, dev) for l in d.get("slot_lanes", ())),
    )


def spine_to_numpy(sp: Spine) -> dict:
    """The inverse of spine_from_numpy (lanes back as u64)."""
    return {
        "runs": [batch_to_numpy(r) for r in sp.runs_b],
        "slots": [batch_to_numpy(s) for s in sp.slots],
        "lanes": [to_u64(l) for l in sp.lanes],
        "slot_lanes": [to_u64(l) for l in sp.slot_lanes],
        "cursor": sp.cursor,
        "key": tuple(sp.key),
        "order": sp.order,
    }


def arrangement_from_numpy(d: dict, schema: Schema, device=None) -> Arrangement:
    """A port Arrangement holding exactly the batch of ``d``."""
    return Arrangement(batch_from_numpy(d["batch"], schema, device), tuple(d["key"]),
                       d.get("order", "exact"))


def arrangement_to_numpy(arr: Arrangement) -> dict:
    """The inverse of arrangement_from_numpy."""
    return {"batch": batch_to_numpy(arr.batch), "key": tuple(arr.key),
            "order": arr.order}


def _part_from_numpy(d: dict, cur, device):
    """One state part: a spine where the plan holds a spine (a delta
    join's arrangement), else an arrangement."""
    if isinstance(cur, Spine):
        return spine_from_numpy(d, cur.schema, device)
    return arrangement_from_numpy(d, cur.schema, device)


def install_state(df, states: list, output: dict, err_output: dict, time: int,
                  compact_tick: int = 0, join_caps=None, letrec_caps=None) -> None:
    """Replace a port Dataflow's state with a reference dataflow's:
    ``states`` holds, per state slot, the list of its parts as
    arrangement or spine dicts (slot order, part kinds and schemas are
    the plan's, so both packages agree on them); ``output`` is the output
    spine's dict, ``err_output`` the err arrangement's, ``time`` the
    frontier, ``compact_tick`` the fold schedule's tick, ``join_caps``
    the join sites' output tiers and ``letrec_caps`` the LetRec sites'
    binding-delta tiers (None keeps the port's). The first processed
    time, where a Constant emits, becomes 0, the reference's. A TopK's
    or a Threshold's arrangement, a temporal Filter's buffer, a linear
    join's spines and the states inside a LetRec are parts like any
    other.
    ``peek_errors`` reads the carried errors once the port has stepped
    (whether the plan has err sites is learnt at the first step)."""
    if len(states) != len(df.states):
        raise ValueError(f"{len(states)} state slots for a plan with {len(df.states)}")
    df.states = [
        tuple(_part_from_numpy(p, cur, df.device) for p, cur in zip(parts, now))
        for parts, now in zip(states, df.states)
    ]
    if join_caps is not None:
        if len(join_caps) != len(df._ctx.join_caps):
            raise ValueError(f"{len(join_caps)} join tiers for a plan with "
                             f"{len(df._ctx.join_caps)} join sites")
        df._ctx.join_caps[:] = [int(c) for c in join_caps]
    if letrec_caps is not None:
        if len(letrec_caps) != len(df._ctx.letrec_caps):
            raise ValueError(f"{len(letrec_caps)} LetRec tiers for a plan with "
                             f"{len(df._ctx.letrec_caps)} LetRec sites")
        df._ctx.letrec_caps[:] = [int(c) for c in letrec_caps]
    df.output = spine_from_numpy(output, df.out_schema, df.device)
    df.err_output = arrangement_from_numpy(err_output, ERR_SCHEMA, df.device)
    df._time = int(time)
    df._compact_tick = int(compact_tick)
    df._ctx.first_time = 0
