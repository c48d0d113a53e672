"""Arrangements: sorted, consolidated columnar indexes on the device (the
port of ``materialize_tpu/arrangement/spine.py``).

- ``Arrangement``: one consolidated sorted run.
- ``Spine``: a geometric ladder of consolidated sorted runs (smallest
  first, ``runs_b[-1]`` the base), optionally with a ring of append
  slots below run 0, and each run's row-stacked sort lanes cached
  (``[cap, L]`` int64, stored form) and carried through merges by the
  merge's own row gather. Readers see the multiset sum of runs and
  slots.

Order modes: ``exact`` (SQL lane order: key columns, then the rest) or
``hash`` (key hash pair, then full-row hash pair: 4 lanes). Equality is
exact everywhere; hashes only fix the order.

Differences from the reference: the slot cursor is a host integer (the
host drives the schedule, so placing a slot costs no readback and no
device switch), and spines are immutable values — every fold returns
new tensors, so rollback checkpoints hold plain references.
"""

from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass

import torch

from ..ops.consolidate import consolidate, consolidate_sorted, consolidate_sorted_cached
from ..ops.lanes import hash_pair, key_lane_width, key_lanes, stack_lanes
from ..ops.merge import merge_sorted, merge_sorted_cached
from ..ops.search import lex_searchsorted_2d
from ..ops.sort import apply_perm, shrink, sort_perm
from ..repr.batch import Batch
from ..repr.schema import Schema


@dataclass
class Arrangement:
    """A collection arranged (sorted) by a key-column prefix; ``batch``
    is consolidated. ``lanes2d`` is an optional cache of the stacked sort
    lanes (attached by ``Spine.runs()``)."""

    batch: Batch
    key: tuple
    order: str = "exact"
    lanes2d: object = None

    @property
    def schema(self) -> Schema:
        return self.batch.schema

    @property
    def capacity(self) -> int:
        return self.batch.capacity

    @staticmethod
    def empty(schema: Schema, key, capacity: int = 256, device=None) -> "Arrangement":
        return Arrangement(Batch.empty(schema, capacity, device=device), tuple(key))

    def map_batches(self, fn) -> "Arrangement":
        """Rebuild with ``fn`` applied to the batch (growth); drops the
        lane cache."""
        return Arrangement(fn(self.batch), self.key, self.order)

    def _rest(self) -> list:
        return [i for i in range(self.schema.arity) if i not in self.key]

    def sort_lanes(self) -> list:
        """exact: key cols then the rest; hash: (key hash pair,
        full-row hash pair)."""
        rest = self._rest()
        if self.order == "hash":
            kh1, kh2 = hash_pair(key_lanes(self.batch, self.key))
            if not rest:
                # Full-column key: the row hash IS the key hash.
                return [kh1, kh2, kh1, kh2]
            rh1, rh2 = hash_pair(key_lanes(self.batch, list(self.key) + rest))
            return [kh1, kh2, rh1, rh2]
        return key_lanes(self.batch, list(self.key) + rest)

    def sort_lanes_2d(self) -> torch.Tensor:
        if self.lanes2d is not None:
            return self.lanes2d
        return stack_lanes(self.sort_lanes())

    def key_lane_prefix(self) -> int:
        if self.order == "hash":
            return 2
        return key_lane_width(self.schema, self.key)

    def key_lanes_2d(self) -> torch.Tensor:
        """Stacked key-only lanes (a prefix of the sort lanes, except for
        the empty key's constant lane)."""
        if not self.key:
            from ..ops.lanes import SIGN

            return torch.full(
                (self.batch.capacity, 1), SIGN, dtype=torch.int64,
                device=self.batch.device,
            )
        return self.sort_lanes_2d()[:, : self.key_lane_prefix()].contiguous()

    def probe_lanes(self, batch: Batch, cols) -> list:
        """Lanes for probing this arrangement with ``batch``'s ``cols``."""
        if self.order == "hash":
            kh1, kh2 = hash_pair(key_lanes(batch, cols))
            return [kh1, kh2]
        return key_lanes(batch, cols)


def run_sort_lanes(batch: Batch, key, order: str) -> torch.Tensor:
    """Stacked sort lanes of a run batch — the lane-cache (re)build."""
    return stack_lanes(Arrangement(batch, tuple(key), order).sort_lanes())


def arrange(batch: Batch, key, capacity: int | None = None,
            order: str = "exact") -> Arrangement:
    """Sort + consolidate a batch into an Arrangement."""
    if capacity is not None:
        from ..plan.decisions import quantize_cap

        capacity = quantize_cap(capacity, minimum=batch.capacity)
    key = tuple(key)
    cons = consolidate(batch, include_time=False)
    # consolidate's output is in full-row hash order: a hash-mode
    # arrangement keyed by every column in schema order is sorted.
    if order == "hash" and key == tuple(range(batch.schema.arity)):
        sorted_batch = cons
    else:
        arr = Arrangement(cons, key, order)
        perm = sort_perm(arr.sort_lanes(), cons.count, cons.capacity)
        sorted_batch = apply_perm(cons, perm)
    if capacity is not None and capacity != sorted_batch.capacity:
        sorted_batch = sorted_batch.with_capacity(capacity)
    return Arrangement(sorted_batch, key, order)


def insert(arr: Arrangement, delta: Batch, out_capacity: int):
    """Merge a delta into the arrangement; returns (arrangement,
    overflowed)."""
    d = arrange(delta, arr.key, capacity=None, order=arr.order)
    merged, overflow = merge_sorted(
        arr.batch, arr.sort_lanes_2d(), d.batch, d.sort_lanes_2d(), out_capacity
    )
    return Arrangement(consolidate_sorted(merged), arr.key, arr.order), overflow


def lookup_range(arr: Arrangement, probe_lanes) -> tuple:
    """For each probe key, the [lo, hi) row range of matching keys."""
    lanes_2d = arr.key_lanes_2d()
    query_2d = (
        probe_lanes if getattr(probe_lanes, "ndim", None) == 2
        else stack_lanes(probe_lanes)
    )
    lo = lex_searchsorted_2d(lanes_2d, arr.batch.count, query_2d, side="left")
    hi = lex_searchsorted_2d(lanes_2d, arr.batch.count, query_2d, side="right")
    return lo, hi


@dataclass
class Spine:
    """Geometric ladder of consolidated sorted runs (``runs_b[0]``
    smallest, ``runs_b[-1]`` the base), an optional append-slot ring
    with its host cursor, and the cached stacked sort lanes of every run
    and slot (``()`` when caching is off)."""

    runs_b: tuple
    key: tuple
    order: str = "exact"
    slots: tuple = ()
    cursor: int = 0
    lanes: tuple = ()
    slot_lanes: tuple = ()

    @property
    def levels(self) -> int:
        return len(self.runs_b)

    @property
    def base(self) -> Batch:
        return self.runs_b[-1]

    @property
    def tail(self) -> Batch:
        return self.runs_b[0]

    @property
    def schema(self) -> Schema:
        return self.base.schema

    @property
    def device(self) -> torch.device:
        return self.base.device

    def run_lanes_2d(self, i: int) -> torch.Tensor:
        if self.lanes:
            return self.lanes[i]
        return run_sort_lanes(self.runs_b[i], self.key, self.order)

    def slot_lanes_2d(self, i: int) -> torch.Tensor:
        if self.slot_lanes:
            return self.slot_lanes[i]
        return run_sort_lanes(self.slots[i], self.key, self.order)

    def _with(self, **kw) -> "Spine":
        d = dict(
            runs_b=self.runs_b, key=self.key, order=self.order,
            slots=self.slots, cursor=self.cursor, lanes=self.lanes,
            slot_lanes=self.slot_lanes,
        )
        d.update(kw)
        return Spine(**d)

    def with_run(self, i: int, batch: Batch, lanes=None) -> "Spine":
        """Replace run i; ``lanes`` None keeps the cached lanes (the
        run's rows are unchanged in content, e.g. a count reset)."""
        rs = list(self.runs_b)
        rs[i] = batch
        new_lanes = self.lanes
        if self.lanes and lanes is not None:
            ls = list(self.lanes)
            ls[i] = lanes
            new_lanes = tuple(ls)
        return self._with(runs_b=tuple(rs), lanes=new_lanes)

    def runs(self) -> tuple:
        """Single-run Arrangement views (base first, then smaller runs,
        then slots), each carrying its cached lanes."""
        batches = tuple(reversed(self.runs_b)) + self.slots
        if self.lanes:
            lanes = tuple(reversed(self.lanes)) + self.slot_lanes
        else:
            lanes = (None,) * len(batches)
        return tuple(
            Arrangement(b, self.key, self.order, lanes2d=l)
            for b, l in zip(batches, lanes)
        )

    @staticmethod
    def empty(schema: Schema, key, capacity: int = 256, tail_capacity: int = 1024,
              order: str = "exact", levels: int = 2, ratio: int = 8,
              ingest_slots: int = 0, cache_lanes: bool = True,
              device=None) -> "Spine":
        """Capacities run geometrically from ``tail_capacity`` up, with
        the base pinned at ``capacity``; ``ingest_slots`` > 0 adds a ring
        of that many ``tail_capacity`` slots."""
        if levels < 2:
            raise ValueError("a spine needs at least 2 levels")
        caps = [tail_capacity * (ratio ** i) for i in range(levels - 1)]
        caps.append(capacity)
        key = tuple(key)
        runs = tuple(Batch.empty(schema, c, device=device) for c in caps)
        slots = tuple(
            Batch.empty(schema, tail_capacity, device=device).canonicalize_nulls()
            for _ in range(ingest_slots)
        )
        lanes, slot_lanes = (), ()
        if cache_lanes:
            lanes = tuple(run_sort_lanes(b, key, order) for b in runs)
            slot_lanes = tuple(run_sort_lanes(s, key, order) for s in slots)
        return Spine(runs, key, order, slots, 0, lanes, slot_lanes)


def _arrange_for_run(delta: Batch, key: tuple, order: str) -> Arrangement:
    """Arrange a delta for a spine run: a delta already content-hash
    sorted skips both the sort and the re-consolidation."""
    if (
        order == "hash"
        and key == tuple(range(delta.schema.arity))
        and ("hash_sorted" in delta.hints or "hash_consolidated" in delta.hints)
    ):
        return Arrangement(delta, key, order)
    return arrange(delta, key, capacity=None, order=order)


def insert_tail(spine: Spine, delta: Batch):
    """Absorb a delta — the hot-path insert. With a slot ring the
    arranged delta BECOMES slot ``cursor % slots`` (O(delta)); without,
    it merges into run 0. Returns (new_spine, overflowed)."""
    d = _arrange_for_run(delta, spine.key, spine.order)
    if spine.slots:
        slot_cap = spine.slots[0].capacity
        nb = d.batch
        overflow = nb.count > slot_cap
        if nb.capacity < slot_cap:
            nb = nb.with_capacity(slot_cap)
        elif nb.capacity > slot_cap:
            nb, sovf = shrink(nb, slot_cap)
            overflow = overflow | sovf
        nb = nb.canonicalize_nulls().replace(hints=())
        k = spine.cursor % len(spine.slots)
        slots = list(spine.slots)
        slots[k] = nb
        slot_lanes = spine.slot_lanes
        if slot_lanes:
            sl = list(slot_lanes)
            sl[k] = run_sort_lanes(nb, spine.key, spine.order)
            slot_lanes = tuple(sl)
        return (
            spine._with(slots=tuple(slots), cursor=spine.cursor + 1,
                        slot_lanes=slot_lanes),
            overflow,
        )
    tail = spine.tail
    merged, merged_lanes, overflow = merge_sorted_cached(
        tail, spine.run_lanes_2d(0), d.batch, d.sort_lanes_2d(), tail.capacity
    )
    cons, cons_lanes = consolidate_sorted_cached(merged, merged_lanes)
    return spine.with_run(0, cons, cons_lanes), overflow


def _tree_merge_cached(parts: list):
    """Pairwise-merge (sorted batch, lanes) pairs into one (capacity =
    sum; never overflows)."""
    while len(parts) > 1:
        nxt = []
        for i in range(0, len(parts) - 1, 2):
            (a, al), (b, bl) = parts[i], parts[i + 1]
            m, ml, _ = merge_sorted_cached(a, al, b, bl, a.capacity + b.capacity)
            nxt.append((m, ml))
        if len(parts) % 2:
            nxt.append(parts[-1])
        parts = nxt
    return parts[0]


def flush_slots(spine: Spine):
    """Fold the slot ring into run 0: tree-merge the slots, merge into
    run 0, clear the ring. Returns (new_spine, run-0 overflow)."""
    if not spine.slots:
        return spine, torch.zeros((), dtype=torch.bool, device=spine.device)
    merged_slots, slot_merged_lanes = _tree_merge_cached(
        [(s, spine.slot_lanes_2d(i)) for i, s in enumerate(spine.slots)]
    )
    r0 = spine.runs_b[0]
    merged, merged_lanes, overflow = merge_sorted_cached(
        r0, spine.run_lanes_2d(0), merged_slots, slot_merged_lanes, r0.capacity
    )
    cons, cons_lanes = consolidate_sorted_cached(merged, merged_lanes)
    cleared = tuple(s.replace(count=torch.zeros_like(s.count)) for s in spine.slots)
    new = spine.with_run(0, cons, cons_lanes)
    return new._with(slots=cleared, cursor=0), overflow


def compact_depth(spine: Spine) -> int:
    """Number of fold levels: a slotted spine's level 0 is the slot
    flush; level l > 0 folds run l-1 into run l."""
    return spine.levels - 1 + (1 if spine.slots else 0)


def compact_level(spine: Spine, level: int):
    """Fold one ladder level; returns (new_spine, overflowed) where the
    flag is the TARGET run's capacity overflow."""
    if spine.slots:
        if level == 0:
            return flush_slots(spine)
        lo_i, hi_i = level - 1, level
    else:
        lo_i, hi_i = level, level + 1
    lo, hi = spine.runs_b[lo_i], spine.runs_b[hi_i]
    merged, merged_lanes, overflow = merge_sorted_cached(
        hi, spine.run_lanes_2d(hi_i), lo, spine.run_lanes_2d(lo_i), hi.capacity
    )
    cons, cons_lanes = consolidate_sorted_cached(merged, merged_lanes)
    out = spine.with_run(hi_i, cons, cons_lanes)
    out = out.with_run(lo_i, lo.replace(count=torch.zeros_like(lo.count)))
    return out, overflow


def clone_state_tree(tree):
    """Copy every tensor of a state tree (tuples and lists of
    arrangements, spines, batches and tensors) into fresh storage; the
    tree's other values are shared."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(clone_state_tree(x) for x in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(clone_state_tree(x) for x in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        new = copy.copy(tree)
        for f in dataclasses.fields(tree):
            object.__setattr__(new, f.name, clone_state_tree(getattr(tree, f.name)))
        return new
    return tree


def compact_spine(spine: Spine):
    """Full cascade into the base; returns (new_spine, flags
    [compact_depth], smallest target first)."""
    flags = []
    for level in range(compact_depth(spine)):
        spine, ovf = compact_level(spine, level)
        flags.append(ovf)
    return spine, torch.stack(flags)
