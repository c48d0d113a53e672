"""The load generator as processes of its own, ahead of the system under
test, behind a bounded ring of shared buffers.

The source is a module ``ivmbench/gen/<source>.py`` (see ``tpch.py``):
``INPUTS`` gives each input's columns and dtypes, ``stream(sf, seed,
codes)`` makes its rows. Items are numbered in the order the harness
consumes them: the snapshot's insert-only batches first, then the churn
ticks; an item is ``{input: (columns, diffs)}``. Process ``p`` of ``P``
makes the items ``i`` with ``i % P == p``, each into the next slot of
its own ring of ``slots`` buffers, and replays the version bookkeeping
of every tick it does not make, so all of them agree on which rows a
tick deletes. The harness reads an item's columns in place and frees
its slot once the program has copied them; a full ring stops the
process until then. Nothing but numpy runs in these processes, at a
lower scheduling priority than the harness's own.
"""

from __future__ import annotations

import importlib
import os
import queue
import time
import traceback

import numpy as np

NICE = 5  # the generators yield the CPU to the process that drives the card


def source(name: str):
    """The source module ``ivmbench/gen/<name>.py``."""
    return importlib.import_module(f"ivmbench.gen.{name}")


def slot_layout(inputs: dict, slot_rows: int):
    """For each input, the byte offsets of its columns and of its diffs in
    a slot; and the slot's size."""
    offs, at = {}, 0
    for name, columns in inputs.items():
        cols = []
        for _, dt in columns:
            cols.append(at)
            at += slot_rows * np.dtype(dt).itemsize
        offs[name] = (cols, at)
        at += slot_rows * 8
    return offs, at


def _views(inputs: dict, buf, slot: int, slot_rows: int, counts: dict) -> dict:
    offs, size = slot_layout(inputs, slot_rows)
    base = slot * size
    out = {}
    for name, columns in inputs.items():
        col_offs, diff_off = offs[name]
        n = counts[name]
        cols = [np.frombuffer(buf, dtype=dt, count=n, offset=base + off)
                for (_, dt), off in zip(columns, col_offs)]
        out[name] = (cols, np.frombuffer(buf, dtype=np.int64, count=n, offset=base + diff_off))
    return out


def worker(p: int, n_procs: int, plan: dict, buf, free, filled, control, stop) -> None:
    """Generator process ``p``: waits for the start message (the string
    codes and the snapshot's batch size), then fills its ring until the
    harness stops it."""
    try:
        os.nice(NICE)
        start = control.get()
        if start is None:
            return
        codes, batch_orders = start
        src = source(plan["source"])
        stream = src.stream(plan["sf"], plan["seed"], codes)
        n_snap = stream.snapshot_batches(batch_orders)
        per_tick = plan["orders_per_tick"]
        slots, slot_rows = plan["slots"], plan["slot_rows"]
        local, item = 0, 0
        while not stop.is_set():
            mine = item % n_procs == p
            if item < n_snap:
                if not mine:
                    item += 1
                    continue
                made = stream.snapshot_item(item, batch_orders)
            else:
                tick = item - n_snap
                if not mine:
                    stream.advance(per_tick, tick)
                    item += 1
                    continue
                made = stream.tick(per_tick, tick)
            counts = {name: len(cols[0]) for name, (cols, _) in made.items()}
            if max(counts.values()) > slot_rows:
                raise ValueError(f"item {item}: {counts} rows over the slot's {slot_rows}")
            while not free.acquire(timeout=0.5):
                if stop.is_set():
                    return
            if stop.is_set():
                return
            slot = local % slots
            views = _views(src.INPUTS, buf, slot, slot_rows, counts)
            for name, (cols, diffs) in made.items():
                v_cols, v_diff = views[name]
                for dst, col in zip(v_cols, cols):
                    dst[:] = col
                v_diff[:] = 1 if diffs is None else diffs
            filled.put((item, counts, slot))
            local += 1
            item += 1
    except Exception:  # noqa: BLE001 - a boundary: the harness reports it and fails
        filled.put(("error", traceback.format_exc()))


class Feed:
    """The harness's end of the generator processes: ``next()`` gives the
    next item in place, ``release()`` frees its slot. ``plan`` holds
    ``source``, ``sf``, ``seed``, ``orders_per_tick``, ``slots`` and
    ``slot_rows``."""

    def __init__(self, ctx, plan: dict, n_procs: int):
        self.plan = plan
        self.n_procs = n_procs
        self.slot_rows = plan["slot_rows"]
        self.inputs = source(plan["source"]).INPUTS
        _, size = slot_layout(self.inputs, self.slot_rows)
        self.stop_event = ctx.Event()
        self.procs, self.bufs, self.frees, self.filleds, self.controls = [], [], [], [], []
        for p in range(n_procs):
            buf = ctx.RawArray("b", size * plan["slots"])
            free = ctx.Semaphore(plan["slots"])
            filled = ctx.Queue()
            control = ctx.Queue()
            proc = ctx.Process(
                target=worker, name=f"ivmbench-gen-{p}",
                args=(p, n_procs, plan, buf, free, filled, control, self.stop_event),
                daemon=True,
            )
            proc.start()
            self.procs.append(proc)
            self.bufs.append(buf)
            self.frees.append(free)
            self.filleds.append(filled)
            self.controls.append(control)
        self.item = 0
        self.closed = False

    def start(self, codes, batch_orders: int) -> None:
        for c in self.controls:
            c.put(([int(x) for x in codes], int(batch_orders)))

    def next(self):
        """(item index, {input: (columns, diffs)}) of the next item, read
        in place from its slot; valid until ``release(item)``."""
        p = self.item % self.n_procs
        while True:
            try:
                msg = self.filleds[p].get(timeout=1.0)
                break
            except queue.Empty:
                if not self.procs[p].is_alive():
                    raise RuntimeError(
                        f"generator process {p} ended (exit code {self.procs[p].exitcode})"
                    ) from None
        if msg[0] == "error":
            raise RuntimeError(f"generator process {p} failed:\n{msg[1]}")
        item, counts, slot = msg
        if item != self.item:
            raise RuntimeError(f"generator {p} sent item {item}, expected {self.item}")
        self.item += 1
        return item, _views(self.inputs, self.bufs[p], slot, self.slot_rows, counts)

    def release(self, item: int) -> None:
        self.frees[item % self.n_procs].release()

    def close(self) -> None:
        """Stop every generator process and wait until each has ended."""
        if self.closed:
            return
        self.closed = True
        self.stop_event.set()
        for c in self.controls:
            c.put(None)
        for f in self.frees:
            f.release()
        for proc, filled in zip(self.procs, self.filleds):
            deadline = time.monotonic() + 10.0
            while proc.is_alive() and time.monotonic() < deadline:
                try:  # drain, so a put blocked on a full pipe can finish
                    while True:
                        filled.get_nowait()
                except queue.Empty:
                    pass
                proc.join(timeout=0.1)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=5.0)
        for q in self.filleds + self.controls:
            q.close()
            q.join_thread()
