"""Pipelined span executor: the double-buffered control plane (the
port's copy of ``materialize_tpu/render/span_exec.py``).

The serial span protocol — dispatch span K, block on its readback,
think, dispatch span K+1 — leaves the device idle for the whole host
gap between spans. This executor keeps the device fed and coordinates
only at span boundaries:

    stage span K+1's inputs     (the port builds inputs on the
                                 dataflow's device: a pass-through)
    dispatch span K+1           (its eager kernels queue behind K's on
                                 the stream; the device never drains)
    read span K's flags         (ONE device->host readback per span:
                                 the OR-accumulated overflow flags,
                                 copied into pinned host memory right
                                 after K's dispatch; waiting on the
                                 copy's event blocks exactly until K
                                 finished while K+1 is already queued)
    commit span K               (frontier advance, trace record)

At most ONE span is in flight ahead of the committed boundary (double
buffering), and every span's device->host traffic is the single flags
readback (``readbacks == 1`` in the trace).

Donation (``span_donation`` dyncfg): the reference hands the span
program's carry to XLA so each span writes into the previous span's
buffers. Eager torch has no such hand-off: every step returns fresh
state tensors and the rollback checkpoint holds references
(``Dataflow._checkpoint``), so nothing is aliased and the effective
donation is always off (``_donation_supported()`` is false, as on the
reference's CPU backend). The request is still resolved as the
reference resolves it, and a requested window still checkpoints through
``Dataflow._clone_checkpoint``, kept for the day the port's carries are
updated in place. Every read of dataflow state sequences through
:meth:`sync` (the span barrier wired into ``output_batch``,
``peek_errors``, ``run_steps`` and ``run_span``).

Overflow keeps the rollback/replay contract: flags accumulate as an
on-device OR, so the span whose boundary readback first reports an
overflow triggers ``check_flags`` — roll back to the window checkpoint,
grow the flagged tiers, replay the window's logged inputs — and the
pipeline refills. Windows are bounded (``span_window_spans``) so the
defer log cannot grow without bound in a long-running loop.
"""

from __future__ import annotations

import time as _time

import numpy as np


def resolve_donation(mode=None) -> bool:
    """Resolve the span-carry donation request: an explicit bool wins,
    then the ``span_donation`` dyncfg ('on'/'off'/'auto'); 'auto'
    donates only where the backend implements donation, which eager
    torch does not."""
    if isinstance(mode, bool):
        return mode
    if mode is None:
        from ..utils.dyncfg import COMPUTE_CONFIGS, SPAN_DONATION

        mode = SPAN_DONATION(COMPUTE_CONFIGS)
    if mode in ("on", "true", True):
        return True
    if mode in ("off", "false", False):
        return False
    from .dataflow import _donation_supported

    return _donation_supported()


class SpanExecutor:
    """Double-buffered pipelined execution of a ``Dataflow``'s spans.
    One executor per dataflow; attaching sets the dataflow's span
    barrier so state reads sequence against span boundaries."""

    def __init__(self, df, donate=None, trace: bool = True):
        from .dataflow import _donation_supported

        self.df = df
        # `donate` is the REQUEST (dyncfg policy); `self.donate` is what
        # takes effect, and what stats and the span trace report.
        self.donate_requested = resolve_donation(donate)
        self.donate = self.donate_requested and _donation_supported()
        # Reentrancy guard: the dataflow's span_barrier() must no-op for
        # reads issued by this executor's own dispatch/sync path.
        self.in_dispatch = False
        # (flags snapshot, trace rec, deltas, arrival monotonic stamp)
        self._inflight = None
        self.trace: list[dict] = [] if trace else None
        self.freshness_label = getattr(df, "name", "") or "span"
        self.freshness_replica = "local"
        self.spans_submitted = 0
        self.spans_committed = 0
        self.boundary_syncs = 0  # reads that forced a span boundary
        self.overflows = 0
        # The most spans dispatched past the committed boundary at once.
        self.max_inflight = 0
        self._last_host_free: float | None = None
        df._span_exec = self

    # -- the pipeline -------------------------------------------------------
    def submit(self, inputs_list: list):
        """Stage + dispatch one span, then complete the PREVIOUS span's
        boundary (its one readback): the readback waits for the previous
        span while this one is already queued on the device. Returns the
        previous span's committed (validated) deltas, or None when there
        was no previous span or its window was replayed."""
        from ..utils.dyncfg import COMPUTE_CONFIGS, SPAN_WINDOW_SPANS
        from ..utils.lockcheck import device_dispatch

        device_dispatch("span_exec.submit")
        t0 = _time.perf_counter()
        arrived = _time.monotonic()  # freshness clock (lag_ms)
        gap_ms = (
            0.0
            if self._last_host_free is None
            else (t0 - self._last_host_free) * 1e3
        )
        prev_deltas = None
        self.in_dispatch = True
        try:
            window_sync_ms = 0.0
            if (
                len(self.df._defer_log)
                >= int(SPAN_WINDOW_SPANS(COMPUTE_CONFIGS))
            ):
                # Window boundary: validate + clear the defer log so
                # replay memory stays bounded. One extra sync point,
                # amortized over the window, timed on its own.
                self._sync_locked()
                self.df.check_flags()
                window_sync_ms = (_time.perf_counter() - t0) * 1e3
            t_up = _time.perf_counter()
            staged = self._stage(inputs_list)
            t1 = _time.perf_counter()
            deltas = self.df.run_span(
                staged, donate=self.donate_requested
            )
            snap = self.df.flags_snapshot()
            t2 = _time.perf_counter()
            rec = {
                "span": self.spans_submitted,
                "ticks": len(inputs_list),
                "host_gap_ms": round(gap_ms, 3),
                "window_sync_ms": round(window_sync_ms, 3),
                "upload_ms": round((t1 - t_up) * 1e3, 3),
                "dispatch_ms": round((t2 - t1) * 1e3, 3),
                "readback_wait_ms": None,
                "readbacks": None,
                "overflow": False,
                "donated": self.donate,
            }
            self.spans_submitted += 1
            prev, self._inflight = (
                self._inflight,
                (snap, rec, deltas, arrived),
            )
            if prev is not None:
                prev_deltas = self._complete(prev)
            # Spans dispatched past the committed boundary once submit
            # returns: the double buffer's bound is one.
            self.max_inflight = max(
                self.max_inflight,
                self.spans_submitted - self.spans_committed,
            )
        finally:
            self.in_dispatch = False
            self._last_host_free = _time.perf_counter()
        return prev_deltas

    def _stage(self, inputs_list: list) -> list:
        """The reference uploads every input batch here so the transfer
        overlaps the in-flight span. The port's inputs are built on the
        dataflow's device (``Dataflow._check_inputs`` refuses others),
        so staging passes through, as the reference's does on a backend
        without a transfer to hide."""
        return inputs_list

    def _complete(self, handle):
        """The span boundary: ONE flags readback (blocks until the span's
        work finished), then commit — or, on overflow, roll back and
        replay the whole window through check_flags."""
        snap, rec, deltas, arrived = handle
        r0 = self.df._readbacks
        t0 = _time.perf_counter()
        overflow = self.df.read_flags_snapshot(snap)
        rec["readback_wait_ms"] = round(
            (_time.perf_counter() - t0) * 1e3, 3
        )
        rec["readbacks"] = self.df._readbacks - r0
        if overflow:
            # The flagged span (and everything after it, including the
            # span still in flight) replays against grown tiers; the
            # replay commits synchronously, so the in-flight handle is
            # already absorbed.
            rec["overflow"] = True
            self.overflows += 1
            self.df.check_flags()
            absorbed, self._inflight = self._inflight, None
            if absorbed is not None:
                arec = absorbed[1]
                arec["readbacks"] = 0
                arec["readback_wait_ms"] = 0.0
                arec["absorbed_by_replay"] = True
                if self.trace is not None:
                    self.trace.append(arec)
                self.spans_committed += 1
            deltas = None
        if self.trace is not None:
            self.trace.append(rec)
        self.spans_committed += 1
        # Span-boundary freshness: lag since the committed span's inputs
        # were submitted (host bookkeeping only). The frontier is the
        # monotone committed-span counter.
        from ..coord.freshness import FRESHNESS, lag_ms

        FRESHNESS.record(
            self.freshness_label,
            self.freshness_replica,
            self.spans_committed,
            lag_ms(arrived),
        )
        from ..utils.trace import TRACER

        if TRACER.enabled("debug"):
            TRACER.record(
                "span_exec.commit",
                _time.time(),
                (rec["readback_wait_ms"] or 0.0) / 1e3,
                level="debug",
                span=rec["span"],
                ticks=rec["ticks"],
                upload_ms=rec["upload_ms"],
                dispatch_ms=rec["dispatch_ms"],
                host_gap_ms=rec["host_gap_ms"],
                donated=rec["donated"],
                overflow=rec["overflow"],
            )
        return deltas

    def sync(self):
        """Complete + commit the in-flight span — the read barrier every
        dataflow-state read sequences through, so a read admitted while
        a span is in flight observes a committed span boundary."""
        if self._inflight is None:
            return
        self.boundary_syncs += 1
        self.in_dispatch = True
        try:
            self._sync_locked()
        finally:
            self.in_dispatch = False
            self._last_host_free = _time.perf_counter()

    def _sync_locked(self):
        if self._inflight is None:
            return
        handle, self._inflight = self._inflight, None
        self._complete(handle)

    def close(self):
        """Drain the pipeline, validate the window, and detach."""
        self.sync()
        self.df.check_flags()
        if self.df._span_exec is self:
            self.df._span_exec = None

    # -- observability ------------------------------------------------------
    def stats(self) -> dict:
        committed = [
            r for r in (self.trace or []) if r["readbacks"] is not None
        ]
        readbacks = [
            r["readbacks"]
            for r in committed
            if not r.get("absorbed_by_replay")
        ]
        return {
            "spans_submitted": self.spans_submitted,
            "spans_committed": self.spans_committed,
            "overflows": self.overflows,
            "boundary_syncs": self.boundary_syncs,
            "donated": self.donate,
            "max_inflight": self.max_inflight,
            "readbacks_per_span": (
                float(np.mean(readbacks)) if readbacks else 0.0
            ),
        }
