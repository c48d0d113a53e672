"""The traced run's breakdown: where the device's time went, and what the
host was doing while the device sat idle."""

from __future__ import annotations

from . import stats

TOP = 10


def host_spans(run) -> list:
    """The harness's spans of the window, (name, start, end): waits on
    the generator, ingest calls, and each submit call split by the
    executor's own record into its window sync, upload, dispatch, the
    previous span's flags readback (at the call's end) and the commit's
    bookkeeping between them."""
    out = list(run.host_spans)
    prev = None
    for sp in run.spans:
        s0, s1 = sp.submit
        at = s0
        if sp.rec is not None:
            for key, name in (("window_sync_ms", "submit.window_sync"),
                              ("upload_ms", "submit.upload"),
                              ("dispatch_ms", "submit.dispatch")):
                end = min(at + sp.rec[key] / 1e3, s1)
                out.append((name, at, end))
                at = end
        rb = prev.rec.get("readback_wait_ms") if prev is not None and prev.rec else None
        rb_start = max(at, s1 - (rb or 0.0) / 1e3)
        if rb_start > at:
            out.append(("submit.commit", at, rb_start))
        if rb:
            out.append(("submit.readback_wait", rb_start, s1))
        prev = sp
    return out


def busy(run) -> list:
    return [(s, min(e, run.window_s)) for _, s, e in run.device_events]


def breakdown(run) -> dict:
    """The device operations that took most time, by name, and the idle
    time by the host span it fell in; each list at most ``TOP`` long."""
    by_name: dict = {}
    for name, s, e in run.device_events:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    idle = stats.attribute(stats.gaps(busy(run), 0.0, run.window_s), host_spans(run))
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": [[n, v] for n, v in gaps]}


def busy_s(run) -> float:
    return stats.union_length(busy(run))


def span_seconds(run) -> list:
    """The median, 90th percentile and longest time between the returns
    of consecutive submit calls in the window."""
    ends = [sp.submit[1] for sp in run.spans]
    steps = [b - a for a, b in zip(ends, ends[1:])]
    if not steps:
        return []
    return [stats.percentile(steps, 50), stats.percentile(steps, 90), max(steps)]


def host_summary(run) -> dict:
    """The window's host-side sums, for standard error: ingest and the
    executor's dispatch per tick, its readback wait per span (ms), the
    wait on the generator (s)."""
    recs = [sp.rec for sp in run.spans if sp.rec is not None]
    ticks = sum(sp.ticks for sp in run.spans if sp.rec is not None) or 1
    waits = [r["readback_wait_ms"] for r in recs if r.get("readback_wait_ms") is not None]
    return {
        "ingest_ms_tick": run.ingest_s * 1e3 / max(run.ticks, 1),
        "dispatch_ms_tick": sum(r["dispatch_ms"] for r in recs) / ticks,
        "readback_ms_span": sum(waits) / len(waits) if waits else None,
        "gen_wait_s": run.gen_wait_s,
    }
