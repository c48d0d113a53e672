"""The benchmark's arithmetic over a run's records: rates, percentiles and
interval unions. Plain Python and numpy; every metric reader uses these,
so each quantity has one definition."""

from __future__ import annotations

import numpy as np


def rate(count: float, seconds: float) -> float:
    """Work per second over the whole window."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return count / seconds


def percentile(values, q: float) -> float:
    """The ``q``-th percentile of every value, by linear interpolation
    between the closest ranks (numpy's default)."""
    if len(values) == 0:
        raise ValueError("a percentile of no values")
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def merged(intervals) -> list:
    """Sorted, disjoint intervals covering the same points as ``intervals``
    ((start, end) pairs)."""
    out: list = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def union_length(intervals) -> float:
    """How long at least one interval covers."""
    return sum(e - s for s, e in merged(intervals))


def gaps(intervals, lo: float, hi: float) -> list:
    """The parts of [lo, hi] no interval covers, in order."""
    out, at = [], lo
    for s, e in merged(intervals):
        if e <= lo or s >= hi:
            continue
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
    if at < hi:
        out.append((at, hi))
    return out


def idle_share(busy_intervals, lo: float, hi: float) -> float:
    """1 - the covered share of [lo, hi]."""
    clipped = [(max(s, lo), min(e, hi)) for s, e in busy_intervals]
    return 1.0 - union_length(clipped) / (hi - lo)


def attribute(gap_list, spans) -> dict:
    """Seconds of each gap spent inside each named host span ((name,
    start, end) triples); what no span covers goes to ``harness``."""
    spans = sorted(spans, key=lambda s: s[1])
    starts = np.asarray([s[1] for s in spans], dtype=np.float64)
    out: dict = {}
    for gs, ge in gap_list:
        covered = 0.0
        i = max(int(np.searchsorted(starts, gs, side="right")) - 1, 0)
        while i < len(spans) and spans[i][1] < ge:
            name, s, e = spans[i]
            part = min(e, ge) - max(s, gs)
            if part > 0:
                out[name] = out.get(name, 0.0) + part
                covered += part
            i += 1
        if ge - gs - covered > 0:
            out["harness"] = out.get("harness", 0.0) + (ge - gs - covered)
    return out
