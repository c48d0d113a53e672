"""Metrics: Prometheus-style registry.

Analog of the reference's ``ore::metrics::MetricsRegistry`` (every
process registers counters/gauges/histograms and serves them in the
Prometheus text exposition format; SURVEY.md §5 metrics/observability).
No external client library — the text format is trivial and this keeps
the zero-dependency rule.

Deployment-wide scraping: replica processes piggyback their
sample snapshots on Frontiers responses; the controller keeps the
latest per replica, and :func:`cluster_exposition` merges them with
the local registry into ONE conformant exposition — every remote
sample gains a ``replica`` label, families repeated across processes
share a single ``# TYPE`` header, and one scrape of the coordinator's
``/metrics`` covers the cluster.
"""

from __future__ import annotations

import threading
from bisect import bisect_right


class _Metric:
    def __init__(self, name: str, help_: str, registry: "MetricsRegistry"):
        from .locks import tracked_lock

        self.name = name
        self.help = help_
        self._lock = tracked_lock("metrics.metric")
        if registry is not None:
            registry._register(self)


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name, help_="", registry=None):
        super().__init__(name, help_, registry)
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value

    def samples(self):
        with self._lock:
            return [(self.name, {}, self._value)]


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name, help_="", registry=None):
        super().__init__(name, help_, registry)
        self._value = 0.0

    def set(self, v: float) -> None:
        self._value = float(v)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        return self._value

    def samples(self):
        with self._lock:
            return [(self.name, {}, self._value)]


class Histogram(_Metric):
    kind = "histogram"

    DEFAULT_BUCKETS = (
        0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5, 10,
    )

    def __init__(self, name, help_="", buckets=None, registry=None):
        super().__init__(name, help_, registry)
        self.buckets = tuple(buckets or self.DEFAULT_BUCKETS)
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._total = 0

    def observe(self, v: float) -> None:
        with self._lock:
            self._counts[bisect_right(self.buckets, v)] += 1
            self._sum += v
            self._total += 1

    def quantile(self, q: float) -> float:
        """Approximate quantile from bucket counts: the upper bound of
        the bucket containing the q-th observation. Edge contract:
        empty histogram -> 0.0; q <= 0 -> the
        first NONEMPTY bucket's bound (never an empty leading bucket);
        q >= 1 -> the last nonempty bucket's bound (+Inf only when
        observations actually landed past the last finite bucket)."""
        with self._lock:
            if self._total == 0:
                return 0.0
            q = min(max(q, 0.0), 1.0)
            if q <= 0.0:
                for i, c in enumerate(self._counts[:-1]):
                    if c > 0:
                        return self.buckets[i]
                return float("inf")  # everything in the overflow bucket
            target = q * self._total
            acc = 0
            for i, c in enumerate(self._counts[:-1]):
                acc += c
                # `c > 0` skips empty leading buckets a tiny target
                # (q*total < 1) would otherwise select.
                if c > 0 and acc >= target:
                    return self.buckets[i]
            return float("inf")

    def samples(self):
        with self._lock:  # consistent with observe(): no torn scrapes
            counts = list(self._counts)
            total, sum_ = self._total, self._sum
        out = []
        acc = 0
        for b, c in zip(self.buckets, counts):
            acc += c
            out.append((self.name + "_bucket", {"le": str(b)}, acc))
        out.append(
            (self.name + "_bucket", {"le": "+Inf"}, acc + counts[-1])
        )
        out.append((self.name + "_sum", {}, sum_))
        out.append((self.name + "_count", {}, total))
        return out


def _escape_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(s: str) -> str:
    return (
        s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def _fmt_value(v) -> str:
    """Prometheus sample value: integers render without a trailing
    `.0` (cumulative bucket counts MUST parse as integers)."""
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def sample_line(name: str, labels: dict, value) -> str:
    if labels:
        lbl = ",".join(
            f'{k}="{_escape_label(str(v))}"'
            for k, v in sorted(labels.items())
        )
        return f"{name}{{{lbl}}} {_fmt_value(value)}"
    return f"{name} {_fmt_value(value)}"


def exposition(families: list) -> str:
    """Render [(name, kind, help, [(sample_name, labels, value)...])]
    to the text exposition format. Families sharing a name (the same
    metric observed in several processes) merge under ONE header."""
    lines = []
    seen_headers = set()
    for name, kind, help_, samples in families:
        if name not in seen_headers:
            seen_headers.add(name)
            if help_:
                lines.append(f"# HELP {name} {_escape_help(help_)}")
            lines.append(f"# TYPE {name} {kind}")
        for sname, labels, value in samples:
            lines.append(sample_line(sname, labels, value))
    return "\n".join(lines) + "\n"


class MetricsRegistry:
    """Register-and-scrape: the per-process metrics authority."""

    def __init__(self):
        from .locks import tracked_lock

        self._metrics: dict[str, _Metric] = {}
        self._lock = tracked_lock("metrics.registry")

    def _register(self, m: _Metric) -> None:
        with self._lock:
            if m.name in self._metrics:
                raise ValueError(f"metric {m.name!r} already registered")
            self._metrics[m.name] = m

    def get_or_create(self, kind: str, name: str, help_: str = "",
                      **kwargs) -> _Metric:
        """Idempotent registration: return the existing metric or
        create it, tolerating a first-registration race (shared
        metrics registered lazily from several threads — the compile
        ledger, the coordinator's statement counter)."""
        m = self.get(name)
        if m is not None:
            return m
        try:
            return getattr(self, kind)(name, help_, **kwargs)
        except ValueError:
            return self.get(name)

    def counter(self, name, help_="") -> Counter:
        return Counter(name, help_, registry=self)

    def gauge(self, name, help_="") -> Gauge:
        return Gauge(name, help_, registry=self)

    def histogram(self, name, help_="", buckets=None) -> Histogram:
        return Histogram(name, help_, buckets=buckets, registry=self)

    def get(self, name: str) -> _Metric | None:
        return self._metrics.get(name)

    def families(self, extra_labels: dict | None = None) -> list:
        """[(name, kind, help, samples)] — the mergeable form replicas
        piggyback on Frontiers (``extra_labels`` stamped on every
        sample, e.g. {"replica": "r0"})."""
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        out = []
        for m in metrics:
            samples = m.samples()
            if extra_labels:
                samples = [
                    (sn, {**lb, **extra_labels}, v)
                    for sn, lb, v in samples
                ]
            out.append((m.name, m.kind, m.help, samples))
        return out

    def expose_text(self) -> str:
        """Prometheus text exposition format (this process only)."""
        return exposition(self.families())


def cluster_exposition(registry: "MetricsRegistry",
                       remote: dict | None) -> str:
    """One exposition covering the deployment: the local registry's
    families plus every replica's last piggybacked snapshot, remote
    samples labeled ``replica="<name>"``. Families are merged by name
    so a metric observed in N processes exposes one TYPE header and
    N+... labeled series."""
    merged: dict[str, tuple] = {}
    order: list[str] = []

    def absorb(families, extra_labels=None):
        for name, kind, help_, samples in families:
            if extra_labels:
                samples = [
                    (sn, {**lb, **extra_labels}, v)
                    for sn, lb, v in samples
                ]
            if name in merged:
                k0, h0, s0 = merged[name]
                merged[name] = (k0, h0 or help_, s0 + list(samples))
            else:
                merged[name] = (kind, help_, list(samples))
                order.append(name)

    absorb(registry.families())
    for rep_name in sorted(remote or ()):
        absorb(remote[rep_name], {"replica": rep_name})
    return exposition(
        [(n,) + merged[n][:2] + (merged[n][2],) for n in order]
    )


# Per-process default registry (ore::metrics global analog).
REGISTRY = MetricsRegistry()
