"""One run of one cell: set-up, the measured window, the read, the check.

The entry the window drives is the replica's compute plane: each tick's
rows go through ``storage/persist/operators.updates_to_batch`` (the
function a replica calls on fetched updates) into the ingest tier the
dataflow's builder sized, spans of ticks through
``render/span_exec.SpanExecutor.submit``, and at the end ``close`` and
the configuration's read (``ivmbench/reads/<read>.py``) with
``Dataflow.peek_errors``. Rows are handed in the order the source
(``ivmbench/gen/<stream>.py``) makes them, unsorted and with no hint.
The traffic's kind of loop (``ivmbench/loops/<loop>.py``) decides when
each span is handed.

The program is imported only inside :func:`run_cell`. The generator
processes start once its builder has said how large a snapshot batch
is, and run beside its set-up.
"""

from __future__ import annotations

import gc
import importlib
import multiprocessing as mp
import time
from dataclasses import dataclass, field

import numpy as np

from . import check, manifest
from .gen import feed as feed_mod


@dataclass
class Span:
    """One span of the window: its ticks and source rows, when its first
    rows were handed to ingest, when its ticks were ready (the loop kind
    says), the submit call that dispatched it, the time the call that
    committed it returned, and the executor's record."""

    first_tick: int
    ticks: int
    rows: int = 0
    handed: float = 0.0
    ready: float = 0.0
    submit: tuple = (0.0, 0.0)
    committed_at: float | None = None
    rec: dict | None = None


@dataclass
class Run:
    """What a run recorded, in seconds from the window's start; the metric
    readers read it."""

    setup_s: float = 0.0
    window_s: float = 0.0
    spans: list = field(default_factory=list)
    ingest_s: float = 0.0  # summed over the window's ingest calls
    gen_wait_s: float = 0.0  # the window's time waiting on the generator
    host_spans: list = field(default_factory=list)  # (name, start, end)
    device_events: list | None = None  # (name, start, end) in the window
    extra: dict = field(default_factory=dict)  # what a metric's probe collected
    phases: dict = field(default_factory=dict)  # set-up's and the read's parts, seconds
    host: dict = field(default_factory=dict)  # the window's CPU and GC seconds, overflows

    @property
    def ticks(self) -> int:
        return sum(s.ticks for s in self.spans)

    def committed(self) -> list:
        return [s for s in self.spans if s.committed_at is not None]


def _cpu_seconds() -> float:
    """This process's CPU seconds, user and system."""
    import resource

    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


def calibrate_ms() -> float:
    """Milliseconds of a fixed piece of pure-Python work, the best of
    three: how fast this host runs the harness's kind of code now."""
    best = float("inf")
    for _ in range(3):
        t = time.perf_counter()
        x = 0
        for i in range(200_000):
            x += i & 7
        best = min(best, time.perf_counter() - t)
    return best * 1e3


class _GcClock:
    """Seconds the cyclic garbage collector ran while installed."""

    def __init__(self):
        self.s, self._t = 0.0, None

    def __call__(self, phase, _info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.s += time.perf_counter() - self._t
            self._t = None


def _load(path: str):
    mod, _, name = path.partition(":")
    return getattr(importlib.import_module(mod), name)


class Cell:
    """A cell resolved from its files: the configuration, the traffic
    mix, the metrics the run reports, and the pieces they name: the
    source, the query's reference, the read and the kind of loop."""

    def __init__(self, name: str, config: dict, traffic: dict, metrics: list):
        self.name = name
        self.config = config
        self.traffic = traffic
        self.metrics = metrics
        self.source = manifest.piece("gen", config["stream"])
        self.reference = manifest.piece("reference", config["query"])
        self.reader = manifest.piece("reads", config["read"])
        self.loop = manifest.piece("loops", traffic["loop"])

    @classmethod
    def named(cls, workload: str, trace: bool, root=manifest.ROOT) -> "Cell":
        bench = manifest.load(root)
        wl = manifest.workload(bench, workload)
        return cls(workload, manifest.config(bench, wl["config"], root),
                   manifest.traffic(wl["traffic"], root),
                   manifest.metrics_for(bench, workload, trace))


def start_feed(cell: Cell, seed: int, batch_orders: int) -> feed_mod.Feed:
    """Start the generator processes (numpy only), their slots sized for
    the larger of a tick and a snapshot batch of ``batch_orders``."""
    t = cell.traffic
    plan = dict(source=cell.config["stream"], sf=cell.config["scale_factor"], seed=seed,
                orders_per_tick=t["orders_per_tick"], slots=t["ring_slots"],
                slot_rows=cell.source.max_rows(t["orders_per_tick"], batch_orders))
    return feed_mod.Feed(mp.get_context("spawn"), plan, t["generators"])


@dataclass
class Outputs:
    """What the timed path produced, on the host: the read's rows and
    times, the err collection, and the sampled spans' deltas as
    (first tick, [(rows with the time last, diffs) a tick])."""

    rows: list
    times: np.ndarray
    errors: list
    deltas: list


@dataclass
class Handed:
    """What the harness handed the program, for the reference to make
    again: the seed, the program's codes of the source's strings, the
    snapshot's batches and the churn ticks (warm span first)."""

    seed: int
    codes: list
    n_snap: int
    ticks: int
    span_ticks: int


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, t0: float,
             device: str = "cuda"):
    """One run of ``cell``: returns (run record, outputs, what was handed,
    peak device bytes). ``t0`` is the process's start on the
    ``perf_counter`` clock; set-up is measured from it."""
    import torch

    calib = calibrate_ms()
    cfg, per_tick = cell.config, cell.traffic["orders_per_tick"]
    df, h_orders, tier = _load(cfg["dataflow"]["builder"])(
        n_orders_per_tick=per_tick, device=device, **cfg["dataflow"].get("args", {}))
    batch_orders = max(h_orders, per_tick)
    built = time.perf_counter()
    feed = start_feed(cell, seed, batch_orders)
    try:
        run, *rest = _run(torch, cell, feed, df, tier, batch_orders, seed, seconds, trace,
                          t0, built, device)
    finally:
        feed.close()
    run.host["calib_ms"] = [calib, calibrate_ms()]
    return (run, *rest)


class Window:
    """What a kind of loop drives in the window: ``ingest_span()`` takes
    the next span's ticks from the source through the program's ingest,
    ``submit()`` hands it to the span executor, and records what the
    metrics read. Times are seconds from the window's start."""

    def __init__(self, run: Run, feed, ex, to_batches, span_ticks: int, first_tick: int,
                 seconds: float, keep: int, rng):
        self.run, self.feed, self.ex, self.to_batches = run, feed, ex, to_batches
        self.span_ticks, self.tick, self.seconds = span_ticks, first_tick, seconds
        self.keep, self.rng = keep, rng
        self.sampled: list = []  # a reservoir of (window span, its deltas), drawn from the seed
        self.eligible = 0
        self.t_start = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self.t_start

    def ingest_span(self):
        """(the span, its step inputs): its ticks' rows, each through the
        program's ingest as the generator hands them."""
        run, t0 = self.run, self.t_start
        sp = Span(first_tick=self.tick, ticks=self.span_ticks)
        inputs = []
        for k in range(self.span_ticks):
            a = time.perf_counter()
            item, made = self.feed.next()
            b = time.perf_counter()
            if k == 0:
                sp.handed = b - t0
            batches = self.to_batches(made)
            c = time.perf_counter()
            self.feed.release(item)
            run.host_spans.append(("gen_wait", a - t0, b - t0))
            run.host_spans.append(("ingest", b - t0, c - t0))
            run.ingest_s += c - b
            run.gen_wait_s += b - a
            sp.rows += sum(len(diffs) for _, diffs in made.values())
            inputs.append(batches)
        self.tick += self.span_ticks
        return sp, inputs

    def submit(self, sp: Span, inputs: list) -> None:
        """Hand the span to the executor; the call's return commits the
        span before it, whose deltas the check may sample."""
        run, t0 = self.run, self.t_start
        s0 = time.perf_counter()
        prev = self.ex.submit(inputs)
        s1 = time.perf_counter()
        sp.submit = (s0 - t0, s1 - t0)
        if run.spans:
            run.spans[-1].committed_at = s1 - t0
            if prev is not None:
                pair = (len(run.spans) - 1, prev)
                if len(self.sampled) < self.keep:
                    self.sampled.append(pair)
                else:
                    r = int(self.rng.integers(0, self.eligible + 1))
                    if r < self.keep:
                        self.sampled[r] = pair
                self.eligible += 1
        run.spans.append(sp)


def _device_events(torch, prof, real0_ns: int, window_s: float) -> list:
    """The trace's device operations (kernels, copies, fills) that start
    in the window, as (name, start, end) seconds from its start."""
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda or e.is_user_annotation():
            continue
        s = (e.start_ns() - real0_ns) / 1e9
        if 0.0 <= s < window_s:
            out.append((e.name(), s, s + e.duration_ns() / 1e9))
    out.sort(key=lambda x: x[1])
    return out


def _run(torch, cell, feed, df, tier, batch_orders, seed, seconds, trace, t0, built,
         device):
    from materialize_tpu_torch.render.span_exec import SpanExecutor
    from materialize_tpu_torch.repr.schema import GLOBAL_DICT
    from materialize_tpu_torch.storage.persist import operators

    cfg, traffic, src = cell.config, cell.traffic, cell.source
    span_ticks = traffic["span_ticks"]
    on_card = device != "cpu"
    schemas = {name: _load(path) for name, path in src.SCHEMAS.items()}
    codes = [int(c) for c in GLOBAL_DICT.encode_many(list(src.STRINGS))]
    feed.start(codes, batch_orders)
    n_snap = src.stream(cfg["scale_factor"], seed, codes).snapshot_batches(batch_orders)
    step = 0  # the next step's logical time: the dataflow steps once a batch

    def to_batches(made):
        nonlocal step
        out = {name: operators.updates_to_batch(
                   schemas[name], cols, [None] * schemas[name].arity, None, diffs,
                   as_of=step, capacity=tier, device=device)
               for name, (cols, diffs) in made.items()}
        step += 1
        return out

    def ingest():
        item, made = feed.next()
        out = to_batches(made)
        feed.release(item)
        return out

    ex = SpanExecutor(df)
    run = Run()
    # -- set-up: the snapshot, insert-only, then one warm span of churn ------
    t_h = time.perf_counter()
    full = n_snap - n_snap % span_ticks
    for _ in range(0, full, span_ticks):
        ex.submit([ingest() for _ in range(span_ticks)])
    if n_snap > full:
        ex.sync()
        df.run_steps([ingest() for _ in range(n_snap - full)])
    ex.sync()
    t_w = time.perf_counter()
    ex.submit([ingest() for _ in range(span_ticks)])
    ex.sync()
    run.phases.update(build_s=built - t0, hydrate_s=t_w - t_h,
                      warm_s=time.perf_counter() - t_w)
    base_span = ex.spans_submitted
    probes = [p for p in (manifest.probe(m["name"]) for m in cell.metrics) if p] \
        if trace else []
    prof = None
    if trace and on_card:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
    if on_card:
        torch.cuda.synchronize()
    # -- the window -------------------------------------------------------------
    gc_clock = _GcClock()
    gc.callbacks.append(gc_clock)
    cpu0 = _cpu_seconds()
    w = Window(run, feed, ex, to_batches, span_ticks, span_ticks, seconds,
               traffic["check_spans"], np.random.default_rng([seed, 0x1B]))
    real0 = time.time_ns()
    run.setup_s = w.t_start - t0
    for p in probes:
        p.install()
    cell.loop.window(w)
    run.window_s = w.elapsed()
    for p in probes:
        p.uninstall()
    run.host.update(cpu_s=_cpu_seconds() - cpu0, gc_s=gc_clock.s, overflows=ex.overflows)
    gc.callbacks.remove(gc_clock)
    # -- after the window: drain, read, free ----------------------------------
    t_r = time.perf_counter()
    ex.close()
    if on_card:
        torch.cuda.synchronize()
    if prof is not None:
        prof.stop()
    recs = {r["span"]: r for r in ex.trace}
    for i, sp in enumerate(run.spans):
        sp.rec = recs.get(base_span + i)
    memory_peak = int(torch.cuda.max_memory_allocated()) if on_card else 0
    rows, times = cell.reader.read(df)
    errors = df.peek_errors()
    deltas = []
    for idx, batches in sorted(w.sampled, key=lambda x: x[0]):
        got = []
        for b in batches:
            c = b.to_columns()
            got.append((check.matrix(c[:-1]), c[-1]))
        deltas.append((run.spans[idx].first_tick, got))
    del df, ex, w
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    if prof is not None:
        run.device_events = _device_events(torch, prof, real0, run.window_s)
        del prof
        gc.collect()
    for p in probes:
        p.collect(torch, run)
    run.phases["read_s"] = time.perf_counter() - t_r
    handed = Handed(seed, codes, n_snap, span_ticks + run.ticks, span_ticks)
    return run, Outputs(rows, times, errors, deltas), handed, memory_peak


# -- the check -------------------------------------------------------------------

CHECKS = ("rows_off", "future_rows", "err_rows", "delta_rows_off", "spans_unchecked")
LIMITS = dict.fromkeys(CHECKS, 0)
# Between two points where the reference needs a query's state, carry it
# tick by tick when they are at most this many ticks apart, else work it
# out again from the whole table.
CARRY_TICKS = 32


def judge(cell: Cell, out: Outputs, handed: Handed, control: str | None = None,
          device="cpu") -> dict:
    """The numbers compared, each {value, limit}. The reference makes the
    handed rows again from the seed and works the view out itself; the
    multisets are compared on ``device``.

    With ``control`` the reference's own outputs take the program's
    place with one stated guarantee broken: ``duplicate_tick`` applies a
    tick drawn from the seed twice (exactly-once broken);
    ``stale_read`` reads before the last span (a read after the last
    commit must see it)."""
    ref = cell.reference
    per_tick, span = cell.traffic["orders_per_tick"], handed.span_ticks
    stream = cell.source.stream(cell.config["scale_factor"], handed.seed, handed.codes)
    by_first = dict(out.deltas)
    last_first = handed.ticks - span
    spans = set(by_first) | ({last_first} if control == "stale_read" else set())
    needs = sorted(spans | {handed.ticks})
    dup = int(np.random.default_rng([handed.seed, 0xD0]).integers(0, handed.ticks)) \
        if control == "duplicate_tick" else None
    state, state_at, dup_rows = None, None, None

    def step(t: int, want: bool):
        """Move the stream past tick ``t``; with ``want`` (or at the
        duplicated tick) make its rows, and with ``want`` its delta,
        carrying the state."""
        nonlocal state, state_at, dup_rows
        if not (want or t == dup):
            stream.advance(per_tick, t)
            return None
        item = stream.tick(per_tick, t)
        as_of = handed.n_snap + t
        if t == dup:
            dup_rows = (item, as_of)
        if not want:
            return None
        (mat, d), state = ref.delta(state, item, as_of)
        state_at = t + 1
        return mat, d

    delta_off, stale = 0, []
    t = 0
    while t < handed.ticks:
        if t in spans:
            if state_at != t:
                state, state_at = ref.state(stream), t
            tally = check.Tally(device)
            for k in range(span):
                mat, d = step(t + k, True)
                if t in by_first:
                    tally.add(*((mat, d) if control else by_first[t][k]), 1)
                    tally.add(mat, d, -1)
                if control == "stale_read" and t == last_first:
                    stale.append((mat[:, :-1], -d))
            delta_off += tally.rows_off()
            t += span
            continue
        nxt = next(p for p in needs if p > t)
        step(t, state_at == t and ref.NEEDS_STATE and nxt - t <= CARRY_TICKS)
        t += 1
    if state_at != handed.ticks:
        state = ref.state(stream)
    want_rows = list(ref.rows(stream, state))
    if control is None:
        got_rows, errors = out.rows, out.errors
        last_step = handed.n_snap + handed.ticks - 1
        future = sum(int(np.abs(d[np.asarray(out.times).astype(np.uint64) > last_step]).sum())
                     for _, d in out.rows)
    else:
        got_rows, errors, future = list(want_rows) + stale, [], 0
        if dup is not None:
            (mat, d), _ = ref.delta(state, *dup_rows)
            got_rows.append((mat[:, :-1], d))
    values = {
        "rows_off": check.rows_off(got_rows, want_rows, device),
        "future_rows": future,
        "err_rows": int(sum(abs(n) for _, n in errors)),
        "delta_rows_off": delta_off,
        "spans_unchecked": cell.traffic["check_spans"] - len(out.deltas),
    }
    return {k: {"value": values[k], "limit": LIMITS[k]} for k in CHECKS}


def correct(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
