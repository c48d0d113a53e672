"""The benchmark's arithmetic: rates over the window, a percentile over
every tick, the idle share and idle attribution from intervals, the
merge byte count and the metric readers over a made-up run."""

import pytest

from ivmbench import manifest, peaks, report, stats
from ivmbench.loop import Run, Span


def test_rate_and_percentile():
    assert stats.rate(300, 1.5) == 200.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)
    assert stats.percentile(list(range(101)), 95) == 95.0
    assert stats.percentile([1.0, 2.0], 50) == 1.5
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_intervals():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (5.0, 4.0)]
    assert stats.merged(iv) == [(0.0, 2.0), (3.0, 4.0)]
    assert stats.union_length(iv) == 3.0
    assert stats.gaps(iv, -1.0, 6.0) == [(-1.0, 0.0), (2.0, 3.0), (4.0, 6.0)]
    assert stats.idle_share(iv, 0.0, 4.0) == pytest.approx(0.25)
    # a busy interval past the window counts only inside it
    assert stats.idle_share([(0.0, 10.0)], 0.0, 4.0) == 0.0
    spans = [("ingest", 2.0, 2.5), ("submit.dispatch", 2.5, 3.5)]
    got = stats.attribute([(2.0, 3.0), (4.0, 6.0)], spans)
    assert got == pytest.approx({"ingest": 0.5, "submit.dispatch": 0.5, "harness": 2.0})


def test_merge_bytes_count_valid_rows_only():
    # 3 + 4 valid rows of 5 lanes into 16 slots: 7 rows read, 7 written
    # with their source index; the capacities do not count.
    assert peaks.merge_bytes(3, 4, 16, 5) == 7 * 5 * 8 + 7 * (5 * 8 + 8)
    # an overflowing merge consumes only what fits
    assert peaks.merge_bytes(10, 10, 16, 1) == 16 * 8 + 16 * 16
    assert peaks.least_seconds(peaks.HBM_BYTES_PER_S) == 1.0


def _run():
    run = Run(setup_s=12.5, window_s=2.0)
    for i in range(4):
        sp = Span(first_tick=16 * i, ticks=16, rows=1000, ready=0.5 * i,
                  submit=(0.5 * i + 0.3, 0.5 * i + 0.5),
                  rec={"window_sync_ms": 0.0, "upload_ms": 0.0, "dispatch_ms": 100.0,
                       "readback_wait_ms": 50.0})
        sp.committed_at = 0.5 * (i + 1) + 0.5 if i < 3 else None
        run.spans.append(sp)
    run.spans[-1].rec["readback_wait_ms"] = None
    run.ingest_s = 0.64
    run.host_spans = [("gen_wait", 0.0, 0.1), ("ingest", 0.1, 0.3)]
    run.device_events = [("k", 0.0, 0.5), ("merge_path_kernel<4>", 0.5, 1.0), ("k", 1.5, 3.0)]
    run.extra = {"merges": [(100, 100, 256, 4)], "merge_kernel_s": [0.5]}
    return run


def _read(name, run):
    return manifest.reader(name)(run)


def test_readers():
    run = _run()
    assert _read("updates_per_s", run) == 3000 / 2.0
    # span i ready at 0.5 i, committed at 0.5 (i + 1) + 0.5: 1.0 s each;
    # the last, never committed, waits 2.0 - 1.5 s up to the window's end
    waits = [1000.0] * 48 + [500.0] * 16
    assert _read("freshness_ms_p95", run) == stats.percentile(waits, 95)
    assert _read("setup_s", run) == 12.5
    assert _read("ingest_ms_per_tick.tput", run) == 10.0
    assert _read("dispatch_ms_per_tick.tput", run) == 100.0 / 16
    assert _read("readback_wait_ms_per_span.fresh", run) == 50.0
    assert _read("device_ops_per_tick.tput", run) == 3 / 64
    assert _read("device_idle_share.tput", run) == pytest.approx(0.25)
    want = 100 * peaks.least_seconds(peaks.merge_bytes(100, 100, 256, 4)) / 0.5
    assert _read("merge_path_roofline.tput", run) == pytest.approx(want)


def test_readers_find_nothing_without_a_trace():
    run = _run()
    run.device_events, run.extra = None, {}
    for name in ("device_ops_per_tick.tput", "device_idle_share.tput",
                 "merge_path_roofline.tput"):
        assert _read(name, run) is None


def test_merge_probe_collects_each_launch():
    import torch

    probe = manifest.probe("merge_path_roofline.tput")
    assert probe is not None and manifest.probe("updates_per_s") is None
    run = _run()
    run.extra = {}
    probe.launches[:] = [(torch.tensor([100]), torch.tensor(100), 256, torch.zeros(1, 4).shape[1])]
    probe.collect(torch, run)
    assert run.extra == {"merges": [(100, 100, 256, 4)], "merge_kernel_s": [0.5]}
    assert _read("merge_path_roofline.tput", run) == pytest.approx(
        100 * peaks.least_seconds(peaks.merge_bytes(100, 100, 256, 4)) / 0.5)
    # a trace that misses a launch gives no share
    probe.launches[:] = [(torch.tensor(1), torch.tensor(1), 4, 4)] * 2
    probe.collect(torch, run)
    assert _read("merge_path_roofline.tput", run) is None


def test_breakdown():
    run = _run()
    b = report.breakdown(run)
    assert b["device_ops"][0] == ["k", 2.0]
    idle = dict(b["idle_gaps"])
    # idle 1.0-1.5 (spans 1 and 2 submit there: dispatch, then readback)
    # and none past the window: the last kernel is cut at 2.0
    assert sum(idle.values()) == pytest.approx(0.5)
    assert report.busy_s(run) == pytest.approx(1.5)
