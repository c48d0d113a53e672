"""The benchmark's cells cut to a size the CPU runs in seconds: the same
files, with the scale factor, the ticks and the index's tiers made
small. Only tests use it."""

import json

from ivmbench import loop, manifest

SF = 0.002

# Configurations kept beside the cells with no cell of their own in
# ``BENCHMARK.json`` (PERF.md says why), held to their reference all the
# same: the cell's name, its configuration's file and its traffic.
SPARE = {"q1-no-avg-disc-sf1.rf": ("ivmbench/configs/tpch-sf1-q1-no-avg-disc.json", "rf")}


def cell(name: str) -> loop.Cell:
    bench = manifest.load()
    if name in SPARE:
        path, traffic_name = SPARE[name]
        cfg = json.loads((manifest.ROOT / path).read_text())
    else:
        wl = manifest.workload(bench, name)
        cfg, traffic_name = manifest.config(bench, wl["config"]), wl["traffic"]
    cfg["scale_factor"] = SF
    if cfg["query"] == "index":
        cfg["dataflow"]["args"] = {"state_cap": 4096, "out_levels": 2}
    traffic = dict(manifest.traffic(traffic_name), generators=2, ring_slots=4, check_spans=1,
                   orders_per_tick=16 if cfg["query"] == "index" else 64, span_ticks=8)
    metrics = manifest.metrics_for(bench, name, False) + manifest.metrics_for(bench, name, True)
    return loop.Cell(name, cfg, traffic, metrics)


CELLS = ("index13-sf1.rf", *SPARE)
