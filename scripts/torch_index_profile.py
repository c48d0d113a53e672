#!/usr/bin/env python3
"""Where the time goes in a maintained TPC-H workload of the port, on a card.

    python3 scripts/torch_index_profile.py [index|q1|q15|q9] [--sf 1.0] [--ticks N] [--trace PATH]

Builds the workload's configuration of ``chip_smoke.py`` (``index``: the
reference bench's ``config_index`` layout, ``state_cap = 2^23``;
``q1``: TPC-H Q1 in the bench's ``config_q1`` layout; ``q15``: TPC-H Q15
in the bench's ``config_q15`` layout; ``q9``: TPC-H Q9 in the bench's
``config_q9`` layout, hydrated in ticks of 16,384 orders with its tiers
pre-sized and its join tier set back to a churn tick's after), hydrates
the TPC-H snapshot (growing tiers on overflow), warms one churn span,
then traces ``--ticks`` more churn ticks (default 16; 2 for ``q9``,
whose tick runs ~10^5 operations: its warm ticks make the traced ones
end on a fold tick) with ``torch.profiler`` (CPU + CUDA). Prints JSON
lines: the span's wall time, the device's busy time (union of kernel
intervals) and idle share, the kernel launches, and the device time by
kernel name (top 15, with the merge-path kernel's launches and share;
a span that shows no launch of it fails), and the host time spent in
each layer of the step path (``host_ms_by_layer``: the script wraps the
layer functions in profiler ranges for the traced span; ranges nest, so
a layer's time includes its parts'; Q15's join probes, their binary
search and range expansion, their gathers' concatenation, the join
spines' inserts (Q9: into a slot of the ring), the folds with the ring
flushes, and the MIN/MAX query are layers of their own). With
``--trace PATH`` the Chrome trace of the span is written to PATH.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (range name, module, attribute): the step path's layers, wrapped in
# profiler ranges for the traced span only.
LAYERS = (
    ("step", "materialize_tpu_torch.render.dataflow", "Dataflow._step_core"),
    ("fold", "materialize_tpu_torch.render.dataflow", "Dataflow._compact"),
    ("mfp", "materialize_tpu_torch.render.dataflow", "apply_mfp"),
    ("reduce", "materialize_tpu_torch.ops.reduce", "ReduceOp.step"),
    ("reduce.contributions", "materialize_tpu_torch.ops.reduce", "delta_contributions"),
    ("reduce.sum_by_key", "materialize_tpu_torch.ops.reduce", "sum_by_key"),
    ("reduce.lookup", "materialize_tpu_torch.ops.reduce", "gather_old_accums"),
    ("reduce.state_merge", "materialize_tpu_torch.ops.reduce", "merge_accum_state"),
    ("out.consolidate", "materialize_tpu_torch.render.dataflow", "consolidate"),
    ("out.insert", "materialize_tpu_torch.render.dataflow", "insert_tail"),
    ("err", "materialize_tpu_torch.render.dataflow", "Dataflow._apply_err_delta"),
    ("reduce.minmax_query", "materialize_tpu_torch.ops.reduce", "minmax_query"),
    ("reduce.minmax_insert", "materialize_tpu_torch.ops.reduce", "insert"),
    ("join", "materialize_tpu_torch.ops.delta_join", "DeltaJoinOp.step"),
    ("join.insert", "materialize_tpu_torch.ops.delta_join", "insert_tail"),
    ("join.probe", "materialize_tpu_torch.ops.delta_join", "DeltaJoinOp._probe"),
    ("join.probe.search", "materialize_tpu_torch.ops.delta_join", "lookup_range"),
    ("join.probe.expand", "materialize_tpu_torch.ops.delta_join", "expand_ranges"),
    ("join.probe.concat", "materialize_tpu_torch.ops.delta_join", "concat_batches"),
    ("fold.level", "materialize_tpu_torch.render.dataflow", "compact_level"),
    ("fold.slot_flush", "materialize_tpu_torch.arrangement.spine", "flush_slots"),
)


def _wrap_layers(torch) -> None:
    import functools
    import importlib

    for name, mod_name, attr in LAYERS:
        owner = importlib.import_module(mod_name)
        *path, leaf = attr.split(".")
        for part in path:
            owner = getattr(owner, part)
        fn = getattr(owner, leaf)

        def wrapped(*a, _fn=fn, _name=name, **k):
            with torch.profiler.record_function(_name):
                return _fn(*a, **k)

        setattr(owner, leaf, functools.wraps(fn)(wrapped))


def layer_host_ms(torch, events) -> dict:
    """Host ms inside each layer's range, summed over its calls."""
    names = {name for name, _, _ in LAYERS}
    out: dict = {}
    for e in events:
        if e.name in names and e.device_type == torch.autograd.DeviceType.CPU:
            out[e.name] = out.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from materialize_tpu_torch.storage.generator.tpch import TpchGenerator
    from materialize_tpu_torch.workloads.index import index_config, rows_per_tick
    from materialize_tpu_torch.workloads.tpch import (
        Q9_LAYOUT, apply_tiers, q1_config, q9_config, q9_tiers, q15_config, set_join_tiers)

    ap = argparse.ArgumentParser()
    ap.add_argument("workload", nargs="?", choices=("index", "q1", "q15", "q9"),
                    default="index")
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--ticks", type=int, default=None)
    ap.add_argument("--trace", default=None, help="write the Chrome trace here")
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()

    ticks = args.ticks or (2 if args.workload == "q9" else 16)
    if args.workload == "index":
        df, hydrate, churn = index_config(
            sf=args.sf, n_orders_per_tick=1024, state_cap=1 << 23, out_levels=4,
            ce=4, ratio=4, slots=True, seed=42, device="cuda",
        )
    elif args.workload == "q9":
        df, hydrate, churn = q9_config(sf=args.sf, n_orders_per_tick=1024, seed=42,
                                       device="cuda", hydrate_orders=16384)
        apply_tiers(df, q9_tiers(df, TpchGenerator(sf=args.sf, seed=42), 16384, 1024,
                                 2 * Q9_LAYOUT["ce"] + ticks))
    else:
        config = q1_config if args.workload == "q1" else q15_config
        df, hydrate, churn = config(sf=args.sf, n_orders_per_tick=1024, seed=42,
                                    device="cuda")
    ce = df._compact_every
    h = hydrate()
    n_h = len(h) - len(h) % ce
    for i in range(0, n_h, 32):
        df.run_span(h[i:min(i + 32, n_h)])
        df.check_flags()
    df.run_steps(h[n_h:])
    if args.workload == "q9":  # back to a churn tick's join tier
        set_join_tiers(df, rows_per_tick(1024))
    # Warm ticks, then the traced ones: a span of their own when they
    # fill fold periods; else one deferred run of steps that ends on a
    # fold tick (the warm ticks align it), so a fold's share is in the
    # trace. Either way one flags readback.
    if ticks % ce:
        n_warm = ce + (-(df._compact_tick + ticks)) % ce
        df.run_steps([churn(i, df.time + i)[0] for i in range(n_warm)], defer_check=True)
    else:
        n_warm = ticks
        df.run_span([churn(i, df.time + i)[0] for i in range(n_warm)])
    df.check_flags()
    traced = [churn(n_warm + i, df.time + i)[0] for i in range(ticks)]
    torch.cuda.synchronize()

    from torch.profiler import ProfilerActivity, profile

    _wrap_layers(torch)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        if ticks % ce:
            df.run_steps(traced, defer_check=True)
        else:
            df.run_span(traced)
        over = df.check_flags()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    # The layer ranges also appear on the device as annotations spanning
    # their kernels: they are not kernels.
    layer_names = {name for name, _, _ in LAYERS}
    kernels = [
        e for e in prof.events()
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
        and e.name not in layer_names
    ]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy_us, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy_us += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy_us += cur_e - cur_s
    by_name: dict = {}
    for e in kernels:
        d = by_name.setdefault(e.name, [0, 0.0])
        d[0] += 1
        d[1] += e.time_range.end - e.time_range.start
    total_us = sum(v[1] for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    merge_us = sum(v[1] for k, v in by_name.items() if "merge_path_kernel" in k)
    merge_launches = sum(v[0] for k, v in by_name.items() if "merge_path_kernel" in k)
    print(json.dumps({
        "phase": "profile", "workload": args.workload, "card": card, "sf": args.sf,
        "ticks": ticks,
        "overflowed": over, "span_wall_ms": wall_ms,
        "device_busy_ms": busy_us / 1e3, "device_idle_share": 1 - busy_us / 1e3 / wall_ms,
        "kernel_launches": len(kernels), "kernel_time_ms": total_us / 1e3,
        "merge_path_ms": merge_us / 1e3, "merge_path_launches": merge_launches,
        "merge_path_share_of_kernel_time": merge_us / total_us if total_us else 0.0,
    }))
    print(json.dumps({"host_ms_by_layer": layer_host_ms(torch, prof.events()),
                      "span_wall_ms": wall_ms}))
    for name, (cnt, us) in top:
        print(json.dumps({"kernel": name[:120], "launches": cnt, "ms": us / 1e3,
                          "share": us / total_us}))
    if not merge_launches:
        print("no merge_path_kernel launch in the traced span", file=sys.stderr)
        return 1
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
