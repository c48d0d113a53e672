#!/usr/bin/env python3
"""The auction phases of ``chip_smoke.py`` before and after its Q9
phases, in one process on a card.

    python3 scripts/torch_phase_order.py [--without-q9]

Runs ``chip_smoke.py``'s kernel build, then ``auction`` and
``auction_x16`` on a fresh process; then the Q9 phases as the smoke
runs them (``q9`` at SF 1, ``q9_kernel_shape``, ``q9_vs_plain_path``);
then ``auction`` and ``auction_x16`` again, right after Q9 as in the
smoke; then ``gc.collect()`` and ``torch.cuda.empty_cache()``, and the
two once more. With ``--without-q9`` it runs the pair twice and
nothing else: run so in a new process before and after another
workload on the same machine, it tells state left in a process from
state left in the machine, and its second pair shows what one pair
(its profiled ticks included) leaves behind. Each phase prints its own JSON line (``tick_ms_p50`` and the
rest). Before each auction pair one line gives the process's state
(the Python objects the collector tracks, the collections each
generation has run, the caching allocator's reserved and allocated
bytes, segments and allocation retries) and the machine's (the mean
``cpu MHz`` of ``/proc/cpuinfo``; the card's SM clock, temperature and
power draw from ``nvidia-smi``). The last line gives the pairs'
``tick_ms_p50`` side by side.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _state(torch, when: str) -> dict:
    mem = torch.cuda.memory_stats()
    out = {"phase": "process_state", "when": when, "gc_objects": len(gc.get_objects()),
           "gc_collections": [g["collections"] for g in gc.get_stats()],
           "reserved_bytes": mem.get("reserved_bytes.all.current", 0),
           "allocated_bytes": mem.get("allocated_bytes.all.current", 0),
           "segments": mem.get("segment.all.current", 0),
           "alloc_retries": mem.get("num_alloc_retries", 0)}
    with open("/proc/cpuinfo") as f:
        mhz = [float(ln.split(":")[1]) for ln in f if ln.startswith("cpu MHz")]
    out["cpu_mhz_mean"] = sum(mhz) / len(mhz) if mhz else None
    out["card_clock_temp_power"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,temperature.gpu,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps(out), flush=True)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from materialize_tpu_torch.ops import merge_kernel

    ap = argparse.ArgumentParser()
    ap.add_argument("--without-q9", action="store_true")
    args = ap.parse_args()
    card = cs.phase_card_and_build(torch, merge_kernel)

    def pair(when):
        _state(torch, when)
        return [cs.phase_auction(torch, merge_kernel, card, name, state_cap=cap,
                                 n_users=users, auctions_per_tick=apt, bids_per_auction=8,
                                 retract_after=4)["tick_ms_p50"]
                for name, cap, users, apt in (("auction", 1 << 13, 512, 128),
                                              ("auction_x16", 1 << 17, 8192, 2048))]

    fresh = pair("fresh process")
    if args.without_q9:
        again = pair("after one pair")
        print(json.dumps({"phase": "phase_order", "card": card,
                          "tick_ms_p50": {"fresh": fresh, "again": again},
                          "order": ["auction", "auction_x16"]}), flush=True)
        return 0
    q9 = cs.phase_q9(torch, merge_kernel, card)

    def half_full(ca, cb, out):
        return ca // 2, min(cb // 2, max(out - ca // 2, 0))

    cs.phase_path_kernel(torch, merge_kernel, card, q9["by_shape"], "q9_kernel_shape",
                         half_full)
    cs.phase_path_modes(torch, merge_kernel, card, "q9_vs_plain_path",
                        lambda **kw: cs.q9_presized(churn_ticks=8, **kw), sf=0.002,
                        span_ticks=8)
    del q9
    after = pair("after the Q9 phases")
    gc.collect()
    torch.cuda.empty_cache()
    cleared = pair("after gc.collect() and empty_cache()")
    print(json.dumps({"phase": "phase_order", "card": card,
                      "tick_ms_p50": {"fresh": fresh, "after_q9": after,
                                      "after_q9_cleared": cleared},
                      "order": ["auction", "auction_x16"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
