#!/usr/bin/env python3
"""The phases of ``chip_smoke.py`` that the pipelined span path, the
dictionary rebalance and EXPLAIN PHYSICAL PLAN touch, in one process on
a card, without the rest of the script.

    python3 scripts/torch_span_phases.py [--skip-index] [--deploy-ab]

Runs ``chip_smoke.py``'s card line and kernel build, ``sql_plans``
(EXPLAIN PHYSICAL PLAN of Q7 and Q1 against the plans the render layer
builds), ``arms_small`` (with the dictionary rebalance on the card),
``index`` (the SF 1 index: the serial churn train, then the next 32
ticks through ``render/span_exec.SpanExecutor``; left out with
``--skip-index``), the bare ``q1`` cell, ``serve`` a tick at a time and
then pipelined (each with its host-sync probe), and ``deploy`` (the
replica process with ``span_pipelining`` on, its span census and
compile records). With ``--deploy-ab``, ``sql_plans``, ``arms_small``
and ``index`` are left out, ``serve`` runs once (a tick at a time) and
``deploy`` four times, its replica stepping a tick at a time,
pipelined, pipelined, a tick at a time (an A B B A comparison in one
process). Each phase prints its JSON line as the
smoke does, and the last line the seconds of each.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--skip-index", action="store_true")
    ap.add_argument("--deploy-ab", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_span_phases: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from materialize_tpu_torch.ops import merge_kernel

    seconds, t = {}, time.perf_counter()

    def mark(name):
        nonlocal t
        now = time.perf_counter()
        seconds[name] = now - t
        t = now

    card = cs.phase_card_and_build(torch, merge_kernel)
    mark("build")
    if args.deploy_ab:
        q1 = cs.phase_q1(torch, merge_kernel, card, sf=0.1)
        mark("q1")
        serve = cs.phase_serve(torch, merge_kernel, card, q1)
        mark("serve")
        for i, on in enumerate((False, True, True, False)):
            cs.phase_deploy(torch, merge_kernel, card, serve, span_pipelining=on)
            mark(f"deploy_{i}_{'pipelined' if on else 'per_tick'}")
        print(json.dumps({"phase": "done", "card": card, "phase_s": seconds}), flush=True)
        return 0
    cs.phase_sql_plans(card)
    mark("sql_plans")
    cs.phase_arms_small(torch, merge_kernel, card)
    mark("arms_small")
    if not args.skip_index:
        cs.phase_index(torch, merge_kernel, card)
        mark("index")
    q1 = cs.phase_q1(torch, merge_kernel, card, sf=0.1)
    mark("q1")
    runs, _rows = cs.serve_phases(torch, merge_kernel, card, q1)
    mark("serve")
    cs.phase_deploy(torch, merge_kernel, card, runs[0])
    mark("deploy")
    print(json.dumps({"phase": "done", "card": card, "phase_s": seconds}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
