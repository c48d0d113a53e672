#!/usr/bin/env python3
"""Pagerank with and without the LetRec's source-only shortcut, on a
card.

    python3 scripts/torch_letrec_ab.py [--ticks 8]

``render/dataflow.py:_source_only`` runs a LetRec value's subtrees that
read no binding (pagerank's out-degree COUNT, its node DISTINCT and
base ranks, and the edges' side of the second join) only in the first
evaluation of a tick, and the linear joins skip those sides after it.
Version ``off`` builds the same plan with the shortcut replaced by a
plain build of the subtree, so every evaluation steps those operators
on empty deltas, as the reference does. Both run the bench's pagerank
(``pagerank_config``'s defaults: 2,000 nodes, 10,000 edges, 64 rewired
a tick, 60 evaluations a tick, tiers from ``pagerank_tiers``) in the
order on, off, off, on, each a fresh dataflow: 1 hydrate tick, one
span of ``--ticks`` churn ticks timed with the card synchronised at
its ends and its flags read once, then one profiled tick. Prints one
JSON line per run (``tick_ms``, ``evaluations_per_tick``, the device
operations of the profiled tick and per evaluation) and a last line
with each version's means; fails if a version's peek differs from the
first run's by a bit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORDER = ("on", "off", "off", "on")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from chip_smoke import _device_ops
    from materialize_tpu_torch.render import dataflow
    from materialize_tpu_torch.workloads.pagerank import pagerank_config, pagerank_tiers
    from materialize_tpu_torch.workloads.tpch import apply_tiers

    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, default=8)
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    shortcut = dataflow._source_only

    def plain(expr, ctx):
        names, ctx.letrec_names = ctx.letrec_names, frozenset()
        inner = dataflow._build(expr, ctx)
        ctx.letrec_names = names
        return inner

    rows, want = [], None
    for name in ORDER:
        dataflow._source_only = shortcut if name == "on" else plain
        df, hydrate, churn, _ = pagerank_config(device="cuda")
        apply_tiers(df, pagerank_tiers(df, 2000, 10000, 64, 2 + args.ticks))
        df.run_steps(hydrate())
        ticks = [churn(i, 1 + i)[0] for i in range(args.ticks + 1)]
        ctx = df._ctx
        torch.cuda.synchronize()
        t = time.perf_counter()
        e0 = len(ctx.letrec_evals)
        df.run_span(ticks[:args.ticks])
        over = df.check_flags()
        torch.cuda.synchronize()
        tick_ms = (time.perf_counter() - t) * 1e3 / args.ticks
        evals = ctx.letrec_evals[e0:]
        e1 = len(ctx.letrec_evals)

        def last():
            df.run_steps(ticks[args.ticks:], defer_check=True)
            df.check_flags()

        ops = _device_ops(torch, last)
        got = sorted(df.peek())
        if want is None:
            want = got
        if over or got != want:
            print(f"{name}: overflowed ({over}) or its peek differs", file=sys.stderr)
            return 1
        rows.append({"version": name, "tick_ms": tick_ms, "ticks": args.ticks,
                     "evaluations_per_tick": float(np.mean(evals)),
                     "ops_per_tick": ops, "ops_per_evaluation": ops / ctx.letrec_evals[e1],
                     "card": card})
        print(json.dumps(rows[-1]), flush=True)
        del df
        torch.cuda.empty_cache()
    dataflow._source_only = shortcut
    means = {v: {m: float(np.mean([r[m] for r in rows if r["version"] == v]))
                 for m in ("tick_ms", "ops_per_tick", "ops_per_evaluation")}
             for v in ("on", "off")}
    print(json.dumps({"means": means, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
