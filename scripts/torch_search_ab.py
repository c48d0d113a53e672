#!/usr/bin/env python3
"""The plain search (``ops/search.py:lex_searchsorted_2d``) of this
checkout against another version of the same file, on a card.

    python3 scripts/torch_search_ab.py OTHER_SEARCH_PY [--sf 0.1]

OTHER_SEARCH_PY is a copy of ``materialize_tpu_torch/ops/search.py``
from another commit (it imports only torch). Both versions run in one
process, in the order this, other, other, this: the version under test
is swapped in where the port calls the search (the join probes'
``lookup_range`` and the merge's plain chain). Prints one JSON line per
version and run:

- ``plain_ms``: ``merge_source_map_torch`` at the index's level-2 fold
  (2^23 rows with 2^21, L = 4, runs 70 % full, as ``chip_smoke.py``
  times it), CUDA events around R calls; the two versions' results
  must be equal;
- TPC-H Q15 at ``--sf`` (``q15_config``, hydrated, then a warm span of
  16): ``tick_ms``, one span of 16 churn ticks timed with the card
  synchronised at its ends, its flags read once; ``ops_per_tick``, the
  device operations (``torch.profiler``, device activity only) of one
  more span of 16.

The last line gives the mean of each metric per version.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORDER = ("this", "other", "other", "this")


def _load(path: str):
    spec = importlib.util.spec_from_file_location("other_search", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.lex_searchsorted_2d


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from chip_smoke import _device_ops, _hash_run, cuda_ms
    from materialize_tpu_torch.arrangement import spine
    from materialize_tpu_torch.ops import merge, search
    from materialize_tpu_torch.workloads.tpch import q15_config

    ap = argparse.ArgumentParser()
    ap.add_argument("other")
    ap.add_argument("--sf", type=float, default=0.1)
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    versions = {"this": search.lex_searchsorted_2d, "other": _load(args.other)}

    def use(name):
        spine.lex_searchsorted_2d = merge.lex_searchsorted_2d = versions[name]

    rows = []
    rng = np.random.default_rng(3)
    cap_a, cap_b = 1 << 23, 1 << 21
    ac, bc = int(cap_a * 0.7), int(cap_b * 0.7)
    a, ah = _hash_run(torch, rng, cap_a, ac)
    b, _ = _hash_run(torch, rng, cap_b, bc, share_from=ah)
    ca = torch.tensor(ac, dtype=torch.int32, device="cuda")
    cb = torch.tensor(bc, dtype=torch.int32, device="cuda")
    want = None
    for name in ORDER:
        use(name)
        got = merge.merge_source_map_torch(a, ca, cap_a, b, cb, cap_b, cap_a)
        if want is None:
            want = got
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            print(f"{name}: the merge's plain chain differs", file=sys.stderr)
            return 1
        ms, reps = cuda_ms(torch, lambda: merge.merge_source_map_torch(
            a, ca, cap_a, b, cb, cap_b, cap_a))
        rows.append({"what": "plain_chain", "version": name, "plain_ms": ms, "reps": reps,
                     "cap_a": cap_a, "cap_b": cap_b, "L": 4, "card": card})
        print(json.dumps(rows[-1]), flush=True)
    del a, b, want, got

    use("this")
    df, hydrate, churn = q15_config(sf=args.sf, n_orders_per_tick=1024, seed=42,
                                    device="cuda")
    h = hydrate()
    n_h = len(h) - len(h) % df._compact_every
    for i in range(0, n_h, 32):
        df.run_span(h[i:min(i + 32, n_h)])
        df.check_flags()
    df.run_steps(h[n_h:])
    ticks = [churn(i, len(h) + i)[0] for i in range(16 * (1 + 2 * len(ORDER)))]
    spans = [ticks[i:i + 16] for i in range(0, len(ticks), 16)]
    df.run_span(spans[0])
    df.check_flags()
    for k, name in enumerate(ORDER):
        use(name)
        torch.cuda.synchronize()
        t = time.perf_counter()
        df.run_span(spans[1 + 2 * k])
        over = df.check_flags()
        torch.cuda.synchronize()
        tick_ms = (time.perf_counter() - t) * 1e3 / 16

        def span(s=spans[2 + 2 * k]):
            df.run_span(s)
            df.check_flags()

        ops = _device_ops(torch, span) / 16
        rows.append({"what": "q15", "version": name, "sf": args.sf, "tick_ms": tick_ms,
                     "ops_per_tick": ops, "overflowed": over, "card": card})
        print(json.dumps(rows[-1]), flush=True)
    means = {}
    for name in versions:
        mine = [r for r in rows if r["version"] == name]
        means[name] = {m: float(np.mean([r[m] for r in mine if m in r]))
                       for m in ("plain_ms", "tick_ms", "ops_per_tick")}
    print(json.dumps({"means": means, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
