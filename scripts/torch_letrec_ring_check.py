#!/usr/bin/env python3
"""The reference's LetRec with slotted join spines, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/torch_letrec_ring_check.py

Runs the reference package's ``pagerank_mir`` (60 evaluations) on
``tests/test_letrec.py``'s five edges at ``state_cap`` 256 (the join
spines take merge ingest) and 8192 (a ring of 8 append slots: the
reference's rule picks it at 8x the 1024-row ingest tier), and prints
one JSON line per tier: its ingest slots, its ranks and the largest
relative difference from 60 power iterations. A ring cannot hold the
60 inserts of one tick: its cursor wraps and overwrites unflushed
slots, so the slotted run's ranks are wrong. The port renders a
LetRec's joins with merge ingest (``render/dataflow.py:_build_letrec``).
Takes about a minute (two step-program compiles).
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from materialize_tpu.render.dataflow import Dataflow  # noqa: E402
from materialize_tpu.repr.batch import Batch  # noqa: E402
from materialize_tpu.repr.schema import Column, ColumnType, Schema  # noqa: E402
from materialize_tpu.workloads.pagerank import pagerank_mir  # noqa: E402
from tests.test_letrec import _pagerank_oracle  # noqa: E402

EDGE = Schema([Column("src", ColumnType.INT64), Column("dst", ColumnType.INT64)])
EDGES = [(0, 1), (1, 2), (2, 0), (0, 2), (3, 2)]


def main() -> int:
    arr = np.array(EDGES)
    want = _pagerank_oracle(EDGES, n_iters=60)
    for cap in (256, 8192):
        df = Dataflow(pagerank_mir(EDGE, max_iters=60), state_cap=cap)
        df.step({"edges": Batch.from_numpy(EDGE, [arr[:, 0], arr[:, 1]],
                                           np.zeros(len(EDGES), np.uint64),
                                           np.ones(len(EDGES), np.int64))})
        got = {r[0]: r[1] for r in df.peek()}
        rel = max(abs(got[n] - want[n]) / want[n] for n in want)
        print(json.dumps({"state_cap": cap, "ingest_slots": df._ctx.ingest_slots,
                          "ranks": {str(k): v for k, v in sorted(got.items())},
                          "oracle": {str(k): v for k, v in sorted(want.items())},
                          "max_rel_diff": rel}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
