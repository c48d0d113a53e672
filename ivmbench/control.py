"""The control of the check that decides ``correct``, on the card:

    python3 ivmbench/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

For each seed, one run of the cell at its own size and load, then the
numbers compared three times: for the program's outputs, and for each
control, the reference's own outputs put in the program's place with
one guarantee of the configuration broken (``loop.judge``: a tick
applied twice, a read that misses the last span). Every control must
come out not correct. One JSON line per seed. The benchmark's own runs
never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

CONTROLS = ("duplicate_tick", "stale_read")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)

    from ivmbench import loop, run

    run._environment()
    cell = loop.Cell.named(args.workload, False)
    ok = True
    for seed in args.seeds:
        t0 = time.perf_counter()
        rec, out, handed, _peak = loop.run_cell(cell, seed, args.seconds, False, t0)
        line = {"workload": args.workload, "seed": seed, "ticks": rec.ticks,
                "program": loop.judge(cell, out, handed, device="cuda"), "controls": {}}
        for c in CONTROLS:
            checks = loop.judge(cell, out, handed, control=c, device="cuda")
            line["controls"][c] = checks
            ok &= not loop.correct(checks)
        ok &= loop.correct(line["program"])
        print(json.dumps(line), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
