"""Run one cell of the benchmark once, on the CUDA card:

    python3 ivmbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object: ``correct``,
``attempted`` and ``failed`` (ticks), the cell's end-to-end metrics
(``--trace 0``) or per-layer metrics (``--trace 1``, with the device's
busy and window seconds and a breakdown), the device, and last the
numbers compared beside their limits, which also end standard error.
Exits non-zero, printing no result, without a card (or fewer than the
cell asks for), when a module of JAX or the JAX package is loaded, or
when the program is missing.
"""

import time

T0 = time.perf_counter()  # the process's start, for setup_s

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Top-level module names that must not be loaded in this process.
FORBIDDEN = ("jax", "jaxlib", "flax", "materialize_tpu")
# Every build and kernel cache at a fixed place inside the checkout.
CACHE = ROOT / ".ivmbench_cache"


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def _environment() -> None:
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    # The program's native libraries build into its own ``_build/``; a
    # program bank elsewhere would be a cache outside the checkout.
    os.environ.pop("MZ_PROGRAM_BANK", None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    from ivmbench import loop, manifest, report

    trace = bool(args.trace)
    cell = loop.Cell.named(args.workload, trace)
    chips = manifest.workload(manifest.load(), args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"ivmbench: the cell needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    run, out, handed, peak = loop.run_cell(cell, args.seed, args.seconds, trace, T0)
    t_j = time.perf_counter()
    checks = loop.judge(cell, out, handed, device="cuda")
    run.phases["judge_s"] = time.perf_counter() - t_j
    metrics = {}
    for m in cell.metrics:
        value = manifest.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": peak}
    result = {"correct": loop.correct(checks), "attempted": run.ticks, "failed": 0,
              "metrics": metrics, "device": device}
    if trace:
        device["busy_s"] = report.busy_s(run)
        device["window_s"] = run.window_s
        result["breakdown"] = report.breakdown(run)
    result["checks"] = checks
    print(f"ivmbench: {args.workload} seed {args.seed}: window {run.window_s} s, "
          f"{run.ticks} ticks in {len(run.spans)} spans, set-up {run.setup_s} s, "
          f"phases {run.phases}, window {run.host}, {report.host_summary(run)}, "
          f"span s p50/p90/max {report.span_seconds(run)}",
          file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"ivmbench: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
