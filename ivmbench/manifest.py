"""Finding a cell's pieces by name: ``BENCHMARK.json`` at the root of the
checkout, each configuration at the ``file`` it names, each traffic mix
at ``ivmbench/traffic/<name>.json``, each metric's reader at
``ivmbench/metrics/<name>.py``; and, named inside those files, each
source at ``ivmbench/gen/<stream>.py``, each query's reference at
``ivmbench/reference/<query>.py``, each read at
``ivmbench/reads/<read>.py`` and each kind of loop at
``ivmbench/loops/<loop>.py``. A new cell, configuration, source, mix,
read, loop or metric is new files and new entries; nothing here
changes."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent


def load(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for wl in bench["workloads"]:
        if wl["name"] == name:
            return wl
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(root / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str, root: Path = ROOT) -> dict:
    with open(root / "ivmbench" / "traffic" / f"{name}.json") as f:
        return json.load(f)


def metrics_for(bench: dict, workload_name: str, trace: bool) -> list:
    """The metrics a run of the cell reports: its end-to-end ones, or
    with ``trace`` its per-layer ones; a metric with ``workloads`` only
    in the cells it lists."""
    return [m for m in bench["per_layer" if trace else "end_to_end"]
            if workload_name in m.get("workloads", [workload_name])]


def _metric(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "ivmbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str):
    """The ``read(run)`` function of metric ``name``."""
    return _metric(name).read


def probe(name: str):
    """A new instance of metric ``name``'s ``Probe`` (what a traced run
    installs around the window to give the reader something to read:
    ``install()``, ``uninstall()``, ``collect(torch, run)``), or None."""
    cls = getattr(_metric(name), "Probe", None)
    return cls() if cls is not None else None


def piece(kind: str, name: str):
    """The module ``ivmbench/<kind>/<name>.py`` (kind ``gen``,
    ``reference``, ``reads`` or ``loops``)."""
    return importlib.import_module(f"ivmbench.{kind}.{name}")
