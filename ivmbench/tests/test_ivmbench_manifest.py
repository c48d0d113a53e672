"""``BENCHMARK.json`` keeps to the benchmark's contract, and every piece
it names is a file the harness finds by that name."""

import json
import re
from pathlib import Path

import pytest

from ivmbench import manifest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert all(_line(w) for w in BENCH["command"]) and len(BENCH["command"]) <= 32
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/")
        assert ".." not in p.split("/") and not p.endswith("_torch")


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra
        assert NAME.match(e["name"])
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for key in ("why", "layer"):
            assert key not in e or _line(e[key])
        if section == "configs":
            assert _line(e["source"]) and len(e["reduced"]) <= 16


def test_references_between_entries():
    configs = {c["name"]: c for c in BENCH["configs"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m.get("workloads", cells)) <= cells
        if m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in BENCH["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4) and NAME.match(w["traffic"])
        reported = manifest.metrics_for(BENCH, w["name"], False)
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        assert manifest.metrics_for(BENCH, w["name"], True)
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == set(configs)


def test_every_named_piece_is_a_file():
    paths = [ROOT / p for p in BENCH["paths"]]
    for c in BENCH["configs"]:
        f = ROOT / c["file"]
        assert any(p in f.parents for p in paths)
        cfg = json.loads(f.read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] and NAME.match(cfg["query"])
        assert {"assumed", "guarantees"} <= set(cfg)
        for kind, key in (("reference", "query"), ("gen", "stream"), ("reads", "read")):
            assert NAME.match(cfg[key])
            assert (ROOT / "ivmbench" / kind / f"{cfg[key]}.py").exists()
    for w in BENCH["workloads"]:
        t = manifest.traffic(w["traffic"])
        assert NAME.match(t["loop"]) and (ROOT / "ivmbench" / "loops" / f"{t['loop']}.py").exists()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(manifest.reader(m["name"]))
    for p in paths:
        for f in p.rglob("*"):
            rel = f.relative_to(ROOT).as_posix()
            assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel
