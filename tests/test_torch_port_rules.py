"""The port's own rules: no JAX, an explicit device, no silent fallback.

- Nothing under ``materialize_tpu_torch/`` and not ``chip_smoke.py``
  imports ``jax`` or anything of the reference package ``materialize_tpu``
  (AST scan of every import statement).
- Importing the slice's modules leaves ``jax`` out of ``sys.modules`` and
  builds nothing (the native library and the kernel build at first use).
- Entry points default to ``device="cuda"`` and raise without a card;
  ``python -m materialize_tpu_torch.testing.chaos --device cpu`` storms
  with neither ``jax`` nor ``materialize_tpu`` loaded, and the two
  commands, ``python -m materialize_tpu_torch.coord.replica``
  and ``python -m materialize_tpu_torch.server.environmentd``, serve
  with ``--device cpu`` with neither ``jax`` nor ``materialize_tpu``
  loaded, and exit non-zero with ``--device cuda`` and no card. A SIGTERM
  that reaches ``environmentd`` right after its ``Environment`` is up
  (before ``main()`` goes on) leaves no replica process behind.
- The kernel's wrappers (``search_right``, ``merge_path``) and a merge
  forced to the kernel raise on CPU tensors.
- The SPMD layer (``parallel/``, ``coord/spmd.py``) launches ranks on
  the card unless asked for the CPU, where it takes gloo only; the
  replica command serves with ``--device cpu --workers 2`` with neither
  ``jax`` nor ``materialize_tpu`` loaded.
"""

from __future__ import annotations

import ast
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from tests.torch_serving import deadline, one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "materialize_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "materialize_tpu")

SLICE_MODULES = [
    "materialize_tpu_torch",
    "materialize_tpu_torch.repr.schema",
    "materialize_tpu_torch.repr.batch",
    "materialize_tpu_torch.ops.lanes",
    "materialize_tpu_torch.ops.sort",
    "materialize_tpu_torch.ops.rows2d",
    "materialize_tpu_torch.ops.consolidate",
    "materialize_tpu_torch.ops.search",
    "materialize_tpu_torch.ops.merge",
    "materialize_tpu_torch.ops.merge_kernel",
    "materialize_tpu_torch.arrangement.spine",
    "materialize_tpu_torch.ops.reduce",
    "materialize_tpu_torch.ops.join",
    "materialize_tpu_torch.ops.delta_join",
    "materialize_tpu_torch.plan.decisions",
    "materialize_tpu_torch.expr.errors",
    "materialize_tpu_torch.expr.scalar",
    "materialize_tpu_torch.expr.linear",
    "materialize_tpu_torch.expr.relation",
    "materialize_tpu_torch.render.dataflow",
    "materialize_tpu_torch.storage.generator.tpch",
    "materialize_tpu_torch.coord.peek",
    "materialize_tpu_torch.workloads.index",
    "materialize_tpu_torch.workloads.tpch",
    "materialize_tpu_torch.ops.topk",
    "materialize_tpu_torch.storage.generator.auction",
    "materialize_tpu_torch.workloads.auction",
    "materialize_tpu_torch.workloads.pagerank",
    "materialize_tpu_torch.interop",
    "materialize_tpu_torch.expr.strings",
    "materialize_tpu_torch.sql.lexer",
    "materialize_tpu_torch.sql.ast",
    "materialize_tpu_torch.sql.parser",
    "materialize_tpu_torch.sql.hir",
    "materialize_tpu_torch.sql.catalog",
    "materialize_tpu_torch.sql.plan_query",
    "materialize_tpu_torch.sql.lowering",
    "materialize_tpu_torch.sql.plan",
    "materialize_tpu_torch.analysis.monotonic",
    "materialize_tpu_torch.transform.optimizer",
    "materialize_tpu_torch.transform.cse",
    "materialize_tpu_torch.native",
    "materialize_tpu_torch.utils.dyncfg",
    "materialize_tpu_torch.utils.retry",
    "materialize_tpu_torch.utils.metrics",
    "materialize_tpu_torch.utils.trace",
    "materialize_tpu_torch.utils.locks",
    "materialize_tpu_torch.storage.persist",
    "materialize_tpu_torch.storage.persist.location",
    "materialize_tpu_torch.storage.persist.codec",
    "materialize_tpu_torch.storage.persist.state",
    "materialize_tpu_torch.storage.persist.pubsub",
    "materialize_tpu_torch.storage.persist.machine",
    "materialize_tpu_torch.storage.persist.client",
    "materialize_tpu_torch.storage.persist.operators",
    "materialize_tpu_torch.coord.protocol",
    "materialize_tpu_torch.coord.oracle",
    "materialize_tpu_torch.coord.freshness",
    "materialize_tpu_torch.coord.replica",
    "materialize_tpu_torch.coord.controller",
    "materialize_tpu_torch.coord.sources",
    "materialize_tpu_torch.coord.coordinator",
    "materialize_tpu_torch.server.pgwire",
    "materialize_tpu_torch.storage.persist.compactor",
    "materialize_tpu_torch.coord.subscribe",
    "materialize_tpu_torch.coord.introspection",
    "materialize_tpu_torch.coord.autoscaler",
    "materialize_tpu_torch.server.http",
    "materialize_tpu_torch.server.environmentd",
    "materialize_tpu_torch.render.span_exec",
    "materialize_tpu_torch.expr.remap",
    "materialize_tpu_torch.utils.compile_ledger",
    "materialize_tpu_torch.utils.lockcheck",
    "materialize_tpu_torch.plan",
    "materialize_tpu_torch.plan.lir",
    "materialize_tpu_torch.plan.lowering",
    "materialize_tpu_torch.analysis",
    "materialize_tpu_torch.analysis.typecheck",
    "materialize_tpu_torch.analysis.provenance",
    "materialize_tpu_torch.analysis.donation",
    "materialize_tpu_torch.analysis.shard_prop",
    "materialize_tpu_torch.analysis.racecheck",
    "materialize_tpu_torch.analysis.step_lint",
    "materialize_tpu_torch.analysis.host_sync",
    "materialize_tpu_torch.analysis.interleave",
    "materialize_tpu_torch.testing",
    "materialize_tpu_torch.testing.slt",
    "materialize_tpu_torch.storage",
    "materialize_tpu_torch.storage.kafka",
    "materialize_tpu_torch.storage.kafka.avro",
    "materialize_tpu_torch.storage.kafka.broker",
    "materialize_tpu_torch.storage.kafka.decode",
    "materialize_tpu_torch.storage.kafka.source",
    "materialize_tpu_torch.storage.kafka.sink",
    "materialize_tpu_torch.testing.chaos",
    "materialize_tpu_torch.parallel",
    "materialize_tpu_torch.parallel.mesh",
    "materialize_tpu_torch.parallel.multihost",
    "materialize_tpu_torch.parallel.exchange",
    "materialize_tpu_torch.coord.spmd",
    "materialize_tpu_torch.workloads.multichip",
]


def _top_names(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_jax_or_reference_imports():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15 and (ROOT / "chip_smoke.py").exists()
    bad = []
    for f in files:
        for name in _top_names(ast.parse(f.read_text(), str(f))):
            if name in FORBIDDEN:
                bad.append(f"{f.relative_to(ROOT)}: {name}")
    assert not bad, bad


def test_no_raise_names_items_14_or_15():
    """The plan checkers (ROADMAP Queue 1 item 14) and the collection
    aggregates (item 15) are ported: no string of the port names either
    item, so nothing raises naming them."""
    bad = []
    for f in sorted(PKG.rglob("*.py")):
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                text = " ".join(node.value.split())
                if "item 14" in text or "item 15" in text or "ITEM_14" in text:
                    bad.append(f"{f.relative_to(ROOT)}:{node.lineno}")
    assert not bad, bad


def test_no_raise_names_item_16():
    """Kafka sources and sinks and the chaos harness (ROADMAP Queue 1
    item 16) are ported: no string of the port names the item."""
    bad = []
    for f in sorted(PKG.rglob("*.py")):
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                if "item 16" in " ".join(node.value.split()):
                    bad.append(f"{f.relative_to(ROOT)}:{node.lineno}")
    assert not bad, bad


# Runs the chaos command as ``__main__`` and then reports which of the
# forbidden packages it loaded.
_CHAOS = """
import runpy, sys
sys.argv = ["chaos"] + sys.argv[1:]
try:
    runpy.run_module("materialize_tpu_torch.testing.chaos", run_name="__main__")
finally:
    loaded = sorted(m for m in ("jax", "jaxlib", "materialize_tpu") if m in sys.modules)
    print("LOADED", loaded, flush=True)
"""


def test_chaos_command_storms_on_cpu_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _CHAOS, "--device", "cpu", "--ticks", "4"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    out = proc.stdout + proc.stderr[-2000:]
    assert proc.returncode == 0 and "LOADED []" in proc.stdout, out
    assert "ChaosReport(ops=4" in proc.stdout and "failures=[]" in proc.stdout, out


def test_chaos_command_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run(
        [sys.executable, "-m", "materialize_tpu_torch.testing.chaos", "--ticks", "4"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0 and "cuda" in proc.stderr, proc.stdout + proc.stderr[-2000:]
    assert "ChaosReport" not in proc.stdout


def test_slt_runner_imports_nothing_of_the_reference():
    """``testing/slt.py`` is the port's own copy: it imports neither JAX
    nor the reference, and loading it loads neither."""
    f = PKG / "testing" / "slt.py"
    assert not set(_top_names(ast.parse(f.read_text()))) & set(FORBIDDEN)
    code = (
        "import sys\n"
        "from materialize_tpu_torch.testing.slt import parse_slt, run_slt\n"
        "assert 'jax' not in sys.modules and 'materialize_tpu' not in sys.modules\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_slice_imports_leave_jax_unloaded():
    code = (
        "import importlib, sys\n"
        f"for m in {SLICE_MODULES!r}: importlib.import_module(m)\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert 'materialize_tpu' not in sys.modules, 'reference imported'\n"
        "from materialize_tpu_torch import native\n"
        "from materialize_tpu_torch.ops import merge_kernel\n"
        "assert native._lib is None, 'native library built at import'\n"
        "assert merge_kernel._FN is None, 'merge kernel built at import'\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


def test_entry_points_default_to_cuda():
    from materialize_tpu_torch import default_device
    from materialize_tpu_torch.expr.relation import Get
    from materialize_tpu_torch.render.dataflow import Dataflow
    from materialize_tpu_torch.storage.generator.tpch import LINEITEM_SCHEMA
    from materialize_tpu_torch.workloads.index import index_config
    from materialize_tpu_torch.storage.generator.auction import AuctionGenerator
    from materialize_tpu_torch.workloads.auction import auction_config
    from materialize_tpu_torch.workloads.pagerank import pagerank_config
    from materialize_tpu_torch.workloads.tpch import q1_config, q7_config, q9_config, q15_config

    assert default_device() == "cuda"
    if torch.cuda.is_available():
        assert Dataflow(Get("lineitem", LINEITEM_SCHEMA)).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        Dataflow(Get("lineitem", LINEITEM_SCHEMA))
    with pytest.raises(RuntimeError, match="cuda"):
        index_config(sf=0.001)
    with pytest.raises(RuntimeError, match="cuda"):
        q1_config(sf=0.001)
    with pytest.raises(RuntimeError, match="cuda"):
        q15_config(sf=0.001)
    with pytest.raises(RuntimeError, match="cuda"):
        q9_config(sf=0.001)
    with pytest.raises(RuntimeError, match="cuda"):
        q7_config(sf=0.001)
    with pytest.raises(RuntimeError, match="cuda"):
        auction_config()
    with pytest.raises(RuntimeError, match="cuda"):
        AuctionGenerator().tick(0, 0)
    with pytest.raises(RuntimeError, match="cuda"):
        pagerank_config()
    from materialize_tpu_torch.coord.protocol import PersistLocation
    from materialize_tpu_torch.coord.replica import ReplicaWorker

    with pytest.raises(RuntimeError, match="cuda"):
        # The replica's device is checked before it opens the location.
        ReplicaWorker(location=PersistLocation("/nonexistent/blob", "/nonexistent/c.db"))
    from materialize_tpu_torch.coord.coordinator import Coordinator
    from materialize_tpu_torch.server.environmentd import Environment
    from materialize_tpu_torch.storage.persist import MemBlob, MemConsensus, PersistClient

    with pytest.raises(RuntimeError, match="cuda"):
        Coordinator(PersistClient(MemBlob(), MemConsensus()))
    with pytest.raises(RuntimeError, match="cuda"):
        # Checked before a directory or a replica process is made.
        Environment("/nonexistent/envd", tick_interval=None)
    cpu = Dataflow(Get("lineitem", LINEITEM_SCHEMA), device="cpu")
    assert cpu.device.type == "cpu"


def test_parallel_entry_points_default_to_cuda():
    """The SPMD layer names its device: launching ranks, counting a
    host's workers and an SPMD replica default to the card and raise
    without one; the CPU takes gloo only."""
    from materialize_tpu_torch.coord.protocol import PersistLocation
    from materialize_tpu_torch.coord.replica import ReplicaWorker
    from materialize_tpu_torch.parallel.mesh import check_backend
    from materialize_tpu_torch.parallel.multihost import host_local_device_count, spawn_workers

    with pytest.raises(ValueError, match="gloo"):
        check_backend("nccl", torch.device("cpu"), 1)
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="cuda"):
        spawn_workers(print, 2)
    with pytest.raises(RuntimeError, match="cuda"):
        host_local_device_count()
    with pytest.raises(RuntimeError, match="cuda"):
        ReplicaWorker(location=PersistLocation("/nonexistent/blob", "/nonexistent/c.db"),
                      workers=2)


def test_replica_command_serves_with_two_workers_on_cpu(tmp_path):
    """``python -m materialize_tpu_torch.coord.replica --device cpu
    --workers 2`` serves with neither ``jax`` nor ``materialize_tpu``
    loaded; its follower exits with it."""
    port = _free_port()
    args = ["--port", str(port), "--blob", str(tmp_path / "blob"),
            "--consensus", str(tmp_path / "c.db"), "--device", "cpu", "--workers", "2"]
    proc = subprocess.run(
        [sys.executable, "-c", _CLEAN, "materialize_tpu_torch.coord.replica", str(port),
         *args],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    assert proc.returncode == 0 and "LOADED []" in proc.stdout, (
        proc.stdout + proc.stderr[-2000:])


def test_kernel_mode_refuses_cpu_tensors():
    import numpy as np

    from materialize_tpu_torch.ops import merge_kernel
    from materialize_tpu_torch.ops.merge import merge_mode, merge_sorted_cached
    from materialize_tpu_torch.repr.batch import Batch
    from materialize_tpu_torch.repr.schema import Column, ColumnType, Schema

    a = torch.stack([torch.arange(4), torch.zeros(4, dtype=torch.int64)], 1)
    c = torch.tensor(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        merge_kernel.search_right(a, c, a)
    with pytest.raises(ValueError, match="CUDA"):
        merge_kernel.merge_path(a, c, 4, a, c, 8)
    schema = Schema([Column("id", ColumnType.INT64, nullable=False)])
    batch = Batch.from_numpy(schema, [np.arange(4)], np.uint64(0), np.ones(4, np.int64),
                             capacity=4, device="cpu")
    with merge_mode("kernel"), pytest.raises(ValueError, match="CUDA"):
        merge_sorted_cached(batch, a, batch, a, 8)
    with merge_mode("torch"):
        merged, lanes, _ = merge_sorted_cached(batch, a, batch, a, 8)
    assert merged.cols[0].tolist() == [0, 0, 1, 1, 2, 2, 3, 3]
    assert lanes.shape == (8, 2)


# Runs a ``-m`` entry point's module as ``__main__`` in this process and,
# once it serves, reports which of the forbidden packages are loaded.
_CLEAN = """
import os, runpy, signal, socket, sys, threading, time
module, port = sys.argv[1], int(sys.argv[2])
sys.argv = [module] + sys.argv[3:]

def watch():
    while True:
        try:
            socket.create_connection(("127.0.0.1", port), 1).close()
            break
        except OSError:
            time.sleep(0.05)
    loaded = sorted(m for m in ("jax", "jaxlib", "materialize_tpu") if m in sys.modules)
    # One write: the served module prints from its own thread meanwhile.
    sys.stdout.flush()
    os.write(1, f"LOADED {loaded}\\n".encode())
    if module.endswith("environmentd"):
        # The port was free when the test chose it, so another process
        # may listen on it first: signal only once main() handles SIGTERM.
        while signal.getsignal(signal.SIGTERM) in (signal.SIG_DFL, None):
            time.sleep(0.05)
        os.kill(os.getpid(), signal.SIGTERM)  # a clean shutdown
    else:
        os._exit(0)

threading.Thread(target=watch, daemon=True).start()
runpy.run_module(module, run_name="__main__")
"""


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _entry(module: str, device: str, tmp_path) -> tuple:
    port = _free_port()
    if module.endswith("replica"):
        args = ["--port", str(port), "--blob", str(tmp_path / "blob"),
                "--consensus", str(tmp_path / "c.db")]
    else:
        args = ["--data-dir", str(tmp_path / "envd"), "--pg-port", str(port),
                "--http-port", str(_free_port())]
    proc = subprocess.run(
        [sys.executable, "-c", _CLEAN, module, str(port), *args, "--device", device],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    return proc.returncode, proc.stdout, proc.stderr


@pytest.mark.parametrize("module", ["materialize_tpu_torch.coord.replica",
                                    "materialize_tpu_torch.server.environmentd"])
def test_commands_serve_on_cpu_without_jax(module, tmp_path):
    rc, out, err = _entry(module, "cpu", tmp_path)
    assert rc == 0 and "LOADED []" in out, out + err[-2000:]


@pytest.mark.parametrize("module", ["materialize_tpu_torch.coord.replica",
                                    "materialize_tpu_torch.server.environmentd"])
def test_commands_refuse_cuda_without_a_card(module, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    rc, out, err = _entry(module, "cuda", tmp_path)
    assert rc != 0 and "LOADED" not in out and "cuda" in err, out + err[-2000:]


# Runs environmentd's main() with a hook in this child only: the moment
# ``Environment(...)`` returns, before main() goes on, the process sends
# itself SIGTERM. The replica processes it spawned must not outlive it.
_GAP = """
import os, signal, sys, time
from materialize_tpu_torch.server import environmentd
init = environmentd.Environment.__init__

def init_then_sigterm(self, *args, **kwargs):
    init(self, *args, **kwargs)
    print("REPLICAS", *[p.pid for p in self.procs], flush=True)
    os.kill(os.getpid(), signal.SIGTERM)
    time.sleep(60)  # the handler's SystemExit ends this

environmentd.Environment.__init__ = init_then_sigterm
sys.argv = ["environmentd"] + sys.argv[1:]
environmentd.main()
"""


def test_sigterm_right_after_boot_leaves_no_replica(tmp_path):
    args = ["--data-dir", str(tmp_path / "envd"), "--pg-port", str(_free_port()),
            "--http-port", str(_free_port()), "--device", "cpu"]
    proc = subprocess.run(
        [sys.executable, "-c", _GAP, *args], cwd=ROOT, capture_output=True,
        text=True, timeout=90, env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("REPLICAS")]
    assert line, proc.stdout + proc.stderr[-2000:]
    pids = [int(p) for p in line[0].split()[1:]]
    assert proc.returncode == 0 and pids, proc.stdout + proc.stderr[-2000:]
    deadline = time.monotonic() + 10
    alive = pids
    while alive and time.monotonic() < deadline:
        alive = [p for p in pids if _alive(p)]
        time.sleep(0.1)
    assert not alive, f"replica processes {alive} outlived environmentd"


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(") ", 1)[1][0] != "Z"
    except (FileNotFoundError, ProcessLookupError, IndexError):
        return False
