"""The port's own rules: no JAX, an explicit device, no silent fallback.

- Nothing under ``materialize_tpu_torch/`` and not ``chip_smoke.py``
  imports ``jax`` or anything of the reference package ``materialize_tpu``
  (AST scan of every import statement).
- Importing the slice's modules leaves ``jax`` out of ``sys.modules`` and
  builds nothing (the native library and the kernel build at first use).
- Entry points default to ``device="cuda"`` and raise without a card.
- The kernel's wrappers (``search_right``, ``merge_path``) and a merge
  forced to the kernel raise on CPU tensors.
"""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's eager ops here are small: one intra-op thread runs them
    about as fast, and does not contend with other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

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
    cpu = Dataflow(Get("lineitem", LINEITEM_SCHEMA), device="cpu")
    assert cpu.device.type == "cpu"


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
