"""The merge-path kernel: build, load and launch ``csrc/merge_path.cu``
(replaces the reference's Pallas kernel
``materialize_tpu/ops/merge_pallas.py:pallas_search_right`` and the
inversion and lanes gather that followed it).

The CUDA source has a plain C interface, is compiled with ``nvcc`` for
``sm_90a`` into ``materialize_tpu_torch/_build/`` at first use (keyed by
a hash of the source and flags, so an edit rebuilds), and is loaded
with ``ctypes``. Nothing here runs when the module is imported.

``search_right`` and ``merge_path`` launch on CUDA tensors only; their
plain torch versions are ``ops/merge.py:search_right_torch`` and
``ops/merge.py:merge_source_map_torch``, which the CPU takes. There is no
fallback from here to them.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from collections import Counter
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "merge_path.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

# Launches of the kernel since the last reset (a run sets it to 0 and
# reads it after driving the main path), in all and by (m, n,
# out_capacity, L): a's rows, b's rows, the output slots, the lanes.
LAUNCHES = 0
LAUNCHES_BY_SHAPE: Counter = Counter()

_FN = None
_LOCK = threading.Lock()
BUILD_INFO: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _compile():
    """Compile ``SOURCE`` with nvcc into a shared library under
    ``BUILD_DIR`` (named by a hash of the source and flags; an existing
    one is reused). Returns (path, compiler log, seconds, whether it was
    built now, the build's fingerprint)."""
    from ..utils.compile_ledger import source_fingerprint

    src = SOURCE.read_bytes()
    digest = source_fingerprint(src, NVCC_FLAGS)
    lib_path = BUILD_DIR / f"lib{SOURCE.stem}-{digest}.so"
    t0 = time.perf_counter()
    log = ""
    built = not lib_path.exists()
    if built:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".so.tmp{os.getpid()}")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
            capture_output=True, text=True, timeout=600,
        )
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, lib_path)
    return lib_path, log, time.perf_counter() - t0, built, digest


def build():
    """Compile (if needed) and load the kernel library; returns its C
    entry point ``merge_path`` with its argument types. Records the
    build's seconds, the seconds to build (if needed) and load the
    library, and the compiler's ``-Xptxas -v`` report in
    ``BUILD_INFO``, and the build or load in the compile ledger."""
    global _FN
    with _LOCK:
        if _FN is None:
            t0 = time.perf_counter()
            path, log, seconds, built, digest = _compile()
            fn = ctypes.CDLL(str(path)).merge_path
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
            _FN = fn
            load_seconds = time.perf_counter() - t0
            BUILD_INFO.update(path=str(path), seconds=seconds, log=log,
                              load_seconds=load_seconds)
            from ..utils.compile_ledger import LEDGER

            LEDGER.record("nvcc", SOURCE.name, digest, " ".join(NVCC_FLAGS),
                          load_seconds, cache="miss" if built else "hit")
        return _FN


def _check(what: str, a: torch.Tensor, b: torch.Tensor, *counts) -> None:
    if not (a.is_cuda and b.is_cuda):
        raise ValueError(f"{what} takes CUDA tensors only")
    if a.dtype != torch.int64 or b.dtype != torch.int64:
        raise TypeError(f"{what}: lanes must be int64, got {a.dtype}/{b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[1] or b.shape[1] < 1:
        raise ValueError(f"{what}: shapes {tuple(a.shape)} / {tuple(b.shape)}")
    if b.shape[1] > 1024:
        raise ValueError(f"{what}: {b.shape[1]} lanes, at most 1024")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{what}: lanes must be contiguous")
    for c in counts:
        if not isinstance(c, torch.Tensor) or c.dtype != torch.int32 or c.numel() != 1:
            raise TypeError(f"{what}: counts must be one-element int32 tensors")
        if c.device != a.device:
            raise ValueError(f"{what}: counts must lie on the lanes' CUDA device")
    if b.device != a.device:
        raise ValueError(f"{what}: tensors on different devices")


def _launch(a, a_count, b, b_count, cap_a, out_capacity, pos, src, merged) -> None:
    global LAUNCHES
    fn = _FN or build()
    m, L = a.shape
    n = b.shape[0]
    args = (
        a.data_ptr(), a_count.data_ptr(), b.data_ptr(),
        None if b_count is None else b_count.data_ptr(),
        m, n, L, cap_a, out_capacity,
        None if pos is None else pos.data_ptr(),
        None if src is None else src.data_ptr(),
        None if merged is None else merged.data_ptr(),
    )
    dev = a.device
    if dev.index == torch.cuda.current_device():
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"merge_path launch failed: cudaError {rc}")
    LAUNCHES += 1
    LAUNCHES_BY_SHAPE[(m, n, out_capacity, L)] += 1


def search_right(
    a: torch.Tensor, a_count: torch.Tensor, b: torch.Tensor, b_count=None
) -> torch.Tensor:
    """For each row of ``b`` ([n, L] int64, stored lane form), the count
    of rows of ``a``'s valid prefix ``[0, a_count)`` ([m, L]) that are
    lexicographically <= it, as [n] int32 — the TPU kernel's function,
    launched on ``torch.cuda.current_stream()``. The counts are
    one-element int32 CUDA tensors, read on the device. ``b_count`` None
    means all n rows, which must then be sorted; otherwise the rows past
    it get -1."""
    _check("search_right", a, b, a_count, *(() if b_count is None else (b_count,)))
    m, n = a.shape[0], b.shape[0]
    if b_count is None:
        pos = torch.empty(n, dtype=torch.int32, device=b.device)
    else:
        pos = torch.full((n,), -1, dtype=torch.int32, device=b.device)
    if n:
        _launch(a, a_count, b, b_count, m, m + n, pos, None, None)
    return pos


def merge_path(
    a_lanes: torch.Tensor, a_count: torch.Tensor, cap_a: int,
    b_lanes: torch.Tensor, b_count: torch.Tensor, out_capacity: int,
    want_pos: bool = False,
):
    """The merged run of ``a_lanes[:a_count]`` and ``b_lanes[:b_count]``
    (sorted, stored lane form) in ``out_capacity`` slots: ``src``
    ([out_capacity] int64, an index into ``concat(a, b)``) and the merged
    lanes ([out_capacity, L] int64), bit for bit
    ``merge_source_map_torch``; with ``want_pos`` also each placed ``b``
    row's insertion point (``search_right``'s), -1 for the others. One
    launch on ``torch.cuda.current_stream()``."""
    _check("merge_path", a_lanes, b_lanes, a_count, b_count)
    m, L = a_lanes.shape
    n = b_lanes.shape[0]
    if cap_a != m:
        raise ValueError(f"merge_path: cap_a {cap_a} != a's {m} lane rows")
    if out_capacity > 0 and m == 0 and n == 0:
        raise ValueError("merge_path: no rows to fill the output from")
    dev = a_lanes.device
    src = torch.empty(out_capacity, dtype=torch.int64, device=dev)
    merged = torch.empty((out_capacity, L), dtype=torch.int64, device=dev)
    pos = torch.full((n,), -1, dtype=torch.int32, device=dev) if want_pos else None
    if out_capacity > 0:
        _launch(a_lanes, a_count, b_lanes, b_count, cap_a, out_capacity, pos, src, merged)
    return (src, merged, pos) if want_pos else (src, merged)
