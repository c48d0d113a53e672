"""Native (C++) host-side kernels, loaded via ctypes.

``mtnative.cpp`` is the port's own copy of the reference's host C++
(CRC32C, the zigzag varint codec, the host lexsort and
``consolidate_i64``). It is compiled with ``g++`` at FIRST USE, not at
import, into the git-ignored ``materialize_tpu_torch/_build/`` (named by
a hash of the source and flags, as the CUDA kernel is), and loaded with
ctypes; with a program bank configured (``compile/bank.py``) the library
is looked up there first and stored there after a build.

Unlike the reference, a failed build raises: there is no silent numpy
fallback on the serving path. The numpy versions below (``*_plain``) are
the plain versions the tests hold the library against.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = Path(__file__).resolve().parent / "mtnative.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_lib = None
_LOCK = threading.Lock()


def build_key() -> tuple:
    """The library's compile-ledger and program-bank key: ("g++", the
    source and flags fingerprint, the host's machine)."""
    import platform

    from ..utils.compile_ledger import source_fingerprint

    return "g++", source_fingerprint(SOURCE.read_bytes(), CXX_FLAGS), platform.machine()


def _compile(digest: str) -> tuple:
    """Compile (or reuse) the shared library; returns its path and
    whether it was built now, and keeps the build's seconds beside it.
    Raises ``RuntimeError`` when g++ fails or is missing."""
    from ..compile.bank import write_build_seconds

    so_path = BUILD_DIR / f"libmtnative-{digest}.so"
    if so_path.exists():
        return so_path, False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # Per-process tmp name: concurrent first builds (test workers) must
    # not interleave writes into one file.
    tmp = so_path.with_suffix(f".so.tmp{os.getpid()}")
    try:
        proc = subprocess.run(
            ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
            capture_output=True, text=True, timeout=120,
        )
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"building {SOURCE.name} with g++ failed: {e!r}") from e
    if proc.returncode != 0:
        raise RuntimeError(
            f"building {SOURCE.name} with g++ failed ({proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    write_build_seconds(so_path, time.perf_counter() - t0)
    os.replace(tmp, so_path)
    return so_path, True


def lib():
    """The loaded library, built on first call."""
    global _lib
    if _lib is not None:
        return _lib
    with _LOCK:
        if _lib is None:
            from ..compile.bank import fetch_library

            t0 = time.perf_counter()
            kind, digest, target = build_key()
            path, cache, attrs = fetch_library(kind, SOURCE.name, digest, target,
                                               "mtn_crc32c", "g++",
                                               lambda: _compile(digest))
            so = ctypes.CDLL(str(path))
            so.mtn_crc32c.restype = ctypes.c_uint32
            so.mtn_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
            so.mtn_vbyte_encode_i64.restype = ctypes.c_int64
            so.mtn_vbyte_encode_i64.argtypes = [
                ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t,
            ]
            so.mtn_vbyte_decode_i64.restype = ctypes.c_int64
            so.mtn_vbyte_decode_i64.argtypes = [
                ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t,
            ]
            so.mtn_lexsort_i64.restype = None
            so.mtn_lexsort_i64.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t, ctypes.c_void_p,
            ]
            so.mtn_consolidate_i64.restype = ctypes.c_int64
            so.mtn_consolidate_i64.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_size_t, ctypes.c_void_p, ctypes.c_void_p,
            ]
            _lib = so
            from ..utils.compile_ledger import LEDGER

            LEDGER.record(kind, SOURCE.name, digest, target, time.perf_counter() - t0,
                          cache=cache, **attrs)
    return _lib


def crc32c(data: bytes) -> int:
    return lib().mtn_crc32c(data, len(data))


def vbyte_encode_i64(a: np.ndarray) -> bytes:
    """Zigzag varint delta encoding of an int64 array."""
    a = np.ascontiguousarray(a, np.int64)
    n = len(a)
    cap = 10 * n + 16
    out = np.empty(cap, np.uint8)
    written = lib().mtn_vbyte_encode_i64(a.ctypes.data, n, out.ctypes.data, cap)
    if written < 0:
        raise ValueError("vbyte encode overflowed its buffer")
    return out[:written].tobytes()


def vbyte_decode_i64(data: bytes, n: int) -> np.ndarray:
    out = np.empty(n, np.int64)
    buf = np.frombuffer(data, np.uint8)
    consumed = lib().mtn_vbyte_decode_i64(
        buf.ctypes.data if len(buf) else None, len(buf), out.ctypes.data, n,
    )
    if consumed < 0:
        raise ValueError("malformed vbyte stream")
    return out


def lexsort_i64(cols: list) -> np.ndarray:
    """Stable lexicographic sort permutation; cols most-significant
    first (np.lexsort order is the reverse)."""
    n = len(cols[0]) if cols else 0
    if n == 0:
        return np.zeros(0, np.int64)
    arrs = [np.ascontiguousarray(c, np.int64) for c in cols]
    ptrs = (ctypes.c_void_p * len(arrs))(*[a.ctypes.data for a in arrs])
    perm = np.empty(n, np.int64)
    lib().mtn_lexsort_i64(ptrs, len(arrs), n, perm.ctypes.data)
    return perm


def consolidate_i64(key_cols: list, diffs: np.ndarray) -> tuple:
    """Host consolidation: returns (row_indices, summed_diffs) for each
    distinct key with nonzero total diff (differential's
    consolidate_updates)."""
    n = len(diffs)
    if n == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    arrs = [np.ascontiguousarray(c, np.int64) for c in key_cols]
    d = np.ascontiguousarray(diffs, np.int64)
    ptrs = (ctypes.c_void_p * len(arrs))(*[a.ctypes.data for a in arrs])
    out_rows = np.empty(n, np.int64)
    out_diffs = np.empty(n, np.int64)
    k = lib().mtn_consolidate_i64(
        ptrs, len(arrs), d.ctypes.data, n, out_rows.ctypes.data, out_diffs.ctypes.data,
    )
    return out_rows[:k].copy(), out_diffs[:k].copy()


# -- plain versions (numpy / Python): what the tests hold the library to --

_CRC_TABLE: list = []


def crc32c_plain(data: bytes) -> int:
    if not _CRC_TABLE:
        for i in range(256):
            c = i
            for _ in range(8):
                c = (0x82F63B78 ^ (c >> 1)) if c & 1 else (c >> 1)
            _CRC_TABLE.append(c)
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def vbyte_encode_i64_plain(a: np.ndarray) -> bytes:
    # Deltas wrap mod 2^64 before zigzag, as in the C++.
    mask = (1 << 64) - 1
    out = bytearray()
    prev = 0
    for v in np.asarray(a, np.int64).tolist():
        d = (v - prev) & mask
        z = ((d << 1) & mask) ^ (mask if d >> 63 else 0)
        prev = v
        while True:
            b = z & 0x7F
            z >>= 7
            out.append(b | (0x80 if z else 0))
            if not z:
                break
    return bytes(out)


def vbyte_decode_i64_plain(data: bytes, n: int) -> np.ndarray:
    out = np.empty(n, np.int64)
    pos = 0
    prev = 0
    for i in range(n):
        z = 0
        shift = 0
        while True:
            if pos >= len(data) or shift > 63:
                raise ValueError("malformed vbyte stream")
            byte = data[pos]
            pos += 1
            z |= (byte & 0x7F) << shift
            if not byte & 0x80:
                break
            shift += 7
        prev += (z >> 1) ^ -(z & 1)
        prev = (prev + (1 << 63)) % (1 << 64) - (1 << 63)
        out[i] = prev
    return out


def consolidate_i64_plain(key_cols: list, diffs: np.ndarray) -> tuple:
    n = len(diffs)
    if n == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    arrs = [np.asarray(c, np.int64) for c in key_cols]
    perm = np.lexsort(arrs[::-1])
    new_run = np.ones(n, bool)
    new_run[1:] = False
    for c in (c[perm] for c in arrs):
        new_run[1:] |= c[1:] != c[:-1]
    group = np.cumsum(new_run) - 1
    sums = np.zeros(int(group[-1]) + 1, np.int64)
    np.add.at(sums, group, np.asarray(diffs, np.int64)[perm])
    firsts = perm[new_run]
    keep = sums != 0
    return firsts[keep], sums[keep]
