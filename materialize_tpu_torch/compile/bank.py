"""The program bank over the port's native libraries (the port of
``materialize_tpu/compile/bank.py``).

The reference's bank is a directory of serialized PJRT executables, so
that a recovery boot deserializes instead of recompiling. The port's
compiled artefacts are its native libraries: ``csrc/merge_path.cu``,
built by nvcc for ``sm_90a`` (``ops/merge_kernel.py:build``), and
``native/mtnative.cpp``, built by g++ (``native/__init__.py:lib``).
One entry is one library:

- **Key.** The compile ledger's ``(kind, fingerprint, tier)``: ``nvcc``
  or ``g++``; the digest of the source and flags
  (``utils/compile_ledger.py:source_fingerprint``); the target
  (``sm_90a``, or the host's machine for g++).
- **Layout.** A directory per key holding ``lib.so`` and ``meta.json``
  (the stamp, the library's sha256, its name, and the seconds of the
  build that made it, which a hit recovers).
- **Stamp.** torch's version, the CUDA runtime's, the compiler's and,
  for device code, the card's capability. A skewed entry is skipped
  (a miss) and kept: another deployment may still own it.
- **Verified.** A store loads the copy with ``ctypes`` and resolves its
  entry symbol before it publishes it; a lookup checks the sha256 and
  does the same before it serves it. A corrupt entry is unlinked and
  counted as a miss.
- **Atomic.** An entry is written under a temporary name and renamed
  into place, so concurrent processes (a deployment's replica processes
  share its bank) never see half of one.

A bank that cannot be read or written raises: it never turns into a
silent rebuild. ``configure_bank`` / ``get_bank`` and the
``MZ_PROGRAM_BANK`` environment variable set it up, as the reference's
do; ``environmentd`` puts it at ``<data-dir>/blob/program_bank``.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import threading
import time as _time

# Bump when the entry layout changes: old-format entries are skipped.
BANK_FORMAT = 1

# Subprocess replicas inherit the bank location through the environment.
BANK_ENV_VAR = "MZ_PROGRAM_BANK"

_LIB = "lib.so"
_META = "meta.json"
_STAMP_KEYS = ("format", "torch", "cuda", "compiler", "capability")

_VERSIONS: dict = {}
_VERSIONS_LOCK = threading.Lock()


def _entry_dirname(kind: str, fingerprint: str, tier: str) -> str:
    def safe(s: str) -> str:
        return "".join(c if (c.isalnum() or c in "._-") else "_" for c in s)

    return f"{safe(kind)}__{safe(fingerprint)}__{safe(tier)}"


def compiler_version(compiler: str) -> str:
    """The compiler's version line (cached per process): nvcc's
    ``release`` line, g++'s first line; ``missing`` without one."""
    with _VERSIONS_LOCK:
        if compiler in _VERSIONS:
            return _VERSIONS[compiler]
    try:
        proc = subprocess.run([compiler, "--version"], capture_output=True, text=True,
                              timeout=60)
        lines = [ln.strip() for ln in proc.stdout.splitlines() if ln.strip()]
    except (OSError, subprocess.SubprocessError):
        lines = []
    rel = [ln for ln in lines if "release" in ln]
    version = (rel or lines or ["missing"])[0]
    with _VERSIONS_LOCK:
        _VERSIONS[compiler] = version
    return version


def environment_stamp(kind: str, compiler: str) -> dict:
    """What an entry must match to be served in this process."""
    import torch

    capability = "host"
    if kind == "nvcc" and torch.cuda.is_available():
        capability = "sm_%d%d" % torch.cuda.get_device_capability()
    return {
        "format": BANK_FORMAT,
        "torch": torch.__version__,
        "cuda": torch.version.cuda or "",
        "compiler": compiler_version(compiler),
        "capability": capability,
    }


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _loads(path: str, symbol: str) -> bool:
    """Whether ``ctypes`` loads the library and resolves ``symbol``."""
    try:
        getattr(ctypes.CDLL(path), symbol)
    except (OSError, AttributeError):
        return False
    return True


class ProgramBank:
    """One bank directory. Thread-safe; cheap to construct."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        from ..utils.lockcheck import tracked_lock

        # A leaf lock: taken by both build sites and the compile worker.
        self._lock = tracked_lock("compile.bank")
        self.stats = {
            "hits": 0,  # entries served
            "misses": 0,  # lookups that found no usable entry
            "stores": 0,  # entries written
            "damaged": 0,  # corrupt entries unlinked (each also a miss)
            "skipped": 0,  # skewed entries kept (each also a miss)
            "seconds_recovered": 0.0,  # build seconds the hits skipped
        }

    def _count(self, **incs) -> None:
        with self._lock:
            for k, v in incs.items():
                self.stats[k] += v

    # -- key paths ---------------------------------------------------------
    def path_for(self, kind: str, fingerprint: str, tier: str) -> str:
        """The entry's directory."""
        return os.path.join(self.root, _entry_dirname(kind, fingerprint, tier))

    # -- lookup / store ----------------------------------------------------
    def lookup(self, kind: str, fingerprint: str, tier: str, symbol: str,
               compiler: str):
        """(path of the entry's library, its meta) or None. The library
        has been loaded and its ``symbol`` resolved before it is served.
        Raises ``OSError`` when the bank cannot be read."""
        path = self.path_for(kind, fingerprint, tier)
        try:
            with open(os.path.join(path, _META)) as f:
                meta = json.load(f)
        except FileNotFoundError:
            if os.path.isdir(path):
                self._damaged(path)
            else:
                self._count(misses=1)
            return None
        except ValueError:
            self._damaged(path)
            return None
        if not isinstance(meta, dict) or "sha256" not in meta:
            self._damaged(path)
            return None
        env = environment_stamp(kind, compiler)
        if any(meta.get(k) != env[k] for k in _STAMP_KEYS):
            self._count(misses=1, skipped=1)
            return None
        lib = os.path.join(path, _LIB)
        try:
            ok = _sha256(lib) == meta["sha256"] and _loads(lib, symbol)
        except FileNotFoundError:
            ok = False
        if not ok:
            self._damaged(path)
            return None
        self._count(hits=1, seconds_recovered=float(meta.get("seconds", 0.0)))
        return lib, meta

    def store(self, kind: str, fingerprint: str, tier: str, lib_path: str,
              symbol: str, compiler: str, seconds: float = 0.0,
              name: str = "") -> str:
        """Copy a built library into the bank (atomic: a temporary
        directory renamed into place, after the copy loaded). ``seconds``
        is the build's, which a later hit recovers. Returns the entry's
        library path; raises when the bank cannot be written or the copy
        does not load."""
        path = self.path_for(kind, fingerprint, tier)
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        try:
            lib = os.path.join(tmp, _LIB)
            shutil.copyfile(lib_path, lib)
            if not _loads(lib, symbol):
                raise RuntimeError(
                    f"program bank: {lib_path} does not load or lacks {symbol!r}")
            meta = {
                **environment_stamp(kind, compiler),
                "kind": kind,
                "fingerprint": fingerprint,
                "tier": tier,
                "name": name,
                "symbol": symbol,
                "sha256": _sha256(lib),
                "seconds": float(seconds),
                "stored_at": _time.time(),
            }
            with open(os.path.join(tmp, _META), "w") as f:
                json.dump(meta, f)
            if os.path.exists(path):
                # A skewed or concurrent entry under the same key: the
                # one verified here replaces it.
                old = f"{tmp}.old"
                os.rename(path, old)
                shutil.rmtree(old)
            os.rename(tmp, path)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._count(stores=1)
        return os.path.join(path, _LIB)

    def _damaged(self, path: str) -> None:
        self._count(misses=1, damaged=1)
        try:
            shutil.rmtree(path)
        except FileNotFoundError:
            pass

    # -- introspection (mz_program_bank) -----------------------------------
    def entries(self) -> list:
        """Per-entry metadata (without loading anything); directories
        without a readable meta are skipped."""
        out = []
        for fn in sorted(os.listdir(self.root)):
            path = os.path.join(self.root, fn)
            if ".tmp." in fn or not os.path.isdir(path):
                continue
            try:
                with open(os.path.join(path, _META)) as f:
                    meta = json.load(f)
                st = os.stat(os.path.join(path, _LIB))
            except (OSError, ValueError):
                continue
            out.append({
                "kind": meta.get("kind", ""),
                "name": meta.get("name", ""),
                "fingerprint": meta.get("fingerprint", ""),
                "tier": meta.get("tier", ""),
                "bytes": int(st.st_size),
                "seconds": float(meta.get("seconds", 0.0)),
                "stored_at": float(meta.get("stored_at", st.st_mtime)),
            })
        return out

    def snapshot(self) -> dict:
        """Counters and the entry census: the recovery report's view."""
        with self._lock:
            stats = dict(self.stats)
        ents = self.entries()
        stats["entries"] = len(ents)
        stats["bytes"] = sum(e["bytes"] for e in ents)
        stats["seconds_recovered"] = round(stats["seconds_recovered"], 3)
        return stats


# -- the build sites' path through the bank ----------------------------------


def build_seconds_path(lib_path) -> str:
    """Where a ``_build/`` library's build seconds are kept."""
    return f"{lib_path}.seconds"


def write_build_seconds(lib_path, seconds: float) -> None:
    tmp = f"{build_seconds_path(lib_path)}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(repr(float(seconds)))
    os.replace(tmp, build_seconds_path(lib_path))


def read_build_seconds(lib_path) -> float:
    """The seconds of the build that made a ``_build/`` library (0.0
    where none were kept)."""
    try:
        with open(build_seconds_path(lib_path)) as f:
            return float(f.read())
    except (OSError, ValueError):
        return 0.0


def fetch_library(kind: str, name: str, fingerprint: str, tier: str, symbol: str,
                  compiler: str, build) -> tuple:
    """The library a build site loads: ``(path, cache, ledger attrs)``.
    Without a bank, ``build()`` (which returns the ``_build/`` path and
    whether it built now) decides. With one, a hit serves the bank's
    copy (cache ``bank_hit``); a miss takes ``build()``'s library and
    stores it (attrs ``bank="miss"``)."""
    bank = get_bank()
    if bank is None:
        path, built = build()
        return path, "miss" if built else "hit", {}
    t0 = _time.perf_counter()
    got = bank.lookup(kind, fingerprint, tier, symbol, compiler)
    lookup_ms = (_time.perf_counter() - t0) * 1e3
    if got is not None:
        path, meta = got
        return path, "bank_hit", {"recovered_seconds": float(meta.get("seconds", 0.0)),
                                  "lookup_ms": lookup_ms}
    path, built = build()
    t1 = _time.perf_counter()
    bank.store(kind, fingerprint, tier, str(path), symbol, compiler,
               seconds=read_build_seconds(path), name=name)
    return path, "miss" if built else "hit", {
        "bank": "miss", "lookup_ms": lookup_ms,
        "store_ms": (_time.perf_counter() - t1) * 1e3}


# -- the process-global bank -------------------------------------------------
BANK: ProgramBank | None = None
_resolved = False


def configure_bank(path: str | None) -> ProgramBank | None:
    """Point this process at a bank directory (None disables)."""
    global BANK, _resolved
    _resolved = True
    BANK = ProgramBank(path) if path else None
    return BANK


def get_bank() -> ProgramBank | None:
    """The configured bank, resolving ``MZ_PROGRAM_BANK`` once on first
    use (subprocess replicas inherit it)."""
    global BANK, _resolved
    if not _resolved:
        _resolved = True
        path = os.environ.get(BANK_ENV_VAR)
        if path:
            BANK = ProgramBank(path)
    return BANK
