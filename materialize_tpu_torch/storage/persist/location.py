"""Durability substrate traits: Blob and Consensus.

Analog of the reference's ``persist/src/location.rs`` (``Blob``:570,
``Consensus``:446): a durable key->bytes store for immutable batch parts,
and a linearizable versioned log for shard state. The reference backs
these with S3/Azure/file and Postgres/CRDB/FoundationDB; here the
production-shaped backends are filesystem blob + SQLite consensus (both
crash-safe on one host), with in-memory variants for tests and an
``UnreliableBlob`` fault-injection wrapper mirroring
``persist/src/unreliable.rs``.
"""

from __future__ import annotations

import os
import sqlite3
import tempfile
import threading
from dataclasses import dataclass


class Blob:
    """Durable key -> immutable bytes store (location.rs:570).

    Values are written once and never mutated; delete exists for GC.
    """

    def set(self, key: str, value: bytes) -> None:
        raise NotImplementedError

    def get(self, key: str) -> bytes | None:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def list_keys(self, prefix: str = "") -> list[str]:
        raise NotImplementedError


class MemBlob(Blob):
    def __init__(self):
        self._data: dict[str, bytes] = {}
        self._lock = threading.Lock()

    def set(self, key: str, value: bytes) -> None:
        with self._lock:
            self._data[key] = bytes(value)

    def get(self, key: str) -> bytes | None:
        with self._lock:
            return self._data.get(key)

    def delete(self, key: str) -> None:
        with self._lock:
            self._data.pop(key, None)

    def list_keys(self, prefix: str = "") -> list[str]:
        with self._lock:
            return sorted(k for k in self._data if k.startswith(prefix))


class FileBlob(Blob):
    """Filesystem-backed blob store with atomic writes (write temp +
    rename, fsync) — the crash-safety discipline of persist's file
    backend (persist/src/file.rs)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        # Keys may contain '/'; map to subdirectories. Reject escapes
        # (shard names flow into keys verbatim).
        p = os.path.join(self.root, key)
        root = os.path.realpath(self.root)
        if os.path.commonpath([os.path.realpath(p), root]) != root:
            raise ValueError(f"blob key escapes the store root: {key!r}")
        return p

    def set(self, key: str, value: bytes) -> None:
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path))
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(value)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def get(self, key: str) -> bytes | None:
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def delete(self, key: str) -> None:
        try:
            os.unlink(self._path(key))
        except FileNotFoundError:
            pass

    def list_keys(self, prefix: str = "") -> list[str]:
        out = []
        for dirpath, _dirs, files in os.walk(self.root):
            for fn in files:
                rel = os.path.relpath(os.path.join(dirpath, fn), self.root)
                rel = rel.replace(os.sep, "/")
                if rel.startswith(prefix):
                    out.append(rel)
        return sorted(out)


class ExternalDurabilityError(RuntimeError):
    """Injected / environmental durability-layer failure (retryable)."""


def retry_external(
    f, attempts: int | None = None, base_sleep: float | None = None
):
    """Retry transient durability-layer failures with jittered
    exponential backoff (the reference's ore::retry discipline). The
    shape comes from the unified ``retry_policy_durability`` dyncfg
    (utils/retry.py); explicit ``attempts``/``base_sleep`` arguments
    pin a local policy instead (tests)."""
    from ...utils.retry import RetryPolicy, policy

    if attempts is not None or base_sleep is not None:
        pol = RetryPolicy(
            base=base_sleep if base_sleep is not None else 0.01,
            attempts=attempts if attempts is not None else 8,
            jitter=0.0,
        )
    else:
        pol = policy("durability")
    return pol.retry(f, retryable=(ExternalDurabilityError,))


class UnreliableBlob(Blob):
    """Fault-injection wrapper (persist/src/unreliable.rs analog): fails a
    deterministic fraction of operations so retry loops get exercised."""

    def __init__(self, inner: Blob, fail_every: int = 3):
        self.inner = inner
        self.fail_every = fail_every
        self._op = 0

    def _maybe_fail(self):
        self._op += 1
        if self.fail_every and self._op % self.fail_every == 0:
            raise ExternalDurabilityError(
                f"injected blob failure (op {self._op})"
            )

    def set(self, key: str, value: bytes) -> None:
        self._maybe_fail()
        self.inner.set(key, value)

    def get(self, key: str) -> bytes | None:
        self._maybe_fail()
        return self.inner.get(key)

    def delete(self, key: str) -> None:
        self._maybe_fail()
        self.inner.delete(key)

    def list_keys(self, prefix: str = "") -> list[str]:
        return self.inner.list_keys(prefix)


@dataclass(frozen=True)
class VersionedData:
    """One consensus entry: a monotonically increasing sequence number and
    an opaque payload (the serialized shard state diff/snapshot)."""

    seqno: int
    data: bytes


class Consensus:
    """Linearizable per-key versioned log (location.rs:446).

    ``compare_and_set(key, expected, new)`` succeeds iff the key's head
    seqno equals ``expected`` (None for vacant); this is the only write
    path, so all state transitions are totally ordered per shard.
    """

    def head(self, key: str) -> VersionedData | None:
        raise NotImplementedError

    def compare_and_set(
        self, key: str, expected: int | None, new: VersionedData
    ) -> bool:
        raise NotImplementedError

    def scan(self, key: str, from_seqno: int) -> list[VersionedData]:
        raise NotImplementedError

    def truncate(self, key: str, below_seqno: int) -> None:
        """Drop entries with seqno < below_seqno (state GC)."""
        raise NotImplementedError


class MemConsensus(Consensus):
    def __init__(self):
        self._log: dict[str, list[VersionedData]] = {}
        self._lock = threading.Lock()

    def head(self, key: str) -> VersionedData | None:
        with self._lock:
            log = self._log.get(key)
            return log[-1] if log else None

    def compare_and_set(self, key, expected, new) -> bool:
        with self._lock:
            log = self._log.setdefault(key, [])
            head = log[-1].seqno if log else None
            if head != expected:
                return False
            assert new.seqno == (0 if expected is None else expected + 1)
            log.append(new)
            return True

    def scan(self, key, from_seqno) -> list[VersionedData]:
        with self._lock:
            return [
                v for v in self._log.get(key, []) if v.seqno >= from_seqno
            ]

    def truncate(self, key, below_seqno) -> None:
        with self._lock:
            log = self._log.get(key)
            if log:
                self._log[key] = [v for v in log if v.seqno >= below_seqno]


class SqliteConsensus(Consensus):
    """SQLite-backed consensus — the single-host stand-in for the
    reference's Postgres/CRDB consensus (persist/src/postgres.rs).
    Linearizability comes from SQLite's serialized transactions; the
    compare-and-set is one conditional INSERT."""

    def __init__(self, path: str):
        self.path = path
        self._local = threading.local()
        conn = self._conn()
        conn.execute(
            "CREATE TABLE IF NOT EXISTS consensus ("
            " key TEXT NOT NULL, seqno INTEGER NOT NULL, data BLOB NOT NULL,"
            " PRIMARY KEY (key, seqno))"
        )
        conn.commit()

    def _conn(self) -> sqlite3.Connection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = sqlite3.connect(self.path, timeout=30.0)
            conn.execute("PRAGMA journal_mode=WAL")
            conn.execute("PRAGMA synchronous=NORMAL")
            self._local.conn = conn
        return conn

    def head(self, key: str) -> VersionedData | None:
        row = self._conn().execute(
            "SELECT seqno, data FROM consensus WHERE key=? "
            "ORDER BY seqno DESC LIMIT 1",
            (key,),
        ).fetchone()
        return VersionedData(row[0], row[1]) if row else None

    def compare_and_set(self, key, expected, new) -> bool:
        """Insert ``new`` iff the head seqno is ``expected``: the check
        and the insert in one IMMEDIATE transaction (the write lock held
        from the check on). The reference checks outside the insert's
        transaction and leans on the primary key; beside the state GC's
        truncation that let a shard's upper go back (a source ticking
        beside readers and a compactor stalled on ``UpperMismatch``
        within seconds)."""
        conn = self._conn()
        try:
            conn.execute("BEGIN IMMEDIATE")
            try:
                row = conn.execute(
                    "SELECT MAX(seqno) FROM consensus WHERE key=?", (key,)
                ).fetchone()
                head = row[0] if row and row[0] is not None else None
                if head != expected:
                    conn.rollback()
                    return False
                conn.execute(
                    "INSERT INTO consensus (key, seqno, data) VALUES (?,?,?)",
                    (key, new.seqno, new.data),
                )
                conn.commit()
            except BaseException:
                conn.rollback()
                raise
            return True
        except sqlite3.IntegrityError:
            return False  # concurrent writer won the seqno

    def scan(self, key, from_seqno) -> list[VersionedData]:
        rows = self._conn().execute(
            "SELECT seqno, data FROM consensus WHERE key=? AND seqno>=? "
            "ORDER BY seqno",
            (key, from_seqno),
        ).fetchall()
        return [VersionedData(r[0], r[1]) for r in rows]

    def truncate(self, key, below_seqno) -> None:
        conn = self._conn()
        with conn:
            conn.execute(
                "DELETE FROM consensus WHERE key=? AND seqno<?",
                (key, below_seqno),
            )
