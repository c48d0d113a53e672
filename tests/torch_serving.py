"""Shared pieces of the serving-path parity tests (``test_torch_persist``,
``test_torch_coordinator``, ``test_torch_pgwire``): a per-test deadline,
one torch intra-op thread, an in-process cluster of either package, and
a minimal PostgreSQL wire client.

The reference package runs under the suite's JAX CPU platform
(``tests/conftest.py``); the port's replica runs with ``device="cpu"``.
"""

from __future__ import annotations

import faulthandler
import importlib
import signal
import socket
import struct
import threading

import pytest
import torch

# Per-test deadline: a hang fails the one test (and prints every
# thread's stack) instead of holding a test worker until the suite's
# own time limit.
DEADLINE_S = 120
SOCKET_TIMEOUT_S = 10.0
JOIN_TIMEOUT_S = 10.0


def _arm(what: str):
    faulthandler.dump_traceback_later(DEADLINE_S, exit=False)

    def on_alarm(signum, frame):
        raise TimeoutError(f"{what} exceeded its {DEADLINE_S} s deadline")

    old = signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(DEADLINE_S)
    return old


def _disarm(old) -> None:
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)
    faulthandler.cancel_dump_traceback_later()


@pytest.fixture(autouse=True)
def deadline(request):
    old = _arm(request.node.nodeid)
    try:
        yield
    finally:
        _disarm(old)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Eager torch on one intra-op thread: it does not contend with the
    other test processes or with XLA's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PKGS = {"ref": "materialize_tpu", "port": "materialize_tpu_torch"}


def mod(pkg: str, name: str):
    """``materialize_tpu.<name>`` or ``materialize_tpu_torch.<name>``."""
    return importlib.import_module(f"{PKGS[pkg]}.{name}")


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class Cluster:
    """One replica thread, a persist location and a coordinator of one
    package (``tests/test_coordinator.py``'s fixture, for either
    package). The port's replica runs on the CPU."""

    def __init__(self, pkg: str, root: str, device: str = "cpu"):
        self.pkg = pkg
        protocol = mod(pkg, "coord.protocol")
        replica = mod(pkg, "coord.replica")
        self.loc = protocol.PersistLocation(f"{root}/blob", f"{root}/consensus.db")
        self.port = free_port()
        ready = threading.Event()
        self._handle: list = []
        kw = {"handle": self._handle}
        if pkg == "port":
            kw["device"] = device
        self._thread = threading.Thread(
            target=replica.serve_forever,
            args=(self.port, self.loc, "r0", ready), kwargs=kw, daemon=True,
        )
        self._thread.start()
        assert ready.wait(SOCKET_TIMEOUT_S), "replica did not start"
        self.coords: list = []

    def coordinator(self):
        coordinator = mod(self.pkg, "coord.coordinator")
        persist = mod(self.pkg, "storage.persist")
        c = coordinator.Coordinator(
            persist.PersistClient(
                persist.FileBlob(self.loc.blob_root),
                persist.SqliteConsensus(self.loc.consensus_path),
            ),
            tick_interval=None,  # manual ticks: deterministic tests
        )
        c.add_replica("r0", ("127.0.0.1", self.port))
        self.coords.append(c)
        return c

    def shutdown(self) -> None:
        for c in self.coords:
            c.shutdown()
        self.coords = []
        for w in self._handle:
            w.stop()
        self._thread.join(JOIN_TIMEOUT_S)
        assert not self._thread.is_alive(), "replica thread did not stop"


def outcome(coord, stmt):
    """(kind, sorted rows, columns, affected) of a statement, or its
    error (type and text); a ("tick", source, n) entry ticks by hand."""
    if isinstance(stmt, tuple):
        _, name, n = stmt
        for _ in range(n):
            coord.sources[name].tick_once()
        return ("tick", name, n)
    try:
        r = coord.execute(stmt)
    except Exception as e:  # noqa: BLE001 - the error IS the outcome
        return ("error", type(e).__name__, str(e))
    return (r.kind, sorted(r.rows, key=repr), tuple(r.columns), r.affected)


def run_script(pkg: str, root: str, script: list, reads: list) -> tuple:
    """The script's outcomes and then the reads', on a fresh cluster."""
    cl = Cluster(pkg, root)
    try:
        coord = cl.coordinator()
        return [outcome(coord, s) for s in script], [outcome(coord, s) for s in reads]
    finally:
        cl.shutdown()


def boot_and_read(root: str, reads: list) -> tuple:
    """The port's cluster over a data directory another cluster wrote:
    its recovery report and the reads' outcomes."""
    cl = Cluster("port", root)
    try:
        coord = cl.coordinator()
        return dict(coord.recovery), [outcome(coord, s) for s in reads]
    finally:
        cl.shutdown()


class MiniPg:
    """A minimal PostgreSQL v3 client (``tests/test_server.py``'s, which
    also returns each error's SQLSTATE)."""

    def __init__(self, port: int):
        self.sock = socket.create_connection(("127.0.0.1", port), SOCKET_TIMEOUT_S)
        self.sock.settimeout(SOCKET_TIMEOUT_S)
        payload = struct.pack("!I", 196608) + b"user\x00test\x00\x00"
        self.sock.sendall(struct.pack("!I", len(payload) + 4) + payload)
        self.params = {}
        self._read_until_ready()

    def _recv_exact(self, n):
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            assert chunk, "server closed"
            buf += chunk
        return buf

    def read_msg(self):
        tag = self._recv_exact(1)
        (length,) = struct.unpack("!I", self._recv_exact(4))
        return tag, self._recv_exact(length - 4)

    def _read_until_ready(self):
        msgs = []
        while True:
            tag, payload = self.read_msg()
            msgs.append((tag, payload))
            if tag == b"S":
                k, v = payload.split(b"\x00")[:2]
                self.params[k.decode()] = v.decode()
            if tag == b"Z":
                return msgs

    @staticmethod
    def _data_row(payload):
        (n,) = struct.unpack("!H", payload[:2])
        off = 2
        row = []
        for _ in range(n):
            (ln,) = struct.unpack("!i", payload[off: off + 4])
            off += 4
            if ln == -1:
                row.append(None)
            else:
                row.append(payload[off: off + ln].decode())
                off += ln
        return tuple(row)

    @staticmethod
    def _error(payload):
        fields = {f[:1]: f[1:].decode() for f in payload.split(b"\x00") if f}
        return fields.get(b"C"), fields.get(b"M")

    def send(self, tag: bytes, payload: bytes):
        self.sock.sendall(tag + struct.pack("!I", len(payload) + 4) + payload)

    def query(self, sql: str):
        """(columns, rows, (sqlstate, message) | None, complete tag)."""
        self.send(b"Q", sql.encode() + b"\x00")
        return self.collect()

    def collect(self):
        columns, rows, error, tag_text = [], [], None, None
        for tag, payload in self._read_until_ready():
            if tag == b"T":
                (n,) = struct.unpack("!H", payload[:2])
                off = 2
                for _ in range(n):
                    end = payload.index(b"\x00", off)
                    columns.append(payload[off:end].decode())
                    off = end + 1 + 18
            elif tag == b"D":
                rows.append(self._data_row(payload))
            elif tag == b"E":
                error = self._error(payload)
            elif tag == b"C":
                tag_text = payload[:-1].decode()
        return columns, rows, error, tag_text

    def extended(self, sql: str, params: list, maxrows: int = 0, param_oids: tuple = ()):
        """One Parse/Bind/Describe/Execute/Sync round trip: (tags, rows,
        error)."""
        cstr = lambda s: s.encode() + b"\x00"  # noqa: E731
        parse = cstr("") + cstr(sql) + struct.pack("!h", len(param_oids))
        for o in param_oids:
            parse += struct.pack("!I", o)
        self.send(b"P", parse)
        bind = cstr("") + cstr("") + struct.pack("!h", 0) + struct.pack("!h", len(params))
        for p in params:
            if p is None:
                bind += struct.pack("!i", -1)
            else:
                b = str(p).encode()
                bind += struct.pack("!i", len(b)) + b
        bind += struct.pack("!h", 0)
        self.send(b"B", bind)
        self.send(b"D", b"P" + cstr(""))
        self.send(b"E", cstr("") + struct.pack("!i", maxrows))
        self.send(b"S", b"")
        tags, rows, error = [], [], None
        for tag, payload in self._read_until_ready():
            tags.append(tag)
            if tag == b"D":
                rows.append(self._data_row(payload))
            elif tag == b"E":
                error = self._error(payload)
        return tags, rows, error

    def close(self):
        try:
            self.send(b"X", b"")
        finally:
            self.sock.close()
