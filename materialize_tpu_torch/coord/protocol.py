"""Control-plane transport: the CTP analog.

The reference's CTP (``service/src/transport.rs:10-21``) is
bincode-serialized, length-prefixed messages with heartbeating over
TCP/UDS, single active client per server, nonce-based epoch fencing
(``ComputeCommand::Hello`` ``protocol/command.rs:45-53``). The analog
here: length-prefixed frames carrying pickled command/response dicts with
a native CRC32C integrity check, over TCP; one active controller per
replica; a strictly increasing ``nonce`` fences stale controllers.

Pickle is the bincode analog for this *internal, trusted* link between
our own processes (never exposed to users; the SQL front end has its own
wire protocol).

Command set (``compute-client/src/protocol/command.rs:38-45``):
  Hello{nonce}, CreateInstance, CreateDataflow, Schedule, Peek,
  CancelPeek, AllowCompaction, UpdateConfiguration
Response set (``protocol/response.rs:29``):
  HelloOk/HelloReject, Frontiers, PeekResponse, SubscribeResponse, Status
"""

from __future__ import annotations

import io
import pickle
import socket
import struct
from dataclasses import dataclass, field
from typing import Any

from .. import native

FRAME_MAGIC = b"MTC1"
MAX_FRAME = 1 << 30


class TransportError(RuntimeError):
    pass


def hard_close(sock: socket.socket) -> None:
    """Close a socket that ANOTHER thread may be blocked reading.

    A bare ``close()`` is deferred by CPython while a sibling thread
    sits in ``recv`` on the same socket object (``_io_refs``): the fd
    never actually closes, the peer never sees FIN, and the blocked
    reader never wakes — a fenced replica session then leaves its old
    controller hanging "connected" forever (found by the
    chaos harness: frame-kill storms wedged exactly here).
    ``shutdown(SHUT_RDWR)`` takes effect immediately regardless of
    concurrent readers, waking them with EOF; the close then lands.

    The interleaving explorer keeps this wedge as a standing
    regression fixture: ``analysis/interleave.WedgeModel`` rediscovers
    it exhaustively on a bare ``close()`` (one-step minimal schedule)
    and proves every schedule through THIS function wakes the reader
    (tests/test_interleave.py)."""
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


def send_frame(sock: socket.socket, payload: bytes) -> None:
    header = FRAME_MAGIC + struct.pack(
        "<II", len(payload), native.crc32c(payload)
    )
    sock.sendall(header + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = io.BytesIO()
    got = 0
    while got < n:
        chunk = sock.recv(n - got)
        if not chunk:
            raise TransportError("connection closed")
        buf.write(chunk)
        got += len(chunk)
    return buf.getvalue()


def recv_frame(sock: socket.socket) -> bytes:
    header = _recv_exact(sock, 12)
    if header[:4] != FRAME_MAGIC:
        raise TransportError("bad frame magic")
    length, crc = struct.unpack("<II", header[4:])
    if length > MAX_FRAME:
        raise TransportError(f"oversized frame: {length}")
    payload = _recv_exact(sock, length)
    if native.crc32c(payload) != crc:
        raise TransportError("frame crc mismatch")
    return payload


def send_msg(sock: socket.socket, msg: Any) -> None:
    send_frame(sock, pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL))


def recv_msg(sock: socket.socket) -> Any:
    return pickle.loads(recv_frame(sock))


# ---------------------------------------------------------------------------
# Dataflow descriptions shipped over the wire
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PersistLocation:
    """Where a replica finds the durability substrate (subprocess-able
    config; in-process tests may inject client objects instead)."""

    blob_root: str
    consensus_path: str


@dataclass(frozen=True)
class DataflowDescription:
    """What to build (compute-types/src/dataflows.rs:32 analog): MIR to
    render, source shard imports, and exports — an index (peekable
    in-replica arrangement) and/or an MV sink shard."""

    name: str
    expr: Any  # mir.RelationExpr
    source_imports: dict  # input name -> (shard_name, Schema)
    sink_shard: str | None = None
    # input name -> (publisher dataflow name, Schema): the input is the
    # device-resident output arrangement of an already-installed
    # dataflow (index import — TraceManager sharing,
    # compute/src/arrangement/manager.rs:33 + render.rs:384-403);
    # hydration snapshots the live arrangement instead of replaying the
    # publisher's sources, and steady-state deltas are pushed
    # step-by-step.
    index_imports: dict = field(default_factory=dict)
    # Explicit hydration timestamp (SELECT/SUBSCRIBE ... AS OF t): the
    # view hydrates its inputs at exactly t instead of as-of selection's
    # latest readable time (compute-client/src/as_of_selection.rs when
    # an AS OF is user-specified). Inputs must be readable at t.
    as_of: "int | None" = None

    def fingerprint(self) -> bytes:
        return pickle.dumps(
            (
                self.name,
                self.expr,
                sorted(self.source_imports.items()),
                self.sink_shard,
                sorted(self.index_imports.items()),
                self.as_of,
            ),
            protocol=pickle.HIGHEST_PROTOCOL,
        )


# ---------------------------------------------------------------------------
# Command / response constructors (dicts keep the wire format trivial)
# ---------------------------------------------------------------------------


def hello(nonce: int) -> dict:
    return {"kind": "Hello", "nonce": nonce}


def with_trace(cmd: dict, trace: dict | None) -> dict:
    """Attach a statement trace context (``{"t": trace_id, "s":
    span_id}``, utils/trace.py) to a command so the replica's child
    spans join the SAME tree (the OpenTelemetryContext-riding-commands
    pattern). None is a no-op — replayed history and
    untraced paths ship no context."""
    if trace:
        cmd["trace"] = trace
    return cmd


def create_dataflow(
    desc: DataflowDescription, trace: dict | None = None
) -> dict:
    return with_trace({"kind": "CreateDataflow", "desc": desc}, trace)


def drop_dataflow(name: str) -> dict:
    return {"kind": "DropDataflow", "name": name}


def peek(
    peek_id: int, dataflow: str, as_of: int | None, exact: bool = False,
    trace: dict | None = None,
) -> dict:
    """``exact`` = serve at exactly ``as_of`` (AS OF semantics: rewind
    inside the multiversion window); default serves the latest complete
    result once the frontier passes ``as_of``."""
    return with_trace(
        {
            "kind": "Peek", "peek_id": peek_id, "dataflow": dataflow,
            "as_of": as_of, "exact": exact,
        },
        trace,
    )


def peek_lookup(
    peek_id: int, dataflow: str, as_of: int | None, spec: dict,
    trace: dict | None = None,
) -> dict:
    """A BATCHED fast-path peek (coord/peek.py): ``spec`` carries
    {"scan": bool, "bound_cols": tuple, "probes": [...]} — N sessions'
    stacked lookups against one maintained index, served by a single
    device gather once the dataflow's frontier passes ``as_of``. The
    response's ``rows_groups`` aligns with ``probes`` (one shared group
    for scans)."""
    return with_trace(
        {
            "kind": "Peek", "peek_id": peek_id, "dataflow": dataflow,
            "as_of": as_of, "exact": False, "lookup": spec,
        },
        trace,
    )


def cancel_peek(peek_id: int) -> dict:
    return {"kind": "CancelPeek", "peek_id": peek_id}


def allow_compaction(dataflow: str, since: int) -> dict:
    return {"kind": "AllowCompaction", "dataflow": dataflow, "since": since}


def update_configuration(params: dict) -> dict:
    return {"kind": "UpdateConfiguration", "params": params}


def frontiers(
    uppers: dict,
    records: dict,
    span_epochs: dict,
    replica_id: str,
    donation: dict | None = None,
    sharding: dict | None = None,
    recovery: dict | None = None,
    spans: list | None = None,
    compiles: list | None = None,
    metrics: list | None = None,
    arrangement_bytes: dict | None = None,
    freshness: dict | None = None,
    swaps: dict | None = None,
    compactions: dict | None = None,
) -> dict:
    """Replica -> controller frontier report. ``span_epochs`` carries
    each dataflow's monotone COMMITTED span counter (the
    pipelined control plane commits frontiers once per span, and
    peeks/compaction sequence against span boundaries — the counter
    is the boundary identity a coordinator can reason about without
    another round trip). ``donation`` piggybacks each dataflow's
    buffer-provenance/donation verdict whenever it changed —
    the EXPLAIN ANALYSIS and mz_donation surface, shipped only on
    change so steady state pays nothing. ``sharding`` piggybacks the
    shard-spec prover's report (SPMD-safety verdict, resolved
    ingest mode, communication census) the same way — the EXPLAIN
    ANALYSIS ``sharding:`` and mz_sharding surface. ``recovery``
    piggybacks each dataflow's install/rebuild/reconcile counters
    whenever they change — the mz_recovery surface that
    makes reconciliation a counted invariant (rebuilds == 0 across a
    controller restart with unchanged fingerprints). ``spans`` /
    ``compiles`` / ``metrics`` piggyback the observability plane:
    completed trace spans (wire tuples, utils/trace.py),
    compile-ledger records (utils/compile_ledger.py), and the
    replica's /metrics sample families — each shipped only when
    nonempty/changed, so steady state with tracing off pays nothing.
    ``arrangement_bytes`` carries per-dataflow device-resident bytes
    by spine component (runs/slots/lanes/history) alongside the row
    counts in ``records`` — the mz_arrangement_sizes surface.
    ``freshness`` piggybacks the freshness plane:
    ``{"status": {dataflow: hydration entry}}`` ships on every report
    path when a status transitioned (the controller's per-(dataflow,
    replica) board absorbs it), and ``{"lag": [wire records]}``
    carries wallclock-lag observations from subprocess replicas only
    (in-process replicas share the process-global recorder; the
    controller pid-dedupes shipped copies). ``swaps`` piggybacks
    async-compile hot-swap transitions (
    ``{dataflow: {"state": pending|swapped|swap-failed, ...}}``),
    shipped only on change — the EXPLAIN ANALYSIS ``pending_swap``
    and mz_program_bank surface. ``compactions`` piggybacks the
    counted compaction stats of shards this replica's compactor
    touched (``{shard: stats row}``, dirty-set — subprocess
    replicas only; in-process ones share the process-global registry)
    — the mz_compactions surface."""
    msg = {
        "kind": "Frontiers",
        "uppers": uppers,
        "records": records,
        "span_epochs": span_epochs,
        "replica_id": replica_id,
    }
    if donation:
        msg["donation"] = donation
    if sharding:
        msg["sharding"] = sharding
    if recovery:
        msg["recovery"] = recovery
    if spans:
        msg["spans"] = spans
    if compiles:
        msg["compiles"] = compiles
    if metrics:
        msg["metrics"] = metrics
    if arrangement_bytes:
        msg["arrangement_bytes"] = arrangement_bytes
    if freshness:
        msg["freshness"] = freshness
    if swaps:
        msg["swaps"] = swaps
    if compactions:
        msg["compactions"] = compactions
    return msg
