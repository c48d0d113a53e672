"""PostgreSQL wire protocol v3: the SQL front door.

Analog of the reference's ``src/pgwire`` (``protocol.rs:145 run()``,
``:847 StateMachine``): startup handshake, the simple-query protocol
(Query -> RowDescription/DataRow*/CommandComplete/ReadyForQuery), error
responses, and COPY in and out. SUBSCRIBE (streamed via COPY-out in the
reference) is not ported: the coordinator's error reaches the client. Text result format only
(the reference negotiates binary per column; text is always legal).
No TLS/SCRAM — SSLRequest is politely refused with 'N' (plaintext), as
the reference does when TLS is off.
"""

from __future__ import annotations

import socket
import struct
import threading
import traceback

from ..repr.schema import ColumnType
from ..utils.trace import TRACER

# PG type OIDs for the text protocol.
_OIDS = {
    ColumnType.BOOL: 16,
    ColumnType.INT32: 23,
    ColumnType.INT64: 20,
    ColumnType.FLOAT64: 701,
    ColumnType.DATE: 1082,
    ColumnType.TIMESTAMP: 20,  # virtual time: expose as int8
    ColumnType.DECIMAL: 1700,
    ColumnType.STRING: 25,
}

PROTOCOL_V3 = 196608
SSL_REQUEST = 80877103
CANCEL_REQUEST = 80877102


def _msg(tag: bytes, payload: bytes) -> bytes:
    return tag + struct.pack("!I", len(payload) + 4) + payload


def _error_code(e: Exception) -> str:
    """SQLSTATE for an execution error. Admission-control sheds
    (coord/peek.ServerBusy) map to 53400 (configuration_limit_exceeded
    family: insufficient resources, retryable) so clients can
    distinguish overload from query errors."""
    from ..coord.peek import ServerBusy

    return "53400" if isinstance(e, ServerBusy) else "XX000"


def _cstr(s: str) -> bytes:
    return s.encode() + b"\x00"


class _Prepared:
    """A named prepared statement (extended protocol Parse target)."""

    def __init__(self, sql: str, param_oids: tuple):
        self.sql = sql
        self.param_oids = param_oids
        self.nparams = _max_param(sql)


class _Portal:
    """A bound portal: statement + parameter values, partially
    executable with row limits (protocol.rs portal machinery)."""

    def __init__(self, sql: str):
        self.sql = sql
        self.result = None  # ExecuteResult once executed
        self.sent = 0  # rows already sent (Execute with maxrows)


def _max_param(sql: str) -> int:
    """Highest $N placeholder outside string literals."""
    import re

    n = 0
    in_str = False
    i = 0
    while i < len(sql):
        ch = sql[i]
        if ch == "'":
            in_str = not in_str
        elif not in_str and ch == "$":
            m = re.match(r"\$(\d+)", sql[i:])
            if m:
                n = max(n, int(m.group(1)))
                i += len(m.group(0))
                continue
        i += 1
    return n


# OID families for parameter typing (Parse's declared param_oids)
_NUMERIC_OIDS = {20, 21, 23, 26, 700, 701, 1700}
_TEXT_OIDS = {25, 1042, 1043, 18, 19}
_BOOL_OID = 16


def _substitute_params(
    sql: str, values: list, param_oids: tuple = ()
) -> str:
    """Inline bound parameter values as SQL literals ($N -> literal).
    The reference carries typed Datums through portals; the text
    protocol's values are re-parsed here. A parameter whose Parse
    message declared an OID is typed by it; undeclared (OID 0/absent)
    parameters fall back to a numeric-looking heuristic — ambiguous for
    text columns holding digit strings, in which case clients should
    declare OIDs (drivers that prepare with types do)."""
    import re

    def lit(idx, v):
        if v is None:
            return "NULL"
        s = v if isinstance(v, str) else v.decode()
        oid = param_oids[idx] if idx < len(param_oids) else 0
        if oid in _TEXT_OIDS:
            return "'" + s.replace("'", "''") + "'"
        if oid in _NUMERIC_OIDS:
            return s
        if oid == _BOOL_OID:
            return "true" if s.strip().lower() in (
                "t", "true", "1", "yes", "on"
            ) else "false"
        if re.fullmatch(r"-?\d+(\.\d+)?([eE][+-]?\d+)?", s):
            return s
        if s.lower() in ("true", "false"):
            return s
        return "'" + s.replace("'", "''") + "'"

    out, i, in_str = [], 0, False
    while i < len(sql):
        ch = sql[i]
        if ch == "'":
            in_str = not in_str
            out.append(ch)
            i += 1
            continue
        if not in_str and ch == "$":
            m = re.match(r"\$(\d+)", sql[i:])
            if m:
                idx = int(m.group(1)) - 1
                if idx >= len(values):
                    raise ValueError(f"parameter ${idx + 1} not bound")
                out.append(lit(idx, values[idx]))
                i += len(m.group(0))
                continue
        out.append(ch)
        i += 1
    return "".join(out)


class PgConnection:
    def __init__(self, sock: socket.socket, coordinator):
        self.sock = sock
        self.coord = coordinator
        self.alive = True
        self.prepared: dict[str, _Prepared] = {}
        self.portals: dict[str, _Portal] = {}
        self._skip_until_sync = False

    # -- low-level ----------------------------------------------------------
    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("client disconnected")
            buf += chunk
        return buf

    def _send(self, data: bytes) -> None:
        self.sock.sendall(data)

    # -- session ------------------------------------------------------------
    def run(self) -> None:
        try:
            if not self._startup():
                return
            self._ready()
            while self.alive:
                tag = self.sock.recv(1)
                if not tag:
                    return
                (length,) = struct.unpack("!I", self._recv_exact(4))
                payload = self._recv_exact(length - 4)
                if tag == b"Q":
                    self._handle_query(payload[:-1].decode())
                elif tag == b"X":
                    return
                elif tag == b"S":  # Sync: end of extended batch
                    self._skip_until_sync = False
                    self._ready()
                elif self._skip_until_sync:
                    continue  # drop messages until Sync after an error
                elif tag == b"P":
                    self._handle_parse(payload)
                elif tag == b"B":
                    self._handle_bind(payload)
                elif tag == b"D":
                    self._handle_describe(payload)
                elif tag == b"E":
                    self._handle_execute(payload)
                elif tag == b"C":
                    self._handle_close(payload)
                elif tag == b"H":  # Flush: all responses sent eagerly
                    pass
                else:
                    self._error("08P01", f"unknown message {tag!r}")
                    self._ready()
        except (ConnectionError, OSError):
            pass
        finally:
            self.sock.close()

    def _startup(self) -> bool:
        while True:
            (length,) = struct.unpack("!I", self._recv_exact(4))
            payload = self._recv_exact(length - 4)
            (code,) = struct.unpack("!I", payload[:4])
            if code == SSL_REQUEST:
                self._send(b"N")  # no TLS; client retries plaintext
                continue
            if code == CANCEL_REQUEST:
                return False
            if code != PROTOCOL_V3:
                self._error("08P01", f"unsupported protocol {code}")
                return False
            break
        # AuthenticationOk + minimal parameters + key data.
        self._send(_msg(b"R", struct.pack("!I", 0)))
        for k, v in (
            ("server_version", "9.5.0"),
            ("server_name", "materialize_tpu"),
            ("client_encoding", "UTF8"),
            ("DateStyle", "ISO"),
            ("integer_datetimes", "on"),
        ):
            self._send(_msg(b"S", _cstr(k) + _cstr(v)))
        self._send(_msg(b"K", struct.pack("!II", 0, 0)))
        return True

    def _ready(self) -> None:
        self._send(_msg(b"Z", b"I"))

    def _error(self, code: str, message: str) -> None:
        payload = (
            b"S" + _cstr("ERROR")
            + b"C" + _cstr(code)
            + b"M" + _cstr(message)
            + b"\x00"
        )
        self._send(_msg(b"E", payload))

    # -- queries ------------------------------------------------------------
    def _handle_query(self, sql: str) -> None:
        # One trace per STATEMENT (the statement
        # root uses the shared trace-context API, so coordinator /
        # controller / replica child spans all join this id space —
        # mz_trace_spans shows one tree per statement, not one blob
        # per simple-query batch).
        for stmt in _split_statements(sql):
            if not stmt.strip():
                self._send(_msg(b"I", b""))  # EmptyQueryResponse
                continue
            with TRACER.statement("pgwire.query", sql=stmt[:100]):
                try:
                    res = self.coord.execute(stmt)
                except Exception as e:  # planning/execution error
                    self._error(_error_code(e), str(e))
                    self._ready()
                    return
                try:
                    self._send_result(stmt, res)
                except BrokenPipeError:
                    raise
                except (ConnectionError, OSError):
                    raise
                except Exception as e:
                    # e.g. COPY parse failures / CopyFail: report and
                    # keep the session alive
                    self._error("XX000", str(e))
                    self._ready()
                    return
        self._ready()

    # -- extended protocol (protocol.rs extended-query state machine) ------
    def _ext_error(self, code: str, message: str) -> None:
        """Error inside an extended-protocol batch: report and discard
        messages until the Sync."""
        self._error(code, message)
        self._skip_until_sync = True

    def _handle_parse(self, payload: bytes) -> None:
        name, off = _read_cstr(payload, 0)
        sql, off = _read_cstr(payload, off)
        (noids,) = struct.unpack_from("!h", payload, off)
        off += 2
        oids = struct.unpack_from(f"!{noids}I", payload, off)
        try:
            stmts = [s for s in _split_statements(sql) if s.strip()]
            if len(stmts) > 1:
                raise ValueError(
                    "cannot prepare multiple statements at once"
                )
            self.prepared[name] = _Prepared(
                stmts[0] if stmts else "", tuple(oids)
            )
            self._send(_msg(b"1", b""))  # ParseComplete
        except Exception as e:
            self._ext_error("42601", str(e))

    def _handle_bind(self, payload: bytes) -> None:
        try:
            portal, off = _read_cstr(payload, 0)
            stmt_name, off = _read_cstr(payload, off)
            (nfmt,) = struct.unpack_from("!h", payload, off)
            off += 2
            fmts = struct.unpack_from(f"!{nfmt}h", payload, off)
            off += 2 * nfmt
            (nparams,) = struct.unpack_from("!h", payload, off)
            off += 2
            values = []
            for i in range(nparams):
                (ln,) = struct.unpack_from("!i", payload, off)
                off += 4
                if ln == -1:
                    values.append(None)
                else:
                    raw = payload[off : off + ln]
                    off += ln
                    fmt = fmts[i] if i < len(fmts) else (
                        fmts[0] if len(fmts) == 1 else 0
                    )
                    if fmt != 0:
                        raise ValueError(
                            "binary parameter format not supported"
                        )
                    values.append(raw.decode())
            # result formats: text (0) only
            (nrfmt,) = struct.unpack_from("!h", payload, off)
            off += 2
            rfmts = struct.unpack_from(f"!{nrfmt}h", payload, off)
            if any(f != 0 for f in rfmts):
                raise ValueError("binary result format not supported")
            ps = self.prepared.get(stmt_name)
            if ps is None:
                raise ValueError(
                    f"prepared statement {stmt_name!r} does not exist"
                )
            self.portals[portal] = _Portal(
                _substitute_params(ps.sql, values, ps.param_oids)
            )
            self._send(_msg(b"2", b""))  # BindComplete
        except Exception as e:
            self._ext_error("08P01", str(e))

    def _describe_results(self, sql: str) -> None:
        """RowDescription (or NoData) for a statement/portal by planning
        it without executing (Describe; the reference's describe path
        runs the planner's describe-only mode, sql/src/plan/statement.rs)."""
        from ..sql import parser as sqlparser
        from ..sql.plan import SelectPlan, plan_statement

        try:
            stmt = sqlparser.parse_statement(sql)
            plan = plan_statement(stmt, self.coord.catalog)
        except Exception:
            self._send(_msg(b"n", b""))  # NoData for unplannable here
            return
        if isinstance(plan, SelectPlan):
            self._row_description(plan.column_names, plan.expr.schema())
        else:
            self._send(_msg(b"n", b""))

    def _handle_describe(self, payload: bytes) -> None:
        kind = payload[0:1]
        name, _ = _read_cstr(payload, 1)
        if kind == b"S":
            ps = self.prepared.get(name)
            if ps is None:
                self._ext_error(
                    "26000", f"prepared statement {name!r} does not exist"
                )
                return
            # ParameterDescription: unknown params described as text
            oids = list(ps.param_oids) + [25] * (
                ps.nparams - len(ps.param_oids)
            )
            self._send(
                _msg(
                    b"t",
                    struct.pack("!h", len(oids))
                    + b"".join(struct.pack("!I", o) for o in oids),
                )
            )
            self._describe_results(
                _substitute_params(ps.sql, [None] * ps.nparams)
                if ps.nparams
                else ps.sql
            )
        elif kind == b"P":
            po = self.portals.get(name)
            if po is None:
                self._ext_error(
                    "34000", f"portal {name!r} does not exist"
                )
                return
            self._describe_results(po.sql)
        else:
            self._ext_error("08P01", f"bad describe kind {kind!r}")

    def _handle_execute(self, payload: bytes) -> None:
        name, off = _read_cstr(payload, 0)
        (maxrows,) = struct.unpack_from("!i", payload, off)
        po = self.portals.get(name)
        if po is None:
            self._ext_error("34000", f"portal {name!r} does not exist")
            return
        try:
            if po.result is None:
                if not po.sql.strip():
                    self._send(_msg(b"I", b""))  # EmptyQueryResponse
                    return
                with TRACER.statement(
                    "pgwire.execute", sql=po.sql[:100]
                ):
                    po.result = self.coord.execute(po.sql)
                po.sent = 0
            res = po.result
            if res.kind == "rows" and getattr(res, "copy_out", False):
                self._copy_out_rows(res)
            elif res.kind == "copy_in":
                self._copy_in(res)
            elif res.kind == "rows":
                schema = self._result_schema(res)
                rows = res.rows[po.sent :]
                if maxrows and maxrows > 0 and len(rows) > maxrows:
                    for row in rows[:maxrows]:
                        self._data_row(row, schema)
                    po.sent += maxrows
                    self._send(_msg(b"s", b""))  # PortalSuspended
                    return
                for row in rows:
                    self._data_row(row, schema)
                po.sent = len(res.rows)
                self._complete(f"SELECT {len(res.rows)}")
            elif res.kind == "subscription":
                res.subscription.close()
                self._ext_error(
                    "0A000",
                    "SUBSCRIBE requires the simple query protocol",
                )
            else:
                self._send_result(po.sql, res)
        except Exception as e:
            self._ext_error(_error_code(e), str(e))

    def _handle_close(self, payload: bytes) -> None:
        kind = payload[0:1]
        name, _ = _read_cstr(payload, 1)
        if kind == b"S":
            self.prepared.pop(name, None)
        else:
            self.portals.pop(name, None)
        self._send(_msg(b"3", b""))  # CloseComplete

    def _send_result(self, stmt: str, res) -> None:
        if res.kind == "rows" and getattr(res, "copy_out", False):
            self._copy_out_rows(res)
        elif res.kind == "rows":
            schema = self._result_schema(res)
            self._row_description(res.columns, schema)
            for row in res.rows:
                self._data_row(row, schema)
            self._complete(f"SELECT {len(res.rows)}")
        elif res.kind == "copy_in":
            self._copy_in(res)
        elif res.kind == "text":
            self._row_description(res.columns or ("explain",), None)
            for line in res.text.split("\n"):
                self._data_row((line,), None)
            self._complete("EXPLAIN")
        elif res.kind == "subscription":
            self._stream_subscription(res)
        else:
            verb = stmt.strip().split()[0].upper()
            self._complete(
                f"INSERT 0 {res.affected}" if verb == "INSERT" else verb
            )

    def _result_schema(self, res):
        # Column types: taken from the plan when available; text is a
        # safe fallback for the wire's text format.
        return getattr(res, "schema", None)

    def _row_description(self, columns, schema) -> None:
        parts = [struct.pack("!H", len(columns))]
        for i, name in enumerate(columns):
            oid = 25
            if schema is not None and i < len(schema.columns):
                oid = _OIDS.get(schema.columns[i].ctype, 25)
            parts.append(
                _cstr(str(name))
                + struct.pack("!IhIhih", 0, 0, oid, -1, -1, 0)
            )
        self._send(_msg(b"T", b"".join(parts)))

    def _data_row(self, row, schema) -> None:
        parts = [struct.pack("!H", len(row))]
        for v in row:
            if v is None:
                parts.append(struct.pack("!i", -1))
            else:
                if isinstance(v, bool):
                    s = "t" if v else "f"
                else:
                    s = str(v)
                b = s.encode()
                parts.append(struct.pack("!i", len(b)) + b)
        self._send(_msg(b"D", b"".join(parts)))

    def _complete(self, tag: str) -> None:
        self._send(_msg(b"C", _cstr(tag)))

    def _copy_out_rows(self, res) -> None:
        """COPY (query) TO STDOUT: rows in pg text format."""
        n = len(res.columns)
        self._send(
            _msg(b"H", struct.pack("!bh", 0, n) + b"\x00\x00" * n)
        )
        lines = []
        for row in res.rows:
            lines.append(
                "\t".join(_copy_text_field(v) for v in row) + "\n"
            )
        if lines:
            self._send(_msg(b"d", "".join(lines).encode()))
        self._send(_msg(b"c", b""))  # CopyDone
        self._complete(f"COPY {len(res.rows)}")

    def _copy_in(self, res) -> None:
        """COPY table FROM STDIN: CopyInResponse, then CopyData until
        CopyDone/CopyFail (text format)."""
        n = len(res.columns)
        self._send(
            _msg(b"G", struct.pack("!bh", 0, n) + b"\x00\x00" * n)
        )
        chunks: list = []
        saw_sync = False
        while True:
            tag = self._recv_exact(1)
            (length,) = struct.unpack("!I", self._recv_exact(4))
            payload = self._recv_exact(length - 4)
            if tag == b"d":
                chunks.append(payload)
            elif tag == b"c":  # CopyDone
                break
            elif tag == b"f":  # CopyFail
                raise ValueError(
                    "COPY aborted by client: "
                    + payload.rstrip(b"\x00").decode()
                )
            elif tag == b"S":
                # a pipelined Sync (extended-protocol batch) arrives
                # before the copy stream: owe its ReadyForQuery after
                # the copy completes
                saw_sync = True
            elif tag == b"H":  # Flush: no-op
                continue
            else:
                raise ValueError(
                    f"unexpected message {tag!r} during COPY"
                )
        rows = []
        text = b"".join(chunks).decode()
        lines = text.split("\n")
        if lines and lines[-1] == "":
            lines.pop()  # artifact of the terminating newline ONLY —
            # interior empty lines are real single-column empty strings
        for line in lines:
            if line == "\\.":
                continue
            rows.append(
                [
                    None if f == "\\N" else _copy_unescape(f)
                    for f in line.split("\t")
                ]
            )
        count = self.coord.copy_in_rows(res.table, res.columns, rows)
        self._complete(f"COPY {count}")
        if saw_sync:
            self._skip_until_sync = False
            self._ready()

    def _stream_subscription(self, res) -> None:
        """SUBSCRIBE over the COPY-out subprotocol needs the reference's
        fan-out hub; the port's coordinator raises before any
        subscription exists, and that error reaches the client."""
        raise NotImplementedError(
            "SUBSCRIBE is not ported (ROADMAP Queue 1 item 6b: "
            "coord/subscribe.py)"
        )

_COPY_ESCAPES = {
    "\\": "\\",
    "t": "\t",
    "n": "\n",
    "r": "\r",
    "b": "\b",
    "f": "\f",
    "v": "\v",
}


def _copy_unescape(field: str) -> str:
    if "\\" not in field:
        return field
    out, i = [], 0
    while i < len(field):
        ch = field[i]
        if ch == "\\" and i + 1 < len(field):
            out.append(_COPY_ESCAPES.get(field[i + 1], field[i + 1]))
            i += 2
        else:
            out.append(ch)
            i += 1
    return "".join(out)


def _copy_text_field(v) -> str:
    if v is None:
        return "\\N"
    if isinstance(v, bool):
        return "t" if v else "f"
    s = str(v)
    return (
        s.replace("\\", "\\\\")
        .replace("\t", "\\t")
        .replace("\n", "\\n")
        .replace("\r", "\\r")
    )


def _read_cstr(buf: bytes, off: int) -> tuple:
    end = buf.index(b"\x00", off)
    return buf[off:end].decode(), end + 1


def _split_statements(sql: str) -> list[str]:
    """Split on ';' outside string literals (simple-query batches)."""
    out, cur, in_str = [], [], False
    for ch in sql:
        if ch == "'":
            in_str = not in_str
            cur.append(ch)
        elif ch == ";" and not in_str:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if "".join(cur).strip():
        out.append("".join(cur))
    return out


class PgServer:
    """TCP acceptor: one thread per connection (server-core analog)."""

    def __init__(self, coordinator, host: str = "127.0.0.1", port: int = 0):
        self.coord = coordinator
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind((host, port))
        self.sock.listen(16)
        self.port = self.sock.getsockname()[1]
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._accept, daemon=True)

    def start(self) -> "PgServer":
        self._thread.start()
        return self

    def _accept(self) -> None:
        self.sock.settimeout(0.2)
        while not self._stop.is_set():
            try:
                conn, _ = self.sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True
            ).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            PgConnection(conn, self.coord).run()
        except Exception:
            traceback.print_exc()

    def stop(self) -> None:
        self._stop.set()
        self.sock.close()
