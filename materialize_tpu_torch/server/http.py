"""HTTP endpoints: SQL-over-HTTP, metrics, readiness, SSE SUBSCRIBE.

Analog of the reference's ``environmentd/src/http``: POST /api/sql
executes statements and returns JSON results; GET /metrics serves the
Prometheus registry; GET /api/readyz for probes; GET/POST
/api/subscribe streams a SUBSCRIBE as Server-Sent Events off the
fan-out hub. Stdlib http.server — the control plane is not
a throughput surface, but SSE sessions are hub-woken (event-driven),
so idle streams cost nothing between spans.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from ..utils.metrics import REGISTRY


def make_handler(coordinator):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def _reply(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _webhook(self, name: str) -> None:
            """POST /api/webhook/<source>: body {"rows": [[...], ...]},
            an array of rows [[...], ...], or one flat row [...]
            (webhook sources, adapter/src/webhook.rs analog)."""
            n = int(self.headers.get("Content-Length", 0))
            try:
                body = json.loads(self.rfile.read(n) or b"{}")
                if isinstance(body, dict) and "rows" in body:
                    rows = body["rows"]
                elif isinstance(body, list):
                    if not body:
                        rows = []  # empty batch: appended 0
                    elif isinstance(body[0], list):
                        rows = body
                    else:
                        rows = [body]  # one flat row
                else:
                    raise ValueError(
                        'expected {"rows": [[...], ...]}, an array of '
                        "rows, or one flat row array"
                    )
                count = coordinator.append_webhook(name, rows)
                self._reply(
                    200,
                    json.dumps({"appended": count}).encode(),
                    "application/json",
                )
            except Exception as e:
                from ..sql.hir import PlanError

                code = (
                    400
                    if isinstance(
                        e, (PlanError, ValueError, json.JSONDecodeError)
                    )
                    else 500
                )
                body = json.dumps({"error": str(e)}).encode()
                self._reply(code, body, "application/json")

        def _subscribe_sse(self, sql: str) -> None:
            """GET/POST /api/subscribe: stream a SUBSCRIBE as
            Server-Sent Events. Each hub chunk becomes one `data:`
            message `{"events": [[vals..., time, diff], ...],
            "progress": frontier}` (plus `"snapshot": true` for state
            transfers); keepalive comments flush every 15s so a dead
            client surfaces as a write failure. Admission sheds are
            503; slow-consumer disconnects end the stream with an
            `event: error` message."""
            from ..coord.peek import ServerBusy
            from ..coord.subscribe import SubscriptionLagging

            if not sql:
                self._reply(
                    400,
                    json.dumps(
                        {"error": "missing SUBSCRIBE query"}
                    ).encode(),
                    "application/json",
                )
                return
            # Validate BEFORE executing: /api/subscribe must never
            # run a non-SUBSCRIBE statement (a GET carrying an INSERT
            # would otherwise commit the write and then report 400 —
            # state-changing "errors" break retry semantics).
            try:
                from ..sql import ast as sqlast
                from ..sql import parser as sqlparser

                stmt = sqlparser.parse_statement(sql)
                if not isinstance(stmt, sqlast.Subscribe):
                    raise ValueError(
                        "/api/subscribe requires a SUBSCRIBE "
                        "statement"
                    )
            except Exception as e:
                self._reply(
                    400,
                    json.dumps({"error": str(e)}).encode(),
                    "application/json",
                )
                return
            try:
                res = coordinator.execute(sql)
            except ServerBusy as e:
                self._reply(
                    503,
                    json.dumps({"error": str(e)}).encode(),
                    "application/json",
                )
                return
            except Exception as e:
                self._reply(
                    400,
                    json.dumps({"error": str(e)}).encode(),
                    "application/json",
                )
                return
            if res.kind != "subscription":
                self._reply(
                    400,
                    json.dumps(
                        {
                            "error": "/api/subscribe requires a "
                            "SUBSCRIBE statement"
                        }
                    ).encode(),
                    "application/json",
                )
                return
            sub = res.subscription
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()
            import select

            wake = sub.wake_socket()
            conn = self.connection
            try:
                self.wfile.write(
                    b": subscribed columns="
                    + ",".join(map(str, res.columns)).encode()
                    + b"\n\n"
                )
                self.wfile.flush()
                while True:
                    # Drain BEFORE selecting (chunks enqueued before
                    # the wake fd existed — the join snapshot — have
                    # no wake byte to select on) and BEFORE honoring
                    # `closed`: a hub-reaped lagging session still
                    # owes the client its error (raised by pop_ready),
                    # not a clean end-of-stream.
                    for kind, events, frontier, _st in sub.pop_ready():
                        payload = {
                            "events": [list(e) for e in events],
                            "progress": frontier,
                        }
                        if kind == "snapshot":
                            payload["snapshot"] = True
                        self.wfile.write(
                            b"data: "
                            + json.dumps(
                                payload, default=str
                            ).encode()
                            + b"\n\n"
                        )
                        self.wfile.flush()
                    if sub.closed:
                        return
                    # Event-driven, like the pgwire COPY-out loop: a
                    # committed span wakes via the session fd, a
                    # client close wakes via the connection (EOF —
                    # SSE clients never send mid-stream, so ANY
                    # inbound readability is teardown).
                    ready, _, _ = select.select(
                        [conn, wake], [], [], 15.0
                    )
                    if conn in ready:
                        return
                    if wake in ready:
                        try:
                            while wake.recv(4096):
                                pass
                        except (BlockingIOError, OSError):
                            pass
                    if not ready:
                        # Liveness probe: a half-open (unreachable,
                        # never-FIN'd) client fails this write.
                        self.wfile.write(b": keepalive\n\n")
                        self.wfile.flush()
            except SubscriptionLagging as e:
                try:
                    self.wfile.write(
                        b"event: error\ndata: "
                        + json.dumps({"error": str(e)}).encode()
                        + b"\n\n"
                    )
                    self.wfile.flush()
                except (BrokenPipeError, ConnectionError, OSError):
                    pass
            except (BrokenPipeError, ConnectionError, OSError):
                pass
            finally:
                sub.close()

        def do_GET(self):
            if self.path.startswith("/api/subscribe"):
                qs = parse_qs(urlparse(self.path).query)
                self._subscribe_sse(
                    (qs.get("query") or [""])[0].strip()
                )
                return
            if self.path == "/metrics":
                # ONE scrape covers the deployment: the
                # local registry merged with every replica's last
                # piggybacked snapshot, remote samples labeled
                # replica="<name>" (utils/metrics.cluster_exposition).
                from ..utils.metrics import cluster_exposition

                with coordinator.controller._lock:
                    remote = dict(
                        coordinator.controller.replica_metrics
                    )
                self._reply(
                    200,
                    cluster_exposition(REGISTRY, remote).encode(),
                    "text/plain; version=0.0.4",
                )
            elif self.path == "/api/livez":
                # Liveness: the process answers HTTP. Always 200 —
                # restarts are decided by readiness, not liveness.
                self._reply(200, b"live\n", "text/plain")
            elif self.path == "/api/readyz":
                # Readiness (the freshness plane): 200 only
                # when the coordinator's health verdict says catalog
                # replay succeeded, some replica is connected, every
                # durable dataflow hydrated, and lag is under the SLO;
                # otherwise 503 with the full JSON verdict — the
                # machine-checkable "ready" for `environmentd
                # --recover` drives and rolling restarts.
                verdict = coordinator.health()
                self._reply(
                    200 if verdict["ready"] else 503,
                    (json.dumps(verdict) + "\n").encode(),
                    "application/json",
                )
            else:
                self._reply(404, b"not found\n", "text/plain")

        def do_POST(self):
            if self.path.startswith("/api/webhook/"):
                self._webhook(self.path[len("/api/webhook/"):])
                return
            if self.path.startswith("/api/subscribe"):
                n = int(self.headers.get("Content-Length", 0))
                try:
                    body = json.loads(self.rfile.read(n) or b"{}")
                    sql = str(body.get("query", "")).strip()
                except Exception:
                    sql = ""
                self._subscribe_sse(sql)
                return
            if self.path != "/api/sql":
                self._reply(404, b"not found\n", "text/plain")
                return
            n = int(self.headers.get("Content-Length", 0))
            try:
                req = json.loads(self.rfile.read(n) or b"{}")
                queries = req.get("query")
                if isinstance(queries, str):
                    from .pgwire import _split_statements

                    queries = [
                        q for q in _split_statements(queries)
                        if q.strip()
                    ]
                from ..utils.trace import TRACER

                results = []
                for q in queries or []:
                    with TRACER.statement("http.query", sql=q[:100]):
                        res = coordinator.execute(q)
                    if res.kind == "rows":
                        results.append(
                            {
                                "tag": f"SELECT {len(res.rows)}",
                                "columns": list(res.columns),
                                "rows": [list(r) for r in res.rows],
                            }
                        )
                    elif res.kind == "text":
                        results.append(
                            {"tag": "EXPLAIN", "text": res.text}
                        )
                    elif res.kind == "copy_in":
                        results.append(
                            {
                                "error": "COPY FROM STDIN is not "
                                "supported over HTTP; use pgwire"
                            }
                        )
                    elif res.kind == "subscription":
                        res.subscription.close()
                        results.append(
                            {
                                "error": "SUBSCRIBE over /api/sql "
                                "cannot stream; use the "
                                "/api/subscribe SSE endpoint"
                            }
                        )
                    else:
                        results.append({"tag": "OK"})
                # default=str: exact decimal.Decimal values serialize as
                # their text form (pg's numeric-over-json behavior)
                body = json.dumps(
                    {"results": results}, default=str
                ).encode()
                self._reply(200, body, "application/json")
            except Exception as e:
                from ..coord.peek import ServerBusy
                from ..sql.hir import PlanError
                from ..sql.parser import ParseError

                # Client mistakes are 400; admission-control sheds are
                # 503 (retryable overload); execution faults (peek
                # timeouts, internal errors) are the server's 500.
                if isinstance(e, ServerBusy):
                    code = 503
                elif isinstance(
                    e, (PlanError, ParseError, json.JSONDecodeError)
                ):
                    code = 400
                else:
                    code = 500
                body = json.dumps({"error": str(e)}).encode()
                self._reply(code, body, "application/json")

    return Handler


class HttpServer:
    def __init__(self, coordinator, host="127.0.0.1", port=0):
        self._srv = ThreadingHTTPServer(
            (host, port), make_handler(coordinator)
        )
        self.port = self._srv.server_address[1]
        self._thread = threading.Thread(
            target=self._srv.serve_forever, daemon=True
        )

    def start(self) -> "HttpServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()
