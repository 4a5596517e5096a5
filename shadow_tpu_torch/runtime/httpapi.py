"""HTTP front door for the durable daemon: `shadow-tpu serve --http
HOST:PORT` (docs/service.md "HTTP front door").

The spool-file drop is the daemon's only admission path — and that is
the point: this module adds a NETWORK door without adding a second
admission path. Every ``POST /v1/jobs`` body lands in ``incoming/``
through the identical atomic write-then-rename the CLI submitter uses,
so HTTP submissions inherit the whole journal-crash-safety story
(admission WAL, idempotent digests, SIGKILL-loses-zero-jobs) for free.
Reads come off the daemon's journal-backed state mirrors; the event
stream rides the existing ``on_rows`` flight-recorder seam via the
service's ``_on_progress`` pub-sub.

Endpoints (all JSON unless noted)::

    POST /v1/jobs                 spec YAML/JSON body -> 202 + job ids
                                  (400 parse, 409 duplicate entry,
                                   429 quota-class + Retry-After)
    GET  /v1/jobs/{id}            status: queued/running/terminal
    GET  /v1/jobs/{id}/results    sim-stats.json once terminal (409
                                  while running, 404 when absent)
    GET  /v1/jobs/{id}/events     chunked ndjson progress stream,
                                  closed by a terminal sentinel
    GET  /v1/metrics              the prom textfile, scrape-ready

Errors are structured JSON mirroring the ``.reason.json`` refusal
records: refusals that gate admission (parse / duplicate / quota-class)
are journaled ``reject`` records returned verbatim under ``error``;
purely informational errors (404/409/503) use the same
``{reason, detail}`` shape without a journal write. stdlib
``http.server`` only — ThreadingHTTPServer, one handler thread per
connection, no new dependencies. The ``http-drop`` chaos fault
(runtime/chaos.py) drops a request with a structured 503 at ordinal
``at`` — the soak story's network half.
"""

from __future__ import annotations

import json
import os
import queue
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import yaml

from shadow_tpu_torch.utils.shadow_log import slog

# job ids become path components under SPOOL/jobs/: first char
# alphanumeric, so a traversal component ("..", ".hidden") never matches
_JOB_ID_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,160}$")

_MAX_BODY_BYTES = 4_000_000


def parse_http_addr(addr: str) -> "tuple[str, int]":
    host, _, port = str(addr).rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(
            f"http address {addr!r} must be HOST:PORT (port 0 binds an "
            "ephemeral port, published in the spool's http-address file)"
        )
    return host, int(port)


class FrontDoor:
    """The daemon-owned HTTP server: started inside DaemonService.run()
    on a background thread, stopped in its finally. Request/latency
    counters feed the daemon's prom gauge set
    (shadow_tpu_http_requests_total{route,code} and the
    shadow_tpu_http_latency_seconds summary)."""

    def __init__(self, daemon, addr: str):
        self.daemon = daemon
        self.host, self.port = parse_http_addr(addr)
        self.server: "ThreadingHTTPServer | None" = None
        self.thread: "threading.Thread | None" = None
        self.bound: "str | None" = None
        self.closing = False
        self._lock = threading.Lock()
        self._requests: "dict[tuple[str, int], int]" = {}
        self._latencies: "list[float]" = []
        self._latency_sum = 0.0
        self._latency_count = 0
        self._req_ord = 0

    # --- lifecycle -------------------------------------------------------

    def start(self) -> None:
        front = self

        class Handler(_Handler):
            pass

        Handler.front = front
        self.server = ThreadingHTTPServer((self.host, self.port), Handler)
        self.server.daemon_threads = True
        host, port = self.server.server_address[:2]
        self.bound = f"{host}:{port}"
        # discovery file: --http HOST:0 binds an ephemeral port, and
        # clients (tests, submit --wait --http) read the bound address
        # here instead of guessing
        path = os.path.join(self.daemon.spool_dir, "http-address")
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(self.bound + "\n")
        os.replace(tmp, path)
        self.thread = threading.Thread(
            target=self.server.serve_forever, name="httpapi", daemon=True
        )
        self.thread.start()
        slog("info", 0, "daemon",
             f"HTTP front door listening on {self.bound} "
             f"(daemon {self.daemon.daemon_id})")

    def stop(self) -> None:
        self.closing = True  # unblocks event streams within a poll tick
        if self.server is not None:
            self.server.shutdown()
            self.server.server_close()
        if self.thread is not None:
            self.thread.join(timeout=5)

    # --- telemetry -------------------------------------------------------

    def next_ord(self) -> int:
        with self._lock:
            o = self._req_ord
            self._req_ord += 1
            return o

    def observe(self, route: str, code: int, seconds: float) -> None:
        with self._lock:
            key = (route, int(code))
            self._requests[key] = self._requests.get(key, 0) + 1
            self._latencies.append(seconds)
            del self._latencies[:-512]
            self._latency_sum += seconds
            self._latency_count += 1

    def gauges(self) -> dict:
        """The front door's prom families, merged into the daemon's
        gauge set (write_prom keeps one TYPE line per family)."""
        from shadow_tpu_torch.runtime.daemon import _percentiles

        g: dict = {}
        with self._lock:
            for (route, code), n in sorted(self._requests.items()):
                g[
                    "shadow_tpu_http_requests_total"
                    f'{{route="{route}",code="{code}"}}'
                ] = n
            pct = _percentiles(self._latencies)
            for p, q in (("p50", "0.5"), ("p90", "0.9"), ("p99", "0.99")):
                if p in pct:
                    g[
                        f'shadow_tpu_http_latency_seconds{{quantile="{q}"}}'
                    ] = pct[p]
            g["shadow_tpu_http_latency_seconds_sum"] = round(
                self._latency_sum, 6
            )
            g["shadow_tpu_http_latency_seconds_count"] = self._latency_count
        return g

    def describe(self) -> dict:
        with self._lock:
            return {
                "address": self.bound,
                "requests_total": sum(self._requests.values()),
            }


class _Handler(BaseHTTPRequestHandler):
    front: FrontDoor  # set per FrontDoor.start()
    protocol_version = "HTTP/1.1"
    server_version = "shadow-tpu"

    def log_message(self, fmt, *args):  # noqa: A002 — stdlib signature
        pass  # request accounting goes through front.observe, not stderr

    def do_GET(self):
        self._dispatch("GET")

    def do_POST(self):
        self._dispatch("POST")

    # --- plumbing --------------------------------------------------------

    def _dispatch(self, method: str) -> None:
        t0 = time.perf_counter()
        route, code = "other", 0
        try:
            route, code = self._route(method)
        except (BrokenPipeError, ConnectionResetError):
            code = 499  # client went away mid-response
            self.close_connection = True
        except Exception as e:  # noqa: BLE001 — one bad request must
            # never take a handler thread (or the daemon) down
            try:
                code = self._error(500, "internal", str(e)[:300])
            except OSError:
                code = 500
        finally:
            self.front.observe(route, code, time.perf_counter() - t0)

    def _route(self, method: str) -> "tuple[str, int]":
        from shadow_tpu_torch.runtime import chaos

        parts = [
            p for p in self.path.split("?", 1)[0].split("/") if p
        ]
        route, handler, jid = "other", None, None
        if parts[:1] == ["v1"]:
            if parts[1:] == ["jobs"]:
                route = "/v1/jobs"
                handler = self._post_jobs if method == "POST" else None
            elif parts[1:] == ["metrics"]:
                route = "/v1/metrics"
                handler = self._get_metrics if method == "GET" else None
            elif len(parts) in (3, 4) and parts[1] == "jobs":
                jid = parts[2]
                sub = parts[3] if len(parts) == 4 else None
                if sub is None:
                    route = "/v1/jobs/{id}"
                    handler = self._get_status if method == "GET" else None
                elif sub in ("results", "events"):
                    route = f"/v1/jobs/{{id}}/{sub}"
                    if method == "GET":
                        handler = (
                            self._get_results if sub == "results"
                            else self._get_events
                        )
        # the chaos seam sits where a flaky LB would: after routing (the
        # metric label is honest), before any state is touched
        if chaos.fire("http-drop", at=self.front.next_ord()) is not None:
            return route, self._error(
                503, "http-drop",
                "injected fault: request dropped by the chaos plane",
                retry_after_s=1,
            )
        if handler is None:
            return route, self._error(
                404 if route == "other" else 405,
                "no-route",
                f"{method} {self.path} is not a front-door endpoint",
            )
        if jid is not None and not _JOB_ID_RE.match(jid):
            return route, self._error(
                400, "bad-job-id",
                f"job id {jid!r} is not a canonical tenant.entry-sN name",
            )
        return route, handler(jid) if jid is not None else handler()

    def _send_json(self, code: int, doc: dict,
                   headers: "dict | None" = None) -> int:
        data = json.dumps(doc, indent=2, default=str).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        for k, v in (headers or {}).items():
            self.send_header(k, str(v))
        self.end_headers()
        self.wfile.write(data)
        return code

    def _error(self, code: int, reason: str, detail: str,
               **extra) -> int:
        headers = {}
        if "retry_after_s" in extra:
            headers["Retry-After"] = max(1, int(extra["retry_after_s"]))
        return self._send_json(
            code,
            {"error": {"reason": reason, "detail": detail, **extra}},
            headers=headers,
        )

    def _refusal(self, code: int, rec: dict) -> int:
        """A journaled reject record as the response body — the HTTP
        mirror of the spool's .reason.json reply files."""
        headers = {}
        if rec.get("retry_after_s") is not None:
            headers["Retry-After"] = max(1, int(rec["retry_after_s"]))
        return self._send_json(code, {"error": rec}, headers=headers)

    def _chunk(self, doc: dict) -> None:
        data = (json.dumps(doc) + "\n").encode()
        self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")
        self.wfile.flush()

    # --- endpoints -------------------------------------------------------

    def _post_jobs(self) -> int:
        d = self.front.daemon
        try:
            length = int(self.headers.get("Content-Length") or 0)
        except ValueError:
            length = 0
        if length <= 0 or length > _MAX_BODY_BYTES:
            return self._error(
                400, "parse",
                "request body must be a spool spec "
                f"(1..{_MAX_BODY_BYTES} bytes of YAML or JSON)",
            )
        body = self.rfile.read(length).decode("utf-8", "replace")
        from shadow_tpu_torch.runtime.daemon import parse_spool_spec

        # JSON is a YAML subset: one parser covers both content types
        try:
            tenant, entry, jobs, _canon = parse_spool_spec(
                body, d.spool_dir, d.default_tenant
            )
        except (ValueError, yaml.YAMLError) as e:
            return self._refusal(400, d.http_refusal(None, "parse", str(e)))
        if (tenant, entry) in d._entries:
            return self._refusal(
                409,
                d.http_refusal(
                    tenant, "duplicate",
                    f"entry {entry!r} is already admitted for tenant "
                    f"{tenant!r} (submit under a new name)",
                ),
            )
        rem = d._budget_remaining(tenant)
        if rem is not None and rem <= 0:
            # the 429-equivalent: journaled like every refusal, with the
            # ledger's refill horizon as Retry-After
            return self._refusal(
                429,
                d.http_refusal(
                    tenant, "quota-class",
                    f"tenant {tenant!r} exhausted its device-seconds "
                    "budget for this window",
                    retry_after_s=d._retry_after_s(),
                ),
            )
        dest = d.spool_body(body, f"{tenant}.{entry}")
        # 202, not 201: admission (journal WAL, world validation) is the
        # drain loop's job — the spec is durably spooled, and status is
        # one GET away under the canonical ids returned here
        return self._send_json(
            202,
            {
                "tenant": tenant,
                "entry": entry,
                "job_ids": [j.name for j in jobs],
                "spooled": os.path.basename(dest),
            },
        )

    def _get_status(self, jid: str) -> int:
        doc = self.front.daemon.job_status(jid)
        if doc is None:
            return self._error(
                404, "unknown-job", f"job {jid!r} was never admitted here"
            )
        return self._send_json(200, doc)

    def _get_results(self, jid: str) -> int:
        d = self.front.daemon
        doc = d.job_status(jid)
        if doc is None:
            return self._error(
                404, "unknown-job", f"job {jid!r} was never admitted here"
            )
        if doc["status"] in ("queued", "running"):
            return self._error(
                409, "not-terminal",
                f"job {jid!r} is {doc['status']}; results publish when "
                "it reaches a terminal status",
            )
        try:
            with open(d.job_results_path(jid), "rb") as f:
                data = f.read()
        except OSError:
            return self._error(
                404, "no-results",
                f"job {jid!r} is {doc['status']} and published no "
                "sim-stats.json",
            )
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)
        return 200

    def _get_events(self, jid: str) -> int:
        d = self.front.daemon
        if d.job_status(jid) is None:
            return self._error(
                404, "unknown-job", f"job {jid!r} was never admitted here"
            )
        q = d.subscribe_progress(jid)
        try:
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            # opening frame: the snapshot as of subscription
            self._chunk({"job": jid, **d.job_progress.get(jid, {})})
            term = d._terminal.get(jid)
            if term is not None:
                self._chunk({"job": jid, "terminal": term})
            else:
                while True:
                    try:
                        item = q.get(timeout=1.0)
                    except queue.Empty:
                        # terminal may have landed before we subscribed
                        # (the sentinel went to no one) — re-check
                        term = d._terminal.get(jid)
                        if term is not None:
                            self._chunk({"job": jid, "terminal": term})
                            break
                        if self.front.closing:
                            self._chunk(
                                {"job": jid, "stream": "daemon-stopping"}
                            )
                            break
                        continue
                    self._chunk(item)
                    if "terminal" in item:
                        break
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()
        finally:
            d.unsubscribe_progress(jid, q)
        self.close_connection = True
        return 200

    def _get_metrics(self) -> int:
        data = self.front.daemon.render_metrics().encode()
        self.send_response(200)
        self.send_header("Content-Type", "text/plain; version=0.0.4")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)
        return 200
