"""Stdlib Prometheus scrape endpoint — ``/metrics`` over ``http.server``
(port of ``deeplearning4j_tpu/telemetry/exposition.py``).

A scrape is one GET returning one rendered string, so
``ThreadingHTTPServer`` from the stdlib is enough.  When the served
registry carries a cross-worker trace store (a ``FleetRegistry``), the
endpoint also answers ``/traces`` and ``/traces?id=<trace>``.  When it
carries an SLO alert engine (``FleetRegistry(alerts=...)`` or a plain
registry with an ``.alerts`` attribute), ``/alerts`` serves the
engine's state as JSON, evaluated against the served view per request
like a scrape.  When it carries an embedded time-series store (every
``FleetRegistry``, or a plain registry with a ``.tsdb`` attribute),
``/query`` answers range reads: ``?series=<name>`` plus optional label
matchers (``tenant=inter``), ``start``/``end`` (unix seconds),
``func=range|rate|delta|quantile`` and ``q`` for quantiles.

Error discipline: unknown paths answer a REAL 404 with a JSON body
naming the endpoints, malformed queries answer 400 with a JSON error,
and a handler exception answers 500 with the error name — a scrape
surface never pushes a stack trace down the wire.
"""
from __future__ import annotations

import json
import logging
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from deeplearning4j_torch.telemetry.registry import MetricsRegistry

log = logging.getLogger("deeplearning4j_torch")

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
JSON_TYPE = "application/json"


class MetricsServer:
    """Background scrape server; ``port=0`` binds an ephemeral port
    (read it back from ``.port`` — what tests and the smoke script use).

    >>> srv = MetricsServer(registry, port=9464).start()
    >>> # curl localhost:9464/metrics   (+ /traces, /alerts where
    >>> #                                the registry carries them)
    >>> srv.close()
    """

    def __init__(self, registry: MetricsRegistry, port: int = 9464,
                 host: str = "127.0.0.1"):
        self.registry = registry
        self._httpd = ThreadingHTTPServer((host, port), self._handler())
        self.host = host
        self.port = self._httpd.server_address[1]
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None

    def _handler(self):
        registry = self.registry

        class Handler(BaseHTTPRequestHandler):
            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _send_json(self, code: int, doc: dict) -> None:
                self._send(code, json.dumps(doc).encode(), JSON_TYPE)

            def _refresh(self) -> None:
                """Fold the latest beacons in first, like a scrape
                (directory-backed ``FleetRegistry`` only)."""
                refresh = getattr(registry, "refresh", None)
                if callable(refresh) and getattr(
                        registry, "directory", None) is not None:
                    refresh()

            def do_GET(self):
                try:
                    self._route()
                except (BrokenPipeError, ConnectionResetError):
                    pass             # client went away mid-write
                                     # (scrape timeout RST included)
                except Exception as e:
                    # never a stack trace down the wire: the scrape
                    # surface degrades to a typed JSON error
                    log.exception("metrics endpoint %s failed",
                                  self.path)
                    try:
                        self._send_json(500, {
                            "error": type(e).__name__,
                            "detail": str(e)})
                    except Exception:
                        pass

            def _route(self):
                parsed = urllib.parse.urlparse(self.path)
                path = parsed.path
                traces = getattr(registry, "traces", None)
                alerts = getattr(registry, "alerts", None)
                tsdb = getattr(registry, "tsdb", None)
                if path == "/query" and tsdb is not None:
                    self._query(tsdb, parsed)
                elif path == "/traces" and traces is not None:
                    q = urllib.parse.parse_qs(
                        parsed.query, keep_blank_values=True)
                    unknown = sorted(set(q) - {"id"})
                    ids = q.get("id", [])
                    if unknown or len(ids) > 1 or (ids and not ids[0]):
                        # malformed query: a 400 with a JSON body, not
                        # a silent default and never a stack trace
                        self._send_json(400, {
                            "error": "bad_query",
                            "detail": ("unknown parameter(s) "
                                       f"{unknown}" if unknown else
                                       "id must be given exactly once "
                                       "with a non-empty value"),
                            "usage": "/traces or /traces?id=<trace>"})
                        return
                    self._refresh()
                    body = traces.render_json(
                        ids[0] if ids else None).encode()
                    self._send(200, body, JSON_TYPE)
                elif path == "/alerts" and alerts is not None:
                    # evaluated against the served view per request —
                    # the scrape IS the evaluation cadence, exactly
                    # like a Prometheus rule group.  A FleetRegistry
                    # evaluates its attached engine INSIDE view(), so
                    # building the view is the whole pass — a second
                    # explicit evaluate would double the work and the
                    # sample density per scrape.
                    view = getattr(registry, "view", None)
                    if callable(view):
                        self._refresh()
                        view()
                    else:
                        alerts.evaluate(registry)
                    self._send(200, alerts.render_json().encode(),
                               JSON_TYPE)
                elif path in ("/metrics", "/"):
                    body = registry.render_prometheus().encode()
                    self._send(200, body, CONTENT_TYPE)
                else:
                    endpoints = ["/metrics"]
                    if traces is not None:
                        endpoints.append("/traces")
                    if alerts is not None:
                        endpoints.append("/alerts")
                    if tsdb is not None:
                        endpoints.append("/query")
                    self._send_json(404, {"error": "not_found",
                                          "endpoints": endpoints})

            _QUERY_USAGE = ("/query?series=<name>[&<label>=<value>...]"
                            "[&start=<unix_s>][&end=<unix_s>]"
                            "[&func=range|rate|delta|quantile]"
                            "[&q=<0..1>]")

            def _query(self, tsdb, parsed) -> None:
                """The TSDB range-read endpoint: reserved
                parameters select/shape the read, every OTHER
                parameter is a label equality matcher.  Malformed
                input answers 400 with a JSON error, matching the
                /traces discipline; an unknown series matches nothing
                and answers 200 with an empty result."""
                q = urllib.parse.parse_qs(parsed.query,
                                          keep_blank_values=True)
                bad = None
                repeated = sorted(k for k, v in q.items()
                                  if len(v) > 1)
                series = q.get("series", [""])[0]
                if repeated:
                    bad = f"repeated parameter(s) {repeated}"
                elif not series:
                    bad = ("series must be given exactly once with a "
                           "non-empty value")
                start = end = qq = None
                func = q.get("func", ["range"])[0]
                if bad is None:
                    try:
                        if "start" in q:
                            start = float(q["start"][0])
                        if "end" in q:
                            end = float(q["end"][0])
                        if "q" in q:
                            qq = float(q["q"][0])
                    except ValueError:
                        bad = "start/end/q must be numbers"
                if bad is not None:
                    self._send_json(400, {"error": "bad_query",
                                          "detail": bad,
                                          "usage": self._QUERY_USAGE})
                    return
                matchers = [(k, v[0]) for k, v in sorted(q.items())
                            if k not in ("series", "start", "end",
                                         "func", "q")]
                # a fleet view refreshes + records a fresh sample per
                # query, exactly like a scrape drives /alerts
                view = getattr(registry, "view", None)
                if callable(view):
                    self._refresh()
                    view()
                try:
                    doc = tsdb.query(series, matchers=matchers,
                                     start=start, end=end, func=func,
                                     q=qq)
                except ValueError as e:
                    # tsdb's own validation (unknown func, quantile
                    # without q, rate over a histogram): caller error,
                    # not a 500
                    self._send_json(400, {"error": "bad_query",
                                          "detail": str(e),
                                          "usage": self._QUERY_USAGE})
                    return
                self._send_json(200, doc)

            def log_message(self, *a):  # keep scrapes out of stderr
                pass

        return Handler

    def start(self) -> "MetricsServer":
        thread = threading.Thread(target=self._httpd.serve_forever,
                                  name="dl4j-torch-metrics", daemon=True)
        with self._lock:
            self._thread = thread
        thread.start()
        return self

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        with self._lock:
            thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=5)

    def __enter__(self) -> "MetricsServer":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


def start_metrics_server(registry: MetricsRegistry, port: int = 9464,
                         host: str = "127.0.0.1") -> MetricsServer:
    """One-liner: start a daemon scrape endpoint for ``registry``."""
    return MetricsServer(registry, port=port, host=host).start()
