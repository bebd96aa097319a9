"""Prometheus-style text exposition + the tiny stdlib /metrics + /healthz
HTTP endpoint both the serving server and the apex drivers mount.

No third-party client library: the exposition format is plain text and the
server is ``http.server.ThreadingHTTPServer`` on a daemon thread — good
enough for a scrape every few seconds, zero new dependencies (the container
bakes only the jax_graft toolchain).

Endpoints:
  /metrics   registry counters/gauges as ``ria_<name>{role="..."} value``,
             histograms as summary-style quantile rows + _count/_sum;
  /healthz   JSON from the attached health callback; HTTP 200 for
             ok/degraded (the run is alive), 503 for failing (a scheduler
             or LB should act).
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional

from rainbow_iqn_apex_tpu_torch.obs.registry import Histogram, MetricRegistry
from rainbow_iqn_apex_tpu_torch.obs.schema import sanitize

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    return "ria_" + _NAME_RE.sub("_", name)


def escape_label_value(value: str) -> str:
    """Prometheus text-format label-value escaping: backslash, double
    quote, and newline must be escaped or a hostile/odd role (or host)
    string corrupts the whole exposition (one bad label breaks every
    scraper parsing the page, not just its own line)."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _label_str(pairs: "list[tuple[str, str]]") -> str:
    if not pairs:
        return ""
    inner = ",".join(
        f'{k}="{escape_label_value(v)}"' for k, v in pairs
    )
    return "{" + inner + "}"


def prometheus_text(
    registry: MetricRegistry,
    extra_labels: Optional[Dict[str, str]] = None,
) -> str:
    """The registry in Prometheus text exposition format (v0.0.4).

    ``extra_labels`` ride on every sample — the obs collector re-exports
    one registry per fleet host with ``{"host": ...}`` here."""
    extra = sorted((extra_labels or {}).items())
    lines = []
    for name, role, metric in registry.collect():
        pname = _prom_name(name)
        base = ([("role", role)] if role else []) + extra
        label = _label_str(base)
        if isinstance(metric, Histogram):
            snap = metric.snapshot()
            lines.append(f"# TYPE {pname} summary")
            for q, key in (("0.5", "p50"), ("0.9", "p90"), ("0.99", "p99")):
                if key in snap:
                    qlabel = _label_str(base + [("quantile", q)])
                    lines.append(f"{pname}{qlabel} {snap[key]:.6g}")
            lines.append(f"{pname}_count{label} {metric.total_count}")
            lines.append(f"{pname}_sum{label} {metric.total_sum:.6g}")
        else:
            lines.append(f"# TYPE {pname} {metric.kind}")
            lines.append(f"{pname}{label} {metric.get():.6g}")
    return "\n".join(lines) + "\n"


class ObsHTTPServer:
    """Serve /metrics and /healthz for one registry + health callback.

    ``port=0`` binds an ephemeral port (read ``.port`` after construction);
    Config.obs_http_port <= 0 means callers never construct one at all."""

    def __init__(
        self,
        registry: MetricRegistry,
        health_fn: Optional[Callable[[], Dict[str, Any]]] = None,
        port: int = 0,
        host: str = "127.0.0.1",
        metrics_text_fn: Optional[Callable[[], str]] = None,
        routes: Optional[Dict[str, Callable[[], Dict[str, Any]]]] = None,
    ):
        self.registry = registry
        self.health_fn = health_fn
        # the obs collector overrides /metrics with its host-labelled fleet
        # aggregate and mounts extra JSON endpoints (/fleetz) here; plain
        # runs leave both None and serve exactly the pre-fleet surface
        self.metrics_text_fn = metrics_text_fn
        self.routes = dict(routes or {})
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # no stderr chatter per scrape
                pass

            def _send(self, code: int, body: str, ctype: str) -> None:
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                try:
                    if path == "/metrics":
                        text = (
                            outer.metrics_text_fn()
                            if outer.metrics_text_fn is not None
                            else prometheus_text(outer.registry)
                        )
                        self._send(200, text, "text/plain; version=0.0.4")
                    elif path == "/healthz":
                        health = (
                            outer.health_fn() if outer.health_fn is not None
                            else {"status": "ok"}
                        )
                        code = 503 if health.get("status") == "failing" else 200
                        self._send(
                            code, json.dumps(sanitize(health)), "application/json"
                        )
                    elif path in outer.routes:
                        self._send(
                            200,
                            json.dumps(sanitize(outer.routes[path]())),
                            "application/json",
                        )
                    else:
                        self._send(404, "not found\n", "text/plain")
                except (BrokenPipeError, ConnectionResetError):
                    pass  # client went away mid-scrape; nothing to serve
                except Exception as e:
                    # a broken health/route callback must answer a reasoned
                    # 500, not kill the response mid-scrape with a traceback
                    # (the pre-r18 /healthz crash path): count it, then try
                    # to tell the scraper what broke — best-effort, the
                    # headers may already be gone
                    outer.registry.counter(
                        "obs_http_errors_total", "obs"
                    ).inc()
                    try:
                        self._send(
                            500,
                            json.dumps(
                                {"status": "error",
                                 "error": type(e).__name__,
                                 "path": path}
                            ),
                            "application/json",
                        )
                    except Exception:
                        pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "ObsHTTPServer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever,
                name="obs-http",
                daemon=True,
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread.join(timeout=5)
            self._thread = None
        self._httpd.server_close()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"
