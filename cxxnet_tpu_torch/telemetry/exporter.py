"""Registry exposition: Prometheus text format, the ``/metrics`` server,
the JSONL log (the port's copy of ``cxxnet_tpu/telemetry/exporter.py``).

Three ways the same registry leaves the process:

* :func:`render_prometheus`: text exposition format 0.0.4, served at
  ``GET /metrics`` by the serve server (serve/server.py) and, during
  training, by the standalone :class:`MetricsServer`
  (``telemetry_port = <p>``);
* :class:`TelemetryLogger`: a periodic JSONL log (``telemetry_log =
  <path>``), one flat registry snapshot a line, rotated to ``<path>.1``
  past ``max_bytes``;
* ``registry.snapshot()`` directly, which ``/statz`` embeds.

A :class:`MetricsServer` whose port cannot be bound raises (``OSError``)
from its constructor: nothing here swallows it.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Optional

from .registry import REGISTRY, MetricRegistry

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _fmt_value(v: float) -> str:
    if v != v:                                   # NaN
        return "NaN"
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _labels_str(names, values, extra: str = "") -> str:
    parts = [f'{k}="{_escape_label(str(v))}"'
             for k, v in zip(names, values)]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def render_prometheus(registry: Optional[MetricRegistry] = None) -> str:
    """The whole registry in Prometheus text exposition format 0.0.4
    (# HELP / # TYPE headers, cumulative histogram buckets with the
    canonical ``le`` labels)."""
    registry = registry or REGISTRY
    out = []
    for fam in registry.collect():
        if fam.help:
            out.append(f"# HELP {fam.name} {fam.help}")
        out.append(f"# TYPE {fam.name} {fam.kind}")
        for vals, child in fam.samples():
            if fam.kind == "histogram":
                # one-lock snapshot: buckets/sum/count must agree within
                # a single exposition (see HistogramChild.snapshot)
                cum_buckets, hsum, hcount = child.snapshot()
                for ub, cum in cum_buckets:
                    le = "+Inf" if ub == math.inf else _fmt_value(ub)
                    ls = _labels_str(fam.labelnames, vals,
                                     'le="%s"' % le)
                    out.append(f"{fam.name}_bucket{ls} {cum}")
                ls = _labels_str(fam.labelnames, vals)
                out.append(f"{fam.name}_sum{ls} {_fmt_value(hsum)}")
                out.append(f"{fam.name}_count{ls} {hcount}")
            else:
                out.append(
                    f"{fam.name}{_labels_str(fam.labelnames, vals)} "
                    f"{_fmt_value(child.value)}")
    return "\n".join(out) + "\n"


class MetricsServer:
    """Standalone ``/metrics`` (+ ``/healthz``) HTTP endpoint for runs
    that have no serve server — i.e. training. Stdlib-only, daemon
    threads, ephemeral-port friendly (``port=0`` -> ``.port``)."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 registry: Optional[MetricRegistry] = None,
                 render_fn=None):
        from http.server import (BaseHTTPRequestHandler,
                                 ThreadingHTTPServer)
        registry = registry or REGISTRY
        # render_fn replaces the exposition body: host 0's fleet
        # aggregator (telemetry.aggregate.FleetAggregator.render) serves
        # the merged, host-labelled view here; settable after start
        self.render_fn = render_fn
        server_ref = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):       # scrape spam
                pass

            def do_GET(self):
                if self.path == "/metrics":
                    fn = server_ref.render_fn
                    try:
                        text = fn() if fn is not None \
                            else render_prometheus(registry)
                    except Exception:
                        # a broken fleet render must not fail the
                        # scrape: the local registry answers
                        text = render_prometheus(registry)
                    body = text.encode("utf-8")
                    ctype = PROMETHEUS_CONTENT_TYPE
                elif self.path == "/healthz":
                    body = b'{"ok": true}'
                    ctype = "application/json"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "MetricsServer":
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True,
                                        name="telemetry-metrics")
        self._thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)


class TelemetryLogger:
    """Periodic JSONL registry snapshots for offline runs.

    One line per interval: ``{"ts": <unix>, "uptime_s": ..., "metrics":
    {flat name{labels} -> value}}``. Before each write the file is
    size-checked against ``max_bytes`` and rotated to ``<path>.1``
    (one generation — bounded disk, not an archive). ``write_now()``
    exists so tests and shutdown flushes are deterministic."""

    def __init__(self, path: str, interval_s: float = 5.0,
                 max_bytes: int = 1 << 20,
                 registry: Optional[MetricRegistry] = None):
        self.path = path
        self.interval_s = float(interval_s)
        self.max_bytes = int(max_bytes)
        self.registry = registry or REGISTRY
        self.rotations = 0
        self.lines = 0
        self._t0 = time.time()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        d = os.path.dirname(os.path.abspath(path))
        if d:
            os.makedirs(d, exist_ok=True)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="telemetry-jsonl")

    def start(self) -> "TelemetryLogger":
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.write_now()

    def write_now(self) -> None:
        line = json.dumps({
            "ts": round(time.time(), 3),
            "uptime_s": round(time.time() - self._t0, 3),
            "metrics": self.registry.snapshot(),
        }, sort_keys=True)
        with self._lock:
            try:
                if os.path.exists(self.path) \
                        and os.path.getsize(self.path) >= self.max_bytes:
                    os.replace(self.path, self.path + ".1")
                    self.rotations += 1
                with open(self.path, "a", encoding="utf-8") as f:
                    f.write(line + "\n")
                self.lines += 1
            except OSError:
                pass          # telemetry must never kill the run

    def stop(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=5)
        self.write_now()                       # final flush
