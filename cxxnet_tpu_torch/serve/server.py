"""Stdlib JSON front-end of one inference engine or a replica fleet (the
port of ``cxxnet_tpu/serve/server.py``).

* ``POST /predict``  ``{"data": [[...], ...], "raw": 0|1, "timeout_ms": N?,
  "version": "rNNNN"?}`` -> ``{"pred": [...]}`` / ``{"prob": [[...]]}``
* ``POST /extract``  ``{"data": ..., "node": "name"}``
  -> ``{"node": ..., "features": [[...]]}``
* ``POST /generate`` ``{"prompt": [ids...], "max_new": N?,
  "deadline_ms": T?, "stream": 0|1, "version": "rNNNN"?}``: LM serving
  (``serve/lm/``), once ``attach_lm`` brought the plane up. Streamed by
  default as ``Transfer-Encoding: chunked`` ndjson, one event a chunk
  flushed as each token lands (``serve/lm/stream.py`` has the events),
  so a client reads TTFT and inter-token latency directly; ``"stream":
  0`` returns ``{"tokens": [...], "reason": ...}`` in one body. A client
  that drops mid-stream cancels its sequence and frees its KV blocks.
* ``GET  /healthz``  -> ``{"status": "ok"|"degraded"|"open"|"down", ...}``
* ``GET  /statz``    -> the ServingStats snapshot + breaker/queue state,
  the resilience ``counters`` and the run identity ``run``
* ``GET  /metrics``  -> the whole process registry in Prometheus text
  format 0.0.4 (serving, SLO, fleet, LM plane, cascade, checkpoints)

The server fronts one engine (``ServeServer(engine)``, served as a
pool of one replica) or a replica fleet (``ServeServer(pool=...)``,
``serve/fleet.py``). Requests route by version pin, breaker state,
admission control and queue depth. A fleet's ``/healthz`` reports the
worst replica with a per-replica list; its ``/statz`` keeps the
single-engine layout at the top (summed) and adds ``replicas``,
``versions`` and, with a ``reload_watcher`` (``serve/reload.py``,
started and stopped with the server), ``reload``. The ``version`` field or the ``X-Model-Version`` header pins
a request to the replicas serving that version; ``/generate`` goes
through ``pool.submit_lm``.

Health: ``ok`` (200) dispatching normally; ``degraded`` (200) the queue
is past ``degraded_queue_frac`` of its budget, the breaker is probing,
the latency-SLO burn rate (``slo_ms > 0``) is at or over
``slo_burn_degraded``, or (fleet) a replica is draining, reloading or
degraded; ``open`` (503) the breaker is open; ``down`` (500) the batcher
worker is dead. Errors: malformed request, wrong row width, a bad
prompt or unknown version 400; backpressure, breaker open, no healthy
replica, admission shedding or no LM plane 503; deadline exceeded 504;
engine failure 500. Shutdown is graceful: stop the reload watcher and
accepting, then drain the LM planes and the batchers, on ``stop()`` or
on SIGINT/SIGTERM (handlers installed by ``start()`` on the main
thread). Corrupt records skipped since the server started
(``recordio.skipped``) read ``degraded`` and show as ``skipped_records``.

A request is the ``serve.request`` span (``serve.queue_wait``,
``serve.batch_assembly`` and ``serve.infer`` on the batcher's thread,
``serve.respond`` on the handler's); ``start()`` writes ``serve_start``
to the run ledger.
"""

from __future__ import annotations

import json
import signal
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple

import numpy as np

from ..resilience import CircuitOpen, counters
from ..telemetry.exporter import PROMETHEUS_CONTENT_TYPE, render_prometheus
from ..telemetry.ledger import LEDGER, run_info
from ..telemetry.disttrace import DISTTRACE
from ..telemetry.trace import TRACER
from .batcher import Backpressure, DeadlineExceeded
from .engine import InferenceEngine
from .fleet import NoHealthyReplica, ReplicaPool


class NoLMPlane(RuntimeError):
    """``POST /generate`` on a server with no LM plane attached (503)."""


def _make_handler(server: "ServeServer"):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):          # quiet per-request spam
            if not server.silent and server.verbose:
                BaseHTTPRequestHandler.log_message(self, fmt, *args)

        def _reply(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if code >= 400:
                # an error may leave the POST body unread; on a keep-alive
                # socket those bytes would parse as the next request
                self.close_connection = True
                self.send_header("Connection", "close")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                code, payload = server.health()
                self._reply(code, payload)
            elif self.path == "/statz":
                self._reply(200, server.statz())
            elif self.path == "/metrics":
                # one scrape is the whole process registry
                body = render_prometheus().encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", PROMETHEUS_CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._reply(404, {"error": f"no such path {self.path}"})

        def _read_json(self) -> dict:
            n = int(self.headers.get("Content-Length", 0))
            if n <= 0 or n > server.max_body_bytes:
                raise ValueError(f"bad Content-Length {n}")
            return json.loads(self.rfile.read(n).decode("utf-8"))

        def do_POST(self):
            if self.path not in ("/predict", "/extract", "/generate"):
                self._reply(404, {"error": f"no such path {self.path}"})
                return
            # a W3C ``traceparent`` header parents the request's span
            # under the client's; without one it is a new root trace
            # (the plain span when distributed tracing is off)
            ctx = (DISTTRACE.extract(self.headers.get("traceparent"))
                   if DISTTRACE.enabled else None)
            with DISTTRACE.span("serve.request", cat="serve",
                                args={"path": self.path}, parent=ctx):
                self._handle_post()

        def _handle_post(self):
            try:
                req = self._read_json()
                version = req.get("version") \
                    or self.headers.get("X-Model-Version") or None
                if self.path == "/generate":
                    self._handle_generate(req, version)
                    return
                data = np.asarray(req["data"], np.float32)
                if data.ndim == 1:
                    data = data[None, :]
                timeout_ms = req.get("timeout_ms")
                if self.path == "/extract":
                    node = req.get("node", "top")
                    fut = server.submit(data, "extract", node,
                                        timeout_ms=timeout_ms,
                                        version=version)
                    out = fut.result(timeout=server.result_timeout_s)
                    with TRACER.span("serve.respond", cat="serve"):
                        self._reply(200, {"node": node,
                                          "features": out.tolist()})
                else:
                    kind = "raw" if int(req.get("raw", 0)) else "predict"
                    fut = server.submit(data, kind, timeout_ms=timeout_ms,
                                        version=version)
                    out = fut.result(timeout=server.result_timeout_s)
                    key = "prob" if kind == "raw" else "pred"
                    with TRACER.span("serve.respond", cat="serve"):
                        self._reply(200, {key: out.tolist()})
            except (Backpressure, CircuitOpen, NoHealthyReplica,
                    NoLMPlane) as e:
                self._reply(503, {"error": str(e)})
            except DeadlineExceeded as e:
                self._reply(504, {"error": str(e)})
            except (KeyError, ValueError, TypeError) as e:
                self._reply(400, {"error": f"{type(e).__name__}: {e}"})
            except Exception as e:   # the engine failed: report, keep serving
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

        def _handle_generate(self, req: dict, version) -> None:
            from .lm.stream import LAST_CHUNK, chunk, encode_event
            prompt = req.get("prompt")
            if not isinstance(prompt, (list, tuple)) or not prompt:
                raise ValueError(
                    "generate needs a non-empty integer list 'prompt'")
            handle = server.submit_lm(
                [int(t) for t in prompt], max_new=req.get("max_new"),
                deadline_ms=req.get("deadline_ms"), version=version)
            if not int(req.get("stream", 1)):
                try:
                    done = handle.result(timeout=server.result_timeout_s)
                except TimeoutError:
                    # the generation outlived the handler's budget: evict
                    # it (its decode row and KV blocks) and answer 504
                    handle.cancel()
                    raise DeadlineExceeded(
                        "generation exceeded result_timeout_s="
                        f"{server.result_timeout_s}")
                with TRACER.span("serve.respond", cat="serve"):
                    self._reply(200, {"tokens": done["tokens"],
                                      "reason": done["reason"]})
                return
            # headers are committed from here on: a failure is an in-band
            # error event (pushed by the scheduler) or a dropped
            # connection, never a second status line
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            try:
                with TRACER.span("serve.stream", cat="serve"):
                    for ev in handle.events(
                            timeout=server.result_timeout_s):
                        self.wfile.write(chunk(encode_event(ev)))
                        self.wfile.flush()     # per token: TTFT is real
                    self.wfile.write(LAST_CHUNK)
                    self.wfile.flush()
            except (TimeoutError, OSError):
                # client gone (or stream wedged): release the decode row
                # and KV blocks instead of generating into the void
                handle.cancel()
                self.close_connection = True

    return Handler


class ServeServer:
    """One engine (or a replica pool) behind HTTP, with a periodic stats
    log line.

    Exactly one of ``engine`` and ``pool`` is given. An engine becomes a
    pool of one replica (``ReplicaPool.from_engines``) with the server's
    batcher, breaker and SLO knobs, no admission control and no fleet
    series, and ``/healthz``, ``/statz``, ``/metrics`` and the log line
    keep the single engine's layout. A pool's replicas already have their batchers, breakers and
    SLO trackers (built by ``ReplicaPool.build``), so those knobs are
    not used. An optional ``reload_watcher`` starts with the server,
    stops before the drain, and shows in ``/statz`` as ``reload``."""

    def __init__(self, engine: Optional[InferenceEngine] = None,
                 port: int = 0, host: str = "127.0.0.1",
                 max_batch: Optional[int] = None,
                 max_latency_ms: float = 5.0,
                 max_queue_rows: int = 1024,
                 default_timeout_ms: Optional[float] = None,
                 log_interval_s: float = 30.0,
                 silent: bool = False, verbose: bool = False,
                 max_body_bytes: int = 64 << 20,
                 result_timeout_s: float = 120.0,
                 breaker_threshold: int = 5,
                 breaker_reset_s: float = 10.0,
                 degraded_queue_frac: float = 0.8,
                 slo_ms: float = 0.0,
                 slo_target: float = 0.99,
                 slo_window_s: float = 60.0,
                 slo_burn_degraded: float = 2.0,
                 pool: Optional[ReplicaPool] = None,
                 reload_watcher=None,
                 handle_signals: bool = True):
        if (engine is None) == (pool is None):
            raise ValueError("ServeServer takes exactly one of "
                             "engine= or pool=")
        if engine is not None:
            pool = ReplicaPool.from_engines(
                [engine], admission_control=False, fleet=False,
                max_batch=max_batch,
                max_latency_ms=max_latency_ms, max_queue_rows=max_queue_rows,
                default_timeout_ms=default_timeout_ms,
                breaker_threshold=breaker_threshold,
                breaker_reset_s=breaker_reset_s,
                degraded_queue_frac=degraded_queue_frac, slo_ms=slo_ms,
                slo_target=slo_target, slo_window_s=slo_window_s,
                slo_burn_degraded=slo_burn_degraded)
        # the single engine's replica, whose layout the views keep
        self._one = pool.replicas[0] if engine is not None else None
        self.engine = engine
        self.batcher = self._one.batcher if self._one else None
        self.pool = pool
        self.reload_watcher = reload_watcher
        self.silent = silent
        self.verbose = verbose
        self.max_body_bytes = max_body_bytes
        self.result_timeout_s = result_timeout_s
        self.log_interval_s = log_interval_s
        # degradation relative to this server's lifetime: records skipped
        # before it started (a training run in the process) are not its
        self._skipped_base = counters.get("recordio.skipped")
        self.httpd = ThreadingHTTPServer((host, port), _make_handler(self))
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_address[1]
        self._http_thread: Optional[threading.Thread] = None
        self._log_stop = threading.Event()
        self._log_thread: Optional[threading.Thread] = None
        self.handle_signals = bool(handle_signals)
        self._stop_evt = threading.Event()
        self._stop_lock = threading.Lock()
        self._stopped = False
        self._stop_done = threading.Event()
        self._prev_handlers: Dict[int, object] = {}

    @property
    def lm(self):
        """The single engine's LM plane (serve/lm LMScheduler), once
        ``attach_lm`` brought it up; a pool keeps one per replica."""
        return self._one.lm if self._one else None

    def submit(self, data, kind: str = "predict",
               node: Optional[str] = None,
               timeout_ms: Optional[float] = None,
               version: Optional[str] = None):
        """Route one request through the pool; a version pin must name
        a version some replica serves."""
        return self.pool.submit(data, kind, node, timeout_ms=timeout_ms,
                                version=version)

    # -- LM serving plane --------------------------------------------------
    def attach_lm(self, lm_cfg) -> "ServeServer":
        """Bring up the LM plane (a ``parse_lm_serve_config`` result) on
        every replica (``ReplicaPool.attach_lm``): its live count is the
        batcher's idle probe and its snapshot in ``/statz``
        (``set_lm_role`` splits prefill and decode)."""
        self.pool.attach_lm(lm_cfg)
        return self

    def submit_lm(self, prompt, max_new: Optional[int] = None,
                  deadline_ms: Optional[float] = None,
                  version: Optional[str] = None):
        """Route one generation request; returns its StreamHandle."""
        if all(r.lm is None for r in self.pool.replicas):
            raise NoLMPlane("no LM plane attached (server.attach_lm)")
        return self.pool.submit_lm(prompt, max_new=max_new,
                                   deadline_ms=deadline_ms,
                                   version=version)

    def health(self) -> Tuple[int, Dict]:
        codes = {"ok": 200, "degraded": 200, "open": 503, "down": 500}
        skipped = counters.get("recordio.skipped") - self._skipped_base
        if self._one is None:
            agg = self.pool.health()
            status = agg["status"]
            if status == "ok" and skipped > 0:
                status = "degraded"
            return codes[status], {
                "status": status, "ok": status == "ok",
                "replicas": agg["replicas"], "versions": agg["versions"],
                "skipped_records": skipped}
        rep = self._one
        status = rep.health()
        if status == "ok" and skipped > 0:
            status = "degraded"
        queued = rep.batcher.queued_rows if rep.alive() else 0
        out = {"status": status, "ok": status == "ok",
               "breaker": (rep.breaker.effective_state()
                           if rep.breaker is not None else "disabled"),
               "queued_rows": queued,
               "queue_frac": round(
                   queued / max(1, rep.batcher.max_queue_rows), 4),
               "skipped_records": skipped}
        if rep.slo is not None:
            out["slo_burn_rate"] = round(rep.burn_rate(), 4)
        return codes[status], out

    def statz(self) -> Dict:
        reps = self.pool.replicas
        if self._one is None:
            out = self.pool.snapshot()
        else:
            rep = self._one
            out = rep.engine.stats.snapshot()
            if rep.breaker is not None:
                out["breaker"] = rep.breaker.snapshot()
            if rep.slo is not None:
                out["slo"] = rep.slo.snapshot()
            out["version"] = rep.version
        out["queue"] = {"rows": sum(r.batcher.queued_rows for r in reps),
                        "max_rows": sum(r.batcher.max_queue_rows
                                        for r in reps)}
        if self.reload_watcher is not None:
            out["reload"] = self.reload_watcher.snapshot()
        out["counters"] = counters.snapshot()
        # run identity: joins /statz and scrapes with the run ledger
        out["run"] = run_info()
        return out

    # -- lifecycle -------------------------------------------------------
    def start(self) -> "ServeServer":
        self._http_thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True, name="serve-http")
        self._http_thread.start()
        if self.log_interval_s > 0 and not self.silent:
            self._log_thread = threading.Thread(
                target=self._log_loop, daemon=True, name="serve-statlog")
            self._log_thread.start()
        if self.reload_watcher is not None:
            self.reload_watcher.start()
        if self.handle_signals:
            self._install_signal_handlers()
        n_rep = len(self.pool.replicas)
        LEDGER.event(
            "serve_start", port=self.port, replicas=n_rep,
            versions=self.pool.versions() if self._one is None else None,
            reload_s=(self.reload_watcher.interval_s
                      if self.reload_watcher is not None
                      and hasattr(self.reload_watcher, "interval_s")
                      else 0))
        if not self.silent:
            print(f"serving on http://{self.httpd.server_address[0]}:"
                  f"{self.port} (/predict /extract /healthz /statz "
                  f"/metrics), {n_rep} replica(s)", flush=True)
        return self

    def _log_loop(self) -> None:
        while not self._log_stop.wait(self.log_interval_s):
            print(self.log_line(), flush=True)

    def log_line(self) -> str:
        if self._one is not None:
            return self._one.engine.stats.log_line()
        s = self.pool.snapshot()
        return ("serve-fleet[%dx]\tqps:%.2f\tp50_ms:%.2f\tp99_ms:%.2f"
                "\tfill:%.3f\tok:%d\tfailed:%d\tversions:%s" % (
                    len(self.pool.replicas), s["qps"],
                    s["latency_ms"]["p50"], s["latency_ms"]["p99"],
                    s["batches"]["fill_ratio"], s["requests"]["ok"],
                    s["requests"]["failed"],
                    ",".join(sorted(s["versions"]) or ["init"])))

    def _install_signal_handlers(self) -> None:
        """SIGTERM/SIGINT -> the graceful drain of ``stop()``. Main thread
        only; the handler restores the previous handlers, so a second
        signal gets the process's original behaviour."""
        if threading.current_thread() is not threading.main_thread():
            return

        def _sig(signum, _frame):
            self._restore_signal_handlers()
            self._stop_evt.set()

        for signum in (signal.SIGINT, signal.SIGTERM):
            self._prev_handlers[signum] = signal.signal(signum, _sig)
        threading.Thread(target=self._sig_watch, daemon=True,
                         name="serve-sigwatch").start()

    def _sig_watch(self) -> None:
        self._stop_evt.wait()
        self.stop()

    def _restore_signal_handlers(self) -> None:
        for signum, prev in self._prev_handlers.items():
            signal.signal(signum, prev)
        self._prev_handlers = {}

    def stop(self) -> None:
        """Graceful and idempotent: stop the reload watcher and
        accepting, drain the batcher(s), print the final stats line. A
        second caller waits for the first one's drain to finish."""
        with self._stop_lock:
            if self._stopped:
                self._stop_done.wait()
                return
            self._stopped = True
        self._stop_evt.set()
        self._log_stop.set()
        try:
            # no weights swap may race the teardown
            if self.reload_watcher is not None:
                self.reload_watcher.stop()
            if self._http_thread is not None:     # serve_forever runs
                self.httpd.shutdown()
                self._http_thread.join(timeout=10)
            self.httpd.server_close()
            # each replica's LM plane, then its batcher
            self.pool.close(drain=True)
            if not self.silent:
                print(self.log_line(), flush=True)
            if threading.current_thread() is threading.main_thread():
                self._restore_signal_handlers()
        finally:
            self._stop_done.set()

    def serve_until_interrupt(self) -> None:
        """Foreground loop of ``task = serve``: block until SIGINT/SIGTERM
        (or ``stop()``), then shut down gracefully."""
        try:
            self._stop_evt.wait()
        finally:
            self.stop()
