"""Stdlib JSON front-end of one inference engine (the port of
``cxxnet_tpu/serve/server.py``'s single-engine server).

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
* ``GET  /statz``    -> the ServingStats snapshot + breaker/queue state

Health: ``ok`` (200) dispatching normally; ``degraded`` (200) the queue
is past ``degraded_queue_frac`` of its budget or the breaker is probing;
``open`` (503) the breaker is open; ``down`` (500) the batcher worker is
dead. Errors: malformed request, wrong row width, a bad prompt or
unknown version 400; backpressure, breaker open or no LM plane 503;
deadline exceeded 504; engine failure 500. Shutdown is graceful: stop
accepting, then drain the LM plane and the batcher, on ``stop()`` or on
SIGINT/SIGTERM (handlers installed by ``start()`` on the main thread).

Not served yet: replica fleets, hot reload and A/B pins, and with them
``ReplicaPool.attach_lm``, ``set_lm_role`` and int8 LM serving (ROADMAP
Queue A 4); ``GET /metrics`` and the SLO burn rate (Queue A 12).
"""

from __future__ import annotations

import json
import signal
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple

import numpy as np

from ..resilience import CircuitBreaker, CircuitOpen
from .batcher import Backpressure, DeadlineExceeded, MicroBatcher
from .engine import InferenceEngine


class UnknownVersion(ValueError):
    """A request pinned a model version this server does not serve."""


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
                    self._reply(200, {"node": node,
                                      "features": out.tolist()})
                else:
                    kind = "raw" if int(req.get("raw", 0)) else "predict"
                    fut = server.submit(data, kind, timeout_ms=timeout_ms,
                                        version=version)
                    out = fut.result(timeout=server.result_timeout_s)
                    key = "prob" if kind == "raw" else "pred"
                    self._reply(200, {key: out.tolist()})
            except (Backpressure, CircuitOpen, NoLMPlane) as e:
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
                for ev in handle.events(timeout=server.result_timeout_s):
                    self.wfile.write(chunk(encode_event(ev)))
                    self.wfile.flush()         # per token: TTFT is real
                self.wfile.write(LAST_CHUNK)
                self.wfile.flush()
            except (TimeoutError, OSError):
                # client gone (or stream wedged): release the decode row
                # and KV blocks instead of generating into the void
                handle.cancel()
                self.close_connection = True

    return Handler


class ServeServer:
    """One engine + micro-batcher + breaker behind HTTP, with a periodic
    stats log line."""

    def __init__(self, engine: InferenceEngine,
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
                 handle_signals: bool = True):
        self.engine = engine
        self.stats = engine.stats
        self.silent = silent
        self.verbose = verbose
        self.max_body_bytes = max_body_bytes
        self.result_timeout_s = result_timeout_s
        self.log_interval_s = log_interval_s
        self.degraded_queue_frac = float(degraded_queue_frac)
        # breaker_threshold = 0 disables circuit breaking
        self.breaker = (CircuitBreaker(failure_threshold=breaker_threshold,
                                       reset_timeout_s=breaker_reset_s)
                        if breaker_threshold > 0 else None)
        self.batcher = MicroBatcher(
            engine, max_batch=max_batch, max_latency_ms=max_latency_ms,
            max_queue_rows=max_queue_rows,
            default_timeout_ms=default_timeout_ms, stats=self.stats,
            breaker=self.breaker)
        # the LM plane (serve/lm LMScheduler), set by attach_lm
        self.lm = None
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

    def submit(self, data, kind: str = "predict",
               node: Optional[str] = None,
               timeout_ms: Optional[float] = None,
               version: Optional[str] = None):
        """Route one request to the batcher; a version pin must name the
        engine's own weights."""
        self._check_version(version)
        return self.batcher.submit(data, kind, node, timeout_ms=timeout_ms)

    def _check_version(self, version: Optional[str]) -> None:
        if version is not None and version != self.engine.weights_version:
            raise UnknownVersion(
                f"no replica serves model version {version!r}; "
                f"available: [{self.engine.weights_version!r}]")

    # -- LM serving plane --------------------------------------------------
    def attach_lm(self, lm_cfg) -> "ServeServer":
        """Bring up the LM plane (a ``parse_lm_serve_config`` result):
        one LMEngine and scheduler on this server's engine, its live
        count registered as the batcher's idle probe and its snapshot in
        ``/statz`` (``self.lm.set_role`` splits prefill and decode)."""
        from .lm import LMEngine, LMScheduler
        if self.lm is not None:
            raise RuntimeError("LM plane already attached")
        sched = LMScheduler(LMEngine(self.engine, lm_cfg), lm_cfg)
        sched.start()
        self.batcher.add_idle_probe(sched.live_count)
        self.stats.lm = sched.snapshot
        self.lm = sched
        return self

    def submit_lm(self, prompt, max_new: Optional[int] = None,
                  deadline_ms: Optional[float] = None,
                  version: Optional[str] = None):
        """Route one generation request; returns its StreamHandle."""
        if self.lm is None:
            raise NoLMPlane("no LM plane attached (server.attach_lm)")
        self._check_version(version)
        return self.lm.submit(prompt, max_new=max_new,
                              deadline_ms=deadline_ms)

    def health(self) -> Tuple[int, Dict]:
        alive = self.batcher._thread.is_alive()
        queued = self.batcher.queued_rows if alive else 0
        queue_frac = queued / max(1, self.batcher.max_queue_rows)
        breaker_state = (self.breaker.effective_state()
                         if self.breaker is not None else "disabled")
        if not alive:
            status, code = "down", 500
        elif breaker_state == "open":
            status, code = "open", 503
        elif (breaker_state == "half_open"
              or queue_frac >= self.degraded_queue_frac):
            status, code = "degraded", 200
        else:
            status, code = "ok", 200
        return code, {"status": status, "ok": status == "ok",
                      "breaker": breaker_state, "queued_rows": queued,
                      "queue_frac": round(queue_frac, 4)}

    def statz(self) -> Dict:
        out = self.stats.snapshot()
        if self.breaker is not None:
            out["breaker"] = self.breaker.snapshot()
        out["queue"] = {"rows": self.batcher.queued_rows,
                        "max_rows": self.batcher.max_queue_rows}
        out["version"] = self.engine.weights_version
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
        if self.handle_signals:
            self._install_signal_handlers()
        if not self.silent:
            print(f"serving on http://{self.httpd.server_address[0]}:"
                  f"{self.port} (/predict /extract /healthz /statz)",
                  flush=True)
        return self

    def _log_loop(self) -> None:
        while not self._log_stop.wait(self.log_interval_s):
            print(self.stats.log_line(), flush=True)

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
        """Graceful and idempotent: stop accepting, drain the batcher,
        print the final stats line. A second caller waits for the first
        one's drain to finish."""
        with self._stop_lock:
            if self._stopped:
                self._stop_done.wait()
                return
            self._stopped = True
        self._stop_evt.set()
        self._log_stop.set()
        try:
            if self._http_thread is not None:     # serve_forever runs
                self.httpd.shutdown()
                self._http_thread.join(timeout=10)
            self.httpd.server_close()
            # the LM plane first: its live sequences are what the
            # batcher's idle probe watches
            if self.lm is not None:
                self.lm.stop(drain=True)
                self.lm.engine.close()
            self.batcher.close(drain=True)
            if not self.silent:
                print(self.stats.log_line(), flush=True)
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
