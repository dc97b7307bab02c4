"""Dynamic micro-batching queue in front of the inference engine (the
port of ``cxxnet_tpu/serve/batcher.py``, without distributed tracing).
Each dispatch is the ``serve.queue_wait`` and ``serve.batch_assembly``
spans, and the rows admitted but not dispatched are the
``cxxnet_serve_queue_rows{engine}`` gauge.

Requests accumulate until ``max_batch`` rows or ``max_latency_ms``
elapses, then dispatch as ONE device call (``engine.run_padded``) and
the results scatter back to per-request futures, with:

* **backpressure**: a bounded row budget; ``submit`` raises
  :class:`Backpressure` instead of queueing without bound;
* **deadlines**: a request may carry ``timeout_ms``; one whose deadline
  passed by dispatch time fails with :class:`DeadlineExceeded`;
* **circuit breaking**: an optional :class:`CircuitBreaker` turns
  consecutive dispatch failures into fail-fast :class:`CircuitOpen`.

Requests of different output kinds (predict / raw / extract[node])
cannot share a device call, so pending work is grouped per
``(kind, node)`` and each group flushes on its own.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..resilience import CircuitBreaker, CircuitOpen
from ..telemetry.registry import REGISTRY
from ..telemetry.disttrace import DISTTRACE
from ..telemetry.trace import TRACER
from .engine import InferenceEngine
from .stats import ServingStats


class Backpressure(RuntimeError):
    """Queue row budget exhausted; retry later (HTTP 503)."""


class DeadlineExceeded(TimeoutError):
    """Request expired before its batch dispatched (HTTP 504)."""


class _Request:
    __slots__ = ("rows", "kind", "node", "future", "t_submit", "deadline",
                 "ctx")

    def __init__(self, rows, kind, node, deadline):
        self.rows = rows
        self.kind = kind
        self.node = node
        self.future: Future = Future()
        self.t_submit = time.perf_counter()
        self.deadline = deadline          # perf_counter abs, or None
        # the submitting thread's distributed-trace context (the HTTP
        # handler's serve.request span): the worker parents this
        # request's queue wait, batch assembly and infer under it
        self.ctx = DISTTRACE.current()


class MicroBatcher:
    def __init__(self, engine: InferenceEngine,
                 max_batch: Optional[int] = None,
                 max_latency_ms: float = 5.0,
                 max_queue_rows: int = 1024,
                 default_timeout_ms: Optional[float] = None,
                 stats: Optional[ServingStats] = None,
                 breaker: Optional[CircuitBreaker] = None):
        self.engine = engine
        self.stats = stats or engine.stats
        self.breaker = breaker
        # a dispatch larger than the engine's top bucket could never run
        # as one device call
        self.max_batch = min(int(max_batch or engine.max_batch),
                             engine.max_batch)
        self.max_latency_s = max_latency_ms / 1e3
        self.max_queue_rows = int(max_queue_rows)
        self.default_timeout_ms = default_timeout_ms
        self._q: "queue.Queue[_Request]" = queue.Queue()
        self._rows_lock = threading.Lock()
        self._queued_rows = 0
        # flushes between their row release and their last dispatch
        self._dispatching = 0
        # live-work probes (the LM scheduler's live sequences): counts of
        # in-flight work outside the row accounting
        self._live_probes: List = []
        self._g_depth_fam = REGISTRY.gauge(
            "cxxnet_serve_queue_rows",
            "Rows admitted to the micro-batcher but not yet dispatched",
            labels=("engine",))
        self._g_depth = self._g_depth_fam.labels(self.stats.instance)
        self._stop = threading.Event()
        self._drain = True
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="serve-batcher")
        self._thread.start()

    # -- client side -----------------------------------------------------
    def submit(self, data, kind: str = "predict",
               node: Optional[str] = None,
               timeout_ms: Optional[float] = None) -> Future:
        """Enqueue one request; returns a Future of its result rows.
        Raises ValueError on a malformed request, Backpressure when the
        row budget is full, CircuitOpen when the breaker is open."""
        rows = self.engine._to_input(data)
        if rows.shape[0] == 0:
            raise ValueError("empty request")
        if rows.shape[0] > self.max_batch:
            raise ValueError(
                f"request rows {rows.shape[0]} > max_batch "
                f"{self.max_batch}; split client-side or call the engine "
                "directly")
        self.stats.record_request()
        # breaker gate after input validation (a malformed request is the
        # client's fault) and before queueing (fail fast)
        if self.breaker is not None and not self.breaker.allow():
            self.stats.record_reject("breaker")
            raise CircuitOpen(
                f"serve circuit breaker open ({self.breaker.state}); "
                "device dispatches are failing — retry later")
        if timeout_ms is None:
            timeout_ms = self.default_timeout_ms
        deadline = (time.perf_counter() + timeout_ms / 1e3
                    if timeout_ms else None)
        req = _Request(rows, kind, node, deadline)
        # stop-check and put under the lock close() sets _stop under, so
        # no request lands after the worker's final drain
        with self._rows_lock:
            if self._stop.is_set():
                raise RuntimeError("batcher is shut down")
            if self._queued_rows + rows.shape[0] > self.max_queue_rows:
                self.stats.record_reject("backpressure")
                raise Backpressure(
                    f"serve queue full ({self._queued_rows} rows "
                    f">= {self.max_queue_rows})")
            self._queued_rows += rows.shape[0]
            self._g_depth.set(self._queued_rows)
            self._q.put(req)
        return req.future

    def close(self, drain: bool = True, timeout: Optional[float] = 30.0
              ) -> None:
        """Stop the worker. ``drain=True`` serves everything already
        queued first; ``drain=False`` rejects it."""
        self._drain = drain
        with self._rows_lock:
            self._stop.set()
        self._q.put(None)                 # wake the worker
        self._thread.join(timeout=timeout)
        self._g_depth_fam.remove_labels(self.stats.instance)

    @property
    def queued_rows(self) -> int:
        with self._rows_lock:
            return self._queued_rows

    def add_idle_probe(self, probe) -> None:
        """Register a live-work probe (a callable returning a count of
        in-flight items) that must read 0 before :attr:`idle` is True.
        The LM scheduler registers its live-sequence count: a drained
        batcher with decodes still holding KV blocks is not idle, and a
        weights swap then would hand a sequence logits from a model that
        never saw its prefix."""
        with self._rows_lock:
            self._live_probes.append(probe)

    @property
    def idle(self) -> bool:
        """No row admitted, no flush mid-dispatch, and every live-work
        probe at 0: what a hot reload drains to. ``queued_rows`` alone
        is not enough, because ``_flush`` releases the rows before the
        device call."""
        with self._rows_lock:
            probes = list(self._live_probes)
            if self._queued_rows != 0 or self._dispatching != 0:
                return False
        return all(int(p()) == 0 for p in probes)

    # -- worker side -----------------------------------------------------
    def _release(self, reqs: List[_Request]) -> None:
        n = sum(r.rows.shape[0] for r in reqs)
        with self._rows_lock:
            self._queued_rows -= n
            self._g_depth.set(self._queued_rows)

    def _flush(self, reqs: List[_Request]) -> None:
        """Reject expired requests, then dispatch the group in chunks of
        at most ``max_batch`` rows."""
        with self._rows_lock:
            # keeps `idle` False across the release -> dispatch gap
            self._dispatching += 1
        try:
            self._release(reqs)
            now = time.perf_counter()
            live: List[_Request] = []
            for r in reqs:
                if r.deadline is not None and now > r.deadline:
                    self.stats.record_reject("deadline")
                    r.future.set_exception(DeadlineExceeded(
                        "request expired before dispatch"))
                else:
                    live.append(r)
            chunk: List[_Request] = []
            n_rows = 0
            for r in live:
                if chunk and n_rows + r.rows.shape[0] > self.max_batch:
                    self._dispatch(chunk)
                    chunk, n_rows = [], 0
                chunk.append(r)
                n_rows += r.rows.shape[0]
            if chunk:
                self._dispatch(chunk)
        finally:
            with self._rows_lock:
                self._dispatching -= 1

    def _dispatch(self, live: List[_Request]) -> None:
        """ONE device call for one chunk; scatter results to futures."""
        # queue wait: the earliest member's submit to now, on the
        # worker's track
        t_now = time.perf_counter()
        TRACER.add_complete("serve.queue_wait",
                            min(r.t_submit for r in live),
                            t_now, cat="serve",
                            args={"requests": len(live)})
        with TRACER.span("serve.batch_assembly", cat="serve",
                         args={"requests": len(live)}):
            rows = (live[0].rows if len(live) == 1
                    else np.concatenate([r.rows for r in live], axis=0))
        t_asm1 = time.perf_counter()
        try:
            out = self.engine.run_padded(rows, live[0].kind, live[0].node)
        except Exception as e:   # reported to every waiting client
            if self.breaker is not None:
                self.breaker.record_failure()
            for r in live:
                self.stats.record_failure()
                r.future.set_exception(e)
            return
        if self.breaker is not None:
            self.breaker.record_success()
        if DISTTRACE.enabled:
            # each request's segments, parented across the thread hop
            # onto its serve.request span (a batch's members share the
            # assembly and infer wall time)
            t_infer1 = time.perf_counter()
            for r in live:
                if r.ctx is not None:
                    DISTTRACE.record("serve.queue_wait", r.t_submit,
                                     t_now, r.ctx, cat="serve",
                                     args={"requests": len(live)})
                    DISTTRACE.record("serve.batch_assembly", t_now,
                                     t_asm1, r.ctx, cat="serve",
                                     args={"requests": len(live)})
                    DISTTRACE.record("serve.infer", t_asm1, t_infer1,
                                     r.ctx, cat="serve",
                                     args={"rows": int(rows.shape[0])})
        self.stats.record_batch(
            n_requests=len(live), rows_real=rows.shape[0],
            rows_bucket=self.engine.bucket_for(rows.shape[0]))
        off = 0
        t_done = time.perf_counter()
        for r in live:
            n = r.rows.shape[0]
            r.future.set_result(out[off:off + n])
            self.stats.record_done(t_done - r.t_submit)
            off += n

    def _worker(self) -> None:
        # pending groups: (kind, node) -> (first_arrival_t, [requests])
        pending: Dict[Tuple[str, Optional[str]],
                      Tuple[float, List[_Request]]] = {}

        def group_rows(reqs: List[_Request]) -> int:
            return sum(r.rows.shape[0] for r in reqs)

        def group_due(t0: float, reqs: List[_Request]) -> float:
            """When this group must dispatch: the latency window's end,
            or 50 ms before the earliest member deadline if sooner (a
            queue wakeup can slip several ms past its timeout)."""
            due = t0 + self.max_latency_s
            dls = [r.deadline for r in reqs if r.deadline is not None]
            if dls:
                due = min(due, min(dls) - 0.05)
            return due

        def flush_due(force: bool = False) -> None:
            now = time.perf_counter()
            for key in list(pending):
                t0, reqs = pending[key]
                if force or now >= group_due(t0, reqs) \
                        or group_rows(reqs) >= self.max_batch:
                    del pending[key]
                    self._flush(reqs)

        while True:
            stopping = self._stop.is_set()
            if pending:
                t_next = min(group_due(t0, reqs)
                             for t0, reqs in pending.values())
                wait = max(0.0, t_next - time.perf_counter())
            else:
                wait = 0.1
            try:
                # once stopping, drain what is queued without waiting
                req = self._q.get_nowait() if stopping \
                    else self._q.get(timeout=wait)
            except queue.Empty:
                if stopping:                  # queue fully drained
                    if self._drain:
                        flush_due(force=True)
                    else:
                        err = RuntimeError("batcher shut down")
                        for _t0, reqs in pending.values():
                            self._release(reqs)
                            for r in reqs:
                                r.future.set_exception(err)
                        pending.clear()
                    break
                flush_due()
                continue
            if req is None:                   # shutdown sentinel
                continue                      # keep draining until Empty
            if stopping and not self._drain:
                self._release([req])
                req.future.set_exception(RuntimeError("batcher shut down"))
                continue
            key = (req.kind, req.node)
            t0, reqs = pending.get(key, (time.perf_counter(), []))
            reqs.append(req)
            pending[key] = (t0, reqs)
            if group_rows(reqs) >= self.max_batch:
                del pending[key]
                self._flush(reqs)
            else:
                flush_due()
