"""Serving statistics: request outcomes, latency percentiles, batch fill,
cell-cache hits (the port of ``cxxnet_tpu/serve/stats.py``).

A view over the process-wide telemetry registry, as in the JAX package:
every counter is a ``cxxnet_serve_*`` registry series labelled by the
engine's ``instance`` (the replicas of a fleet stay apart in a
``/metrics`` scrape), and :meth:`ServingStats.snapshot`, the ``/statz``
payload, reads the same series back in the JAX package's key layout,
with the LM plane's block under ``lm`` once one is attached. Latencies
also feed ``cxxnet_serve_request_latency_seconds``; the p50/p95/p99 of
the snapshot come from a bounded local reservoir. An optional
:class:`telemetry.SLOTracker` (``slo``) records every terminal outcome
too. Thread-safe: the batcher worker, the HTTP handler threads and the
engine all write here.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from ..telemetry.registry import REGISTRY, MetricRegistry

_INSTANCE_SEQ = itertools.count()


class ServingStats:
    """Rolling serving metrics.

    * latency: bounded sample reservoir (last ``max_samples`` request
      latencies) -> p50/p95/p99 at snapshot time, plus the registry
      latency histogram;
    * QPS: completion timestamps within a rolling ``qps_window_s`` window;
    * batch fill: real rows / padded bucket rows, per dispatch;
    * coalescing: requests folded into each device call;
    * compile cache: hit/miss/evict counters fed by the engine.
    """

    def __init__(self, max_samples: int = 4096, qps_window_s: float = 60.0,
                 registry: Optional[MetricRegistry] = None):
        self._lock = threading.Lock()
        self._t0 = time.time()
        self.qps_window_s = qps_window_s
        self._lat: deque = deque(maxlen=max_samples)       # seconds
        self._done_ts: deque = deque(maxlen=65536)         # completion times
        reg = registry or REGISTRY
        self.instance = str(next(_INSTANCE_SEQ))
        eng = (self.instance,)
        # every (family, label-values) this instance creates, so
        # unregister() drops them when the engine goes away
        self._series = []

        def _track(fam, *vals):
            self._series.append((fam, vals))
            return fam.labels(*vals)
        req = reg.counter("cxxnet_serve_requests_total",
                          "Serve requests by outcome",
                          labels=("engine", "result"))
        self._c_total = _track(req, self.instance, "received")
        self._c_ok = _track(req, self.instance, "ok")
        self._c_rej_bp = _track(req, self.instance, "rejected_backpressure")
        self._c_rej_dl = _track(req, self.instance, "rejected_deadline")
        self._c_rej_br = _track(req, self.instance, "rejected_breaker")
        self._c_failed = _track(req, self.instance, "failed")
        self._c_batches = _track(reg.counter(
            "cxxnet_serve_batches_dispatched_total",
            "Device dispatches", labels=("engine",)), *eng)
        self._c_req_batched = _track(reg.counter(
            "cxxnet_serve_requests_batched_total",
            "Requests folded into dispatches",
            labels=("engine",)), *eng)
        rows = reg.counter("cxxnet_serve_batch_rows_total",
                           "Dispatched rows (real vs padded-bucket)",
                           labels=("engine", "kind"))
        self._c_rows_real = _track(rows, self.instance, "real")
        self._c_rows_padded = _track(rows, self.instance, "padded")
        self._c_coalesced = _track(reg.counter(
            "cxxnet_serve_batches_coalesced_total",
            "Dispatches that folded >= 2 requests",
            labels=("engine",)), *eng)
        cache = reg.counter("cxxnet_serve_cache_events_total",
                            "Compile-cache events",
                            labels=("engine", "event"))
        self._c_hit = _track(cache, self.instance, "hit")
        self._c_miss = _track(cache, self.instance, "miss")
        self._c_evict = _track(cache, self.instance, "evict")
        self._g_csize = _track(reg.gauge("cxxnet_serve_cache_size",
                                         "Compiled executables cached",
                                         labels=("engine",)), *eng)
        self._g_ccap = _track(reg.gauge("cxxnet_serve_cache_capacity",
                                        "Compile-cache capacity",
                                        labels=("engine",)), *eng)
        self._h_lat = _track(reg.histogram(
            "cxxnet_serve_request_latency_seconds",
            "End-to-end request latency (submit -> result)",
            labels=("engine",)), *eng)
        # the latency-SLO tracker (telemetry.SLOTracker), set by the
        # replica when serve_slo_ms > 0; every terminal outcome feeds it
        self.slo = None
        # the LM plane's snapshot (LMScheduler.snapshot), set by
        # ReplicaPool.attach_lm; /statz shows it as "lm"
        self.lm = None

    # -- registry-backed attribute views ---------------------------------
    @property
    def requests_total(self) -> int:
        return int(self._c_total.value)

    @property
    def requests_ok(self) -> int:
        return int(self._c_ok.value)

    @property
    def rejected_backpressure(self) -> int:
        return int(self._c_rej_bp.value)

    @property
    def rejected_deadline(self) -> int:
        return int(self._c_rej_dl.value)

    @property
    def rejected_breaker(self) -> int:
        return int(self._c_rej_br.value)

    @property
    def failed(self) -> int:
        return int(self._c_failed.value)

    @property
    def batches_dispatched(self) -> int:
        return int(self._c_batches.value)

    @property
    def rows_real(self) -> int:
        return int(self._c_rows_real.value)

    @property
    def rows_padded(self) -> int:
        return int(self._c_rows_padded.value)

    @property
    def requests_batched(self) -> int:
        return int(self._c_req_batched.value)

    @property
    def batches_coalesced_ge2(self) -> int:
        return int(self._c_coalesced.value)

    @property
    def cache_hits(self) -> int:
        return int(self._c_hit.value)

    @property
    def cache_misses(self) -> int:
        return int(self._c_miss.value)

    @property
    def cache_evictions(self) -> int:
        return int(self._c_evict.value)

    @property
    def cache_size(self) -> int:
        return int(self._g_csize.value)

    @property
    def cache_capacity(self) -> int:
        return int(self._g_ccap.value)

    def unregister(self) -> None:
        """Drop this instance's series from the registry (a replica's
        close calls this): a torn-down engine's numbers must not appear
        in scrapes forever. Held child references keep working; they
        stop exporting."""
        for fam, vals in self._series:
            fam.remove_labels(*vals)
        if self.slo is not None:
            self.slo.unregister()

    # -- recording -------------------------------------------------------
    def record_request(self) -> None:
        self._c_total.inc()

    def record_reject(self, kind: str) -> None:
        if kind == "backpressure":
            self._c_rej_bp.inc()
        elif kind == "breaker":
            self._c_rej_br.inc()
        else:
            self._c_rej_dl.inc()
        if self.slo is not None:       # a rejected client missed the SLO
            self.slo.record(ok=False)

    def record_failure(self) -> None:
        self._c_failed.inc()
        if self.slo is not None:
            self.slo.record(ok=False)

    def record_done(self, latency_s: float) -> None:
        now = time.time()
        self._c_ok.inc()
        self._h_lat.observe(latency_s)
        if self.slo is not None:
            self.slo.record(latency_s=latency_s, ok=True)
        with self._lock:
            self._lat.append(latency_s)
            self._done_ts.append(now)

    def record_batch(self, n_requests: int, rows_real: int,
                     rows_bucket: int) -> None:
        self._c_batches.inc()
        self._c_req_batched.inc(n_requests)
        self._c_rows_real.inc(rows_real)
        self._c_rows_padded.inc(rows_bucket)
        if n_requests >= 2:
            self._c_coalesced.inc()

    def record_cache(self, hit: Optional[bool] = None,
                     size: Optional[int] = None,
                     capacity: Optional[int] = None,
                     evicted: bool = False) -> None:
        """``hit=None`` updates geometry only (no hit/miss tick)."""
        if hit is True:
            self._c_hit.inc()
        elif hit is False:
            self._c_miss.inc()
        if evicted:
            self._c_evict.inc()
        if size is not None:
            self._g_csize.set(size)
        if capacity is not None:
            self._g_ccap.set(capacity)

    # -- reading ---------------------------------------------------------
    def latency_samples(self) -> List[float]:
        """Copy of the latency reservoir (seconds): a fleet pools these
        across replicas, so its percentiles come from the pooled
        observations, not from averaged percentiles."""
        with self._lock:
            return list(self._lat)

    def snapshot_uptime(self) -> float:
        return max(time.time() - self._t0, 1e-9)

    def recent_qps(self) -> float:
        """Completions per second over the rolling window (the same
        number snapshot()['qps'] reports)."""
        now = time.time()
        uptime = max(now - self._t0, 1e-9)
        window = min(self.qps_window_s, uptime)
        if not window:
            return 0.0
        cutoff = now - window
        with self._lock:
            recent = sum(1 for t in self._done_ts if t >= cutoff)
        return recent / window

    @staticmethod
    def _pct(sorted_vals: List[float], q: float) -> float:
        if not sorted_vals:
            return 0.0
        idx = min(len(sorted_vals) - 1,
                  max(0, int(round(q * (len(sorted_vals) - 1)))))
        return sorted_vals[idx]

    def snapshot(self) -> Dict:
        """The ``/statz`` payload (the JAX package's key layout). The
        reservoir is copied under this object's lock and sorted outside
        it, so a poller never stalls the dispatch path."""
        with self._lock:
            lat_raw = list(self._lat)
        uptime = self.snapshot_uptime()
        qps = self.recent_qps()       # one definition of the window
        lat = sorted(lat_raw)
        rows_real, rows_padded = self.rows_real, self.rows_padded
        b_disp, req_batched = self.batches_dispatched, self.requests_batched
        fill = rows_real / rows_padded if rows_padded else 0.0
        rpb = req_batched / b_disp if b_disp else 0.0
        return {
            "uptime_s": round(uptime, 3),
            "requests": {
                "total": self.requests_total,
                "ok": self.requests_ok,
                "rejected_backpressure": self.rejected_backpressure,
                "rejected_deadline": self.rejected_deadline,
                "rejected_breaker": self.rejected_breaker,
                "failed": self.failed,
            },
            "qps": round(qps, 3),
            "latency_ms": {
                "p50": round(1e3 * self._pct(lat, 0.50), 3),
                "p95": round(1e3 * self._pct(lat, 0.95), 3),
                "p99": round(1e3 * self._pct(lat, 0.99), 3),
                "mean": round(1e3 * sum(lat) / len(lat), 3)
                        if lat else 0.0,
                "samples": len(lat),
            },
            "batches": {
                "dispatched": b_disp,
                "coalesced_ge2": self.batches_coalesced_ge2,
                "avg_requests_per_batch": round(rpb, 3),
                "fill_ratio": round(fill, 4),
                "rows_real": rows_real,
                "rows_padded": rows_padded,
            },
            "compile_cache": {
                "hits": self.cache_hits,
                "misses": self.cache_misses,
                "evictions": self.cache_evictions,
                "size": self.cache_size,
                "capacity": self.cache_capacity,
            },
            **({"lm": self.lm()} if self.lm is not None else {}),
        }

    def log_line(self) -> str:
        """One periodic log line: ``serve[   12 sec]\\tqps:3.2 ...``."""
        s = self.snapshot()
        return ("serve[%5d sec]\tqps:%.2f\tp50_ms:%.2f\tp95_ms:%.2f"
                "\tp99_ms:%.2f\tfill:%.3f\tcache_hit:%d\tcache_miss:%d"
                "\tok:%d\trej:%d" % (
                    s["uptime_s"], s["qps"], s["latency_ms"]["p50"],
                    s["latency_ms"]["p95"], s["latency_ms"]["p99"],
                    s["batches"]["fill_ratio"], s["compile_cache"]["hits"],
                    s["compile_cache"]["misses"], s["requests"]["ok"],
                    s["requests"]["rejected_backpressure"]
                    + s["requests"]["rejected_deadline"]
                    + s["requests"]["rejected_breaker"]))
