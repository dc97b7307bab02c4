"""Serving statistics: request outcomes, latency percentiles, batch fill,
cell-cache hits (the port of ``cxxnet_tpu/serve/stats.py``).

:meth:`ServingStats.snapshot` is the ``/statz`` payload with the JAX
package's key layout, with the LM plane's block under ``lm`` once one is
attached. The counters are plain integers behind a lock;
the Prometheus ``/metrics`` registry that the JAX package exports them
through waits for ROADMAP Queue A 12. Each instance has its own
``instance`` id, so the replicas of a fleet stay distinguishable, and an
optional :class:`telemetry.SLOTracker` (``slo``) that every terminal
outcome is also recorded in. Thread-safe: the batcher worker, the HTTP
handler threads and the engine all write here.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Dict, List, Optional

_INSTANCE_SEQ = itertools.count()


class ServingStats:
    """Rolling serving metrics: a bounded latency reservoir (p50/p95/p99
    at snapshot time), completions within a rolling ``qps_window_s``,
    real/padded rows per dispatch, requests per dispatch, and the
    engine's cell-cache hits, misses and evictions."""

    _COUNTERS = ("requests_total", "requests_ok", "rejected_backpressure",
                 "rejected_deadline", "rejected_breaker", "failed",
                 "batches_dispatched", "requests_batched", "rows_real",
                 "rows_padded", "batches_coalesced_ge2", "cache_hits",
                 "cache_misses", "cache_evictions", "cache_size",
                 "cache_capacity")

    def __init__(self, max_samples: int = 4096, qps_window_s: float = 60.0):
        self._lock = threading.Lock()
        self.instance = str(next(_INSTANCE_SEQ))
        self._t0 = time.time()
        self.qps_window_s = qps_window_s
        self._lat: deque = deque(maxlen=max_samples)       # seconds
        self._done_ts: deque = deque(maxlen=65536)         # completion times
        for name in self._COUNTERS:
            setattr(self, name, 0)
        # the LM plane's snapshot (LMScheduler.snapshot), set by
        # ServeServer.attach_lm; /statz shows it as "lm"
        self.lm = None
        # the latency-SLO tracker (telemetry.SLOTracker), set by the
        # server or the fleet when serve_slo_ms > 0
        self.slo = None

    def _add(self, **deltas: int) -> None:
        with self._lock:
            for k, v in deltas.items():
                setattr(self, k, getattr(self, k) + v)

    # -- recording -------------------------------------------------------
    def record_request(self) -> None:
        self._add(requests_total=1)

    def record_reject(self, kind: str) -> None:
        key = {"backpressure": "rejected_backpressure",
               "breaker": "rejected_breaker"}.get(kind, "rejected_deadline")
        self._add(**{key: 1})
        if self.slo is not None:        # a rejected client missed the SLO
            self.slo.record(ok=False)

    def record_failure(self) -> None:
        self._add(failed=1)
        if self.slo is not None:
            self.slo.record(ok=False)

    def record_done(self, latency_s: float) -> None:
        now = time.time()
        with self._lock:
            self.requests_ok += 1
            self._lat.append(latency_s)
            self._done_ts.append(now)
        if self.slo is not None:
            self.slo.record(latency_s=latency_s, ok=True)

    def record_batch(self, n_requests: int, rows_real: int,
                     rows_bucket: int) -> None:
        self._add(batches_dispatched=1, requests_batched=n_requests,
                  rows_real=rows_real, rows_padded=rows_bucket,
                  batches_coalesced_ge2=int(n_requests >= 2))

    def record_cache(self, hit: Optional[bool] = None,
                     size: Optional[int] = None,
                     capacity: Optional[int] = None,
                     evicted: bool = False) -> None:
        """``hit=None`` updates the geometry only (no hit/miss tick)."""
        with self._lock:
            if hit is True:
                self.cache_hits += 1
            elif hit is False:
                self.cache_misses += 1
            if evicted:
                self.cache_evictions += 1
            if size is not None:
                self.cache_size = size
            if capacity is not None:
                self.cache_capacity = capacity

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
        """Completions per second over the rolling window."""
        now = time.time()
        window = min(self.qps_window_s, max(now - self._t0, 1e-9))
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
        """The ``/statz`` payload (the JAX package's key layout)."""
        with self._lock:
            lat = sorted(self._lat)
            c = {k: getattr(self, k) for k in self._COUNTERS}
        uptime = self.snapshot_uptime()
        qps = self.recent_qps()
        fill = c["rows_real"] / c["rows_padded"] if c["rows_padded"] else 0.0
        rpb = (c["requests_batched"] / c["batches_dispatched"]
               if c["batches_dispatched"] else 0.0)
        return {
            "uptime_s": round(uptime, 3),
            "requests": {
                "total": c["requests_total"],
                "ok": c["requests_ok"],
                "rejected_backpressure": c["rejected_backpressure"],
                "rejected_deadline": c["rejected_deadline"],
                "rejected_breaker": c["rejected_breaker"],
                "failed": c["failed"],
            },
            "qps": round(qps, 3),
            "latency_ms": {
                "p50": round(1e3 * self._pct(lat, 0.50), 3),
                "p95": round(1e3 * self._pct(lat, 0.95), 3),
                "p99": round(1e3 * self._pct(lat, 0.99), 3),
                "mean": round(1e3 * sum(lat) / len(lat), 3) if lat else 0.0,
                "samples": len(lat),
            },
            "batches": {
                "dispatched": c["batches_dispatched"],
                "coalesced_ge2": c["batches_coalesced_ge2"],
                "avg_requests_per_batch": round(rpb, 3),
                "fill_ratio": round(fill, 4),
                "rows_real": c["rows_real"],
                "rows_padded": c["rows_padded"],
            },
            "compile_cache": {
                "hits": c["cache_hits"],
                "misses": c["cache_misses"],
                "evictions": c["cache_evictions"],
                "size": c["cache_size"],
                "capacity": c["cache_capacity"],
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
