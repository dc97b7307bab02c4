"""Serve SLO tracking: good/bad request accounting and burn rate (the
port of ``cxxnet_tpu/telemetry/slo.py``), exported as the registry's
``cxxnet_serve_slo_*`` series.

The operator declares an SLO, "``serve_slo_target`` of requests complete
OK within ``serve_slo_ms``", and this tracker classifies every finished
request:

* **good**: served successfully within the latency objective;
* **bad**: over the objective, failed, or rejected (backpressure,
  breaker, deadline): the client missed either way.

Two readings come out:

* **attainment**: lifetime good / total;
* **burn rate**: (bad fraction over the rolling ``window_s``) / (1 -
  target), how fast the error budget is being spent now. 1.0 is exactly
  sustainable; at ``serve_slo_burn_degraded`` or over, ``/healthz`` reads
  ``degraded`` and the fleet's admission control sheds load.

The window is a ring of per-second (good, bad) buckets: O(1) memory and
update. Thread-safe; stdlib only.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Tuple

from .registry import REGISTRY, MetricRegistry


class SLOTracker:
    def __init__(self, slo_ms: float, target: float = 0.99,
                 window_s: float = 60.0, instance: str = "0",
                 registry: Optional[MetricRegistry] = None,
                 clock=time.monotonic):
        if slo_ms <= 0:
            raise ValueError(f"slo_ms must be > 0, got {slo_ms}")
        if not 0.0 < target < 1.0:
            raise ValueError(
                f"slo target must be in (0, 1), got {target}")
        self.slo_s = float(slo_ms) / 1e3
        self.target = float(target)
        self.window_s = max(1, int(round(window_s)))
        self.instance = str(instance)
        self._clock = clock
        self._lock = threading.Lock()
        # slot i covers the second s with s % window_s == i; _sec says
        # which second a slot holds, so a stale lap is zeroed on reuse
        n = self.window_s
        self._good = [0] * n
        self._bad = [0] * n
        self._sec = [-1] * n
        self._tot_good = 0
        self._tot_bad = 0
        reg = registry or REGISTRY
        self._reg = reg
        slo_req = reg.counter(
            "cxxnet_serve_slo_requests_total",
            "Terminal requests classified against the latency SLO",
            labels=("engine", "result"))
        self._c_good = slo_req.labels(self.instance, "good")
        self._c_bad = slo_req.labels(self.instance, "bad")
        self._g_burn = reg.gauge(
            "cxxnet_serve_slo_burn_rate",
            "Error-budget burn rate over the rolling window "
            "(1.0 = exactly sustainable)", labels=("engine",)
        ).labels(self.instance)
        self._g_burn.set_function(self.burn_rate)
        reg.gauge("cxxnet_serve_slo_ms", "Latency objective (ms)",
                  labels=("engine",)).labels(self.instance).set(slo_ms)
        reg.gauge("cxxnet_serve_slo_target", "Availability objective",
                  labels=("engine",)).labels(self.instance).set(target)

    def unregister(self) -> None:
        """Drop this engine's SLO series (the replica's teardown, as
        ``ServingStats.unregister``)."""
        for name in ("cxxnet_serve_slo_burn_rate", "cxxnet_serve_slo_ms",
                     "cxxnet_serve_slo_target"):
            fam = self._reg.get(name)
            if fam is not None:
                fam.remove_labels(self.instance)
        fam = self._reg.get("cxxnet_serve_slo_requests_total")
        if fam is not None:
            fam.remove_labels(self.instance, "good")
            fam.remove_labels(self.instance, "bad")

    # -- recording -------------------------------------------------------
    def record(self, latency_s: Optional[float] = None,
               ok: bool = True) -> None:
        """One terminal request: ``ok=False`` (failure/rejection) or a
        latency over the objective is bad; everything else good."""
        good = bool(ok) and latency_s is not None \
            and latency_s <= self.slo_s
        sec = int(self._clock())
        i = sec % self.window_s
        with self._lock:
            if self._sec[i] != sec:
                self._sec[i] = sec
                self._good[i] = 0
                self._bad[i] = 0
            if good:
                self._good[i] += 1
                self._tot_good += 1
            else:
                self._bad[i] += 1
                self._tot_bad += 1
        (self._c_good if good else self._c_bad).inc()

    # -- reading ---------------------------------------------------------
    def _window_counts(self) -> Tuple[int, int]:
        now_sec = int(self._clock())
        lo = now_sec - self.window_s + 1
        g = b = 0
        with self._lock:
            for i in range(self.window_s):
                if lo <= self._sec[i] <= now_sec:
                    g += self._good[i]
                    b += self._bad[i]
        return g, b

    def burn_rate(self) -> float:
        """(bad fraction in the window) / error budget; 0 with no
        traffic (an idle endpoint is not spending budget)."""
        g, b = self._window_counts()
        total = g + b
        if total == 0:
            return 0.0
        return (b / total) / (1.0 - self.target)

    def attainment(self) -> float:
        """Lifetime good / total (1.0 with no traffic)."""
        with self._lock:
            total = self._tot_good + self._tot_bad
            return self._tot_good / total if total else 1.0

    def snapshot(self) -> Dict:
        g, b = self._window_counts()
        with self._lock:
            tot_g, tot_b = self._tot_good, self._tot_bad
        return {
            "slo_ms": round(self.slo_s * 1e3, 3),
            "target": self.target,
            "window_s": self.window_s,
            "window_good": g,
            "window_bad": b,
            "burn_rate": round(self.burn_rate(), 4),
            "attainment": round(self.attainment(), 6),
            "good": tot_g,
            "bad": tot_b,
        }
