"""Circuit breaker of the serve dispatch path (the port's copy of
``cxxnet_tpu/resilience/breaker.py``). Every transition is a
``breaker_transition`` event in the run ledger.

* **closed**: normal; ``failure_threshold`` consecutive dispatch
  failures trip it open (one success resets the streak);
* **open**: every request is rejected at once (HTTP 503) until
  ``reset_timeout_s`` elapses;
* **half_open**: one probe request is let through; success closes the
  breaker, failure re-opens it.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict

from ..telemetry.ledger import LEDGER


class CircuitOpen(RuntimeError):
    """Breaker is open: fail fast, retry later (HTTP 503)."""


class CircuitBreaker:
    def __init__(self, failure_threshold: int = 5,
                 reset_timeout_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        if failure_threshold < 1:
            raise ValueError(
                f"failure_threshold must be >= 1, got {failure_threshold}")
        self.failure_threshold = int(failure_threshold)
        self.reset_timeout_s = float(reset_timeout_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = "closed"              # closed | open | half_open
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._probe_at = 0.0
        self.opens = 0
        self.probes = 0
        self.rejections = 0

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def effective_state(self) -> str:
        """State as /healthz reports it: an open breaker past its reset
        timeout reads "half_open" (probe-ready)."""
        with self._lock:
            if self._state == "open" \
                    and self._clock() - self._opened_at \
                    >= self.reset_timeout_s:
                return "half_open"
            return self._state

    def allow(self) -> bool:
        """May a new request be admitted now? An open breaker past its
        reset timeout admits one probe; a probe that never reports back
        is replaced after another reset period."""
        with self._lock:
            if self._state == "closed":
                return True
            now = self._clock()
            if self._state == "open":
                if now - self._opened_at >= self.reset_timeout_s:
                    self._set_state("half_open")
                    self._probe_at = now
                    self.probes += 1
                    return True
                self.rejections += 1
                return False
            if now - self._probe_at >= self.reset_timeout_s:
                self._probe_at = now
                self.probes += 1
                return True
            self.rejections += 1
            return False

    def record_success(self) -> None:
        with self._lock:
            self._consecutive_failures = 0
            self._set_state("closed")

    def record_failure(self) -> None:
        with self._lock:
            if self._state == "half_open":
                self._trip()
                return
            self._consecutive_failures += 1
            if self._consecutive_failures >= self.failure_threshold:
                self._trip()

    def _set_state(self, new: str) -> None:
        """A transition and its ledger event (under the lock; the
        ledger append is a local file write)."""
        if new == self._state:
            return
        old, self._state = self._state, new
        LEDGER.event("breaker_transition", from_state=old, to_state=new,
                     consecutive_failures=self._consecutive_failures,
                     opens=self.opens)

    def _trip(self) -> None:
        if self._state != "open":
            self.opens += 1
        self._set_state("open")
        self._opened_at = self._clock()
        self._consecutive_failures = 0

    def snapshot(self) -> Dict:
        with self._lock:
            return {
                "state": self._state,
                "failure_threshold": self.failure_threshold,
                "reset_timeout_s": self.reset_timeout_s,
                "consecutive_failures": self._consecutive_failures,
                "opens": self.opens,
                "probes": self.probes,
                "rejections": self.rejections,
            }
