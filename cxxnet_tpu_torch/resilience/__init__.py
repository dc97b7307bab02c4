"""Fault tolerance of the port (the port of ``cxxnet_tpu/resilience``):

* :mod:`.failpoints`: named, env/config-driven fault-injection sites;
* :mod:`.sentinel`: :class:`TrainingSentinel`, the loss NaN / spike
  watchdog behind the round loop's rollback;
* :mod:`.breaker`: :class:`CircuitBreaker` of the serve dispatch path;
* :mod:`.retry`: :func:`retry_call`, the full-jitter backoff of remote
  streams and data-service fetches (``io.retries``).

Plus the process-wide :data:`counters` (corrupt records skipped,
checkpoint write failures, sentinel trips and rollbacks), a view over
the telemetry registry: a dotted name ``ckpt.write_failures`` is the
counter ``cxxnet_ckpt_write_failures_total`` in a ``/metrics`` scrape,
and ``/statz`` shows them under ``counters``.
"""

from __future__ import annotations

import threading
from typing import Dict

from ..telemetry.registry import REGISTRY


def _prom_name(dotted: str) -> str:
    """``"ckpt.write_failures"`` -> ``"cxxnet_ckpt_write_failures_total"``."""
    return "cxxnet_" + dotted.replace(".", "_").replace("-", "_") \
        + "_total"


class Counters:
    """Thread-safe named counters stored in the telemetry registry, one
    ``cxxnet_*_total`` counter a dotted name; this class keeps the name
    mapping, so ``/statz`` shows the dotted keys."""

    def __init__(self, registry=None):
        self._lock = threading.Lock()
        self._reg = registry or REGISTRY
        self._children: Dict[str, object] = {}

    def _child(self, name: str):
        with self._lock:
            c = self._children.get(name)
            if c is None:
                c = self._reg.counter(
                    _prom_name(name),
                    help=f"cxxnet degradation counter {name}").labels()
                self._children[name] = c
            return c

    def inc(self, name: str, n: int = 1) -> None:
        self._child(name).inc(n)

    def get(self, name: str) -> int:
        return int(self._child(name).value)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            items = list(self._children.items())
        return {name: int(c.value) for name, c in items}

    def reset(self) -> None:
        with self._lock:
            items = list(self._children.values())
            self._children.clear()
        for c in items:
            c._reset()


counters = Counters()

from . import failpoints                                    # noqa: E402
from .breaker import CircuitBreaker, CircuitOpen            # noqa: E402
from .failpoints import InjectedFault                       # noqa: E402
from .retry import retry_call                               # noqa: E402
from .sentinel import SentinelAbort, TrainingSentinel       # noqa: E402

__all__ = [
    "counters", "failpoints", "InjectedFault", "retry_call",
    "SentinelAbort", "TrainingSentinel", "CircuitBreaker", "CircuitOpen",
]
