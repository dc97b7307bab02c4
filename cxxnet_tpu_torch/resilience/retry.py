"""Exponential backoff with full jitter for transient IO failures (the
port's copy of ``cxxnet_tpu/resilience/retry.py``).

:func:`retry_call` wraps a thunk: attempt ``i`` that fails sleeps
``cap * (1 - jitter + jitter * rng())`` with ``cap = min(max_delay,
base * 2**i)`` before the next, and counts ``io.retries``. The stream
layer (``io/stream.py``) runs every remote operation, and every local
one while an ``io.*`` failpoint is armed, through it; the data-service
client runs each fetch through it. The knobs come as a
:class:`cxxnet_tpu_torch.config.RetryPolicy` (``io_retry_attempts``,
``io_retry_base_ms``, ``io_retry_max_ms``, ``io_retry_jitter``).
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional, Tuple, Type

from . import counters


def retry_call(fn: Callable, *, what: str = "",
               attempts: int = 4,
               base_delay_s: float = 0.05,
               max_delay_s: float = 2.0,
               jitter: float = 1.0,
               retry_on: Tuple[Type[BaseException], ...] = (OSError,),
               sleep: Callable[[float], None] = time.sleep,
               rng: Callable[[], float] = random.random,
               on_retry: Optional[Callable] = None):
    """``fn()`` with up to ``attempts`` tries. ``jitter`` in [0, 1]: 0
    sleeps the whole backoff, 1 a uniform share of it. ``sleep`` and
    ``rng`` are injectable; ``on_retry(i, exc, delay)`` sees each retry.
    The last failure is raised unchanged."""
    if attempts < 1:
        raise ValueError(f"retry attempts must be >= 1, got {attempts}")
    for i in range(attempts):
        try:
            return fn()
        except retry_on as e:
            if i == attempts - 1:
                raise
            cap = min(max_delay_s, base_delay_s * (2.0 ** i))
            delay = cap * (1.0 - jitter + jitter * rng())
            counters.inc("io.retries")
            if on_retry is not None:
                on_retry(i, e, delay)
            sleep(delay)
    raise AssertionError("unreachable")
