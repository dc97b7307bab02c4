"""TrainingSentinel: the loss NaN / spike watchdog with rollback
accounting (the port's copy of ``cxxnet_tpu/resilience/sentinel.py``).

The sentinel watches the per-step loss over a rolling window:

* **hard anomaly**: a NaN or Inf loss (or grad norm), always flagged;
* **spike**: a loss over ``spike_factor`` times the rolling median of
  the last ``window`` healthy losses, once ``min_history`` of them
  exist. ``spike_factor <= 0`` turns spike detection off (NaN and Inf
  detection stay on).

The sentinel never touches the trainer: the round loop in ``main.py``
owns the response, a ``Trainer.rollback`` to the newest valid round,
the LR scaled by ``lr_backoff``, and :class:`SentinelAbort` after
``max_rollbacks``.
"""

from __future__ import annotations

import math
import statistics
from collections import deque
from typing import List, Optional


class SentinelAbort(RuntimeError):
    """Too many rollbacks (or an anomaly with nothing to roll back to):
    the run is unrecoverable without operator intervention."""


class TrainingSentinel:
    def __init__(self, spike_factor: float = 10.0, window: int = 50,
                 min_history: int = 8, max_rollbacks: int = 3):
        if window < 1:
            raise ValueError(f"sentinel window must be >= 1, got {window}")
        self.spike_factor = float(spike_factor)
        self.min_history = int(min_history)
        self.max_rollbacks = int(max_rollbacks)
        self._hist: deque = deque(maxlen=int(window))
        self.observed = 0
        self.rollbacks = 0
        self.anomalies: List[str] = []       # human-readable event log

    # -- observation -----------------------------------------------------
    def observe(self, loss: float,
                grad_norm: Optional[float] = None) -> Optional[str]:
        """Feed one step's loss (and optionally grad norm). Returns None
        when healthy, else a reason string; anomalous values are NOT
        admitted to the rolling baseline."""
        self.observed += 1
        loss = float(loss)
        if not math.isfinite(loss):
            return self._anomaly(f"non-finite loss {loss} "
                                 f"(step obs #{self.observed})")
        if grad_norm is not None and not math.isfinite(float(grad_norm)):
            return self._anomaly(f"non-finite grad norm {grad_norm} "
                                 f"(step obs #{self.observed})")
        if (self.spike_factor > 0
                and len(self._hist) >= max(1, self.min_history)):
            med = statistics.median(self._hist)
            thresh = self.spike_factor * max(med, 1e-8)
            if loss > thresh:
                return self._anomaly(
                    f"loss spike {loss:.6g} > {self.spike_factor:g} x "
                    f"median {med:.6g} (step obs #{self.observed})")
        self._hist.append(loss)
        return None

    def _anomaly(self, reason: str) -> str:
        self.anomalies.append(reason)
        return reason

    # -- rollback accounting ---------------------------------------------
    def record_rollback(self, to_round: int, reason: str) -> None:
        """Account one rollback; raises :class:`SentinelAbort` when the
        budget is exhausted (the rollback that WOULD exceed it is not
        worth doing — the run has demonstrably stopped converging)."""
        self.rollbacks += 1
        self.anomalies.append(
            f"rollback #{self.rollbacks} -> round {to_round}: {reason}")
        if self.rollbacks > self.max_rollbacks:
            raise SentinelAbort(
                f"training aborted: {self.rollbacks} rollbacks exceed "
                f"max_rollbacks={self.max_rollbacks}\n" + self.report())

    def annotate_last(self, detail: str) -> None:
        """Append ``detail`` to the latest anomaly record (the round loop
        attaches the model-health provenance, ``layer=conv3 kind=grad``,
        once the walk ran)."""
        if detail and self.anomalies:
            self.anomalies[-1] += f" [{detail}]"

    def reset_window(self) -> None:
        """Drop the rolling baseline — after a rollback + LR backoff the
        old loss scale no longer describes the trajectory."""
        self._hist.clear()

    # -- reporting -------------------------------------------------------
    def report(self) -> str:
        lines = [f"sentinel report: {self.observed} observations, "
                 f"{self.rollbacks} rollbacks, "
                 f"{len(self.anomalies)} events"]
        lines += [f"  - {a}" for a in self.anomalies]
        return "\n".join(lines)
