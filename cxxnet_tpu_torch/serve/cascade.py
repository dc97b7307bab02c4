"""Cascade inference: a confidence router in front of a two-tier fleet
(the port of ``cxxnet_tpu/serve/cascade.py``).

The cheap tier (int8 replicas, ``ops/fused_quant.py``) answers every
request first; rows whose confidence clears ``cascade_threshold`` are
final, the rest escalate to the flagship (full-precision) tier. The
premise is that every row pays the cheap tier and only the escalated
fraction pays the flagship, so a request costs about fast latency +
escalation rate x flagship latency. Whether the int8 tier is cheaper on
a given card is a measurement, not a given: ``chip_smoke.py`` phase 18
prints the cascade's cost beside the flagship's alone.

Confidence of a row of the fast tier's raw output (softmax rows):

- ``margin``:  p1 - p2, the gap of the top two;
- ``entropy``: 1 - H(p)/log(k), so 1 is one-hot certain.

Rows of a single output column (a regression head) have no class
distribution to be confident about: they never escalate.

:class:`CascadeRouter` is a :class:`ReplicaPool` over both tiers'
replicas. A tier is a model version: the quantized round serves as
``rNNNN-int8``, the source round as ``rNNNN``. So the server's pool
surface (health, /statz, drain, version pins, per-version outcomes)
works unchanged, and only ``submit`` routes. Version-pinned requests
and ``extract`` (feature taps have no confidence) bypass the cascade.
The tiers' replicas share the cards as any fleet's do; on one H100
both tiers dispatch on ``cuda:0``'s default stream.

Rows count by the tier that answered them in
``cxxnet_cascade_rows_total{pool,tier}``, the escalated share is the
``cxxnet_cascade_escalation_rate{pool}`` gauge, and a request that
escalates is a ``cascade_escalate`` ledger event, as in the JAX package;
``cascade_stats`` (in ``/statz`` as ``cascade``) carries the same
counts.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..config import QuantConfig
from ..telemetry.ledger import LEDGER
from ..telemetry.registry import REGISTRY
from .fleet import Replica, ReplicaPool

_TINY = 1e-12


def row_confidence(probs: np.ndarray, metric: str = "margin") -> np.ndarray:
    """Per-row confidence in [0, 1] from raw output rows, in float64.
    Rows are renormalized (a linear head must not give NaN
    confidences)."""
    p = np.asarray(probs, np.float64)
    if p.ndim != 2:
        p = p.reshape(p.shape[0], -1)
    k = p.shape[1]
    if k < 2:
        return np.ones(p.shape[0])
    p = np.clip(p, 0.0, None)
    p = p / np.maximum(p.sum(axis=1, keepdims=True), _TINY)
    if metric == "entropy":
        h = -np.sum(p * np.log(np.maximum(p, _TINY)), axis=1)
        return 1.0 - h / np.log(k)
    top2 = np.partition(p, k - 2, axis=1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


class CascadeRouter(ReplicaPool):
    """Two-tier pool with confidence routing (see the module docstring).
    Build with :meth:`build_two_tier`, or pass built replicas and the
    two tier versions."""

    def __init__(self, replicas: Sequence[Replica], *,
                 fast_version: str, flagship_version: str,
                 qc: QuantConfig, admission_control: bool = True):
        super().__init__(replicas, admission_control=admission_control)
        if fast_version == flagship_version:
            raise ValueError(
                "cascade tiers must serve distinct versions, both are "
                f"{fast_version!r} (the quantized round serves with an "
                "-int8 suffix — did both tiers load the same blob?)")
        for want in (fast_version, flagship_version):
            if not any(r.version == want for r in self.replicas):
                raise ValueError(
                    f"cascade: no replica serves tier version {want!r}; "
                    f"have {sorted(self.versions())}")
        self.fast_version = fast_version
        self.flagship_version = flagship_version
        self.threshold = float(qc.cascade_threshold)
        self.metric = qc.cascade_metric
        self._clock = threading.Lock()
        self._cstats = {"requests": 0, "requests_escalated": 0,
                        "rows": 0, "rows_escalated": 0, "failed": 0}
        self._c_rows = REGISTRY.counter(
            "cxxnet_cascade_rows_total",
            "Cascade rows by final answering tier",
            labels=("pool", "tier"))
        self._g_esc = REGISTRY.gauge(
            "cxxnet_cascade_escalation_rate",
            "Fraction of cascade rows escalated to the flagship tier",
            labels=("pool",))

    # -- construction ----------------------------------------------------
    @classmethod
    def build_two_tier(cls, cfg: Any, *, flagship_blob: Dict[str, Any],
                       fast_blob: Dict[str, Any], qc: QuantConfig,
                       n_flagship: int = 1, n_fast: int = 1,
                       flagship_digest: str = "", fast_digest: str = "",
                       flagship_dtype: Optional[str] = None,
                       admission_control: bool = True,
                       silent: bool = False, **pool_kw) -> "CascadeRouter":
        """Both tiers over one net config: ``n_fast`` int8 replicas on
        the quantized blob and ``n_flagship`` replicas on the source
        blob in ``flagship_dtype`` (the net's policy by default), each
        tier placed over the cards by ``fleet.build_engines``."""
        fast = ReplicaPool.build(
            cfg, n_fast, blob=fast_blob, digest=fast_digest,
            dtype="int8", admission_control=admission_control,
            silent=silent, **pool_kw)
        flagship = ReplicaPool.build(
            cfg, n_flagship, blob=flagship_blob, digest=flagship_digest,
            dtype=flagship_dtype, admission_control=admission_control,
            silent=silent, **pool_kw)
        replicas: List[Replica] = list(fast.replicas) + \
            list(flagship.replicas)
        for i, rep in enumerate(replicas):
            rep.idx = i
        return cls(replicas,
                   fast_version=fast.replicas[0].version,
                   flagship_version=flagship.replicas[0].version,
                   qc=qc, admission_control=admission_control)

    # -- routing ---------------------------------------------------------
    def submit(self, data, kind: str = "predict",
               node: Optional[str] = None,
               timeout_ms: Optional[float] = None,
               version: Optional[str] = None):
        """Confidence-routed submit: ``predict`` / ``raw`` requests run
        the cascade; a ``version`` pin or ``extract`` routes directly
        (both legs land in the per-version outcomes of the base pool)."""
        if version is not None or kind == "extract":
            return super().submit(data, kind, node, timeout_ms, version)
        rows = np.asarray(data)
        out: "Future[np.ndarray]" = Future()
        fast_fut = super().submit(rows, "raw", None, timeout_ms,
                                  self.fast_version)
        fast_fut.add_done_callback(
            lambda f: self._on_fast(f, rows, kind, timeout_ms, out))
        return out

    def _finalize(self, out: Future, result=None, exc=None) -> None:
        if exc is not None:
            with self._clock:
                self._cstats["failed"] += 1
            out.set_exception(exc)
        else:
            out.set_result(result)

    def _on_fast(self, f: Future, rows: np.ndarray, kind: str,
                 timeout_ms: Optional[float], out: Future) -> None:
        exc = f.exception()
        if exc is not None:
            self._finalize(out, exc=exc)
            return
        try:
            probs = np.asarray(f.result())
            conf = row_confidence(probs, self.metric)
            esc = conf < self.threshold
            n, n_esc = len(conf), int(esc.sum())
            with self._clock:
                self._cstats["requests"] += 1
                self._cstats["rows"] += n
                self._cstats["rows_escalated"] += n_esc
                if n_esc:
                    self._cstats["requests_escalated"] += 1
                rate = self._cstats["rows_escalated"] \
                    / max(1, self._cstats["rows"])
            self._c_rows.labels(self.instance, "fast").inc(n - n_esc)
            self._g_esc.labels(self.instance).set(rate)
            if not n_esc:
                self._finalize(out, self._fast_answer(probs, kind))
                return
            self._c_rows.labels(self.instance, "flagship").inc(n_esc)
            LEDGER.event("cascade_escalate", rows=n_esc, total=n,
                         min_conf=round(float(conf.min()), 4),
                         threshold=self.threshold, metric=self.metric)
            flag_fut = ReplicaPool.submit(
                self, rows[esc], kind, None, timeout_ms,
                self.flagship_version)
            flag_fut.add_done_callback(
                lambda g: self._on_flagship(g, probs, esc, kind, out))
        except Exception as e:                  # noqa: BLE001
            self._finalize(out, exc=e)

    def _on_flagship(self, g: Future, probs: np.ndarray,
                     esc: np.ndarray, kind: str, out: Future) -> None:
        exc = g.exception()
        if exc is not None:
            self._finalize(out, exc=exc)
            return
        try:
            merged = self._fast_answer(probs, kind)
            merged[esc] = np.asarray(g.result())
            self._finalize(out, merged)
        except Exception as e:                  # noqa: BLE001
            self._finalize(out, exc=e)

    @staticmethod
    def _fast_answer(probs: np.ndarray, kind: str) -> np.ndarray:
        """Fast-tier rows in the requested output kind, as the engine's
        ``predict`` gives them (argmax; the value of a 1-column row)."""
        if kind == "raw":
            return np.array(probs, np.float32)
        p = probs.reshape(probs.shape[0], -1)
        if p.shape[1] == 1:
            return p[:, 0].astype(np.float32)
        return np.argmax(p, axis=1).astype(np.float32)

    # -- introspection ---------------------------------------------------
    def cascade_stats(self) -> Dict[str, Any]:
        with self._clock:
            s = dict(self._cstats)
        s.update(
            threshold=self.threshold, metric=self.metric,
            fast_version=self.fast_version,
            flagship_version=self.flagship_version,
            escalation_rate=round(
                s["rows_escalated"] / max(1, s["rows"]), 6))
        return s

    def snapshot(self) -> Dict[str, Any]:
        out = super().snapshot()
        out["cascade"] = self.cascade_stats()
        return out
