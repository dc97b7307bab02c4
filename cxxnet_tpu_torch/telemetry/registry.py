"""Process-wide metric registry: Counter, Gauge, log-bucketed Histogram
(the port's copy of ``cxxnet_tpu/telemetry/registry.py``).

Every subsystem registers its counters, gauges and histograms in one
process-global :data:`REGISTRY`, and every consumer (the serve server's
``GET /metrics``, the training ``telemetry_port`` exporter, the
``telemetry_log`` JSONL log, ``/statz``) renders a view of that one
registry. ``ServingStats`` and ``resilience.counters`` store their
numbers here.

Stdlib only: the registry is importable from any layer (io,
resilience, serve) without an import cycle or a device.

Thread-safe: every child metric takes a small lock per update, so the
serve threads and the train loop can write at once without losing a
tick.
"""

from __future__ import annotations

import bisect
import math
import re
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


class MetricError(ValueError):
    """Bad metric name/labels, or a get-or-create type mismatch."""


def log_buckets(lo: float, hi: float, per_decade: int = 3
                ) -> Tuple[float, ...]:
    """Geometric (log-spaced) histogram bucket upper bounds from ``lo``
    up to the first edge >= ``hi`` — ``per_decade`` edges per factor of
    10. The default latency ladder (100 us .. ~60 s) spans everything
    from a cache-hit serve dispatch to a slow remote checkpoint write
    with a constant relative error per bucket."""
    if lo <= 0 or hi <= lo or per_decade < 1:
        raise MetricError(
            f"log_buckets: need 0 < lo < hi, per_decade >= 1 "
            f"(got {lo}, {hi}, {per_decade})")
    out: List[float] = []
    exp = math.log10(lo)
    step = 1.0 / per_decade
    while True:
        edge = 10.0 ** exp
        # snap near-integer exponent edges (1e-3, 1e-2, ...) to exact
        edge = float(f"{edge:.6g}")
        out.append(edge)
        if edge >= hi:
            return tuple(out)
        exp += step


DEFAULT_LATENCY_BUCKETS = log_buckets(1e-4, 60.0, per_decade=3)


class _Child:
    """One concrete time series (a metric family resolved to one label
    set)."""
    __slots__ = ("_lock",)

    def __init__(self):
        self._lock = threading.Lock()


class CounterChild(_Child):
    __slots__ = ("_v",)

    def __init__(self):
        super().__init__()
        self._v = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise MetricError(f"counter increment must be >= 0, got {n}")
        with self._lock:
            self._v += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._v

    def _reset(self) -> None:
        with self._lock:
            self._v = 0.0


class GaugeChild(_Child):
    __slots__ = ("_v", "_fn")

    def __init__(self):
        super().__init__()
        self._v = 0.0
        self._fn: Optional[Callable[[], float]] = None

    def set(self, v: float) -> None:
        with self._lock:
            self._fn = None
            self._v = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._v += n

    def dec(self, n: float = 1.0) -> None:
        with self._lock:
            self._v -= n

    def set_function(self, fn: Callable[[], float]) -> None:
        """Callback gauge: ``value`` is computed at read time (e.g. a
        queue depth read straight from the queue object)."""
        with self._lock:
            self._fn = fn

    @property
    def value(self) -> float:
        with self._lock:
            fn = self._fn
            if fn is None:
                return self._v
        try:                      # outside the lock: fn may take its own
            return float(fn())
        except Exception:
            return float("nan")

    def _reset(self) -> None:
        with self._lock:
            self._fn = None
            self._v = 0.0


class HistogramChild(_Child):
    __slots__ = ("buckets", "_counts", "_sum", "_count")

    def __init__(self, buckets: Sequence[float]):
        super().__init__()
        self.buckets = tuple(buckets)       # upper bounds; +Inf implicit
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        # bucket le=B holds observations v <= B; bisect_left returns the
        # first edge >= v, so an observation AT an edge lands in that
        # edge's bucket (the Prometheus le-semantics tests pin down)
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def raw(self) -> Tuple[Tuple[float, ...], List[int], float, int]:
        """(bucket edges, per-bucket raw counts with the +Inf overflow
        slot, sum, count) under one lock hold: the mergeable snapshot
        form (telemetry.aggregate), whose counts add bucket-wise."""
        with self._lock:
            return self.buckets, list(self._counts), self._sum, self._count

    def snapshot(self) -> Tuple[List[Tuple[float, int]], float, int]:
        """(cumulative buckets, sum, count) read under ONE lock hold —
        exposition must never tear (``bucket{le="+Inf"}`` != ``_count``
        breaks histogram_quantile and strict format validators)."""
        with self._lock:
            counts = list(self._counts)
            total_sum = self._sum
            total_count = self._count
        out: List[Tuple[float, int]] = []
        acc = 0
        for b, c in zip(self.buckets, counts):
            acc += c
            out.append((b, acc))
        out.append((math.inf, acc + counts[-1]))
        return out, total_sum, total_count

    def _reset(self) -> None:
        with self._lock:
            self._counts = [0] * (len(self.buckets) + 1)
            self._sum = 0.0
            self._count = 0


_KIND_CHILD = {"counter": CounterChild, "gauge": GaugeChild,
               "histogram": HistogramChild}


class MetricFamily:
    """A named metric with a fixed label-name set; each distinct label
    VALUE tuple resolves (get-or-create) to one child time series.
    Unlabeled families delegate inc/set/observe to their single default
    child so ``registry.counter("x").inc()`` just works."""

    def __init__(self, name: str, kind: str, help: str = "",
                 labelnames: Sequence[str] = (),
                 buckets: Optional[Sequence[float]] = None):
        self.name = name
        self.kind = kind
        self.help = help
        self.labelnames = tuple(labelnames)
        self._buckets = tuple(buckets) if buckets is not None else None
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], _Child] = {}

    def _make_child(self) -> _Child:
        if self.kind == "histogram":
            return HistogramChild(self._buckets or DEFAULT_LATENCY_BUCKETS)
        return _KIND_CHILD[self.kind]()

    def labels(self, *vals: str, **kw: str):
        """Resolve one child. Positional values follow ``labelnames``
        order; keyword form must name every label exactly."""
        if kw:
            if vals:
                raise MetricError(
                    f"{self.name}: mix of positional and keyword labels")
            try:
                vals = tuple(str(kw[k]) for k in self.labelnames)
            except KeyError as e:
                raise MetricError(
                    f"{self.name}: missing label {e.args[0]!r} "
                    f"(labels: {self.labelnames})")
            if len(kw) != len(self.labelnames):
                extra = set(kw) - set(self.labelnames)
                raise MetricError(
                    f"{self.name}: unknown labels {sorted(extra)}")
        else:
            vals = tuple(str(v) for v in vals)
        if len(vals) != len(self.labelnames):
            raise MetricError(
                f"{self.name}: got {len(vals)} label values for "
                f"{len(self.labelnames)} labels {self.labelnames}")
        with self._lock:
            child = self._children.get(vals)
            if child is None:
                child = self._make_child()
                self._children[vals] = child
            return child

    def samples(self) -> List[Tuple[Tuple[str, ...], _Child]]:
        with self._lock:
            return sorted(self._children.items())

    def remove_labels(self, *vals: str, **kw: str) -> None:
        """Drop one child series — the teardown hook for per-instance
        labels (a dead engine's frozen gauges must not be scraped
        forever). A held child reference keeps working but no longer
        exports."""
        if kw and not vals:
            vals = tuple(str(kw[k]) for k in self.labelnames)
        else:
            vals = tuple(str(v) for v in vals)
        with self._lock:
            self._children.pop(vals, None)

    # -- unlabeled-family conveniences ----------------------------------
    def _default(self):
        if self.labelnames:
            raise MetricError(
                f"{self.name} has labels {self.labelnames}; call "
                ".labels(...) first")
        return self.labels()

    def inc(self, n: float = 1.0) -> None:
        self._default().inc(n)

    def set(self, v: float) -> None:
        self._default().set(v)

    def dec(self, n: float = 1.0) -> None:
        self._default().dec(n)

    def set_function(self, fn: Callable[[], float]) -> None:
        self._default().set_function(fn)

    def observe(self, v: float) -> None:
        self._default().observe(v)

    @property
    def value(self) -> float:
        return self._default().value

    def _reset(self) -> None:
        with self._lock:
            for child in self._children.values():
                child._reset()


class MetricRegistry:
    """Thread-safe name -> :class:`MetricFamily` map with get-or-create
    semantics (the same family object comes back for the same name, so
    independent subsystems can share a series without coordination;
    a name re-registered with a DIFFERENT kind or label set raises)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, MetricFamily] = {}

    def _get_or_create(self, name: str, kind: str, help: str,
                       labels: Sequence[str],
                       buckets: Optional[Sequence[float]] = None
                       ) -> MetricFamily:
        if not _NAME_RE.match(name or ""):
            raise MetricError(f"invalid metric name {name!r}")
        for ln in labels:
            if not _LABEL_RE.match(ln):
                raise MetricError(f"{name}: invalid label name {ln!r}")
        with self._lock:
            fam = self._metrics.get(name)
            if fam is None:
                fam = MetricFamily(name, kind, help=help,
                                   labelnames=labels, buckets=buckets)
                self._metrics[name] = fam
                return fam
        if fam.kind != kind:
            raise MetricError(
                f"metric {name!r} already registered as {fam.kind}, "
                f"not {kind}")
        if fam.labelnames != tuple(labels):
            raise MetricError(
                f"metric {name!r} already registered with labels "
                f"{fam.labelnames}, not {tuple(labels)}")
        return fam

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> MetricFamily:
        return self._get_or_create(name, "counter", help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> MetricFamily:
        return self._get_or_create(name, "gauge", help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None
                  ) -> MetricFamily:
        return self._get_or_create(name, "histogram", help, labels,
                                   buckets=buckets)

    def collect(self) -> List[MetricFamily]:
        """Stable-ordered family list for exposition."""
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def get(self, name: str) -> Optional[MetricFamily]:
        with self._lock:
            return self._metrics.get(name)

    def snapshot(self) -> Dict[str, float]:
        """Flat ``name{label="v",...}`` -> value dict (histograms as
        ``_count`` / ``_sum``) — the JSONL event-log payload."""
        out: Dict[str, float] = {}
        for fam in self.collect():
            for vals, child in fam.samples():
                key = fam.name
                if vals:
                    key += "{" + ",".join(
                        f'{k}="{v}"'
                        for k, v in zip(fam.labelnames, vals)) + "}"
                if fam.kind == "histogram":
                    _cum, hsum, hcount = child.snapshot()
                    out[key + "_count"] = hcount
                    out[key + "_sum"] = hsum
                else:
                    out[key] = child.value
        return out

    def reset(self) -> None:
        """Zero every child (tests / chaos tools); families and children
        stay registered so held references keep working."""
        for fam in self.collect():
            fam._reset()


# the process-global registry every subsystem shares
REGISTRY = MetricRegistry()


def get_registry() -> MetricRegistry:
    return REGISTRY
