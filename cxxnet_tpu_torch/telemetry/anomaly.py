"""Fleet anomaly detection: stragglers, hangs, recompile storms (the
port of ``cxxnet_tpu/telemetry/anomaly.py``; the same rules, metric
names and ledger events).

The signals derived from the telemetry the fleet layer collects —
rule-driven and
individually testable (the declarative ``match_partition_rules`` spirit:
each detector is a pure observation -> verdict function wrapped in a
thin stateful shell), never wired ad hoc into the train loop:

* :class:`StragglerDetector` — per-host step-time MEDIANS from the
  merged fleet view's ``cxxnet_steptime_step_seconds`` histograms
  (aggregate.quantile), compared against the fleet-merged median: a
  host whose median exceeds ``factor`` x fleet median (with at least
  ``min_steps`` observations on both sides) is a straggler. Median vs
  median, not mean vs mean: one GC pause or checkpoint stall on a
  healthy host must not make it look slow.
* :class:`HangWatchdog` — a daemon thread watching a monotonic progress
  reading (the step counter). No progress for ``hang_s`` seconds while
  the run is supposed to be stepping => dump EVERY thread's stack
  (faulthandler) into the run ledger as a ``hang_dump`` event, tick
  ``cxxnet_hangs_total``, and keep watching (dump-once-per-stall, not
  per tick). The dump is the artifact that distinguishes "slow
  collective" from "deadlocked host" after the fact — a hung process
  can usually still run this thread and append a line, which is exactly
  why the ledger transport is a local file append and not a collective.
* :class:`RecompileStormDetector` — compile events arriving faster
  than ``threshold`` per ``window_s`` AFTER the first ``grace`` warmup
  compiles => a recompile storm. The port has no XLA compile: what
  compiles in its process is a kernel source built by ``ops/_build.py``
  (``nvcc``) or ``load_host`` (``g++``), and a miss of the LM engine's
  runner cache (``serve/lm/engine.py``). Each one calls
  :func:`note_compile`, which counts it once
  :func:`install_compile_counter` ran.

All stdlib, so the detectors stay importable everywhere the registry
is.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from .ledger import LEDGER
from .registry import REGISTRY, MetricRegistry

STEP_SECONDS_METRIC = "cxxnet_steptime_step_seconds"


# -- stragglers ---------------------------------------------------------------

class StragglerDetector:
    """Pure rule over a FleetView + counters/ledger on state change.

    ``check(view)`` returns the CURRENT verdict list (possibly empty);
    the stateful shell emits one ``straggler`` ledger event + one
    ``cxxnet_stragglers_total`` tick per (host, round-of-detection)
    onset, so a persistently slow host does not spam an event per
    refresh."""

    def __init__(self, factor: float = 2.0, min_steps: int = 8,
                 metric: str = STEP_SECONDS_METRIC,
                 registry: Optional[MetricRegistry] = None):
        if factor <= 1.0:
            raise ValueError(
                f"straggler factor must be > 1, got {factor}")
        self.factor = float(factor)
        self.min_steps = int(min_steps)
        self.metric = metric
        reg = registry or REGISTRY
        self._c_straggler = reg.counter(
            "cxxnet_stragglers_total",
            "Straggler onsets detected (host median step time > factor "
            "x fleet median)", labels=("host",))
        self._g_ratio = reg.gauge(
            "cxxnet_straggler_ratio",
            "Host median step time / fleet median (1.0 = keeping pace)",
            labels=("host",))
        self._flagged: set = set()
        self._baseline: Dict[int, Dict[str, Any]] = {}

    def _gather(self, view) -> Dict[int, Dict[str, Any]]:
        per_host: Dict[int, Dict[str, Any]] = {}
        for h in view.hosts:
            for vals, v in view.host_samples(self.metric, h):
                if isinstance(v, dict) and vals == ():
                    per_host[h] = v
        return per_host

    # -- the rule (pure; property-tested directly) -----------------------
    def verdicts_from(self, per_host: Dict[int, Dict[str, Any]]
                      ) -> List[Dict[str, Any]]:
        from .aggregate import quantile
        ready = {h: v for h, v in per_host.items()
                 if v["count"] >= self.min_steps}
        if len(ready) < 2:
            return []
        # fleet histogram = bucket-wise sum over the comparable hosts
        edges = None
        fleet_counts = None
        for v in ready.values():
            if edges is None:
                edges, fleet_counts = list(v["buckets"]), list(v["counts"])
            elif list(v["buckets"]) == edges:
                fleet_counts = [a + b for a, b in
                                zip(fleet_counts, v["counts"])]
        fleet_med = quantile(edges, fleet_counts, 0.5)
        if not fleet_med or fleet_med != fleet_med:
            return []
        out = []
        for h, hist in sorted(ready.items()):
            if list(hist["buckets"]) != edges:
                continue
            med = quantile(hist["buckets"], hist["counts"], 0.5)
            ratio = med / fleet_med if fleet_med > 0 else float("inf")
            self._g_ratio.labels(str(h)).set(ratio)
            if med > self.factor * fleet_med:
                out.append({"host": h, "median_s": round(med, 6),
                            "fleet_median_s": round(fleet_med, 6),
                            "ratio": round(ratio, 3)})
        return out

    # -- windowing -------------------------------------------------------
    def _delta(self, host: int, hist: Dict[str, Any]
               ) -> Optional[Dict[str, Any]]:
        """Observations since the previous check. Cumulative histograms
        would average a late-onset slowdown into the host's entire
        healthy history (a host degrading after 10k good steps would
        need ~10k slow steps to move its lifetime median); per-check
        deltas keep the comparison on RECENT behavior. A counter reset
        or bucket change falls back to the cumulative reading."""
        prev = self._baseline.get(host)
        cur = {"buckets": list(hist["buckets"]),
               "counts": list(hist["counts"]),
               "sum": float(hist["sum"]), "count": int(hist["count"])}
        self._baseline[host] = cur
        if prev is None or prev["buckets"] != cur["buckets"]:
            return cur
        d_counts = [a - b for a, b in zip(cur["counts"], prev["counts"])]
        d_count = cur["count"] - prev["count"]
        if d_count < 0 or any(c < 0 for c in d_counts):
            return cur                     # restarted process: re-baseline
        if d_count == 0:
            return None                    # no new steps since last check
        return {"buckets": cur["buckets"], "counts": d_counts,
                "sum": cur["sum"] - prev["sum"], "count": d_count}

    # -- stateful shell --------------------------------------------------
    def check(self, view, round_no: Optional[int] = None
              ) -> List[Dict[str, Any]]:
        deltas = {}
        for h, hist in self._gather(view).items():
            d = self._delta(h, hist)
            if d is not None:
                deltas[h] = d
        verdicts = self.verdicts_from(deltas)
        current = {v["host"] for v in verdicts}
        for v in verdicts:
            if v["host"] not in self._flagged:
                self._c_straggler.labels(str(v["host"])).inc()
                # straggler_host, not host: the envelope's host column
                # is the WRITER (the aggregating process), the flagged
                # host is event payload
                LEDGER.event("straggler", round=round_no,
                             straggler_host=v["host"],
                             median_s=v["median_s"],
                             fleet_median_s=v["fleet_median_s"],
                             ratio=v["ratio"])
        self._flagged = current          # recovery re-arms the event
        return verdicts

    @staticmethod
    def fragment(verdicts: List[Dict[str, Any]]) -> str:
        """Round-log fragment: ``\\tstraggler:h1(3.2x)``; empty when
        every host keeps pace."""
        if not verdicts:
            return ""
        return "\tstraggler:" + ",".join(
            "h%d(%.1fx)" % (v["host"], v["ratio"]) for v in verdicts)


# -- hangs --------------------------------------------------------------------

def dump_all_stacks(limit_frames: int = 40) -> str:
    """Every live thread's stack as one string. faulthandler first (it
    sees threads the threading module lost track of), formatted
    traceback fallback."""
    import io
    import tempfile
    try:
        import faulthandler
        with tempfile.TemporaryFile(mode="w+") as f:
            faulthandler.dump_traceback(file=f, all_threads=True)
            f.seek(0)
            return f.read()
    except Exception:
        pass
    import traceback
    buf = io.StringIO()
    frames = sys._current_frames()
    names = {t.ident: t.name for t in threading.enumerate()}
    for tid, frame in frames.items():
        buf.write("Thread %s (%s):\n" % (tid, names.get(tid, "?")))
        buf.write("".join(traceback.format_stack(frame, limit=limit_frames)))
    return buf.getvalue()


class HangWatchdog:
    """No step progress within ``hang_s`` => stack dump to the ledger.

    ``progress_fn`` returns a monotonically increasing number (the
    registry step counter); the watchdog arms once it has seen the
    FIRST progress (startup compilation is not a hang) and re-arms
    after every advance. One dump per stall: the dump marks the stall
    begin; further ticks of the same stall only extend
    ``stalled_for_s``."""

    def __init__(self, hang_s: float, progress_fn: Callable[[], float],
                 registry: Optional[MetricRegistry] = None,
                 poll_s: Optional[float] = None,
                 on_dump: Optional[Callable[[str], None]] = None):
        if hang_s <= 0:
            raise ValueError(f"hang_s must be > 0, got {hang_s}")
        self.hang_s = float(hang_s)
        self.poll_s = poll_s if poll_s is not None \
            else max(0.5, self.hang_s / 4)
        self.progress_fn = progress_fn
        self.on_dump = on_dump
        self.dumps = 0
        reg = registry or REGISTRY
        self._c_hangs = reg.counter(
            "cxxnet_hangs_total",
            "Stalls detected by the hang watchdog (no step progress "
            "within telemetry_hang_s)")
        self._stop = threading.Event()
        self._last_progress: Optional[float] = None
        self._last_advance = time.monotonic()
        self._armed = False
        self._dumped_this_stall = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="telemetry-hang-watchdog")

    def start(self) -> "HangWatchdog":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=5)

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            self._tick()

    def _tick(self, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        try:
            p = float(self.progress_fn())
        except Exception:
            return
        if self._last_progress is None:
            # baseline reading: NOT yet armed — a long first compile
            # with zero steps is startup, not a hang
            self._last_progress = p
            self._last_advance = now
            return
        if p > self._last_progress:
            self._last_progress = p
            self._last_advance = now
            self._armed = True
            self._dumped_this_stall = False
            return
        if not self._armed:
            return
        stalled = now - self._last_advance
        if stalled >= self.hang_s and not self._dumped_this_stall:
            self._dumped_this_stall = True
            self.dump_now(stalled_for_s=round(stalled, 3))

    def dump_now(self, stalled_for_s: float = 0.0,
                 dry_run: bool = False) -> str:
        """Capture + ledger one stack dump. ``dry_run`` exercises the
        whole path (tools/smoke_fleet.py) without counting a hang."""
        stacks = dump_all_stacks()
        if not dry_run:
            self._c_hangs.inc()
            self.dumps += 1
        LEDGER.event("hang_dump", stalled_for_s=stalled_for_s,
                     dry_run=bool(dry_run), pid=os.getpid(),
                     stacks=stacks)
        if self.on_dump is not None:
            try:
                self.on_dump(stacks)
            except Exception:
                pass
        return stacks


# -- recompile storms ---------------------------------------------------------

_COMPILE_COUNTER = None


def install_compile_counter() -> bool:
    """Count every compile of this process (:func:`note_compile`) into
    ``cxxnet_compiles_total`` and a ``compile`` ledger event, as the JAX
    package counts its XLA backend compiles. Idempotent."""
    global _COMPILE_COUNTER
    if _COMPILE_COUNTER is None:
        _COMPILE_COUNTER = REGISTRY.counter(
            "cxxnet_compiles_total",
            "Compiles observed in this process (kernel builds, LM "
            "runner-cache misses)")
    return True


def note_compile(seconds: float, what: str = "") -> None:
    """One compile that took ``seconds``: a kernel source built, or an
    LM runner made on a cache miss (``what`` names it). Free until
    :func:`install_compile_counter` ran."""
    c = _COMPILE_COUNTER
    if c is None:
        return
    c.inc()
    LEDGER.event("compile", seconds=round(float(seconds), 4),
                 **({"what": what} if what else {}))


class RecompileStormDetector:
    """Sliding-window rate rule over the compile counter. Feed it
    ``observe(total_compiles)`` (any cadence); it keeps (ts, total)
    observations ``window_s`` back and fires when compiles-in-window
    exceed ``threshold`` after the first ``grace`` compiles (warmup
    tracing is expected to compile several step/eval variants). One
    ledger event + counter tick per storm onset; the storm re-arms
    once the rate falls back under threshold."""

    def __init__(self, window_s: float = 60.0, threshold: int = 8,
                 grace: int = 8,
                 registry: Optional[MetricRegistry] = None):
        self.window_s = float(window_s)
        self.threshold = int(threshold)
        self.grace = int(grace)
        self._obs: deque = deque()       # (t, total)
        self._in_storm = False
        self.storms = 0
        reg = registry or REGISTRY
        self._c_storms = reg.counter(
            "cxxnet_recompile_storms_total",
            "Recompile-storm onsets (compile rate over threshold)")
        self._g_rate = reg.gauge(
            "cxxnet_compile_rate_per_min",
            "Compiles observed in the trailing storm window, per minute")

    def observe(self, total: float, now: Optional[float] = None) -> bool:
        """Returns True while a storm is active."""
        now = time.monotonic() if now is None else now
        self._obs.append((now, float(total)))
        cutoff = now - self.window_s
        while len(self._obs) > 1 and self._obs[0][0] < cutoff:
            self._obs.popleft()
        in_window = self._obs[-1][1] - self._obs[0][1]
        span = max(self._obs[-1][0] - self._obs[0][0], 1e-9)
        self._g_rate.set(in_window * 60.0 / max(span, 1.0))
        # threshold scaled to the retained span: the prune above keeps
        # the first observation >= cutoff whenever two exist, so span
        # normally stays <= window_s and need == threshold — but if the
        # retained pair ever spans longer (observations sparser than
        # the window under a future prune change), a drip of compiles
        # across that longer span must not read as a window-sized burst
        need = self.threshold * max(span, self.window_s) / self.window_s
        storm = (total > self.grace and in_window >= need)
        if storm and not self._in_storm:
            self.storms += 1
            self._c_storms.inc()
            LEDGER.event("recompile_storm",
                         compiles_in_window=int(in_window),
                         window_s=self.window_s, total_compiles=int(total))
        self._in_storm = storm
        return storm
