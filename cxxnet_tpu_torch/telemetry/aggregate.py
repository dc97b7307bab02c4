"""Cross-process metric aggregation: mergeable registry snapshots (the
port of ``cxxnet_tpu/telemetry/aggregate.py``: snapshot schema 1, the
same file layout and merge rules, so either package's aggregator reads
the other's snapshots).

The registry dies at the process boundary: every worker of a
multi-host run keeps its own counters and its own step-time histograms,
and nothing ever sees the FLEET. This module makes registry snapshots
*mergeable values*:

* :func:`export_snapshot` — one process's registry as a plain dict
  (schema-versioned JSON): counters/gauges by value, histograms as RAW
  per-bucket counts (raw counts merge by addition; cumulative counts do
  not).
* :class:`FleetView` / :func:`merge_snapshots` — the merge semantics
  are held by tests/test_torch_fleetobs.py:
  **counters sum** across hosts, **gauges keep per-host** (a queue
  depth has no meaningful cross-host sum), **histograms merge
  bucket-wise** when edges agree (else they stay per-host). Merging is
  commutative and associative by construction: a FleetView is just the
  union of per-host snapshots keyed by host (same host: newest ``ts``
  wins), and every fleet-level series is DERIVED from that union at
  read time.
* :func:`quantile` — Prometheus-style histogram_quantile (linear
  interpolation inside the winning bucket) over raw counts, so per-host
  step-time medians and fleet medians come from the same estimator the
  dashboards would use.
* :class:`SnapshotPusher` / :class:`FleetAggregator` — the transport:
  each worker atomically writes its snapshot to
  ``<fleet_dir>/host_<k>.json`` on a shared filesystem every
  ``push_interval`` seconds (tmp + rename, so a reader never sees a
  torn file); the aggregating process (host 0) folds the files plus its
  OWN live registry into a FleetView and renders ``/metrics`` with a
  ``host`` label on every series (fleet-summed counters and bucket-
  merged histograms additionally carry ``host="fleet"``). File-based
  push is deliberate: it needs no collective, so it keeps working
  mid-hang — exactly when the straggler/hang detectors (anomaly.py)
  need the data — and works for N independent processes with no
  collective bring-up.

Stdlib-only, like the registry itself.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from .registry import REGISTRY, MetricRegistry

SNAPSHOT_SCHEMA = 1


# -- one process -> one snapshot dict -----------------------------------------

def export_snapshot(registry: Optional[MetricRegistry] = None,
                    host: int = 0, run_id: str = "") -> Dict[str, Any]:
    """The whole registry as a JSON-safe dict. Histograms carry raw
    per-bucket counts (+Inf overflow slot last) plus sum/count read
    under one lock, so a snapshot is internally consistent the same way
    an exposition is. Callback gauges are evaluated here — snapshot
    time IS exposition time for a pushed worker. ``run_id`` stamps the
    snapshot so an aggregator can reject files left behind by PREVIOUS
    runs sharing the same fleet dir."""
    registry = registry or REGISTRY
    fams: Dict[str, Any] = {}
    for fam in registry.collect():
        samples = []
        for vals, child in fam.samples():
            if fam.kind == "histogram":
                edges, counts, hsum, hcount = child.raw()
                samples.append([list(vals), {
                    "buckets": list(edges), "counts": counts,
                    "sum": hsum, "count": hcount}])
            else:
                v = child.value
                if v != v or v in (math.inf, -math.inf):
                    v = None          # JSON has no NaN/Inf; None = absent
                samples.append([list(vals), v])
        fams[fam.name] = {"kind": fam.kind, "help": fam.help,
                          "labels": list(fam.labelnames),
                          "samples": samples}
    return {"schema": SNAPSHOT_SCHEMA, "host": int(host),
            "run_id": run_id, "ts": round(time.time(), 3),
            "families": fams}


# -- merging ------------------------------------------------------------------

class FleetView:
    """Union of per-host snapshots + derived fleet series. Internally
    just ``{host: snapshot}``; every aggregate is computed at read time
    from that union, which is what makes merge order irrelevant."""

    def __init__(self, per_host: Optional[Dict[int, Dict[str, Any]]] = None):
        self.per_host: Dict[int, Dict[str, Any]] = dict(per_host or {})

    @property
    def hosts(self) -> List[int]:
        return sorted(self.per_host)

    # -- lookups ---------------------------------------------------------
    def host_samples(self, name: str, host: int
                     ) -> List[Tuple[Tuple[str, ...], Any]]:
        snap = self.per_host.get(host)
        if not snap:
            return []
        fam = snap["families"].get(name)
        if not fam:
            return []
        return [(tuple(vals), v) for vals, v in fam["samples"]]

    def family(self, name: str) -> Optional[Dict[str, Any]]:
        """Family metadata from any host that has it (kind/labels are
        get-or-create-stable across processes running the same code)."""
        for h in self.hosts:
            fam = self.per_host[h]["families"].get(name)
            if fam:
                return fam
        return None

    def family_names(self) -> List[str]:
        names = set()
        for snap in self.per_host.values():
            names.update(snap["families"])
        return sorted(names)

    def fleet_counter(self, name: str) -> Dict[Tuple[str, ...], float]:
        """Per-label-tuple SUM across hosts."""
        out: Dict[Tuple[str, ...], float] = {}
        for h in self.hosts:
            for vals, v in self.host_samples(name, h):
                if v is None or isinstance(v, dict):
                    continue
                out[vals] = out.get(vals, 0.0) + float(v)
        return out

    def fleet_histogram(self, name: str
                        ) -> Dict[Tuple[str, ...], Dict[str, Any]]:
        """Bucket-wise merged histogram per label tuple. Hosts whose
        bucket edges disagree with the first-seen edges are left OUT of
        the fleet series (they still render per-host) — adding apples
        to oranges silently would corrupt every derived quantile."""
        out: Dict[Tuple[str, ...], Dict[str, Any]] = {}
        for h in self.hosts:
            for vals, v in self.host_samples(name, h):
                if not isinstance(v, dict):
                    continue
                cur = out.get(vals)
                if cur is None:
                    out[vals] = {"buckets": list(v["buckets"]),
                                 "counts": list(v["counts"]),
                                 "sum": float(v["sum"]),
                                 "count": int(v["count"])}
                elif cur["buckets"] == list(v["buckets"]):
                    cur["counts"] = [a + b for a, b in
                                     zip(cur["counts"], v["counts"])]
                    cur["sum"] += float(v["sum"])
                    cur["count"] += int(v["count"])
        return out


def merge_snapshots(snaps: Iterable[Any]) -> FleetView:
    """Fold host snapshots and/or FleetViews into one FleetView.
    Commutative + associative: the result is the keyed union of host
    snapshots; a host appearing twice resolves to its newest ``ts``
    (ties keep either — the payloads are then equal for all the
    aggregator cares)."""
    view = FleetView()
    for s in snaps:
        if s is None:
            continue
        items = (s.per_host.items() if isinstance(s, FleetView)
                 else [(int(s.get("host", 0)), s)])
        for h, snap in items:
            cur = view.per_host.get(h)
            if cur is None or snap.get("ts", 0) >= cur.get("ts", 0):
                view.per_host[h] = snap
    return view


def quantile(buckets: Sequence[float], counts: Sequence[int],
             q: float) -> float:
    """Prometheus histogram_quantile over RAW bucket counts (+Inf slot
    last): find the bucket holding the q-th observation, linearly
    interpolate inside it. Observations past the last finite edge clamp
    to that edge (no upper bound to interpolate toward)."""
    total = sum(counts)
    if total <= 0:
        return float("nan")
    rank = q * total
    acc = 0.0
    for i, c in enumerate(counts):
        acc += c
        if acc >= rank:
            if i >= len(buckets):           # +Inf overflow bucket
                return float(buckets[-1]) if buckets else float("nan")
            lo = float(buckets[i - 1]) if i > 0 else 0.0
            hi = float(buckets[i])
            if c <= 0:
                return hi
            frac = (rank - (acc - c)) / c
            return lo + (hi - lo) * frac
    return float(buckets[-1]) if buckets else float("nan")


# -- exposition ---------------------------------------------------------------

# one label-escape / value-format implementation for BOTH expositions
# (exporter.render_prometheus and render_fleet below)
from .exporter import _escape_label as _esc                   # noqa: E402
from .exporter import _fmt_value as _fmt                      # noqa: E402


def _lbl(names: Sequence[str], vals: Sequence[str], host: str,
         extra: str = "") -> str:
    parts = ['host="%s"' % _esc(host)]
    parts += ['%s="%s"' % (k, _esc(str(v))) for k, v in zip(names, vals)]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}"


def _own_lbl(names: Sequence[str], vals: Sequence[str],
             extra: str = "") -> str:
    """Label string WITHOUT the prepended writer-host label — for
    families that already carry a host label of their own."""
    parts = ['%s="%s"' % (k, _esc(str(v))) for k, v in zip(names, vals)]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def render_fleet(view: FleetView) -> str:
    """Prometheus text for the merged fleet: every per-host series with
    a ``host="<k>"`` label; counters and (edge-compatible) histograms
    additionally as ``host="fleet"`` aggregates. Gauges render per-host
    only — the merge semantics, visible in the exposition.

    Families whose OWN label set already contains ``host`` (the
    straggler series: their host label names the SUBJECT host) render
    merged-only with their own labels — prepending the writer-host
    label there would emit a duplicate ``host=`` pair, which is
    invalid exposition and kills the whole scrape."""
    out: List[str] = []
    for name in view.family_names():
        fam = view.family(name)
        kind, names = fam["kind"], fam["labels"]
        own_host = "host" in names
        if fam.get("help"):
            out.append("# HELP %s %s" % (name, fam["help"]))
        out.append("# TYPE %s %s" % (name, kind))
        if own_host:
            if kind == "counter":
                for vals, total in sorted(view.fleet_counter(name).items()):
                    out.append("%s%s %s" % (
                        name, _own_lbl(names, vals), _fmt(total)))
            elif kind == "histogram":
                for vals, hv in sorted(view.fleet_histogram(name).items()):
                    _render_hist(out, name, names, vals, None, hv)
            else:
                # gauges: union across writers, one line per label
                # tuple (writers observing the same subject agree or
                # the newest-merged wins)
                merged: Dict[Tuple[str, ...], float] = {}
                for h in view.hosts:
                    for vals, v in view.host_samples(name, h):
                        if v is not None and not isinstance(v, dict):
                            merged[tuple(vals)] = float(v)
                for vals, v in sorted(merged.items()):
                    out.append("%s%s %s" % (
                        name, _own_lbl(names, vals), _fmt(v)))
            continue
        for h in view.hosts:
            for vals, v in view.host_samples(name, h):
                if kind == "histogram" and isinstance(v, dict):
                    _render_hist(out, name, names, vals, str(h), v)
                elif v is not None:
                    out.append("%s%s %s" % (
                        name, _lbl(names, vals, str(h)), _fmt(float(v))))
        if kind == "counter":
            for vals, total in sorted(view.fleet_counter(name).items()):
                out.append("%s%s %s" % (
                    name, _lbl(names, vals, "fleet"), _fmt(total)))
        elif kind == "histogram":
            for vals, hv in sorted(view.fleet_histogram(name).items()):
                _render_hist(out, name, names, vals, "fleet", hv)
    return "\n".join(out) + "\n"


def _render_hist(out: List[str], name: str, names: Sequence[str],
                 vals: Sequence[str], host: Optional[str],
                 v: Dict[str, Any]) -> None:
    lbl = (lambda extra="": _own_lbl(names, vals, extra)) if host is None \
        else (lambda extra="": _lbl(names, vals, host, extra))
    acc = 0
    for edge, c in zip(v["buckets"], v["counts"]):
        acc += c
        out.append("%s_bucket%s %d" % (
            name, lbl('le="%s"' % _fmt(edge)), acc))
    acc += v["counts"][-1] if len(v["counts"]) > len(v["buckets"]) else 0
    out.append("%s_bucket%s %d" % (name, lbl('le="+Inf"'), acc))
    out.append("%s_sum%s %s" % (name, lbl(), _fmt(v["sum"])))
    out.append("%s_count%s %d" % (name, lbl(), v["count"]))


# -- transport ----------------------------------------------------------------

def _host_path(fleet_dir: str, host: int) -> str:
    return os.path.join(fleet_dir, "host_%d.json" % host)


def write_snapshot(fleet_dir: str, host: int,
                   registry: Optional[MetricRegistry] = None,
                   run_id: str = "") -> str:
    """Atomic push through the ONE durable-write protocol
    (io.stream.write_bytes_atomic: per-call-unique tmp + fsync +
    rename + dir fsync). A concurrent reader sees the previous
    complete snapshot or the new one, never a torn file, and two
    concurrent pushers in ONE process (the periodic thread racing a
    round-boundary push) cannot interleave into each other's tmp file
    either — the helper's tmp names are pid+sequence unique, last
    rename wins. A host's last snapshot before a crash also survives
    power loss, which is what the aggregator's post-mortem fleet view
    reads."""
    from ..io.stream import write_bytes_atomic
    os.makedirs(fleet_dir, exist_ok=True)
    path = _host_path(fleet_dir, host)
    snap = export_snapshot(registry, host=host, run_id=run_id)
    write_bytes_atomic(path, json.dumps(snap).encode("utf-8"))
    return path


def read_snapshots(fleet_dir: str,
                   skip_host: Optional[int] = None,
                   run_id: Optional[str] = None
                   ) -> List[Dict[str, Any]]:
    """All ``host_*.json`` snapshots in the fleet dir; unreadable or
    torn files are skipped (the next push replaces them). With
    ``run_id`` set, snapshots stamped with a DIFFERENT (or missing)
    run id are rejected — a persistent shared fleet dir accumulates
    files from previous runs and departed hosts, and yesterday's
    host_1.json must not haunt today's fleet view."""
    out = []
    try:
        entries = sorted(os.listdir(fleet_dir))
    except OSError:
        return out
    for fn in entries:
        if not (fn.startswith("host_") and fn.endswith(".json")):
            continue
        try:
            h = int(fn[5:-5])
        except ValueError:
            continue
        if skip_host is not None and h == skip_host:
            continue
        try:
            with open(os.path.join(fleet_dir, fn), encoding="utf-8") as f:
                snap = json.load(f)
        except (OSError, ValueError):
            continue
        if isinstance(snap, dict) and "families" in snap:
            if run_id is not None and snap.get("run_id") != run_id:
                continue
            snap.setdefault("host", h)
            out.append(snap)
    return out


class SnapshotPusher:
    """Every worker runs one: a daemon thread pushing this process's
    snapshot to the fleet dir every ``interval_s`` (plus explicit
    ``push_now`` at round boundaries and shutdown, so the aggregator's
    view is never staler than the last round)."""

    def __init__(self, fleet_dir: str, host: int, interval_s: float = 10.0,
                 registry: Optional[MetricRegistry] = None,
                 run_id: str = ""):
        self.fleet_dir = fleet_dir
        self.host = int(host)
        self.interval_s = float(interval_s)
        self.registry = registry or REGISTRY
        self.run_id = run_id
        self.pushes = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="telemetry-fleet-push")

    def start(self) -> "SnapshotPusher":
        self.push_now()
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.push_now()

    def push_now(self) -> None:
        try:
            write_snapshot(self.fleet_dir, self.host, self.registry,
                           run_id=self.run_id)
            self.pushes += 1
        except OSError:
            pass              # telemetry must never kill the run

    def stop(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=5)
        self.push_now()


class FleetAggregator:
    """The aggregating process's (host 0's) view: own LIVE registry +
    the other hosts' pushed files, merged on every refresh. ``render``
    backs the fleet ``/metrics`` exposition; anomaly.py reads
    ``view()`` for straggler/storm verdicts."""

    def __init__(self, fleet_dir: str, host: int = 0,
                 registry: Optional[MetricRegistry] = None,
                 run_id: str = ""):
        self.fleet_dir = fleet_dir
        self.host = int(host)
        self.registry = registry or REGISTRY
        # filter pushed files to THIS run ("" = accept only unstamped
        # snapshots — offline tools folding arbitrary dirs pass
        # run_id=None via read_snapshots directly)
        self.run_id = run_id
        self._lock = threading.Lock()

    def view(self) -> FleetView:
        snaps = read_snapshots(self.fleet_dir, skip_host=self.host,
                               run_id=self.run_id)
        snaps.append(export_snapshot(self.registry, host=self.host,
                                     run_id=self.run_id))
        return merge_snapshots(snaps)

    def render(self) -> str:
        with self._lock:          # one refresh per scrape, not per line
            return render_fleet(self.view())
