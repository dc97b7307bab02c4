"""Serving fleet: a replica pool with SLO-aware routing (the port of
``cxxnet_tpu/serve/fleet.py``).

N independent :class:`InferenceEngine` replicas, each with its own
network on its own device, micro-batcher, circuit breaker and SLO
tracker, behind a router that picks per request. Routing
(:meth:`ReplicaPool.pick`), in order:

1. **version pin**: a request carrying a model version (A/B) only
   considers replicas serving that version;
2. **availability**: replicas that are draining, reloading or down, or
   whose breaker is open, are skipped;
3. **admission control**: if every available replica is *degraded* (SLO
   burn rate at or over ``slo_burn_degraded``, queue near its budget, or
   breaker probing), the request is refused up front with
   :class:`AllReplicasDegraded` (HTTP 503);
4. **least load**: among the healthy rest, the replica with the fewest
   queued rows wins, a round-robin rotation breaking ties.

Hot reload (``serve/reload.py``) swaps replicas one at a time: a
DRAINING replica finishes what it admitted but takes no new work, so a
rolling reload drops no request. A/B pins come from the same machinery:
reload only a canary subset and two versions serve side by side.

Devices (:meth:`ReplicaPool.build`): with fewer devices than replicas
the replicas share them round-robin (on one H100 every replica runs on
``cuda:0``); with at least as many, each replica takes one device, the
rest idle. A replica spanning several cards, one engine across them,
is refused (ROADMAP Queue A 4: replicas over several cards). Replicas on
one card dispatch from their own threads on the device's default
stream, which the kernels' ``split_scratch`` workspaces rely on (one
stream a device): no replica gets a side stream.

Telemetry, as in the JAX package: each replica's lifecycle state is the
``cxxnet_serve_replica_state{engine}`` gauge and a ``replica_state``
ledger event at every transition; terminal outcomes per version count
in ``cxxnet_serve_version_requests_total{pool,version,result}``; a
route decision is the ``serve.route`` span (under distributed tracing
a child of the request's trace, and a failed request's trace id is kept
by version for :meth:`ReplicaPool.failed_traces`). A pool built with
``fleet = False`` (the single engine of ``ServeServer(engine)``) exports
none of the gauges and counters, as the JAX package's single engine has
none. Stdlib threading; every public method is thread-safe.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

import torch

from ..config import ConfigError, parse_config_string
from ..convert import params_from_jax
from ..device import resolve_devices
from ..graph import build_graph, global_param
from ..model import Network
from ..resilience import CircuitBreaker
from ..telemetry import SLOTracker
from ..telemetry.ledger import LEDGER
from ..telemetry.disttrace import DISTTRACE
from ..telemetry.registry import REGISTRY
from ..telemetry.trace import TRACER
from .batcher import MicroBatcher
from .engine import InferenceEngine, negotiate_blob, version_name
from .stats import ServingStats

# replica lifecycle states
UP, DRAINING, RELOADING, DOWN = "up", "draining", "reloading", "down"
# the cxxnet_serve_replica_state gauge's code of each state
_STATE_CODE = {UP: 0, DRAINING: 1, RELOADING: 2, DOWN: 3}

_POOL_SEQ = itertools.count()

__all__ = ["Replica", "ReplicaPool", "build_engines", "NoHealthyReplica",
           "AllReplicasDegraded", "UnknownVersion", "version_name",
           "UP", "DRAINING", "RELOADING", "DOWN"]


class NoHealthyReplica(RuntimeError):
    """Every candidate replica is out of rotation (down, draining or
    breaker-open): fail fast, retry later (HTTP 503)."""


class AllReplicasDegraded(NoHealthyReplica):
    """Admission control: every available replica is degraded (SLO burn
    or queue saturation); the request is shed (HTTP 503)."""


class UnknownVersion(ValueError):
    """The request pinned a model version no replica serves (HTTP 400)."""


class Replica:
    """One engine + batcher + breaker + SLO tracker, with the lifecycle
    state the router keys on. Built by :meth:`ReplicaPool.build`."""

    def __init__(self, idx: int, engine: InferenceEngine,
                 batcher: MicroBatcher,
                 breaker: Optional[CircuitBreaker],
                 slo: Optional[SLOTracker],
                 degraded_queue_frac: float = 0.8,
                 slo_burn_degraded: float = 2.0,
                 fleet: bool = True):
        self.idx = int(idx)
        self.engine = engine
        self.batcher = batcher
        self.breaker = breaker
        self.slo = slo
        self.degraded_queue_frac = float(degraded_queue_frac)
        self.slo_burn_degraded = float(slo_burn_degraded)
        # the LM plane (serve/lm LMScheduler), set by ReplicaPool.attach_lm
        self.lm = None
        self._state = UP
        # a submit holds it across its state/version re-check and the
        # enqueue, and a reload takes it to flip DRAINING: a request
        # picked for version X is never admitted after the replica began
        # draining toward version Y
        self.admission_lock = threading.Lock()
        # the lifecycle gauge and ledger events of a fleet's replica
        self.fleet = bool(fleet)
        self._g_state = None
        if self.fleet:
            self._g_state = REGISTRY.gauge(
                "cxxnet_serve_replica_state",
                "Replica lifecycle state (0=up 1=draining 2=reloading "
                "3=down)", labels=("engine",)).labels(engine.stats.instance)
            self._g_state.set(0)

    @classmethod
    def build(cls, idx: int, engine: InferenceEngine, *,
              max_batch: Optional[int] = None,
              max_latency_ms: float = 5.0, max_queue_rows: int = 1024,
              default_timeout_ms: Optional[float] = None,
              breaker_threshold: int = 5, breaker_reset_s: float = 10.0,
              degraded_queue_frac: float = 0.8,
              slo_ms: float = 0.0, slo_target: float = 0.99,
              slo_window_s: float = 60.0,
              slo_burn_degraded: float = 2.0,
              fleet: bool = True) -> "Replica":
        """``engine`` with a circuit breaker (none when
        ``breaker_threshold = 0``), an SLO tracker on its stats (when
        ``slo_ms > 0``: every terminal outcome is classified good or
        bad, and the burn rate turns the replica degraded before the
        breaker trips) and a micro-batcher."""
        breaker = (CircuitBreaker(failure_threshold=breaker_threshold,
                                  reset_timeout_s=breaker_reset_s)
                   if breaker_threshold > 0 else None)
        slo = None
        if slo_ms > 0:
            slo = SLOTracker(slo_ms, target=slo_target,
                             window_s=slo_window_s,
                             instance=engine.stats.instance)
            engine.stats.slo = slo
        batcher = MicroBatcher(
            engine, max_batch=max_batch, max_latency_ms=max_latency_ms,
            max_queue_rows=max_queue_rows,
            default_timeout_ms=default_timeout_ms, breaker=breaker)
        return cls(idx, engine, batcher, breaker, slo,
                   degraded_queue_frac=degraded_queue_frac,
                   slo_burn_degraded=slo_burn_degraded, fleet=fleet)

    # -- state -----------------------------------------------------------
    @property
    def version(self) -> str:
        """The version this replica serves: the engine's weights
        provenance, so a swap cannot leave it out of step."""
        return self.engine.weights_version

    @property
    def state(self) -> str:
        return self._state

    def set_state(self, new: str) -> None:
        """A lifecycle transition: the gauge and a ``replica_state``
        ledger event."""
        if new not in _STATE_CODE:
            raise ValueError(f"unknown replica state {new!r}")
        old, self._state = self._state, new
        if old == new or not self.fleet:
            return
        self._g_state.set(_STATE_CODE[new])
        # the W3C trace context of a current span (a reload's drain)
        # rides along; the ledger stamps the trace id itself
        tp = DISTTRACE.current_traceparent()
        LEDGER.event("replica_state", replica=self.idx,
                     engine=self.engine.stats.instance,
                     from_state=old, to_state=new, version=self.version,
                     **({"traceparent": tp} if tp else {}))

    # -- router signals --------------------------------------------------
    def alive(self) -> bool:
        return self.batcher._thread.is_alive()

    def available(self) -> bool:
        """In rotation: UP, worker alive, breaker not open. A breaker
        past its reset timeout reads half_open and stays available: the
        recovery probe needs traffic."""
        if self._state != UP or not self.alive():
            return False
        return self.breaker is None \
            or self.breaker.effective_state() != "open"

    def queue_frac(self) -> float:
        return self.batcher.queued_rows / max(1, self.batcher.max_queue_rows)

    def burn_rate(self) -> float:
        return self.slo.burn_rate() if self.slo is not None else 0.0

    def degraded(self) -> bool:
        """Impaired but serving, the admission-control predicate: the
        single-engine /healthz degraded clause (queue near its budget,
        breaker probing, SLO burn at or over the line)."""
        if self.breaker is not None \
                and self.breaker.effective_state() == "half_open":
            return True
        return self.queue_frac() >= self.degraded_queue_frac \
            or self.burn_rate() >= self.slo_burn_degraded

    def health(self) -> str:
        """``ok | degraded | open | down``, the single-engine /healthz
        vocabulary (draining or reloading reads degraded)."""
        if not self.alive():
            return "down"
        if self.breaker is not None \
                and self.breaker.effective_state() == "open":
            return "open"
        if self._state == DOWN:
            return "down"
        if self._state in (DRAINING, RELOADING) or self.degraded():
            return "degraded"
        return "ok"

    def snapshot(self) -> Dict[str, Any]:
        """The replica's /statz row: identity, routing signals and its
        engine's stats snapshot under ``stats``."""
        out = {
            "replica": self.idx,
            "engine_instance": self.engine.stats.instance,
            "state": self._state,
            "status": self.health(),
            "version": self.version,
            "weights_round": self.engine.weights_round,
            "weights_digest": self.engine.weights_digest,
            "queued_rows": self.batcher.queued_rows,
            "queue_frac": round(self.queue_frac(), 4),
            "devices": 1,
            "stats": self.engine.stats.snapshot(),
        }
        if self.breaker is not None:
            out["breaker"] = self.breaker.snapshot()
        if self.slo is not None:
            out["slo"] = self.slo.snapshot()
        return out

    def close(self, drain: bool = True) -> None:
        self.set_state(DOWN)
        # the LM plane first: its live sequences are what the batcher's
        # idle probe watches
        if self.lm is not None:
            self.lm.stop(drain=drain)
            self.lm.engine.close()
        self.batcher.close(drain=drain)
        self.engine.stats.unregister()
        if self.fleet:
            REGISTRY.get("cxxnet_serve_replica_state").remove_labels(
                self.engine.stats.instance)


def replica_devices(devs: Sequence, n: int, silent: bool = False) -> List:
    """The device of each of ``n`` replicas over ``devs``: round-robin
    when there are fewer devices than replicas, else one each (the rest
    idle, said unless ``silent``). Raises where each replica would span
    several devices."""
    devs = list(devs)
    if n < 1:
        raise ValueError(f"serve_replicas must be >= 1, got {n}")
    if len(devs) < n:
        return [devs[i % len(devs)] for i in range(n)]
    per = len(devs) // n
    if per > 1:
        raise ConfigError(
            f"{n} replica(s) over {len(devs)} cards would give each "
            f"replica {per} cards; one engine runs on one card (ROADMAP "
            "Queue A 4: replicas over several cards). Set serve_replicas "
            f"= {len(devs)} or list fewer cards in dev")
    if len(devs) % n and not silent:
        print(f"serve-fleet: {len(devs) - n} of {len(devs)} devices idle "
              f"({n} replicas x 1 device each)", flush=True)
    return devs[:n]


def build_engines(cfg: Any, n: int, *,
                  blob: Optional[Dict[str, Any]] = None, digest: str = "",
                  devices: Optional[Sequence] = None, buckets: Any = None,
                  max_batch: int = 64, cache_size: int = 16,
                  dtype: Optional[str] = None,
                  silent: bool = False) -> List[InferenceEngine]:
    """``n`` engines of the net config ``cfg``, placed by
    :func:`replica_devices` over ``devices`` (by default the cards the
    config's ``dev`` names).

    ``blob`` is a verified checkpoint blob, read once on the host and
    negotiated once for all of them (``serve_dtype = int8`` demands a
    quantized round, an fp engine dequantizes one), then placed per
    engine: N replicas never read or hash the archive N times. Without
    a blob every engine serves the same fresh weights (smoke mode,
    version ``init``)."""
    if blob is not None:
        blob = negotiate_blob(blob, dtype)
    pairs = parse_config_string(cfg) if isinstance(cfg, str) else list(cfg)
    if devices is None:
        devices = resolve_devices(global_param(pairs, "dev", ""))
    graph = build_graph(pairs)
    weights = (params_from_jax(blob["params"], blob["state"])
               if blob is not None else None)
    engines = []
    for dev in replica_devices(devices, int(n), silent):
        net = Network(graph, pairs, device=dev)
        net.load_weights(*(weights or net.init(
            torch.Generator().manual_seed(0))))
        engine = InferenceEngine(net, buckets=buckets, max_batch=max_batch,
                                 cache_size=cache_size, dtype=dtype)
        if blob is not None:
            engine.set_provenance(blob["meta"]["round"], digest)
        engines.append(engine)
    return engines


class ReplicaPool:
    """N replicas + the router. Build with :meth:`build` or
    :meth:`from_engines`, or pass built replicas (tests)."""

    def __init__(self, replicas: Sequence[Replica],
                 admission_control: bool = True):
        if not replicas:
            raise ValueError("replica pool needs at least one replica")
        self.replicas: List[Replica] = list(replicas)
        self.admission_control = bool(admission_control)
        self.fleet = all(r.fleet for r in self.replicas)
        self.instance = str(next(_POOL_SEQ))
        self._lock = threading.Lock()
        self._rr = 0
        # per-version terminal outcomes (the A/B readout):
        # version -> {requests, ok, failed, lat_sum}
        self._vstats: Dict[str, Dict[str, float]] = {}
        # trace ids of recent failed requests a version (bounded; sampled
        # traces only): a deploy_incident names them
        self._failed_traces: Dict[str, deque] = {}
        self._c_version = REGISTRY.counter(
            "cxxnet_serve_version_requests_total",
            "Pool requests by model version and outcome",
            labels=("pool", "version", "result"))

    # -- construction ----------------------------------------------------
    @classmethod
    def build(cls, cfg: Any, n_replicas: int, *,
              blob: Optional[Dict[str, Any]] = None,
              digest: str = "",
              devices: Optional[Sequence] = None,
              admission_control: bool = True,
              buckets: Any = None, max_batch: int = 64,
              cache_size: int = 16, dtype: Optional[str] = None,
              silent: bool = False, **knobs) -> "ReplicaPool":
        """:func:`build_engines`, each engine a replica of
        :meth:`from_engines` with ``knobs`` (:meth:`Replica.build`)."""
        return cls.from_engines(
            build_engines(cfg, n_replicas, blob=blob, digest=digest,
                          devices=devices, buckets=buckets,
                          max_batch=max_batch, cache_size=cache_size,
                          dtype=dtype, silent=silent),
            admission_control=admission_control, **knobs)

    @classmethod
    def from_engines(cls, engines: Sequence[InferenceEngine],
                     admission_control: bool = True,
                     **knobs) -> "ReplicaPool":
        """A pool of one replica per engine, each with its own batcher,
        breaker and SLO tracker (``knobs``: :meth:`Replica.build`, its
        ``fleet`` flag included)."""
        return cls([Replica.build(i, e, **knobs)
                    for i, e in enumerate(engines)],
                   admission_control=admission_control)

    # -- routing ---------------------------------------------------------
    def versions(self) -> Dict[str, List[int]]:
        """version -> indices of the replicas serving it."""
        out: Dict[str, List[int]] = {}
        for r in self.replicas:
            out.setdefault(r.version, []).append(r.idx)
        return out

    def _unknown(self, version: str) -> UnknownVersion:
        return UnknownVersion(
            f"no replica serves model version {version!r}; "
            f"available: {sorted(self.versions())}")

    def pick(self, version: Optional[str] = None) -> Replica:
        """Route one request (the policy of the module docstring)."""
        cands = [r for r in self.replicas
                 if version is None or r.version == version]
        if version is not None and not cands:
            raise self._unknown(version)
        avail = [r for r in cands if r.available()]
        if not avail:
            raise NoHealthyReplica(
                "no replica available"
                + (f" for version {version!r}" if version else "")
                + ": all down, draining, or breaker-open — retry later")
        healthy = [r for r in avail if not r.degraded()]
        if not healthy:
            if self.admission_control:
                raise AllReplicasDegraded(
                    "admission control: every available replica is "
                    "degraded (SLO burn / queue saturation) — "
                    "shedding load, retry later")
            healthy = avail
        with self._lock:
            self._rr += 1
            rr = self._rr
        n = len(self.replicas)
        # least queued rows; the rotation breaks ties
        return min(healthy, key=lambda r: (r.batcher.queued_rows,
                                           (r.idx - rr) % n))

    def submit(self, data, kind: str = "predict",
               node: Optional[str] = None,
               timeout_ms: Optional[float] = None,
               version: Optional[str] = None):
        """Route and enqueue one request; returns its result Future. The
        pick is checked again under the replica's admission lock: a
        reload that flips it to DRAINING (or swaps its version) between
        the pick and the enqueue would otherwise serve a pinned request
        from the wrong model. The per-version outcomes hang off the
        future, so the A/B readout sees terminal results. The route
        decision is the ``serve.route`` span, naming the replica (a
        child of the request's trace under distributed tracing); a
        failed request's trace id is kept for :meth:`failed_traces`."""
        route_ctx = DISTTRACE.current()
        t_route0 = time.perf_counter()
        for _ in range(8):            # re-pick bound: reloads are rare
            rep = self.pick(version)
            with rep.admission_lock:
                if rep.state != UP or (version is not None
                                       and rep.version != version):
                    continue          # lost a race with a reload
                ver = rep.version
                # the route ends before the enqueue, where the queue
                # wait begins
                t_route1 = time.perf_counter()
                fut = rep.batcher.submit(data, kind, node,
                                         timeout_ms=timeout_ms)
                break
        else:
            raise NoHealthyReplica(
                "could not admit request: replicas kept transitioning "
                "(reload storm?) — retry later")
        if route_ctx is not None:
            DISTTRACE.record("serve.route", t_route0, t_route1, route_ctx,
                             cat="serve",
                             args={"replica": rep.idx, "version": ver})
        else:
            TRACER.add_complete("serve.route", t_route0, t_route1,
                                cat="serve",
                                args={"replica": rep.idx, "version": ver})
        t0 = time.perf_counter()
        with self._lock:
            vs = self._vstats.setdefault(
                ver, {"requests": 0, "ok": 0, "failed": 0, "lat_sum": 0.0})
            vs["requests"] += 1

        def _done(f):
            ok = f.exception() is None
            with self._lock:
                vs["ok" if ok else "failed"] += 1
                if ok:
                    vs["lat_sum"] += time.perf_counter() - t0
                elif route_ctx is not None and route_ctx.sampled:
                    self._failed_traces.setdefault(
                        ver, deque(maxlen=16)).append(route_ctx.trace_id)
            if self.fleet:
                self._c_version.labels(self.instance, ver,
                                       "ok" if ok else "failed").inc()
        fut.add_done_callback(_done)
        return fut

    # -- LM serving plane (serve/lm) --------------------------------------
    def attach_lm(self, lm_cfg) -> None:
        """Bring up the LM plane: one paged-KV LMEngine and scheduler per
        replica over the replica's own network and weights, so a hot
        reload swaps them too. The scheduler's live count is the
        batcher's idle probe (a reload drain waits for decodes still
        holding KV blocks) and its snapshot the stats' ``lm``."""
        from .lm import LMEngine, LMScheduler
        for rep in self.replicas:
            if rep.lm is not None:
                raise RuntimeError(
                    f"replica {rep.idx} already has an LM plane")
            sched = LMScheduler(LMEngine(rep.engine, lm_cfg), lm_cfg)
            sched.start()
            rep.batcher.add_idle_probe(sched.live_count)
            rep.engine.stats.lm = sched.snapshot
            rep.lm = sched

    def set_lm_role(self, idx: int, role: str, peer=None) -> None:
        """Switch one replica's plane mid-run, e.g. disaggregate with
        ``pool.set_lm_role(0, "prefill",
        peer=pool.replicas[1].lm.handoff_addr)``."""
        rep = self.replicas[int(idx)]
        if rep.lm is None:
            raise RuntimeError(f"replica {idx} has no LM plane")
        rep.lm.set_role(role, peer)

    def submit_lm(self, prompt, max_new: Optional[int] = None,
                  deadline_ms: Optional[float] = None,
                  version: Optional[str] = None):
        """Route one generation request; returns its StreamHandle. The
        discipline of :meth:`submit` over the replicas that can start a
        sequence (decode-role replicas only take handoffs), the one
        with the fewest live sequences first."""
        cands = [r for r in self.replicas
                 if r.lm is not None and r.lm.role != "decode"
                 and (version is None or r.version == version)]
        if version is not None and not cands:
            raise self._unknown(version)
        if not cands:
            raise NoHealthyReplica(
                "no replica accepts LM requests (none attached, or all "
                "decode-role)")
        for _ in range(8):            # re-pick bound, as in submit()
            avail = [r for r in cands if r.available()]
            if not avail:
                raise NoHealthyReplica(
                    "no LM replica available: all down, draining, or "
                    "breaker-open — retry later")
            rep = min(avail, key=lambda r: r.lm.live_count())
            with rep.admission_lock:
                if rep.state != UP or (version is not None
                                       and rep.version != version):
                    continue          # lost a race with a reload
                return rep.lm.submit(prompt, max_new=max_new,
                                     deadline_ms=deadline_ms)
        raise NoHealthyReplica(
            "could not admit LM request: replicas kept transitioning "
            "(reload storm?) — retry later")

    def failed_traces(self, version: str) -> List[str]:
        """Trace ids of recent failed requests against ``version`` (newest
        last; empty when tracing is off or the traces were unsampled)."""
        with self._lock:
            return list(self._failed_traces.get(version, ()))

    # -- reload hooks (serve/reload.py drives these) ---------------------
    def reload_replica(self, idx: int, params, net_state,
                       round_counter: int, digest: str = "",
                       drain_timeout_s: float = 30.0) -> int:
        """Swap one replica's weights with a graceful drain: DRAINING
        takes it out of rotation (what it admitted still completes), the
        swap waits until the batcher is idle (its LM plane's sequences
        included), and the replica comes back UP. Past the drain timeout
        the swap goes ahead: a dispatch still running reads its weights
        as one pair, all old or all new. Returns the old round."""
        rep = self.replicas[int(idx)]
        old_round = rep.engine.weights_round
        # under the admission lock: no request already picked can still
        # be admitted after this, so `idle` really means quiescent
        with rep.admission_lock:
            rep.set_state(DRAINING)
        try:
            deadline = time.perf_counter() + drain_timeout_s
            while not rep.batcher.idle \
                    and time.perf_counter() < deadline:
                time.sleep(0.002)
            rep.set_state(RELOADING)
            rep.engine.swap_weights(params, net_state, round_counter,
                                    digest)
        finally:
            rep.set_state(UP)
        return old_round

    def newest_round(self) -> int:
        """Newest checkpoint round any replica serves (-1 while every
        replica serves fresh weights)."""
        rounds = [r.engine.weights_round for r in self.replicas
                  if r.version != "init"]
        return max(rounds) if rounds else -1

    # -- aggregate views -------------------------------------------------
    def health(self) -> Dict[str, Any]:
        """Fleet health: the worst replica decides the status, and the
        per-replica statuses ride along."""
        rank = {"ok": 0, "degraded": 1, "open": 2, "down": 3}
        statuses = [r.health() for r in self.replicas]
        worst = max(statuses, key=lambda s: rank[s])
        return {
            "status": worst,
            "replicas": [
                {"replica": r.idx, "status": s, "state": r.state,
                 "version": r.version,
                 "queued_rows": r.batcher.queued_rows,
                 "burn_rate": round(r.burn_rate(), 4)}
                for r, s in zip(self.replicas, statuses)],
            "versions": self.versions(),
        }

    def version_stats(self) -> Dict[str, Dict[str, Any]]:
        """Per-version outcomes. Versions being served always appear (a
        canary with no traffic yet too); retired ones keep their
        numbers for the A/B comparison."""
        serving = self.versions()
        with self._lock:
            out = {}
            for ver in set(serving) | set(self._vstats):
                vs = self._vstats.get(
                    ver, {"requests": 0, "ok": 0, "failed": 0,
                          "lat_sum": 0.0})
                done = vs["ok"]
                out[ver] = {
                    "replicas": serving.get(ver, []),
                    "requests": int(vs["requests"]),
                    "ok": int(vs["ok"]),
                    "failed": int(vs["failed"]),
                    "mean_ms": round(1e3 * vs["lat_sum"] / done, 3)
                    if done else 0.0,
                }
            return out

    def snapshot(self) -> Dict[str, Any]:
        """The fleet's /statz: the single-engine key layout at the top
        (summed over replicas, percentiles over the pooled latency
        samples), plus ``replicas`` and ``versions``."""
        stats = [r.engine.stats for r in self.replicas]
        lat = sorted(s for st in stats for s in st.latency_samples())
        pct = ServingStats._pct
        snaps = [st.snapshot() for st in stats]

        def total(group: str, key: str) -> int:
            return sum(s[group][key] for s in snaps)
        rows_real = total("batches", "rows_real")
        rows_padded = total("batches", "rows_padded")
        b_disp = total("batches", "dispatched")
        req_batched = sum(st.requests_batched for st in stats)
        return {
            "uptime_s": round(max(st.snapshot_uptime() for st in stats), 3),
            "requests": {k: total("requests", k)
                         for k in snaps[0]["requests"]},
            "qps": round(sum(st.recent_qps() for st in stats), 3),
            "latency_ms": {
                "p50": round(1e3 * pct(lat, 0.50), 3),
                "p95": round(1e3 * pct(lat, 0.95), 3),
                "p99": round(1e3 * pct(lat, 0.99), 3),
                "mean": round(1e3 * sum(lat) / len(lat), 3) if lat
                        else 0.0,
                "samples": len(lat),
            },
            "batches": {
                "dispatched": b_disp,
                "coalesced_ge2": total("batches", "coalesced_ge2"),
                "avg_requests_per_batch":
                    round(req_batched / b_disp, 3) if b_disp else 0.0,
                "fill_ratio": round(rows_real / rows_padded, 4)
                if rows_padded else 0.0,
                "rows_real": rows_real,
                "rows_padded": rows_padded,
            },
            "compile_cache": {k: total("compile_cache", k)
                              for k in snaps[0]["compile_cache"]},
            "replicas": [r.snapshot() for r in self.replicas],
            "versions": self.version_stats(),
        }

    # -- lifecycle -------------------------------------------------------
    def close(self, drain: bool = True) -> None:
        for r in self.replicas:
            r.close(drain=drain)
        fam = REGISTRY.get("cxxnet_serve_version_requests_total")
        if fam is not None:
            with self._lock:
                for ver in self._vstats:
                    for res in ("ok", "failed"):
                        fam.remove_labels(self.instance, ver, res)
