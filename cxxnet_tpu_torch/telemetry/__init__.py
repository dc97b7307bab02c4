"""Telemetry of the port (the port of ``cxxnet_tpu/telemetry``): one
registry, one tracer, every subsystem a client.

* :mod:`.registry`: the process-wide Counter / Gauge / Histogram
  registry (:data:`REGISTRY`); ``ServingStats``, the SLO tracker and
  ``resilience.counters`` store their numbers here, and ``GET /metrics``
  and ``/statz`` are views of it;
* :mod:`.trace`: span tracing (:data:`TRACER`), written as Chrome trace
  JSON by ``telemetry_trace = <path>``;
* :mod:`.steptime`: :class:`StepTimeProbe`, the data wait / dispatch /
  device breakdown with its verdict in the round line;
* :mod:`.exporter`: Prometheus text, the ``telemetry_port`` scrape
  server and the ``telemetry_log`` JSONL log;
* :mod:`.profiler`: ``telemetry_profile_steps = a-b`` and
  ``profile_dir`` through ``torch.profiler``;
* :mod:`.ledger`: the run ledger (``telemetry_ledger = <path>``);
* :mod:`.slo` and :mod:`.modelhealth`: the serve latency SLO, the
  offline checkpoint verdict and the trainer's health probe;
* :mod:`.disttrace`: distributed tracing (W3C traceparent over the
  serve HTTP and the data-service wire, clock anchors and offsets for
  ``tools/trace_assemble.py``);
* :mod:`.aggregate`: the fleet snapshot push and the merged,
  host-labelled ``/metrics`` of ``telemetry_fleet_dir``;
* :mod:`.anomaly`: the straggler, hang and recompile-storm detectors;
* :mod:`.traceparse`: the per-phase attribution of a profile bracket.

:class:`TelemetrySession` bundles the knob-driven pieces, so the task
driver owns one object with one ``close()``.
"""

from __future__ import annotations

import os
from typing import Optional

from .aggregate import (FleetAggregator, FleetView, SnapshotPusher,
                        export_snapshot, merge_snapshots, quantile,
                        render_fleet)
from .anomaly import (HangWatchdog, RecompileStormDetector,
                      StragglerDetector, install_compile_counter)
from .disttrace import (DISTTRACE, DistTracer, TraceContext,
                        estimate_offset, parse_traceparent,
                        set_trace_identity)
from .exporter import (PROMETHEUS_CONTENT_TYPE, MetricsServer,
                       TelemetryLogger, render_prometheus)
from .ledger import (LEDGER, RunLedger, config_hash, new_run_id,
                     read_ledger, run_info, set_run_info)
from .modelhealth import HealthProbe, layer_report, reload_verdict
from .profiler import ProfileBracket, ProfilerError, StepProfiler
from .registry import REGISTRY, MetricRegistry, get_registry, log_buckets
from .slo import SLOTracker
from .steptime import StepTimeProbe
from .trace import TRACER, Tracer

__all__ = [
    "REGISTRY", "MetricRegistry", "get_registry", "log_buckets",
    "TRACER", "Tracer", "StepTimeProbe", "StepProfiler",
    "ProfileBracket", "ProfilerError", "MetricsServer", "TelemetryLogger",
    "render_prometheus", "PROMETHEUS_CONTENT_TYPE", "TelemetrySession",
    "LEDGER", "RunLedger", "new_run_id", "config_hash",
    "set_run_info", "run_info", "read_ledger", "SLOTracker",
    "layer_report", "reload_verdict", "HealthProbe",
    "DISTTRACE", "DistTracer", "TraceContext", "estimate_offset",
    "parse_traceparent", "set_trace_identity",
    "FleetAggregator", "FleetView", "SnapshotPusher", "export_snapshot",
    "merge_snapshots", "quantile", "render_fleet",
    "HangWatchdog", "RecompileStormDetector", "StragglerDetector",
    "install_compile_counter",
]


class TelemetrySession:
    """Everything the ``telemetry_*`` keys turn on, with one
    :meth:`close` (the JAX package's session). Built by ``main.py`` from
    a :class:`~cxxnet_tpu_torch.config.TelemetryConfig`; every piece is
    off by default but the step-time probe. ``cuda`` says whether the
    train step runs on a card (the step profiler then requires device
    events). A ``telemetry_port`` that cannot be bound raises.

    ``telemetry_ledger`` or ``telemetry_fleet_dir`` counts this
    process's compiles and arms the recompile-storm detector;
    ``telemetry_trace`` also turns on distributed tracing;
    ``telemetry_fleet_dir`` pushes this host's snapshot there, and on
    host 0 aggregates the fleet (``/metrics`` serves the merged view)
    and runs the straggler detector; ``telemetry_hang_s`` (or
    ``telemetry_hang_dryrun``) arms the hang watchdog."""

    def __init__(self, cfg, silent: bool = False, cfg_hash: str = "",
                 host: int = 0, cuda: bool = False):
        self.cfg = cfg
        self.silent = silent
        self.host = int(host)
        self.logger: Optional[TelemetryLogger] = None
        self.server: Optional[MetricsServer] = None
        self.profiler: Optional[StepProfiler] = None
        self.pusher: Optional[SnapshotPusher] = None
        self.aggregator: Optional[FleetAggregator] = None
        self.straggler: Optional[StragglerDetector] = None
        self.watchdog: Optional[HangWatchdog] = None
        self.storm: Optional[RecompileStormDetector] = None
        #: the aggregating host's latest straggler verdicts
        self.last_straggler_verdicts: list = []
        # run identity: the knob, else the env (so the processes of one
        # run share one id), else a fresh one
        self.run_id = (cfg.run_id or os.environ.get("CXXNET_RUN_ID")
                       or new_run_id())
        self.cfg_hash = cfg_hash
        set_run_info(self.run_id, cfg_hash)
        if cfg.ledger_path:
            LEDGER.enable(cfg.ledger_path, self.run_id, host=self.host)
        if cfg.ledger_path or cfg.fleet_dir:
            install_compile_counter()
            self.storm = RecompileStormDetector(
                window_s=cfg.storm_window_s,
                threshold=cfg.storm_threshold)
        if cfg.trace_path:
            TRACER.enable(capacity=cfg.trace_capacity)
            DISTTRACE.enable(sample=cfg.trace_sample,
                             tail_pct=cfg.trace_tail_pct,
                             tail_window=cfg.trace_tail_window,
                             anchor_s=cfg.trace_anchor_s)
            set_trace_identity(host=self.host)
        if cfg.log_path:
            self.logger = TelemetryLogger(
                cfg.log_path, interval_s=cfg.log_interval_s,
                max_bytes=cfg.log_max_kb << 10).start()
        if cfg.port:
            self.server = MetricsServer(port=cfg.port).start()
            if not silent:
                print(f"telemetry: /metrics on "
                      f"http://127.0.0.1:{self.server.port}", flush=True)
        if cfg.profile_steps:
            self.profiler = StepProfiler(cfg.profile_steps, cfg.profile_dir,
                                         cuda=cuda)
        if cfg.fleet_dir:
            # every host pushes; host 0 also aggregates, and its
            # /metrics serves the merged fleet
            self.pusher = SnapshotPusher(
                cfg.fleet_dir, host=self.host,
                interval_s=cfg.push_interval_s,
                run_id=self.run_id).start()
            if self.host == 0:
                self.aggregator = FleetAggregator(cfg.fleet_dir,
                                                  host=self.host,
                                                  run_id=self.run_id)
                self.straggler = StragglerDetector(
                    factor=cfg.straggler_factor,
                    min_steps=cfg.straggler_min_steps)
                if self.server is not None:
                    self.server.render_fn = self.aggregator.render
        if cfg.hang_s > 0 or cfg.hang_dryrun:
            # progress = the step-time probe's step counter until the
            # trainer gives its own (main.py sets progress_fn)
            steps = REGISTRY.counter("cxxnet_steptime_steps_total")
            self.watchdog = HangWatchdog(
                cfg.hang_s if cfg.hang_s > 0 else 3600.0,
                progress_fn=lambda: steps.value)
            if cfg.hang_s > 0:
                self.watchdog.start()
            if cfg.hang_dryrun:
                self.watchdog.dump_now(dry_run=True)

    def make_probe(self) -> StepTimeProbe:
        return StepTimeProbe(sync_interval=self.cfg.sync_interval)

    def round_tick(self, round_no: int, **fields) -> str:
        """End-of-round housekeeping of the train loop: the ``round_end``
        ledger event, this host's snapshot push, the recompile-storm
        feed, and on the aggregating host the per-host step medians and
        the straggler verdicts. Returns a round-log fragment ("" when
        there is nothing fleet-worthy to say)."""
        LEDGER.event("round_end", round=round_no, **fields)
        if self.pusher is not None:
            self.pusher.push_now()
        if self.storm is not None:
            c = REGISTRY.get("cxxnet_compiles_total")
            if c is not None:
                self.storm.observe(c.value)
        if self.aggregator is None or self.straggler is None:
            return ""
        view = self.aggregator.view()
        verdicts = self.straggler.check(view, round_no)
        self.last_straggler_verdicts = verdicts
        frag = ""
        if len(view.hosts) > 1:
            meds = []
            for h in view.hosts:
                for vals, v in view.host_samples(
                        "cxxnet_steptime_step_seconds", h):
                    if isinstance(v, dict) and vals == () and v["count"]:
                        meds.append("h%d=%.1f" % (h, 1e3 * quantile(
                            v["buckets"], v["counts"], 0.5)))
            if meds:
                frag += "\tfleet_p50_ms:" + ",".join(meds)
        frag += StragglerDetector.fragment(verdicts)
        return frag

    def close(self, ready=None, status: str = "ok") -> None:
        """Finish in order: close a live profiler bracket, stop the
        watchdog, the last fleet push, ``run_end`` to the ledger, flush
        the JSONL log, write the trace, stop the scrape server. The
        ledger and the tracers go back to disabled."""
        try:
            if self.profiler is not None:
                self.profiler.close(ready)
        finally:
            if self.watchdog is not None:
                self.watchdog.stop()
            if self.pusher is not None:
                self.pusher.stop()
            LEDGER.event("run_end", status=status)
            LEDGER.disable()
            if self.logger is not None:
                self.logger.stop()
            if self.cfg.trace_path:
                # a last wall-clock anchor dates the last spans
                DISTTRACE.anchor(force=True)
                n, dropped = TRACER.dump(self.cfg.trace_path), TRACER.dropped
                DISTTRACE.disable()
                TRACER.disable()
                TRACER.clear()
                if not self.silent:
                    print(f"telemetry: {n} trace events -> "
                          f"{self.cfg.trace_path}"
                          + (f" ({dropped} dropped)" if dropped else ""),
                          flush=True)
            if self.server is not None:
                self.server.stop()
