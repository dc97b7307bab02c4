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
* :mod:`.slo` and :mod:`.modelhealth`: the serve latency SLO and the
  offline checkpoint verdict.

:class:`TelemetrySession` bundles the knob-driven pieces, so the task
driver owns one object with one ``close()``. The fleet pieces of the
JAX package (``telemetry_fleet_dir``, the straggler, hang and
recompile-storm detectors, distributed tracing) wait for ROADMAP Queue
A 12.
"""

from __future__ import annotations

import os
from typing import Optional

from .exporter import (PROMETHEUS_CONTENT_TYPE, MetricsServer,
                       TelemetryLogger, render_prometheus)
from .ledger import (LEDGER, RunLedger, config_hash, new_run_id,
                     read_ledger, run_info, set_run_info)
from .modelhealth import layer_report, reload_verdict
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
    "layer_report", "reload_verdict",
]


class TelemetrySession:
    """Everything the ``telemetry_*`` keys turn on, with one
    :meth:`close`. Built by ``main.py`` from a
    :class:`~cxxnet_tpu_torch.config.TelemetryConfig`; every piece is off
    by default but the step-time probe. ``cuda`` says whether the train
    step runs on a card (the step profiler then requires device
    events). A ``telemetry_port`` that cannot be bound raises."""

    def __init__(self, cfg, silent: bool = False, cfg_hash: str = "",
                 host: int = 0, cuda: bool = False):
        self.cfg = cfg
        self.silent = silent
        self.host = int(host)
        self.logger: Optional[TelemetryLogger] = None
        self.server: Optional[MetricsServer] = None
        self.profiler: Optional[StepProfiler] = None
        # run identity: the knob, else the env (so the processes of one
        # run share one id), else a fresh one
        self.run_id = (cfg.run_id or os.environ.get("CXXNET_RUN_ID")
                       or new_run_id())
        self.cfg_hash = cfg_hash
        set_run_info(self.run_id, cfg_hash)
        if cfg.ledger_path:
            LEDGER.enable(cfg.ledger_path, self.run_id, host=self.host)
        if cfg.trace_path:
            TRACER.enable(capacity=cfg.trace_capacity)
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

    def make_probe(self) -> StepTimeProbe:
        return StepTimeProbe(sync_interval=self.cfg.sync_interval)

    def round_tick(self, round_no: int, **fields) -> str:
        """End-of-round housekeeping of the train loop: the ``round_end``
        ledger event. Returns a round-log fragment (none on one
        process)."""
        LEDGER.event("round_end", round=round_no, **fields)
        return ""

    def close(self, ready=None, status: str = "ok") -> None:
        """Finish in order: close a live profiler bracket, ``run_end`` to
        the ledger, flush the JSONL log, write the trace, stop the scrape
        server. The ledger and the tracer go back to disabled."""
        try:
            if self.profiler is not None:
                self.profiler.close(ready)
        finally:
            LEDGER.event("run_end", status=status)
            LEDGER.disable()
            if self.logger is not None:
                self.logger.stop()
            if self.cfg.trace_path:
                n, dropped = TRACER.dump(self.cfg.trace_path), TRACER.dropped
                TRACER.disable()
                TRACER.clear()
                if not self.silent:
                    print(f"telemetry: {n} trace events -> "
                          f"{self.cfg.trace_path}"
                          + (f" ({dropped} dropped)" if dropped else ""),
                          flush=True)
            if self.server is not None:
                self.server.stop()
