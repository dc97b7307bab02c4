"""Telemetry of the port: the serve latency-SLO tracker and the offline
model-health verdict. The Prometheus registry, the run ledger, the spans
and the trainer-side model health wait for ROADMAP Queue A 12."""

from .modelhealth import layer_report, reload_verdict
from .slo import SLOTracker

__all__ = ["SLOTracker", "layer_report", "reload_verdict"]
