"""Serve telemetry of the port: the latency-SLO tracker. The Prometheus
registry, the run ledger and the spans wait for ROADMAP Queue A 12."""

from .slo import SLOTracker

__all__ = ["SLOTracker"]
