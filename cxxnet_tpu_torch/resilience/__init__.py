"""Fault tolerance of the serve path (the port of ``cxxnet_tpu/resilience``):
the dispatch circuit breaker. Failpoints, retries and the training
sentinel come with the training telemetry (ROADMAP Queue A 12)."""

from .breaker import CircuitBreaker, CircuitOpen

__all__ = ["CircuitBreaker", "CircuitOpen"]
