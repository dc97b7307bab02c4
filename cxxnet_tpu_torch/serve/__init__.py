"""Serving: engine, micro-batcher, stats and the HTTP server."""

from .batcher import Backpressure, DeadlineExceeded, MicroBatcher
from .engine import InferenceEngine
from .server import NoLMPlane, ServeServer, UnknownVersion
from .stats import ServingStats

__all__ = ["Backpressure", "DeadlineExceeded", "InferenceEngine",
           "MicroBatcher", "NoLMPlane", "ServeServer", "ServingStats",
           "UnknownVersion"]
