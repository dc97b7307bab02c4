"""Serving: engine, micro-batcher, stats, the replica fleet with its hot
reload, the two-tier cascade, and the HTTP server."""

from .batcher import Backpressure, DeadlineExceeded, MicroBatcher
from .cascade import CascadeRouter, row_confidence
from .engine import InferenceEngine
from .fleet import (AllReplicasDegraded, NoHealthyReplica, ReplicaPool,
                    UnknownVersion)
from .reload import ReloadWatcher
from .server import NoLMPlane, ServeServer
from .stats import ServingStats

__all__ = ["AllReplicasDegraded", "Backpressure", "CascadeRouter",
           "DeadlineExceeded",
           "InferenceEngine", "MicroBatcher", "NoHealthyReplica",
           "NoLMPlane", "ReloadWatcher", "ReplicaPool", "ServeServer",
           "ServingStats", "UnknownVersion", "row_confidence"]
