"""Serving: engine, micro-batcher, stats, the replica fleet with its hot
reload, and the HTTP server."""

from .batcher import Backpressure, DeadlineExceeded, MicroBatcher
from .engine import InferenceEngine
from .fleet import (AllReplicasDegraded, NoHealthyReplica, ReplicaPool,
                    UnknownVersion)
from .reload import ReloadWatcher
from .server import NoLMPlane, ServeServer
from .stats import ServingStats

__all__ = ["AllReplicasDegraded", "Backpressure", "DeadlineExceeded",
           "InferenceEngine", "MicroBatcher", "NoHealthyReplica",
           "NoLMPlane", "ReloadWatcher", "ReplicaPool", "ServeServer",
           "ServingStats", "UnknownVersion"]
