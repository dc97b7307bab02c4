"""Autoregressive LM serving: paged KV-cache, continuous batching,
token streaming, prefill/decode disaggregation (the port of
``cxxnet_tpu/serve/lm/``).

Layering (each module only reaches down):

* ``blocks``    — host-side block allocator
* ``engine``    — LMEngine: the paged-attention step over a wrapped
                  InferenceEngine (its network, weights and device)
* ``stream``    — ndjson event + HTTP chunked framing helpers
* ``handoff``   — prefill -> decode KV shipping (data_service wire)
* ``scheduler`` — continuous-batching loop, StreamHandle, roles

Entry point: ``ServeServer.attach_lm`` runs one LMScheduler on the
server's engine and serves ``POST /generate`` (streaming).
"""

from .blocks import BlockPool, PoolExhausted, SCRATCH_BLOCK
from .engine import LMEngine
from .scheduler import LMScheduler, StreamHandle

__all__ = ["BlockPool", "PoolExhausted", "SCRATCH_BLOCK", "LMEngine",
           "LMScheduler", "StreamHandle"]
