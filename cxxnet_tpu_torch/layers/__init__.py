"""Layer registry and factory (the port of ``cxxnet_tpu/layers/__init__.py``)."""

from __future__ import annotations

from ..config import ConfigPairs
from ..graph import LayerSpec
from .base import LAYER_REGISTRY, ApplyCtx, Layer, register_layer
from . import core, conv, norm, loss, seq  # noqa: F401  (populate registry)


def create_layer(spec: LayerSpec, global_cfg: ConfigPairs) -> Layer:
    """Build the layer object of ``spec``. ``share`` specs are resolved
    by the Network (the primary layer object is reused), so they never
    reach this factory. Types the grammar knows but the port does not
    build yet raise, naming the ROADMAP item."""
    if spec.type not in LAYER_REGISTRY:
        item = ("Queue A 8, experts" if spec.type == "moe"
                else "Queue A 6, remaining layers")
        raise NotImplementedError(
            f"layer type {spec.type!r} ({spec.name!r}) is not in the "
            f"PyTorch port yet (ROADMAP {item})")
    return LAYER_REGISTRY[spec.type](spec, global_cfg)


__all__ = ["Layer", "ApplyCtx", "LayerSpec", "create_layer",
           "LAYER_REGISTRY", "register_layer"]
