"""Layer registry and factory (the port of ``cxxnet_tpu/layers/__init__.py``),
with the ``pairtest`` composite and user ``plugin`` layers."""

from __future__ import annotations

import dataclasses
import importlib

import torch

from ..config import ConfigPairs
from ..graph import LayerSpec
from .base import LAYER_REGISTRY, ApplyCtx, Layer, register_layer
from . import core, conv, norm, loss, seq, moe  # noqa: F401  (populate registry)


class PairTestLayer(Layer):
    """Master and slave implementations side by side on one input: the
    output is the master's, and a training forward records the largest
    ``|master - slave|`` over the outputs in the layer state under
    ``diff`` (f32). Params ``{"master": ..., "slave": ...}``, the slave's
    a copy of the master's at init; state ``{"master", "slave", "diff"}``.
    Both share the context, so they draw the same numbers."""
    has_params = True
    has_state = True

    def __init__(self, spec: LayerSpec, global_cfg: ConfigPairs):
        master_t, slave_t = spec.pairtest
        sub = lambda t, role: LayerSpec(
            type=t, name=spec.name + "." + role, nindex_in=spec.nindex_in,
            nindex_out=spec.nindex_out, cfg=list(spec.cfg))
        self.master = LAYER_REGISTRY[master_t](sub(master_t, "master"),
                                               global_cfg)
        self.slave = LAYER_REGISTRY[slave_t](sub(slave_t, "slave"),
                                             global_cfg)
        super().__init__(spec, global_cfg)

    def infer_shapes(self, in_shapes):
        out_m = self.master.infer_shapes(in_shapes)
        out_s = self.slave.infer_shapes(in_shapes)
        if out_m != out_s:
            raise ValueError(
                f"pairtest {self.name!r}: master/slave shapes disagree "
                f"{out_m} vs {out_s}")
        return out_m

    def init_params(self, generator, in_shapes):
        p = self.master.init_params(generator, in_shapes)
        return {"master": p, "slave": {k: v.clone() for k, v in p.items()}}

    def init_state(self, in_shapes):
        return {"master": self.master.init_state(in_shapes),
                "slave": self.slave.init_state(in_shapes),
                "diff": torch.zeros((), dtype=torch.float32)}

    def cast_params(self, lp, dtype):
        return {"master": self.master.cast_params(lp.get("master", {}),
                                                  dtype),
                "slave": self.slave.cast_params(lp.get("slave", {}), dtype)}

    def forward(self, params, state, inputs, ctx):
        sinks = {}
        outs = {}
        for role, layer in (("master", self.master), ("slave", self.slave)):
            sub = dataclasses.replace(ctx, state_sink={})
            outs[role] = layer.forward(params.get(role, {}),
                                       state.get(role, {}), inputs, sub)
            sinks[role] = sub.state_sink.get(layer.name,
                                             state.get(role, {}))
        if ctx.train and ctx.state_sink is not None:
            with torch.no_grad():
                diff = torch.stack(
                    [(a.float() - b.float()).abs().max()
                     for a, b in zip(outs["master"], outs["slave"])]).max()
            ctx.state_sink[self.name] = {"master": sinks["master"],
                                         "slave": sinks["slave"],
                                         "diff": diff}
        return outs["master"]


def _create_plugin_layer(spec: LayerSpec, global_cfg: ConfigPairs) -> Layer:
    """A user layer: ``plugin_module`` (an importable module) and
    ``plugin_layer`` (a subclass of this package's :class:`Layer` in it);
    every other key of the block reaches the class's ``set_param``. A
    JAX layer (``cxxnet_tpu.layers.Layer``) cannot serve the port."""
    mod_name = cls_name = None
    for k, v in spec.cfg:
        if k == "plugin_module":
            mod_name = v
        elif k == "plugin_layer":
            cls_name = v
    if not mod_name or not cls_name:
        raise ValueError(
            "plugin layer needs both plugin_module and plugin_layer")
    try:
        mod = importlib.import_module(mod_name)
    except ImportError as e:
        raise ValueError(
            f"plugin layer: cannot import module {mod_name!r} "
            "(is it on PYTHONPATH?)") from e
    cls = getattr(mod, cls_name, None)
    if cls is None or not (isinstance(cls, type) and issubclass(cls, Layer)):
        raise ValueError(
            f"plugin layer: {mod_name}.{cls_name} is not a "
            "cxxnet_tpu_torch.layers.Layer subclass (a layer of the JAX "
            "package cannot run in the PyTorch port)")
    return cls(spec, global_cfg)


def create_layer(spec: LayerSpec, global_cfg: ConfigPairs) -> Layer:
    """Build the layer object of ``spec``. ``share`` specs are resolved
    by the Network (the primary layer object is reused), so they never
    reach this factory."""
    if spec.type == "pairtest":
        return PairTestLayer(spec, global_cfg)
    if spec.type == "plugin":
        return _create_plugin_layer(spec, global_cfg)
    if spec.type not in LAYER_REGISTRY:
        raise ValueError(f"unknown layer type: {spec.type!r}")
    return LAYER_REGISTRY[spec.type](spec, global_cfg)


__all__ = ["Layer", "ApplyCtx", "LayerSpec", "create_layer",
           "LAYER_REGISTRY", "register_layer", "PairTestLayer"]
