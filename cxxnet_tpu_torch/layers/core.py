"""Core (non-conv) layers: fullc, activations, flatten, dropout, split,
concat (the port of ``cxxnet_tpu/layers/core.py``). Their training
forwards are differentiated by PyTorch autograd; the fullc epilogue's
backward is the epilogue kernel's (``ops/fused_epilogue.BiasAct``)."""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from ..ops.fused_epilogue import bias_act as bias_act_fused
from ..ops.fused_epilogue import bias_act_plain
from .base import Layer, Params, Shape3, flat_size, is_flat, register_layer


def _flat2d(x: torch.Tensor) -> torch.Tensor:
    """View a (b,1,1,n) or NHWC node as (b, features) in (y, x, c) order."""
    return x.reshape(x.shape[0], -1)


def _as_node(x2d: torch.Tensor) -> torch.Tensor:
    """Lift (b, n) back to the flat node layout (b, 1, 1, n)."""
    return x2d.reshape(x2d.shape[0], 1, 1, x2d.shape[1])


def bias_act(x: torch.Tensor, bias, act: str, fused: bool) -> torch.Tensor:
    """The conv/fullc epilogue: the kernels' autograd function when
    ``fused``, else the plain version (differentiated by autograd);
    ``x`` unchanged when there is nothing to do."""
    if bias is None and act == "none":
        return x
    return (bias_act_fused if fused else bias_act_plain)(x, bias, act)


@register_layer("fullc")
class FullConnectLayer(Layer):
    """Fully-connected layer. Weight (in, out), forward ``x @ W``; the
    bias and a folded relu go through the epilogue."""
    has_params = True
    compute_leaves = ("wmat",)

    def infer_shapes(self, in_shapes: List[Shape3]) -> List[Shape3]:
        self.check_n(in_shapes, 1, 1)
        if self.hp.num_hidden <= 0:
            raise ValueError(f"fullc layer {self.name!r}: nhidden must be set")
        self._in_num = flat_size(in_shapes[0])
        return [(1, 1, self.hp.num_hidden)]

    def init_params(self, generator, in_shapes) -> Params:
        nh = self.hp.num_hidden
        params: Params = {"wmat": self.hp.init_weight(
            generator, (self._in_num, nh), self._in_num, nh)}
        if not self.hp.no_bias:
            params["bias"] = torch.full((nh,), self.hp.init_bias,
                                        device=generator.device)
        return params

    def forward(self, params, state, inputs, ctx):
        x = _flat2d(inputs[0]).to(ctx.compute_dtype)
        y = torch.matmul(x, params["wmat"])
        y = bias_act(y, params.get("bias"), ctx.fuse_act or "none", ctx.fused)
        return [_as_node(y)]


class _ActivationLayer(Layer):
    fn = staticmethod(lambda x: x)

    def infer_shapes(self, in_shapes):
        self.check_n(in_shapes, 1, 1)
        return [in_shapes[0]]

    def forward(self, params, state, inputs, ctx):
        return [self.fn(inputs[0])]


@register_layer("relu")
class ReluLayer(_ActivationLayer):
    fn = staticmethod(torch.relu)


@register_layer("sigmoid")
class SigmoidLayer(_ActivationLayer):
    fn = staticmethod(torch.sigmoid)


@register_layer("tanh")
class TanhLayer(_ActivationLayer):
    fn = staticmethod(torch.tanh)


@register_layer("softplus")
class SoftplusLayer(_ActivationLayer):
    fn = staticmethod(F.softplus)


@register_layer("flatten")
class FlattenLayer(Layer):
    """Reshape to a flat node; feature order (y, x, c) as in the JAX
    package (the cxxnet reference's NCHW flatten orders (c, y, x))."""

    def infer_shapes(self, in_shapes):
        self.check_n(in_shapes, 1, 1)
        return [(1, 1, flat_size(in_shapes[0]))]

    def forward(self, params, state, inputs, ctx):
        return [_as_node(_flat2d(inputs[0]))]


@register_layer("dropout")
class DropoutLayer(Layer):
    """Inverted dropout: identity at eval and at ``threshold = 0``; its
    training mode is not ported yet."""

    def set_param(self, name, val):
        if name == "threshold":
            self.threshold = float(val)

    def __init__(self, spec, global_cfg):
        self.threshold = 0.0
        super().__init__(spec, global_cfg)
        if not (0.0 <= self.threshold < 1.0):
            raise ValueError("dropout: invalid threshold")

    def infer_shapes(self, in_shapes):
        self.check_n(in_shapes, 1, 1)
        return [in_shapes[0]]

    def forward(self, params, state, inputs, ctx):
        if ctx.train and self.threshold > 0.0:
            raise NotImplementedError(
                f"dropout {self.name!r}: its training mode is not in the "
                "PyTorch port yet (ROADMAP Queue A 6, remaining layers)")
        return [inputs[0]]


@register_layer("split")
class SplitLayer(Layer):
    """1 -> N fan-out."""

    def infer_shapes(self, in_shapes):
        if len(in_shapes) != 1:
            raise ValueError("split: exactly one input")
        return [in_shapes[0]] * len(self.spec.nindex_out)

    def forward(self, params, state, inputs, ctx):
        return [inputs[0]] * len(self.spec.nindex_out)


class _ConcatBase(Layer):
    """Concatenate along the channel/feature axis (the last in NHWC);
    ``concat`` of non-flat nodes is rejected as in the JAX package."""
    channel_concat = True

    def infer_shapes(self, in_shapes):
        if len(in_shapes) < 2 or len(in_shapes) > 4:
            raise ValueError(f"{self.spec.type}: supports 2..4 inputs")
        base = in_shapes[0]
        if not self.channel_concat:
            for s in in_shapes:
                if not is_flat(s):
                    raise ValueError(
                        "concat of non-flat nodes is not supported; use "
                        "ch_concat for channel concatenation")
            return [(1, 1, sum(s[2] for s in in_shapes))]
        for s in in_shapes:
            if s[1:] != base[1:]:
                raise ValueError("ch_concat: spatial dims must match")
        return [(sum(s[0] for s in in_shapes), base[1], base[2])]

    def forward(self, params, state, inputs, ctx):
        return [torch.cat(inputs, dim=-1)]


@register_layer("concat")
class ConcatLayer(_ConcatBase):
    channel_concat = False


@register_layer("ch_concat")
class ChConcatLayer(_ConcatBase):
    channel_concat = True
