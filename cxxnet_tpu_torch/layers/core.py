"""Core (non-conv) layers: fullc, activations (xelu and the randomized
insanity among them), flatten, dropout, split, concat, bias, prelu,
fixconn and maxout (the port of ``cxxnet_tpu/layers/core.py``). Their training forwards are
differentiated by PyTorch autograd; the fullc epilogue's backward is the
epilogue kernel's (``ops/fused_epilogue.BiasAct``).

Arithmetic with a constant runs in the node's dtype, as JAX's weakly
typed Python floats do: the constant is rounded to the dtype and held in
a 0-dim tensor on the node's device (:func:`const_like`), so a division
stays a division on the card (PyTorch turns a division by a Python
scalar there into a product with its reciprocal)."""

from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.fused_epilogue import bias_act as bias_act_fused
from ..ops.fused_epilogue import bias_act_plain
from ..ops.fused_quant import fullc_weight_for_kernel, int8_matmul
from .base import Layer, Params, Shape3, flat_size, is_flat, register_layer


def _flat2d(x: torch.Tensor) -> torch.Tensor:
    """View a (b,1,1,n) or NHWC node as (b, features) in (y, x, c) order."""
    return x.reshape(x.shape[0], -1)


def _as_node(x2d: torch.Tensor) -> torch.Tensor:
    """Lift (b, n) back to the flat node layout (b, 1, 1, n)."""
    return x2d.reshape(x2d.shape[0], 1, 1, x2d.shape[1])


def const_like(v, like: torch.Tensor) -> torch.Tensor:
    """``v`` as a 0-dim tensor of ``like``'s dtype and device."""
    return torch.full((), v, dtype=like.dtype, device=like.device)


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
    bias and a folded relu go through the epilogue. With int8 weights
    (a PTQ-derived round: ``wmat_scale`` present) the product and its
    epilogue are the int8 kernel's (``ops/fused_quant``), output f32."""
    has_params = True
    compute_leaves = ("wmat",)

    def quant_shapes(self):
        return {"wmat_scale": (self.hp.num_hidden,), "act_scale": ()}

    def place_leaf(self, leaf, t):
        if leaf == "wmat" and t.dtype == torch.int8:
            return fullc_weight_for_kernel(t)
        return t

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
        if "wmat_scale" in params:
            y = int8_matmul(_flat2d(inputs[0]), params["wmat"],
                            params["wmat_scale"], params["act_scale"],
                            params.get("bias"), ctx.fuse_act or "none",
                            fused=ctx.fused)
            return [_as_node(y)]
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


def _xelu(x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """op::xelu: ``x > 0 ? x : x / b``."""
    return torch.where(x > 0, x, x / b)


@register_layer("xelu")
class XeluLayer(_ActivationLayer):
    """Leaky relu with divisor slope ``b`` (default 5)."""

    def set_param(self, name, val):
        if name == "b":
            self.b = float(val)

    def __init__(self, spec, global_cfg):
        self.b = 5.0
        super().__init__(spec, global_cfg)

    def forward(self, params, state, inputs, ctx):
        x = inputs[0]
        return [_xelu(x, const_like(self.b, x))]


@register_layer("insanity", "rrelu")
class InsanityLayer(_ActivationLayer):
    """Randomized leaky relu. Training: per-element divisor slopes drawn
    U[lb, ub) in the node's dtype (``ctx.draws``) and the int32 ``step``
    state advanced by one; eval: the slope ``(ub - lb) / (log ub - log
    lb)`` in float32 (``(lb + ub) / 2`` when ``lb == ub``), rounded to
    the dtype. ``calm_start``/``calm_end`` move (lb, ub) linearly toward
    their midpoint over those updates, as the JAX package does; its
    float32 bounds then make a training output float32, as JAX's type
    promotion does. The pipeline's once-per-step state tick waits for
    model parallelism (ROADMAP Queue A 9)."""
    has_state = True

    def set_param(self, name, val):
        if name == "lb":
            self.lb = float(val)
        elif name == "ub":
            self.ub = float(val)
        elif name == "calm_start":
            self.calm_start = int(val)
        elif name == "calm_end":
            self.calm_end = int(val)

    def __init__(self, spec, global_cfg):
        self.lb, self.ub = 5.0, 10.0
        self.calm_start = self.calm_end = 0
        super().__init__(spec, global_cfg)

    def init_state(self, in_shapes):
        return {"step": torch.zeros((), dtype=torch.int32)}

    @property
    def annealing(self) -> bool:
        return self.calm_end > self.calm_start

    def _bounds(self, step: torch.Tensor):
        """(lb, ub) at ``step``: Python floats, or float32 0-dim tensors
        while annealing."""
        if not self.annealing:
            return self.lb, self.ub
        mid = 0.5 * (self.lb + self.ub)
        t = ((step - self.calm_start).float()
             / float(self.calm_end - self.calm_start)).clamp(0.0, 1.0)
        return self.lb + t * (mid - self.lb), self.ub + t * (mid - self.ub)

    def forward(self, params, state, inputs, ctx):
        x = inputs[0]
        step = state["step"]
        lb, ub = self._bounds(step)
        if ctx.train:
            u = ctx.draw_source(self.name).uniform(x.shape, x.dtype)
            if self.annealing:
                x, slope = x.float(), u.float() * (ub - lb) + lb
            else:
                slope = u * const_like(ub - lb, x) + const_like(lb, x)
            if ctx.state_sink is not None:
                ctx.state_sink[self.name] = {"step": step + 1}
            return [_xelu(x, slope)]
        f32 = torch.float32
        lb_, ub_ = (torch.as_tensor(v, dtype=f32).to(x.device)
                    for v in (lb, ub))
        denom = torch.log(ub_) - torch.log(lb_)
        slope = torch.where(denom < 1e-8, 0.5 * (lb_ + ub_),
                            (ub_ - lb_) / denom.clamp_min(1e-8))
        return [_xelu(x, slope.to(x.dtype))]


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
    """Inverted dropout, ``threshold`` the drop probability: identity at
    eval and at ``threshold = 0``; in training a keep mask Bernoulli(1 -
    threshold) from ``ctx.draws`` and ``where(mask, x / pkeep, 0)``, the
    division in the node's dtype."""

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
        x = inputs[0]
        if not ctx.train or self.threshold == 0.0:
            return [x]
        pkeep = 1.0 - self.threshold
        mask = ctx.draw_source(self.name).keep_mask(x.shape, pkeep)
        return [torch.where(mask, x / const_like(pkeep, x),
                            const_like(0.0, x))]


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


@register_layer("bias")
class BiasLayer(Layer):
    """Per-feature additive bias of a flat node (its ``bias`` leaf f32,
    so a bf16 node comes out f32, as JAX's type promotion gives)."""
    has_params = True

    def infer_shapes(self, in_shapes):
        self.check_n(in_shapes, 1, 1)
        if not is_flat(in_shapes[0]):
            raise ValueError("bias layer requires a flat input node")
        self._n = in_shapes[0][2]
        return [in_shapes[0]]

    def init_params(self, generator, in_shapes):
        return {"bias": torch.full((self._n,), self.hp.init_bias,
                                   device=generator.device)}

    def forward(self, params, state, inputs, ctx):
        return [inputs[0] + params["bias"]]


@register_layer("prelu")
class PReluLayer(Layer):
    """Learnable per-channel negative slope, kept under ``bias`` (so it
    takes the bias group's lr and wd), clipped to [0, 1]: ``where(x > 0,
    x, x * slope)``. With ``random = r`` a training forward multiplies
    the slope by ``1 + 2 r u - r``, ``u`` uniform of the node's shape and
    dtype from ``ctx.draws``. The f32 slope makes a bf16 node f32, as in
    the JAX package."""
    has_params = True

    def set_param(self, name, val):
        if name == "init_slope":
            self.init_slope = float(val)
        elif name == "random_slope":
            self.init_random = int(val)
        elif name == "random":
            self.random_noise = float(val)

    def __init__(self, spec, global_cfg):
        self.init_slope = 0.25
        self.init_random = 0
        self.random_noise = 0.0
        super().__init__(spec, global_cfg)

    def infer_shapes(self, in_shapes):
        self.check_n(in_shapes, 1, 1)
        s = in_shapes[0]
        self._channel = s[2] if is_flat(s) else s[0]
        return [s]

    def init_params(self, generator, in_shapes):
        dev = generator.device
        if self.init_random:
            slope = torch.rand((self._channel,), generator=generator,
                               device=dev) * self.init_slope
        else:
            slope = torch.full((self._channel,), self.init_slope, device=dev)
        return {"bias": slope}

    def forward(self, params, state, inputs, ctx):
        x = inputs[0]
        slope = params["bias"]
        if ctx.train and self.random_noise > 0:
            r = self.random_noise
            u = ctx.draw_source(self.name).uniform(x.shape, x.dtype)
            mask = slope * (const_like(1.0, u) + u * const_like(r, u)
                            * const_like(2.0, u) - const_like(r, u))
        else:
            mask = slope.expand(x.shape)
        mask = mask.clamp(0.0, 1.0)
        return [torch.where(x > 0, x, x * mask)]


@register_layer("fixconn")
class FixConnectLayer(Layer):
    """A fixed (not learned) connection matrix read from ``weight_file``
    at shape inference: ``rows cols`` then the row-major entries,
    whitespace separated (or a plain 2-D text table). The matrix is a
    buffer of the layer, copied to a node's device at its first use;
    ``y = x @ W`` in float32 at least (a bf16 node comes out f32, as
    JAX's promotion of the dot gives)."""

    def set_param(self, name, val):
        if name == "weight_file":
            self.weight_file = val

    def __init__(self, spec, global_cfg):
        self.weight_file = ""
        self._on: dict = {}
        super().__init__(spec, global_cfg)

    def infer_shapes(self, in_shapes):
        import io as _io
        from ..io.stream import read_bytes
        self.check_n(in_shapes, 1, 1)
        if not self.weight_file:
            raise ValueError("fixconn: weight_file must be set")
        data = np.loadtxt(_io.BytesIO(read_bytes(self.weight_file)),
                          dtype=np.float32)
        if data.ndim == 1:
            rows, cols = int(data[0]), int(data[1])
            data = data[2:].reshape(rows, cols)
        self._wmat = np.ascontiguousarray(data)
        self._on = {}
        if flat_size(in_shapes[0]) != self._wmat.shape[0]:
            raise ValueError(
                f"fixconn: input size {flat_size(in_shapes[0])} does not "
                f"match weight rows {self._wmat.shape[0]}")
        return [(1, 1, int(self._wmat.shape[1]))]

    def forward(self, params, state, inputs, ctx):
        x = _flat2d(inputs[0])
        w = self._on.get(x.device)
        if w is None:
            w = self._on[x.device] = torch.from_numpy(self._wmat).to(
                x.device)
        dt = torch.promote_types(x.dtype, torch.float32)
        return [_as_node(torch.matmul(x.to(dt), w.to(dt)))]


@register_layer("maxout")
class MaxoutLayer(Layer):
    """Maxout: the channels (conv nodes, NHWC) or features (flat nodes)
    split into groups of ``num_piece`` consecutive ones, the output the
    max of each group. The backward shares a tie's gradient evenly among
    the tied elements, as JAX's max does."""

    def set_param(self, name, val):
        if name == "num_piece":
            self.num_piece = int(val)

    def __init__(self, spec, global_cfg):
        self.num_piece = 2
        super().__init__(spec, global_cfg)

    def infer_shapes(self, in_shapes):
        self.check_n(in_shapes, 1, 1)
        c, y, x = in_shapes[0]
        feat = x if is_flat(in_shapes[0]) else c
        if self.num_piece < 1 or feat % self.num_piece:
            raise ValueError(
                f"maxout: channel/feature count {feat} not divisible by "
                f"num_piece {self.num_piece}")
        if is_flat(in_shapes[0]):
            return [(1, 1, x // self.num_piece)]
        return [(c // self.num_piece, y, x)]

    def forward(self, params, state, inputs, ctx):
        x = inputs[0]
        k = self.num_piece
        return [torch.amax(x.reshape(x.shape[:-1] + (x.shape[-1] // k, k)),
                           dim=-1)]
