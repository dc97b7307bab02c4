"""Convolution and pooling layers (the port of ``cxxnet_tpu/layers/conv.py``).

Convolution runs ``F.conv2d`` on an NCHW view of the NHWC node: the
permute is a view whose memory is channels_last, so no copy is made,
and the output is permuted back the same way. Weights are OIHW
``(cout, cin/group, kh, kw)`` in channels_last memory (the JAX package's
HWIO becomes OIHW in ``convert.params_from_jax``). A bias and a folded
relu go through the epilogue kernel. With int8 weights (a PTQ-derived
round) the conv is the int8 kernel's product over an int8 im2col with
the bias and relu in its epilogue (``ops/fused_quant.int8_conv``), its
weight laid out (cout, kh*kw*cin/group) at load. In training the conv is
differentiated by PyTorch autograd, as the JAX package left its
gradient to XLA.

Pooling keeps cxxnet's ceil-mode geometry exactly (``_pool_geometry``):
the node is padded explicitly, with ``-inf`` for max and 0 for sum, and
then pooled with no padding; avg divides by ``k*k`` counting padded
cells. Windows that tile the node or cover it whole go to the pooling
kernels (``ops/fused_pool.Pool``, forward and backward), as in the JAX
package; the other geometries are differentiated by autograd. ``F.max_pool2d`` /
``F.avg_pool2d`` with ``ceil_mode=True`` count windows and divide
differently, so they are never given padding here.

LRN (``lrn``) runs the LRN kernels (``ops/fused_lrn.Lrn``) when the
kernels are selected and take the node, else the JAX layer's own
arithmetic in the node's dtype.

Left out: the JAX package's space-to-depth stem rewrite and stem
channel padding, value-exact layout tricks for the TPU's matrix unit.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from ..ops.fused_lrn import lrn, lrn_takes
from ..ops.fused_quant import conv_weight_for_kernel, int8_conv
from ..ops.fused_pool import kernel_geometry, pool, scale_in_dtype
from .base import Layer, Params, Shape3, register_layer
from .core import bias_act, const_like


@register_layer("conv")
class ConvolutionLayer(Layer):
    """2-D convolution with groups; output spatial size
    floor((in + 2p - k)/stride) + 1."""
    has_params = True
    compute_leaves = ("wmat",)

    def infer_shapes(self, in_shapes: List[Shape3]) -> List[Shape3]:
        self.check_n(in_shapes, 1, 1)
        c, y, x = in_shapes[0]
        hp = self.hp
        if hp.num_channel <= 0:
            raise ValueError(f"conv {self.name!r}: nchannel must be set")
        if hp.kernel_height <= 0 or hp.kernel_width <= 0:
            raise ValueError(f"conv {self.name!r}: kernel_size must be set")
        if c % hp.num_group or hp.num_channel % hp.num_group:
            raise ValueError(f"conv {self.name!r}: channels must divide ngroup")
        if hp.kernel_height > y + 2 * hp.pad_y or \
                hp.kernel_width > x + 2 * hp.pad_x:
            raise ValueError(
                f"conv {self.name!r}: kernel size exceeds padded input")
        oy = (y + 2 * hp.pad_y - hp.kernel_height) // hp.stride + 1
        ox = (x + 2 * hp.pad_x - hp.kernel_width) // hp.stride + 1
        self._cin = c
        return [(hp.num_channel, oy, ox)]

    def init_params(self, generator, in_shapes) -> Params:
        hp = self.hp
        kh, kw = hp.kernel_height, hp.kernel_width
        cin_g = self._cin // hp.num_group
        fan_in = cin_g * kh * kw
        fan_out = (hp.num_channel // hp.num_group) * kh * kw
        params: Params = {"wmat": hp.init_weight(
            generator, (hp.num_channel, cin_g, kh, kw), fan_in, fan_out)}
        if not hp.no_bias:
            params["bias"] = torch.full((hp.num_channel,), hp.init_bias,
                                        device=generator.device)
        return params

    def quant_shapes(self):
        return {"wmat_scale": (self.hp.num_channel,), "act_scale": ()}

    def place_leaf(self, leaf, t):
        if leaf == "wmat" and t.dtype == torch.int8:
            return conv_weight_for_kernel(t)
        if leaf == "wmat":
            return t.contiguous(memory_format=torch.channels_last)
        return t

    def forward(self, params, state, inputs, ctx):
        hp = self.hp
        if "wmat_scale" in params:
            return [int8_conv(
                inputs[0], params["wmat"], params["wmat_scale"],
                params["act_scale"], params.get("bias"),
                ctx.fuse_act or "none",
                kernel=(hp.kernel_height, hp.kernel_width), stride=hp.stride,
                padding=(hp.pad_y, hp.pad_x), groups=hp.num_group,
                fused=ctx.fused)]
        x = inputs[0].to(ctx.compute_dtype)
        y = F.conv2d(x.permute(0, 3, 1, 2), params["wmat"],
                     stride=hp.stride, padding=(hp.pad_y, hp.pad_x),
                     groups=hp.num_group)
        y = y.permute(0, 2, 3, 1).contiguous()
        return [bias_act(y, params.get("bias"), ctx.fuse_act or "none",
                         ctx.fused)]


def _pool_geometry(size: int, k: int, s: int, p: int):
    """cxxnet's ceil-mode pooling geometry:
    out = min(size + 2p - k + s - 1, size + 2p - 1) // s + 1.
    Returns (out, extra): the trailing padding beyond ``p`` that makes an
    unpadded pool over the padded node yield ``out`` windows."""
    out = min(size + 2 * p - k + s - 1, size + 2 * p - 1) // s + 1
    needed = (out - 1) * s + k
    extra = max(0, needed - (size + 2 * p))
    return out, extra


def pool_padded_plain(x: torch.Tensor, kh: int, kw: int, stride: int,
                      pad, extra, reducer: str, scale_avg: bool,
                      pre_relu: bool) -> torch.Tensor:
    """Plain pooling of an NHWC node over any cxxnet geometry: pad
    ``pad`` before and ``pad + extra`` after on each spatial axis (with
    ``-inf`` for max, 0 for sum) and pool unpadded, as the JAX package's
    ``lax.reduce_window`` path does. A sum is taken in the node's dtype
    as XLA evaluates that reduce_window: the window's cells added one at
    a time in row-major order, each partial sum rounded to the dtype.
    For avg the sum is then multiplied by ``1/(kh*kw)`` rounded to the
    dtype."""
    if pre_relu:
        x = torch.relu(x)
    (py, px), (ey, ex) = pad, extra
    if py or px or ey or ex:
        fill = float("-inf") if reducer == "max" else 0.0
        x = F.pad(x, (0, 0, px, px + ex, py, py + ey), value=fill)
    if reducer == "max":
        y = F.max_pool2d(x.permute(0, 3, 1, 2), (kh, kw), stride=stride)
        return y.permute(0, 2, 3, 1).contiguous()
    oy = (x.shape[1] - kh) // stride + 1
    ox = (x.shape[2] - kw) // stride + 1
    y = None
    for dy in range(kh):
        for dx in range(kw):
            cell = x[:, dy:dy + (oy - 1) * stride + 1:stride,
                     dx:dx + (ox - 1) * stride + 1:stride, :]
            y = cell if y is None else y + cell
    if scale_avg and kh * kw != 1:
        y = (y.float() * scale_in_dtype(1.0 / (kh * kw), x.dtype)
             ).to(x.dtype)
    return y.contiguous()


class _PoolingLayer(Layer):
    """Max/avg/sum pooling with cxxnet's ceil-mode output shapes; avg
    divides by k*k including padded cells."""
    reducer = "max"          # max | sum
    scale_avg = False
    pre_relu = False         # relu_max_pooling

    def infer_shapes(self, in_shapes):
        self.check_n(in_shapes, 1, 1)
        c, y, x = in_shapes[0]
        hp = self.hp
        if hp.kernel_height <= 0 or hp.kernel_width <= 0:
            raise ValueError(f"{self.spec.type} {self.name!r}: must set kernel_size")
        if hp.kernel_height > y + 2 * hp.pad_y or \
                hp.kernel_width > x + 2 * hp.pad_x:
            raise ValueError(
                f"{self.spec.type} {self.name!r}: kernel exceeds padded input")
        oy, self._extra_y = _pool_geometry(y, hp.kernel_height, hp.stride, hp.pad_y)
        ox, self._extra_x = _pool_geometry(x, hp.kernel_width, hp.stride, hp.pad_x)
        return [(c, oy, ox)]

    def forward(self, params, state, inputs, ctx):
        hp = self.hp
        x = inputs[0]
        kh, kw = hp.kernel_height, hp.kernel_width
        pad, extra = (hp.pad_y, hp.pad_x), (self._extra_y, self._extra_x)
        if ctx.fused and kernel_geometry(x.shape[1], x.shape[2], kh, kw,
                                         hp.stride, pad, extra):
            return [pool(x, kh, kw, self.reducer, self.scale_avg,
                         self.pre_relu)]
        return [pool_padded_plain(x, kh, kw, hp.stride, pad, extra,
                                  self.reducer, self.scale_avg,
                                  self.pre_relu)]


@register_layer("max_pooling")
class MaxPoolingLayer(_PoolingLayer):
    reducer = "max"


@register_layer("sum_pooling")
class SumPoolingLayer(_PoolingLayer):
    reducer = "sum"


@register_layer("avg_pooling")
class AvgPoolingLayer(_PoolingLayer):
    reducer = "sum"
    scale_avg = True


@register_layer("relu_max_pooling", "insanity_max_pooling")
class ReluMaxPoolingLayer(_PoolingLayer):
    """Max pooling over relu'd inputs; also insanity_max_pooling, whose
    eval forward this is (its random cell pick is train-only)."""
    reducer = "max"
    pre_relu = True

    def forward(self, params, state, inputs, ctx):
        if ctx.train and self.spec.type == "insanity_max_pooling":
            raise NotImplementedError(
                f"insanity_max_pooling {self.name!r}: its training forward "
                "(a random cell pick) is not in the PyTorch port yet "
                "(ROADMAP Queue A 6, remaining layers)")
        return super().forward(params, state, inputs, ctx)


@register_layer("lrn")
class LRNLayer(Layer):
    """AlexNet's cross-channel local response normalization: ``y = x *
    (knorm + alpha/nsize * window_sum(x^2))^-beta`` over a centered
    channel window of ``local_size``. With the kernels selected and
    ``knorm > 0`` it is the LRN kernels' autograd function (f32 inside);
    otherwise the JAX layer's unfused arithmetic in the node's dtype:
    x^2, the padded shifted window sum, ``exp(-beta * log(norm))``."""

    def set_param(self, name, val):
        if name == "local_size":
            self.nsize = int(val)
        elif name == "alpha":
            self.alpha = float(val)
        elif name == "beta":
            self.beta = float(val)
        elif name == "knorm":
            self.knorm = float(val)

    def __init__(self, spec, global_cfg):
        self.nsize = 3
        self.alpha = 0.001
        self.beta = 0.75
        self.knorm = 1.0
        super().__init__(spec, global_cfg)

    def infer_shapes(self, in_shapes):
        self.check_n(in_shapes, 1, 1)
        return [in_shapes[0]]

    def forward(self, params, state, inputs, ctx):
        x = inputs[0]
        if ctx.fused and lrn_takes(x, self.knorm):
            return [lrn(x, self.nsize, self.alpha, self.beta, self.knorm)]
        half = self.nsize // 2
        padded = F.pad(x * x, (half, self.nsize - 1 - half))
        c = x.shape[-1]
        win = sum(padded[..., i:i + c] for i in range(self.nsize))
        ab = const_like(self.alpha / self.nsize, x)
        norm = const_like(self.knorm, x) + ab * win
        return [x * torch.exp(const_like(-self.beta, x) * torch.log(norm))]
