"""Sequence / transformer layers: embed, layernorm, posembed, mha, ffn,
seqfc, add, lmloss (the port of ``cxxnet_tpu/layers/seq.py``).

Node convention for sequences, as in the JAX package: logical shape
``(E, S, 1)`` -> tensor ``(batch, S, 1, E)`` (tokens on the y axis,
features on the channel axis). Token-id inputs are flat nodes
``(1, 1, S)`` holding the ids as floats.

Each layer casts its f32 masters to the compute dtype inside its forward,
where the JAX layer casts them, so autograd carries the gradients back to
the masters in f32. ``mha`` and ``ffn`` keep their projections one level
deeper in the parameter tree (``{"q"|"k"|"v"|"o": {"wmat", "bias"}}``,
``{"h"|"o": {...}}``), the JAX package's layout. Left out: the sequence-
and pipeline-parallel attention (``seq_parallel`` and
``pipeline_parallel`` raise naming ROADMAP Queue A 9). ``seqfc`` with
int8 weights (a PTQ-derived round) runs the int8 product of
``ops/fused_quant``.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from ..ops.attention import (attention_reference, chunked_attention,
                             flash_attention, rope)
from ..ops.fused_quant import fullc_weight_for_kernel, int8_matmul
from .base import Layer, Shape3, register_layer
from .loss import LossLayerBase


def _seq(x: torch.Tensor) -> torch.Tensor:
    """(b, S, 1, E) -> (b, S, E)."""
    return x.reshape(x.shape[0], x.shape[1], x.shape[3])


def _unseq(x: torch.Tensor) -> torch.Tensor:
    """(b, S, E) -> (b, S, 1, E)."""
    return x.reshape(x.shape[0], x.shape[1], 1, x.shape[2])


def _linear(x: torch.Tensor, p, eq: str, dtype: torch.dtype) -> torch.Tensor:
    """``einsum(eq, x, wmat) + bias`` with the leaves cast to ``dtype``."""
    y = torch.einsum(eq, x, p["wmat"].to(dtype))
    if "bias" in p:
        y = y + p["bias"].to(dtype)
    return y


@register_layer("embed")
class EmbedLayer(Layer):
    """Token embedding: flat id node (1,1,S) -> sequence node (E,S,1).
    ``nhidden`` = embedding dim, ``vocab_size`` = table rows. The rows
    are gathered from the table cast to the compute dtype, as in the JAX
    package, so a bf16 table's gradient is scattered and added in bf16."""
    has_params = True

    def set_param(self, name, val):
        if name == "vocab_size":
            self.vocab_size = int(val)

    def __init__(self, spec, global_cfg):
        self.vocab_size = 0
        super().__init__(spec, global_cfg)
        if self.vocab_size <= 0:
            raise ValueError(f"embed layer {spec.name!r} needs vocab_size")

    def infer_shapes(self, in_shapes: List[Shape3]) -> List[Shape3]:
        self.check_n(in_shapes, 1, 1)
        c, y, S = in_shapes[0]
        if c != 1 or y != 1:
            raise ValueError("embed expects a flat (1,1,S) token-id node")
        return [(self.hp.num_hidden, S, 1)]

    def init_params(self, generator, in_shapes):
        return {"wmat": self.hp.init_weight(
            generator, (self.vocab_size, self.hp.num_hidden),
            self.vocab_size, self.hp.num_hidden)}

    def forward(self, params, state, inputs, ctx):
        x = inputs[0]
        ids = x.reshape(x.shape[0], -1).long()
        out = F.embedding(ids, params["wmat"].to(ctx.compute_dtype))
        return [_unseq(out)]


@register_layer("layernorm")
class LayerNormLayer(Layer):
    """LayerNorm over the feature axis of a sequence node, in f32 (the
    JAX layer's arithmetic, not ``F.layer_norm``'s). Its ``gamma`` and
    ``beta`` fall in the optimizer's ``bias`` group."""
    has_params = True

    def set_param(self, name, val):
        if name == "eps":
            self.eps = float(val)

    def __init__(self, spec, global_cfg):
        self.eps = 1e-5
        super().__init__(spec, global_cfg)

    def infer_shapes(self, in_shapes):
        self.check_n(in_shapes, 1, 1)
        return [in_shapes[0]]

    def init_params(self, generator, in_shapes):
        e = in_shapes[0][0]
        dev = generator.device
        return {"gamma": torch.ones((e,), device=dev),
                "beta": torch.zeros((e,), device=dev)}

    def forward(self, params, state, inputs, ctx):
        x = inputs[0].float()
        mu = x.mean(dim=-1, keepdim=True)
        var = torch.square(x - mu).mean(dim=-1, keepdim=True)
        y = (x - mu) * torch.rsqrt(var + self.eps)
        y = y * params["gamma"] + params["beta"]
        return [y.to(ctx.compute_dtype)]


@register_layer("posembed")
class PosEmbedLayer(Layer):
    """Learned absolute position embedding added to a sequence node
    (E,S,1) -> (E,S,1); the alternative to ``rope = 1`` on mha."""
    has_params = True

    def infer_shapes(self, in_shapes):
        self.check_n(in_shapes, 1, 1)
        return [in_shapes[0]]

    def init_params(self, generator, in_shapes):
        e, s, _ = in_shapes[0]
        return {"wmat": self.hp.init_sigma * torch.randn(
            (s, e), generator=generator, device=generator.device)}

    def forward(self, params, state, inputs, ctx):
        x = inputs[0]
        pe = params["wmat"].to(ctx.compute_dtype)
        return [x + pe.reshape(1, x.shape[1], 1, pe.shape[1])]


class _SeqLinearMixin:
    """Init of (in_dim -> out_dim) projections on sequence nodes."""

    def _linear_params(self, generator, in_dim, out_dim, no_bias):
        p = {"wmat": self.hp.init_weight(generator, (in_dim, out_dim),
                                         in_dim, out_dim)}
        if not no_bias:
            p["bias"] = torch.full((out_dim,), self.hp.init_bias,
                                   device=generator.device)
        return p


@register_layer("mha")
class MultiHeadAttentionLayer(Layer, _SeqLinearMixin):
    """Multi-head self-attention on a sequence node (E,S,1) -> (E,S,1).

    Config: ``nhead``, ``causal`` (0/1), ``rope`` / ``rope_theta``,
    ``attn_impl`` in {auto, ref, chunked, flash}, ``attn_block``. Under
    ``auto`` (the JAX package's dispatch, with the card in the TPU's
    place): a CUDA tensor whose sequence length ``attn_block`` divides
    takes :func:`flash_attention` (its kernels, or with ``fused_kernels =
    0`` their plain versions); otherwise sequences up to 512 take the
    reference attention and longer ones the chunked attention. ``ref``,
    ``chunked`` and ``flash`` force their choice."""
    has_params = True

    def set_param(self, name, val):
        if name == "nhead":
            self.nhead = int(val)
        elif name == "causal":
            self.causal = bool(int(val))
        elif name == "attn_impl":
            if val not in ("auto", "ref", "chunked", "flash"):
                raise ValueError(f"unknown attn_impl {val!r}")
            self.attn_impl = val
        elif name == "attn_block":
            self.attn_block = int(val)
        elif name == "rope":
            self.rope = bool(int(val))
        elif name == "rope_theta":
            self.rope_theta = float(val)

    def __init__(self, spec, global_cfg):
        self.nhead = 8
        self.causal = False
        self.attn_impl = "auto"
        self.attn_block = 128
        self.rope = False
        self.rope_theta = 10000.0
        super().__init__(spec, global_cfg)

    def infer_shapes(self, in_shapes):
        self.check_n(in_shapes, 1, 1)
        e, s, _ = in_shapes[0]
        if e % self.nhead:
            raise ValueError(
                f"mha {self.name!r}: dim {e} not divisible by nhead "
                f"{self.nhead}")
        return [in_shapes[0]]

    def init_params(self, generator, in_shapes):
        e = in_shapes[0][0]
        h, d = self.nhead, e // self.nhead
        p = {}
        for nm in ("q", "k", "v"):
            sub = self._linear_params(generator, e, e, self.hp.no_bias)
            sub["wmat"] = sub["wmat"].reshape(e, h, d)
            if "bias" in sub:
                sub["bias"] = sub["bias"].reshape(h, d)
            p[nm] = sub
        out = self._linear_params(generator, e, e, self.hp.no_bias)
        out["wmat"] = out["wmat"].reshape(h, d, e)
        p["o"] = out
        return p

    def attend_impl(self, q: torch.Tensor) -> str:
        """The attention this layer takes for ``q`` (B, S, H, D)."""
        if self.attn_impl != "auto":
            return self.attn_impl
        S = q.shape[1]
        if q.is_cuda and S % self.attn_block == 0:
            return "flash"
        return "ref" if S <= 512 else "chunked"

    def _attend(self, q, k, v, ctx):
        impl = self.attend_impl(q)
        if impl == "ref":
            return attention_reference(q, k, v, causal=self.causal)
        if impl == "chunked":
            return chunked_attention(q, k, v, causal=self.causal,
                                     block_k=self.attn_block)
        return flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=self.causal,
                               fused=ctx.fused)

    def forward(self, params, state, inputs, ctx):
        cdt = ctx.compute_dtype
        x = _seq(inputs[0]).to(cdt)
        q, k, v = (_linear(x, params[nm], "bse,ehd->bshd", cdt)
                   for nm in ("q", "k", "v"))
        if self.rope:
            q, k = rope(q, self.rope_theta), rope(k, self.rope_theta)
        o = self._attend(q, k, v, ctx)
        return [_unseq(_linear(o, params["o"], "bshd,hde->bse", cdt))]


@register_layer("ffn")
class FFNLayer(Layer, _SeqLinearMixin):
    """Position-wise feed-forward (E,S,1) -> (E,S,1); ``nhidden`` = inner
    dim (default 4E), ``act`` in {gelu, relu}. gelu is the tanh
    approximation, ``jax.nn.gelu``'s default."""
    has_params = True

    def set_param(self, name, val):
        if name == "act":
            if val not in ("gelu", "relu"):
                raise ValueError(f"unknown ffn act {val!r}")
            self.act = val

    def __init__(self, spec, global_cfg):
        self.act = "gelu"
        super().__init__(spec, global_cfg)

    def infer_shapes(self, in_shapes):
        self.check_n(in_shapes, 1, 1)
        return [in_shapes[0]]

    def init_params(self, generator, in_shapes):
        e = in_shapes[0][0]
        f = self.hp.num_hidden or 4 * e
        return {"h": self._linear_params(generator, e, f, self.hp.no_bias),
                "o": self._linear_params(generator, f, e, self.hp.no_bias)}

    def forward(self, params, state, inputs, ctx):
        cdt = ctx.compute_dtype
        x = _seq(inputs[0]).to(cdt)
        h = _linear(x, params["h"], "bse,ef->bsf", cdt)
        h = F.gelu(h, approximate="tanh") if self.act == "gelu" \
            else torch.relu(h)
        return [_unseq(_linear(h, params["o"], "bsf,fe->bse", cdt))]


@register_layer("seqfc")
class SeqFCLayer(Layer, _SeqLinearMixin):
    """Per-position linear projection (E,S,1) -> (K,S,1), e.g. the LM
    head; ``nhidden`` = K."""
    has_params = True

    def infer_shapes(self, in_shapes):
        self.check_n(in_shapes, 1, 1)
        e, s, _ = in_shapes[0]
        return [(self.hp.num_hidden, s, 1)]

    def init_params(self, generator, in_shapes):
        e = in_shapes[0][0]
        return self._linear_params(generator, e, self.hp.num_hidden,
                                   self.hp.no_bias)

    def quant_shapes(self):
        return {"wmat_scale": (self.hp.num_hidden,), "act_scale": ()}

    def place_leaf(self, leaf, t):
        if leaf == "wmat" and t.dtype == torch.int8:
            return fullc_weight_for_kernel(t)
        return t

    def forward(self, params, state, inputs, ctx):
        if "wmat_scale" in params:
            # int8 weights (a PTQ-derived round): positions fold into
            # rows, one int8 product with the fused dequant/bias epilogue
            x = _seq(inputs[0])
            b, s, e = x.shape
            y = int8_matmul(x.reshape(b * s, e), params["wmat"],
                            params["wmat_scale"], params["act_scale"],
                            params.get("bias"), "none", fused=ctx.fused)
            return [_unseq(y.reshape(b, s, -1))]
        cdt = ctx.compute_dtype
        x = _seq(inputs[0]).to(cdt)
        return [_unseq(_linear(x, params, "bse,ek->bsk", cdt))]


@register_layer("add")
class AddLayer(Layer):
    """Elementwise sum of N same-shape nodes (residual connections):
    ``layer[x,fx->y] = add``."""

    def infer_shapes(self, in_shapes):
        if len(in_shapes) < 2 or len(self.spec.nindex_out) != 1:
            raise ValueError(
                f"add layer {self.name!r} needs >=2 inputs, 1 output")
        for s in in_shapes[1:]:
            if s != in_shapes[0]:
                raise ValueError(
                    f"add layer {self.name!r}: shape mismatch {in_shapes}")
        return [in_shapes[0]]

    def forward(self, params, state, inputs, ctx):
        out = inputs[0]
        for x in inputs[1:]:
            out = out + x
        return [out]


@register_layer("lmloss")
class LMLossLayer(LossLayerBase):
    """Per-token softmax cross-entropy: logits node (V,S,1) against a
    label slice of width S (token ids). The node holds per-token f32
    log-probabilities; the loss is the masked mean over examples of the
    mean NLL over tokens."""

    def forward(self, params, state, inputs, ctx):
        return [torch.log_softmax(inputs[0].float(), dim=-1)]

    def loss(self, outputs, label, mask, batch=None):
        logp_all = outputs[0]                      # (b, S, 1, V)
        b, S = logp_all.shape[0], logp_all.shape[1]
        lp2 = logp_all.reshape(b, S, -1)
        idx = label.long()                         # (b, S)
        logp = torch.gather(lp2, 2, idx[:, :, None])[:, :, 0]
        return self._mean(-logp.mean(dim=1), mask, batch)
