"""Mixture-of-experts layer (the port of ``cxxnet_tpu/layers/moe.py``).

A token-choice top-k routed expert FFN in the GShard/Switch form over a
sequence node ``(E, S, 1)``: a router ``(E, X)`` in float32, softmax
gates, top-1 (``topk = 1``) or top-2 choices, a fixed capacity of
``C = int(T / X * capacity_factor * topk)`` slots an expert per
sequence (tokens past it are dropped), dense one-hot dispatch and
combine tensors ``(B, T, X, C)``, the expert FFN ``h`` (``E -> nhidden``,
gelu (tanh) or relu) and ``o`` (``nhidden -> E``) with a leading expert
axis, all as plain ``torch.einsum`` products, which the JAX package
leaves to XLA too. ``no_drop = 1`` runs every expert on every token and
keeps the chosen ones' gated outputs (no capacity).

The GShard load-balance loss ``moe_loss_coef * X * sum(frac * mean_gate)``
(``frac`` the share of tokens whose first choice is each expert,
``mean_gate`` the mean gate) is written to the layer state under
``_aux_loss`` (``ctx.state_sink``), which ``Network.apply`` adds to the
training objective. Under data parallelism (``ctx.dp``) ``frac`` and
``mean_gate`` are the global batch's means: :class:`AllReduceMean`
averages them over the ranks in the forward and its backward averages
their gradients the same way, as the JAX package's ``pmean`` over the
data axis does, and the Network adds ``aux / world`` on each rank (the
trainer sums losses and gradients over the ranks), so the update is the
single-device update over the global batch.

Left out: expert parallelism (``model_parallel > 1`` raises naming ROADMAP
Queue A 9) and the sequence-parallel routing.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .base import Layer, register_layer
from .seq import _seq, _unseq


class AllReduceMean(torch.autograd.Function):
    """The mean of a tensor over the ranks of ``dp`` (a
    ``parallel.DpContext``); its backward is the mean of the gradients
    over the ranks (the gradient of the global mean)."""

    @staticmethod
    def forward(ctx, t, dp):
        ctx.dp = dp
        out = t.detach().clone()
        dp.all_reduce(out)
        return out / dp.world

    @staticmethod
    def backward(ctx, g):
        g = g.detach().clone()
        ctx.dp.all_reduce(g)
        return g / ctx.dp.world, None


def _act(h: torch.Tensor, act: str) -> torch.Tensor:
    return F.gelu(h, approximate="tanh") if act == "gelu" else torch.relu(h)


@register_layer("moe")
class MoELayer(Layer):
    """Routed expert FFN. Params ``router/wmat (E, X)``, ``h/wmat (X, E,
    F)``, ``h/bias (X, F)``, ``o/wmat (X, F, E)``, ``o/bias (X, E)``
    (``F = nhidden``, default 4E); state ``_aux_loss`` ()."""
    has_params = True
    has_state = True

    def set_param(self, name, val):
        if name == "num_expert":
            self.num_expert = int(val)
        elif name == "topk":
            self.topk = int(val)
        elif name == "capacity_factor":
            self.capacity_factor = float(val)
        elif name == "act":
            if val not in ("gelu", "relu"):
                raise ValueError(f"unknown moe act {val!r}")
            self.act = val
        elif name == "moe_loss_coef":
            self.moe_loss_coef = float(val)
        elif name == "no_drop":
            self.no_drop = int(val)

    def __init__(self, spec, global_cfg):
        self.num_expert = 8
        self.topk = 2
        self.capacity_factor = 1.25
        self.act = "gelu"
        self.moe_loss_coef = 0.01
        self.no_drop = 0
        super().__init__(spec, global_cfg)
        if self.topk not in (1, 2):
            raise ValueError("moe: topk must be 1 or 2")

    def infer_shapes(self, in_shapes):
        self.check_n(in_shapes, 1, 1)
        return [in_shapes[0]]

    def init_params(self, generator, in_shapes):
        e = in_shapes[0][0]
        f = self.hp.num_hidden or 4 * e
        x = self.num_expert
        dev = generator.device
        return {
            "router": {"wmat": self.hp.init_weight(generator, (e, x), e, x)},
            "h": {"wmat": self.hp.init_weight(generator, (x, e, f), e, f),
                  "bias": torch.zeros((x, f), device=dev)},
            "o": {"wmat": self.hp.init_weight(generator, (x, f, e), f, e),
                  "bias": torch.zeros((x, e), device=dev)},
        }

    def init_state(self, in_shapes):
        return {"_aux_loss": torch.zeros((), dtype=torch.float32)}

    def route(self, x: torch.Tensor, router: torch.Tensor, dp=None):
        """Gates ``(B, T, X)`` f32, the choices ``[(one_hot, gate), ...]``
        and the load-balance loss of ``x`` (B, T, E)."""
        X = self.num_expert
        logits = torch.einsum("bte,ex->btx", x.float(), router.float())
        gates = torch.softmax(logits, dim=-1)

        def choose(residual):
            idx = torch.argmax(residual, dim=-1)
            return F.one_hot(idx, X).float(), idx

        oh1, idx1 = choose(gates)
        sel = [(oh1, torch.gather(gates, -1, idx1[..., None])[..., 0])]
        if self.topk == 2:
            oh2, idx2 = choose(gates - gates * oh1 - oh1)
            sel.append((oh2, torch.gather(gates, -1, idx2[..., None])[..., 0]))
        frac = oh1.mean(dim=(0, 1))
        mean_gate = gates.mean(dim=(0, 1))
        if dp is not None and dp.world > 1:
            frac = AllReduceMean.apply(frac, dp)
            mean_gate = AllReduceMean.apply(mean_gate, dp)
        aux = self.moe_loss_coef * X * torch.sum(frac * mean_gate)
        return gates, sel, aux

    def forward(self, params, state, inputs, ctx):
        cdt = ctx.compute_dtype
        x = _seq(inputs[0]).to(cdt)                      # (B, T, E)
        B, T, E = x.shape
        X = self.num_expert
        C = max(1, int(T / X * self.capacity_factor * self.topk))
        _, sel, aux = self.route(x, params["router"]["wmat"], ctx.dp)
        if ctx.state_sink is not None:
            ctx.state_sink[self.name] = {"_aux_loss": aux}
        wh, bh = params["h"]["wmat"].to(cdt), params["h"]["bias"].to(cdt)
        wo, bo = params["o"]["wmat"].to(cdt), params["o"]["bias"].to(cdt)
        if self.no_drop:
            w = sum(oh * gate[..., None] for oh, gate in sel)   # (B, T, X)
            h = _act(torch.einsum("bte,xef->btxf", x, wh) + bh[None, None],
                     self.act)
            y = torch.einsum("btxf,xfe->btxe", h, wo) + bo[None, None]
            out = torch.einsum("btx,btxe->bte", w.float(), y.float())
            return [_unseq(out.to(cdt))]
        # position in the expert's buffer by a cumulative sum over the
        # tokens, in f32; prev_count carries each expert's fill from the
        # first choices to the second
        dispatch = x.new_zeros((B, T, X, C), dtype=torch.float32)
        combine = x.new_zeros((B, T, X, C), dtype=torch.float32)
        prev = x.new_zeros((B, X), dtype=torch.float32)
        for oh, gate in sel:
            pos = torch.cumsum(oh, dim=1) - oh + prev[:, None, :]
            prev = prev + oh.sum(dim=1)
            pos_in = (pos * oh).sum(dim=-1)              # (B, T)
            keep = (pos_in < C).float() * oh.sum(dim=-1)
            # a slot past the capacity is dropped by keep
            slot = F.one_hot(pos_in.long().clamp_max(C - 1), C).float()
            d = oh[..., None] * slot[:, :, None, :] * keep[..., None, None]
            dispatch = dispatch + d
            combine = combine + d * gate[..., None, None]
        ex_in = torch.einsum("btxc,bte->bxce", dispatch, x.float()).to(cdt)
        h = _act(torch.einsum("bxce,xef->bxcf", ex_in, wh)
                 + bh[None, :, None, :], self.act)
        y = torch.einsum("bxcf,xfe->bxce", h, wo) + bo[None, :, None, :]
        out = torch.einsum("btxc,bxce->bte", combine, y.float())
        return [_unseq(out.to(cdt))]
