"""Batch normalization (the port of ``cxxnet_tpu/layers/norm.py``).

Training (``ctx.train``) normalizes with the batch's own per-channel
moments. With the kernels selected that is
:func:`~cxxnet_tpu_torch.ops.fused_norm.fused_bn_act` (the BN forward
and backward kernels on the card, their plain versions on the CPU);
with ``fused_kernels = 0`` it is the JAX package's jnp path written in
PyTorch, one-pass ``E[x^2] - E[x]^2`` clamped at 0 or two-pass with
``bn_two_pass = 1``, differentiated by autograd. ``batch_norm`` then
moves its running statistics by ``bn_momentum`` in f32 and hands them
to ``ctx.state_sink``.

At eval ``batch_norm`` normalizes with its running statistics. The
arithmetic follows the JAX package (norm.py:224-228): with a bf16 input
and f32 ``slope``/``mean``/``var``, the input is promoted to f32, scaled
and shifted, the folded relu applied, and only then cast back to the
input's dtype. ``batch_norm_no_ma`` recomputes batch statistics at
eval: through the BN forward kernel when the kernels are selected, as
the JAX package's fused path does (norm.py:211-215). Statistics are per
channel for conv nodes and per feature for flat nodes, as the trailing
NHWC axis holds either.

Under data parallelism (``ctx.dp``) every pass that takes batch moments
(training, and ``batch_norm_no_ma`` at eval) takes those of the global
batch through :func:`~cxxnet_tpu_torch.ops.fused_norm.sync_bn_act`: the
sync-BN kernels, or their plain versions under ``fused_kernels = 0``.
Nothing takes shard-local moments there. ``bn_two_pass = 1`` raises
under dp: two-pass moments across ranks are not ported (nor does the JAX
package have a kernel for them).

:func:`cxxnet_tpu_torch.model.calibrate_bn` drives the one other mode:
with ``ctx.calib_sink`` set, a layer normalizes with its input's batch
moments and records them.
"""

from __future__ import annotations

import torch

from ..config import ConfigError
from ..ops.fused_norm import bn_act_plain, fused_bn_act, sync_bn_act
from .base import Layer, is_flat, register_layer


class _BatchNormBase(Layer):
    moving_avg = True
    has_params = True

    def set_param(self, name, val):
        if name == "init_slope":
            self.init_slope = float(val)
        elif name == "eps":
            self.eps = float(val)
        elif name == "bn_momentum":
            self.bn_momentum = float(val)
        elif name == "bn_two_pass":
            self.two_pass = bool(int(val))

    def __init__(self, spec, global_cfg):
        self.init_slope = 1.0
        self.eps = 1e-10
        self.bn_momentum = 0.9
        self.two_pass = False
        self._clamp_checked = False
        super().__init__(spec, global_cfg)

    @property
    def has_state(self):
        return self.moving_avg

    def infer_shapes(self, in_shapes):
        self.check_n(in_shapes, 1, 1)
        s = in_shapes[0]
        self._channel = s[2] if is_flat(s) else s[0]
        return [s]

    def init_params(self, generator, in_shapes):
        dev = generator.device
        return {
            "wmat": torch.full((self._channel,), self.init_slope, device=dev),
            "bias": torch.full((self._channel,), self.hp.init_bias, device=dev),
        }

    def init_state(self, in_shapes):
        if not self.moving_avg:
            return {}
        return {"running_exp": torch.zeros(self._channel),
                "running_var": torch.zeros(self._channel)}

    def _batch_moments(self, x: torch.Tensor):
        xf = x.float()
        mean = xf.mean(dim=(0, 1, 2))
        if self.two_pass:
            var = (xf - mean).square().mean(dim=(0, 1, 2))
        else:
            var = torch.clamp(xf.square().mean(dim=(0, 1, 2))
                              - mean.square(), min=0.0)
        return mean, var

    def _check_clamp(self, x: torch.Tensor, mean: torch.Tensor) -> None:
        """The JAX package's variance-clamp warning (norm.py:168-184) as
        a host-side check, made once per layer instance (its first
        training call on the plain path): the one-pass moment
        ``E[x^2] - E[x]^2`` went negative by more than eps on some
        channel."""
        self._clamp_checked = True
        with torch.no_grad():
            xf = x.float()
            worst = float((xf.square().mean(dim=(0, 1, 2))
                           - mean.square()).min())
        if worst < -self.eps:
            print(f"WARNING batch_norm {self.name!r}: one-pass variance "
                  f"went negative (min E[x^2]-E[x]^2 = {worst:.3e}, "
                  f"beyond eps {self.eps:.1e}) and was clamped to 0 — f32 "
                  f"cancellation on a large-mean/low-variance channel; "
                  f"normalization degrades toward rsqrt(eps) there. "
                  f"Consider rescaling inputs or raising eps.", flush=True)

    def _sync(self, x, slope, bias, ctx):
        """The global batch's batch norm over the ranks of ``ctx.dp``."""
        if self.two_pass:
            raise ConfigError(
                f"batch_norm {self.name!r}: bn_two_pass = 1 under data "
                "parallelism is not in the PyTorch port (ROADMAP Queue A 5, "
                "still queued: two-pass moments across ranks)")
        return sync_bn_act(x, slope, bias, self.eps, ctx.fuse_act or "none",
                           ctx.dp, ctx.fused)

    def _forward_train(self, params, state, x, ctx):
        slope, bias = params["wmat"], params["bias"]
        act = ctx.fuse_act or "none"
        if ctx.dp is not None:
            out, mean, var = self._sync(x, slope, bias, ctx)
        elif ctx.fused:
            out, mean, var = fused_bn_act(x, slope, bias, self.eps, act,
                                          self.two_pass)
        else:
            # the JAX package's jnp path (norm.py:145-189), differentiated
            # by autograd through the moments
            out, mean, var = bn_act_plain(x, slope, bias, self.eps, act,
                                          self.two_pass)
            if not self.two_pass and not self._clamp_checked:
                self._check_clamp(x, mean.detach())
        if self.moving_avg:
            m = self.bn_momentum
            with torch.no_grad():
                ctx.state_sink[self.name] = {
                    "running_exp": state["running_exp"] * m
                    + mean.detach() * (1 - m),
                    "running_var": state["running_var"] * m
                    + var.detach() * (1 - m),
                }
        return [out]

    def forward(self, params, state, inputs, ctx):
        x = inputs[0]
        if ctx.train:
            return self._forward_train(params, state, x, ctx)
        slope, bias = params["wmat"], params["bias"]
        if ctx.calib_sink is not None:
            mean, var = self._batch_moments(x)
            ctx.calib_sink[self.name] = (mean, var)
        elif self.moving_avg:
            mean, var = state["running_exp"], state["running_var"]
        elif ctx.dp is not None:
            return [self._sync(x, slope, bias, ctx)[0]]
        elif ctx.fused:
            return [fused_bn_act(x, slope, bias, self.eps,
                                 ctx.fuse_act or "none", self.two_pass)[0]]
        else:
            mean, var = self._batch_moments(x)
        inv = torch.rsqrt(var + self.eps)
        out = x.float() * (slope * inv) + (bias - slope * mean * inv)
        if ctx.fuse_act == "relu":
            out = torch.relu(out)
        return [out.to(x.dtype)]


@register_layer("batch_norm")
class BatchNormLayer(_BatchNormBase):
    moving_avg = True


@register_layer("batch_norm_no_ma")
class BatchNormNoMALayer(_BatchNormBase):
    moving_avg = False
