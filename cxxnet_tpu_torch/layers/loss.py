"""Loss layers: softmax, lp_loss/l2_loss, multi_logistic (the port of
``cxxnet_tpu/layers/loss.py``).

Each is a self-loop layer whose forward writes its prediction into the
node (probabilities, sigmoid, identity) and whose ``loss(outputs,
label, mask)`` is the scalar that training differentiates: the
per-example loss times the mask (padded rows 0), summed, divided by
the full batch and multiplied by ``grad_scale``, as the reference's
hand-set gradients scale (loss_layer_base-inl.hpp:55-62). Softmax and
its cross-entropy run in f32 whatever the compute dtype.
"""

from __future__ import annotations

from typing import Optional

import torch

from .base import Layer, register_layer


class LossLayerBase(Layer):
    is_loss = True

    def set_param(self, name, val):
        if name == "target":
            self.target = val
        elif name == "grad_scale":
            self.grad_scale = float(val)

    def __init__(self, spec, global_cfg):
        self.target = "label"
        self.grad_scale = 1.0
        super().__init__(spec, global_cfg)
        if spec.nindex_in != spec.nindex_out:
            raise ValueError(f"{spec.type} is a self-loop layer: use layer[+0]")

    def infer_shapes(self, in_shapes):
        self.check_n(in_shapes, 1, 1)
        return [in_shapes[0]]

    def _mean(self, per_example: torch.Tensor, mask: torch.Tensor,
              batch: Optional[int]) -> torch.Tensor:
        """grad_scale-weighted mean over the full batch (padded rows
        masked out, the division still by the batch size): ``batch``
        rows, the global batch of a data-parallel rank, or by default the
        rows given."""
        return self.grad_scale * torch.sum(per_example * mask) \
            / (per_example.shape[0] if batch is None else batch)

    def loss(self, outputs, label: torch.Tensor, mask: torch.Tensor,
             batch: Optional[int] = None) -> torch.Tensor:
        """The scalar loss of these rows, divided by ``batch`` (default:
        their number). A data-parallel rank passes the global batch, so
        the ranks' losses, and their gradients, sum to the global
        batch's."""
        raise NotImplementedError


@register_layer("softmax")
class SoftmaxLayer(LossLayerBase):
    """Node output = class probabilities, computed in f32 whatever the
    compute dtype."""

    def forward(self, params, state, inputs, ctx):
        x = inputs[0]
        logits = x.reshape(x.shape[0], -1).float()
        return [torch.softmax(logits, dim=-1).reshape(x.shape)]

    def loss(self, outputs, label, mask, batch=None):
        """Cross-entropy of the class index in ``label[:, 0]``."""
        probs = outputs[0].reshape(outputs[0].shape[0], -1)
        idx = label[:, 0].long()
        p = torch.gather(probs, 1, idx[:, None])[:, 0]
        return self._mean(-torch.log(torch.clamp(p, min=1e-30)), mask,
                          batch)


@register_layer("lp_loss", "l2_loss")
class LpLossLayer(LossLayerBase):
    """Regression loss: the forward is the identity."""

    def set_param(self, name, val):
        super().set_param(name, val)
        if name == "p":
            self.p = float(val)

    def __init__(self, spec, global_cfg):
        self.p = 2.0
        super().__init__(spec, global_cfg)

    def forward(self, params, state, inputs, ctx):
        return [inputs[0]]

    def loss(self, outputs, label, mask, batch=None):
        """sum_j |pred_j - label_j|^p per example."""
        pred = outputs[0].reshape(outputs[0].shape[0], -1).float()
        per = torch.sum(torch.abs(pred - label) ** self.p, dim=1)
        return self._mean(per, mask, batch)


@register_layer("multi_logistic")
class MultiLogisticLayer(LossLayerBase):
    """Independent sigmoids: node output = sigmoid(x)."""

    def forward(self, params, state, inputs, ctx):
        return [torch.sigmoid(inputs[0])]

    def loss(self, outputs, label, mask, batch=None):
        """Binary cross-entropy summed over the outputs."""
        p = outputs[0].reshape(outputs[0].shape[0], -1).float()
        p = torch.clamp(p, 1e-7, 1.0 - 1e-7)
        per = -torch.sum(label * torch.log(p)
                         + (1 - label) * torch.log(1 - p), dim=1)
        return self._mean(per, mask, batch)
