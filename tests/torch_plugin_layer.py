"""A user layer for the port's ``plugin`` tests (torch only, no jax: the
port builds it through ``plugin_module = torch_plugin_layer``).

``ScaleShift``: ``y = x * scale + shift`` per channel (the last axis),
``scale`` initialised to ``init_scale`` (default 1) and ``shift`` to 0.
``NotALayer`` is a class that is not a port ``Layer``."""

import torch

from cxxnet_tpu_torch.layers import Layer


class ScaleShift(Layer):
    has_params = True

    def set_param(self, name, val):
        if name == "init_scale":
            self.init_scale = float(val)

    def __init__(self, spec, global_cfg):
        self.init_scale = 1.0
        super().__init__(spec, global_cfg)

    def infer_shapes(self, in_shapes):
        self.check_n(in_shapes, 1, 1)
        c, y, x = in_shapes[0]
        self._c = x if (c == 1 and y == 1) else c
        return [in_shapes[0]]

    def init_params(self, generator, in_shapes):
        return {"scale": torch.full((self._c,), self.init_scale),
                "shift": torch.zeros((self._c,))}

    def forward(self, params, state, inputs, ctx):
        return [inputs[0] * params["scale"] + params["shift"]]


class NotALayer:
    pass
