"""Layer base classes of the PyTorch port.

The port of ``cxxnet_tpu/layers/base.py``. A layer is an object holding
parsed hyperparameters; its parameters and state live in dictionaries
that the :class:`~cxxnet_tpu_torch.model.Network` keeps and hands to
``forward``, as the JAX package threads its pytrees through ``apply``.
One ``forward`` serves eval and training (``ApplyCtx.train``); in
training it is differentiable by PyTorch autograd, and layers with
state (batch_norm's running statistics, insanity's step counter) hand
their new state to ``ApplyCtx.state_sink`` instead of returning it.
Layers that draw random numbers in training (dropout, insanity) take
them from ``ApplyCtx.draws``, a :class:`Draws` of their own.

Tensor convention: every node is a 4-D NHWC tensor ``(batch, y, x, c)``,
contiguous. "Flat" nodes are ``(batch, 1, 1, n)`` with features on the
channel axis. Logical per-node shapes (without batch) are ``(c, y, x)``
tuples, as the config dialect's ``input_shape = c,y,x``.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..config import ConfigPairs
from ..graph import LayerSpec

Shape3 = Tuple[int, int, int]   # (c, y, x)
Params = Dict[str, torch.Tensor]
State = Dict[str, torch.Tensor]


def is_flat(shape: Shape3) -> bool:
    return shape[0] == 1 and shape[1] == 1


def to_nhwc(shape: Shape3, batch: int) -> Tuple[int, int, int, int]:
    c, y, x = shape
    if is_flat(shape):
        return (batch, 1, 1, x)
    return (batch, y, x, c)


def flat_size(shape: Shape3) -> int:
    c, y, x = shape
    return c * y * x


@dataclasses.dataclass
class LayerHyper:
    """Shared layer hyperparameters (the JAX package's LayerHyper)."""
    num_hidden: int = 0
    init_sigma: float = 0.01
    init_uniform: float = -1.0
    init_bias: float = 0.0
    num_channel: int = 0
    random_type: int = 0            # 0 gaussian, 1 uniform/xavier, 2 kaiming
    num_group: int = 1
    kernel_height: int = 0
    kernel_width: int = 0
    stride: int = 1
    pad_y: int = 0
    pad_x: int = 0
    no_bias: int = 0
    silent: int = 0

    def set_param(self, name: str, val: str) -> None:
        if name == "init_sigma":
            self.init_sigma = float(val)
        elif name == "init_uniform":
            self.init_uniform = float(val)
        elif name == "init_bias":
            self.init_bias = float(val)
        elif name == "random_type":
            mapping = {"gaussian": 0, "uniform": 1, "xavier": 1, "kaiming": 2}
            if val not in mapping:
                raise ValueError(f"invalid random_type {val!r}")
            self.random_type = mapping[val]
        elif name == "nhidden":
            self.num_hidden = int(val)
        elif name == "nchannel":
            self.num_channel = int(val)
        elif name == "ngroup":
            self.num_group = int(val)
        elif name == "kernel_size":
            self.kernel_height = self.kernel_width = int(val)
        elif name == "kernel_height":
            self.kernel_height = int(val)
        elif name == "kernel_width":
            self.kernel_width = int(val)
        elif name == "stride":
            self.stride = int(val)
        elif name == "pad":
            self.pad_y = self.pad_x = int(val)
        elif name == "pad_y":
            self.pad_y = int(val)
        elif name == "pad_x":
            self.pad_x = int(val)
        elif name == "no_bias":
            self.no_bias = int(val)
        elif name == "silent":
            self.silent = int(val)

    def init_weight(self, generator: torch.Generator, shape: Sequence[int],
                    in_num: int, out_num: int) -> torch.Tensor:
        """Weight draw with the JAX package's distributions (float32, on
        the generator's device). The numbers differ from ``jax.random``'s
        for the same seed: weights move between the packages through
        checkpoints, never through seeds."""
        dev = generator.device
        if self.random_type == 0:
            return self.init_sigma * torch.randn(
                shape, generator=generator, device=dev)
        if self.random_type == 1:
            a = (3.0 / (in_num + out_num)) ** 0.5
            if self.init_uniform > 0:
                a = self.init_uniform
            u = torch.rand(shape, generator=generator, device=dev)
            return (2.0 * u - 1.0) * a
        if self.random_type == 2:
            if self.num_hidden > 0:
                sigma = (2.0 / self.num_hidden) ** 0.5
            else:
                sigma = (2.0 / (self.num_channel * self.kernel_width *
                                self.kernel_height)) ** 0.5
            return sigma * torch.randn(shape, generator=generator, device=dev)
        raise ValueError(f"unsupported random_type {self.random_type}")


class Draws:
    """The random draws of one layer in one training forward (the port of
    the JAX package's per-layer key ``fold_in(fold_in(PRNGKey(seed),
    step), layer)``, model.py:226 and trainer.py:709-715).

    Each draw makes a fresh ``torch.Generator`` on ``device`` seeded from
    (``seed``, ``step``, ``layer``), so the same triple gives the same
    numbers whenever the forward runs: a resumed run draws what an
    unbroken one would have, and a forward recomputed in the backward
    (``torch.utils.checkpoint``, which restores only the default
    generators) draws the same mask again. The numbers differ from
    ``jax.random``'s; tests hand a layer the JAX layer's draws through an
    object with these two methods.

    Under data parallelism (``dp``, a ``parallel.DpContext``) each rank
    draws for the global batch, ``shape[0] * dp.world`` rows, and keeps
    its own rows (``dp.rows``): the ranks' draws differ as the parts of
    one device's draw do, and the dp step draws what the single-device
    step on the global batch draws."""

    def __init__(self, seed: int, step: int, layer: int,
                 device: torch.device, dp: Optional[Any] = None):
        self.device = torch.device(device)
        self.dp = dp
        h = hashlib.sha256(f"{seed}:{step}:{layer}".encode()).digest()
        self._seed = int.from_bytes(h[:8], "little") & (2 ** 63 - 1)

    def _rand(self, shape, dtype: torch.dtype) -> torch.Tensor:
        shape = tuple(shape)
        world = 1 if self.dp is None else self.dp.world
        u = torch.rand((shape[0] * world,) + shape[1:],
                       generator=torch.Generator(device=self.device)
                       .manual_seed(self._seed),
                       device=self.device, dtype=dtype)
        return u if world == 1 else u[self.dp.rows(u.shape[0])]

    def keep_mask(self, shape, pkeep: float) -> torch.Tensor:
        """Bernoulli(``pkeep``) booleans of ``shape``: True keeps."""
        return self._rand(shape, torch.float32) < pkeep

    def uniform(self, shape, dtype: torch.dtype) -> torch.Tensor:
        """Uniform [0, 1) values of ``shape`` drawn in ``dtype``."""
        return self._rand(shape, dtype)


@dataclasses.dataclass
class ApplyCtx:
    """Per-call context of ``Layer.forward``."""
    compute_dtype: torch.dtype = torch.float32
    # training forward: batch statistics, dropout, differentiable
    train: bool = False
    # training: layer name -> its new state (batch_norm running stats)
    state_sink: Optional[Dict[str, Dict[str, torch.Tensor]]] = None
    # hand tensors to the kernel wrappers (ops/fused.py); False = the
    # plain PyTorch versions
    fused: bool = False
    # activation folded into this layer by graph.act_fusion_plan: "relu"
    # or None. Layers honouring it apply it on their plain path too.
    fuse_act: Optional[str] = None
    # batch-norm calibration: when a dict, batch_norm layers normalize
    # with the batch moments of their input and record them here under
    # their name (model.calibrate_bn)
    calib_sink: Optional[Dict[str, Tuple[torch.Tensor, torch.Tensor]]] = None
    # training: this layer's random draws (dropout, insanity)
    draws: Optional[Draws] = None
    # data parallelism: this rank's parallel.DpContext (batch_norm takes
    # the global batch's moments over it); None on one device
    dp: Optional[Any] = None
    # model health (health = 1): layer name -> its activation taps; a
    # batch_norm adds the smallest batch variance of the moments its
    # kernel returns (telemetry/modelhealth.py). None = health off
    health_sink: Optional[Dict[str, Dict[str, torch.Tensor]]] = None

    def draw_source(self, layer: str) -> Draws:
        """The layer's draws; a training forward without them raises."""
        if self.draws is None:
            raise ValueError(f"layer {layer!r} draws random numbers in "
                             "training: ApplyCtx.draws must be set")
        return self.draws


class Layer:
    """Base class: parse hyperparameters at construction, then a
    forward over tensors (eval, or training when ``ctx.train``)."""

    has_params = False
    has_state = False
    is_loss = False
    #: parameter leaves held in the compute dtype (cast once at load)
    compute_leaves: Tuple[str, ...] = ()

    def __init__(self, spec: LayerSpec, global_cfg: ConfigPairs):
        self.spec = spec
        self.name = spec.name
        self.hp = LayerHyper()
        for k, v in global_cfg:
            self.hp.set_param(k, v)
            self.set_param(k, v)
        for k, v in spec.cfg:
            self.hp.set_param(k, v)
            self.set_param(k, v)

    def set_param(self, name: str, val: str) -> None:
        """Layer-specific config hook."""

    def infer_shapes(self, in_shapes: List[Shape3]) -> List[Shape3]:
        """Output logical shapes given input logical shapes."""
        raise NotImplementedError

    def init_params(self, generator: torch.Generator,
                    in_shapes: List[Shape3]) -> Params:
        return {}

    def init_state(self, in_shapes: List[Shape3]) -> State:
        return {}

    def place_leaf(self, leaf: str, t: torch.Tensor) -> torch.Tensor:
        """Hook to give a loaded leaf its memory layout (conv weights)."""
        return t

    def cast_params(self, lp: Params, dtype: torch.dtype) -> Params:
        """The layer's params as its forward takes them: the compute
        leaves cast to ``dtype`` (float ones only: an int8 ``wmat`` stays
        int8) and every leaf laid out by :meth:`place_leaf`."""
        return {k: self.place_leaf(
            k, v.to(dtype) if k in self.compute_leaves
            and v.is_floating_point() else v) for k, v in lp.items()}

    def quant_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """Shapes of the leaves a PTQ-derived round adds to this layer's
        parameters beside its int8 ``wmat`` (``wmat_scale`` per output
        channel, the scalar ``act_scale``); empty for a layer that does
        not quantize (quant/ptq.QUANT_LAYER_TYPES)."""
        return {}

    def forward(self, params: Params, state: State,
                inputs: List[torch.Tensor], ctx: ApplyCtx
                ) -> List[torch.Tensor]:
        raise NotImplementedError

    def check_n(self, in_shapes: List[Shape3], n_in: int, n_out: int) -> None:
        if len(self.spec.nindex_in) != n_in or len(self.spec.nindex_out) != n_out:
            raise ValueError(
                f"{self.spec.type} layer {self.name!r}: needs {n_in} input(s) "
                f"and {n_out} output(s), got {len(self.spec.nindex_in)}->"
                f"{len(self.spec.nindex_out)}")


LAYER_REGISTRY: Dict[str, type] = {}


def register_layer(*names: str):
    def deco(cls):
        for n in names:
            LAYER_REGISTRY[n] = cls
        cls.type_names = names
        return cls
    return deco
