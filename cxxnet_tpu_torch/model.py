"""Network: a NetGraph run over NHWC tensors, at eval or in training.

The port of ``cxxnet_tpu/model.py``'s Network: shape inference over the
DAG, the activation-fold plan, init from an explicit
``torch.Generator``, an eval forward with node capture for extract, and
:meth:`Network.apply`, the differentiable training pass.
Parameters and layer state are kept as ``params[layer][leaf]`` /
``state[layer][leaf]`` dictionaries, the JAX package's pytree layout,
nested one level deeper where a layer's parameters are (``mha``'s
``params[layer][q|k|v|o][leaf]``, ``ffn``'s ``[h|o]``), with conv
weights OIHW (``convert.params_from_jax``). Shared layers
(``share[tag]``) reuse the primary layer's object and parameters. The
input node holds images (NHWC) or, for sequence models, token ids as
floats in a flat ``(batch, 1, 1, S)`` node, which ``embed`` reads.
Nodes ``1..extra_data_num`` (``in_1``, ...) hold the batch's
``extra_data`` arrays, shaped by ``extra_data_shape[i]``. In training a
layer's ``_aux_loss`` state (moe's load-balance loss) joins the
objective, as the JAX package adds it.
With ``remat = 1`` the training pass wraps each layer that has
parameters in ``torch.utils.checkpoint`` (the JAX package's
``jax.checkpoint``): its forward runs again in the backward. Layers that
draw in training (dropout, insanity) get a ``layers.Draws`` of their own
per pass, seeded from (``seed``, the step, the layer's index), as the
JAX package folds the layer index into the step's key.

Weights live on the network's device as float32 masters. For the eval
forward the leaves a layer computes with (conv and fullc ``wmat``) are
also held cast to the compute dtype, cast once per load or update
(:meth:`Network.invalidate_cast`), which equals the JAX package's
per-call cast. :meth:`Network.apply` casts inside the autograd graph
instead, so gradients reach the f32 masters.

The eval forward reads the cast params and the layer state as one pair
under ``weights_lock`` (:meth:`Network.weights_pair`), and a weights
swap installs both under the same lock after placing and casting them
outside it (:meth:`Network.place_weights`, :meth:`Network.install_weights`),
so no forward sees new params with old batch-norm statistics.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .config import ConfigPairs, Policy
from .device import resolve_device
from .graph import NetGraph, act_fusion_plan, global_param, policy_from_config
from .layers import ApplyCtx, Layer, create_layer
from .layers.base import Draws, Shape3, to_nhwc
from .ops.fused import kernels_active, resolve_mode
from .optim import get_leaf, leaves, unflatten
from .telemetry.modelhealth import act_tap

Params = Dict[str, Dict[str, torch.Tensor]]
NetState = Dict[str, Dict[str, torch.Tensor]]


@dataclasses.dataclass
class ForwardResult:
    out: torch.Tensor                            # value of the last node
    nodes: Optional[Dict[str, torch.Tensor]]     # node name -> value


class Network(nn.Module):
    """Static graph + layer objects; weights loaded with
    :meth:`load_weights`, then :meth:`forward` runs eval passes.

    ``device`` defaults to the config's ``dev`` (device.resolve_device:
    the card unless ``dev = cpu``)."""

    def __init__(self, graph: NetGraph, cfg: ConfigPairs,
                 device: Optional[Any] = None):
        super().__init__()
        self.graph = graph
        if graph.input_shape is None:
            raise ValueError("input_shape must be set")
        self.policy: Policy = policy_from_config(cfg)
        self.compute_dtype = self.policy.compute_dtype
        self.fused_mode = resolve_mode(
            global_param(cfg, "fused_kernels", "auto"))
        self.device = (torch.device(device) if device is not None
                       else resolve_device(global_param(cfg, "dev", "")))
        # remat = 1: each layer with parameters keeps only its inputs for
        # the backward and runs its forward again there (the JAX
        # package's jax.checkpoint per layer)
        self.remat = bool(int(global_param(cfg, "remat", "0")))
        self.seed = int(global_param(cfg, "seed", "0"))
        self.layers: List[Layer] = []
        for spec in graph.layers:
            if spec.is_shared:
                self.layers.append(self.layers[spec.primary_layer_index])
            else:
                self.layers.append(create_layer(spec, graph.defcfg))
        # shape inference over the DAG
        self.node_shapes: List[Optional[Shape3]] = [None] * graph.num_nodes
        self.node_shapes[0] = graph.input_shape
        for i in range(graph.extra_data_num):
            self.node_shapes[1 + i] = graph.extra_shapes[i]
        for spec, layer in zip(graph.layers, self.layers):
            in_shapes = []
            for ni in spec.nindex_in:
                if self.node_shapes[ni] is None:
                    raise ValueError(
                        f"layer {spec.name!r}: input node "
                        f"{graph.node_names[ni]!r} has no value yet")
                in_shapes.append(self.node_shapes[ni])
            for ni, s in zip(spec.nindex_out, layer.infer_shapes(in_shapes)):
                self.node_shapes[ni] = s
        self._in_shapes_of = [
            [self.node_shapes[ni] for ni in spec.nindex_in]
            for spec in graph.layers]
        # activation-fold plan (graph.act_fusion_plan): value-preserving,
        # so computed whenever the kernels are not switched off
        if self.fused_mode != "off":
            self._fuse_act, self._act_folded = act_fusion_plan(graph)
        else:
            self._fuse_act, self._act_folded = {}, set()
        self.params: Optional[Params] = None
        self.state: Optional[NetState] = None
        # data parallelism: this rank's parallel.DpContext (the JAX
        # package's Network.fused_spmd), set by the trainer; every pass
        # hands it to the layers, batch_norm takes the global batch's
        # moments over it and the loss divides by the global batch
        self.dp = None
        self._cast: Dict[torch.dtype, Params] = {}
        # guards params, state and their casts as one set (reentrant: a
        # serve engine installs weights and its version under it)
        self.weights_lock = threading.RLock()

    @property
    def fused(self) -> bool:
        """Whether layers hand their tensors to the kernel wrappers."""
        return kernels_active(self.fused_mode)

    def out_shape(self) -> Shape3:
        return self.node_shapes[self.graph.layers[-1].nindex_out[0]]

    # -- init / weights ----------------------------------------------------
    def init(self, generator: torch.Generator) -> Tuple[Params, NetState]:
        """Fresh float32 params + state on the generator's device (not
        loaded; see :meth:`load_weights`)."""
        params: Params = {}
        state: NetState = {}
        for li, (spec, layer) in enumerate(zip(self.graph.layers, self.layers)):
            if spec.is_shared:
                continue
            in_shapes = self._in_shapes_of[li]
            if layer.has_params:
                params[layer.name] = layer.init_params(generator, in_shapes)
            st = layer.init_state(in_shapes)
            if st:
                state[layer.name] = st
        return params, state

    def _expected(self) -> Tuple[Dict, Dict]:
        """Leaf shapes the graph implies: (params, state) path -> shape,
        a path being the keys from the layer down to the leaf."""
        g = torch.Generator()
        p, s = self.init(g)
        shape = lambda tree: {path: tuple(v.shape)
                              for path, v in leaves(tree)}
        return shape(p), shape(s)

    def _expected_quant(self, params: Dict) -> Dict:
        """Leaf shapes the int8 form adds for each layer of ``params``
        that carries ``wmat_scale`` (a PTQ-derived round); raises for a
        layer that does not quantize."""
        by_name = {l.name: l for l in self.layers}
        want = {}
        for name, lp in params.items():
            if not (isinstance(lp, dict) and "wmat_scale" in lp):
                continue
            shapes = by_name[name].quant_shapes() if name in by_name else {}
            if not shapes:
                raise ValueError(
                    f"params {name}: int8 leaves on a layer that does not "
                    "quantize (fullc, conv, seqfc do)")
            want.update({(name, leaf): s for leaf, s in shapes.items()})
        return want

    def load_weights(self, params: Dict, state: Dict) -> None:
        """Place ``params``/``state`` (port layout, nested trees of numpy
        arrays or tensors) on the device as float32, checked leaf by leaf
        against the graph, and cast the compute leaves once. A quantized
        layer's leaves (``wmat`` int8 of the float shape, ``wmat_scale``,
        ``act_scale``) are checked too; int8 stays int8."""
        self.install_weights(self.place_weights(params, state,
                                                self.compute_dtype))

    def place_weights(self, params: Dict, state: Dict,
                      dtype: torch.dtype) -> Tuple[Params, NetState, Dict]:
        """The checked placement of :meth:`load_weights` and the cast
        tree of ``dtype``, without touching the loaded weights: the
        slow half of a swap, done outside ``weights_lock``."""
        want_p, want_s = self._expected()
        want_p.update(self._expected_quant(params))
        quant = {path[0] for path in want_p if path[-1] == "wmat_scale"}

        def place(tree, want, what):
            got = {path for path, _ in leaves(tree)}
            if got != set(want):
                missing = sorted(set(want) - got)[:4]
                extra = sorted(got - set(want))[:4]
                raise ValueError(
                    f"{what} do not match the net config: missing "
                    f"{missing}, unexpected {extra}")
            out = []
            for path, shp in want.items():
                v = get_leaf(tree, path)
                v = torch.as_tensor(v if torch.is_tensor(v)
                                    else np.asarray(v))
                if tuple(v.shape) != shp:
                    raise ValueError(
                        f"{what} {'/'.join(path)}: shape {tuple(v.shape)} "
                        f"!= {shp} implied by the net config")
                # float leaves as float32, a quantized layer's wmat as
                # int8; integer state (insanity's step counter) int32
                if path[0] in quant and path[-1] == "wmat":
                    if v.dtype != torch.int8:
                        raise ValueError(
                            f"{what} {'/'.join(path)}: a quantized layer's "
                            f"wmat must be int8, got {v.dtype}")
                    dt = torch.int8
                elif v.is_floating_point():
                    dt = torch.float32
                else:
                    dt = torch.int32
                out.append((path, v.to(self.device, dt)))
            return unflatten(out)

        params_d = place(params, want_p, "params")
        state_d = place(state, want_s, "state")
        with torch.inference_mode():
            casts = {dtype: self._cast_tree(params_d, dtype)}
        return params_d, state_d, casts

    def install_weights(self, placed: Tuple[Params, NetState, Dict]) -> None:
        """Make a :meth:`place_weights` result the loaded weights, params,
        state and casts at once under ``weights_lock``."""
        params_d, state_d, casts = placed
        with self.weights_lock:
            self.params, self.state = params_d, state_d
            self._cast = dict(casts)

    def invalidate_cast(self) -> None:
        """Drop the eval forward's cast weights: call after the masters
        changed in place (an optimizer step)."""
        with self.weights_lock:
            self._cast = {}

    def _cast_tree(self, params: Params, dtype: torch.dtype) -> Params:
        """Each layer's compute leaves cast to ``dtype`` and laid out by
        the layer; the other leaves, and int8 weights, as they are (an
        int8 ``wmat`` laid out for the int8 product)."""
        tree = {}
        for layer in self.layers:
            lp = params.get(layer.name)
            if lp is None or layer.name in tree:
                continue
            tree[layer.name] = layer.cast_params(lp, dtype)
        return tree

    def weights_for(self, dtype: torch.dtype) -> Params:
        """Params with each layer's compute leaves cast to ``dtype`` and
        laid out by the layer, built once per dtype."""
        return self.weights_pair(dtype)[0]

    def weights_pair(self, dtype: torch.dtype) -> Tuple[Params, NetState]:
        """(:meth:`weights_for` ``dtype``, the layer state), read together
        under ``weights_lock``: what one eval pass runs with."""
        with self.weights_lock:
            if self.params is None:
                raise ValueError("no weights loaded: call load_weights()")
            tree = self._cast.get(dtype)
            if tree is None:
                with torch.inference_mode():
                    tree = self._cast_tree(self.params, dtype)
                self._cast[dtype] = tree
            return tree, self.state

    # -- graph walk --------------------------------------------------------
    def _walk(self, params: Params, state: NetState, data: torch.Tensor,
              ctx_fields: Dict[str, Any],
              label: Optional[torch.Tensor] = None,
              mask: Optional[torch.Tensor] = None,
              draws: Optional[Callable[[int], Any]] = None,
              extra_data: Sequence[torch.Tensor] = ()):
        """The one walk of :meth:`forward` and :meth:`apply`: each layer
        over its input nodes with its leaves of ``params`` (already cast)
        and an ``ApplyCtx(**ctx_fields)`` carrying the act-fold plan and,
        given ``draws``, ``draws(layer index)``. ``extra_data`` are the
        values of the nodes ``1..extra_data_num`` (``in_1..``). Returns
        the node values and the f32 sum of the training objective: the
        loss layers' losses (0 without a label) and, in training, the
        ``_aux_loss`` a layer writes to its state (the moe load-balance
        loss; divided by the world under dp, whose ranks' losses the
        trainer sums), in layer order."""
        g = self.graph
        want = to_nhwc(g.input_shape, data.shape[0])
        if tuple(data.shape) != want:
            raise ValueError(f"input shape {tuple(data.shape)} != {want}")
        if len(extra_data) != g.extra_data_num:
            raise ValueError(f"the net takes {g.extra_data_num} extra_data "
                             f"input(s), got {len(extra_data)}")
        nodes: List[Optional[torch.Tensor]] = [None] * g.num_nodes
        nodes[0] = data
        for i, ed in enumerate(extra_data):
            want = to_nhwc(g.extra_shapes[i], data.shape[0])
            if tuple(ed.shape) != want:
                raise ValueError(f"extra_data[{i}] shape {tuple(ed.shape)} "
                                 f"!= {want}")
            nodes[1 + i] = ed
        loss = torch.zeros((), dtype=torch.float32, device=data.device)
        batch = None if self.dp is None else data.shape[0] * self.dp.world
        sink = ctx_fields.get("state_sink")
        train = ctx_fields.get("train", False)
        health = ctx_fields.get("health_sink")
        for li, (spec, layer) in enumerate(zip(g.layers, self.layers)):
            if li in self._act_folded:
                # relu folded into its producer (graph.act_fusion_plan);
                # its tap reads the fused kernel's output
                nodes[spec.nindex_out[0]] = nodes[spec.nindex_in[0]]
                if health is not None:
                    self._health_tap(health, spec, nodes)
                continue
            ctx = ApplyCtx(fuse_act=self._fuse_act.get(li),
                           draws=draws(li) if draws is not None else None,
                           **ctx_fields)
            run = functools.partial(self._run_layer, layer,
                                    params.get(layer.name, {}),
                                    state.get(layer.name, {}), ctx)
            inputs = [nodes[ni] for ni in spec.nindex_in]
            if self.remat and layer.has_params and torch.is_grad_enabled():
                outputs = checkpoint(run, *inputs, use_reentrant=False)
            else:
                outputs = run(*inputs)
            for ni, out in zip(spec.nindex_out, outputs):
                nodes[ni] = out
            if health is not None:
                self._health_tap(health, spec, nodes)
            aux = (sink.get(layer.name, {}).get("_aux_loss")
                   if train and sink is not None else None)
            if aux is not None:
                loss = loss + (aux if self.dp is None
                               else aux / self.dp.world)
            if layer.is_loss and label is not None:
                a, b = g.label_slice(layer.target)
                loss = loss + layer.loss(outputs, label[:, a:b].float(),
                                         mask, batch)
        return nodes, loss

    @staticmethod
    def _health_tap(sink: Dict[str, Dict[str, torch.Tensor]], spec,
                    nodes) -> None:
        """The JAX package's per-layer activation taps (``_health_tap``):
        the output's abs-max, a relu's exact-zero fraction, beside what
        the layer put under its name (batch_norm's ``bn_var_min``)."""
        ent = act_tap(nodes[spec.nindex_out[0]], spec.type == "relu")
        sink[spec.name] = {**sink.get(spec.name, {}), **ent}

    @staticmethod
    def _run_layer(layer: Layer, lp, ls, ctx: ApplyCtx, *inputs):
        return tuple(layer.forward(lp, ls, list(inputs), ctx))

    def _top(self) -> int:
        g = self.graph
        return g.layers[-1].nindex_out[0] if g.layers else 0

    # -- forward -----------------------------------------------------------
    @torch.inference_mode()
    def forward(self, data: torch.Tensor, capture_nodes: bool = False,
                compute_dtype: Optional[torch.dtype] = None,
                fused: Optional[bool] = None,
                calib_sink: Optional[Dict] = None,
                extra_data: Sequence[torch.Tensor] = ()) -> ForwardResult:
        """One eval pass. ``data`` is NHWC (batch, y, x, c) or flat
        (batch, 1, 1, n) on the network's device, ``extra_data`` the
        values of the extra input nodes. ``compute_dtype``
        overrides the policy's for this call (the serve engine's
        ``serve_dtype``); ``fused`` overrides the kernel selection;
        ``calib_sink`` switches batch_norm layers to calibration
        (:func:`calibrate_bn`)."""
        cdt = self.compute_dtype if compute_dtype is None else compute_dtype
        params, state = self.weights_pair(cdt)
        nodes, _ = self._walk(
            params, state, data,
            dict(compute_dtype=cdt,
                 fused=self.fused if fused is None else fused,
                 calib_sink=calib_sink, dp=self.dp),
            extra_data=extra_data)
        node_map = None
        if capture_nodes:
            node_map = {name: nodes[i]
                        for i, name in enumerate(self.graph.node_names)
                        if nodes[i] is not None}
        return ForwardResult(out=nodes[self._top()], nodes=node_map)

    # -- training pass -----------------------------------------------------
    def apply(self, params: Params, state: NetState, data: torch.Tensor,
              label: Optional[torch.Tensor] = None,
              mask: Optional[torch.Tensor] = None, train: bool = False,
              capture_nodes: bool = False, step: int = 0,
              draws: Optional[Callable[[int], Any]] = None,
              extra_data: Sequence[torch.Tensor] = (),
              health_sink: Optional[Dict[str, Dict[str, torch.Tensor]]]
              = None):
        """One differentiable pass (the JAX package's ``Network.apply``):
        returns ``(loss, new_state, nodes)``. ``params`` are the f32
        masters (leaves that may require grad); each layer casts its
        compute leaves to the compute dtype inside the graph. ``label``
        is (batch, label_width) float32, ``mask`` (batch,) marks real
        rows (None = all) and ``extra_data`` holds the extra input
        nodes' values. ``loss`` is the f32 sum of the loss layers'
        losses (0 without a label) and, in training, the layers'
        ``_aux_loss``; ``new_state`` is ``state`` with the
        training updates of layers that keep state (batch_norm's
        running statistics, insanity's step counter, moe's ``_aux_loss``
        and pairtest's ``diff``, no grad);
        ``nodes`` maps node names to values: every node with
        ``capture_nodes``, else the last one. In training each layer draws
        from ``Draws(seed, step, layer index)`` (under dp this rank's rows
        of the global batch's draws); ``draws`` replaces that
        factory (tests hand the JAX package's draws in). A
        ``health_sink`` dict collects each layer's activation taps
        (``health = 1``: detached reads, the math unchanged); None adds
        no op."""
        if mask is None:
            mask = torch.ones((data.shape[0],), dtype=torch.float32,
                              device=data.device)
        sink: Dict[str, Dict[str, torch.Tensor]] = {}
        if train and draws is None:
            draws = functools.partial(Draws, self.seed, step,
                                      device=data.device, dp=self.dp)
        nodes, loss = self._walk(
            self._cast_tree(params, self.compute_dtype), state, data,
            dict(compute_dtype=self.compute_dtype, fused=self.fused,
                 train=train, state_sink=sink, dp=self.dp,
                 health_sink=health_sink), label, mask,
            draws, extra_data)
        new_state = {l: dict(d) for l, d in state.items()}
        new_state.update({l: _detached(d) for l, d in sink.items()})
        top = self._top()
        node_map = {name: nodes[i]
                    for i, name in enumerate(self.graph.node_names)
                    if nodes[i] is not None and (capture_nodes or i == top)}
        return loss, new_state, node_map

    def top_node(self) -> str:
        """Name of the last layer's output node (the metrics' default)."""
        g = self.graph
        return g.node_names[g.layers[-1].nindex_out[0] if g.layers else 0]


def _detached(tree):
    """A state tree with every tensor detached from autograd."""
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    return tree.detach()


def calibrate_bn(net: Network, data: torch.Tensor) -> NetState:
    """Running statistics equal to each batch_norm layer's batch moments
    on ``data``, from one plain forward (kernels off) in which each BN
    layer normalizes with the moments of its own input: the state a
    training step with ``bn_momentum = 0`` would leave. Returns a new
    state tree (float32, on the network's device); load it with
    ``net.load_weights(params, state)``. A random-init net needs this to
    serve: its zero running statistics make eval BN scale by
    ``rsqrt(eps)`` at every layer."""
    sink: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
    net.forward(data, fused=False, calib_sink=sink)
    state = {l: dict(d) for l, d in net.state.items()}
    for name, (mean, var) in sink.items():
        if name in state:
            state[name] = {"running_exp": mean, "running_var": var}
    return state
