"""Optimizers with tag-scoped hyperparameters and learning-rate schedules
(the port of ``cxxnet_tpu/optim.py``, SGD and NAG).

Hyperparameters are resolved per leaf by its tag: a leaf keyed ``bias``
(and batch_norm's ``bias``) is in the ``bias`` group, every other leaf
in ``wmat``; ``wmat:lr = ...`` scopes a key to one group. The schedules
(constant, expdecay, polydecay, factor, and the momentum ramp) are
evaluated on the host per update and handed to the apply as floats, so
a schedule change rebuilds nothing.

The step updates the f32 masters and the momenta IN PLACE (the JAX
package returns new trees; in place saves a copy of both). With the
kernels selected it is one :func:`~cxxnet_tpu_torch.ops.fused_optim.
fused_sgd_apply` per tag group (one kernel launch on the card); with
``fused_kernels = 0`` it is the plain per-leaf math. The optimizer
state is ``{"mom": tree}`` in the params' layout, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch

from .config import ConfigError, ConfigPairs
from .graph import global_param
from .ops.fused import kernels_active, resolve_mode
from .ops.fused_optim import fused_sgd_apply

TAGS = ("wmat", "bias")

Tree = Dict[str, Dict[str, torch.Tensor]]


def tag_for_param(param_name: str) -> str:
    """lr/wd scoping group of a parameter leaf key."""
    return "bias" if param_name in ("bias", "gamma", "beta") else "wmat"


@dataclasses.dataclass
class UpdaterHyper:
    """Per-tag hyperparameters (the reference's UpdaterParam)."""
    tag: str = "wmat"
    base_lr: float = 0.01
    wd: float = 0.0
    momentum: float = 0.9
    lr_schedule: int = 0          # 0 const, 1 expdecay, 2 polydecay, 3 factor
    lr_step: int = 1
    lr_gamma: float = 0.5
    lr_alpha: float = 0.5
    lr_factor: float = 0.1
    lr_minimum: float = 1e-5
    start_epoch: int = 0
    momentum_schedule: int = 0
    base_momentum: float = 0.5
    final_momentum: float = 0.9
    saturation_epoch: int = 0
    clip_gradient: float = 0.0

    def set_param(self, name: str, val: str) -> None:
        # tag scoping: "wmat:lr" applies only when tag == "wmat"
        if name.startswith(self.tag + ":"):
            name = name[len(self.tag) + 1:]
        elif ":" in name and name.split(":", 1)[0] in TAGS:
            return  # scoped to a different tag
        if name in ("lr", "eta"):
            self.base_lr = float(val)
        elif name == "wd":
            self.wd = float(val)
        elif name == "momentum":
            self.momentum = float(val)
        elif name == "momentum_schedule":
            self.momentum_schedule = int(val)
        elif name == "clip_gradient":
            self.clip_gradient = float(val)
        elif name == "final_momentum":
            self.final_momentum = float(val)
        elif name == "base_momentum":
            self.base_momentum = float(val)
        elif name == "saturation_epoch":
            self.saturation_epoch = int(val)
        elif name.startswith("lr:") or name.startswith("eta:"):
            sub = name.split(":", 1)[1]
            if sub == "schedule":
                mapping = {"constant": 0, "expdecay": 1, "polydecay": 2,
                           "factor": 3}
                if val in mapping:
                    self.lr_schedule = mapping[val]
            elif sub == "gamma":
                self.lr_gamma = float(val)
            elif sub == "alpha":
                self.lr_alpha = float(val)
            elif sub == "step":
                self.lr_step = int(val)
            elif sub == "factor":
                self.lr_factor = float(val)
            elif sub == "minimum_lr":
                self.lr_minimum = float(val)
            elif sub == "start_epoch":
                self.start_epoch = int(val)

    def schedule(self, epoch: int) -> Tuple[float, float]:
        """(learning_rate, momentum) at update step ``epoch``."""
        if self.lr_schedule == 0:
            lr = self.base_lr
        elif self.lr_schedule == 1:
            lr = self.base_lr * (self.lr_gamma ** (epoch / self.lr_step))
        elif self.lr_schedule == 2:
            lr = self.base_lr * (1.0 + (epoch // self.lr_step) * self.lr_gamma) \
                ** (-self.lr_alpha)
        elif self.lr_schedule == 3:
            lr = self.base_lr * (self.lr_factor ** (epoch // self.lr_step))
        else:
            raise ValueError("unknown lr schedule")
        momentum = self.momentum
        if self.momentum_schedule and self.saturation_epoch:
            momentum = (self.final_momentum - self.base_momentum) \
                / self.saturation_epoch * epoch + self.base_momentum
        momentum = min(momentum, self.final_momentum) \
            if self.momentum_schedule else momentum
        lr = max(lr, self.lr_minimum)
        if epoch < self.start_epoch:
            lr = self.base_lr
        return lr, momentum


def build_hypers(cfg: ConfigPairs) -> Dict[str, UpdaterHyper]:
    hypers = {tag: UpdaterHyper(tag=tag) for tag in TAGS}
    for name, val in cfg:
        for h in hypers.values():
            h.set_param(name, val)
    return hypers


def _prep_grad(g: torch.Tensor, w: torch.Tensor,
               hyper: UpdaterHyper) -> torch.Tensor:
    """NaN-zeroing, clip and weight decay of one gradient leaf, upcast
    to the master's dtype first."""
    g = g.to(w.dtype)
    g = torch.where(torch.isnan(g), torch.zeros_like(g), g)
    if hyper.clip_gradient != 0.0:
        g = torch.clamp(g, -hyper.clip_gradient, hyper.clip_gradient)
    if hyper.wd != 0.0:
        g = g + hyper.wd * w
    return g


def leaves(tree: Tree) -> List[Tuple[str, str, torch.Tensor]]:
    """``(layer, key, tensor)`` of a two-level tree, in its order."""
    return [(l, k, v) for l, d in tree.items() for k, v in d.items()]


class Optimizer:
    """SGD / NAG over ``params[layer][key]`` trees of f32 masters."""

    def __init__(self, updater_type: str, cfg: ConfigPairs):
        if updater_type == "adam":
            raise ConfigError(
                "updater = adam: not trained by the PyTorch port yet "
                "(ROADMAP Queue A 3, still queued: Adam, Queue B row 12b)")
        if updater_type not in ("sgd", "nag"):
            raise ConfigError(f"unknown updater {updater_type!r}")
        self.type = updater_type
        self.hypers = build_hypers(cfg)
        self.fused_mode = resolve_mode(
            global_param(cfg, "fused_kernels", "auto"))
        self.lr_scale = 1.0

    @property
    def fused(self) -> bool:
        """Whether the step goes through the multi-tensor apply."""
        return kernels_active(self.fused_mode)

    def init_state(self, params: Tree) -> Dict[str, Tree]:
        return {"mom": {l: {k: torch.zeros_like(v) for k, v in d.items()}
                        for l, d in params.items()}}

    def schedules(self, epoch: int) -> Dict[str, Tuple[float, float]]:
        """(lr, momentum) per tag at update step ``epoch``."""
        out = {}
        for tag, h in self.hypers.items():
            lr, mom = h.schedule(epoch)
            out[tag] = (lr * self.lr_scale, mom)
        return out

    @torch.no_grad()
    def update(self, params: Tree, grads: Tree, opt_state: Dict[str, Tree],
               sched: Dict[str, Tuple[float, float]]) -> None:
        """One step: ``params`` and ``opt_state["mom"]`` change in place;
        ``grads`` has the params' structure."""
        mom = opt_state["mom"]
        if self.fused:
            groups: Dict[str, List[Tuple[str, str]]] = {}
            for l, k, _ in leaves(params):
                groups.setdefault(tag_for_param(k), []).append((l, k))
            for tag, keys in groups.items():
                h = self.hypers[tag]
                lr, momentum = sched[tag]
                fused_sgd_apply(
                    [params[l][k] for l, k in keys],
                    [grads[l][k].float().contiguous() for l, k in keys],
                    [mom[l][k] for l, k in keys], lr, momentum,
                    wd=h.wd, clip=h.clip_gradient, nag=self.type == "nag")
            return
        for l, k, w in leaves(params):
            tag = tag_for_param(k)
            h = self.hypers[tag]
            lr, momentum = sched[tag]
            g = _prep_grad(grads[l][k], w, h)
            m = mom[l][k]
            new_m = momentum * m - lr * g
            if self.type == "sgd":
                new_w = w + new_m
            else:
                new_w = w + (1 + momentum) * new_m - momentum * m
            w.copy_(new_w)
            m.copy_(new_m)
