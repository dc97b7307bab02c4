"""Optimizers with tag-scoped hyperparameters and learning-rate schedules
(the port of ``cxxnet_tpu/optim.py``: SGD, NAG and Adam).

Parameter trees are nested dictionaries of any depth: Inception-BN's
are ``params[layer][leaf]``, an attention layer's ``params[layer][q|k|v|
o][leaf]``. Hyperparameters are resolved per leaf by its tag, taken from
the leaf's last key as in the JAX package: a leaf keyed ``bias``,
``gamma`` or ``beta`` is in the ``bias`` group, every other leaf in
``wmat``; ``wmat:lr = ...`` scopes a key to one group. The schedules
(constant, expdecay, polydecay, factor, and the momentum ramp) are
evaluated on the host per update and handed to the apply as floats, so
a schedule change rebuilds nothing.

The step updates the f32 masters and the moments IN PLACE (the JAX
package returns new trees; in place saves a copy of each). With the
kernels selected it is one :func:`~cxxnet_tpu_torch.ops.fused_optim.
fused_sgd_apply` or ``fused_adam_apply`` per tag group (one kernel
launch on the card); with ``fused_kernels = 0`` it is the plain
per-leaf math. The optimizer state is the JAX package's: ``{"mom":
tree}`` for SGD / NAG, ``{"m1": tree, "m2": tree, "t": step}`` for Adam,
the trees in the params' layout and ``t`` an int32 scalar kept on the
host (Adam's bias correction is computed there, once per step).

Under ``compute_dtype = float16`` the state also holds the dynamic loss
scaler, ``"_mp": {"scale": f32, "good": int32}``, two scalars on the
device (the JAX package's ``_mp`` subtree, created by :meth:`Optimizer.
init_state` and injected or dropped by :meth:`Optimizer.adapt_state` as
the policy of a resumed round changes). The gradients then arrive
multiplied by the scale; :meth:`Optimizer.update` divides them by it
(exact: the scale is a power of two), tests every leaf for inf and NaN,
skips the apply on any (params, moments and Adam's ``t`` keep their
bits), halves the scale (floored at ``loss_scale_min``) and resets
``good``; otherwise it applies, and doubles the scale (capped at
``loss_scale_max``) after ``loss_scale_window`` clean applies in a row.
For SGD and NAG the skip is a device flag that the apply reads on the
card, so a step has no host read; Adam reads the flag on the host once
per apply, since its ``t`` and bias correction live there.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .config import ConfigError, ConfigPairs
from .graph import global_param, policy_from_config
from .ops.fused import kernels_active, resolve_mode
from .ops.fused_optim import adam_apply_plain, fused_adam_apply, fused_sgd_apply

TAGS = ("wmat", "bias")

#: a parameter-shaped tree: nested dictionaries with tensor leaves
Tree = Dict[str, Any]
Path = Tuple[str, ...]


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
    beta1_decay: float = 0.1      # adam: beta1 = 1 - beta1_decay
    beta2_decay: float = 0.001

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
        elif name == "beta1":
            self.beta1_decay = float(val)
        elif name == "beta2":
            self.beta2_decay = float(val)
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


def leaves(tree: Tree, prefix: Path = ()) -> List[Tuple[Path, Any]]:
    """``(path, leaf)`` of a nested tree, depth first in its order: the
    path is the tuple of keys from the root to the leaf."""
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += leaves(v, prefix + (k,))
        else:
            out.append((prefix + (k,), v))
    return out


def get_leaf(tree: Tree, path: Path) -> Any:
    for k in path:
        tree = tree[k]
    return tree


def unflatten(pairs) -> Tree:
    """The nested tree of ``(path, leaf)`` pairs (:func:`leaves`'s
    inverse), keys in the order the pairs give them."""
    tree: Tree = {}
    for path, v in pairs:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


def tree_map(fn, tree: Tree) -> Tree:
    """``tree`` with ``fn`` applied to every leaf."""
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def adam_lr_t(lr: float, t: int, d1: float, d2: float) -> float:
    """Adam's bias-corrected step size at step ``t`` (1-based),
    ``lr * sqrt(1 - (1 - d2)^t) / (1 - (1 - d1)^t)``, computed in float32
    as the JAX package's traced step computes it, so the kernel and the
    plain apply receive the same scalar."""
    f = np.float32
    tf = f(t)
    fix1 = f(1.0) - f(1.0 - d1) ** tf
    fix2 = f(1.0) - f(1.0 - d2) ** tf
    return float(f(lr) * np.sqrt(fix2) / fix1)


class Optimizer:
    """SGD / NAG / Adam over nested trees of f32 masters."""

    def __init__(self, updater_type: str, cfg: ConfigPairs):
        if updater_type not in ("sgd", "nag", "adam"):
            raise ConfigError(f"unknown updater {updater_type!r}")
        self.type = updater_type
        self.hypers = build_hypers(cfg)
        self.fused_mode = resolve_mode(
            global_param(cfg, "fused_kernels", "auto"))
        self.lr_scale = 1.0
        self.fp16 = policy_from_config(cfg).compute_dtype == torch.float16
        self.ls_init = float(global_param(cfg, "loss_scale_init",
                                          str(2.0 ** 15)))
        self.ls_window = int(global_param(cfg, "loss_scale_window", "200"))
        self.ls_min = float(global_param(cfg, "loss_scale_min", "1.0"))
        self.ls_max = float(global_param(cfg, "loss_scale_max",
                                         str(2.0 ** 24)))

    @property
    def fused(self) -> bool:
        """Whether the step goes through the multi-tensor apply."""
        return kernels_active(self.fused_mode)

    def _mp_init(self, device) -> Dict[str, torch.Tensor]:
        """A fresh loss scaler on ``device``."""
        return {"scale": torch.tensor(np.float32(self.ls_init),
                                      device=device),
                "good": torch.zeros((), dtype=torch.int32, device=device)}

    def init_state(self, params: Tree) -> Dict[str, Any]:
        zeros = lambda: tree_map(torch.zeros_like, params)
        if self.type == "adam":
            state = {"m1": zeros(), "m2": zeros(),
                     "t": torch.zeros((), dtype=torch.int32)}
        else:
            state = {"mom": zeros()}
        if self.fp16:
            state["_mp"] = self._mp_init(leaves(params)[0][1].device)
        return state

    def adapt_state(self, opt_state: Dict[str, Any],
                    device) -> Dict[str, Any]:
        """A loaded optimizer state fitted to the current policy: a
        fresh scaler on ``device`` where float16 training resumes a round
        without one, the scaler dropped where another policy resumes a
        float16 round; the moments stay as they are either way."""
        has = "_mp" in opt_state
        if self.fp16 and not has:
            return {**opt_state, "_mp": self._mp_init(device)}
        if not self.fp16 and has:
            return {k: v for k, v in opt_state.items() if k != "_mp"}
        return opt_state

    def schedules(self, epoch: int) -> Dict[str, Tuple[float, float]]:
        """(lr, momentum) per tag at update step ``epoch``."""
        out = {}
        for tag, h in self.hypers.items():
            lr, mom = h.schedule(epoch)
            out[tag] = (lr * self.lr_scale, mom)
        return out

    def _groups(self, params: Tree) -> Dict[str, List[Path]]:
        """Leaf paths of ``params`` by tag group, in tree order."""
        groups: Dict[str, List[Path]] = {}
        for path, _ in leaves(params):
            groups.setdefault(tag_for_param(path[-1]), []).append(path)
        return groups

    @torch.no_grad()
    def update(self, params: Tree, grads: Tree, opt_state: Dict[str, Any],
               sched: Dict[str, Tuple[float, float]]) -> None:
        """One step: ``params`` and the moments in ``opt_state`` change in
        place (Adam's ``t`` is replaced by ``t + 1``); ``grads`` has the
        params' structure. With a loss scaler in ``opt_state`` the
        gradients are loss-scaled: they are unscaled, tested, and the
        apply skipped on an overflow (the module docstring)."""
        mp = opt_state.get("_mp")
        if mp is None:
            self._apply(params, grads, opt_state, sched, None)
            return
        flat = leaves(grads)
        scale = mp["scale"]
        # dividing by a power of two is exact, as the JAX package's g / scale
        gs = torch._foreach_div([g.float() for _, g in flat], scale)
        found = torch.zeros((1,), dtype=torch.float32, device=scale.device)
        torch._amp_foreach_non_finite_check_and_unscale_(
            gs, found, torch.ones((), dtype=torch.float32,
                                  device=scale.device))
        skip = found.reshape(()).to(torch.int32)
        self._apply(params, unflatten(
            (p, g) for (p, _), g in zip(flat, gs)), opt_state, sched, skip)
        finite = skip == 0
        good = torch.where(finite, mp["good"] + 1, 0)
        grow = finite & (good >= self.ls_window)
        ls_max = float(np.float32(self.ls_max))
        ls_min = float(np.float32(self.ls_min))
        new_scale = torch.where(
            finite, torch.where(grow, torch.clamp(scale * 2.0, max=ls_max),
                                scale),
            torch.clamp(scale * 0.5, min=ls_min))
        opt_state["_mp"] = {"scale": new_scale,
                            "good": torch.where(grow, 0, good)
                            .to(torch.int32)}

    def _apply(self, params: Tree, grads: Tree, opt_state: Dict[str, Any],
               sched: Dict[str, Tuple[float, float]],
               skip: Optional[torch.Tensor]) -> None:
        """The apply of unscaled gradients; where the device flag
        ``skip`` is set, params and moments keep their bits."""
        if self.type == "adam":
            self._adam(params, grads, opt_state, sched, skip)
            return
        mom = opt_state["mom"]
        if self.fused:
            for tag, paths in self._groups(params).items():
                h = self.hypers[tag]
                lr, momentum = sched[tag]
                fused_sgd_apply(
                    [get_leaf(params, p) for p in paths],
                    [get_leaf(grads, p).float().contiguous() for p in paths],
                    [get_leaf(mom, p) for p in paths], lr, momentum,
                    wd=h.wd, clip=h.clip_gradient, nag=self.type == "nag",
                    skip=skip)
            return
        for path, w in leaves(params):
            tag = tag_for_param(path[-1])
            h = self.hypers[tag]
            lr, momentum = sched[tag]
            g = _prep_grad(get_leaf(grads, path), w, h)
            m = get_leaf(mom, path)
            new_m = momentum * m - lr * g
            if self.type == "sgd":
                new_w = w + new_m
            else:
                new_w = w + (1 + momentum) * new_m - momentum * m
            if skip is not None:
                new_w = torch.where(skip != 0, w, new_w)
                new_m = torch.where(skip != 0, m, new_m)
            w.copy_(new_w)
            m.copy_(new_m)

    def _adam(self, params: Tree, grads: Tree, opt_state: Dict[str, Any],
              sched: Dict[str, Tuple[float, float]],
              skip: Optional[torch.Tensor]) -> None:
        """Adam (the JAX package's ``_apply`` / ``_apply_fused``): one
        apply per tag group with the kernels, else the plain math leaf by
        leaf; either way with ``t + 1``'s float32 ``lr_t``. The skip flag
        is read on the host: a skipped apply leaves ``t`` as it was."""
        if skip is not None and int(skip):
            return
        t = int(opt_state["t"]) + 1
        m1, m2 = opt_state["m1"], opt_state["m2"]
        for tag, paths in self._groups(params).items():
            h = self.hypers[tag]
            d1, d2 = h.beta1_decay, h.beta2_decay
            lr_t = adam_lr_t(sched[tag][0], t, d1, d2)
            ws = [get_leaf(params, p) for p in paths]
            gs = [get_leaf(grads, p).float().contiguous() for p in paths]
            a = [get_leaf(m1, p) for p in paths]
            b = [get_leaf(m2, p) for p in paths]
            if self.fused:
                fused_adam_apply(ws, gs, a, b, lr_t, d1=d1, d2=d2, wd=h.wd,
                                 clip=h.clip_gradient)
                continue
            new = adam_apply_plain(ws, gs, a, b, lr_t, d1, d2, h.wd,
                                   h.clip_gradient)
            for dst, src in zip((ws, a, b), new):
                for t_, v in zip(dst, src):
                    t_.copy_(v)
        opt_state["t"] = torch.tensor(t, dtype=torch.int32)
