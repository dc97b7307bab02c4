"""Model health (the port of ``cxxnet_tpu/telemetry/modelhealth.py``):
the in-step statistics of ``health = 1``, their host-side probe, the
non-finite provenance walk, per-leaf checkpoint reports and the
serve-reload verdict.

A round's params and BN state are nested dicts of numpy arrays in the
JAX package's layout (what :func:`checkpoint.load_for_inference` yields
in either package). Each leaf is named ``layer/sub/leaf``, the keys from
the layer down joined by ``/``, and the leaves are walked in the JAX
package's order: dict keys sorted at every level (``None`` is an empty
subtree, a list's items read ``[i]``), so the report rows, the
``layers`` and ``provenance`` of a verdict, the six names of its
UNSAFE line and its ``worst`` row are the JAX package's on the same
pair of rounds.

:func:`reload_verdict` is the library ckpt_health call the deployment
controller's offline gate runs (``deploy/gates.py``): RELOAD-UNSAFE
(non-finite values or structure mismatch), RELOAD-SUSPECT (some leaf
moved more than ``max_ratio`` of its RMS), RELOAD-SANE, IDENTICAL or,
for one round alone, SANE.

The trainer half. With ``health = 1`` each plain train step builds one
small tree of f32 scalars on the device (:func:`step_health`): per leaf
the gradient's RMS, abs-max and finite fraction (unscaled under the
float16 loss scaler), the master's RMS and the update-to-weight RMS
ratio of the applied delta; the global gradient norm; per layer the
activation abs-max, the dead-ReLU (exact-zero) fraction of a relu and
the smallest batch variance of a batch_norm, read from the ``var`` the
BN kernel already returns (``model.Network`` taps them). The tree stays
on the device; :class:`HealthProbe` reads it once an interval in one
host copy, fans it out to the ``cxxnet_health_*`` gauges, runs the
windowed detectors (``health_advice`` ledger events) and feeds the
sentinel's ``grad_norm``. :func:`diagnose_nonfinite` names the first
non-finite site (params, then a diagnostic forward's activations, then
its gradients, in layer order) as ``layer=<name> kind=param|activation|
grad|loss leaf=<k>|node=<n>``, the provenance of ``sentinel_trip`` and
``rollback``. ``health = 0`` adds no tensor op and no host sync; ``health
= 1`` never changes the training math (the taps read detached values).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .ledger import LEDGER
from .registry import REGISTRY, MetricRegistry


def _leaf_pairs(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """``(layer/sub/leaf, leaf)`` pairs of a nested tree in the JAX
    package's flatten order (``tree_flatten_with_path``)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _leaf_pairs(tree[k], prefix + (str(k),))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _leaf_pairs(v, prefix + (f"[{i}]",))
        return out
    return [("/".join(prefix), tree)]


# -- in-step statistics (device tensors; no host sync) --------------------------

def _norms(ts: List[torch.Tensor], ord_=2.0) -> List[torch.Tensor]:
    """Per-tensor f32 norms in one multi-tensor launch where it can."""
    return list(torch._foreach_norm(ts, ord_))


def grad_stats(grads, inv_scale=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """Per-leaf gradient numerics keyed "layer/param": RMS, abs-max and
    finite fraction, f32 scalars on the device. ``inv_scale`` unscales
    float16 loss-scaled gradients (finiteness does not depend on it)."""
    pairs = _leaf_pairs(grads)
    g32 = [g.detach().float() for _, g in pairs]
    if inv_scale is not None:
        g32 = list(torch._foreach_mul(g32, inv_scale))
    l2, amax = _norms(g32), _norms(g32, float("inf"))
    out = {}
    for (key, g), n, a in zip(pairs, l2, amax):
        bad = torch.count_nonzero(~torch.isfinite(g.detach()))
        out[key] = {"rms": n / math.sqrt(max(g.numel(), 1)),
                    "absmax": a,
                    "finite_frac": 1.0 - bad.float() / max(g.numel(), 1)}
    return out


def param_stats(params) -> Dict[str, Dict[str, torch.Tensor]]:
    """Per-leaf RMS of the f32 masters, keyed "layer/param"."""
    pairs = _leaf_pairs(params)
    l2 = _norms([p.detach().float() for _, p in pairs])
    return {key: {"rms": n / math.sqrt(max(p.numel(), 1))}
            for (key, p), n in zip(pairs, l2)}


def update_stats(params_before, params_after,
                 eps: float = 1e-12) -> Dict[str, Dict[str, torch.Tensor]]:
    """Per-leaf update-to-weight RMS ratio of the applied delta, ``rms(w_new
    - w_old) / rms(w_old)`` (the JAX optimizer's ``health_update_stats``):
    exactly 0 where the apply was skipped."""
    before, after = _leaf_pairs(params_before), dict(_leaf_pairs(params_after))
    b32 = [b.detach().float() for _, b in before]
    d = list(torch._foreach_sub([after[k].detach().float()
                                 for k, _ in before], b32))
    nd, nb = _norms(d), _norms(b32)
    return {key: {"ratio": (x / r) / (y / r + eps)}
            for (key, b), x, y in zip(before, nd, nb)
            for r in (math.sqrt(max(b.numel(), 1)),)}


def global_grad_norm(grads, inv_scale=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(global L2 norm, all-finite flag as f32 1/0) over every gradient
    leaf: the sentinel's ``grad_norm``. NaN/Inf anywhere makes the norm
    non-finite."""
    g32 = [g.detach().float() for _, g in _leaf_pairs(grads)]
    if inv_scale is not None:
        g32 = list(torch._foreach_mul(g32, inv_scale))
    l2 = torch.stack(_norms(g32))
    finite = torch.stack([torch.isfinite(g).all() for g in g32]).all()
    return torch.sqrt(torch.sum(l2 * l2)), finite.float()


def step_health(grads, params_before, params_after, scale_in=None,
                scale_out=None, act: Optional[Dict[str, Any]] = None
                ) -> Dict[str, Any]:
    """One step's health tree (f32 scalars on the device): the raw
    gradients (before the optimizer's unscale and skip, so a NaN it would
    drop still shows), the masters around the apply, the activation taps
    of ``Network.apply``. Under float16 ``scale_in`` is the scale the
    step's gradients carry (they are unscaled by it) and ``scale_out``
    the scaler's scale after the step (exported as ``loss_scale``)."""
    inv = (1.0 / scale_in) if scale_in is not None else None
    gnorm, finite = global_grad_norm(grads, inv)
    health: Dict[str, Any] = {
        "grad_norm": gnorm,
        "grad_finite": finite,
        "grad": grad_stats(grads, inv),
        "param": param_stats(params_after),
        "update": update_stats(params_before, params_after),
        "act": act or {},
    }
    if scale_out is not None:
        health["loss_scale"] = scale_out.detach().float().clone()
    return health


def reduce_island(act: Dict[str, Dict[str, torch.Tensor]],
                  dp) -> Dict[str, Dict[str, torch.Tensor]]:
    """Make rank-local activation stats the global batch's under data
    parallelism (``dp`` a ``DpContext``): abs-max -> max, ``*_min`` ->
    min, fractions -> mean over the ranks (exact for equal shards), one
    collective a kind. Without ``dp`` the stats are returned as they
    are."""
    if dp is None or dp.world <= 1 or not act:
        return act
    import torch.distributed as dist
    groups = {"max": [], "min": [], "mean": []}
    for layer in sorted(act):
        for k in sorted(act[layer]):
            kind = ("max" if k.endswith("absmax") else
                    "min" if k.endswith("_min") else "mean")
            groups[kind].append((layer, k))
    out = {layer: dict(st) for layer, st in act.items()}
    for kind, op in (("max", dist.ReduceOp.MAX), ("min", dist.ReduceOp.MIN),
                     ("mean", dist.ReduceOp.SUM)):
        keys = groups[kind]
        if not keys:
            continue
        buf = torch.stack([act[l][k].float() for l, k in keys])
        dp.all_reduce(buf, op=op)
        if kind == "mean":
            buf = buf / dp.world
        for (l, k), v in zip(keys, buf):
            out[l][k] = v
    return out


def act_tap(out: torch.Tensor, relu: bool) -> Dict[str, torch.Tensor]:
    """A layer's output taps (detached; no copy of the activation): the
    abs-max, and for a relu the exact-zero fraction."""
    x = out.detach()
    ent = {"absmax": torch.linalg.vector_norm(x, float("inf"),
                                              dtype=torch.float32)}
    if relu:
        ent["zero_frac"] = 1.0 - torch.count_nonzero(x).float() / max(
            x.numel(), 1)
    return ent


def host_tree(tree) -> Any:
    """A tree of device scalars as the same tree of floats, through ONE
    device-to-host copy (the probe's one sync an interval)."""
    pairs = _leaf_pairs(tree)
    ts = [v for _, v in pairs if torch.is_tensor(v)]
    vals = (torch.stack([t.detach().float().reshape(()) for t in ts])
            .cpu().tolist() if ts else [])
    # rebuilt in _leaf_pairs' order: sorted keys at every level
    return _rebuild_sorted(tree, iter(vals))


def _rebuild_sorted(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild_sorted(tree[k], it) for k in sorted(tree)}
    return next(it) if torch.is_tensor(tree) else tree


# -- NaN provenance ------------------------------------------------------------

def _first_nonfinite(named: List[Tuple[str, torch.Tensor]]) -> Optional[str]:
    """The name of the first tensor holding a non-finite value, one host
    read for the lot."""
    if not named:
        return None
    flags = torch.stack([torch.isfinite(t.detach()).all()
                         for _, t in named]).cpu().tolist()
    for (name, _), ok in zip(named, flags):
        if not ok:
            return name
    return None


def diagnose_nonfinite(trainer) -> Optional[str]:
    """First-non-finite provenance in layer topological order: ``layer=
    <name> kind=param leaf=<k>`` (the masters), else ``kind=activation
    node=<n>`` (a diagnostic forward of the step's stashed batch, every
    node captured), else ``kind=grad leaf=<k>`` (its backward, of the
    float16 loss times the current scale), else ``layer=? kind=loss``;
    None when everything is finite. The diagnostic pass runs
    ``Network.apply`` as the step did, the same kernels on the same
    device with the step's draws; the passes after the first need the
    stash a plain ``health = 1`` step leaves."""
    g, net = trainer.graph, trainer.net
    owned = [(spec, layer) for spec, layer in zip(g.layers, net.layers)
             if not spec.is_shared and trainer.params.get(layer.name)]

    def walk(tree, kind):
        named = [(f"layer={layer.name} kind={kind} leaf={k}", v)
                 for spec, layer in owned
                 for k, v in _leaf_pairs(tree.get(layer.name) or {})]
        return _first_nonfinite(named)
    hit = walk(trainer.params, "param")
    if hit is not None:
        return hit
    stash = getattr(trainer, "_health_batch", None)
    if stash is None:
        return None
    data, label, mask, extra, step = stash
    mp = trainer.opt_state.get("_mp") if isinstance(
        trainer.opt_state, dict) else None
    with torch.enable_grad():
        loss, _, nodes = net.apply(trainer.params, net.state, data, label,
                                   mask, train=True, capture_nodes=True,
                                   step=step, extra_data=extra)
        flat = _leaf_pairs(trainer.params)
        sloss = loss * mp["scale"] if mp is not None else loss
        grads = torch.autograd.grad(sloss, [v for _, v in flat],
                                    allow_unused=True)
    named = [(f"layer={spec.name} kind=activation node="
              f"{g.node_names[ni]}", nodes[g.node_names[ni]])
             for spec in g.layers for ni in spec.nindex_out
             if g.node_names[ni] in nodes]
    hit = _first_nonfinite(named)
    if hit is not None:
        return hit
    gtree: Dict[str, Any] = {}
    for (key, _), gr in zip(flat, grads):
        if gr is None:
            continue
        node = gtree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = gr
    hit = walk(gtree, "grad")
    if hit is not None:
        return hit
    if not bool(torch.isfinite(loss.detach()).all()):
        return "layer=? kind=loss"
    return None


# -- training-dynamics detectors ----------------------------------------------

class WindowRule:
    """Pure windowed-onset rule: a key fires once after ``window``
    consecutive bad observations, stays silent while the condition
    persists, and re-arms after the first good observation.
    ``observe(key, None)`` marks an observation that is neither good nor
    bad (an update ratio of exactly 0 on a skipped step)."""

    def __init__(self, window: int):
        self.window = max(1, int(window))
        self._streak: Dict[Any, int] = {}
        self._fired: set = set()

    def observe(self, key, bad: Optional[bool]) -> bool:
        if bad is None:
            return False
        if not bad:
            self._streak[key] = 0
            self._fired.discard(key)
            return False
        s = self._streak.get(key, 0) + 1
        self._streak[key] = s
        if s >= self.window and key not in self._fired:
            self._fired.add(key)
            return True
        return False


class HealthProbe:
    """Host-side consumer of the step's health tree: the one sync an
    interval, the ``cxxnet_health_*`` gauges, the windowed detectors,
    the round-log fragment and the per-round ``model_health`` ledger
    event (the JAX package's class; owned by the round loop like the
    step-time probe, not thread-safe)."""

    def __init__(self, cfg, fp16: bool = False,
                 registry: Optional[MetricRegistry] = None,
                 silent: bool = False):
        self.cfg = cfg
        self.fp16 = bool(fp16)
        self.silent = bool(silent)
        self.syncs = 0
        self.overflows = 0
        self.advice_events = 0
        self.last: Optional[Dict[str, Any]] = None
        self.last_step: Optional[int] = None
        #: the sentinel's grad_norm: None until the first sync and on
        #: float16 overflow steps (the scaler handled those)
        self.last_grad_norm: Optional[float] = None
        self._last_overflow = False
        self._dead_rule = WindowRule(cfg.window)
        self._bn_rule = WindowRule(cfg.window)
        self._ratio_rule = WindowRule(cfg.window)
        reg = registry or REGISTRY
        lp = ("layer", "param")
        self._g_grad_rms = reg.gauge(
            "cxxnet_health_grad_rms",
            "Per-leaf gradient RMS (unscaled)", labels=lp)
        self._g_grad_absmax = reg.gauge(
            "cxxnet_health_grad_absmax",
            "Per-leaf gradient abs-max (unscaled)", labels=lp)
        self._g_grad_finite = reg.gauge(
            "cxxnet_health_grad_finite_frac",
            "Per-leaf fraction of finite gradient entries", labels=lp)
        self._g_param_rms = reg.gauge(
            "cxxnet_health_param_rms",
            "Per-leaf parameter RMS (fp32 masters)", labels=lp)
        self._g_update_ratio = reg.gauge(
            "cxxnet_health_update_ratio",
            "Per-leaf update-to-weight RMS ratio of the applied delta",
            labels=lp)
        self._g_act_absmax = reg.gauge(
            "cxxnet_health_act_absmax",
            "Per-layer activation abs-max", labels=("layer",))
        self._g_dead = reg.gauge(
            "cxxnet_health_dead_frac",
            "Per-layer dead-ReLU (exact-zero) output fraction",
            labels=("layer",))
        self._g_bn_var = reg.gauge(
            "cxxnet_health_bn_var_min",
            "Per-layer minimum BN batch variance across channels",
            labels=("layer",))
        self._g_gnorm = reg.gauge(
            "cxxnet_health_grad_norm",
            "Global gradient L2 norm (unscaled)")
        self._g_scale = reg.gauge(
            "cxxnet_health_loss_scale",
            "fp16 dynamic loss scale after the last synced step")
        self._c_syncs = reg.counter(
            "cxxnet_health_syncs_total",
            "Host syncs taken by the model-health probe")
        self._c_overflow = reg.counter(
            "cxxnet_health_overflow_total",
            "fp16 scaler-overflow (skipped-apply) steps seen at syncs")
        self._c_advice = reg.counter(
            "cxxnet_health_advice_total",
            "Training-dynamics advice events emitted", labels=("kind",))

    # -- feeding ---------------------------------------------------------
    def ingest(self, tree, round_no: Optional[int] = None,
               step: Optional[int] = None) -> Optional[Dict[str, Any]]:
        """Read the device tree (the probe's one host sync an interval),
        fan out to the gauges, run the detectors. Returns the summary
        (also ``self.last``)."""
        if tree is None:
            return None
        host = host_tree(tree) if _has_tensor(tree) else tree
        self.syncs += 1
        self._c_syncs.inc()
        self.last_step = step
        gnorm = float(host.get("grad_norm", float("nan")))
        finite = float(host.get("grad_finite", 1.0))
        overflow = bool(self.fp16 and finite < 1.0)
        onset = overflow and not self._last_overflow
        self._last_overflow = overflow
        if overflow:
            self.overflows += 1
            self._c_overflow.inc()
        self._g_gnorm.set(gnorm)
        ls = host.get("loss_scale")
        if ls is not None:
            self._g_scale.set(float(ls))
        for key, st in host.get("grad", {}).items():
            layer, _, param = key.partition("/")
            self._g_grad_rms.labels(layer, param).set(float(st["rms"]))
            self._g_grad_absmax.labels(layer, param).set(
                float(st["absmax"]))
            self._g_grad_finite.labels(layer, param).set(
                float(st["finite_frac"]))
        for key, st in host.get("param", {}).items():
            layer, _, param = key.partition("/")
            self._g_param_rms.labels(layer, param).set(float(st["rms"]))
        ratio_max: Optional[Tuple[float, str]] = None
        params_host = host.get("param", {})
        for key, st in host.get("update", {}).items():
            layer, _, param = key.partition("/")
            r = float(st["ratio"])
            self._g_update_ratio.labels(layer, param).set(r)
            # a near-zero leaf (zero-init biases) makes the ratio
            # meaningless: skipped for the summary and the band rule
            prms = float(params_host.get(key, {}).get("rms", 1.0))
            if prms < 1e-6:
                continue
            if ratio_max is None or r > ratio_max[0]:
                ratio_max = (r, key)
            # exactly 0 is a skipped apply: neither good nor bad
            bad = None if (r == 0.0 or overflow) else \
                not (self.cfg.ratio_min <= r <= self.cfg.ratio_max)
            if self._ratio_rule.observe(key, bad):
                self._advise("update_ratio", key, r, round_no, step)
        dead_max: Optional[Tuple[float, str]] = None
        bn_min: Optional[Tuple[float, str]] = None
        act_max: Optional[Tuple[float, str]] = None
        for layer, st in host.get("act", {}).items():
            am = float(st["absmax"])
            self._g_act_absmax.labels(layer).set(am)
            if act_max is None or am > act_max[0]:
                act_max = (am, layer)
            if "zero_frac" in st:
                zf = float(st["zero_frac"])
                self._g_dead.labels(layer).set(zf)
                if dead_max is None or zf > dead_max[0]:
                    dead_max = (zf, layer)
                if self._dead_rule.observe(layer,
                                           zf >= self.cfg.dead_frac):
                    self._advise("dead_relu", layer, zf, round_no, step)
            if "bn_var_min" in st:
                bv = float(st["bn_var_min"])
                self._g_bn_var.labels(layer).set(bv)
                if bn_min is None or bv < bn_min[0]:
                    bn_min = (bv, layer)
                if self._bn_rule.observe(layer,
                                         bv <= self.cfg.bn_var_floor):
                    self._advise("bn_collapse", layer, bv, round_no,
                                 step)
        self.last = {
            "grad_norm": gnorm, "grad_finite": finite,
            "overflow": overflow, "overflow_onset": onset,
            "loss_scale": float(ls) if ls is not None else None,
            "dead_max": dead_max, "bn_var_min": bn_min,
            "update_ratio_max": ratio_max, "act_absmax": act_max,
        }
        self.last_grad_norm = None if overflow else gnorm
        return self.last

    def _advise(self, kind: str, layer: str, value: float,
                round_no, step, **extra) -> None:
        self.advice_events += 1
        self._c_advice.labels(kind).inc()
        LEDGER.event("health_advice", kind=kind, layer=layer,
                     value=round(float(value), 8), round=round_no,
                     step=step, **extra)
        if not self.silent:
            print(f"health: {kind} on {layer} (value={value:.4g}, "
                  f"{self.cfg.window} consecutive syncs)", flush=True)

    def reset_after_rollback(self) -> None:
        """Drop the poisoned step's readings after a sentinel rollback: a
        stale NaN grad norm must not re-trip against the restored
        masters."""
        self.last = None
        self.last_grad_norm = None
        self._last_overflow = False

    def note_overflow_advice(self, round_no, step,
                             provenance: Optional[str]) -> None:
        """Ledger a float16 overflow onset with its provenance (the round
        loop owns the trainer the walk needs)."""
        self._advise("scaler_overflow",
                     (provenance or "?").replace("layer=", "", 1)
                     .split(" ")[0],
                     self.last.get("loss_scale") or 0.0
                     if self.last else 0.0,
                     round_no, step, provenance=provenance)

    # -- reading ---------------------------------------------------------
    def round_event(self, round_no: int) -> None:
        """One ``model_health`` ledger event a round."""
        if self.last is None:
            return
        f: Dict[str, Any] = {
            "round": round_no, "step": self.last_step,
            "grad_norm": self.last["grad_norm"],
            "syncs": self.syncs, "overflows": self.overflows,
        }
        if self.last.get("loss_scale") is not None:
            f["loss_scale"] = self.last["loss_scale"]
        for field, key in (("dead_max", "dead_max"),
                           ("bn_var_min", "bn_var_min"),
                           ("update_ratio_max", "update_ratio_max"),
                           ("act_absmax", "act_absmax")):
            v = self.last.get(key)
            if v is not None:
                f[field] = round(v[0], 8)
                f[field + "_layer"] = v[1]
        LEDGER.event("model_health", **f)

    def report_fragment(self) -> str:
        """Round-log fragment, the metric line's ``\\tkey:value``."""
        if self.last is None:
            return ""
        out = "\tgrad_norm:%.4g" % self.last["grad_norm"]
        if self.last.get("dead_max") is not None:
            out += "\tdead_max:%.2f" % self.last["dead_max"][0]
        if self.last.get("loss_scale") is not None:
            out += "\tloss_scale:%g" % self.last["loss_scale"]
        return out


def _has_tensor(tree) -> bool:
    return any(torch.is_tensor(v) for _, v in _leaf_pairs(tree))


# -- offline layer report ------------------------------------------------------

def layer_report(params, state=None) -> List[Dict[str, Any]]:
    """Per-leaf health rows of a round's param (and optionally state)
    trees: RMS, abs-max and finite fraction in float64."""
    rows: List[Dict[str, Any]] = []

    def walk(tree, kind):
        for key, leaf in _leaf_pairs(tree):
            a = np.asarray(leaf, dtype=np.float64)
            n = a.size or 1
            rows.append({
                "leaf": key, "kind": kind,
                "shape": tuple(np.asarray(leaf).shape),
                "rms": float(np.sqrt(np.mean(np.square(a)))),
                "absmax": float(np.max(np.abs(a))) if a.size else 0.0,
                "finite_frac": float(np.isfinite(a).sum() / n),
            })
    walk(params, "param")
    if state:
        walk(state, "state")
    return rows


# -- offline reload verdict ----------------------------------------------------

def delta_map(blob_a, blob_b) -> Dict[Tuple[str, str], float]:
    """Per-leaf ``rms(b - a)`` from the tensors, keyed like the
    :func:`layer_report` rows: value-level changes that keep a leaf's
    RMS (sign flips, permutations) still register."""
    out: Dict[Tuple[str, str], float] = {}

    def walk(ta, tb, kind):
        fa = dict(_leaf_pairs(ta))
        fb = dict(_leaf_pairs(tb))
        for k in set(fa) & set(fb):
            a = np.asarray(fa[k], dtype=np.float64)
            b = np.asarray(fb[k], dtype=np.float64)
            if a.shape != b.shape or not a.size:
                continue
            out[(kind, k)] = float(np.sqrt(np.mean(np.square(b - a))))

    walk(blob_a["params"], blob_b["params"], "param")
    if blob_a.get("state") and blob_b.get("state"):
        walk(blob_a["state"], blob_b["state"], "state")
    return out


def diff_rows(rows_a: List[Dict[str, Any]], rows_b: List[Dict[str, Any]],
              deltas: Optional[Dict[Tuple[str, str], float]] = None
              ) -> Tuple[List[Dict[str, Any]], List[str]]:
    """Per-leaf relative-change rows and structural mismatch notes.
    ``rel_change`` is ``rms(b - a) / rms(a)`` with ``deltas``
    (:func:`delta_map`), else ``|rms(b) - rms(a)| / rms(a)``."""
    a = {(r["kind"], r["leaf"]): r for r in rows_a}
    b = {(r["kind"], r["leaf"]): r for r in rows_b}
    notes = []
    for k in sorted(set(a) - set(b)):
        notes.append("only in A: %s %s" % k)
    for k in sorted(set(b) - set(a)):
        notes.append("only in B: %s %s" % k)
    out = []
    for k in sorted(set(a) & set(b)):
        ra, rb = a[k], b[k]
        if ra["shape"] != rb["shape"]:
            notes.append("shape mismatch at %s %s: %s vs %s"
                         % (k[0], k[1], ra["shape"], rb["shape"]))
            continue
        denom = ra["rms"] or 1e-12
        change = (deltas[k] if deltas is not None and k in deltas
                  else abs(rb["rms"] - ra["rms"]))
        out.append({"kind": k[0], "leaf": k[1],
                    "rms_a": ra["rms"], "rms_b": rb["rms"],
                    "rel_change": change / denom})
    return out, notes


def nonfinite_rows(rows: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Rows with any non-finite element, or a non-finite summary (an
    all-Inf leaf has finite_frac 0 and rms inf)."""
    return [r for r in rows if r["finite_frac"] < 1.0
            or not math.isfinite(r["rms"])]


def _row_provenance(row: Dict[str, Any]) -> str:
    """One report row as ``layer=<name> kind=<kind> leaf=<leaf>``, the
    JAX package's provenance string for the same poison."""
    leaf = row["leaf"]
    layer, _, rest = leaf.partition("/")
    return "layer=%s kind=%s leaf=%s" % (layer, row["kind"],
                                         rest or leaf)


def reload_verdict(blob_a, blob_b=None, max_ratio: float = 0.5,
                   digest_a: str = "", digest_b: str = ""
                   ) -> Dict[str, Any]:
    """The serve-reload verdict over one or two loaded rounds, the JAX
    package's dict: ``verdict``, ``exit_code`` (2 unsafe, 1 suspect, 0
    sane), ``line``, ``nonfinite`` (B's rows first, each with its
    ``layer``), ``layers`` (distinct poisoned layers, candidate first),
    ``provenance`` (of the first poisoned row), ``worst`` (the largest
    ``rel_change`` row), ``diff``, ``structure_notes``, ``a_leaves``,
    ``b_leaves``, ``max_ratio``, ``digest_a`` and ``digest_b``."""
    rows_a = layer_report(blob_a["params"], blob_a.get("state"))
    rows_b = (layer_report(blob_b["params"], blob_b.get("state"))
              if blob_b is not None else None)
    res: Dict[str, Any] = {
        "max_ratio": float(max_ratio),
        "digest_a": digest_a, "digest_b": digest_b,
        "a_leaves": rows_a, "b_leaves": rows_b,
        "nonfinite": [], "layers": [], "provenance": "",
        "worst": None, "diff": [], "structure_notes": [],
    }

    def done(verdict: str, line: str, code: int) -> Dict[str, Any]:
        res.update(verdict=verdict, line=line, exit_code=code)
        return res

    bad = (nonfinite_rows(rows_b) if rows_b else []) \
        + nonfinite_rows(rows_a)
    if bad:
        seen: List[str] = []
        for r in bad:
            r = dict(r)
            r["layer"] = r["leaf"].partition("/")[0]
            res["nonfinite"].append(r)
            if r["layer"] not in seen:
                seen.append(r["layer"])
        res["layers"] = seen
        res["provenance"] = _row_provenance(bad[0])
        return done("RELOAD-UNSAFE",
                    "RELOAD-UNSAFE: non-finite values in %s"
                    % ", ".join(sorted({r["leaf"] for r in bad})[:6]), 2)
    if rows_b is None:
        return done("SANE", "SANE: all leaves finite (digest %s)"
                    % (digest_a or "-"), 0)
    deltas = delta_map(blob_a, blob_b)
    diffs, notes = diff_rows(rows_a, rows_b, deltas)
    res["diff"], res["structure_notes"] = diffs, notes
    if notes:
        return done("RELOAD-UNSAFE",
                    "RELOAD-UNSAFE: structure mismatch — "
                    + "; ".join(notes[:6]), 2)
    if digest_b and digest_a and digest_a == digest_b:
        return done("IDENTICAL", "IDENTICAL (digest %s)" % digest_a, 0)
    worst = max(diffs, key=lambda d: d["rel_change"], default=None)
    res["worst"] = worst
    if worst is not None and worst["rel_change"] > max_ratio:
        return done("RELOAD-SUSPECT",
                    "RELOAD-SUSPECT: %s %s moved %.3gx its RMS "
                    "(> --max-ratio %g)"
                    % (worst["kind"], worst["leaf"],
                       worst["rel_change"], max_ratio), 1)
    return done("RELOAD-SANE",
                "RELOAD-SANE: max relative change %.3g (%s)"
                % ((worst["rel_change"], worst["leaf"]) if worst
                   else (0.0, "-")), 0)
