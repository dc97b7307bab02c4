"""Trainer: one device or one data-parallel rank, SGD / NAG / Adam (the
port of ``cxxnet_tpu/trainer.py``'s single-device and dp paths).

A step is the JAX package's ``_make_train_step`` body ``one``
(trainer.py:1620-1650): the differentiable forward
:meth:`Network.apply` over the f32 masters, ``torch.autograd.grad`` of
the summed loss, then the optimizer's in-place update of the masters and
moments, and the batch_norm running statistics replaced by the step's.
The eval forward's cast weights are dropped after every step, so
:meth:`Trainer.evaluate` scores the weights just trained.

Under ``compute_dtype = float16`` the loss is multiplied by the loss
scaler's scale before the backward (the scale rides the optimizer state,
``opt_state["_mp"]``) and the returned loss is divided back, as the JAX
package's ``_scaled_value_and_grad``; the optimizer unscales, tests and
skips (:mod:`cxxnet_tpu_torch.optim`).

Gradient accumulation (``update_period = p > 1``): an f32 tree of zeros
like the masters (``accum``, zeroed again on every load) sums each
step's gradients (loss-scaled sums under float16); the step that
completes a period hands ``accum / p`` to the optimizer and zeroes it.
``sample_counter`` counts the steps into the period, and
``epoch_counter``, which the schedules and rounds key on, advances once
per applied period. Loss and train metrics stay per step.

Chains (``train_chain = k``, :meth:`Trainer.update_chain_batches`): k
distinct host batches staged in one stacked upload, their k steps queued
with no host read between them (SGD and NAG; Adam under float16 reads
its skip flag once per apply), the k losses returned as one device
tensor: the same steps as k :meth:`Trainer.update` calls, the
accumulation riding across chain boundaries.

Input fold (``input_fold = auto|1|0``, on unless 0): a
``device_normalize`` batch (uint8 with its ``norm``, from an imgrec
pipeline) goes to the card as uint8, and the train step begins by
normalizing it into the compute dtype with the stem kernel
(``ops.fused_stem.decode_normalize``, the JAX package's in-step fold).
With ``input_fold = 0``, and always in :meth:`Trainer.evaluate`, the
uint8 batch is normalized eagerly in f32 on the card, as the JAX
package's ``_device_normalize`` does; under a float32 policy both give
the same bits. Under data parallelism each rank uploads and folds its
own rows.

Telemetry (``telemetry/``): :meth:`Trainer.stage_batch` is the
``train.h2d_stage`` span, :meth:`Trainer.update` the
``train.step_dispatch`` span and :meth:`Trainer.evaluate` the
``train.eval`` span, all free when tracing is off. The ``device.step``
failpoint poisons the masters and the loss with NaN after a step, as a
divergent step would; :meth:`Trainer.rollback` restores a verified
round and :meth:`Trainer.params_finite` guards checkpoint writes (the
loss sentinel in ``main.py``).

Model health (``health = 1``, the ``health_*`` keys; the JAX package's
trainer.py:180-190 and 1601-1640): a plain step also builds the health
tree of :func:`telemetry.modelhealth.step_health` from its gradients,
the masters around the apply and the layers' activation taps (under dp
the taps reduced over the ranks), kept on the device as
:attr:`Trainer.last_health_handle` with no host read, and stashes its
staged batch for :func:`telemetry.modelhealth.diagnose_nonfinite`. A
chain's steps carry no tree (a warning, once). ``health = 0`` adds
nothing to the step.

Train metrics are read one step late, as in the JAX package: step N's
top node is copied to the host after step N+1 was queued (a chain's k
steps after the next chain), so the copy does not stall the card. Rounds are ``%04d.model`` checkpoints in the
JAX layout with the optimizer state (``has_opt``: SGD's momentum tree,
Adam's ``m1``, ``m2`` and ``t``), which the JAX package loads and
resumes.

Data parallelism (``dp``, a :class:`~cxxnet_tpu_torch.parallel.DpContext`):
every rank draws the same global batch and keeps its rows
(``dp.rows``), the padded tail masked on the rank that holds it; the
loss divides by the global batch and batch_norm takes the global
batch's moments (``Network.dp``). After the backward, one all-reduce
sums a flat f32 buffer of every gradient leaf and the loss, so the
ranks' gradients add up to the global batch's and ``last_loss`` is the
global loss; each rank then applies the same update to its replica,
which stays bit-equal to the others. Under ``update_period`` the
all-reduce still runs every step, before the accumulation (the JAX
package's order, where the psum sits inside the gradient), and under
float16 the finiteness test reads the reduced gradients, so every rank
takes the same branch. Train and eval metrics are summed
over the ranks as (sum, cnt) pairs; rank 0 alone writes a round, after
a barrier.
"""

from __future__ import annotations

import os
import re
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import checkpoint as ckpt
from .config import (ConfigError, ConfigPairs, check_train_config,
                     parse_fused_mode, parse_health_config)
from .convert import opt_from_jax, opt_to_jax, params_from_jax, params_to_jax
from .graph import build_graph, global_param
from .io.data import DataBatch
from .metrics import MetricSet
from .model import Network
from .ops.fused_stem import decode_normalize, decode_normalize_reference
from .optim import Optimizer, leaves, tree_map, unflatten
from .parallel import DpContext, allreduce_metric_pairs
from .resilience import failpoints
from .telemetry import modelhealth
from .telemetry.trace import TRACER

_METRIC_RE = re.compile(r"^metric(?:\[([^,\]]+)(?:,([^\]]+))?\])?$")


class StagedBatch:
    """A host batch with this process's rows already on the device
    (:meth:`Trainer.stage_batch`): ``data`` the network's input (folded
    into the compute dtype for a train step, f32 for an eval forward),
    ``label`` f32 (None for an eval forward), ``extra`` the f32 values
    of the extra input nodes (``extra_data``), ``host`` the batch itself
    (its padding, labels and metric rows)."""
    __slots__ = ("host", "data", "label", "extra")

    def __init__(self, host: DataBatch, data: torch.Tensor,
                 label: Optional[torch.Tensor], extra=()):
        self.host = host
        self.data = data
        self.label = label
        self.extra = tuple(extra)


class Trainer:
    """Trainer over one :class:`Network`, on one device or as rank
    ``dp.rank`` of a data-parallel run on ``dp.device``. ``cfg`` is the
    global settings (iterator sections split off)."""

    def __init__(self, cfg: ConfigPairs, device: Optional[Any] = None,
                 dp: Optional[DpContext] = None):
        check_train_config(cfg)
        self.cfg = list(cfg)
        gp = lambda n, d: global_param(cfg, n, d)
        self.dp = dp
        if dp is not None:
            batch_size = int(gp("batch_size", "128"))
            if batch_size % dp.world:
                raise ValueError(
                    f"batch_size {batch_size} not divisible by data-parallel "
                    f"degree {dp.world}")
            device = dp.device
        self.graph = build_graph(cfg)
        self.net = Network(self.graph, cfg, device=device)
        self.net.dp = dp
        self.device = self.net.device
        self.eval_train = int(gp("eval_train", "1"))
        self.seed = int(gp("seed", "0"))
        self.silent = int(gp("silent", "0"))
        try:
            self.input_fold = parse_fused_mode(gp("input_fold", "auto")) \
                != "off"
        except ConfigError:
            raise ConfigError(f"input_fold must be one of auto|1|0 (got "
                              f"{gp('input_fold', 'auto')!r})") from None
        #: device-side (mean, factor) of the last batch's norm, by value
        self._norm_cache = None
        self.optimizer = Optimizer(self.graph.updater_type, cfg)
        self.metric = MetricSet()
        self.train_metric = MetricSet()
        for name, val in cfg:
            m = _METRIC_RE.match(name)
            if not m:
                continue
            label_field, node = m.group(1), m.group(2)
            if label_field is None or node is None:
                label_field, node = "label", None
            self.metric.add(val, label_field, node)
            self.train_metric.add(val, label_field, node)
        self._metric_nodes = sorted({n for n in self.metric.nodes if n})
        self.update_period = int(gp("update_period", "1"))
        self.epoch_counter = 0          # applied updates (schedules key)
        self.sample_counter = 0         # steps into the update period
        self.round_counter = 0
        self.step_count = 0
        self.params = None
        self.opt_state = None
        #: f32 gradient sums of the period so far (update_period > 1)
        self.accum: Optional[Dict] = None
        self._last_loss: Optional[torch.Tensor] = None
        #: (metric nodes, batch) of the steps whose metrics are unread
        self._pending_metric: List[Tuple[Dict, DataBatch]] = []
        self._ones: Optional[torch.Tensor] = None
        #: called with the trainer after every update (timing, tests)
        self.step_hook: Optional[Callable[["Trainer"], None]] = None
        self.health_cfg = parse_health_config(cfg)
        self.health_on = bool(self.health_cfg.enabled)
        #: the last plain step's health tree (device scalars) and its
        #: staged batch (data, label, mask, extra, step) for the
        #: provenance walk
        self._last_health = None
        self._health_batch = None
        self._warned_health_chain = False
        if self.net.fused_mode == "off" and not self.silent and (
                dp is None or dp.is_main):
            print("fused_kernels = 0: this trainer computes the plain "
                  "PyTorch versions of the kernels", flush=True)

    # -- weights --------------------------------------------------------------
    def init_model(self, weights: Optional[Tuple[Dict, Dict]] = None) -> None:
        """Fresh weights and optimizer state on the device. ``weights``
        is a JAX-layout ``(params, state)`` pair of numpy arrays, carried
        in by ``convert.params_from_jax``; without it the layers' own
        init draws them from a CPU generator seeded with ``seed``."""
        if weights is None:
            weights = params_to_jax(
                *self.net.init(torch.Generator().manual_seed(self.seed)))
        self._place(*params_from_jax(*weights), opt=None)

    def _place(self, params: Dict, state: Dict, opt: Optional[Dict]) -> None:
        self.net.load_weights(params, state)
        self.params = self.net.params
        for _, v in leaves(self.params):
            v.requires_grad_(True)
        self._init_accum()
        fresh = self.optimizer.init_state(self.params)
        if opt is None:
            self.opt_state = fresh
            return
        if set(opt) - {"_mp"} != set(fresh) - {"_mp"}:
            raise ValueError(f"optimizer state {sorted(opt)} does not match "
                             f"updater = {self.optimizer.type}")
        want = {p for p, _ in leaves(self.params)}
        self.opt_state = {}
        for name, tree in opt.items():
            if name == "t":
                self.opt_state["t"] = torch.as_tensor(tree).to(torch.int32)
                continue
            if name == "_mp":
                self.opt_state["_mp"] = {
                    k: torch.as_tensor(np.asarray(tree[k])).reshape(())
                    .to(self.device, dt) for k, dt in
                    (("scale", torch.float32), ("good", torch.int32))}
                continue
            if {p for p, _ in leaves(tree)} != want:
                raise ValueError("optimizer state does not match the net's "
                                 "parameters")
            self.opt_state[name] = tree_map(
                lambda v: torch.as_tensor(v).to(self.device, torch.float32)
                .contiguous(), tree)
        # rounds are policy-portable: the float16 loss scaler is injected
        # or dropped to match this trainer's compute_dtype
        self.opt_state = self.optimizer.adapt_state(self.opt_state,
                                                    self.device)

    def _init_accum(self) -> None:
        """A zero f32 accumulator like the masters (update_period > 1)."""
        self.accum = None if self.update_period <= 1 else tree_map(
            lambda v: torch.zeros_like(v, dtype=torch.float32,
                                       requires_grad=False), self.params)

    def load_blob(self, blob: Dict[str, Any]) -> None:
        """Restore params, layer state, optimizer state and counters from
        a round read by ``checkpoint.load_model`` (JAX layout)."""
        ckpt.check_structure(blob["meta"], self.graph.structure_signature())
        p, s = params_from_jax(blob["params"], blob["state"])
        opt = blob.get("opt")
        self._place(p, s, None if opt is None else opt_from_jax(opt))
        meta = blob["meta"]
        self.round_counter = meta["round"]
        self.epoch_counter = meta["epoch"]
        self.step_count = int(meta.get("step_count", 0))
        self.optimizer.lr_scale = float(meta.get("lr_scale", 1.0))

    def load_model(self, path: str) -> None:
        """Restore a round from ``path`` (:meth:`load_blob`)."""
        self.load_blob(ckpt.load_model(path))

    def copy_model_from(self, path: str) -> None:
        """Finetune's restore: the layers of the round at ``path`` whose
        name and leaf shapes match this net's replace the current (fresh)
        params (``checkpoint.copy_model_from``, which prints a line a
        layer unless ``silent``); layer state, optimizer state and
        counters stay as they are."""
        blob = ckpt.load_model(path)
        fresh = params_to_jax(self.params, {})[0]
        self._set_params(ckpt.copy_model_from(
            fresh, blob["params"], verbose=not self.silent and (
                self.dp is None or self.dp.is_main)))

    def _set_params(self, params_jax: Dict) -> None:
        """Replace the masters by a JAX-layout params tree, keeping the
        layer state and the optimizer state."""
        self.net.load_weights(params_from_jax(params_jax, {})[0],
                              self.net.state)
        self.params = self.net.params
        for _, v in leaves(self.params):
            v.requires_grad_(True)

    # -- weights API (the JAX package's get_weight / set_weight) -------------
    @staticmethod
    def _walk(tree, layer_name: str, tag: str):
        """The leaf of ``tree`` at ``layer_name`` and ``tag``, a dotted
        path into a nested layer (``q.wmat`` of an mha layer)."""
        node = tree[layer_name]
        for part in tag.split("."):
            node = node[part]
        return node

    def get_weight(self, layer_name: str, tag: str) -> np.ndarray:
        """A master weight as float32 numpy in the JAX package's layout
        (a conv ``wmat`` HWIO), as the JAX package's get_weight gives it."""
        layer = params_to_jax({layer_name: self.params[layer_name]}, {})[0]
        return self._walk(layer, layer_name, tag)

    def set_weight(self, weight: np.ndarray, layer_name: str,
                   tag: str) -> None:
        self.set_weights({(layer_name, tag): weight})

    def set_weights(self, updates) -> None:
        """Assign weights given in the JAX layout, ``updates`` mapping
        (layer, dotted tag) to an array; a shape that differs from the
        current weight's raises before anything changes."""
        p = params_to_jax(self.params, {})[0]
        for (layer, tag), w in updates.items():
            cur = self._walk(p, layer, tag)
            if tuple(np.shape(w)) != tuple(cur.shape):
                raise ValueError(
                    f"set_weight {layer}.{tag}: shape {np.shape(w)} != "
                    f"{tuple(cur.shape)}")
        for (layer, tag), w in updates.items():
            parts = tag.split(".")
            node = p[layer]
            for part in parts[:-1]:
                node = node[part]
            node[parts[-1]] = np.asarray(w, dtype=node[parts[-1]].dtype)
        self._set_params(p)

    def save_model(self, path: str) -> None:
        """Write the current round with its optimizer state (``has_opt``).
        Under dp rank 0 writes it between two barriers: once every rank
        got here, and before any rank goes on."""
        if self.dp is not None:
            self.dp.barrier()
            try:
                if self.dp.is_main:
                    self._write(path)
            finally:
                self.dp.barrier()
            return
        self._write(path)

    def _write(self, path: str) -> None:
        params, state = params_to_jax(self.params, self.net.state)
        ckpt.save_model(path, structure_sig=self.graph.structure_signature(),
                        round_counter=self.round_counter,
                        epoch_counter=self.epoch_counter, params=params,
                        net_state=state, opt_state=opt_to_jax(self.opt_state),
                        step_count=self.step_count,
                        lr_scale=self.optimizer.lr_scale)

    def start_round(self, round_counter: int) -> None:
        self.round_counter = round_counter

    # -- training ---------------------------------------------------------
    def _rows(self, batch: DataBatch) -> Tuple[slice, int]:
        """This process's rows of ``batch`` and how many of them are real
        (not padding): all of them on one device, ``dp.rows`` under dp."""
        n, n_real = batch.batch_size, batch.batch_size - batch.num_batch_padd
        rows = slice(0, n) if self.dp is None else self.dp.rows(n)
        return rows, min(max(n_real - rows.start, 0), rows.stop - rows.start)

    def _upload(self, a: np.ndarray, dtype) -> torch.Tensor:
        """A host array on the device as ``dtype`` (pinned and
        non-blocking onto a card)."""
        t = torch.from_numpy(np.ascontiguousarray(a, dtype))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _norm_consts(self, norm: dict):
        """The device-side mean (or None) and the factor of a batch's
        ``norm``, cached by value. The factor is ``scale / divideby``
        taken in double and rounded to float32, as the JAX package's."""
        mean = norm.get("mean")
        div = float(norm.get("divideby", 1.0))
        scale = float(norm.get("scale", 1.0))
        key = (None if mean is None else
               (np.shape(mean), np.asarray(mean, np.float32).tobytes()),
               div, scale)
        if self._norm_cache is None or self._norm_cache[0] != key:
            mean_c = None if mean is None else self._upload(mean, np.float32)
            self._norm_cache = (key, mean_c, np.float32(scale / div))
        return self._norm_cache[1], self._norm_cache[2]

    def _input(self, batch: DataBatch, fold: bool) -> torch.Tensor:
        """This process's rows of ``batch.data`` as the network's input on
        the device (:meth:`_stage_input`)."""
        rows, _ = self._rows(batch)
        return self._stage_input(np.asarray(batch.data)[rows], batch.norm,
                                 fold)

    def _extras(self, batch: DataBatch) -> Tuple[torch.Tensor, ...]:
        """This process's rows of the first ``extra_data_num`` arrays of
        ``batch.extra_data`` on the device as f32, one upload an array (a
        net without extra inputs ignores them, as the JAX package's)."""
        n = self.graph.extra_data_num
        if len(batch.extra_data) < n:
            raise ValueError(f"the net takes {n} extra_data input(s) and "
                             f"the batch carries {len(batch.extra_data)}")
        rows, _ = self._rows(batch)
        return tuple(self._upload(np.asarray(e)[rows], np.float32)
                     for e in batch.extra_data[:n])

    def _stage_input(self, data: np.ndarray, norm: Optional[dict],
                     fold: bool) -> torch.Tensor:
        """Host rows (any leading axes before the NHWC or flat ones) on the
        device as the network's input. A uint8 array crosses as uint8;
        with ``fold`` and ``input_fold`` on, ``norm`` is applied into the
        compute dtype by :func:`decode_normalize` (the stem kernel when
        the kernels are on), else eagerly into f32 (no ``norm``: a plain
        cast)."""
        if data.dtype != np.uint8:
            return self._upload(data, np.float32)
        x = self._upload(data, np.uint8)
        if norm is None:
            return x.to(torch.float32)
        mean, factor = self._norm_consts(norm)
        if fold and self.input_fold:
            lead = x.shape[:-3]
            y = decode_normalize(x.reshape((-1,) + x.shape[-3:]), mean,
                                 factor, self.net.compute_dtype,
                                 fused=self.net.fused)
            return y.reshape(lead + y.shape[1:])
        return decode_normalize_reference(x, mean, factor, torch.float32)

    def stage_batch(self, batch, for_eval: bool = False) -> StagedBatch:
        """This process's rows of a host batch on the device (the
        ``train.h2d_stage`` span; the copies themselves are
        asynchronous): the input folded for a train step or in f32 for
        ``for_eval``, and the labels of a train step. A batch staged
        already comes back as it is."""
        if not TRACER.enabled:
            return self._stage_batch(batch, for_eval)
        with TRACER.span("train.h2d_stage", cat="train"):
            return self._stage_batch(batch, for_eval)

    def _stage_batch(self, batch, for_eval: bool) -> StagedBatch:
        if isinstance(batch, StagedBatch):
            return batch
        if for_eval:
            return StagedBatch(batch, self._input(batch, fold=False), None,
                               self._extras(batch))
        rows, _ = self._rows(batch)
        return StagedBatch(batch, self._input(batch, fold=True),
                           self._upload(batch.label[rows], np.float32),
                           self._extras(batch))

    def _mask(self, batch: DataBatch) -> torch.Tensor:
        """This process's rows: real 1, padded 0. The all-ones mask of
        every full batch is made once per batch size on the device (no
        upload)."""
        rows, n_real = self._rows(batch)
        n = rows.stop - rows.start
        if n_real == n:
            if self._ones is None or self._ones.shape[0] != n:
                self._ones = torch.ones((n,), dtype=torch.float32,
                                        device=self.device)
            return self._ones
        mask = torch.ones((n,), dtype=torch.float32)
        mask[n_real:] = 0.0
        return mask.to(self.device)

    def gradients(self, batch: DataBatch):
        """The forward and backward of one minibatch, changing nothing:
        ``(loss, new_state, nodes, grads)``, ``grads`` in the params'
        tree layout (f32; multiplied by the loss scale under float16)."""
        if self.params is None:
            raise RuntimeError("call init_model() first")
        staged = self.stage_batch(batch)
        return self._forward_backward(staged.data, staged.label,
                                      self._mask(staged.host), staged.extra)

    def _forward_backward(self, data: torch.Tensor, label: torch.Tensor,
                          mask: torch.Tensor, extra=(), health_sink=None):
        """:meth:`gradients` of staged inputs. Under float16 the summed
        loss is multiplied by the scale before the backward and the
        returned loss divided back (exact: the scale is a power of
        two). ``health_sink`` collects the activation taps."""
        loss, new_state, nodes = self.net.apply(
            self.params, self.net.state, data, label, mask,
            train=True, capture_nodes=bool(self._metric_nodes),
            step=self.step_count, extra_data=extra,
            health_sink=health_sink)
        mp = self.opt_state.get("_mp")
        if mp is not None:
            loss = loss * mp["scale"]
        flat = leaves(self.params)
        grads = torch.autograd.grad(loss, [v for _, v in flat])
        if mp is not None:
            loss = loss.detach() / mp["scale"]
        return loss, new_state, nodes, unflatten(
            (p, g) for (p, _), g in zip(flat, grads))

    def _allreduce(self, loss: torch.Tensor, gtree):
        """One all-reduce (sum over the ranks) of a flat f32 buffer of
        every gradient leaf and the loss: the global batch's gradients
        and loss."""
        flat = leaves(gtree)
        buf = torch.cat([g.reshape(-1) for _, g in flat]
                        + [loss.detach().reshape(1)])
        self.dp.all_reduce(buf)
        out, o = [], 0
        for p, g in flat:
            out.append((p, buf[o:o + g.numel()].view_as(g)))
            o += g.numel()
        return buf[o], unflatten(out)

    def _step(self, data: torch.Tensor, label: torch.Tensor,
              mask: torch.Tensor, extra=(), health: bool = False):
        """One step on staged inputs: forward, backward, the all-reduce
        under dp, then the optimizer's apply, or under ``update_period``
        the accumulation and, at the period's end, the apply of ``accum
        / period``. Advances the counters; returns the loss (on the
        device) and the step's nodes. Reads nothing back to the host
        (but Adam's skip flag under float16). ``health``: the step also
        leaves its health tree in ``_last_health`` (no host read)."""
        sink = {} if health else None
        step = self.step_count
        loss, new_state, nodes, gtree = self._forward_backward(
            data, label, mask, extra, health_sink=sink)
        if self.dp is not None:
            loss, gtree = self._allreduce(loss, gtree)
        if health:
            mp = self.opt_state.get("_mp")
            scale_in = None if mp is None else mp["scale"].clone()
            before = tree_map(lambda v: v.detach().clone(), self.params)
        sched = self.optimizer.schedules(self.epoch_counter)
        period = self.update_period
        if period > 1:
            acc = [a for _, a in leaves(self.accum)]
            torch._foreach_add_(acc, [g for _, g in leaves(gtree)])
            if (self.sample_counter + 1) % period == 0:
                self.optimizer.update(
                    self.params, tree_map(lambda a: a / period, self.accum),
                    self.opt_state, sched)
                torch._foreach_zero_(acc)
        else:
            self.optimizer.update(self.params, gtree, self.opt_state, sched)
        if health:
            mp = self.opt_state.get("_mp")
            self._last_health = modelhealth.step_health(
                gtree, before, self.params, scale_in,
                None if mp is None else mp["scale"],
                modelhealth.reduce_island(sink, self.dp))
            self._health_batch = (data, label, mask, tuple(extra), step)
        self.net.state = new_state
        self.net.invalidate_cast()
        self.step_count += 1
        self.sample_counter += 1
        if self.sample_counter >= period:
            self.sample_counter = 0
            self.epoch_counter += 1
        return loss.detach(), nodes

    def _metric_values(self, nodes) -> Dict[Optional[str], torch.Tensor]:
        """The nodes the train metrics read, of one step's nodes."""
        return {n: nodes[n if n is not None else self.net.top_node()]
                .detach() for n in set(self.train_metric.nodes)}

    def update(self, batch) -> None:
        """One minibatch forward, backward and optimizer step (under
        ``update_period``: the accumulation, and the apply at the
        period's end) of a host batch or a :class:`StagedBatch`. An
        armed ``device.step`` failpoint then poisons the masters and the
        loss with NaN (``CXXNET_NAN_LAYER = <layer>`` confines it to one
        layer's masters), as the JAX package's trainer does."""
        if self.params is None:
            raise RuntimeError("call init_model() first")
        t_dispatch0 = time.perf_counter()
        staged = self.stage_batch(batch)
        batch = staged.host
        self._last_loss, nodes = self._step(staged.data, staged.label,
                                            self._mask(batch), staged.extra,
                                            health=self.health_on)
        if failpoints.fire("device.step"):
            self._poison()
        if self.eval_train:
            self._drain_pending_metric()
            self._pending_metric = [(self._metric_values(nodes), batch)]
        TRACER.add_complete("train.step_dispatch", t_dispatch0,
                            time.perf_counter(), cat="train",
                            args={"step": self.step_count})
        if self.step_hook is not None:
            self.step_hook(self)

    def _poison(self) -> None:
        """The injected bad step: NaN into the masters (of the layer
        ``CXXNET_NAN_LAYER`` names, else all) and into the loss."""
        target = os.environ.get("CXXNET_NAN_LAYER", "")
        if target and target not in self.params:
            raise ValueError(
                "CXXNET_NAN_LAYER=%r names no param layer (have: %s)"
                % (target, ", ".join(sorted(self.params))))
        tree = {target: self.params[target]} if target else self.params
        with torch.no_grad():
            for _, v in leaves(tree):
                v.add_(float("nan"))
        self.net.invalidate_cast()
        self._last_loss = torch.full_like(self._last_loss, float("nan"))

    def params_finite(self) -> bool:
        """Whether every master is finite (one host read). Guards
        checkpoint writes: a step whose apply poisoned the masters after
        a finite loss must not be written, or every rollback would
        restore NaN."""
        with torch.no_grad():
            ok = torch.stack([torch.isfinite(v).all()
                              for _, v in leaves(self.params)]).all()
        return bool(ok)

    def rollback(self, path: str,
                 blob: Optional[Dict[str, Any]] = None) -> int:
        """Restore masters, layer state, optimizer state, counters and
        the LR scale from a verified round (the sentinel's recovery),
        from ``blob`` when the scan already read it, and drop what the
        poisoned steps left: the period's accumulation (zeroed by the
        load), the last loss and the unread train metrics. Returns the
        restored round."""
        self.load_blob(blob if blob is not None else ckpt.load_model(path))
        self.sample_counter = 0
        self._last_loss = None
        self._pending_metric = []
        # the poisoned step's health tree and stash (the provenance walk
        # ran before the rollback)
        self._last_health = None
        self._health_batch = None
        return self.round_counter

    def update_chain_batches(self, batches) -> torch.Tensor:
        """``len(batches)`` steps on distinct host batches, the same steps
        as that many :meth:`update` calls (per-batch padding masks, the
        draws of each step, the schedule of each step's epoch counter,
        the accumulation across chain boundaries): the batches staged in
        one stacked upload of the data and one of the labels (their
        ``norm`` shared, as in the JAX package), the steps queued with no
        host read between them. Returns the steps' losses as one device
        tensor. The chain's train metrics are read after the next chain
        or step was queued; ``step_hook`` is called once, after the
        chain."""
        if self.params is None:
            raise RuntimeError("call init_model() first")
        if self.health_on and not self._warned_health_chain:
            self._warned_health_chain = True
            print("WARNING: health=1 does not ride train chains; "
                  "model-health stats are unavailable for this "
                  "configuration", flush=True)
        k = len(batches)
        if k == 0:
            raise ValueError("update_chain_batches: empty batch list")
        norms = {None if b.norm is None else (
            None if b.norm.get("mean") is None else
            np.asarray(b.norm["mean"], np.float32).tobytes(),
            float(b.norm.get("divideby", 1.0)),
            float(b.norm.get("scale", 1.0))) for b in batches}
        if len(norms) != 1:
            raise ValueError("update_chain_batches: batches carry "
                             "different deferred-norm metadata")
        rows, _ = self._rows(batches[0])
        data = self._stage_input(
            np.stack([np.asarray(b.data)[rows] for b in batches]),
            batches[0].norm, fold=True)
        labels = self._upload(
            np.stack([np.asarray(b.label)[rows] for b in batches]),
            np.float32)
        extras = [self._upload(np.stack([np.asarray(b.extra_data[j])[rows]
                                         for b in batches]), np.float32)
                  for j in range(self.graph.extra_data_num)]
        losses, pending = [], []
        for i, b in enumerate(batches):
            loss, nodes = self._step(data[i], labels[i], self._mask(b),
                                     tuple(e[i] for e in extras))
            losses.append(loss)
            if self.eval_train:
                pending.append((self._metric_values(nodes), b))
        losses = torch.stack(losses)
        self._last_loss = losses[-1]
        if self.eval_train:
            self._drain_pending_metric()
            self._pending_metric = pending
        if self.step_hook is not None:
            self.step_hook(self)
        return losses

    @property
    def last_loss(self) -> float:
        """The last step's loss (a host sync), NaN before the first."""
        return float(self._last_loss) if self._last_loss is not None \
            else float("nan")

    @property
    def last_loss_tensor(self) -> Optional[torch.Tensor]:
        """The last step's loss on the device (no sync)."""
        return self._last_loss

    @property
    def last_health_handle(self):
        """The last plain step's health tree as device scalars (None with
        ``health = 0`` or before the first step); the round loop's
        ``HealthProbe`` reads it once an interval."""
        return self._last_health

    # -- metrics / evaluation -------------------------------------------------
    def _add_metric(self, mset: MetricSet,
                    nodes: Dict[Optional[str], torch.Tensor],
                    batch: DataBatch) -> None:
        rows, n_real = self._rows(batch)
        if n_real <= 0:
            return
        vals = {k: v.float().cpu().numpy().reshape(v.shape[0], -1)[:n_real]
                for k, v in nodes.items()}
        labels = {k: np.asarray(batch.label)[rows][:n_real] for k in nodes}
        slices = {name: self.graph.label_slice(name)
                  for name in self.graph.label_name_map}
        mset.add_eval(vals, labels, slices)

    def _drain_pending_metric(self) -> None:
        pending, self._pending_metric = self._pending_metric, []
        for nodes, batch in pending:
            self._add_metric(self.train_metric, nodes, batch)

    def _report(self, mset: MetricSet, name: str) -> str:
        """The round-line fragment of ``mset``, its (sum, cnt) pairs
        summed over the ranks under dp."""
        mset.load_pairs(allreduce_metric_pairs(mset.pairs(), self.dp))
        return "".join("\t%s:%f" % (m, v) for m, v in mset.get(name))

    def evaluate(self, data_iter, name: str) -> str:
        """All metrics over ``data_iter`` with the eval forward (the
        ``train.eval`` span); returns the round-line fragment
        ``\\tname-metric:value``."""
        self.metric.clear()
        need = set(self.metric.nodes)
        with TRACER.span("train.eval", cat="train", args={"set": name}):
            for batch in data_iter:
                staged = self.stage_batch(batch, for_eval=True)
                res = self.net(staged.data, capture_nodes=any(
                    n is not None for n in need), extra_data=staged.extra)
                nodes = {n: (res.out if n is None else res.nodes[n])
                         for n in need}
                self._add_metric(self.metric, nodes, batch)
        return self._report(self.metric, name)

    # -- inference (the batch tasks) -----------------------------------------
    def _eval_rows(self, batch: DataBatch,
                   node: Optional[str] = None) -> np.ndarray:
        """The eval forward of :meth:`evaluate` over ``batch`` (uint8
        batches normalized eagerly in f32): the value of ``node`` (the
        last node when None) as float32 rows, each flattened in NHWC
        order as the JAX package's node, the padded rows dropped."""
        res = self.net(self._input(batch, fold=False),
                       capture_nodes=node is not None,
                       extra_data=self._extras(batch))
        v = res.out if node is None else res.nodes[node]
        _, n_real = self._rows(batch)
        return v.reshape(v.shape[0], -1)[:n_real].float().cpu().numpy()

    def predict(self, batch: DataBatch) -> np.ndarray:
        """Class ids (float32) of the real rows: the argmax of the top
        node, or its value where the top node has one column."""
        out = self._eval_rows(batch)
        if out.shape[1] != 1:
            return np.argmax(out, axis=1).astype(np.float32)
        return out[:, 0]

    def predict_raw(self, batch: DataBatch) -> np.ndarray:
        """The top node's rows (softmax probabilities) of the real rows."""
        return self._eval_rows(batch)

    def _node(self, node_name: str) -> Optional[str]:
        """None for the top node ('top' or 'top[-1]'), else the node's
        name, which must be one of the graph's."""
        if node_name in ("top", "top[-1]"):
            return None
        if node_name not in self.graph.node_names:
            raise ValueError(f"unknown node name {node_name!r}")
        return node_name

    def node_shape(self, node_name: str) -> Tuple[int, int, int]:
        """The (c, y, x) shape of one instance at a node ('top' = the
        last node), as the extract task's ``.meta`` writes it."""
        node = self._node(node_name)
        if node is None:
            return tuple(self.net.out_shape())
        return tuple(self.net.node_shapes[self.graph.node_names.index(node)])

    def extract_feature(self, batch: DataBatch,
                        node_name: str) -> np.ndarray:
        """The value of a node by name ('top' = the last node) as one
        row an instance, in the JAX package's NHWC element order."""
        return self._eval_rows(batch, self._node(node_name))

    def train_metric_report(self, name: str = "train") -> str:
        self._drain_pending_metric()
        out = self._report(self.train_metric, name)
        self.train_metric.clear()
        return out
