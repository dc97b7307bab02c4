"""Trainer: one device or one data-parallel rank, SGD / NAG / Adam (the
port of ``cxxnet_tpu/trainer.py``'s single-device and dp paths).

A step is the JAX package's ``_make_train_step`` body ``one``
(trainer.py:1620-1650) without model health, chains or gradient
accumulation: the differentiable forward :meth:`Network.apply` over the
f32 masters, ``torch.autograd.grad`` of the summed loss, then the
optimizer's in-place update of the masters and moments, and the
batch_norm running statistics replaced by the step's. The eval
forward's cast weights are dropped after every update, so
:meth:`Trainer.evaluate` scores the weights just trained.

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

Train metrics are read one step late, as in the JAX package: step N's
top node is copied to the host after step N+1 was queued, so the copy
does not stall the card. Rounds are ``%04d.model`` checkpoints in the
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
which stays bit-equal to the others. Train and eval metrics are summed
over the ranks as (sum, cnt) pairs; rank 0 alone writes a round, after
a barrier.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from . import checkpoint as ckpt
from .config import (ConfigError, ConfigPairs, check_train_config,
                     parse_fused_mode)
from .convert import opt_from_jax, opt_to_jax, params_from_jax, params_to_jax
from .graph import build_graph, global_param
from .io.data import DataBatch
from .metrics import MetricSet
from .model import Network
from .ops.fused_stem import decode_normalize, decode_normalize_reference
from .optim import Optimizer, leaves, tree_map, unflatten
from .parallel import DpContext, allreduce_metric_pairs

_METRIC_RE = re.compile(r"^metric(?:\[([^,\]]+)(?:,([^\]]+))?\])?$")


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
        self.epoch_counter = 0          # applied updates (schedules key)
        self.round_counter = 0
        self.step_count = 0
        self.params = None
        self.opt_state = None
        self._last_loss: Optional[torch.Tensor] = None
        self._pending_metric = None
        self._ones: Optional[torch.Tensor] = None
        #: called with the trainer after every update (timing, tests)
        self.step_hook: Optional[Callable[["Trainer"], None]] = None
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
        fresh = self.optimizer.init_state(self.params)
        if opt is None:
            self.opt_state = fresh
            return
        if set(opt) != set(fresh):
            raise ValueError(f"optimizer state {sorted(opt)} does not match "
                             f"updater = {self.optimizer.type}")
        want = {p for p, _ in leaves(self.params)}
        self.opt_state = {}
        for name, tree in opt.items():
            if name == "t":
                self.opt_state["t"] = torch.as_tensor(tree).to(torch.int32)
                continue
            if {p for p, _ in leaves(tree)} != want:
                raise ValueError("optimizer state does not match the net's "
                                 "parameters")
            self.opt_state[name] = tree_map(
                lambda v: torch.as_tensor(v).to(self.device, torch.float32)
                .contiguous(), tree)

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

    def save_model(self, path: str) -> None:
        """Write the current round with its optimizer state (``has_opt``).
        Under dp rank 0 writes it between two barriers: once every rank
        got here, and before any rank goes on."""
        if self.dp is not None:
            self.dp.barrier()
            if self.dp.is_main:
                self._write(path)
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
        the device. A uint8 batch crosses as uint8; with ``fold`` and
        ``input_fold`` on, its ``norm`` is applied into the compute dtype
        by :func:`decode_normalize` (the stem kernel when the kernels are
        on), else eagerly into f32 (no ``norm``: a plain cast)."""
        rows, _ = self._rows(batch)
        data = np.asarray(batch.data)[rows]
        if data.dtype != np.uint8:
            return self._upload(data, np.float32)
        x = self._upload(data, np.uint8)
        if batch.norm is None:
            return x.to(torch.float32)
        mean, factor = self._norm_consts(batch.norm)
        if fold and self.input_fold:
            return decode_normalize(x, mean, factor, self.net.compute_dtype,
                                    fused=self.net.fused)
        return decode_normalize_reference(x, mean, factor, torch.float32)

    def _to_device(self, batch: DataBatch):
        rows, _ = self._rows(batch)
        return (self._input(batch, fold=True),
                self._upload(batch.label[rows], np.float32))

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
        tree layout (f32)."""
        if self.params is None:
            raise RuntimeError("call init_model() first")
        data, label = self._to_device(batch)
        loss, new_state, nodes = self.net.apply(
            self.params, self.net.state, data, label, self._mask(batch),
            train=True, capture_nodes=bool(self._metric_nodes),
            step=self.step_count)
        flat = leaves(self.params)
        grads = torch.autograd.grad(loss, [v for _, v in flat])
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

    def update(self, batch: DataBatch) -> None:
        """One minibatch forward, backward and optimizer step."""
        loss, new_state, nodes, gtree = self.gradients(batch)
        if self.dp is not None:
            loss, gtree = self._allreduce(loss, gtree)
        self.optimizer.update(self.params, gtree, self.opt_state,
                              self.optimizer.schedules(self.epoch_counter))
        self.net.state = new_state
        self.net.invalidate_cast()
        self._last_loss = loss.detach()
        self.step_count += 1
        self.epoch_counter += 1
        if self.eval_train:
            self._drain_pending_metric()
            self._pending_metric = (
                {n: nodes[n if n is not None else self.net.top_node()]
                 .detach() for n in set(self.train_metric.nodes)}, batch)
        if self.step_hook is not None:
            self.step_hook(self)

    @property
    def last_loss(self) -> float:
        """The last step's loss (a host sync), NaN before the first."""
        return float(self._last_loss) if self._last_loss is not None \
            else float("nan")

    @property
    def last_loss_tensor(self) -> Optional[torch.Tensor]:
        """The last step's loss on the device (no sync)."""
        return self._last_loss

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
        if self._pending_metric is not None:
            nodes, batch = self._pending_metric
            self._pending_metric = None
            self._add_metric(self.train_metric, nodes, batch)

    def _report(self, mset: MetricSet, name: str) -> str:
        """The round-line fragment of ``mset``, its (sum, cnt) pairs
        summed over the ranks under dp."""
        mset.load_pairs(allreduce_metric_pairs(mset.pairs(), self.dp))
        return "".join("\t%s:%f" % (m, v) for m, v in mset.get(name))

    def evaluate(self, data_iter, name: str) -> str:
        """All metrics over ``data_iter`` with the eval forward; returns
        the round-line fragment ``\\tname-metric:value``."""
        self.metric.clear()
        need = set(self.metric.nodes)
        for batch in data_iter:
            data = self._input(batch, fold=False)
            res = self.net(data, capture_nodes=any(n is not None
                                                   for n in need))
            nodes = {n: (res.out if n is None else res.nodes[n])
                     for n in need}
            self._add_metric(self.metric, nodes, batch)
        return self._report(self.metric, name)

    def train_metric_report(self, name: str = "train") -> str:
        self._drain_pending_metric()
        out = self._report(self.train_metric, name)
        self.train_metric.clear()
        return out
