"""Evaluation metrics: rmse, error, logloss, rec@n, seq_error.

The port's own copy of ``cxxnet_tpu/metrics.py``: metrics accumulate
(sum, count) host-side over numpy prediction/label slices; padded rows
(num_batch_padd) are excluded by the caller passing only real rows. A
data-parallel run sums the (sum, count) pairs over its ranks
(``MetricSet.pairs`` / ``load_pairs``), as the JAX package's
allreduce does.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import numpy as np


class Metric:
    def __init__(self, name: str, label_field: str):
        self.name = name
        self.label_field = label_field
        self.sum = 0.0
        self.cnt = 0

    def clear(self) -> None:
        self.sum, self.cnt = 0.0, 0

    def add(self, pred: np.ndarray, label: np.ndarray) -> None:
        """pred: (n, k) scores; label: (n, w)."""
        raise NotImplementedError

    def get(self) -> float:
        return self.sum / max(self.cnt, 1)


class MetricRMSE(Metric):
    def add(self, pred, label):
        self.sum += float(np.sum((pred - label) ** 2))
        self.cnt += pred.shape[0]


class MetricError(Metric):
    """Classification error: argmax vs label when pred has >1 column and
    label_width==1; sign threshold at 0 otherwise (metric.h:104-136)."""

    def add(self, pred, label):
        n = pred.shape[0]
        if label.shape[1] != 1:
            guess = (pred > 0.0).astype(np.int64)
            err = np.mean(guess != label.astype(np.int64), axis=1)
            self.sum += float(np.sum(err))
        elif pred.shape[1] != 1:
            guess = np.argmax(pred, axis=1)
            self.sum += float(np.sum(guess != label[:, 0].astype(np.int64)))
        else:
            guess = (pred[:, 0] > 0.0).astype(np.int64)
            self.sum += float(np.sum(guess != label[:, 0].astype(np.int64)))
        self.cnt += n


class MetricLogloss(Metric):
    def add(self, pred, label):
        n = pred.shape[0]
        p = np.clip(pred, 1e-15, 1 - 1e-15)
        if label.shape[1] != 1:
            t = label.astype(np.float64)
            ll = -(t * np.log(p[:, :1]) + (1 - t) * np.log(1 - p[:, :1]))
            self.sum += float(np.sum(np.mean(ll, axis=1)))
        elif pred.shape[1] != 1:
            idx = label[:, 0].astype(np.int64)
            self.sum += float(np.sum(-np.log(p[np.arange(n), idx])))
        else:
            t = label[:, 0].astype(np.float64)
            self.sum += float(np.sum(-(t * np.log(p[:, 0]) +
                                       (1 - t) * np.log(1 - p[:, 0]))))
        self.cnt += n


class MetricRecall(Metric):
    """rec@n: fraction of rows whose true label is within the top-n scores
    (metric.h:170-200)."""

    def __init__(self, name, label_field):
        super().__init__(name, label_field)
        m = re.match(r"rec@(\d+)$", name)
        if not m:
            raise ValueError(f"bad recall metric name {name!r}")
        self.topn = int(m.group(1))

    def add(self, pred, label):
        n = pred.shape[0]
        if pred.shape[1] < self.topn:
            raise ValueError(
                f"rec@{self.topn} on prediction list of length {pred.shape[1]}")
        top = np.argsort(-pred, axis=1)[:, :self.topn]
        # every label column counts; per-row score = hits / label count
        # (reference metric.h:170-200 loops all label fields)
        idx = label.astype(np.int64)                    # (n, w)
        hits = np.any(top[:, None, :] == idx[:, :, None], axis=2)  # (n, w)
        self.sum += float(np.sum(hits.mean(axis=1)))
        self.cnt += n


class MetricSeqError(Metric):
    """Per-token classification error for sequence models: pred is the
    flattened (n, S*V) per-token scores, label is (n, S) token ids (V
    inferred as pred_cols // label_cols)."""

    def add(self, pred, label):
        n, S = label.shape
        V = pred.shape[1] // S
        guess = np.argmax(pred.reshape(n, S, V), axis=2)
        self.sum += float(np.sum(guess != label.astype(np.int64)))
        self.cnt += n * S


def create_metric(name: str, label_field: str) -> Metric:
    if name == "seq_error":
        return MetricSeqError(name, label_field)
    if name == "rmse":
        return MetricRMSE(name, label_field)
    if name == "error":
        return MetricError(name, label_field)
    if name == "logloss":
        return MetricLogloss(name, label_field)
    if name.startswith("rec@"):
        return MetricRecall(name, label_field)
    raise ValueError(f"unknown metric {name!r}")


class MetricSet:
    """Set of metrics, each bound to a (label_field, node) pair.

    Config syntax handled by the trainer:
      ``metric = error``                 -> label field "label", top node
      ``metric[lbl,node] = error``       -> named label field + named node
    """

    def __init__(self) -> None:
        self.metrics: List[Metric] = []
        self.nodes: List[Optional[str]] = []   # None = top (last) node

    def add(self, metric_name: str, label_field: str = "label",
            node: Optional[str] = None) -> None:
        self.metrics.append(create_metric(metric_name, label_field))
        self.nodes.append(node)

    def clear(self) -> None:
        for m in self.metrics:
            m.clear()

    def add_eval(self, node_values: Dict[Optional[str], np.ndarray],
                 node_labels: Dict[Optional[str], np.ndarray],
                 label_slices: Dict[str, Tuple[int, int]]) -> None:
        """node_values maps node-name (or None for top) to (n, k) scores for
        the real (unpadded) rows this process holds; node_labels carries the
        row-aligned (n, w) label block per node (rows can differ per node in
        multi-host runs when some nodes are replicated)."""
        for m, node in zip(self.metrics, self.nodes):
            pred = node_values[node]
            label = node_labels[node]
            a, b = label_slices[m.label_field]
            m.add(np.asarray(pred), np.asarray(label[:, a:b]))

    def get(self, prefix: str) -> List[Tuple[str, float]]:
        return [(f"{prefix}-{m.name}", m.get()) for m in self.metrics]

    def pairs(self) -> List[Tuple[float, int]]:
        """Each metric's accumulators ``(sum, cnt)``, in order: what a
        data-parallel run sums over its ranks."""
        return [(m.sum, m.cnt) for m in self.metrics]

    def load_pairs(self, pairs: List[Tuple[float, int]]) -> None:
        """Set each metric's accumulators from :meth:`pairs`' layout."""
        if len(pairs) != len(self.metrics):
            raise ValueError(f"{len(pairs)} metric pairs for "
                             f"{len(self.metrics)} metrics")
        for m, (s, c) in zip(self.metrics, pairs):
            m.sum, m.cnt = float(s), int(c)
