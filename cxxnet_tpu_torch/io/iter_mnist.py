"""The ``mnist`` iterator: idx-ubyte image and label files (the port of
``cxxnet_tpu/io/iter_mnist.py`` and of the ``open_maybe_gz`` it reads
through).

Plain or gzipped (``.gz``) idx files; images scaled by 1/256 into
float32, as a flat ``(n, 1, 1, h*w)`` node (``input_flat = 1``, the
default) or an image ``(n, h, w, 1)``; labels ``(n, 1)`` float32.
``shuffle`` permutes the order at every epoch with
``np.random.RandomState(seed_data)``; the last partial batch is padded
by repeating its last row (or, with ``round_batch``, by wrapping to the
epoch's start), and ``num_batch_padd`` marks the padding. The batches
are bit-equal to the JAX iterator's. Remote paths (``gs://`` and other
``scheme://`` URLs) raise: remote streams come with the rest of the
input pipeline (ROADMAP Queue A 2).
"""

from __future__ import annotations

import gzip
import struct
from typing import Optional

import numpy as np

from .data import DataBatch, DataIter, check_local, register_iter


def open_maybe_gz(path: str):
    """Binary read stream of a local file, gunzipped for ``.gz`` paths."""
    check_local(path)
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def read_idx(path: str) -> np.ndarray:
    """Parse an idx-ubyte file (images magic 2051, labels magic 2049)."""
    with open_maybe_gz(path) as f:
        magic = struct.unpack(">i", f.read(4))[0]
        ndim = magic % 256
        dims = [struct.unpack(">i", f.read(4))[0] for _ in range(ndim)]
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(dims)


@register_iter("mnist")
class MNISTIterator(DataIter):

    def set_param(self, name, val):
        if name == "path_img":
            self.path_img = val
        elif name == "path_label":
            self.path_label = val
        elif name == "shuffle":
            self.shuffle = int(val)
        elif name == "input_flat":
            self.input_flat = int(val)
        elif name == "batch_size":
            self.batch_size = int(val)
        elif name == "seed_data":
            self.seed = int(val)
        elif name == "round_batch":
            self.round_batch = int(val)
        elif name == "silent":
            self.silent = int(val)
        elif name == "index_offset":
            self.index_offset = int(val)

    def __init__(self, cfg):
        self.path_img = ""
        self.path_label = ""
        self.shuffle = 0
        self.input_flat = 1
        self.batch_size = 128
        self.seed = 0
        self.round_batch = 0
        self.silent = 0
        self.index_offset = 0
        super().__init__(cfg)

    def init(self):
        images = read_idx(self.path_img).astype(np.float32) / 256.0
        labels = read_idx(self.path_label).astype(np.float32)
        n = images.shape[0]
        if self.input_flat:
            self.images = images.reshape(n, 1, 1, -1)
        else:
            h, w = images.shape[1], images.shape[2]
            self.images = images.reshape(n, h, w, 1)
        self.labels = labels.reshape(n, 1)
        self.inst = np.arange(n, dtype=np.int64) + self.index_offset
        self._order = np.arange(n)
        self._rng = np.random.RandomState(self.seed)
        self.before_first()
        if not self.silent:
            print(f"MNISTIterator: load {n} images, shuffle={self.shuffle}")

    def before_first(self):
        if self.shuffle:
            self._rng.shuffle(self._order)
        self._pos = 0

    def next(self) -> Optional[DataBatch]:
        n = self.images.shape[0]
        bs = self.batch_size
        if self._pos >= n:
            return None
        idx = self._order[self._pos:self._pos + bs]
        padd = 0
        if len(idx) < bs:
            padd = bs - len(idx)
            if self.round_batch:
                idx = np.concatenate([idx, self._order[:padd]])
            else:
                idx = np.concatenate([idx, np.repeat(idx[-1:], padd)])
        self._pos += bs
        return DataBatch(data=self.images[idx], label=self.labels[idx],
                         num_batch_padd=padd, inst_index=self.inst[idx])
