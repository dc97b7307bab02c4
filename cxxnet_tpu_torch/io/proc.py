"""In-memory iterators (the port of part of ``cxxnet_tpu/io/proc.py``):
the sequential batch cursor with tail padding, the ``synthetic``
gaussian-cluster classification data and the ``synthetic_lm`` token
sequences.

The synthetic draws are the JAX package's, line for line, so the same
``seed_data`` gives bit-equal data and labels and the same batches in
the same order. The JAX iterators' data-service sharding keys
(``dist_num_worker``, ``dist_worker_rank``, ``data_gen_seed``) are not
ported: ``create_iterator`` raises on them (ROADMAP Queue A 2).
"""

from __future__ import annotations

import numpy as np

from .data import DataBatch, DataIter, register_iter


class _InMemoryIterator(DataIter):
    """Sequential batch cursor over in-memory ``self.data`` /
    ``self.labels`` with tail padding (``num_batch_padd``: the last
    batch repeats its last row)."""

    def _finalize_rows(self):
        self.inst = np.arange(self.data.shape[0], dtype=np.int64)

    def before_first(self):
        self._pos = 0

    def next(self):
        n = self.data.shape[0]
        if self._pos >= n:
            return None
        bs = self.batch_size
        idx = np.arange(self._pos, min(self._pos + bs, n))
        padd = 0
        if len(idx) < bs:
            padd = bs - len(idx)
            idx = np.concatenate([idx, np.repeat(idx[-1:], padd)])
        self._pos += bs
        return DataBatch(data=self.data[idx], label=self.labels[idx],
                         num_batch_padd=padd, inst_index=self.inst[idx])


@register_iter("synthetic")
class SyntheticIterator(_InMemoryIterator):
    """Deterministic gaussian-cluster classification data: ``num_class``
    centers of N(0, 2^2) and ``num_inst`` rows of a center plus
    N(0, 0.5^2) noise, in NHWC (or flat (n, 1, 1, k))."""

    def set_param(self, name, val):
        if name == "num_inst":
            self.num_inst = int(val)
        elif name == "batch_size":
            self.batch_size = int(val)
        elif name == "num_class":
            self.num_class = int(val)
        elif name == "input_shape":
            self.input_shape = tuple(int(x) for x in val.split(","))
        elif name == "seed_data":
            self.seed = int(val)
        elif name == "label_width":
            self.label_width = int(val)

    def __init__(self, cfg):
        self.num_inst = 512
        self.batch_size = 128
        self.num_class = 10
        self.input_shape = (1, 1, 32)
        self.seed = 7
        self.label_width = 1
        super().__init__(cfg)

    def init(self):
        rng = np.random.RandomState(self.seed)
        c, y, x = self.input_shape
        dim = c * y * x
        centers = rng.randn(self.num_class, dim).astype(np.float32) * 2.0
        lab = rng.randint(0, self.num_class, size=self.num_inst)
        feats = centers[lab] + 0.5 * rng.randn(self.num_inst, dim).astype(
            np.float32)
        if c == 1 and y == 1:
            self.data = feats.reshape(self.num_inst, 1, 1, x)
        else:
            self.data = feats.reshape(self.num_inst, c, y, x) \
                .transpose(0, 2, 3, 1).copy()
        self.labels = np.tile(lab.astype(np.float32)[:, None],
                              (1, self.label_width))
        self._finalize_rows()
        self.before_first()


@register_iter("synthetic_lm")
class SyntheticLMIterator(_InMemoryIterator):
    """Token sequences for language models: ``num_inst`` rows of
    ``seq_len`` uniform token ids below ``vocab_size`` as a flat
    ``(n, 1, 1, seq_len)`` float node. Labels are ``(token_t + token_0)
    mod vocab_size`` (``lm_task = add0``: solvable only by attending
    back to position 0) or the tokens themselves (``lm_task = copy``)."""

    def set_param(self, name, val):
        if name == "num_inst":
            self.num_inst = int(val)
        elif name == "batch_size":
            self.batch_size = int(val)
        elif name == "vocab_size":
            self.vocab_size = int(val)
        elif name == "seq_len":
            self.seq_len = int(val)
        elif name == "seed_data":
            self.seed = int(val)
        elif name == "lm_task":
            if val not in ("add0", "copy"):
                raise ValueError(f"unknown lm_task {val!r}")
            self.lm_task = val

    def __init__(self, cfg):
        self.num_inst = 512
        self.batch_size = 32
        self.vocab_size = 32
        self.seq_len = 64
        self.seed = 11
        self.lm_task = "add0"
        super().__init__(cfg)

    def init(self):
        rng = np.random.RandomState(self.seed)
        toks = rng.randint(0, self.vocab_size,
                           size=(self.num_inst, self.seq_len))
        if self.lm_task == "copy":
            lab = toks
        else:
            lab = (toks + toks[:, :1]) % self.vocab_size
        self.data = toks.astype(np.float32) \
            .reshape(self.num_inst, 1, 1, self.seq_len)
        self.labels = lab.astype(np.float32)
        self._finalize_rows()
        self.before_first()
