"""Processing iterators (the port of part of ``cxxnet_tpu/io/proc.py``):
the ``threadbuffer`` prefetch wrapper, the sequential batch cursor with
tail padding, the ``synthetic`` gaussian-cluster classification data and
the ``synthetic_lm`` token sequences.

The synthetic draws are the JAX package's, line for line, so the same
``seed_data`` gives bit-equal data and labels and the same batches in
the same order. The JAX iterators' data-service sharding keys
(``dist_num_worker``, ``dist_worker_rank``, ``data_gen_seed``) are not
ported: ``create_iterator`` raises on them (ROADMAP Queue A 2).
"""

from __future__ import annotations

import queue
import threading
from typing import Optional

import numpy as np

from .data import DataBatch, DataIter, register_iter


class _ProducerError:
    """Queue item carrying an exception out of the producer thread, so
    that it surfaces in the consumer's ``next()`` instead of leaving it
    blocked behind a dead producer."""
    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


@register_iter("threadbuffer")
class ThreadBufferIterator(DataIter):
    """Prefetch of whole batches by a background thread into a queue of
    depth ``buffer_size`` (default 2). The producer is a daemon thread
    whose every put is timed and re-checks the stop flag, so
    :meth:`close` (and the next :meth:`before_first`) stops and joins it
    however full the queue is, and a chain left open never holds the
    interpreter at exit. An exception in the wrapped iterator is raised
    again by :meth:`next`."""

    #: seconds :meth:`close` waits for the producer before giving up on it
    JOIN_TIMEOUT_S = 10.0

    def set_param(self, name, val):
        if name == "buffer_size":
            self.buffer_size = int(val)

    def __init__(self, cfg, base: DataIter):
        self.buffer_size = 2
        self.base = base
        self._queue: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        super().__init__(cfg)
        if self.buffer_size < 1:
            raise ValueError(f"buffer_size must be >= 1, got "
                             f"{self.buffer_size}")

    def _put(self, item) -> bool:
        """Put ``item``, giving up when asked to stop; False if it did."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _producer(self):
        try:
            self.base.before_first()
            while not self._stop.is_set():
                batch = self.base.next()
                if not self._put(batch) or batch is None:
                    return
        except BaseException as e:      # noqa: BLE001 (relayed to next())
            self._put(_ProducerError(e))

    def _join_producer(self):
        """Stop the producer, draining the queue until it has ended (it
        may refill a freed slot before it sees the flag), for at most
        ``JOIN_TIMEOUT_S`` (a wrapped iterator stuck in a read cannot be
        interrupted; the thread is a daemon and dies with the process)."""
        t = self._thread
        if t is None or not t.is_alive():
            return
        self._stop.set()
        waited = 0.0
        while t.is_alive() and waited < self.JOIN_TIMEOUT_S:
            try:
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=0.05)
            waited += 0.05

    def before_first(self):
        self._join_producer()
        self._stop.clear()
        self._queue = queue.Queue(maxsize=self.buffer_size)
        self._thread = threading.Thread(target=self._producer, daemon=True,
                                        name="io-threadbuffer")
        self._thread.start()

    def next(self):
        if self._queue is None:
            self.before_first()
        while True:
            try:
                item = self._queue.get(timeout=0.1)
                break
            except queue.Empty:
                # a producer that ended and left nothing: nothing comes
                if not self._thread.is_alive() and self._queue.empty():
                    return None
        if isinstance(item, _ProducerError):
            raise item.exc
        return item

    def close(self):
        """Stop and join the producer, then close the wrapped iterator."""
        self._join_producer()
        close = getattr(self.base, "close", None)
        if callable(close):
            close()


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
