"""Processing iterators (the port of ``cxxnet_tpu/io/proc.py``): the
``threadbuffer`` prefetch wrapper, the ``throttle`` delay and the
``membuffer`` cache wrappers, the ``csv`` source, the sequential batch
cursor with tail padding, the ``synthetic`` gaussian-cluster
classification data and the ``synthetic_lm`` token sequences.

The synthetic draws are the JAX package's, line for line, so the same
``seed_data`` gives bit-equal data and labels and the same batches in
the same order. The sources ``csv``, ``synthetic`` and ``synthetic_lm``
shard as the JAX ones do: ``dist_num_worker`` / ``dist_worker_rank``
keep a worker's contiguous rows (:func:`~.data.dist_slice`), and with
``data_gen_seed`` the synthetic data is drawn from that seed and
``seed_data`` only permutes the worker's rows (what the data service's
shards need: one dataset an epoch, an order a shard and epoch).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import List, Optional

import numpy as np

from . import stream
from .data import DataBatch, DataIter, dist_slice, register_iter


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


@register_iter("throttle")
class ThrottleIterator(DataIter):
    """Delays every ``next()`` by ``throttle_ms``: a stand-in for an
    expensive decode (a trainer fed through it goes input-bound)."""

    def set_param(self, name, val):
        if name == "throttle_ms":
            self.throttle_ms = float(val)

    def __init__(self, cfg, base: DataIter):
        self.throttle_ms = 0.0
        self.base = base
        super().__init__(cfg)

    def before_first(self):
        self.base.before_first()

    def next(self):
        if self.throttle_ms > 0:
            time.sleep(self.throttle_ms / 1e3)
        return self.base.next()

    def close(self):
        close = getattr(self.base, "close", None)
        if callable(close):
            close()


@register_iter("membuffer")
class DenseBufferIterator(DataIter):
    """Caches the first ``max_nbatch`` (alias ``max_buffer``, default 16)
    batches in memory, then loops over them."""

    def set_param(self, name, val):
        if name in ("max_buffer", "max_nbatch"):
            self.max_buffer = int(val)

    def __init__(self, cfg, base: DataIter):
        self.max_buffer = 16
        self.base = base
        self._cache: List[DataBatch] = []
        self._filled = False
        self._pos = 0
        super().__init__(cfg)

    def before_first(self):
        self._pos = 0
        if not self._filled:
            self.base.before_first()
            for _ in range(self.max_buffer):
                b = self.base.next()
                if b is None:
                    break
                self._cache.append(b)
            self._filled = True

    def next(self):
        if self._pos >= len(self._cache):
            return None
        b = self._cache[self._pos]
        self._pos += 1
        return b


@register_iter("csv")
class CSVIterator(DataIter):
    """CSV rows of ``label_width`` leading label columns, then the
    features (``input_shape`` c,y,x reshapes them to NHWC); ``shuffle``
    permutes the order at every epoch with ``RandomState(seed_data)``,
    ``has_header = 1`` skips the first line."""

    supports_dist_shard = True

    def set_param(self, name, val):
        if name == "filename" or name == "path_csv":
            self.filename = val
        elif name == "label_width":
            self.label_width = int(val)
        elif name == "batch_size":
            self.batch_size = int(val)
        elif name == "shuffle":
            self.shuffle = int(val)
        elif name == "input_shape":
            self.input_shape = tuple(int(x) for x in val.split(","))
        elif name == "seed_data":
            self.seed = int(val)
        elif name == "has_header":
            self.has_header = int(val)
        elif name == "dist_num_worker":
            self.nworker = int(val)
        elif name == "dist_worker_rank":
            self.rank = int(val)

    def __init__(self, cfg):
        self.filename = ""
        self.label_width = 1
        self.batch_size = 128
        self.shuffle = 0
        self.input_shape = None
        self.seed = 0
        self.has_header = 0
        self.nworker = 1
        self.rank = 0
        self._inst_base = 0
        super().__init__(cfg)

    def init(self):
        with stream.sopen(self.filename, "rb") as f:
            raw = np.loadtxt(f, delimiter=",", dtype=np.float32, ndmin=2,
                             skiprows=1 if self.has_header else 0)
        self.labels = raw[:, :self.label_width]
        feats = raw[:, self.label_width:]
        n = feats.shape[0]
        if self.input_shape and not (self.input_shape[0] == 1 and
                                     self.input_shape[1] == 1):
            c, y, x = self.input_shape
            self.data = feats.reshape(n, c, y, x).transpose(0, 2, 3, 1).copy()
        else:
            self.data = feats.reshape(n, 1, 1, -1)
        if self.nworker > 1:
            sl = dist_slice(n, self.nworker, self.rank)
            self.data = self.data[sl]
            self.labels = self.labels[sl]
            self._inst_base = sl.start
        self._order = np.arange(self.data.shape[0])
        self._rng = np.random.RandomState(self.seed)
        self.before_first()

    def before_first(self):
        if self.shuffle:
            self._rng.shuffle(self._order)
        self._pos = 0

    def next(self):
        n = self.data.shape[0]
        bs = self.batch_size
        if self._pos >= n:
            return None
        idx = self._order[self._pos:self._pos + bs]
        padd = 0
        if len(idx) < bs:
            padd = bs - len(idx)
            idx = np.concatenate([idx, np.repeat(idx[-1:], padd)])
        self._pos += bs
        return DataBatch(data=self.data[idx], label=self.labels[idx],
                         num_batch_padd=padd,
                         inst_index=(idx + self._inst_base).astype(np.int64))


class _InMemoryIterator(DataIter):
    """Sequential batch cursor over in-memory ``self.data`` /
    ``self.labels`` with tail padding (``num_batch_padd``: the last
    batch repeats its last row). :meth:`_finalize_rows` keeps a
    worker's rows under ``dist_num_worker`` and, with ``data_gen_seed``,
    permutes them by ``RandomState(seed_data)``; ``inst_index`` stays
    the row's global index."""

    supports_dist_shard = True
    nworker = 1
    rank = 0
    gen_seed = None

    def _finalize_rows(self):
        n = self.data.shape[0]
        self.inst = np.arange(n, dtype=np.int64)
        if self.nworker > 1:
            sl = dist_slice(n, self.nworker, self.rank)
            self.data = self.data[sl]
            self.labels = self.labels[sl]
            self.inst = self.inst[sl]
        if self.gen_seed is not None:
            p = np.random.RandomState(self.seed) \
                .permutation(self.data.shape[0])
            self.data = self.data[p]
            self.labels = self.labels[p]
            self.inst = self.inst[p]

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
        elif name == "dist_num_worker":
            self.nworker = int(val)
        elif name == "dist_worker_rank":
            self.rank = int(val)
        elif name == "data_gen_seed":
            self.gen_seed = int(val)

    def __init__(self, cfg):
        self.num_inst = 512
        self.batch_size = 128
        self.num_class = 10
        self.input_shape = (1, 1, 32)
        self.seed = 7
        self.label_width = 1
        super().__init__(cfg)

    def init(self):
        rng = np.random.RandomState(
            self.seed if self.gen_seed is None else self.gen_seed)
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
        elif name == "dist_num_worker":
            self.nworker = int(val)
        elif name == "dist_worker_rank":
            self.rank = int(val)
        elif name == "data_gen_seed":
            self.gen_seed = int(val)

    def __init__(self, cfg):
        self.num_inst = 512
        self.batch_size = 32
        self.vocab_size = 32
        self.seq_len = 64
        self.seed = 11
        self.lm_task = "add0"
        super().__init__(cfg)

    def init(self):
        rng = np.random.RandomState(
            self.seed if self.gen_seed is None else self.gen_seed)
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
