"""Data iterator protocol and factory (the port of ``cxxnet_tpu/io/data.py``).

Batches are host numpy arrays in NHWC (flat nodes (n, 1, 1, k));
``num_batch_padd`` marks the trailing padded rows of an epoch's last
partial batch, which the losses mask and the metrics skip. A
``device_normalize`` pipeline (imgrec) ships uint8 batches with their
deferred normalization in ``norm``; the trainer applies it on the card.
``extra_data`` holds the values of a net's extra input nodes (``in_1``
and on, ``extra_data_num``), which ``attachtxt`` joins to a batch by
instance id.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Type

import numpy as np

from ..config import ConfigError, ConfigPairs


@dataclasses.dataclass
class DataBatch:
    data: np.ndarray                      # (batch, y, x, c) or (batch,1,1,n)
    label: np.ndarray                     # (batch, label_width) float32
    num_batch_padd: int = 0               # trailing rows that are padding
    inst_index: Optional[np.ndarray] = None  # (batch,) instance ids
    # the extra input nodes' values, (batch, y, x, c) each
    extra_data: List[np.ndarray] = dataclasses.field(default_factory=list)
    # device_normalize = 1 pipelines: data is uint8 and this carries the
    # deferred normalization {"mean": (c,) | (y, x, c) | None,
    # "divideby": f, "scale": f} for the trainer to apply on the card
    norm: Optional[dict] = None

    @property
    def batch_size(self) -> int:
        return self.data.shape[0]


class DataIter:
    """Iterator protocol: ``before_first`` then ``next`` until None."""

    #: True on the source iterators that read only their worker's share
    #: under ``dist_num_worker`` / ``dist_worker_rank`` (what the data
    #: service's shards need; :func:`dist_shardable_sources`)
    supports_dist_shard = False

    def __init__(self, cfg: ConfigPairs):
        self.cfg = cfg
        for k, v in cfg:
            self.set_param(k, v)

    def set_param(self, name: str, val: str) -> None:
        pass

    def init(self) -> None:
        pass

    def before_first(self) -> None:
        raise NotImplementedError

    def next(self) -> Optional[DataBatch]:
        """Return the next batch or None at end of epoch."""
        raise NotImplementedError

    def __iter__(self):
        self.before_first()
        while True:
            b = self.next()
            if b is None:
                return
            yield b


def close_chain(it) -> None:
    """Release an iterator chain's background resources, walking
    ``.base`` links: threadbuffer producers (``close()``) and decode
    thread pools (``_pool``)."""
    seen = set()
    while it is not None and id(it) not in seen:
        seen.add(id(it))
        close = getattr(it, "close", None)
        if callable(close):
            try:
                close()
            except Exception:
                pass
        pool = getattr(it, "_pool", None)
        if pool is not None and hasattr(pool, "shutdown"):
            pool.shutdown(wait=False)
        it = getattr(it, "base", None)


def dist_slice(n: int, nworker: int, rank: int) -> slice:
    """The contiguous rows of worker ``rank`` of ``nworker`` over ``n``
    rows (the first ``n % nworker`` workers take one more), so the
    union over ranks is the whole dataset."""
    if not 0 <= rank < nworker:
        raise ValueError(f"dist_worker_rank {rank} outside "
                         f"[0, dist_num_worker={nworker})")
    base, extra = divmod(n, nworker)
    start = rank * base + min(rank, extra)
    return slice(start, start + base + (1 if rank < extra else 0))


ITER_REGISTRY: Dict[str, Type[DataIter]] = {}

#: iterators that wrap the one before them in a chain (``base``)
WRAPPERS = ("threadbuffer", "throttle", "membuffer", "attachtxt")


def register_iter(*names: str):
    def deco(cls):
        for n in names:
            ITER_REGISTRY[n] = cls
        return cls
    return deco


class SkipReadIterator(DataIter):
    """``test_skipread = 1``: the first epoch streams (and counts) the
    real batches; every later epoch serves the first batch that many
    times without touching the source. With ``test_io = 1`` over two
    rounds or more the round lines give the rate with the read and
    decode (round 0) and without (rounds 1+)."""

    def __init__(self, base: DataIter):
        self.base = base
        self._first: Optional[DataBatch] = None
        self._count = 0
        self._known = False
        self._pos = 0
        super().__init__([])

    def before_first(self):
        self._pos = 0
        if not self._known:
            # only a whole first epoch sets the count
            self._count = 0
            self._first = None
            self.base.before_first()

    def next(self):
        if not self._known:
            b = self.base.next()
            if b is None:
                self._known = True
                self._pos = self._count
                return None
            if self._first is None:
                self._first = b
            self._count += 1
            return b
        if self._first is None or self._pos >= self._count:
            return None
        self._pos += 1
        return self._first


def dist_shardable_sources() -> list:
    """The source iterator types that declare ``supports_dist_shard``."""
    from . import iter_img, iter_imgrec, iter_mnist, proc  # noqa: F401
    return sorted(n for n, c in ITER_REGISTRY.items()
                  if c.supports_dist_shard)


def create_iterator(cfg: ConfigPairs) -> DataIter:
    """Build an iterator chain from one config section: the first
    ``iter = <type>`` entry names the source, each later one wraps the
    chain so far (``end`` closes the section); every other pair is
    passed to every iterator of the chain, and ``test_skipread = 1``
    wraps the whole chain in :class:`SkipReadIterator`. The port reads
    the sources ``synthetic``, ``synthetic_lm``, ``mnist``, ``csv``,
    ``imgrec`` (and its ``imgbin`` aliases) and ``img``, wrapped by
    ``threadbuffer``, ``throttle``, ``membuffer`` and ``attachtxt``
    (which feeds ``extra_data`` inputs); a source in a wrapper's place
    or a wrapper first raises."""
    from . import iter_img, iter_imgrec, iter_mnist, proc  # noqa: F401
    kinds = [v for k, v in cfg if k == "iter" and v != "end"]
    params = [(k, v) for k, v in cfg if k != "iter"]
    if not kinds:
        raise ConfigError("config section declares no iterator")
    for i, kind in enumerate(kinds):
        if kind not in ITER_REGISTRY or (i > 0) != (kind in WRAPPERS):
            raise ConfigError(
                f"iter = {kind} (chain {kinds}): a chain is one of the "
                "sources synthetic, synthetic_lm, mnist, csv, imgrec and "
                "img, wrapped by threadbuffer, throttle, membuffer and "
                "attachtxt")
    it = None
    for kind in kinds:
        cls = ITER_REGISTRY[kind]
        it = cls(params) if it is None else cls(params, base=it)
        it.init()           # inner to outer: a wrapper gets a ready base
    if any(k == "test_skipread" and str(v).strip() == "1"
           for k, v in params):
        it = SkipReadIterator(it)
    return it
