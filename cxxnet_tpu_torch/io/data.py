"""Data iterator protocol and factory (the port of ``cxxnet_tpu/io/data.py``).

Batches are host numpy arrays in NHWC (flat nodes (n, 1, 1, k));
``num_batch_padd`` marks the trailing padded rows of an epoch's last
partial batch, which the losses mask and the metrics skip. A
``device_normalize`` pipeline (imgrec) ships uint8 batches with their
deferred normalization in ``norm``; the trainer applies it on the card.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional, Type

import numpy as np

from ..config import ConfigError, ConfigPairs

#: what the port's input pipeline raises on names this ROADMAP item
A2 = "ROADMAP Queue A 2, the input pipeline"


@dataclasses.dataclass
class DataBatch:
    data: np.ndarray                      # (batch, y, x, c) or (batch,1,1,n)
    label: np.ndarray                     # (batch, label_width) float32
    num_batch_padd: int = 0               # trailing rows that are padding
    inst_index: Optional[np.ndarray] = None  # (batch,) instance ids
    # device_normalize = 1 pipelines: data is uint8 and this carries the
    # deferred normalization {"mean": (c,) | (y, x, c) | None,
    # "divideby": f, "scale": f} for the trainer to apply on the card
    norm: Optional[dict] = None

    @property
    def batch_size(self) -> int:
        return self.data.shape[0]


class DataIter:
    """Iterator protocol: ``before_first`` then ``next`` until None."""

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


def check_local(path: str) -> str:
    """``path`` when it names a local file; a ``scheme://`` URL raises
    (the JAX package reads those through its stream layer)."""
    if re.match(r"^[a-zA-Z][a-zA-Z0-9+.\-]*://", path):
        raise ConfigError(f"{path}: remote paths are not read by the "
                          f"PyTorch port yet ({A2})")
    return path


ITER_REGISTRY: Dict[str, Type[DataIter]] = {}

#: iterators that wrap the one before them in a chain (``base``)
WRAPPERS = ("threadbuffer",)

#: iterator-section keys of features the port does not read yet
NOT_YET_KEYS = ("test_skipread", "dist_num_worker", "dist_worker_rank",
                "data_gen_seed", "image_bin", "path_imgbin",
                "image_conf_prefix", "image_conf_ids")


def register_iter(*names: str):
    def deco(cls):
        for n in names:
            ITER_REGISTRY[n] = cls
        return cls
    return deco


def create_iterator(cfg: ConfigPairs) -> DataIter:
    """Build an iterator chain from one config section: the first
    ``iter = <type>`` entry names the source, each later one wraps the
    chain so far (``end`` closes the section); every other pair is
    passed to every iterator of the chain. The port reads the sources
    ``synthetic``, ``synthetic_lm``, ``mnist``, ``imgrec`` (and its
    aliases) and ``img``, and the wrapper ``threadbuffer``; the other
    iterator types (``attachtxt``, ``csv``, ``membuffer``, ``throttle``)
    and the keys of ``NOT_YET_KEYS`` (the ``image_bin`` and
    ``image_conf_prefix`` packs, sharded reading, ``test_skipread``,
    ``data_gen_seed``) raise naming ROADMAP Queue A 2."""
    from . import iter_img, iter_imgrec, iter_mnist, proc  # noqa: F401
    kinds = [v for k, v in cfg if k == "iter" and v != "end"]
    params = [(k, v) for k, v in cfg if k != "iter"]
    for k, v in params:
        if k in NOT_YET_KEYS and str(v).strip() not in ("", "0"):
            raise ConfigError(f"{k} = {v}: not in the PyTorch port yet "
                              f"({A2})")
    if not kinds:
        raise ConfigError("config section declares no iterator")
    for i, kind in enumerate(kinds):
        if kind not in ITER_REGISTRY or (i > 0) != (kind in WRAPPERS):
            raise ConfigError(
                f"iter = {kind} (chain {kinds}): the PyTorch port reads "
                "the sources synthetic, synthetic_lm, mnist, imgrec and "
                f"img, wrapped by threadbuffer, so far ({A2})")
    it = None
    for kind in kinds:
        cls = ITER_REGISTRY[kind]
        it = cls(params) if it is None else cls(params, base=it)
        it.init()           # inner to outer: a wrapper gets a ready base
    return it
