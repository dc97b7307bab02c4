"""Data iterator protocol and factory (the port of ``cxxnet_tpu/io/data.py``).

Batches are host numpy arrays in NHWC (flat nodes (n, 1, 1, k));
``num_batch_padd`` marks the trailing padded rows of an epoch's last
partial batch, which the losses mask and the metrics skip.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Type

import numpy as np

from ..config import ConfigError, ConfigPairs


@dataclasses.dataclass
class DataBatch:
    data: np.ndarray                      # (batch, y, x, c) or (batch,1,1,n)
    label: np.ndarray                     # (batch, label_width) float32
    num_batch_padd: int = 0               # trailing rows that are padding
    inst_index: Optional[np.ndarray] = None  # (batch,) instance ids

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


ITER_REGISTRY: Dict[str, Type[DataIter]] = {}

#: iterator-section keys of features the port does not read yet
NOT_YET_KEYS = ("test_skipread", "dist_num_worker", "dist_worker_rank",
                "data_gen_seed")


def register_iter(*names: str):
    def deco(cls):
        for n in names:
            ITER_REGISTRY[n] = cls
        return cls
    return deco


def create_iterator(cfg: ConfigPairs) -> DataIter:
    """Build an iterator from one config section: each ``iter = <type>``
    entry names an iterator (``end`` closes the section); every other
    pair is passed to it. The port reads ``synthetic``, ``synthetic_lm``
    and ``mnist``; the other iterator types, chains and the keys of
    ``NOT_YET_KEYS`` raise naming ROADMAP Queue A 2."""
    from . import iter_mnist, proc  # noqa: F401  (populate registry)
    kinds = [v for k, v in cfg if k == "iter" and v != "end"]
    params = [(k, v) for k, v in cfg if k != "iter"]
    for k, v in params:
        if k in NOT_YET_KEYS and str(v).strip() not in ("", "0"):
            raise ConfigError(f"{k} = {v}: not in the PyTorch port yet "
                              "(ROADMAP Queue A 2, the input pipeline)")
    if not kinds:
        raise ConfigError("config section declares no iterator")
    for kind in kinds:
        if kind not in ITER_REGISTRY:
            raise ConfigError(
                f"iter = {kind}: the PyTorch port reads iter = synthetic, "
                "synthetic_lm and mnist only so far (ROADMAP Queue A 2, "
                "the input pipeline)")
    if len(kinds) > 1:
        raise ConfigError(
            f"iterator chain {kinds}: chains of iterators are not in the "
            "PyTorch port yet (ROADMAP Queue A 2, the input pipeline)")
    it = ITER_REGISTRY[kinds[0]](params)
    it.init()
    return it
