"""(epoch, shard, batch) addressing over local pipelines (the port of
``cxxnet_tpu/data_service/pipeline.py``).

The service's unit of work is a batch address ``(epoch, shard,
batch_idx)``. An address maps to tensors through the ordinary iterator
chain of the config's data section (``io.create_iterator``: the imgrec
decode pool, the augmentations, the threadbuffer), built once per
``(epoch, shard)`` with:

* ``dist_num_worker = n_shards`` / ``dist_worker_rank = shard``: the
  shard is the pipeline's worker share (a byte range of a record file,
  pages of a pack, rows of a generated or csv dataset);
* ``seed_data = stream_seed(seed, epoch, shard)`` and ``data_gen_seed =
  seed``: a fresh order a shard and epoch over one dataset.

The map is a pure function of (section, service seed, address), so any
holder of the config serves any address: a reader its shards (and on
failover anyone's), a client's degrade path the same stream locally, a
rebalanced successor a departed reader's shard from the client's own
position. No iterator state crosses the wire.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from ..config import ConfigPairs
from ..io.data import (DataBatch, DataIter, close_chain, create_iterator,
                       dist_shardable_sources)
from .assign import stream_seed

#: the prefix of the service's own keys, stripped from the section
_SERVICE_PREFIX = "data_service"


def check_shardable(pairs: ConfigPairs, n_shards: int) -> None:
    """Raise unless the section's source iterator (its first ``iter``)
    honours ``dist_num_worker`` / ``dist_worker_rank``: any other source
    would serve its whole stream in every shard. One shard takes any
    source."""
    if n_shards <= 1:
        return
    kinds = [v for k, v in pairs if k == "iter" and v != "end"]
    shardable = dist_shardable_sources()
    if kinds and kinds[0] not in shardable:
        raise ValueError(
            f"data_service_shards={n_shards} needs a source iterator "
            f"that honors dist_num_worker/dist_worker_rank; "
            f"'{kinds[0]}' does not (shardable: "
            f"{', '.join(shardable)}). Use one of "
            "those or set data_service_shards = 1.")


def shard_section(pairs: ConfigPairs, n_shards: int, shard: int,
                  seed: int, epoch: int) -> ConfigPairs:
    """The section of one (epoch, shard) pipeline: the service's keys
    stripped, the shard and the seeds appended last (the last occurrence
    of a key wins)."""
    if not 0 <= shard < n_shards:
        raise ValueError(f"shard {shard} outside [0, {n_shards})")
    base = [(k, v) for k, v in pairs if not k.startswith(_SERVICE_PREFIX)]
    base += [("dist_num_worker", str(int(n_shards))),
             ("dist_worker_rank", str(int(shard))),
             ("seed_data", str(stream_seed(seed, epoch, shard))),
             ("data_gen_seed", str(int(seed)))]
    return base


@dataclasses.dataclass
class _Cursor:
    epoch: int
    it: DataIter
    next_b: int = 0


class LocalShardSource:
    """Sequential batches of per-shard pipelines, one cursor a shard.
    :meth:`get` returns the addressed batch, or None past the shard's
    end of epoch; a backward seek rebuilds the pipeline and runs it
    forward. Callers serialize access per shard (the reader holds a
    lock a shard; a client is one thread)."""

    def __init__(self, pairs: ConfigPairs, n_shards: int, seed: int):
        check_shardable(pairs, n_shards)
        self.pairs = list(pairs)
        self.n_shards = int(n_shards)
        self.seed = int(seed)
        self._cursors: Dict[int, _Cursor] = {}
        # the batch counts of exhausted streams: (epoch, shard) -> n
        self._lens: Dict[Tuple[int, int], int] = {}

    def _open(self, epoch: int, shard: int) -> _Cursor:
        old = self._cursors.get(shard)
        if old is not None:
            close_chain(old.it)
        it = create_iterator(shard_section(
            self.pairs, self.n_shards, shard, self.seed, epoch))
        it.before_first()
        cur = _Cursor(epoch=epoch, it=it)
        self._cursors[shard] = cur
        return cur

    def close(self) -> None:
        """Release every cursor's chain."""
        for cur in self._cursors.values():
            close_chain(cur.it)
        self._cursors.clear()

    def get(self, epoch: int, shard: int, batch: int
            ) -> Optional[DataBatch]:
        known = self._lens.get((epoch, shard))
        if known is not None and batch >= known:
            return None
        cur = self._cursors.get(shard)
        if cur is None or cur.epoch != epoch or cur.next_b > batch:
            cur = self._open(epoch, shard)
        while True:
            b = cur.it.next()
            if b is None:
                self._lens[(epoch, shard)] = cur.next_b
                return None
            cur.next_b += 1
            if cur.next_b - 1 == batch:
                return b
