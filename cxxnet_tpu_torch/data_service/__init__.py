"""The input data service (the port of ``cxxnet_tpu/data_service``).

Reader processes (``task = data_reader``) own shards of the packed
records and serve decoded, augmented, batched tensors to trainers over
TCP, so decode is paid once a fleet and runs outside the trainer:

* :mod:`.assign`: the fleet's shard assignment, the movement-minimal
  rebalance and the seeded epoch order;
* :mod:`.pipeline`: (epoch, shard, batch) addressing over the ordinary
  iterator chain;
* :mod:`.wire`: the length-prefixed frames (byte-equal to the JAX
  package's);
* :mod:`.reader`: the reader's server with its frame cache;
* :mod:`.client`: the trainer's iterator with retry, failover,
  rebalance and the local degrade.
"""

from .assign import (assign_shards, epoch_permutation, moved_shards,
                     owner_map, rebalance, stream_seed)
from .client import (DataServiceClient, NoReaderAvailable,
                     PrefetchedServiceIterator, ServiceIterator,
                     build_service_iterator)
from .pipeline import LocalShardSource, shard_section
from .reader import DataReaderServer
from .wire import WireError, pack_frame, recv_frame

__all__ = [
    "assign_shards", "epoch_permutation", "moved_shards", "owner_map",
    "rebalance", "stream_seed", "DataServiceClient", "NoReaderAvailable",
    "PrefetchedServiceIterator", "ServiceIterator",
    "build_service_iterator", "LocalShardSource", "shard_section",
    "DataReaderServer", "WireError", "pack_frame", "recv_frame",
]
