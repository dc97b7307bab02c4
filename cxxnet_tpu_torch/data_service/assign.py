"""Shard assignment and the seeded epoch order of the input data service
(the port's copy of ``cxxnet_tpu/data_service/assign.py``; every function
returns what the JAX one returns for the same arguments).

Every member of a fleet, each reader and each trainer client, derives
the same shard -> reader map from the same inputs (the endpoint list in
config order and the shard count) with no coordination: heaviest shard
first, index-tiebroken, onto the least-loaded reader, list-order
tiebroken. :func:`rebalance` re-derives the map after a reader leaves or
joins, moving only orphaned shards and the fewest needed to re-level.
:func:`epoch_permutation` is the seeded cross-shard interleave of one
epoch, and :func:`stream_seed` the ``seed_data`` of one (epoch, shard)
pipeline. Seeds mix through sha256, never ``hash()``, so the map agrees
across processes whatever PYTHONHASHSEED is.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Iterable, List, Sequence, Set, Tuple

import numpy as np

Assignment = Dict[str, List[int]]


def _mix(*parts: int) -> int:
    """Deterministic 64-bit mix of integer parts (process-independent)."""
    h = hashlib.sha256(
        ("cxxnet-ds:" + ":".join(str(int(p)) for p in parts)).encode())
    return int.from_bytes(h.digest()[:8], "little")


def stream_seed(seed: int, epoch: int, shard: int) -> int:
    """``seed_data`` for the (epoch, shard) pipeline: uncorrelated
    across epochs and shards, identical on every host. Bounded to
    int31 — iterators feed it to ``np.random.RandomState`` after their
    own rank arithmetic."""
    return _mix(seed, epoch, shard) % (1 << 31)


def epoch_permutation(seed: int, epoch: int, n_shards: int) -> List[int]:
    """The global cross-shard interleave order for one epoch."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    rng = np.random.RandomState(_mix(seed, epoch) % (1 << 32))
    return [int(s) for s in rng.permutation(n_shards)]


def _normalize(sizes: Sequence[int], readers: Sequence[str]
               ) -> Tuple[List[int], List[str]]:
    readers = list(readers)
    if not readers:
        raise ValueError("shard assignment needs at least one reader")
    if len(set(readers)) != len(readers):
        raise ValueError(f"duplicate reader endpoints: {readers}")
    sizes = [int(s) for s in sizes]
    if any(s < 0 for s in sizes):
        raise ValueError("shard sizes must be >= 0")
    return sizes, readers


def assign_shards(sizes: Sequence[int], readers: Sequence[str]
                  ) -> Assignment:
    """Greedy-balanced deterministic map ``{reader: [shard_idx, ...]}``
    over ``len(sizes)`` shards (``sizes`` weights the balance; pass
    all-1s when record counts are unknown)."""
    sizes, readers = _normalize(sizes, readers)
    loads = {r: 0 for r in readers}
    out: Assignment = {r: [] for r in readers}
    order = sorted(range(len(sizes)), key=lambda i: (-sizes[i], i))
    for shard in order:
        tgt = min(readers, key=lambda r: (loads[r], readers.index(r)))
        out[tgt].append(shard)
        loads[tgt] += sizes[shard]
    for bucket in out.values():
        bucket.sort()
    return out


def owner_map(assignment: Assignment) -> Dict[int, str]:
    """Invert an assignment to ``{shard: reader}``."""
    out: Dict[int, str] = {}
    for reader, shards in assignment.items():
        for s in shards:
            out[s] = reader
    return out


def rebalance(prev: Assignment, sizes: Sequence[int],
              readers: Sequence[str]) -> Assignment:
    """Movement-minimal deterministic re-assignment after a membership
    change. Shards keep their surviving owner; orphans (owner left the
    fleet, or newly appeared shard indices) place greedily onto the
    least-loaded reader; then a scale-up levels by moving the fewest
    shards that strictly shrink the max-min load gap."""
    sizes, readers = _normalize(sizes, readers)
    out: Assignment = {r: [] for r in readers}
    placed: Set[int] = set()
    for reader in readers:
        for s in prev.get(reader, ()):
            if 0 <= s < len(sizes):
                out[reader].append(s)
                placed.add(s)
    loads = {r: sum(sizes[s] for s in out[r]) for r in readers}
    orphans = sorted((s for s in range(len(sizes)) if s not in placed),
                     key=lambda i: (-sizes[i], i))
    for shard in orphans:
        tgt = min(readers, key=lambda r: (loads[r], readers.index(r)))
        out[tgt].append(shard)
        loads[tgt] += sizes[shard]
    # level-up pass (new reader with no orphans to absorb): move a
    # donor shard only when it STRICTLY narrows the donor/recipient
    # gap — that bound is what makes the move set minimal
    while True:
        donor = max(readers, key=lambda r: (loads[r], -readers.index(r)))
        rcpt = min(readers, key=lambda r: (loads[r], readers.index(r)))
        gap = loads[donor] - loads[rcpt]
        movable = [s for s in out[donor] if 0 < sizes[s] < gap]
        if not movable:
            break
        shard = max(movable, key=lambda s: (sizes[s], -s))
        out[donor].remove(shard)
        out[rcpt].append(shard)
        loads[donor] -= sizes[shard]
        loads[rcpt] += sizes[shard]
    for bucket in out.values():
        bucket.sort()
    return out


def moved_shards(prev: Assignment, new: Assignment) -> Set[int]:
    """Shards whose owner changed between two assignments (the
    rebalance cost a test can bound)."""
    old_owner = owner_map(prev)
    return {s for s, r in owner_map(new).items()
            if old_owner.get(s) != r}


def failover_order(endpoints: Iterable[str], owner: str) -> List[str]:
    """Deterministic endpoint try-order for one shard: its owner
    first, then the remaining endpoints in canonical (config) order."""
    eps = list(endpoints)
    return ([owner] if owner in eps else []) + \
        [e for e in eps if e != owner]
