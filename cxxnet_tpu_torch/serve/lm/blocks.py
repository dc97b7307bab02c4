"""Paged KV-cache block accounting: a host-side allocator over a fixed
pool of fixed-size token blocks (the port of
``cxxnet_tpu/serve/lm/blocks.py``).

The device side is one preallocated ``(num_blocks, block_size, heads,
head_dim)`` tensor per attention layer (``serve/lm/engine.py`` owns
them); this module owns the integer bookkeeping only: which blocks are
free, which sequence holds which, and the compaction permutation a
defrag applies. Block **0 is reserved scratch**: block tables are
fixed-width ``(T,)`` arrays padded with 0, and the step writes every
padding or masked token into block 0, so the allocator never hands it
out and the attention mask never reads it.

``used`` and ``capacity`` are what ``/statz`` reads, and the registry
gauges ``cxxnet_lm_kv_blocks_used{engine}`` and
``cxxnet_lm_kv_pool_blocks{engine}`` export them. Thread-safe: the
scheduler thread is the steady-state caller, but the whole-request path
and the handoff listener allocate concurrently.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Tuple

import numpy as np

from ...telemetry.registry import REGISTRY

__all__ = ["BlockPool", "PoolExhausted", "SCRATCH_BLOCK"]

#: block id every padded / masked write lands in; never allocated
SCRATCH_BLOCK = 0


class PoolExhausted(RuntimeError):
    """No free KV blocks; the caller decides whom to evict (the
    scheduler evicts the most-recently-admitted sequence)."""


class BlockPool:
    """Free-list allocator over blocks ``1 .. num_blocks-1``."""

    def __init__(self, num_blocks: int, block_size: int,
                 instance: str = ""):
        if num_blocks < 2:
            raise ValueError(
                f"kv pool needs >= 2 blocks (block 0 is scratch), "
                f"got {num_blocks}")
        if block_size < 1:
            raise ValueError(f"kv block_size must be >= 1, got {block_size}")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self._lock = threading.Lock()
        # LIFO free list: a freed block is reused first, which keeps the
        # working set of pool indices small between defrags
        self._free: List[int] = list(range(self.num_blocks - 1, 0, -1))
        self._owner: Dict[int, int] = {}      # block id -> sequence id
        self.instance = instance
        self._g_used_fam = REGISTRY.gauge(
            "cxxnet_lm_kv_blocks_used",
            "Allocated KV-cache blocks (block 0 scratch excluded)",
            labels=("engine",))
        self._g_cap_fam = REGISTRY.gauge(
            "cxxnet_lm_kv_pool_blocks",
            "Allocatable KV-cache pool blocks",
            labels=("engine",))
        self._g_used = self._g_used_fam.labels(instance)
        self._g_cap = self._g_cap_fam.labels(instance)
        self._g_used.set(0)
        self._g_cap.set(self.num_blocks - 1)

    # -- accounting ------------------------------------------------------
    @property
    def capacity(self) -> int:
        """Allocatable blocks (scratch excluded)."""
        return self.num_blocks - 1

    @property
    def used(self) -> int:
        with self._lock:
            return len(self._owner)

    @property
    def available(self) -> int:
        with self._lock:
            return len(self._free)

    def blocks_for_tokens(self, n_tokens: int) -> int:
        """Blocks needed to hold ``n_tokens`` cache entries."""
        return -(-int(n_tokens) // self.block_size)

    # -- alloc / free ----------------------------------------------------
    def alloc(self, n: int, seq_id: int) -> List[int]:
        """Allocate ``n`` blocks for ``seq_id``, all or nothing, so a
        partial grant never strands blocks on a raise."""
        n = int(n)
        if n <= 0:
            return []
        with self._lock:
            if len(self._free) < n:
                raise PoolExhausted(
                    f"kv pool exhausted: need {n} block(s), "
                    f"{len(self._free)}/{self.capacity} free")
            got = [self._free.pop() for _ in range(n)]
            for b in got:
                self._owner[b] = int(seq_id)
            self._g_used.set(len(self._owner))
            return got

    def free(self, blocks: List[int]) -> None:
        """Return blocks to the pool. A double free and a free of the
        scratch block raise: both mean the block tables are corrupt, and
        a silently shared block would serve one sequence another's
        keys."""
        with self._lock:
            for b in blocks:
                b = int(b)
                if b == SCRATCH_BLOCK:
                    raise ValueError("cannot free the scratch block 0")
                if b not in self._owner:
                    raise ValueError(f"double free of kv block {b}")
                del self._owner[b]
                self._free.append(b)
            self._g_used.set(len(self._owner))

    def owners(self) -> Dict[int, int]:
        """{block id: sequence id} snapshot (tests, debugging)."""
        with self._lock:
            return dict(self._owner)

    # -- defrag ----------------------------------------------------------
    def defrag_plan(self) -> Tuple[np.ndarray, Dict[int, int]]:
        """Compaction plan: allocated blocks move to the front ``1..used``
        in ascending order of their current ids (stable: a second defrag
        is the identity).

        Returns ``(old_of_new, remap)``: ``old_of_new`` is a permutation
        of ``0..num_blocks-1`` with ``old_of_new[new] = old``, the gather
        index the engine applies to every pool tensor, and ``remap``
        maps each held block's old id to its new one for the tables. The
        ENGINE applies the plan (pool gather and table rewrite under its
        lock, no step in flight); this method commits the allocator's
        own state to the compacted layout, so call it only when the plan
        will be applied."""
        with self._lock:
            alive = sorted(self._owner)
            old_of_new = np.empty((self.num_blocks,), np.int32)
            old_of_new[0] = SCRATCH_BLOCK
            remap: Dict[int, int] = {}
            for new_id, old_id in enumerate(alive, start=1):
                old_of_new[new_id] = old_id
                remap[old_id] = new_id
            tail = [b for b in range(1, self.num_blocks) if b not in remap]
            for off, old_id in enumerate(tail):
                old_of_new[1 + len(alive) + off] = old_id
            self._owner = {remap[b]: sid for b, sid in self._owner.items()}
            self._free = list(range(self.num_blocks - 1, len(alive), -1))
            return old_of_new, remap

    def unregister(self) -> None:
        """Drop this pool's gauges from the registry (the engine's
        close)."""
        self._g_used_fam.remove_labels(self.instance)
        self._g_cap_fam.remove_labels(self.instance)
