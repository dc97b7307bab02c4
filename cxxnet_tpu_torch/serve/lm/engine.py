"""LMEngine: autoregressive decoding over a paged KV-cache (the port of
``cxxnet_tpu/serve/lm/engine.py``).

It wraps a loaded :class:`serve.engine.InferenceEngine` (its network,
weights and device) and adds the execution model the whole-request
engine cannot express:

* **a paged KV-cache**: one preallocated ``(num_blocks, block_size,
  heads, head_dim)`` k pool and one v pool per mha layer, in
  ``kv_dtype``, on the weights' device (the JAX package's
  ``parallel/rules.py`` placement is the identity on one device; model
  parallelism waits for ROADMAP Queue A 9). Per-sequence block tables
  are fixed-width ``(T,)`` host arrays padded with the scratch block 0;
  attention over the cache is ``ops.attention.paged_attention``.

* **one step for prefill and decode**: prefill runs it at ``(B = 1, C =
  prefill_chunk)``, decode at ``(B = max_seqs, C = 1)``. The runners are
  kept in a cache keyed ``("step", B, C)`` and ``("install",)`` with hit
  and miss counts (``cxxnet_lm_compile_cache_events_total{engine,event}``),
  as the JAX package keys its compiled cells, so the
  miss count freezes after warm-up (in eager torch a runner is a
  closure; the count starts to cost something with the captured step,
  ROADMAP Queue A 13). Every shape in a cell is fixed (T,
  C); varying lengths live only in the ``lengths`` mask.

* **bit-parity by construction**: every op of the step is row-
  independent, block ids never enter the arithmetic, and the continuous
  scheduler and :meth:`generate_whole` drive the same cells with the
  same per-row inputs, so their greedy tokens are bit-equal.

The graph is interpreted layer by layer: embed, posembed and mha take
position-aware paths (ids clamped at 0, the position table's rows at
``positions``, ``rope_at``, the cache write, paged attention);
layernorm, ffn, seqfc and add go through the layers' own ``forward``
on ``(B, C, 1, E)`` nodes, the training layout with C in place of S.

An int8 engine (``serve_dtype = int8``, a PTQ-derived round) steps in
float32, as the JAX int8 engine does: the quantized ``seqfc`` head goes
through ``int8_matmul`` (the ``q_mm`` kernel on the card, at M = the
step's B * C rows), and embed, posembed, mha, ffn and layernorm stay
float32. A step reads the params and the layer state as one pair
(``Network.weights_pair``), so a weights swap never lands inside it.

Card work goes on the device's current stream (no side streams: the
kernels' ``split_scratch`` relies on one stream a device), and a step
reads the device once: the greedy tokens. Its integer inputs go up in
one host-to-device copy.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ...config import LMServeConfig, parse_policy
from ...layers import ApplyCtx
from ...layers.seq import _linear, _seq, _unseq
from ...ops.attention import paged_attention, rope_at
from ...telemetry.anomaly import note_compile
from ...telemetry.registry import REGISTRY
from ..engine import InferenceEngine
from .blocks import SCRATCH_BLOCK, BlockPool

__all__ = ["LMEngine", "SUPPORTED_TYPES", "kv_from_numpy", "kv_to_numpy"]

#: layer types the LM interpreter understands; anything else in the
#: graph raises at build time instead of answering wrongly
SUPPORTED_TYPES = frozenset({"embed", "layernorm", "posembed", "mha",
                             "ffn", "seqfc", "add", "lmloss"})


def kv_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A cache tensor as a host array. bfloat16 has no numpy type: its
    bits travel as 2-byte void (numpy's ``V2``, the bytes of the JAX
    package's ml_dtypes bfloat16, whose dtype string reads ``<V2``)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.dtype("V2"))
    return t.cpu().numpy()


def kv_from_numpy(a: np.ndarray) -> torch.Tensor:
    """Inverse of :func:`kv_to_numpy` (a CPU tensor)."""
    a = np.ascontiguousarray(a)
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(a.copy())


class LMEngine:
    """Paged-KV autoregressive engine over a wrapped InferenceEngine; its
    pools live on the weights' device."""

    def __init__(self, engine: InferenceEngine, cfg: LMServeConfig):
        self.engine = engine
        self.cfg = cfg
        net = engine.net
        self.net = net
        c, y, s = net.graph.input_shape
        if c != 1 or y != 1:
            raise ValueError(
                "lm serve needs a flat (1,1,S) token-id input node, got "
                f"input_shape {net.graph.input_shape}")
        self.device = _norm(net.device)
        self.block_size = cfg.kv_block_size
        self.num_blocks = cfg.kv_pool_blocks
        self.max_seqs = cfg.max_seqs
        self.max_context = cfg.max_context
        self.chunk = cfg.prefill_chunk
        #: fixed block-table width: every step runs at this T, so the
        #: attention's reduction is the same in every cell
        self.T = cfg.max_blocks_per_seq
        self.compute_dtype = engine.compute_dtype
        self.kv_dtype = (parse_policy(cfg.kv_dtype).compute_dtype
                         if cfg.kv_dtype else self.compute_dtype)
        self.vocab = 0
        self._mha: List[Tuple[int, object]] = []   # (layer index, layer)
        self._validate_graph()
        self.block_pool = BlockPool(self.num_blocks, self.block_size,
                                    instance=engine.stats.instance)
        self.pools = self._init_pools()
        self._pool_lock = threading.Lock()
        self._cache: Dict[tuple, object] = {}
        self._cache_lock = threading.Lock()
        self._hits = 0
        self._misses = 0
        # the cell cache's hits and misses, a family of its own as in the
        # JAX package
        self._cc_fam = REGISTRY.counter(
            "cxxnet_lm_compile_cache_events_total",
            "LM step compile-cache events", labels=("engine", "event"))
        self._c_hit = self._cc_fam.labels(engine.stats.instance, "hit")
        self._c_miss = self._cc_fam.labels(engine.stats.instance, "miss")

    # -- validation / pools ----------------------------------------------
    def _validate_graph(self) -> None:
        g = self.net.graph
        net = self.net
        seen_loss = False
        for li, (spec, layer) in enumerate(zip(g.layers, net.layers)):
            if spec.type not in SUPPORTED_TYPES:
                raise ValueError(
                    f"lm serve: unsupported layer type {spec.type!r} "
                    f"({spec.name!r}); supported: "
                    + ", ".join(sorted(SUPPORTED_TYPES)))
            if layer.is_loss:
                seen_loss = True
                continue
            if seen_loss:
                raise ValueError(
                    "lm serve: loss layers must come last in the graph")
            if spec.type == "embed":
                self.vocab = layer.vocab_size
            if spec.type == "mha":
                if not layer.causal:
                    raise ValueError(
                        f"lm serve: mha {spec.name!r} must be causal "
                        "(causal = 1) for autoregressive decoding")
                if spec.is_shared:
                    raise ValueError(
                        "lm serve: weight-tied (shared) mha layers are "
                        "not supported — each graph position needs its "
                        "own KV pool")
                self._mha.append((li, layer))
            if spec.type == "posembed":
                e, s, _ = net.node_shapes[spec.nindex_in[0]]
                if s < self.max_context:
                    raise ValueError(
                        f"lm serve: posembed table covers {s} positions "
                        f"< lm_serve_max_context {self.max_context}")
        if not self._mha:
            raise ValueError("lm serve: graph has no mha layer")
        if self.vocab <= 0:
            raise ValueError("lm serve: graph has no embed layer")

    def _init_pools(self) -> Dict[str, Dict[str, torch.Tensor]]:
        net = self.net
        pools = {}
        for li, layer in self._mha:
            spec = net.graph.layers[li]
            e = net.node_shapes[spec.nindex_in[0]][0]
            shape = (self.num_blocks, self.block_size, layer.nhead,
                     e // layer.nhead)
            pools[spec.name] = {
                kv: torch.zeros(shape, dtype=self.kv_dtype,
                                device=self.device) for kv in ("k", "v")}
        return pools

    # -- the step --------------------------------------------------------
    def _kv_write(self, pool, kv, tables, positions, lengths) -> None:
        """Write this step's keys or values into the pool. Positions
        at or past a row's length (chunk padding, dead rows) go to the
        scratch block 0, which the mask never reads, so one fixed-shape
        ``index_put_`` covers every case."""
        valid = (positions >= 0) & (positions < lengths[:, None])
        blk = torch.clamp(torch.div(positions, self.block_size,
                                    rounding_mode="floor"), 0, self.T - 1)
        blocks = torch.gather(tables, 1, blk)
        blocks = torch.where(valid, blocks, SCRATCH_BLOCK)
        slots = torch.where(valid, positions % self.block_size, 0)
        pool.index_put_((blocks, slots), kv.to(pool.dtype))

    def _mha_step(self, layer, lp, x, pool, tables, positions, lengths,
                  cdt):
        """The mha layer's decode-path forward: the projections, bias,
        rope and output product of ``layers/seq.py``'s forward, with
        attention over the paged cache instead of the node's own k, v."""
        xs = _seq(x).to(cdt)
        q, k, v = (_linear(xs, lp[nm], "bse,ehd->bshd", cdt)
                   for nm in ("q", "k", "v"))
        if layer.rope:
            pos = torch.clamp(positions, min=0)
            q = rope_at(q, layer.rope_theta, pos)
            k = rope_at(k, layer.rope_theta, pos)
        self._kv_write(pool["k"], k, tables, positions, lengths)
        self._kv_write(pool["v"], v, tables, positions, lengths)
        o = paged_attention(q.to(pool["k"].dtype), pool["k"], pool["v"],
                            tables, positions, lengths)
        return _unseq(_linear(o.to(cdt), lp["o"], "bshd,hde->bse", cdt))

    def _make_step(self, B: int, C: int):
        """The runner of one (B, C) cell: unpacks the step's one int64
        upload and interprets the graph."""
        net = self.net
        g = net.graph
        cdt = self.compute_dtype
        mha_at = {li for li, _ in self._mha}
        out_node = [spec.nindex_out[0] for spec, layer
                    in zip(g.layers, net.layers) if not layer.is_loss][-1]
        rows = torch.arange(B, device=self.device)
        n, T = B * C, self.T
        ctx = ApplyCtx(compute_dtype=cdt, fused=net.fused)

        @torch.no_grad()
        def step(packed: torch.Tensor):
            ids = packed[:n].view(B, C)
            positions = packed[n:2 * n].view(B, C)
            lengths = packed[2 * n:2 * n + B]
            last_idx = packed[2 * n + B:2 * n + 2 * B]
            tables = packed[2 * n + 2 * B:].view(B, T)
            # one pair read: a hot reload never lands inside a step
            params, state = net.weights_pair(cdt)
            nodes: List[Optional[torch.Tensor]] = [None] * g.num_nodes
            for li, (spec, layer) in enumerate(zip(g.layers, net.layers)):
                if layer.is_loss:
                    continue
                lp = params.get(layer.name, {})
                if spec.type == "embed":
                    w = lp["wmat"].to(cdt)
                    out = torch.nn.functional.embedding(
                        torch.clamp(ids, min=0), w)
                    nodes[spec.nindex_out[0]] = out.reshape(B, C, 1, -1)
                elif spec.type == "posembed":
                    pe = lp["wmat"].to(cdt)
                    p = torch.clamp(positions, 0, pe.shape[0] - 1)
                    nodes[spec.nindex_out[0]] = (
                        nodes[spec.nindex_in[0]]
                        + pe[p].reshape(B, C, 1, -1))
                elif li in mha_at:
                    nodes[spec.nindex_out[0]] = self._mha_step(
                        layer, lp, nodes[spec.nindex_in[0]],
                        self.pools[spec.name], tables, positions, lengths,
                        cdt)
                else:
                    outs = layer.forward(lp, state.get(layer.name, {}),
                                         [nodes[i] for i in spec.nindex_in],
                                         ctx)
                    for i, o in zip(spec.nindex_out, outs):
                        nodes[i] = o
            logits = nodes[out_node].reshape(B, C, -1).float()
            last = logits[rows, last_idx]                   # (B, V)
            return torch.argmax(last, dim=-1), last

        return step

    def _make_install(self):
        @torch.no_grad()
        def install(table: torch.Tensor,
                    kv: Dict[str, Dict[str, torch.Tensor]]) -> None:
            for name, ent in kv.items():
                for w in ("k", "v"):
                    pool = self.pools[name][w]
                    pool.index_put_((table,), ent[w].to(
                        self.device, pool.dtype))
        return install

    def _compiled(self, key):
        """Look up a runner (``("step", B, C)`` or ``("install",)``); a
        miss builds it and counts."""
        with self._cache_lock:
            fn = self._cache.get(key)
            if fn is not None:
                self._hits += 1
                self._c_hit.inc()
                return fn
            t0 = time.perf_counter()
            fn = (self._make_step(key[1], key[2]) if key[0] == "step"
                  else self._make_install())
            self._cache[key] = fn
            self._misses += 1
            self._c_miss.inc()
            note_compile(time.perf_counter() - t0, "lm:" + "/".join(
                map(str, key)))
            return fn

    def compile_info(self) -> Dict[str, int]:
        with self._cache_lock:
            return {"size": len(self._cache), "hits": self._hits,
                    "misses": self._misses}

    # -- public step API (scheduler + whole-request path) ----------------
    def step(self, ids: np.ndarray, positions: np.ndarray,
             tables: np.ndarray, lengths: np.ndarray,
             last_idx: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
        """One step of the (B, C) cell that ``ids`` (B, C) names: write
        the chunk's keys and values, return the greedy tokens (B,) and
        the f32 logits at ``last_idx`` (B, V), both on the device."""
        B, C = ids.shape
        fn = self._compiled(("step", B, C))
        packed = np.concatenate([
            np.asarray(a, np.int64).reshape(-1)
            for a in (ids, positions, lengths, last_idx, tables)])
        with self._pool_lock:
            return fn(torch.from_numpy(packed).to(self.device))

    def run_prefill(self, table: np.ndarray, ids: np.ndarray, p0: int,
                    n_real: int) -> int:
        """One prefill chunk of ONE sequence: write KV for positions
        ``p0 .. p0+n_real-1`` and return the greedy token after the
        chunk's last real position (meaningful only for the prompt's
        last chunk). ``ids`` is the fixed-width chunk (C,), padded past
        ``n_real``."""
        C = int(ids.shape[0])
        token, _ = self.step(
            ids.reshape(1, C), (p0 + np.arange(C))[None, :],
            np.asarray(table).reshape(1, -1), [p0 + n_real], [n_real - 1])
        return int(token.cpu()[0])

    def run_decode(self, ids: np.ndarray, positions: np.ndarray,
                   tables: np.ndarray, lengths: np.ndarray) -> np.ndarray:
        """One continuous-batching decode step over the fixed
        ``max_seqs`` rows (C = 1). Dead rows carry ``lengths = 0`` and
        all-scratch tables; their tokens are garbage by contract and the
        scheduler never reads them. Returns the greedy tokens (B,)."""
        B = self.max_seqs
        token, _ = self.step(np.asarray(ids).reshape(B, 1),
                             np.asarray(positions).reshape(B, 1), tables,
                             lengths, np.zeros((B,), np.int64))
        return token.cpu().numpy()

    # -- whole-request reference path ------------------------------------
    def generate_whole(self, prompt, max_new: Optional[int] = None
                       ) -> List[int]:
        """Greedy decode of one request through the SAME cells the
        continuous scheduler uses (prefill chunks, then the B-row decode
        cell with only row 0 live): the bit-parity reference, and a
        synchronous generate for tools. Allocates from the shared block
        pool and frees on exit."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        max_new = int(max_new or self.cfg.max_new_tokens)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if prompt.size + 1 > self.max_context:
            raise ValueError(
                f"prompt length {prompt.size} leaves no room to "
                f"generate within lm_serve_max_context {self.max_context}")
        pool = self.block_pool
        table = np.zeros((self.T,), np.int32)
        blocks: List[int] = []

        def ensure(n_tokens):
            need = pool.blocks_for_tokens(n_tokens)
            while len(blocks) < need:
                got = pool.alloc(1, seq_id=-1)
                table[len(blocks)] = got[0]
                blocks.extend(got)

        try:
            token = None
            p0 = 0
            while p0 < prompt.size:
                c = min(self.chunk, prompt.size - p0)
                ids = np.zeros((self.chunk,), np.int32)
                ids[:c] = prompt[p0:p0 + c]
                ensure(p0 + c)
                token = self.run_prefill(table, ids, p0, c)
                p0 += c
            generated = [token]
            L = prompt.size
            eos = self.cfg.eos
            while (len(generated) < max_new and L < self.max_context
                   and not (eos >= 0 and generated[-1] == eos)):
                ensure(L + 1)
                B = self.max_seqs
                ids = np.zeros((B,), np.int32)
                positions = np.zeros((B,), np.int32)
                tables = np.zeros((B, self.T), np.int32)
                lengths = np.zeros((B,), np.int32)
                ids[0] = generated[-1]
                positions[0] = L
                tables[0] = table
                lengths[0] = L + 1
                toks = self.run_decode(ids, positions, tables, lengths)
                generated.append(int(toks[0]))
                L += 1
            return generated
        finally:
            if blocks:
                pool.free(blocks)

    # -- KV extraction / injection (prefill/decode handoff) --------------
    def extract_kv(self, table: np.ndarray
                   ) -> Dict[str, Dict[str, np.ndarray]]:
        """Host copy of one sequence's cache blocks, gathered by its
        table at the full fixed ``(T, bs, H, D)`` shape (padding blocks
        are scratch content the receiving mask never reads)."""
        idx = torch.from_numpy(np.asarray(table, np.int64)).to(self.device)
        with self._pool_lock, torch.no_grad():
            return {name: {kv: kv_to_numpy(p[kv][idx]) for kv in ("k", "v")}
                    for name, p in self.pools.items()}

    def install_kv(self, table: np.ndarray,
                   kv: Dict[str, Dict[str, np.ndarray]]) -> None:
        """Write a shipped sequence's KV into this engine's pools at the
        receiver's own block table (one runner, one fixed shape)."""
        if set(kv) != set(self.pools):
            raise ValueError(
                f"kv handoff layers {sorted(kv)} != engine layers "
                f"{sorted(self.pools)}")
        fn = self._compiled(("install",))
        idx = torch.from_numpy(np.asarray(table, np.int64)).to(self.device)
        ents = {name: {w: kv_from_numpy(ent[w]) for w in ("k", "v")}
                for name, ent in kv.items()}
        with self._pool_lock:
            fn(idx, ents)

    # -- defrag ----------------------------------------------------------
    def defrag(self) -> Dict[int, int]:
        """Compact allocated blocks to the front of the pool: gather every
        pool tensor through the allocator's permutation and return the
        old -> new id remap the caller applies to its block tables. Runs
        under the pool lock, so no step sees blocks mid-move."""
        with self._pool_lock, torch.no_grad():
            old_of_new, remap = self.block_pool.defrag_plan()
            perm = torch.from_numpy(old_of_new.astype(np.int64)).to(
                self.device)
            for p in self.pools.values():
                for w in ("k", "v"):
                    p[w] = p[w][perm]
            return remap

    def close(self) -> None:
        """Release the pools' device memory and drop the engine's
        series."""
        with self._pool_lock:
            self.pools = {}
        self.block_pool.unregister()
        self._cc_fam.remove_labels(self.engine.stats.instance, "hit")
        self._cc_fam.remove_labels(self.engine.stats.instance, "miss")


def _norm(device) -> torch.device:
    """A device with its index filled in (``cuda`` -> ``cuda:<current>``)."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d
