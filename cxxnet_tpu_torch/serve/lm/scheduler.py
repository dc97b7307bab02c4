"""Continuous (iteration-level) batching scheduler for LM decoding (the
port of ``cxxnet_tpu/serve/lm/scheduler.py``), with its run-ledger
events: ``lm_serve_start``, ``kv_evict`` and ``prefill_handoff``.

One scheduler thread per LMEngine drives the Orca-style loop:

* every iteration runs AT MOST one prefill chunk (for the oldest
  sequence still prefilling) and then ONE decode step over the fixed
  ``max_seqs`` decode rows — so long prompts are chunked between decode
  steps and never stall in-flight generations;
* sequences are admitted into decode rows the moment a row and the KV
  blocks are free, and evicted the moment they finish — no batch
  barrier, no waiting for stragglers;
* eviction frees exactly the sequence's blocks: finish (eos / length),
  client cancel, deadline expiry, and pool-pressure eviction (the
  most-recently-admitted block-holder loses, preserving FIFO progress
  so the loop always drains — no starvation).

Results stream through :class:`StreamHandle`: the caller (server.py's
``/generate``, the handoff listener, tools) iterates ndjson-able event
dicts as tokens land. ``handle.result()`` is the synchronous view and
maps terminal errors onto the SAME exceptions the request batcher uses
(``Backpressure`` -> 503, ``DeadlineExceeded`` -> 504), so server.py's
error table needs no new rows.

Prefill/decode disaggregation: with ``role = "prefill"`` and a peer
address, a sequence that finishes prefill has its KV state extracted,
its LOCAL blocks freed, and the cache shipped to the peer's handoff
listener over the data_service wire frames (see handoff.py); the
decode engine admits it via :meth:`admit_handoff` and events are
relayed back over the same connection. ``role = "decode"`` accepts
ONLY handoffs. Every scheduler runs the listener (ephemeral port,
``handoff_addr``) so a mid-run role split needs no restart.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from ...config import LMServeConfig
from ...telemetry.ledger import LEDGER
from ..batcher import Backpressure, DeadlineExceeded
from .blocks import PoolExhausted
from .engine import LMEngine

__all__ = ["LMScheduler", "StreamHandle", "Sequence"]


class StreamHandle:
    """Per-request event stream + synchronous result view."""

    def __init__(self, seq_id: int):
        self.seq_id = seq_id
        self._q: "queue.Queue[Dict]" = queue.Queue()
        self._done = threading.Event()
        self._cancel_cb = None
        self.cancelled = False

    # scheduler side --------------------------------------------------
    def push(self, event: Dict) -> None:
        self._q.put(event)
        if event.get("event") in ("done", "error"):
            self._done.set()

    # client side -----------------------------------------------------
    def cancel(self) -> None:
        """Client went away / asked to stop: the scheduler evicts the
        sequence at the next step and frees its blocks."""
        self.cancelled = True
        cb = self._cancel_cb
        if cb is not None:
            cb()

    def events(self, timeout: Optional[float] = None):
        """Yield events until the terminal one (inclusive); raise
        ``TimeoutError`` once ``timeout`` seconds have gone by without
        it."""
        deadline = time.monotonic() + timeout if timeout else None
        while True:
            left = None if deadline is None else deadline - time.monotonic()
            if left is not None and left <= 0:
                raise TimeoutError("stream read timed out")
            try:
                ev = self._q.get(timeout=left)
            except queue.Empty:
                raise TimeoutError("stream read timed out") from None
            yield ev
            if ev.get("event") in ("done", "error"):
                return

    def result(self, timeout: Optional[float] = None) -> Dict:
        """Drain the stream; return the terminal 'done' event. Error
        events re-raise as the batcher exception of the same meaning."""
        last = None
        for ev in self.events(timeout=timeout):
            last = ev
        if last.get("event") == "error":
            reason = last.get("reason", "")
            if reason == "deadline":
                raise DeadlineExceeded(last.get("error", "lm deadline"))
            if reason == "pressure":
                raise Backpressure(last.get("error", "kv pool pressure"))
            raise RuntimeError(last.get("error", "lm generate failed"))
        return last


class Sequence:
    """Scheduler-internal per-request state."""

    __slots__ = ("seq_id", "prompt", "max_new", "deadline", "handle",
                 "table", "blocks", "p0", "generated", "admitted_at",
                 "row", "remote_src", "finished")

    def __init__(self, seq_id: int, prompt: np.ndarray, max_new: int,
                 deadline: Optional[float], handle: StreamHandle, T: int):
        self.seq_id = seq_id
        self.prompt = prompt
        self.max_new = max_new
        self.deadline = deadline          # absolute time.monotonic()
        self.handle = handle
        self.table = np.zeros((T,), np.int32)
        self.blocks: List[int] = []
        self.p0 = 0                       # prefill progress (tokens cached)
        self.generated: List[int] = []
        self.admitted_at = time.monotonic()
        self.row: Optional[int] = None
        self.remote_src = False           # admitted via handoff
        self.finished = False             # terminal; _finish ran


class LMScheduler:
    """Decode-step scheduler: continuous batching + streaming +
    prefill/decode disaggregation over one LMEngine."""

    def __init__(self, lm_engine: LMEngine, cfg: LMServeConfig,
                 role: Optional[str] = None,
                 peer: Optional[Tuple[str, int]] = None):
        self.engine = lm_engine
        self.cfg = cfg
        self.role = role or cfg.role
        self.peer = peer
        self._lock = threading.Lock()
        self._waiting: "deque[Sequence]" = deque()
        self._prefilling: "deque[Sequence]" = deque()
        self._ready: "deque[Sequence]" = deque()
        self._active: Dict[int, Sequence] = {}     # row -> seq
        self._free_rows: List[int] = list(range(cfg.max_seqs - 1, -1, -1))
        self._seq_counter = 0
        self._live = 0                             # admitted, not terminal
        self._wake = threading.Event()
        self._stopping = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="lm-scheduler", daemon=True)
        self._ship_threads: List[threading.Thread] = []
        self.listener = None
        self.handoff_addr: Optional[Tuple[str, int]] = None
        self.steps = 0
        self.evictions = 0

    # -- lifecycle -----------------------------------------------------
    def start(self, handoff_port: Optional[int] = None) -> None:
        from .handoff import HandoffListener
        self.listener = HandoffListener(
            self, port=self.cfg.handoff_port
            if handoff_port is None else handoff_port)
        self.listener.start()
        self.handoff_addr = self.listener.addr
        LEDGER.event("lm_serve_start", role=self.role,
                     max_seqs=self.cfg.max_seqs,
                     kv_blocks=self.engine.block_pool.capacity,
                     kv_block_size=self.cfg.kv_block_size,
                     handoff_port=self.handoff_addr[1])
        self._thread.start()

    def set_role(self, role: str,
                 peer: Optional[Tuple[str, int]] = None) -> None:
        """Flip this scheduler's plane mid-run (no restart): already-
        admitted sequences finish under the old plan; new prefill
        completions follow the new role."""
        if role not in ("both", "prefill", "decode"):
            raise ValueError(f"bad lm role {role!r}")
        with self._lock:
            self.role = role
            self.peer = peer
        self._wake.set()

    def stop(self, drain: bool = True, timeout: float = 10.0) -> None:
        if drain:
            deadline = time.monotonic() + timeout
            while self.live_count() and time.monotonic() < deadline:
                time.sleep(0.01)
        # whatever is left gets cancelled so handles always terminate
        with self._lock:
            leftovers = (list(self._waiting) + list(self._prefilling)
                         + list(self._ready) + list(self._active.values()))
        for seq in leftovers:
            seq.handle.cancelled = True
        self._stopping.set()
        self._wake.set()
        if self._thread.is_alive():
            self._thread.join(timeout=timeout)
        # the loop may have exited before seeing the cancel flags —
        # sweep once more so every outstanding handle terminates and
        # every block goes back to the pool (safe even if the join
        # timed out and the loop is still running: _finish is
        # idempotent, so a racing double-finish is a no-op)
        self._sweep_expired()
        if self.listener is not None:
            self.listener.stop()
        for t in self._ship_threads:
            t.join(timeout=timeout)

    # -- admission -----------------------------------------------------
    def submit(self, prompt, max_new: Optional[int] = None,
               deadline_ms: Optional[float] = None) -> StreamHandle:
        """Admit a prompt; returns immediately with the stream handle.
        Raises Backpressure (503) when the LM queue budget is spent."""
        with self._lock:
            if self.role == "decode":
                raise ValueError(
                    "decode-role replica accepts only prefill handoffs")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if prompt.size + 1 > self.cfg.max_context:
            raise ValueError(
                f"prompt length {prompt.size} exceeds lm_serve_max_context"
                f" {self.cfg.max_context} - 1")
        max_new = int(max_new or self.cfg.max_new_tokens)
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        dl_ms = self.cfg.deadline_ms if deadline_ms is None else deadline_ms
        deadline = time.monotonic() + dl_ms / 1e3 if dl_ms else None
        with self._lock:
            if len(self._waiting) + len(self._prefilling) \
                    >= self.cfg.max_queue:
                raise Backpressure(
                    f"lm queue full ({self.cfg.max_queue} sequences "
                    "waiting); retry later")
            self._seq_counter += 1
            seq = Sequence(self._seq_counter, prompt, max_new, deadline,
                           StreamHandle(self._seq_counter), self.engine.T)
            seq.handle._cancel_cb = self._wake.set
            self._waiting.append(seq)
            self._live += 1
        self._wake.set()
        return seq.handle

    def admit_handoff(self, prompt_len: int, first_token: int,
                      max_new: int, deadline_ms: float,
                      kv: Dict[str, Dict[str, np.ndarray]]) -> StreamHandle:
        """Decode-plane entry: install shipped KV state, emit the first
        token (computed by the prefill plane), and queue the sequence
        for decode rows. Runs on the handoff listener's connection
        thread; raises Backpressure / PoolExhausted back to the wire
        when this engine cannot take the sequence."""
        prompt_len = int(prompt_len)
        if prompt_len < 1 or prompt_len + 1 > self.cfg.max_context:
            raise ValueError(f"bad handoff prompt_len {prompt_len}")
        with self._lock:
            if len(self._ready) >= self.cfg.max_queue:
                raise Backpressure("lm decode queue full; retry later")
            self._seq_counter += 1
            seq_id = self._seq_counter
            self._live += 1
        deadline = (time.monotonic() + deadline_ms / 1e3
                    if deadline_ms else None)
        seq = Sequence(seq_id, np.zeros((prompt_len,), np.int32),
                       int(max_new), deadline, StreamHandle(seq_id),
                       self.engine.T)
        seq.remote_src = True
        seq.handle._cancel_cb = self._wake.set
        pool = self.engine.block_pool
        try:
            need = pool.blocks_for_tokens(prompt_len)
            got = pool.alloc(need, seq.seq_id)
            seq.blocks.extend(got)
            seq.table[:need] = got
            self.engine.install_kv(seq.table, kv)
        except BaseException:
            with self._lock:
                self._live -= 1
            if seq.blocks:
                pool.free(seq.blocks)
            raise
        seq.p0 = prompt_len
        self._first_token(seq, int(first_token))
        # same guard as _prefill_chunk: _first_token may have finished
        # the sequence (eos / max_new <= 1), in which case its blocks
        # are already freed and queueing it would run a second decode
        # lifecycle on a terminal sequence
        if seq.generated and seq.blocks:
            with self._lock:
                self._ready.append(seq)
            self._wake.set()
        return seq.handle

    # -- probes --------------------------------------------------------
    def live_count(self) -> int:
        """Sequences admitted and not yet terminal — INCLUDING ones
        only holding KV blocks between steps. Wired into
        MicroBatcher.add_idle_probe so a drain waits for decode state,
        not just batch rows."""
        with self._lock:
            return self._live

    def snapshot(self) -> Dict:
        with self._lock:
            out = {"role": self.role,
                   "waiting": len(self._waiting),
                   "prefilling": len(self._prefilling),
                   "ready": len(self._ready),
                   "active": len(self._active),
                   "live": self._live,
                   "steps": self.steps,
                   "evictions": self.evictions}
        pool = self.engine.block_pool
        out["kv_blocks_used"] = pool.used
        out["kv_blocks_total"] = pool.capacity
        out["compile"] = self.engine.compile_info()
        return out

    # -- internals -----------------------------------------------------
    def _finish(self, seq: Sequence, reason: str) -> None:
        """Terminal bookkeeping shared by every exit path: exactly the
        sequence's own blocks go back to the pool, its row frees, and
        its handle gets the terminal event. Idempotent: the first
        caller wins (the flag is checked-and-set under the lock), so a
        stop()-time sweep racing the scheduler loop can never double-
        free blocks, underflow _live, or emit a second terminal event."""
        with self._lock:
            if seq.finished:
                return
            seq.finished = True
            if seq.row is not None:
                self._active.pop(seq.row, None)
                self._free_rows.append(seq.row)
                seq.row = None
            self._live -= 1
        if seq.blocks:
            self.engine.block_pool.free(seq.blocks)
            seq.blocks = []
        if reason in ("eos", "length", "cancelled"):
            seq.handle.push({"event": "done", "reason": reason,
                             "tokens": list(seq.generated),
                             "seq": seq.seq_id})
        else:
            seq.handle.push({"event": "error", "reason": reason,
                             "error": f"sequence evicted: {reason}",
                             "tokens": list(seq.generated),
                             "seq": seq.seq_id})
        if reason not in ("eos", "length"):
            self.evictions += 1
            LEDGER.event("kv_evict", seq=seq.seq_id, reason=reason,
                         tokens=len(seq.generated))

    def _first_token(self, seq: Sequence, token: int) -> None:
        """Record + emit generated token 0 (from the prefill cell),
        finishing immediately when it already satisfies eos/limits."""
        seq.generated.append(token)
        seq.handle.push({"event": "token", "index": 0, "token": token})
        eos = self.cfg.eos
        if (eos >= 0 and token == eos) or seq.max_new <= 1:
            self._finish(seq, "eos" if eos >= 0 and token == eos
                         else "length")
        elif seq.p0 >= self.cfg.max_context:
            self._finish(seq, "length")

    def _ensure_blocks(self, seq: Sequence, n_tokens: int) -> bool:
        """Grow the sequence's table to cover ``n_tokens`` cache slots,
        evicting the most-recently-admitted block-holder under pool
        pressure. Returns False when SEQ ITSELF was the victim."""
        pool = self.engine.block_pool
        need = pool.blocks_for_tokens(n_tokens)
        while len(seq.blocks) < need:
            try:
                got = pool.alloc(1, seq.seq_id)
            except PoolExhausted:
                victim = self._pressure_victim()
                if victim is None or victim is seq:
                    self._drop_from_queues(seq)
                    self._finish(seq, "pressure")
                    return False
                self._drop_from_queues(victim)
                self._finish(victim, "pressure")
                continue
            seq.table[len(seq.blocks)] = got[0]
            seq.blocks.extend(got)
        return True

    def _pressure_victim(self) -> Optional[Sequence]:
        """Most-recently-admitted sequence holding blocks: FIFO progress
        is preserved (the oldest work always completes), so the loop
        cannot livelock — that is the no-starvation property the tests
        assert."""
        with self._lock:
            holders = [s for s in (list(self._prefilling)
                                   + list(self._ready)
                                   + list(self._active.values()))
                       if s.blocks]
        if not holders:
            return None
        return max(holders, key=lambda s: s.admitted_at)

    def _sweep_expired(self) -> None:
        """Deadline + cancel eviction across every queue."""
        now = time.monotonic()
        with self._lock:
            everyone = (list(self._waiting) + list(self._prefilling)
                        + list(self._ready) + list(self._active.values()))
        for seq in everyone:
            if seq.handle.cancelled:
                self._drop_from_queues(seq)
                self._finish(seq, "cancelled")
            elif seq.deadline is not None and now > seq.deadline:
                self._drop_from_queues(seq)
                self._finish(seq, "deadline")

    def _drop_from_queues(self, seq: Sequence) -> None:
        with self._lock:
            for q in (self._waiting, self._prefilling, self._ready):
                try:
                    q.remove(seq)
                except ValueError:
                    pass

    def _run(self) -> None:
        while not self._stopping.is_set():
            did_work = self._step_once()
            if not did_work:
                self._wake.wait(timeout=0.01)
                self._wake.clear()

    def _step_once(self) -> bool:
        """One scheduler iteration; returns whether anything ran."""
        self._sweep_expired()
        did = False
        # admit waiting -> prefilling (no block cost yet; the chunk loop
        # allocates as it writes)
        with self._lock:
            while self._waiting:
                self._prefilling.append(self._waiting.popleft())
        # one prefill chunk, oldest first — interleaved, never a loop
        with self._lock:
            seq = self._prefilling[0] if self._prefilling else None
        if seq is not None:
            did = True
            self._prefill_chunk(seq)
        # promote ready -> decode rows
        with self._lock:
            while self._ready and self._free_rows:
                s = self._ready.popleft()
                s.row = self._free_rows.pop()
                self._active[s.row] = s
        # one decode step over whoever holds a row
        if self._decode_step():
            did = True
        return did

    def _prefill_chunk(self, seq: Sequence) -> None:
        c = min(self.cfg.prefill_chunk, seq.prompt.size - seq.p0)
        if not self._ensure_blocks(seq, seq.p0 + c):
            self._drop_from_queues(seq)
            return
        ids = np.zeros((self.cfg.prefill_chunk,), np.int32)
        ids[:c] = seq.prompt[seq.p0:seq.p0 + c]
        token = self.engine.run_prefill(seq.table, ids, seq.p0, c)
        seq.p0 += c
        if seq.p0 < seq.prompt.size:
            return                      # more chunks to go
        self._drop_from_queues(seq)
        with self._lock:
            role, peer = self.role, self.peer
        if role == "prefill" and peer is not None:
            self._hand_off(seq, token, peer)
            return
        self._first_token(seq, token)
        if seq.generated and seq.blocks:
            with self._lock:
                self._ready.append(seq)

    def _hand_off(self, seq: Sequence, first_token: int,
                  peer: Tuple[str, int]) -> None:
        """Ship cache + first token to the decode plane; local blocks
        free IMMEDIATELY (the whole point of disaggregation), and a
        relay thread pumps the peer's events into the local handle."""
        from .handoff import ship_prefill
        kv = self.engine.extract_kv(seq.table)
        self.engine.block_pool.free(seq.blocks)
        seq.blocks = []
        left_ms = 0.0
        if seq.deadline is not None:
            left_ms = max(1.0, (seq.deadline - time.monotonic()) * 1e3)
        LEDGER.event("prefill_handoff", seq=seq.seq_id,
                     prompt_len=int(seq.prompt.size),
                     peer=f"{peer[0]}:{peer[1]}")
        with self._lock:
            self._live -= 1     # local custody ends; relay owns the handle

        def relay():
            ship_prefill(peer, int(seq.prompt.size), int(first_token),
                         seq.max_new, left_ms, kv, seq.handle)

        t = threading.Thread(target=relay, daemon=True,
                             name=f"lm-handoff-{seq.seq_id}")
        # prune finished relays so a long-lived prefill engine doesn't
        # accumulate one dead thread object per handed-off sequence
        self._ship_threads = [s for s in self._ship_threads
                              if s.is_alive()]
        self._ship_threads.append(t)
        t.start()

    def _decode_step(self) -> bool:
        with self._lock:
            rows = dict(self._active)
        if not rows:
            return False
        for seq in list(rows.values()):
            # the step writes cache entry p0 + len(generated) - 1, so
            # the table must cover p0 + len(generated) slots — the SAME
            # ensure() the whole-request path does before its step
            self._ensure_blocks(seq, seq.p0 + len(seq.generated))
        with self._lock:
            rows = dict(self._active)   # pressure evictions applied
        if not rows:
            return False
        B, T = self.cfg.max_seqs, self.engine.T
        ids = np.zeros((B,), np.int32)
        positions = np.zeros((B,), np.int32)
        tables = np.zeros((B, T), np.int32)
        lengths = np.zeros((B,), np.int32)
        for row, seq in rows.items():
            # generated[i] feeds at position p0 + i: the last appended
            # token goes in at p0 + len - 1 and the cache then holds
            # p0 + len entries — identical per-row inputs to
            # generate_whole's loop, which is what makes greedy tokens
            # bit-identical between the two paths
            L = seq.p0 + len(seq.generated) - 1
            ids[row] = seq.generated[-1]
            positions[row] = L
            tables[row] = seq.table
            lengths[row] = L + 1
        toks = self.engine.run_decode(ids, positions, tables, lengths)
        self.steps += 1
        eos = self.cfg.eos
        for row, seq in rows.items():
            t = int(toks[row])
            seq.generated.append(t)
            seq.handle.push({"event": "token",
                             "index": len(seq.generated) - 1, "token": t})
            if eos >= 0 and t == eos:
                self._finish(seq, "eos")
            elif len(seq.generated) >= seq.max_new:
                self._finish(seq, "length")
            elif seq.p0 + len(seq.generated) - 1 >= self.cfg.max_context:
                # the next token would feed at a position outside the
                # context window — same cutoff as generate_whole's
                # `L < max_context` loop condition
                self._finish(seq, "length")
        return True
