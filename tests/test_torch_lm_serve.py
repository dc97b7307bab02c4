"""The port's LM serving plane against the JAX package's.

Two causal LMs, each built by the JAX ``Trainer`` on one CPU device
(``mesh1``) and carried into the port through ``params_from_jax``:
``tests/test_lm_serve.py``'s ``LM_CFG`` (embed, posembed, one causal mha,
the seqfc head; E 32, 4 heads, S 32, V 16) and a pre-norm block shaped
like ``examples/LM/tiny_lm.conf`` with ``rope = 1`` (layernorm, mha,
add, layernorm, gelu ffn, add, layernorm, head). The embedding table is
scaled to unit variance after the JAX init, in both packages, so greedy
tokens have margins that f32 rounding cannot flip. Held against the
JAX package, f32, atol 1e-5 unless stated:

* ``parse_lm_serve_config``: the same values or the same error for each
  knob set;
* ``BlockPool``: the same ``alloc`` / ``free`` / ``defrag_plan`` results
  under one seeded op sequence;
* ``rope_at`` (also bit-equal to the port's ``rope`` at the same
  positions) and ``paged_attention`` with dead rows, block-tail padding
  and shuffled tables;
* the stream events and chunks, and the wire frames: byte-equal;
* ``LMEngine``: each prefill chunk's and decode step's tokens and
  ``last`` logits from the same tables, the pools after them, and
  ``generate_whole``'s tokens.

Within the port: the scheduler's tokens bit-equal to ``generate_whole``,
pressure eviction freeing exactly the victim's blocks, deadline and
cancel, defrag mid-sequence, a loopback prefill -> decode handoff (and a
bfloat16 cache's round trip), the runner cache's miss count frozen after
warm-up, and ``POST /generate`` over HTTP (streamed, ``"stream": 0``, a
dropped client, 400, 503, 504, and a generation past the handler's
``result_timeout_s``).
"""

import json
import socket
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cxxnet_tpu.config import ConfigError as JaxConfigError
from cxxnet_tpu.config import parse_config_string as jax_parse
from cxxnet_tpu.config import parse_lm_serve_config as jax_parse_lm
from cxxnet_tpu.data_service import wire as jax_wire
from cxxnet_tpu.ops import attention as jax_att
from cxxnet_tpu.serve import InferenceEngine as JaxEngine
from cxxnet_tpu.serve.lm import BlockPool as JaxBlockPool
from cxxnet_tpu.serve.lm import LMEngine as JaxLMEngine
from cxxnet_tpu.serve.lm import stream as jax_stream
from cxxnet_tpu.trainer import Trainer as JaxTrainer
from cxxnet_tpu_torch.config import (ConfigError, parse_config_string,
                                     parse_lm_serve_config)
from cxxnet_tpu_torch.convert import params_from_jax
from cxxnet_tpu_torch.data_service import wire
from cxxnet_tpu_torch.graph import build_graph
from cxxnet_tpu_torch.model import Network
from cxxnet_tpu_torch.optim import leaves
from cxxnet_tpu_torch.ops.attention import (attention_reference,
                                            paged_attention, rope, rope_at)
from cxxnet_tpu_torch.serve import (Backpressure, DeadlineExceeded,
                                    InferenceEngine, ServeServer)
from cxxnet_tpu_torch.serve.lm import (SCRATCH_BLOCK, BlockPool, LMEngine,
                                       LMScheduler, PoolExhausted, stream)
from cxxnet_tpu_torch.serve.lm.engine import kv_from_numpy, kv_to_numpy

from test_lm_serve import BASE_KNOBS, LM_CFG, S, V

ROPE_CFG = f"""
netconfig=start
layer[+1:e0] = embed:tok_embed
  nhidden = 32
  vocab_size = {V}
  init_sigma = 0.02
layer[+1:n1] = layernorm:ln1
layer[+1:a1] = mha:attn1
  nhead = 4
  causal = 1
  rope = 1
layer[e0,a1->r1] = add:res1
layer[+1:n2] = layernorm:ln2
layer[+1:f1] = ffn:ffn1
  nhidden = 64
layer[r1,f1->r2] = add:res2
layer[+1:nf] = layernorm:lnf
layer[+1:lg] = seqfc:lm_head
  nhidden = {V}
layer[+0] = lmloss
netconfig=end
input_shape = 1,1,{S}
label_vec[0,{S}) = label
batch_size = 8
"""
NETS = {"posembed": LM_CFG, "rope": ROPE_CFG}
ATOL = 1e-5


def _knobs(extra=()):
    return list(dict(BASE_KNOBS + list(extra)).items())


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def port_engine(params, state, text, knobs=()):
    """The port's LMEngine over ``text`` with the JAX-layout weights."""
    cfg = parse_config_string(text + "\ndev = cpu\n")
    net = Network(build_graph(cfg), cfg)
    net.load_weights(*params_from_jax(params, state))
    eng = InferenceEngine(net, buckets="8", max_batch=8)
    lm_cfg = parse_lm_serve_config(_knobs(knobs))
    return LMEngine(eng, lm_cfg), lm_cfg


@pytest.fixture(scope="module", params=sorted(NETS))
def pair(request, mesh1):
    """(JAX LMEngine, port LMEngine, cfg, numpy params, state, text)."""
    text = NETS[request.param]
    tr = JaxTrainer(jax_parse(text), mesh_ctx=mesh1)
    tr.init_model()
    tr.opt_state = None
    params, state = _np(tr.params), _np(tr.net_state)
    params["tok_embed" if "tok_embed" in params else "emb"]["wmat"] *= 50.0
    tr.params = jax.tree_util.tree_map(jnp.asarray, params)
    jl = JaxLMEngine(JaxEngine(tr, buckets="8", max_batch=8),
                     jax_parse_lm(_knobs()))
    pl, cfg = port_engine(params, state, text)
    yield jl, pl, cfg, params, state, text
    jl.close()


@pytest.fixture(scope="module")
def port_lm(pair):
    """A port engine of its own for the scheduler tests (the posembed
    and the rope net both)."""
    _, _, _, params, state, text = pair
    lme, cfg = port_engine(params, state, text)
    yield lme, cfg
    lme.close()


def prompts(n, lo=3, hi=12, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, V, size=rng.randint(lo, hi)).astype(np.int32)
            for _ in range(n)]


# -- knobs, blocks ------------------------------------------------------------

@pytest.mark.parametrize("knobs", [
    [],
    [("kv_block_size", "8"), ("lm_serve_prefill_chunk", "16"),
     ("kv_dtype", "bfloat16"), ("lm_serve_deadline_ms", "2.5"),
     ("lm_serve_role", "prefill"), ("lm_serve_eos", "3")],
    [("kv_block_size", "4"), ("lm_serve_prefill_chunk", "6")],
    [("lm_serve_role", "shard")],
    [("lm_serve_blocksize", "4")],
    [("kv_pool_blocks", "1")],
    [("lm_serve_max_seqs", "0")],
    [("lm_serve_max_new_tokens", "0")],
    [("lm_serve_deadline_ms", "-1")],
    [("kv_block_size", "x")],
], ids=["defaults", "set", "chunk", "role", "typo", "pool", "seqs",
        "new_tokens", "deadline", "not_int"])
def test_lm_serve_config_matches_the_jax_package(knobs):
    try:
        want = jax_parse_lm(knobs)
    except JaxConfigError as e:
        with pytest.raises(ConfigError) as got:
            parse_lm_serve_config(knobs)
        assert str(got.value) == str(e)
        return
    got = parse_lm_serve_config(knobs)
    assert vars(got) == vars(want)
    assert got.max_blocks_per_seq == want.max_blocks_per_seq


def test_block_pool_matches_the_jax_pool_under_seeded_ops():
    rng = np.random.RandomState(3)
    ours, ref = BlockPool(12, 4), JaxBlockPool(12, 4, instance="t-port")
    held = {}
    try:
        for i in range(200):
            op = rng.randint(4)
            if op < 2:
                n = int(rng.randint(1, 4))
                outs = []
                for pool in (ours, ref):
                    try:
                        outs.append(pool.alloc(n, seq_id=i))
                    except (PoolExhausted, RuntimeError) as e:
                        outs.append(type(e).__name__)
                assert outs[0] == outs[1]
                if isinstance(outs[0], list):
                    held[i] = outs[0]
            elif op == 2 and held:
                sid = sorted(held)[rng.randint(len(held))]
                ours.free(held[sid])
                ref.free(held.pop(sid))
            else:
                a, b = ours.defrag_plan(), ref.defrag_plan()
                np.testing.assert_array_equal(a[0], b[0])
                assert a[1] == b[1]
                held = {s: [a[1].get(x, x) for x in blk]
                        for s, blk in held.items()}
            assert ours.owners() == ref.owners()
            assert (ours.used, ours.available) == (ref.used, ref.available)
        with pytest.raises(ValueError):
            ours.free([SCRATCH_BLOCK])
    finally:
        ref.unregister()


# -- rope_at, paged attention -------------------------------------------------

def test_rope_at_matches_jax_and_the_full_rope():
    rng = np.random.RandomState(1)
    x = rng.randn(3, 5, 4, 16).astype(np.float32)
    pos = rng.randint(0, 2048, size=(3, 5)).astype(np.int32)
    got = rope_at(torch.from_numpy(x), 10000.0, torch.from_numpy(pos))
    want = jax_att.rope_at(jnp.asarray(x), 10000.0, jnp.asarray(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    # at positions 7..11 it is the full rope at offset 7, bit for bit,
    # in f32 and in bf16
    for dt in (torch.float32, torch.bfloat16):
        xt = torch.from_numpy(x).to(dt)
        p = torch.arange(7, 12)[None, :].expand(3, 5)
        assert torch.equal(rope_at(xt, 500.0, p), rope(xt, 500.0, offset=7))


@pytest.mark.parametrize("case", ["full", "tail", "dead", "prefill"])
def test_paged_attention_matches_jax(case):
    rng = np.random.RandomState(7)
    B, L, H, D, bs, N = 3, 10, 4, 8, 4, 16
    k = rng.randn(B, L, H, D).astype(np.float32)
    v = rng.randn(B, L, H, D).astype(np.float32)
    T = -(-L // bs)
    order = rng.permutation(np.arange(1, N))[:B * T]   # shuffled tables
    tables = np.zeros((B, T + 1), np.int32)            # padding: scratch
    tables[:, :T] = order.reshape(B, T)
    k_pool = rng.randn(N, bs, H, D).astype(np.float32)  # junk elsewhere
    v_pool = rng.randn(N, bs, H, D).astype(np.float32)
    for b in range(B):
        for i in range(L):
            k_pool[tables[b, i // bs], i % bs] = k[b, i]
            v_pool[tables[b, i // bs], i % bs] = v[b, i]
    lengths = np.full((B,), L, np.int32)
    if case == "prefill":
        Q = L
        q_pos = np.tile(np.arange(L, dtype=np.int32), (B, 1))
    else:
        Q = 1
        q_pos = np.full((B, 1), L - 1, np.int32)
        if case == "tail":                  # lengths inside a block
            lengths = np.array([L, L - 1, 5], np.int32)
            q_pos = (lengths - 1)[:, None].astype(np.int32)
        if case == "dead":
            lengths[1] = 0
    q = rng.randn(B, Q, H, D).astype(np.float32)
    args = (q, k_pool, v_pool, tables, q_pos, lengths)
    got = paged_attention(*map(torch.from_numpy, args)).numpy()
    want = np.asarray(jax_att.paged_attention(*map(jnp.asarray, args)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    for b in range(B):                  # live rows: the plain attention
        n = int(lengths[b])
        if n == 0:                      # a dead row: uniform, not NaN
            np.testing.assert_allclose(
                got[b], np.broadcast_to(
                    v_pool[tables[b]].reshape(-1, H, D).mean(0), got[b].shape),
                atol=ATOL)
            continue
        ref = attention_reference(
            torch.from_numpy(q[b:b + 1]), torch.from_numpy(k[b:b + 1, :n]),
            torch.from_numpy(v[b:b + 1, :n]), causal=case == "prefill")
        np.testing.assert_allclose(got[b:b + 1], ref.numpy(), atol=ATOL)


# -- stream and wire frames ---------------------------------------------------

EVENTS = [{"event": "token", "index": 0, "token": 5},
          {"event": "token", "index": 1, "token": 9},
          {"event": "error", "reason": "deadline", "error": "é late",
           "tokens": [5, 9], "seq": 2},
          {"event": "done", "reason": "length", "tokens": [5, 9], "seq": 1}]


def test_stream_events_and_chunks_are_byte_equal():
    for ev in EVENTS:
        assert stream.encode_event(ev) == jax_stream.encode_event(ev)
        c = stream.chunk(stream.encode_event(ev))
        assert c == jax_stream.chunk(jax_stream.encode_event(ev))
    wire_ = b"".join(stream.chunk(stream.encode_event(e)) for e in EVENTS)
    wire_ += stream.LAST_CHUNK
    assert stream.LAST_CHUNK == jax_stream.LAST_CHUNK
    assert stream.split_events(wire_) == jax_stream.split_events(wire_) \
        == EVENTS
    with pytest.raises(ValueError):
        list(stream.iter_chunks(wire_[:-5]))


def test_wire_frames_are_byte_equal_and_round_trip():
    rng = np.random.RandomState(2)
    kv = rng.randn(3, 4, 2, 8).astype(np.float32)
    bf = jnp.asarray(kv, jnp.bfloat16)
    ours_bf = kv_to_numpy(torch.from_numpy(kv).to(torch.bfloat16))
    header = {"type": "prefill_handoff", "prompt_len": 7,
              "first_token": 3, "max_new": 8, "deadline_ms": 0.0}
    arrays = [("attn/k", kv), ("attn/v", kv[::-1].copy()),
              ("ids", np.arange(5, dtype=np.int32))]
    frame = wire.pack_frame(header, arrays + [("bf", ours_bf)])
    # bfloat16 bits travel as 2-byte void; numpy spells that dtype "|V2"
    # where ml_dtypes' bfloat16 says "<V2": the one byte that differs
    want = jax_wire.pack_frame(header, arrays + [("bf", np.asarray(bf))])
    assert want.count(b'"<V2"') == 1
    assert frame == want.replace(b'"<V2"', b'"|V2"')
    assert wire.pack_frame(header, arrays) == \
        jax_wire.pack_frame(header, arrays)
    assert wire.pack_frame({"type": "event", "data": EVENTS[0]}) == \
        jax_wire.pack_frame({"type": "event", "data": EVENTS[0]})
    a, b = socket.socketpair()
    with a, b:
        a.sendall(frame)
        hdr, got = wire.recv_frame(b, deadline=time.monotonic() + 5)
    assert hdr["type"] == "prefill_handoff" and hdr["prompt_len"] == 7
    for name, arr in arrays:
        np.testing.assert_array_equal(got[name], arr)
    assert torch.equal(kv_from_numpy(got["bf"]),
                       torch.from_numpy(kv).to(torch.bfloat16))
    a, b = socket.socketpair()
    with a, b:
        a.sendall(frame[:20])
        a.close()
        with pytest.raises(wire.WireError):
            wire.recv_frame(b)


# -- LMEngine vs the JAX LMEngine ---------------------------------------------

def _jax_step(jl, ids, positions, tables, lengths, last_idx):
    B, C = ids.shape
    fn = jl._compiled(("step", B, C))
    params, state = jl._weights()
    tok, last, jl.pools = fn(params, state, jl.pools,
                             *(np.asarray(a, np.int32) for a in
                               (ids, positions, tables, lengths, last_idx)))
    return np.asarray(tok), np.asarray(last)


def _pools_close(jl, pl):
    for name, p in pl.pools.items():
        for w in ("k", "v"):
            np.testing.assert_allclose(p[w].numpy(),
                                       np.asarray(jl.pools[name][w]),
                                       atol=ATOL, rtol=0)


def test_lm_engine_steps_match_the_jax_engine(pair):
    jl, pl, cfg, *_ = pair
    C, B, T = cfg.prefill_chunk, cfg.max_seqs, pl.T
    ps = prompts(2, lo=9, hi=11, seed=21)
    # two sequences on disjoint shuffled blocks, prefilled chunk by chunk
    rng = np.random.RandomState(5)
    free = list(rng.permutation(np.arange(1, cfg.kv_pool_blocks)))
    tables = np.zeros((B, T), np.int32)
    firsts = []
    for r, p in enumerate(ps):
        for j in range(pl.block_pool.blocks_for_tokens(p.size + 4)):
            tables[r, j] = free.pop()
        p0 = 0
        while p0 < p.size:
            c = min(C, p.size - p0)
            ids = np.zeros((1, C), np.int32)
            ids[0, :c] = p[p0:p0 + c]
            args = (ids, (p0 + np.arange(C))[None, :], tables[r:r + 1],
                    [p0 + c], [c - 1])
            tok, last = pl.step(*args)
            jtok, jlast = _jax_step(jl, *args)
            np.testing.assert_allclose(last.numpy(), jlast, atol=ATOL,
                                       rtol=0)
            assert tok.tolist() == jtok.tolist()
            p0 += c
        firsts.append(int(tok[0]))
    _pools_close(jl, pl)
    # decode steps with two live rows and one dead row
    gen = [[t] for t in firsts]
    for _ in range(3):
        ids = np.zeros((B, 1), np.int32)
        pos = np.zeros((B, 1), np.int32)
        lengths = np.zeros((B,), np.int32)
        tabs = np.zeros((B, T), np.int32)
        for r, p in enumerate(ps):
            L = p.size + len(gen[r]) - 1
            ids[r, 0], pos[r, 0], lengths[r] = gen[r][-1], L, L + 1
            tabs[r] = tables[r]
        args = (ids, pos, tabs, lengths, np.zeros((B,), np.int32))
        tok, last = pl.step(*args)
        jtok, jlast = _jax_step(jl, *args)
        live = slice(0, len(ps))
        np.testing.assert_allclose(last.numpy()[live], jlast[live],
                                   atol=ATOL, rtol=0)
        assert tok.tolist()[live] == jtok.tolist()[live]
        for r in range(len(ps)):
            gen[r].append(int(tok[r]))
    _pools_close(jl, pl)


def test_generate_whole_matches_the_jax_engine(pair):
    jl, pl, *_ = pair
    for p in prompts(3, seed=4):
        assert pl.generate_whole(p, max_new=6) == \
            jl.generate_whole(p, max_new=6)
    assert pl.block_pool.used == 0


def test_lm_engine_refusals(pair):
    _, pl, cfg, params, state, text = pair
    # the pools sit on the weights' device
    weights = {v.device for _, v in leaves(pl.net.params)}
    assert {p[w].device for p in pl.pools.values() for w in "kv"} == \
        weights == {pl.device}
    with pytest.raises(ConfigError, match="compute_dtype"):
        port_engine(params, state, text, [("kv_dtype", "int4")])
    lme, _ = port_engine(params, state, text, [("kv_dtype", "bfloat16")])
    assert {p[w].dtype for p in lme.pools.values() for w in "kv"} == \
        {torch.bfloat16}
    with pytest.raises(ValueError, match="empty prompt"):
        lme.generate_whole([])


# -- the scheduler (within the port) ------------------------------------------

def test_scheduler_bit_equal_to_generate_whole(port_lm):
    lme, cfg = port_lm
    ps = prompts(4, seed=1)                   # 4 sequences > 3 decode rows
    ref = [lme.generate_whole(p, max_new=6) for p in ps]
    assert lme.block_pool.used == 0
    warm = lme.compile_info()["misses"]
    sched = LMScheduler(lme, cfg)
    sched.start()
    try:
        handles = [sched.submit(p, max_new=6) for p in ps]
        outs = [h.result(timeout=60) for h in handles]
        snap = sched.snapshot()
    finally:
        sched.stop(drain=True)
    for out, want in zip(outs, ref):
        assert out["event"] == "done" and out["tokens"] == want
    assert lme.block_pool.used == 0 and sched.live_count() == 0
    assert lme.compile_info()["misses"] == warm == 2
    assert snap["compile"]["misses"] == warm
    blocks_total = snap["kv_blocks_total"]  # graftlint: disable=config-namespace (statz snapshot field)
    assert blocks_total == cfg.kv_pool_blocks - 1


def test_scheduler_streams_token_events(port_lm):
    lme, cfg = port_lm
    sched = LMScheduler(lme, cfg)
    sched.start()
    try:
        evs = list(sched.submit(prompts(1, seed=3)[0], max_new=5)
                   .events(timeout=60))
    finally:
        sched.stop(drain=True)
    assert [e["event"] for e in evs] == ["token"] * 5 + ["done"]
    assert [e["index"] for e in evs[:-1]] == list(range(5))
    assert evs[-1]["tokens"] == [e["token"] for e in evs[:-1]]


def test_pressure_eviction_frees_exactly_the_victims_blocks(pair):
    _, _, _, params, state, text = pair
    lme, cfg = port_engine(params, state, text, [("kv_pool_blocks", "5")])
    p_old, p_new = prompts(2, lo=8, hi=9, seed=5)
    ref_old = lme.generate_whole(p_old, max_new=8)
    sched = LMScheduler(lme, cfg)
    victims = []
    orig = sched._finish

    def finish(seq, reason):
        if reason == "pressure":
            victims.append((seq.seq_id, sorted(seq.blocks),
                            lme.block_pool.owners()))
        orig(seq, reason)

    sched._finish = finish
    sched.start()
    try:
        h_old = sched.submit(p_old, max_new=8)
        h_new = sched.submit(p_new, max_new=8)
        out_old = h_old.result(timeout=60)
        with pytest.raises(Backpressure):
            h_new.result(timeout=60)
    finally:
        sched.stop(drain=True)
    assert out_old["tokens"] == ref_old
    assert [v[0] for v in victims] == [h_new.seq_id]
    _, blocks, owners = victims[0]
    assert blocks == sorted(b for b, s in owners.items() if s == h_new.seq_id)
    assert sched.evictions == 1
    assert lme.block_pool.used == 0 and lme.block_pool.owners() == {}


def test_deadline_and_cancel_evict_mid_decode(pair):
    _, _, _, params, state, text = pair
    lme, cfg = port_engine(params, state, text,
                           [("lm_serve_max_new_tokens", "24")])
    lme.generate_whole(prompts(1, seed=6)[0], max_new=2)
    orig = lme.run_decode

    def slow_decode(*a, **kw):
        time.sleep(0.05)
        return orig(*a, **kw)

    lme.run_decode = slow_decode
    sched = LMScheduler(lme, cfg)
    sched.start()
    try:
        h = sched.submit(prompts(1, seed=7)[0], max_new=24,
                         deadline_ms=120.0)
        with pytest.raises(DeadlineExceeded):
            h.result(timeout=60)
        h2 = sched.submit(prompts(1, seed=8)[0], max_new=24)
        it = h2.events(timeout=60)
        first = next(ev for ev in it if ev["event"] == "token")
        h2.cancel()
        evs = [first] + list(it)
        assert evs[-1]["event"] == "done"
        assert evs[-1]["reason"] == "cancelled"
        assert 1 <= len(evs[-1]["tokens"]) < 24
    finally:
        sched.stop(drain=True)
    assert lme.block_pool.used == 0 and sched.live_count() == 0


def test_defrag_mid_sequence_preserves_decode(port_lm):
    lme, cfg = port_lm
    prompt = prompts(1, lo=8, hi=9, seed=11)[0]
    ref = lme.generate_whole(prompt, max_new=6)
    pool = lme.block_pool
    pad = pool.alloc(2, seq_id=90)
    table = np.zeros((lme.T,), np.int32)
    blocks = []

    def ensure(n_tokens):
        while len(blocks) < pool.blocks_for_tokens(n_tokens):
            got = pool.alloc(1, seq_id=91)
            table[len(blocks)] = got[0]
            blocks.extend(got)

    try:
        token, p0 = None, 0
        while p0 < prompt.size:
            c = min(cfg.prefill_chunk, prompt.size - p0)
            ids = np.zeros((cfg.prefill_chunk,), np.int32)
            ids[:c] = prompt[p0:p0 + c]
            ensure(p0 + c)
            token = lme.run_prefill(table, ids, p0, c)
            p0 += c
        pool.free(pad)                         # holes below the blocks
        before = list(blocks)
        remap = lme.defrag()
        blocks = [remap.get(b, b) for b in blocks]
        assert blocks != before
        assert sorted(blocks) == list(range(1, len(blocks) + 1))
        table[:len(blocks)] = blocks
        generated, L = [token], int(prompt.size)
        while len(generated) < 6:
            ensure(L + 1)
            B = cfg.max_seqs
            ids = np.zeros((B,), np.int32)
            pos = np.zeros((B,), np.int32)
            tabs = np.zeros((B, lme.T), np.int32)
            lengths = np.zeros((B,), np.int32)
            ids[0], pos[0], tabs[0], lengths[0] = generated[-1], L, table, \
                L + 1
            generated.append(int(lme.run_decode(ids, pos, tabs,
                                                lengths)[0]))
            L += 1
        assert generated == ref
    finally:
        if blocks:
            pool.free(blocks)
    assert pool.used == 0


@pytest.mark.parametrize("kv_dtype", ["", "bfloat16"])
def test_loopback_handoff_gives_the_both_role_tokens(pair, kv_dtype):
    _, _, _, params, state, text = pair
    knobs = [("kv_dtype", kv_dtype)] if kv_dtype else []
    pre, cfg = port_engine(params, state, text, knobs)
    dec, _ = port_engine(params, state, text, knobs)
    ps = prompts(3, seed=9)
    want = [dec.generate_whole(p, max_new=5) for p in ps]
    warm = dec.compile_info()["misses"]
    d_sched = LMScheduler(dec, cfg, role="decode")
    d_sched.start()
    p_sched = LMScheduler(pre, cfg)
    p_sched.start()
    try:
        p_sched.set_role("prefill", peer=d_sched.handoff_addr)
        outs = [h.result(timeout=60) for h in
                [p_sched.submit(p, max_new=5) for p in ps]]
        with pytest.raises(ValueError, match="only prefill handoffs"):
            d_sched.submit(ps[0])
    finally:
        p_sched.stop(drain=True)
        d_sched.stop(drain=True)
    assert [o["tokens"] for o in outs] == want
    assert pre.block_pool.used == 0 and dec.block_pool.used == 0
    assert dec.compile_info()["misses"] == warm + 1      # the install
    assert d_sched.steps > 0 and p_sched.steps == 0


# -- POST /generate over HTTP -------------------------------------------------

def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=60)


def _code(url, payload):
    try:
        _post(url, payload).read()
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())["error"]
    return 200, ""


def test_generate_over_http(pair):
    _, _, _, params, state, text = pair
    lme, cfg = port_engine(params, state, text, [("kv_pool_blocks", "6")])
    want = [lme.generate_whole(p, max_new=6) for p in prompts(2, seed=12)]
    srv = ServeServer(lme.engine, port=0, silent=True, handle_signals=False)
    srv.start()
    base = f"http://127.0.0.1:{srv.port}/generate"
    try:
        assert _code(base, {"prompt": [1, 2]})[0] == 503  # no LM plane
        srv.attach_lm(cfg)
        p0, p1 = prompts(2, seed=12)
        with _post(base, {"prompt": p0.tolist(), "max_new": 6}) as r:
            assert r.headers["Transfer-Encoding"] == "chunked"
            lines = []
            while True:
                line = r.readline()
                if not line:
                    break
                lines.append(json.loads(line))
        assert [e["event"] for e in lines] == ["token"] * 6 + ["done"]
        assert lines[-1]["tokens"] == want[0]
        body = json.loads(_post(base, {"prompt": p1.tolist(), "max_new": 6,
                                       "stream": 0}).read())
        assert body == {"tokens": want[1], "reason": "length"}
        # a client that drops mid-stream frees its row and blocks
        s = socket.create_connection(("127.0.0.1", srv.port))
        msg = json.dumps({"prompt": p0.tolist(), "max_new": 24}).encode()
        s.sendall(b"POST /generate HTTP/1.1\r\nHost: x\r\nContent-Length: "
                  + str(len(msg)).encode() + b"\r\n\r\n" + msg)
        s.recv(64)
        s.close()
        for _ in range(500):
            if srv.lm.live_count() == 0:
                break
            time.sleep(0.01)
        assert srv.lm.live_count() == 0
        assert srv.lm.engine.block_pool.used == 0
        assert _code(base, {"prompt": []})[0] == 400
        assert _code(base, {"prompt": [1] * S})[0] == 400
        code, err = _code(base, {"prompt": [1, 2], "version": "r9999"})
        assert code == 400 and "r9999" in err
        # a prompt longer than the pool: evicted under pressure -> 503
        code, err = _code(base, {"prompt": [1] * 24, "stream": 0})
        assert code == 503 and "pressure" in err
        code, _ = _code(base, {"prompt": [1, 2], "deadline_ms": 1e-3,
                               "stream": 0})
        assert code == 504
        statz = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/statz").read())
        assert statz["lm"]["kv_blocks_used"] == 0  # graftlint: disable=config-namespace (statz snapshot field)
        assert statz["lm"]["compile"]["misses"] == 2
        assert [probe() for probe in srv.batcher._live_probes] == [0]
    finally:
        srv.stop()


def test_generate_past_result_timeout_cancels(pair):
    """A generation that outlives the handler's ``result_timeout_s``:
    ``"stream": 0`` answers 504, a stream ends without its last chunk
    and without a second status line, and both free their blocks."""
    _, _, _, params, state, text = pair
    eng, cfg = port_engine(params, state, text)
    srv = ServeServer(eng.engine, port=0, silent=True, handle_signals=False,
                      result_timeout_s=0.05)
    srv.start()
    srv.attach_lm(cfg)
    lme = srv.lm.engine
    prefill = lme.run_prefill

    def slow_prefill(*a, **k):        # every chunk outlasts the budget
        time.sleep(0.2)
        return prefill(*a, **k)

    lme.run_prefill = slow_prefill
    base = f"http://127.0.0.1:{srv.port}/generate"

    def drained():
        for _ in range(500):
            if srv.lm.live_count() == 0:
                break
            time.sleep(0.01)
        return srv.lm.live_count() == 0 and lme.block_pool.used == 0

    try:
        p0 = prompts(1, seed=13)[0].tolist()
        code, err = _code(base, {"prompt": p0, "max_new": 6, "stream": 0})
        assert code == 504 and "result_timeout_s" in err
        assert drained()
        s = socket.create_connection(("127.0.0.1", srv.port), timeout=30)
        msg = json.dumps({"prompt": p0, "max_new": 6}).encode()
        s.sendall(b"POST /generate HTTP/1.1\r\nHost: x\r\n"
                  b"Content-Length: " + str(len(msg)).encode()
                  + b"\r\n\r\n" + msg)
        raw = b""
        while True:                   # the server closes the connection
            part = s.recv(4096)
            if not part:
                break
            raw += part
        s.close()
        assert raw.startswith(b"HTTP/1.0 200") or \
            raw.startswith(b"HTTP/1.1 200")
        assert raw.count(b"HTTP/1.") == 1
        assert b'"done"' not in raw and not raw.endswith(b"0\r\n\r\n")
        assert drained()
        statz = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/statz").read())
        assert statz["lm"]["kv_blocks_used"] == 0  # graftlint: disable=config-namespace (statz snapshot field)
    finally:
        srv.stop()
