"""Int8 LM serving and the LM plane of a fleet, on the CPU.

The LM is ``tests/test_lm_serve.py``'s (embed, posembed, one causal mha,
the seqfc head; E 32, 4 heads, S 32, V 16), built by the JAX ``Trainer``
with its embedding scaled to unit variance (as in
``test_torch_lm_serve.py``) and its head by ``HEAD_SCALE``, and
quantized by the JAX package's PTQ, calibrated over token batches as
``tests/test_quant.py`` does: the head (``seqfc``) is the one int8
layer.

* The port's int8 ``LMEngine`` against the JAX int8 ``LMEngine`` on that
  round, step by step from the same tables: log-probabilities within
  ``LOGP_TOL``, greedy tokens equal wherever the JAX step's top-two
  margin clears ``MARGIN``; and ``generate_whole`` equal.
* Int8 against float32 greedy tokens, equal over the leading steps where
  the float32 margin clears 0.02 (the bar of ``tests/test_quant.py``'s
  int8 decode test).
* ``ReplicaPool.attach_lm`` and ``set_lm_role``: every replica's plane
  answers as ``generate_whole``, a split pool routes new prompts to the
  prefill replica and hands them to the decode one, the KV pools are
  empty after.
* A reload of a replica with live sequences waits for them (the
  ``live_count`` idle probe): they finish on the old weights, the swap
  sees no live sequence, and the next prompt decodes on the new round.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cxxnet_tpu.config import parse_config_string as jax_parse
from cxxnet_tpu.config import parse_lm_serve_config as jax_parse_lm
from cxxnet_tpu.quant import calibrate_act_scales, quantize_params
from cxxnet_tpu.serve import InferenceEngine as JaxEngine
from cxxnet_tpu.serve.lm import LMEngine as JaxLMEngine
from cxxnet_tpu.trainer import Trainer as JaxTrainer
from cxxnet_tpu_torch import checkpoint as ckpt
from cxxnet_tpu_torch.config import parse_config_string, parse_lm_serve_config
from cxxnet_tpu_torch.convert import params_from_jax
from cxxnet_tpu_torch.graph import build_graph
from cxxnet_tpu_torch.model import Network
from cxxnet_tpu_torch.serve import InferenceEngine, ReplicaPool
from cxxnet_tpu_torch.serve.lm import LMEngine

from test_lm_serve import BASE_KNOBS, LM_CFG, S, V

#: |log-prob| difference, port vs JAX int8 step: the epilogues may
#: round once apart (an FMA against a product and a sum), which moves a
#: logit by an ulp; the reading on this net is 0
LOGP_TOL = 1e-5
#: a greedy token is held equal where the top-two margin of the JAX
#: step's probabilities exceeds this
MARGIN = 1e-3
#: the JAX init leaves the head's logits near 1e-4 (every step a tie);
#: scaled up, they spread over a few units and most steps have a clear
#: greedy token
HEAD_SCALE = 3e4
PORT_CFG = LM_CFG + "\ndev = cpu\n"
KNOBS = list(dict(BASE_KNOBS).items())


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _margin(logits):
    p = np.sort(np.exp(logits - logits.max(-1, keepdims=True)), -1)
    p /= p.sum(-1, keepdims=True)
    return p[..., -1] - p[..., -2]


@pytest.fixture(scope="module")
def rounds(mesh1, tmp_path_factory):
    """(fp params, state, int8 params, path of the int8 round, path of
    a second int8 round from other weights), the JAX package's PTQ."""
    tr = JaxTrainer(jax_parse(LM_CFG), mesh_ctx=mesh1)
    tr.init_model()
    tr.opt_state = None
    params, state = _np(tr.params), _np(tr.net_state)
    params["emb"]["wmat"] *= 50.0
    params["head"]["wmat"] *= HEAD_SCALE
    rng = np.random.RandomState(0)
    calib = [rng.randint(0, V, size=(8, 1, 1, S)).astype(np.float32)
             for _ in range(2)]
    td = tmp_path_factory.mktemp("lm")
    sig = build_graph(parse_config_string(LM_CFG)).structure_signature()
    out = []
    for r, scale in ((1, 1.0), (2, 0.7)):
        p = jax.tree_util.tree_map(lambda a: a * scale
                                   if a.dtype.kind == "f" else a, params)
        scales = calibrate_act_scales(
            tr.net, jax.tree_util.tree_map(jnp.asarray, p), tr.net_state,
            calib)
        assert set(scales) == {"head"}
        qp, _ = quantize_params(p, scales)
        path = str(td / ("%04d.model" % r))
        ckpt.save_model(path, structure_sig=sig, round_counter=r,
                        epoch_counter=0, params=qp, net_state=state)
        out.append((p, qp, path))
    return params, state, out


def port_lm(params, state, dtype=None):
    cfg = parse_config_string(PORT_CFG)
    net = Network(build_graph(cfg), cfg)
    net.load_weights(*params_from_jax(params, state))
    eng = InferenceEngine(net, buckets="8", max_batch=8, dtype=dtype)
    return LMEngine(eng, parse_lm_serve_config(KNOBS))


def jax_lm(params, state, mesh1, dtype=None):
    tr = JaxTrainer(jax_parse(LM_CFG), mesh_ctx=mesh1)
    tr.init_model()
    tr.opt_state = None
    tr.params, tr.net_state = tr._place(params, state)
    return JaxLMEngine(JaxEngine(tr, buckets="8", max_batch=8, dtype=dtype),
                       jax_parse_lm(KNOBS))


def prompts(n, seed=0, lo=3, hi=12):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, V, size=rng.randint(lo, hi)).astype(np.int32)
            for _ in range(n)]


def _jax_step(jl, ids, positions, tables, lengths, last_idx):
    B, C = ids.shape
    fn = jl._compiled(("step", B, C))
    params, state = jl._weights()
    tok, last, jl.pools = fn(params, state, jl.pools,
                             *(np.asarray(a, np.int32) for a in
                               (ids, positions, tables, lengths, last_idx)))
    return np.asarray(tok), np.asarray(last)


def _logp(x):
    x = np.asarray(x, np.float64)
    m = x.max(-1, keepdims=True)
    return x - m - np.log(np.exp(x - m).sum(-1, keepdims=True))


def test_int8_lm_engine_matches_the_jax_int8_engine(rounds, mesh1):
    params, state, ((_, qp, _), _) = rounds
    pl = port_lm(qp, state, "int8")
    jl = jax_lm(qp, state, mesh1, "int8")
    try:
        assert pl.compute_dtype == torch.float32
        assert pl.net.params["head"]["wmat"].dtype == torch.int8
        cfg = pl.cfg
        C, B, T = cfg.prefill_chunk, cfg.max_seqs, pl.T
        ps = prompts(2, seed=21, lo=9, hi=11)
        tables = np.zeros((B, T), np.int32)
        free = list(range(1, cfg.kv_pool_blocks))
        worst, held = 0.0, 0
        gen = []
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
                worst = max(worst, np.abs(_logp(last.numpy())
                                          - _logp(jlast)).max())
                sure = _margin(jlast) > MARGIN
                held += int(sure.sum())
                assert (tok.numpy()[sure] == jtok[sure]).all()
                p0 += c
            gen.append([int(jtok[0])])
        for _ in range(4):
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
            worst = max(worst, np.abs(_logp(last.numpy()[live])
                                      - _logp(jlast[live])).max())
            sure = _margin(jlast[live]) > MARGIN
            held += int(sure.sum())
            assert (tok.numpy()[live][sure] == jtok[live][sure]).all()
            for r in range(len(ps)):
                gen[r].append(int(jtok[r]))
        assert worst <= LOGP_TOL, worst
        assert held >= 8
        for p in prompts(3, seed=4):
            assert pl.generate_whole(p, max_new=6) == \
                jl.generate_whole(p, max_new=6)
    finally:
        pl.close()
        jl.close()


def test_int8_greedy_agrees_with_float32_on_confident_steps(rounds):
    params, state, ((_, qp, _), _) = rounds
    p8, pf = port_lm(qp, state, "int8"), port_lm(params, state)
    try:
        steps = 0
        for p in prompts(4, seed=9):
            t8 = p8.generate_whole(p, max_new=8)
            tf = pf.generate_whole(p, max_new=8)
            seq = np.concatenate([p, np.asarray(tf)])[:S]
            x = torch.zeros((1, 1, 1, S))
            x[0, 0, 0, :len(seq)] = torch.from_numpy(seq.astype(np.float32))
            logp = pf.net(x).out.reshape(S, V).numpy()
            conf = _margin(logp[len(p) - 1:len(p) - 1 + len(tf)])
            k = 0
            while k < len(conf) and conf[k] >= 0.02:
                k += 1
            assert t8[:k] == tf[:k], (t8, tf, conf.tolist())
            steps += k
        assert steps >= 8
    finally:
        p8.close()
        pf.close()


def _pool(path, n=2):
    return ReplicaPool.build(PORT_CFG, n, blob=ckpt.load_for_inference(path),
                             dtype="int8", buckets="8", max_batch=8)


def test_attach_lm_and_set_lm_role_on_a_pool(rounds):
    _, _, ((_, _, path), _) = rounds
    # the decode replica takes every handoff's blocks as it arrives: a
    # pool that holds all six sequences at once
    cfg = parse_lm_serve_config(list(dict(
        KNOBS + [("kv_pool_blocks", "64")]).items()))
    pool = _pool(path)
    try:
        pool.attach_lm(cfg)
        with pytest.raises(RuntimeError, match="already"):
            pool.attach_lm(cfg)
        ps = prompts(6, seed=2)
        ref = [pool.replicas[0].lm.engine.generate_whole(p, max_new=6)
               for p in ps]
        outs = [pool.submit_lm(p, max_new=6).result(timeout=300)
                for p in ps]
        assert [o["tokens"] for o in outs] == ref
        assert all(r.lm.engine.engine.serve_int8 for r in pool.replicas)
        pool.set_lm_role(0, "prefill",
                         peer=pool.replicas[1].lm.handoff_addr)
        pool.set_lm_role(1, "decode")
        handoffs = []
        admit = pool.replicas[1].lm.admit_handoff
        pool.replicas[1].lm.admit_handoff = \
            lambda *a, **k: handoffs.append(1) or admit(*a, **k)
        hs = [pool.submit_lm(p, max_new=6) for p in ps]
        assert [h.result(timeout=300)["tokens"] for h in hs] == ref
        assert len(handoffs) == len(ps)
        assert all(r.lm.engine.block_pool.used == 0
                   and r.lm.live_count() == 0 for r in pool.replicas)
        assert all("lm" in r.snapshot()["stats"] for r in pool.replicas)
    finally:
        pool.close()


def test_a_reload_waits_for_live_sequences(rounds):
    _, state, ((_, _, path1), (_, qp2, path2)) = rounds
    cfg = parse_lm_serve_config(KNOBS)
    pool = _pool(path1, n=1)
    rep = pool.replicas[0]
    try:
        pool.attach_lm(cfg)
        lme = rep.lm.engine
        p = prompts(1, seed=5)[0]
        old = lme.generate_whole(p, max_new=8)
        run_decode = lme.run_decode

        def slow_decode(*a, **k):                 # a decode step of 20 ms
            time.sleep(0.02)
            return run_decode(*a, **k)
        lme.run_decode = slow_decode
        seen = []
        swap = rep.engine.swap_weights

        def spy(*a, **k):
            seen.append((rep.lm.live_count(), rep.batcher.idle))
            return swap(*a, **k)
        rep.engine.swap_weights = spy
        h = pool.submit_lm(p, max_new=8)
        time.sleep(0.03)
        assert rep.lm.live_count() == 1
        blob = ckpt.load_for_inference(path2)
        t0 = time.perf_counter()
        pool.reload_replica(0, blob["params"], blob["state"], 2)
        waited = time.perf_counter() - t0
        assert h.result(timeout=300)["tokens"] == old
        assert seen == [(0, True)] and waited > 0.05
        lme.run_decode = run_decode
        assert rep.version == "r0002-int8"
        new = pool.submit_lm(p, max_new=8).result(timeout=300)["tokens"]
        assert new == port_lm(qp2, state, "int8").generate_whole(
            p, max_new=8)
        assert lme.block_pool.used == 0
    finally:
        pool.close()
