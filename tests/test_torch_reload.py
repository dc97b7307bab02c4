"""The port's hot reload (``serve/reload.py``, ``ReplicaPool
.reload_replica``, ``InferenceEngine.swap_weights``) on the CPU, ported
from ``tests/test_serve_fleet.py``:

* a rolling reload under load drops no request, and the swapped
  replicas answer as a fresh engine on the new round does (atol 1e-6);
* the watcher's round gate, a partial sweep that retries the stale
  replicas, a structure mismatch refused before any replica is touched,
  A/B pins and ``promote``, the watcher thread under the server's
  lifecycle with ``/statz`` ``reload``;
* ``swap_weights`` refuses the other dtype and the replica comes back
  UP; a swap racing dispatches never mixes one round's params with the
  other's batch-norm state (every answer is one round's, bit for bit);
* the int8 staleness quirk of the JAX watcher beside the port's: the
  JAX watcher sweeps an int8 fleet again on every poll and fails on
  every poll once a plain round lands; the port's sweeps once, and
  refuses the plain round once, the replicas UP on their weights.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from cxxnet_tpu_torch import checkpoint as ckpt
from cxxnet_tpu_torch.config import parse_config_string
from cxxnet_tpu_torch.graph import build_graph
from cxxnet_tpu_torch.model import Network, calibrate_bn
from cxxnet_tpu_torch.convert import params_from_jax, params_to_jax
from cxxnet_tpu_torch.serve import (InferenceEngine, ReloadWatcher,
                                    ServeServer, UnknownVersion)
from cxxnet_tpu_torch.serve.fleet import UP

from torch_fleet_fixture import (NET_CFG, PORT_CFG, jax_pool, port_pool,
                                 rows, save_int8_round, save_round)

ATOL = 1e-6


@pytest.fixture()
def pool2():
    p = port_pool(2)
    yield p
    p.close()


def engine_on(path, dtype=None):
    return InferenceEngine.from_checkpoint(PORT_CFG, path, dtype=dtype,
                                           buckets="2,4,8", max_batch=8)


def test_reload_under_load_drops_no_request(pool2, tmp_path):
    path = save_round(tmp_path, 0, seed=1)
    blob = ckpt.load_for_inference(path)
    watcher = ReloadWatcher(pool2, str(tmp_path), interval_s=0)
    futs, stop = [], threading.Event()

    def load():
        i = 0
        while not stop.is_set():
            futs.append(pool2.submit(rows(1 + i % 3, seed=i), "raw"))
            i += 1
            time.sleep(0.002)
    t = threading.Thread(target=load)
    t.start()
    time.sleep(0.15)
    assert watcher.reload_from_blob(blob) == 2
    time.sleep(0.15)
    stop.set()
    t.join()
    outs = [f.result(timeout=30) for f in futs]      # raises on a drop
    assert len(outs) > 20
    assert {r.version for r in pool2.replicas} == {"r0000"}
    assert {r.engine.weights_digest for r in pool2.replicas} \
        == {ckpt.blob_digest(blob["meta"])}
    x = rows(4, seed=99)
    want = engine_on(path).predict_raw(x)
    for rep in pool2.replicas:
        np.testing.assert_allclose(rep.engine.predict_raw(x), want,
                                   atol=ATOL, rtol=0)


def test_watcher_gates_on_the_round(pool2, tmp_path):
    save_round(tmp_path, 0)
    watcher = ReloadWatcher(pool2, str(tmp_path), interval_s=0)
    assert watcher.check_once() is True           # r0000 is news
    assert pool2.newest_round() == 0
    assert watcher.check_once() is False          # nothing newer
    save_round(tmp_path, 3, seed=7)
    assert watcher.check_once() is True
    assert {r.version for r in pool2.replicas} == {"r0003"}
    assert watcher.reloads == 2 and watcher.last_error == ""


def test_a_partial_sweep_retries_the_stale_replicas(pool2, tmp_path):
    save_round(tmp_path, 0, seed=1)
    watcher = ReloadWatcher(pool2, str(tmp_path), interval_s=0)
    orig = pool2.replicas[1].engine.swap_weights
    calls = {"n": 0}

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("transient placement failure")
        return orig(*a, **kw)
    pool2.replicas[1].engine.swap_weights = flaky
    with pytest.raises(RuntimeError, match="transient"):
        watcher.check_once()
    assert pool2.replicas[0].version == "r0000"
    assert pool2.replicas[1].version == "init"
    assert pool2.replicas[1].state == UP
    assert watcher.reloads == 0
    assert watcher.check_once() is True           # only replica 1
    assert {r.version for r in pool2.replicas} == {"r0000"}
    assert calls["n"] == 2 and watcher.reloads == 1


def test_a_structure_mismatch_is_refused_before_any_swap(pool2, tmp_path):
    other = NET_CFG.replace("layer[+1:a1] = relu", "layer[+1:a1] = sigmoid")
    path = save_round(tmp_path, 0, cfg=other)
    watcher = ReloadWatcher(pool2, str(tmp_path), interval_s=0)
    swaps = []
    for rep in pool2.replicas:
        rep.engine.swap_weights = lambda *a, **k: swaps.append(a)
    with pytest.raises(ValueError, match="structure"):
        watcher.reload_from_blob(ckpt.load_for_inference(path))
    assert watcher.check_once() is False          # refused, once
    assert "r0000 refused" in watcher.last_error
    assert watcher.check_once() is False and watcher.refusals == 1
    assert swaps == [] and {r.version for r in pool2.replicas} == {"init"}
    assert {r.state for r in pool2.replicas} == {UP}


def test_ab_pins_route_to_their_round_and_promote(tmp_path):
    pool = port_pool(3)
    try:
        save_round(tmp_path, 0, seed=1)
        watcher = ReloadWatcher(pool, str(tmp_path), interval_s=0,
                                ab_replicas=1)
        watcher.check_once()
        assert [r.version for r in pool.replicas] == \
            ["r0000", "init", "init"]
        p1 = save_round(tmp_path, 1, seed=2)
        watcher.check_once()
        assert [r.version for r in pool.replicas] == \
            ["r0001", "init", "init"]
        for _ in range(6):
            assert pool.pick("r0001").idx == 0
            assert pool.pick("init").idx in (1, 2)
        with pytest.raises(UnknownVersion):
            pool.pick("r0042")
        x = rows(2, seed=3)
        np.testing.assert_allclose(
            pool.submit(x, "raw", version="r0001").result(timeout=30),
            engine_on(p1).predict_raw(x), atol=ATOL, rtol=0)
        pool.submit(rows(1), version="init").result(timeout=30)
        vs = pool.version_stats()
        assert vs["r0001"]["ok"] == 1 and vs["init"]["ok"] == 1
        assert vs["r0001"]["replicas"] == [0]
        assert watcher.promote() is True
        assert {r.version for r in pool.replicas} == {"r0001"}
        assert watcher.promote() is False
        assert set(pool.version_stats()) == {"r0001", "init"}
    finally:
        pool.close()


def test_the_server_runs_the_watcher_thread(tmp_path):
    pool = port_pool(2)
    watcher = ReloadWatcher(pool, str(tmp_path), interval_s=0.05)
    srv = ServeServer(pool=pool, reload_watcher=watcher, port=0,
                      log_interval_s=0, silent=True, handle_signals=False)
    srv.start()
    try:
        assert srv.statz()["reload"]["running"] is True
        save_round(tmp_path, 4, seed=3)
        deadline = time.time() + 20
        while pool.newest_round() != 4 and time.time() < deadline:
            time.sleep(0.02)
        assert {r.version for r in pool.replicas} == {"r0004"}
        assert srv.statz()["reload"]["reloads"] == 1
    finally:
        srv.stop()
    assert watcher.snapshot()["running"] is False


def test_swap_weights_refuses_the_other_dtype(tmp_path):
    qpath = save_int8_round(tmp_path, 1, seed=1)
    pool = port_pool(2, blob=ckpt.load_for_inference(qpath), dtype="int8")
    (tmp_path / "fp").mkdir()
    fp = ckpt.load_for_inference(save_round(tmp_path / "fp", 2, seed=2))
    try:
        assert {r.version for r in pool.replicas} == {"r0001-int8"}
        with pytest.raises(ValueError, match="quantization"):
            pool.reload_replica(0, fp["params"], fp["state"], 2)
        assert pool.replicas[0].state == UP
        assert pool.replicas[0].version == "r0001-int8"
        eng = engine_on(save_round(tmp_path / "fp", 3, seed=2))
        q = ckpt.load_for_inference(qpath)
        with pytest.raises(ValueError, match="quantization"):
            eng.swap_weights(q["params"], q["state"], 1)
        assert eng.weights_version == "r0003"
    finally:
        pool.close()


BN_CFG = PORT_CFG.replace("layer[+1:a1] = relu",
                          "layer[+1:b1] = batch_norm:bn1\n"
                          "layer[+1:a1] = relu")


def bn_round(seed):
    """(params, state) of BN_CFG from ``seed``: numpy weights, the BN
    statistics of a seeded batch, so state differs from round to
    round."""
    cfg = parse_config_string(BN_CFG)
    net = Network(build_graph(cfg), cfg)
    g = torch.Generator().manual_seed(seed)
    params, state = net.init(g)
    params["bn1"]["wmat"] = 1.0 + torch.rand(24, generator=g)
    net.load_weights(params, state)
    x = torch.randn((16, 1, 1, 16), generator=g) * (1 + seed)
    return params_to_jax(params, calibrate_bn(net, x))


def test_a_swap_racing_dispatches_never_mixes_params_and_state():
    cfg = parse_config_string(BN_CFG)
    net = Network(build_graph(cfg), cfg)
    rounds = [bn_round(1), bn_round(2)]
    net.load_weights(*params_from_jax(*rounds[0]))
    eng = InferenceEngine(net, buckets="8", max_batch=8)
    x = rows(8, seed=5)
    want = []
    for r, (p, s) in enumerate(rounds):
        eng.swap_weights(p, s, r)
        want.append(eng.predict_raw(x))
    assert np.abs(want[0] - want[1]).max() > 1e-3
    stop, bad, n = threading.Event(), [], [0]

    def swapper():
        r = 0
        while not stop.is_set():
            r ^= 1
            eng.swap_weights(*rounds[r], r)
    t = threading.Thread(target=swapper)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)         # interleave the two threads finely
    t.start()
    try:
        t_end = time.time() + 1.5
        while time.time() < t_end:
            got = eng.predict_raw(x)
            n[0] += 1
            if not any(np.array_equal(got, w) for w in want):
                bad.append(got)
    finally:
        stop.set()
        t.join(timeout=30)
        sys.setswitchinterval(switch)
    assert not t.is_alive() and n[0] > 20 and not bad


# -- the int8 staleness quirk ----------------------------------------------

def test_an_int8_fleet_is_swept_once_and_refuses_a_plain_round(tmp_path):
    from cxxnet_tpu import checkpoint as jax_ckpt
    from cxxnet_tpu.serve import ReloadWatcher as JaxWatcher
    qpath = save_int8_round(tmp_path, 1, seed=1)
    ours = port_pool(2, blob=ckpt.load_for_inference(qpath), dtype="int8")
    ref = jax_pool(2, blob=jax_ckpt.load_for_inference(qpath), dtype="int8")
    try:
        w_ours = ReloadWatcher(ours, str(tmp_path), interval_s=0)
        w_ref = JaxWatcher(ref, str(tmp_path), interval_s=0)
        assert [r.version for r in ref.replicas] == ["r0001-int8"] * 2
        # the JAX watcher compares r0001 with r0001-int8: every poll is
        # a sweep that re-reads, drains and swaps the same round
        assert [w_ref.check_once() for _ in range(3)] == [True] * 3
        assert w_ref.reloads == 3
        assert [w_ours.check_once() for _ in range(3)] == [False] * 3
        assert w_ours.reloads == 0
        # a plain round lands: the JAX sweep fails on every poll after
        # draining a replica; the port refuses it once, before a drain
        save_round(tmp_path, 2, seed=2)
        for _ in range(2):
            with pytest.raises(ValueError, match="quantization"):
                w_ref.check_once()
        reads = []
        orig = ckpt.find_latest_valid
        ckpt.find_latest_valid = lambda *a, **k: reads.append(1) \
            or orig(*a, **k)
        try:
            assert [w_ours.check_once() for _ in range(3)] == [False] * 3
        finally:
            ckpt.find_latest_valid = orig
        assert len(reads) == 1 and w_ours.refusals == 1
        assert "r0002 refused" in w_ours.last_error
        assert "not quantized" in w_ours.last_error
        assert [(r.version, r.state) for r in ours.replicas] == \
            [("r0001-int8", UP)] * 2
        x = rows(3, seed=8)
        np.testing.assert_allclose(
            ours.submit(x, "raw").result(timeout=30),
            engine_on(qpath, "int8").predict_raw(x), atol=ATOL, rtol=0)
        # a quantized round 3 is news again for the port
        save_int8_round(tmp_path, 3, seed=3)
        assert w_ours.check_once() is True
        assert {r.version for r in ours.replicas} == {"r0003-int8"}
    finally:
        ours.close()
        ref.close()
