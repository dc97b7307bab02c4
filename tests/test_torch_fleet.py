"""The port's serving fleet (``serve/fleet.py``, ``telemetry/slo.py``,
the pool form of ``ServeServer`` and the fleet keys of ``task = serve``)
on the CPU, ported from ``tests/test_serve_fleet.py`` and held against
the JAX package's fleet.

* the router: least-loaded, round-robin ties, draining and breaker-open
  replicas skipped; admission control when every replica is degraded,
  through the queue fraction and through the SLO burn rate;
* ``SLOTracker`` equal to the JAX tracker's snapshots along a scripted
  latency series on one injected clock;
* health, where the worst replica decides; exactly one of engine and
  pool; the single engine served as a pool of one that sheds nothing;
  the SLO burn in the single engine's ``/healthz``;
* parity: both packages' pools, built from one round, answer the same
  rows within f32 tolerance (atol 1e-6; float32, one fullc sum order);
* the key sets of ``/healthz`` and ``/statz``: the JAX pool's, the
  resilience ``counters`` and the run identity ``run`` included (their
  contents, ``DYNAMIC``, hold what ran before in the process);
* ``parse_serve_config`` against the JAX package's on each knob set,
  the device placement of the replicas, and ``task = serve
  serve_replicas = 2`` over HTTP through the port's entry point.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from cxxnet_tpu_torch import checkpoint as ckpt
from cxxnet_tpu_torch.config import (ConfigError, parse_cli_overrides,
                                     parse_config_string, parse_serve_config)
from cxxnet_tpu_torch.main import run
from cxxnet_tpu_torch.serve import (AllReplicasDegraded, InferenceEngine,
                                    NoHealthyReplica, ServeServer,
                                    UnknownVersion)
from cxxnet_tpu_torch.serve.fleet import DRAINING, UP, replica_devices
from cxxnet_tpu_torch.telemetry import SLOTracker

from torch_fleet_fixture import (PORT_CFG, jax_pool, port_net, port_pool,
                                 rows, save_round)

#: /statz fields whose keys are whatever the process ran before: the
#: resilience counters touched so far and the run identity of the last
#: telemetry session
DYNAMIC = {"counters", "run"}


@pytest.fixture()
def pool2():
    p = port_pool(2)
    yield p
    p.close()


def keyset(obj, prefix=""):
    """Dotted paths of every dict key in ``obj`` (a list: its first
    element's)."""
    out = set()
    if isinstance(obj, dict):
        for k, v in obj.items():
            out.add(prefix + k)
            out |= keyset(v, prefix + k + ".")
    elif isinstance(obj, list) and obj:
        out |= keyset(obj[0], prefix + "[].")
    return out


# -- router -------------------------------------------------------------------

def test_router_picks_least_loaded(pool2):
    pool2.replicas[0].batcher._queued_rows = 2
    pool2.replicas[1].batcher._queued_rows = 7
    assert pool2.pick().idx == 0
    pool2.replicas[0].batcher._queued_rows = 9
    assert pool2.pick().idx == 1
    pool2.replicas[0].batcher._queued_rows = 0
    pool2.replicas[1].batcher._queued_rows = 0


def test_router_round_robins_on_ties(pool2):
    assert {pool2.pick().idx for _ in range(8)} == {0, 1}


def test_router_skips_draining_replica(pool2):
    pool2.replicas[0].set_state(DRAINING)
    assert all(pool2.pick().idx == 1 for _ in range(4))
    pool2.replicas[0].set_state(UP)


def test_router_skips_breaker_open_replica(pool2):
    br = pool2.replicas[0].breaker
    for _ in range(br.failure_threshold):
        br.record_failure()
    assert br.state == "open"
    assert all(pool2.pick().idx == 1 for _ in range(4))
    br1 = pool2.replicas[1].breaker
    for _ in range(br1.failure_threshold):
        br1.record_failure()
    with pytest.raises(NoHealthyReplica):
        pool2.pick()
    br.record_success()
    br1.record_success()


def test_admission_control_through_slo_burn():
    clock = [1000.0]
    pool = port_pool(2)
    try:
        for rep in pool.replicas:
            rep.slo = rep.engine.stats.slo = SLOTracker(
                10.0, target=0.99, window_s=30,
                instance=rep.engine.stats.instance, clock=lambda: clock[0])
        for _ in range(20):
            pool.replicas[0].slo.record(ok=False)
        assert pool.replicas[0].degraded()
        assert pool.pick().idx == 1          # the other one serves
        for _ in range(20):
            pool.replicas[1].slo.record(ok=False)
        with pytest.raises(AllReplicasDegraded):
            pool.pick()
        clock[0] += 31                       # the window moves past it
        assert pool.pick().idx in (0, 1)
    finally:
        pool.close()


def test_admission_control_through_queue_fraction():
    pool = port_pool(2, max_queue_rows=10, degraded_queue_frac=0.5)
    try:
        pool.replicas[0].batcher._queued_rows = 5
        assert pool.replicas[0].degraded() and pool.pick().idx == 1
        pool.replicas[1].batcher._queued_rows = 6
        with pytest.raises(AllReplicasDegraded):
            pool.pick()
        pool.admission_control = False       # serve_admission = 0
        assert pool.pick().idx == 0          # the less loaded
    finally:
        for rep in pool.replicas:
            rep.batcher._queued_rows = 0
        pool.close()


def test_slo_tracker_matches_the_jax_tracker():
    from cxxnet_tpu.telemetry.registry import MetricRegistry
    from cxxnet_tpu.telemetry.slo import SLOTracker as JaxSLO
    clock = [500.0]
    ours = SLOTracker(20.0, target=0.95, window_s=5, clock=lambda: clock[0])
    ref = JaxSLO(20.0, target=0.95, window_s=5, instance="t-port",
                 registry=MetricRegistry(), clock=lambda: clock[0])
    assert ours.snapshot() == ref.snapshot()
    rs = np.random.RandomState(4)
    for step in range(60):
        lat = float(rs.exponential(0.015))
        ok = bool(rs.rand() > 0.1)
        for t in (ours, ref):
            t.record(latency_s=lat, ok=ok)
        if step % 7 == 0:
            clock[0] += float(rs.choice([0.3, 1.0, 2.5, 6.0]))
        assert ours.snapshot() == ref.snapshot(), step
        assert ours.burn_rate() == ref.burn_rate()
    for t in (ours, ref):
        t.record(ok=False)
    assert ours.snapshot() == ref.snapshot()
    with pytest.raises(ValueError):
        SLOTracker(0)
    with pytest.raises(ValueError):
        SLOTracker(5.0, target=1.0)


# -- health, statz ------------------------------------------------------------

def test_pool_health_worst_replica_decides(pool2):
    srv = ServeServer(pool=pool2, port=0, log_interval_s=0, silent=True,
                      handle_signals=False)
    try:
        code, hz = srv.health()
        assert (code, hz["status"]) == (200, "ok")
        assert len(hz["replicas"]) == 2
        pool2.replicas[0].set_state(DRAINING)
        code, hz = srv.health()
        assert (code, hz["status"]) == (200, "degraded")
        pool2.replicas[0].set_state(UP)
        br = pool2.replicas[1].breaker
        for _ in range(br.failure_threshold):
            br.record_failure()
        code, hz = srv.health()
        assert (code, hz["status"]) == (503, "open")
        statuses = {r["replica"]: r["status"] for r in hz["replicas"]}
        assert statuses == {0: "ok", 1: "open"}
        br.record_success()
        pool2.replicas[0].batcher.close()          # a dead worker
        code, hz = srv.health()
        assert (code, hz["status"]) == (500, "down")
    finally:
        srv.httpd.server_close()


def test_server_takes_exactly_one_of_engine_and_pool(pool2):
    with pytest.raises(ValueError, match="exactly one"):
        ServeServer()
    import torch
    net = port_net()
    net.load_weights(*net.init(torch.Generator()))
    eng = InferenceEngine(net, buckets="2", max_batch=2)
    with pytest.raises(ValueError, match="exactly one"):
        ServeServer(eng, pool=pool2)


def test_single_engine_healthz_reads_the_slo_burn():
    import torch
    net = port_net()
    net.load_weights(*net.init(torch.Generator()))
    eng = InferenceEngine(net, buckets="2", max_batch=2)
    srv = ServeServer(eng, port=0, log_interval_s=0, silent=True,
                      handle_signals=False, slo_ms=1e6, slo_window_s=30,
                      slo_burn_degraded=2.0)
    try:
        srv.submit(rows(1)).result(timeout=30)
        code, hz = srv.health()
        assert (code, hz["status"], hz["slo_burn_rate"]) == (200, "ok", 0.0)
        assert srv.statz()["slo"]["good"] == 1
        for _ in range(3):
            eng.stats.record_failure()           # 3 bad of 4: burn 75
        code, hz = srv.health()
        assert (code, hz["status"]) == (200, "degraded")
        assert hz["slo_burn_rate"] == pytest.approx(75.0)
    finally:
        srv.httpd.server_close()
        srv.batcher.close()


def test_single_engine_is_a_pool_of_one_that_sheds_nothing():
    import torch
    net = port_net()
    net.load_weights(*net.init(torch.Generator()))
    eng = InferenceEngine(net, buckets="2", max_batch=2)
    srv = ServeServer(eng, port=0, log_interval_s=0, silent=True,
                      handle_signals=False, slo_ms=1e6, slo_window_s=30)
    try:
        (rep,) = srv.pool.replicas
        assert rep.engine is eng and srv.batcher is rep.batcher
        assert not srv.pool.admission_control
        for _ in range(3):
            eng.stats.record_failure()
        assert srv.health()[1]["status"] == "degraded"
        # degraded, yet admitted: the single engine never sheds load
        assert srv.submit(rows(1), version="init").result(
            timeout=30).shape == (1,)
        with pytest.raises(UnknownVersion, match="'r0007'"):
            srv.submit(rows(1), version="r0007")
        assert srv.statz()["version"] == "init"
    finally:
        srv.stop()


def test_pools_of_both_packages_answer_alike_and_share_key_sets(tmp_path):
    from cxxnet_tpu import checkpoint as jax_ckpt
    from cxxnet_tpu.serve import ServeServer as JaxServer
    path = save_round(tmp_path, 3, seed=5)
    ours = port_pool(2, blob=ckpt.load_for_inference(path), digest="d")
    ref = jax_pool(2, blob=jax_ckpt.load_for_inference(path), digest="d")
    srvs = [ServeServer(pool=ours, port=0, log_interval_s=0, silent=True,
                        handle_signals=False),
            JaxServer(pool=ref, port=0, log_interval_s=0, silent=True,
                      handle_signals=False)]
    try:
        assert ours.versions() == ref.versions() == {"r0003": [0, 1]}
        for i in range(6):
            x = rows(1 + i % 3, seed=20 + i)
            got = ours.submit(x, "raw").result(timeout=30)
            want = ref.submit(x, "raw").result(timeout=30)
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
            np.testing.assert_array_equal(
                ours.submit(x).result(timeout=30),
                ref.submit(x).result(timeout=30))
        hz, sz = ([s.health()[1] for s in srvs], [s.statz() for s in srvs])
        assert keyset(hz[0]) == keyset(hz[1])
        stable = [{k for k in keyset(z) if k.split(".")[0] not in DYNAMIC}
                  for z in sz]
        assert stable[0] == stable[1]
        assert DYNAMIC <= set(sz[0]) and DYNAMIC <= set(sz[1])
        assert sz[0]["requests"]["ok"] == sz[1]["requests"]["ok"] == 12
        assert sz[0]["versions"]["r0003"]["ok"] == 12
        assert "serve-fleet[2x]" in srvs[0].log_line()
    finally:
        for s, p in zip(srvs, (ours, ref)):
            s.httpd.server_close()
            p.close()


def test_pinned_and_unknown_versions(pool2):
    assert pool2.submit(rows(1), version="init").result(timeout=30).shape \
        == (1,)
    with pytest.raises(UnknownVersion):
        pool2.submit(rows(1), version="r0042")
    with pytest.raises(NoHealthyReplica, match="LM"):
        pool2.submit_lm([1, 2])
    assert pool2.failed_traces("init") == []


# -- config, devices, the entry point ----------------------------------------

@pytest.mark.parametrize("text", [
    "",
    "serve_replicas = 4\nserve_reload_s = 30\nserve_ab = 1\n"
    "serve_ab_replicas = 1\nserve_max_batch = 32\n",
    "serve_slo_ms = 50\nserve_slo_target = 0.999\nserve_slo_window_s = 10\n"
    "serve_slo_burn_degraded = 4\nserve_admission = 0\n"
    "serve_drain_timeout_s = 5\n",
    "serve_replcas = 2\n",
    "serve_replicas = 2\nserve_ab = 1\nserve_ab_replicas = 2\n",
    "serve_replicas = 0\n",
    "serve_ab = 2\n",
    "serve_reload_s = -1\n",
    "serve_slo_ms = 5\nserve_slo_target = 1\n",
    "serve_drain_timeout_s = -2\n",
    "serve_ab_replicas = 0\n",
], ids=["defaults", "fleet", "slo", "typo", "ab_all", "replicas0", "ab2",
        "reload", "target", "drain", "ab_replicas0"])
def test_serve_config_matches_the_jax_package(text):
    from cxxnet_tpu.config import ConfigError as JaxConfigError
    from cxxnet_tpu.config import parse_config_string as jax_parse
    from cxxnet_tpu.config import parse_serve_config as jax_parse_serve
    try:
        want = jax_parse_serve(jax_parse(text))
    except JaxConfigError as e:
        with pytest.raises(ConfigError) as got:
            parse_serve_config(parse_config_string(text))
        assert str(got.value) == str(e)
        return
    got = parse_serve_config(parse_config_string(text))
    assert vars(got) == vars(want)
    assert got.fleet == want.fleet


def test_cascade_and_deploy_keys_stay_refused():
    """The cascade and deploy keys are not serve keys: they parse, as in
    the JAX package. ``task = serve`` refuses the forms of them that do
    not compose (``tests/test_torch_deploy.py`` holds each message
    against the JAX package's serve task)."""
    from cxxnet_tpu.config import parse_config_string as jax_parse
    from cxxnet_tpu.config import parse_serve_config as jax_parse_serve
    for text, refused in (("cascade_enable = 1\n", "needs cascade_model"),
                          ("deploy_enable = 1\n",
                           "needs a replica fleet")):
        assert vars(parse_serve_config(parse_config_string(text))) \
            == vars(jax_parse_serve(jax_parse(text)))
        with pytest.raises(ConfigError, match=refused):
            run(parse_config_string(PORT_CFG + text + "task = serve\n"))


def test_replica_devices():
    assert replica_devices(["c"], 3) == ["c", "c", "c"]
    assert replica_devices(["a", "b"], 3) == ["a", "b", "a"]
    assert replica_devices(["a", "b"], 2) == ["a", "b"]
    assert replica_devices(["a", "b", "c"], 2, silent=True) == ["a", "b"]
    with pytest.raises(ConfigError,
                       match="Queue A 4: replicas over several cards"):
        replica_devices(["a", "b", "c", "d"], 2)
    with pytest.raises(ValueError):
        replica_devices(["a"], 0)


def test_task_serve_builds_a_fleet_over_http(tmp_path):
    path = save_round(tmp_path, 2, seed=9)
    cfg = parse_config_string(PORT_CFG) + parse_cli_overrides(
        ["task=serve", f"model_in={path}", "serve_port=0",
         "serve_replicas=2", "serve_buckets=2,4,8", "serve_max_batch=8",
         "serve_slo_ms=10000", "silent=1"])
    ready, box = threading.Event(), {}

    def on_ready(srv):
        box["srv"] = srv
        ready.set()
    t = threading.Thread(target=run, args=(cfg,), kwargs={"ready": on_ready},
                         daemon=True)
    t.start()
    assert ready.wait(60)
    srv = box["srv"]
    base = f"http://127.0.0.1:{srv.port}"
    try:
        want = InferenceEngine.from_checkpoint(
            PORT_CFG, path, buckets="2,4,8", max_batch=8).predict_raw(
                rows(3, seed=1))
        for pin in (None, "r0002"):
            body = {"data": rows(3, seed=1).tolist(), "raw": 1}
            if pin:
                body["version"] = pin
            req = urllib.request.Request(
                base + "/predict", data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as r:
                got = np.asarray(json.loads(r.read())["prob"], np.float32)
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        req = urllib.request.Request(
            base + "/predict", data=json.dumps(
                {"data": rows(1).tolist()}).encode(),
            headers={"Content-Type": "application/json",
                     "X-Model-Version": "r0001"})
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=30)
        assert err.value.code == 400
        with urllib.request.urlopen(base + "/statz", timeout=30) as r:
            statz = json.loads(r.read())
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            hz = json.loads(r.read())
        assert [r["version"] for r in statz["replicas"]] == ["r0002"] * 2
        assert statz["requests"]["ok"] == 2
        assert statz["replicas"][0]["slo"]["slo_ms"] == 10000
        assert hz["status"] == "ok" and len(hz["replicas"]) == 2
        assert "reload" not in statz            # serve_reload_s = 0
    finally:
        srv.stop()
        t.join(timeout=30)
    assert not t.is_alive()
