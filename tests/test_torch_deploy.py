"""The port's closed-loop deployment (``deploy/``) against the JAX
package's, and ``task = serve deploy_enable = 1`` through the port's
entry point, on the CPU.

* ``parse_deploy_config`` equal to the JAX package's on the defaults, on
  a typo and on each range error (the same messages);
* the composition refusals of ``task = serve`` (cascade with deploy or a
  reload, a cascade without its int8 round or its flagship, deploy with
  one replica, with a reload, or with as many canaries as replicas):
  the messages of the JAX package's serve task;
* both controllers, with injected clocks, over two-replica pools of
  ``torch_fleet_fixture``'s two-``fullc`` net and one round directory:
  a sane round canaries and promotes, a round with NaN in fc2 is
  blocked naming fc2, a SUSPECT round (fc2 scaled by 2, the same
  predictions) gets the longer window and promotes, a finite round that
  fails parity (fc2's columns permuted) canaries and rolls back, and
  the backoff refuses that round again. The actions, counters, replica
  versions and incident fields are the JAX controller's; after the
  rollback the canary answers bit-equal to its answers before;
* the reference quirks (ROADMAP queue C), both controllers driven: on
  an int8 fleet the JAX offline gate reads every round RELOAD-UNSAFE by
  structure against an int8 incumbent, and without an incumbent round
  its parity gate pins ``rNNNN`` where the canary serves
  ``rNNNN-int8``; with ``serve_breaker_threshold = 0`` it raises after
  the canary swapped. The port canaries and promotes in all three, and
  blocks a plain round that its int8 fleet refuses;
* under distributed tracing both pools keep the trace ids of their
  failed requests by version, and a failing canary gate hands them to
  its incident.
"""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest

from cxxnet_tpu_torch import checkpoint as ckpt
from cxxnet_tpu_torch.config import (ConfigError, parse_cli_overrides,
                                     parse_config_string)
from cxxnet_tpu_torch.deploy import (DeployConfig, DeployController,
                                     parse_deploy_config)
from cxxnet_tpu_torch.graph import build_graph
from cxxnet_tpu_torch.main import run
from cxxnet_tpu_torch.serve import ReplicaPool

from torch_fleet_fixture import (KW, NET_CFG, PORT_CFG, jax_pool, port_pool,
                                 rows, save_round, weights)


class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def deploy_kw():
    return dict(window_s=5.0, backoff_s=30.0, parity_tol=0.25,
                max_ratio=0.5, suspect_factor=2.0, poll_s=0.0)


# -- policy ------------------------------------------------------------------

@pytest.mark.parametrize("text", [
    "", "deploy_enable = 1\ndeploy_window_s = 90\ndeploy_parity_tol = 0.1\n",
    "deploy_windw_s = 60\n", "deploy_enable = 2\n", "deploy_window_s = 0\n",
    "deploy_suspect_factor = 0.5\n", "deploy_burn_max = 0\n",
    "deploy_parity_tol = 1.5\n", "deploy_canary_replicas = 0\n",
    "deploy_probe_rows = 0\n", "deploy_backoff_s = -1\n",
    "deploy_max_ratio = 0\n", "deploy_poll_s = -1\n",
    "deploy_window_s = soon\n"],
    ids=["defaults", "values", "typo", "enable", "window", "suspect",
         "burn", "parity", "canary", "probe", "backoff", "ratio", "poll",
         "float"])
def test_parse_deploy_config_matches_the_jax_package(text):
    from cxxnet_tpu.config import ConfigError as JaxConfigError
    from cxxnet_tpu.config import parse_config_string as jax_parse
    from cxxnet_tpu.deploy import parse_deploy_config as jax_parse_deploy
    try:
        want = jax_parse_deploy(jax_parse(text))
    except JaxConfigError as e:
        with pytest.raises(ConfigError) as got:
            parse_deploy_config(parse_config_string(text))
        assert str(got.value) == str(e)
        return
    got = parse_deploy_config(parse_config_string(text))
    assert vars(got) == vars(want)


# -- the composition refusals of task = serve --------------------------------

@pytest.mark.parametrize("over", [
    ["cascade_enable=1", "cascade_model=q.model", "deploy_enable=1",
     "serve_replicas=2"],
    ["cascade_enable=1", "cascade_model=q.model", "serve_reload_s=1"],
    ["cascade_enable=1"],
    ["cascade_enable=1", "cascade_model=q.model"],
    ["deploy_enable=1"],
    ["deploy_enable=1", "serve_replicas=2", "serve_reload_s=1"],
    ["deploy_enable=1", "serve_replicas=2", "deploy_canary_replicas=2"]],
    ids=["cascade_deploy", "cascade_reload", "cascade_no_model",
         "cascade_no_flagship", "deploy_one_replica", "deploy_reload",
         "deploy_all_canaries"])
def test_serve_composition_refusals_match_the_jax_task(over):
    from cxxnet_tpu.config import ConfigError as JaxConfigError
    from cxxnet_tpu.config import parse_cli_overrides as jax_over
    from cxxnet_tpu.config import parse_config_string as jax_parse
    from cxxnet_tpu.main import LearnTask
    args = ["task=serve", "serve_port=0", "silent=1"] + over
    with pytest.raises(JaxConfigError) as want:
        LearnTask(jax_parse(NET_CFG) + jax_over(args)).task_serve()
    with pytest.raises(ConfigError) as got:
        run(parse_config_string(PORT_CFG) + parse_cli_overrides(args))
    assert str(got.value) == str(want.value)


# -- the controller, held against the JAX controller --------------------------

def save_params(model_dir, r: int, params, cfg: str = NET_CFG) -> str:
    sig = build_graph(parse_config_string(cfg)).structure_signature()
    path = ckpt.model_path(str(model_dir), r)
    ckpt.save_model(path, structure_sig=sig, round_counter=r,
                    epoch_counter=0, params=params, net_state={})
    return path


def _copy(params):
    return {k: {kk: np.array(vv) for kk, vv in v.items()}
            for k, v in params.items()}


@pytest.fixture()
def ledger(tmp_path):
    from cxxnet_tpu.telemetry.ledger import LEDGER, new_run_id
    path = str(tmp_path / "ledger.jsonl")
    LEDGER.enable(path, new_run_id())
    yield path
    LEDGER.disable()


INCIDENT = ("round", "digest", "gate", "reason", "layers", "provenance",
            "trace_ids", "rolled_back", "backoff_s")


def test_controller_matches_the_jax_controller(tmp_path, ledger):
    from cxxnet_tpu.deploy import DeployConfig as JaxDeployConfig
    from cxxnet_tpu.deploy import DeployController as JaxController
    from cxxnet_tpu.telemetry.ledger import read_ledger
    from cxxnet_tpu import checkpoint as jax_ckpt
    models = tmp_path / "models"
    models.mkdir()
    base, _ = weights(1)
    r0 = save_params(models, 0, base)
    port = port_pool(2, blob=ckpt.load_for_inference(r0))
    jaxp = jax_pool(2, blob=jax_ckpt.load_for_inference(r0))
    clk, jclk = Clock(), Clock()
    ctl = DeployController(port, str(models), DeployConfig(**deploy_kw()),
                           drain_timeout_s=5.0, clock=clk)
    jctl = JaxController(jaxp, str(models), JaxDeployConfig(**deploy_kw()),
                         drain_timeout_s=5.0, clock=jclk)
    probe = rows(8, seed=5)
    actions, incidents = [], []

    def tick(dt=0.0):
        clk.t += dt
        jclk.t += dt
        got, want = ctl.check_once(), jctl.check_once()
        assert got == want, (got, want)
        assert [r.version for r in port.replicas] \
            == [r.version for r in jaxp.replicas]
        for k in ("promotions", "rollbacks", "incidents", "state",
                  "rejected_rounds"):
            assert ctl.snapshot()[k] == jctl.snapshot()[k], k
        actions.append(got)
        if got in ("blocked", "rollback"):
            incidents.append(dict(ctl.last_incident))
        return got

    try:
        assert tick() == ""
        # a sane round: every leaf within 1e-3 of its incumbent
        rs = np.random.RandomState(7)
        sane = {k: {kk: (v * (1 + 1e-3 * rs.randn(*v.shape))).astype(
            np.float32) for kk, v in lp.items()} for k, lp in base.items()}
        save_params(models, 1, sane)
        assert tick() == "canary"
        assert port.replicas[0].version == "r0001"
        assert ctl.snapshot()["canary"]["suspect"] is False
        assert tick(4.9) == ""
        assert tick(0.2) == "promote"
        # NaN in fc2: blocked before any replica is touched
        nan = _copy(sane)
        nan["fc2"]["wmat"][3, 1] = np.nan
        save_params(models, 2, nan)
        assert tick() == "blocked"
        # fc2 scaled by 2: SUSPECT (moved 1x its RMS > 0.5), the same
        # predictions; held by the backoff, then a doubled window
        scaled = _copy(sane)
        for k in ("wmat", "bias"):
            scaled["fc2"][k] = scaled["fc2"][k] * 2
        save_params(models, 3, scaled)
        assert tick() == ""
        assert tick(31) == "canary"
        assert ctl.snapshot()["canary"]["suspect"] is True
        assert ctl.snapshot()["canary"] == jctl.snapshot()["canary"]
        assert tick(6) == ""
        assert tick(5) == "promote"
        # fc2's columns permuted: finite, but the predictions move
        before = port.replicas[0].engine.predict_raw(probe)
        perm = _copy(scaled)
        perm["fc2"]["wmat"] = perm["fc2"]["wmat"][:, [1, 2, 3, 4, 0]]
        perm["fc2"]["bias"] = perm["fc2"]["bias"][[1, 2, 3, 4, 0]]
        save_params(models, 4, perm)
        assert tick(31) == "canary"
        assert port.replicas[0].version == "r0004"
        assert tick(11) == "rollback"
        after = port.replicas[0].engine.predict_raw(probe)
        assert np.array_equal(after, before)
        assert [r.version for r in port.replicas] == ["r0003"] * 2
        # the rejected round is never canaried again
        assert tick(1000) == ""
        assert actions == ["", "canary", "", "promote", "blocked", "",
                           "canary", "", "promote", "canary", "rollback",
                           ""]
        want = [e for e in read_ledger(ledger)
                if e["event"] == "deploy_incident"]
        assert len(want) == len(incidents) == 2
        for g, w in zip(incidents, want):
            assert {k: g[k] for k in INCIDENT} == {k: w[k] for k in INCIDENT}
        assert incidents[0]["gate"] == "offline"
        assert incidents[0]["layers"] == ["fc2"]
        assert incidents[0]["provenance"] == "layer=fc2 kind=param leaf=wmat"
        assert incidents[1]["gate"] == "parity"
        assert incidents[1]["rolled_back"] is True
        assert "disagree" in incidents[1]["reason"]
    finally:
        port.close()
        jaxp.close()


def test_controller_needs_two_replicas(tmp_path):
    pool = port_pool(1)
    try:
        with pytest.raises(ValueError, match="at least 2 replicas"):
            DeployController(pool, str(tmp_path),
                             DeployConfig(**deploy_kw()))
    finally:
        pool.close()


# -- the reference quirks -------------------------------------------------------

#: the fullc net over 32 inputs: an int8 round of it clears the default
#: drift verdict (each column's absmax weight saturates, 1/32 and 1/24 of
#: fc1's and fc2's weights, under quant_max_sat_frac 0.05; over 16
#: inputs fc1 reads 1/16 and every round is drift-UNSAFE)
WIDE_CFG = NET_CFG.replace("input_shape = 1,1,16", "input_shape = 1,1,32")


def _wide_round(r: int, seed: int):
    import torch
    from cxxnet_tpu_torch.convert import params_to_jax
    from cxxnet_tpu_torch.model import Network
    cfg = parse_config_string(WIDE_CFG + "dev = cpu\n")
    net = Network(build_graph(cfg), cfg)
    params, state = params_to_jax(*net.init(
        torch.Generator().manual_seed(seed)))
    return net, {"params": params, "state": state,
                 "meta": {"round": r, "epoch": 0}}


def save_wide_plain(model_dir, r: int, seed: int) -> str:
    _, blob = _wide_round(r, seed)
    return save_params(model_dir, r, blob["params"], cfg=WIDE_CFG)


def save_wide_int8(model_dir, r: int, seed: int) -> str:
    from cxxnet_tpu_torch.config import parse_quant_config
    from cxxnet_tpu_torch.quant import quantize_blob, write_quantized_round
    net, blob = _wide_round(r, seed)
    calib = [np.random.RandomState(seed).randn(16, 1, 1, 32)
             .astype(np.float32)]
    qblob, qm = quantize_blob(net, blob, calib, parse_quant_config(
        [("quant_calib_batches", "1")]))
    path = ckpt.model_path(str(model_dir), r)
    write_quantized_round(path, net.graph.structure_signature(), qblob, qm)
    return path


def test_int8_fleet_quirks_of_the_jax_controller(tmp_path):
    import jax
    from cxxnet_tpu import checkpoint as jax_ckpt
    from cxxnet_tpu.deploy import DeployConfig as JaxDeployConfig
    from cxxnet_tpu.deploy import DeployController as JaxController
    from cxxnet_tpu.serve import ReplicaPool as JaxPool
    from cxxnet_tpu.serve.fleet import UnknownVersion
    # rounds of two seeds: SUSPECT against each other, and apart in
    # their predictions, which the parity gate lets through here
    kw = dict(deploy_kw(), parity_tol=1.0)
    with_inc, without = tmp_path / "a", tmp_path / "b"
    with_inc.mkdir()
    without.mkdir()
    r1 = save_wide_int8(with_inc, 1, seed=1)
    save_wide_int8(with_inc, 2, seed=2)
    save_wide_int8(without, 2, seed=2)
    port = ReplicaPool.build(WIDE_CFG + "dev = cpu\n", 2,
                             blob=ckpt.load_for_inference(r1),
                             dtype="int8", **KW)
    jaxp = JaxPool.build(WIDE_CFG, 2, blob=jax_ckpt.load_for_inference(r1),
                         dtype="int8", devices=jax.devices()[:2], **KW)
    try:
        assert [r.version for r in jaxp.replicas] == ["r0001-int8"] * 2
        # an int8 incumbent on disk: the JAX gate compares it quantized
        # against the dequantized candidate
        clk = Clock()
        jctl = JaxController(jaxp, str(with_inc),
                             JaxDeployConfig(**kw),
                             drain_timeout_s=5.0, clock=clk)
        assert jctl.check_once() == "blocked"
        # no incumbent on disk: the canary swaps, and the parity gate
        # pins r0002, which no replica serves
        jctl = JaxController(jaxp, str(without),
                             JaxDeployConfig(**kw),
                             drain_timeout_s=5.0, clock=clk)
        assert jctl.check_once() == "canary"
        assert jaxp.replicas[0].version == "r0002-int8"
        clk.t += 6
        with pytest.raises(UnknownVersion):
            jctl.check_once()
        # the port: canary, then promote, on both directories
        for d in (with_inc, without):
            ctl = DeployController(port, str(d),
                                   DeployConfig(**kw),
                                   drain_timeout_s=5.0, clock=clk)
            assert ctl.check_once() == "canary"
            assert ctl.snapshot()["canary"]["version"] == "r0002-int8"
            clk.t += 11
            assert ctl.check_once() == "promote"
            assert [r.version for r in port.replicas] == ["r0002-int8"] * 2
            for rep in port.replicas:
                rep.engine.set_provenance(1, "")
        # a plain round into the int8 fleet: the watcher refuses it
        # before any drain, and the controller blocks it
        save_wide_plain(without, 3, seed=3)
        ctl = DeployController(port, str(without), DeployConfig(**kw),
                               drain_timeout_s=5.0, clock=clk)
        assert ctl.check_once() == "blocked"
        assert ctl.last_incident["gate"] == "offline"
        assert "not quantized" in ctl.last_incident["reason"]
        assert [r.version for r in port.replicas] == ["r0001-int8"] * 2
        assert all(r.state == "up" for r in port.replicas)
    finally:
        port.close()
        jaxp.close()


def test_breakerless_fleet_quirk_of_the_jax_controller(tmp_path):
    from cxxnet_tpu.deploy import DeployConfig as JaxDeployConfig
    from cxxnet_tpu.deploy import DeployController as JaxController
    # fresh weights against a round: apart, let through by the parity
    # gate here
    kw = dict(deploy_kw(), parity_tol=1.0)
    save_round(tmp_path, 0, seed=1)
    port = port_pool(2, breaker_threshold=0)
    jaxp = jax_pool(2, breaker_threshold=0)
    try:
        clk = Clock()
        jctl = JaxController(jaxp, str(tmp_path),
                             JaxDeployConfig(**kw),
                             drain_timeout_s=5.0, clock=clk)
        with pytest.raises(AttributeError, match="opens"):
            jctl.check_once()
        # the canary swapped, and the controller does not know it
        assert [r.version for r in jaxp.replicas] == ["r0000", "init"]
        assert jctl.check_once() == ""
        ctl = DeployController(port, str(tmp_path),
                               DeployConfig(**kw),
                               drain_timeout_s=5.0, clock=clk)
        assert ctl.check_once() == "canary"
        clk.t += 6
        assert ctl.check_once() == "promote"
        assert [r.version for r in port.replicas] == ["r0000"] * 2
    finally:
        port.close()
        jaxp.close()


# -- task = serve deploy_enable = 1 ---------------------------------------------

def test_task_serve_runs_the_controller(tmp_path):
    models = tmp_path / "models"
    models.mkdir()
    first = save_round(tmp_path, 0, seed=1)
    cfg = parse_config_string(PORT_CFG) + parse_cli_overrides(
        ["task=serve", f"model_in={first}", f"model_dir={models}",
         "serve_port=0", "serve_replicas=2", "serve_buckets=2,4,8",
         "serve_max_batch=8", "deploy_enable=1", "deploy_poll_s=0",
         "deploy_window_s=0.05", "silent=1"])
    ready, box = threading.Event(), {}

    def on_ready(srv):
        box["srv"] = srv
        ready.set()
    t = threading.Thread(target=run, args=(cfg,), kwargs={"ready": on_ready},
                         daemon=True)
    t.start()
    assert ready.wait(60)
    srv = box["srv"]
    try:
        ctl = srv.reload_watcher
        assert isinstance(ctl, DeployController)
        save_round(models, 1, seed=1)
        assert ctl.check_once() == "canary"
        time.sleep(0.1)
        assert ctl.check_once() == "promote"
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/statz", timeout=30) as r:
            statz = json.loads(r.read())
        assert statz["reload"]["promotions"] == 1
        assert statz["reload"]["state"] == "idle"
        assert [rep["version"] for rep in statz["replicas"]] \
            == ["r0001"] * 2
    finally:
        srv.stop()
        t.join(timeout=30)


def test_failing_canary_gates_carry_the_failed_trace_ids():
    """Under distributed tracing each pool keeps the trace ids of its
    failed requests by version (``ReplicaPool.failed_traces``, newest
    last), and a failing breaker gate hands them to the incident, in
    both packages."""
    from cxxnet_tpu.deploy.gates import breaker_gate as jax_breaker_gate
    from cxxnet_tpu.resilience import failpoints as jax_fp
    from cxxnet_tpu.telemetry.disttrace import DISTTRACE as JAX_DT
    from cxxnet_tpu_torch.deploy.gates import breaker_gate
    from cxxnet_tpu_torch.resilience import failpoints
    from cxxnet_tpu_torch.telemetry.disttrace import DISTTRACE
    got = {}
    for name, pool, dt, fp, gate in (
            ("port", port_pool(2), DISTTRACE, failpoints, breaker_gate),
            ("jax", jax_pool(2), JAX_DT, jax_fp, jax_breaker_gate)):
        dt.enable()
        try:
            ver = pool.replicas[0].version
            fp.set("serve.infer", "every:1")
            tids = []
            for _ in range(3):
                with dt.span("serve.request") as sp:
                    fut = pool.submit(rows(1), version=ver)
                tids.append(sp.ctx.trace_id)
                with pytest.raises(Exception):
                    fut.result(timeout=30)
            fp.clear("serve.infer")
            ok = pool.submit(rows(1), version=ver)   # untraced, succeeds
            ok.result(timeout=30)
            assert pool.failed_traces(ver) == tids
            g = gate(pool, [0, 1], ver, {0: -1, 1: 0})
            assert not g.passed and g.trace_ids == tids
            got[name] = (len(tids), g.gate)
        finally:
            fp.clear("serve.infer")
            dt.disable()
            pool.close()
    assert got["port"] == got["jax"] == (3, "breaker")
