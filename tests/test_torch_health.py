"""The trainer half of model health (``health = 1``) in the port against
the JAX package's, on the CPU, over a narrow conv net (conv, batch_norm,
relu, max pool, two fullc, softmax; f32, batch 16) whose weights the
JAX trainer draws and ``convert.py`` carries across.

* one step's health tree (``step_health``: gradient, param and update
  statistics, the global norm, the activation taps of every layer, BN's
  smallest batch variance) within 1e-5 of the JAX tree (relative, or
  1e-7 absolute), but the update ratios of zero-init leaves, which
  ``HealthProbe`` skips too;
* ``HealthProbe`` fed the same tree sets the same ``cxxnet_health_*``
  gauges and writes the same ``health_advice`` / ``model_health``
  events (thresholds set so each detector fires);
* ``diagnose_nonfinite`` names the JAX package's site for a poisoned
  param, a poisoned activation (the stashed batch) and non-finite
  gradients (an infinite loss scale);
* ``health = 1`` leaves the port's losses, masters, momenta and BN
  statistics bit-equal to ``health = 0``, and its per-step tree stays on
  the device until the probe reads it in one copy.
"""

import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

from cxxnet_tpu_torch.config import parse_config_string, parse_health_config
from cxxnet_tpu_torch.io.data import DataBatch
from cxxnet_tpu_torch.telemetry import modelhealth as pmh
from cxxnet_tpu_torch.telemetry.ledger import LEDGER, read_ledger
from cxxnet_tpu_torch.telemetry.registry import MetricRegistry
from cxxnet_tpu_torch.trainer import Trainer

NET = """
netconfig = start
layer[0->1] = conv:cv1
  kernel_size = 3
  pad = 1
  nchannel = 4
  random_type = xavier
layer[1->2] = batch_norm:bn1
layer[2->3] = relu:r1
layer[3->4] = max_pooling:mp1
  kernel_size = 2
  stride = 2
layer[4->5] = flatten:fl
layer[5->6] = fullc:fc1
  nhidden = 16
  random_type = xavier
layer[6->7] = relu:r2
layer[7->8] = fullc:fc2
  nhidden = 4
  random_type = xavier
layer[8->8] = softmax
netconfig = end
input_shape = 1,12,12
batch_size = 16
eta = 0.1
momentum = 0.9
health = 1
"""


def _batch(seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(16, 12, 12, 1).astype(np.float32),
            rs.randint(0, 4, (16, 1)).astype(np.float32))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = float(np.asarray(v))
    return out


@functools.lru_cache(maxsize=None)
def _pair():
    """(JAX trainer, port trainer) after one step on the same batch from
    the same weights."""
    import jax
    from cxxnet_tpu.config import parse_config_string as jparse
    from cxxnet_tpu.io.data import DataBatch as JBatch
    from cxxnet_tpu.trainer import Trainer as JTrainer
    jt = JTrainer(jparse(NET + "dev = cpu\n"))
    jt.init_model()
    weights = (jax.device_get(jt.params), jax.device_get(jt.net_state))
    pt = Trainer(parse_config_string(NET + "dev = cpu\n"))
    pt.init_model(weights=weights)
    data, label = _batch()
    jt.update(JBatch(data=data, label=label, num_batch_padd=0))
    pt.update(DataBatch(data=data, label=label, num_batch_padd=0))
    return jt, pt


def test_step_health_tree_within_1e5_of_the_jax_tree():
    import jax
    jt, pt = _pair()
    want = _flat(jax.device_get(jt.last_health_handle))
    got = _flat(pmh.host_tree(pt.last_health_handle))
    assert set(got) == set(want)
    assert "act/bn1/bn_var_min" in got and "act/r1/zero_frac" in got
    assert "grad/cv1/wmat/finite_frac" in got and "update/fc2/bias/ratio" \
        in got
    held = 0
    for k in want:
        layer_leaf = k[len("update/"):-len("/ratio")]
        if k.startswith("update/") and want[f"param/{layer_leaf}/rms"] \
                < 1e-6:
            # a zero-init leaf (a bias under BN): the ratio divides
            # rounding noise by 1e-12, which the probe skips as well
            continue
        assert got[k] == pytest.approx(want[k], rel=1e-5, abs=1e-7), k
        held += 1
    assert held >= len(want) - 3


#: thresholds at which each detector fires on the first sync
ADVICE = [("health_window", "1"), ("health_dead_frac", "0.1"),
          ("health_bn_var_floor", "100"), ("health_ratio_min", "0.5"),
          ("health_ratio_max", "0.6")]


def test_health_probe_gauges_and_events_equal_the_jax_probe(tmp_path):
    import jax
    from cxxnet_tpu.config import parse_health_config as jax_hc
    from cxxnet_tpu.telemetry.exporter import render_prometheus as jrender
    from cxxnet_tpu.telemetry.ledger import LEDGER as JLEDGER
    from cxxnet_tpu.telemetry.modelhealth import HealthProbe as JProbe
    from cxxnet_tpu.telemetry.registry import MetricRegistry as JRegistry
    from cxxnet_tpu_torch.telemetry.exporter import render_prometheus
    jt, _ = _pair()
    tree = jax.device_get(jt.last_health_handle)
    preg, jreg = MetricRegistry(), JRegistry()
    cfg, jcfg = parse_health_config(ADVICE), jax_hc(ADVICE)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    LEDGER.enable(str(tmp_path / "p.jsonl"), "r")
    JLEDGER.enable(str(tmp_path / "j.jsonl"), "r")
    try:
        pp = pmh.HealthProbe(cfg, registry=preg, silent=True)
        jp = JProbe(jcfg, registry=jreg, silent=True)
        for step in (1, 2):
            got = pp.ingest(tree, round_no=0, step=step)
            want = jp.ingest(tree, round_no=0, step=step)
            assert got == want
        pp.round_event(0)
        jp.round_event(0)
        assert pp.report_fragment() == jp.report_fragment()
        assert pp.last_grad_norm == jp.last_grad_norm
    finally:
        LEDGER.disable()
        JLEDGER.disable()
    assert render_prometheus(preg) == jrender(jreg)
    strip = lambda path: [{k: v for k, v in e.items()
                           if k not in ("ts", "run_id")}
                          for e in read_ledger(str(path))]
    pev, jev = strip(tmp_path / "p.jsonl"), strip(tmp_path / "j.jsonl")
    assert pev == jev
    kinds = {e["kind"] for e in pev if e["event"] == "health_advice"}
    assert kinds == {"dead_relu", "bn_collapse", "update_ratio"}


def _poison(kind, jt, pt):
    """Poison both trainers the same way."""
    import jax.numpy as jnp
    if kind == "param":
        jt.params["fc1"]["bias"] = jt.params["fc1"]["bias"].at[3].set(
            jnp.nan)
        with torch.no_grad():
            pt.params["fc1"]["bias"][3] = float("nan")
    elif kind == "activation":
        d, *rest = jt._health_batch
        jt._health_batch = (d.at[0, 5, 5, 0].set(jnp.inf), *rest)
        d, *rest = pt._health_batch
        d = d.clone()
        d[0, 5, 5, 0] = float("inf")
        pt._health_batch = (d, *rest)
    else:
        jt.opt_state["_mp"] = {"scale": jnp.float32(np.inf),
                               "good": jnp.int32(0)}
        pt.opt_state["_mp"] = {"scale": torch.tensor(float("inf")),
                               "good": torch.tensor(0, dtype=torch.int32)}


@pytest.mark.parametrize("kind,want", [
    ("param", "layer=fc1 kind=param leaf=bias"),
    ("activation", "layer=cv1 kind=activation node="),
    ("grad", "layer=cv1 kind=grad leaf=")])
def test_diagnose_nonfinite_names_the_jax_site(kind, want):
    import jax
    from cxxnet_tpu.config import parse_config_string as jparse
    from cxxnet_tpu.io.data import DataBatch as JBatch
    from cxxnet_tpu.telemetry.modelhealth import \
        diagnose_nonfinite as jax_diagnose
    from cxxnet_tpu.trainer import Trainer as JTrainer
    jt = JTrainer(jparse(NET + "dev = cpu\n"))
    jt.init_model()
    pt = Trainer(parse_config_string(NET + "dev = cpu\n"))
    pt.init_model(weights=(jax.device_get(jt.params),
                           jax.device_get(jt.net_state)))
    data, label = _batch(1)
    jt.update(JBatch(data=data, label=label, num_batch_padd=0))
    pt.update(DataBatch(data=data, label=label, num_batch_padd=0))
    assert pmh.diagnose_nonfinite(pt) is None
    _poison(kind, jt, pt)
    got, expect = pmh.diagnose_nonfinite(pt), jax_diagnose(jt)
    assert got == expect and got.startswith(want)


def _run_port(health: int, steps: int = 4):
    pt = Trainer(parse_config_string(
        NET.replace("health = 1", f"health = {health}") + "dev = cpu\n"))
    pt.init_model()
    losses = []
    for s in range(steps):
        data, label = _batch(s)
        pt.update(DataBatch(data=data, label=label, num_batch_padd=0))
        losses.append(pt.last_loss_tensor.clone())
    return pt, torch.stack(losses)


def test_health_on_is_bit_equal_to_health_off():
    on, lon = _run_port(1)
    off, loff = _run_port(0)
    assert torch.equal(lon, loff)
    flat = lambda t: [v for _, v in pmh._leaf_pairs(t)]
    for a, b in zip(flat(on.params) + flat(on.opt_state["mom"])
                    + flat(on.net.state),
                    flat(off.params) + flat(off.opt_state["mom"])
                    + flat(off.net.state)):
        assert torch.equal(a, b)
    assert off.last_health_handle is None
    tree = on.last_health_handle
    assert all(torch.is_tensor(v) and v.dim() == 0
               for _, v in pmh._leaf_pairs(tree))
    host = pmh.host_tree(tree)
    assert json.dumps(host)        # plain floats
    assert pmh.diagnose_nonfinite(on) is None
