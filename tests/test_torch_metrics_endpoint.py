"""``GET /metrics`` of the port's server against the JAX package's, on the
CPU: a single engine, a two-replica fleet with an LM plane, and a
two-tier cascade, each served by both packages and driven by the same
requests.

Both registries are process-global, and other tests of the process leave
their series in them, so a scrape is read for the series of the engines
and pools under test: each sample whose ``engine`` or ``pool`` label
names one of them, that label renamed by the object's place (``e0``,
``e1``, ``p0``). Of those:

* the set of (family, type, label names, label values) is equal: the
  same series, labels and types (histogram buckets included);
* the request counters are equal: ``cxxnet_serve_requests_total`` by
  outcome, the batch, row and version counters, the cascade's rows by
  tier;
* latency values and the cache counters (the JAX package compiles a
  cell where the port builds a runner) are not compared.
"""

import re
import socket
import urllib.request

import numpy as np
import pytest
import torch

from cxxnet_tpu_torch import checkpoint as ckpt
from cxxnet_tpu_torch.config import (parse_config_string,
                                     parse_lm_serve_config,
                                     parse_quant_config)
from cxxnet_tpu_torch.convert import params_to_jax
from cxxnet_tpu_torch.graph import build_graph
from cxxnet_tpu_torch.model import Network
from cxxnet_tpu_torch.serve import (CascadeRouter, InferenceEngine,
                                    ReplicaPool, ServeServer)

from test_lm_serve import BASE_KNOBS, LM_CFG, S, V
from torch_fleet_fixture import (KW, NET_CFG, PORT_CFG, rows, save_int8_round,
                                 save_round)

_SAMPLE = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})? (\S+)$')
_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
#: counter values held equal (the cache counters are not: the JAX
#: package compiles where the port builds a runner)
COUNTED = ("cxxnet_serve_requests_total", "cxxnet_serve_batches_dispatched_total",
           "cxxnet_serve_requests_batched_total",
           "cxxnet_serve_batch_rows_total",
           "cxxnet_serve_batches_coalesced_total",
           "cxxnet_serve_version_requests_total", "cxxnet_cascade_rows_total",
           "cxxnet_serve_slo_requests_total")


def _scrape(srv) -> str:
    url = f"http://127.0.0.1:{srv.port}/metrics"
    with urllib.request.urlopen(url, timeout=30) as r:
        assert r.headers["Content-Type"].startswith("text/plain; version=0.0.4")
        return r.read().decode("utf-8")


def _series(text: str, roles: dict):
    """({(family, type, ((label, value), ...))}, {key: value} of the
    counted families) of the samples whose ``engine`` or ``pool`` label
    is a key of ``roles``, that label replaced by its role."""
    types, out, counts = {}, set(), {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split()
            types[name] = kind
            continue
        if not line or line.startswith("#"):
            continue
        name, labels, value = _SAMPLE.match(line).groups()
        fam = name
        for suf in ("_bucket", "_sum", "_count"):
            if name.endswith(suf) and types.get(name[:-len(suf)]) \
                    == "histogram":
                fam = name[:-len(suf)]
        lab = dict(_LABEL.findall(labels or ""))
        keys = [k for k in ("engine", "pool") if k in lab]
        if not keys or not all((k, lab[k]) in roles for k in keys):
            continue
        for k in keys:
            lab[k] = roles[(k, lab[k])]
        key = (name, types[fam], tuple(sorted(lab.items())))
        out.add(key)
        if fam in COUNTED:
            counts[key] = float(value)
    return out, counts


def _roles(pool=None, engines=()):
    roles = {("engine", e.stats.instance): f"e{i}"
             for i, e in enumerate(engines)}
    if pool is not None:
        roles[("pool", pool.instance)] = "p0"
    return roles


def _compare(port_srv, port_roles, jax_srv, jax_roles):
    got, got_n = _series(_scrape(port_srv), port_roles)
    want, want_n = _series(_scrape(jax_srv), jax_roles)
    assert got == want
    assert got_n == want_n
    return got_n


def _start(srv):
    srv.start()
    return srv


@pytest.fixture(scope="module")
def fp_round(tmp_path_factory):
    return save_round(tmp_path_factory.mktemp("metrics"), 2, seed=4)


def test_single_engine(fp_round):
    import jax
    from cxxnet_tpu import checkpoint as jax_ckpt
    from cxxnet_tpu.config import parse_config_string as jax_parse
    from cxxnet_tpu.parallel import make_mesh_context
    from cxxnet_tpu.serve import InferenceEngine as JaxEngine
    from cxxnet_tpu.serve.engine import restore_inference_blob
    from cxxnet_tpu.serve.server import ServeServer as JaxServer
    from cxxnet_tpu.trainer import Trainer as JaxTrainer
    eng = InferenceEngine.from_checkpoint(PORT_CFG, fp_round,
                                          buckets=KW["buckets"],
                                          max_batch=KW["max_batch"])
    tr = JaxTrainer(jax_parse(NET_CFG),
                    mesh_ctx=make_mesh_context(devices=jax.devices()[:1]))
    restore_inference_blob(tr, jax_ckpt.load_for_inference(fp_round))
    jeng = JaxEngine(tr, buckets=KW["buckets"], max_batch=KW["max_batch"])
    knobs = dict(port=0, log_interval_s=0, silent=True,
                 handle_signals=False, slo_ms=1e4)
    srvs = [_start(ServeServer(eng, **knobs)),
            _start(JaxServer(jeng, **knobs))]
    try:
        for i, n in enumerate((1, 3, 8, 2)):
            for s in srvs:
                s.submit(rows(n, seed=30 + i)).result(timeout=60)
        counts = _compare(srvs[0], _roles(engines=[eng]), srvs[1],
                          _roles(engines=[jeng]))
        ok = ("cxxnet_serve_requests_total", "counter",
              (("engine", "e0"), ("result", "ok")))
        assert counts[ok] == 4
    finally:
        for s in srvs:
            s.stop()


def _lm_round(tmp_path_factory) -> str:
    cfg = parse_config_string(LM_CFG + "\ndev = cpu\n")
    net = Network(build_graph(cfg), cfg)
    p, st = params_to_jax(*net.init(torch.Generator().manual_seed(3)))
    path = ckpt.model_path(str(tmp_path_factory.mktemp("lm")), 1)
    ckpt.save_model(path, structure_sig=net.graph.structure_signature(),
                    round_counter=1, epoch_counter=0, params=p,
                    net_state=st)
    return path


def test_two_replica_fleet_with_an_lm_plane(tmp_path_factory):
    import jax
    from cxxnet_tpu import checkpoint as jax_ckpt
    from cxxnet_tpu.config import parse_lm_serve_config as jax_parse_lm
    from cxxnet_tpu.serve import ReplicaPool as JaxPool
    from cxxnet_tpu.serve.server import ServeServer as JaxServer
    path = _lm_round(tmp_path_factory)
    knobs = dict(buckets="8", max_batch=8, slo_ms=1e4)
    pool = ReplicaPool.build(LM_CFG + "\ndev = cpu\n", 2,
                             blob=ckpt.load_for_inference(path),
                             digest="d", **knobs)
    jpool = JaxPool.build(LM_CFG, 2, blob=jax_ckpt.load_for_inference(path),
                          digest="d", devices=jax.devices()[:2], **knobs)
    pool.attach_lm(parse_lm_serve_config(BASE_KNOBS))
    jpool.attach_lm(jax_parse_lm(BASE_KNOBS))
    srv_kw = dict(port=0, log_interval_s=0, silent=True,
                  handle_signals=False)
    srvs = [_start(ServeServer(pool=pool, **srv_kw)),
            _start(JaxServer(pool=jpool, **srv_kw))]
    try:
        rs = np.random.RandomState(0)
        for i in range(3):
            x = rs.randint(0, V, (1 + i, S)).astype(np.float32)
            # one new token: the prefill cell's, so the JAX planes compile
            # no decode cell
            prompt = list(rs.randint(1, V, 4 + i))
            for p in (pool, jpool):
                p.submit(x).result(timeout=60)
                p.submit_lm(prompt, max_new=1).result(timeout=120)
        counts = _compare(
            srvs[0], _roles(pool, [r.engine for r in pool.replicas]),
            srvs[1], _roles(jpool, [r.engine for r in jpool.replicas]))
        assert sum(v for (n, _, lab), v in counts.items()
                   if n == "cxxnet_serve_version_requests_total"
                   and ("result", "ok") in lab) == 3
        got, _ = _series(_scrape(srvs[0]), _roles(
            pool, [r.engine for r in pool.replicas]))
        fams = {n for n, _, _ in got}
        assert {"cxxnet_lm_kv_blocks_used", "cxxnet_lm_kv_pool_blocks",
                "cxxnet_lm_compile_cache_events_total",
                "cxxnet_serve_replica_state",
                "cxxnet_serve_version_requests_total",
                "cxxnet_serve_slo_burn_rate"} <= fams
    finally:
        srvs[0].stop()
        # the JAX handoff listener's accept() does not wake when its
        # socket closes, so its stop would wait out a 5 s join per
        # replica: flag it and wake it with one connection first
        for rep in jpool.replicas:
            rep.lm.listener._stop.set()
            socket.create_connection(rep.lm.listener.addr, timeout=5).close()
        srvs[1].stop()


def test_cascade(tmp_path_factory):
    import jax
    from cxxnet_tpu import checkpoint as jax_ckpt
    from cxxnet_tpu.config import parse_quant_config as jax_qc
    from cxxnet_tpu.serve import CascadeRouter as JaxRouter
    from cxxnet_tpu.serve.server import ServeServer as JaxServer
    src = save_round(tmp_path_factory.mktemp("cascade_fp"), 1, seed=3)
    q = save_int8_round(tmp_path_factory.mktemp("cascade_q"), 1, seed=3)
    reqs = [rows(n, seed=60 + i) for i, n in enumerate((2, 5, 1, 8, 3))]
    pairs = [("cascade_threshold", "0.5")]
    router = CascadeRouter.build_two_tier(
        PORT_CFG, flagship_blob=ckpt.load_for_inference(src),
        fast_blob=ckpt.load_for_inference(q),
        qc=parse_quant_config(pairs), **KW)
    jrouter = JaxRouter.build_two_tier(
        NET_CFG, flagship_blob=jax_ckpt.load_for_inference(src),
        fast_blob=jax_ckpt.load_for_inference(q), qc=jax_qc(pairs),
        devices=jax.devices()[:1], **KW)
    srv_kw = dict(port=0, log_interval_s=0, silent=True,
                  handle_signals=False)
    srvs = [_start(ServeServer(pool=router, **srv_kw)),
            _start(JaxServer(pool=jrouter, **srv_kw))]
    try:
        for x in reqs:
            for r in (router, jrouter):
                r.submit(x, "raw").result(timeout=60)
        counts = _compare(
            srvs[0], _roles(router, [r.engine for r in router.replicas]),
            srvs[1], _roles(jrouter, [r.engine for r in jrouter.replicas]))
        tiers = {dict(lab)["tier"]: v for (n, _, lab), v in counts.items()
                 if n == "cxxnet_cascade_rows_total"}
        assert sum(tiers.values()) == sum(len(x) for x in reqs)
    finally:
        for s in srvs:
            s.stop()
