"""The port's two-tier cascade (``serve/cascade.py``) against the JAX
package's ``CascadeRouter``, and ``task = serve cascade_enable = 1``
through the port's entry point, on the CPU.

* ``row_confidence`` within 1e-12 of the JAX function on seeded rows:
  margin and entropy over softmax rows, one column (never escalates),
  and rows that are not normalized (negative entries clipped);
* both routers built on the same flagship round and the same int8 round
  of ``torch_fleet_fixture``'s two-``fullc`` net in float32, the int8
  round quantized by the JAX package's PTQ as
  ``tests/test_torch_int8_calib.py`` does, the threshold between the two
  middle margins of the int8 tier over the request rows (so both
  branches run and no row sits on it). Over the same requests of 1-8
  rows: the answers within that file's ``PORT_VS_JAX`` (rel L2), the
  same escalation mask outside a 1e-6 band around the threshold, the
  same ``cascade_stats`` counters; escalated rows are the flagship
  engine's answers and the rest the int8 engine's. Version pins and
  ``extract`` bypass the cascade.
"""

import json
import threading
import urllib.request

import numpy as np
import pytest

from cxxnet_tpu_torch import checkpoint as ckpt
from cxxnet_tpu_torch.config import (parse_cli_overrides,
                                     parse_config_string,
                                     parse_quant_config)
from cxxnet_tpu_torch.graph import build_graph
from cxxnet_tpu_torch.main import run
from cxxnet_tpu_torch.serve import CascadeRouter, row_confidence

from torch_fleet_fixture import KW, NET_CFG, PORT_CFG, rows, save_round

#: the port's int8 answers against the JAX package's on one round
#: (tests/test_torch_int8_calib.py)
PORT_VS_JAX = 1e-3
#: requests of 1-8 rows
SIZES = (1, 3, 8, 5, 2, 7, 4, 6)
BAND = 1e-6


def _conf_rows(kind: str) -> np.ndarray:
    rs = np.random.RandomState({"softmax": 1, "one": 2, "raw": 3}[kind])
    if kind == "softmax":
        z = rs.randn(64, 10) * 3
        e = np.exp(z - z.max(1, keepdims=True))
        return (e / e.sum(1, keepdims=True)).astype(np.float32)
    if kind == "one":
        return rs.rand(9, 1).astype(np.float32)
    return (rs.randn(32, 6) * 2).astype(np.float32)


@pytest.mark.parametrize("kind", ["softmax", "one", "raw"])
@pytest.mark.parametrize("metric", ["margin", "entropy"])
def test_row_confidence_matches_the_jax_package(kind, metric):
    from cxxnet_tpu.serve.cascade import row_confidence as jax_conf
    p = _conf_rows(kind)
    got, want = row_confidence(p, metric), jax_conf(p, metric)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    if kind == "one":
        assert (got == 1.0).all()
    assert np.isfinite(got).all() and (got >= -1e-12).all()


@pytest.fixture(scope="module")
def rounds(tmp_path_factory):
    """The flagship round (port writer) and its int8 derivation by the
    JAX package's PTQ, calibrated on rows drawn as the requests are."""
    import jax
    from cxxnet_tpu import checkpoint as jax_ckpt
    from cxxnet_tpu import quant as jax_quant
    from cxxnet_tpu.config import parse_config_string as jax_parse
    from cxxnet_tpu.config import parse_quant_config as jax_qc
    from cxxnet_tpu.graph import build_graph as jax_graph
    from cxxnet_tpu.model import Network as JaxNetwork
    td = tmp_path_factory.mktemp("cascade")
    src = save_round(td, 1, seed=3)
    jcfg = jax_parse(NET_CFG)
    net = JaxNetwork(jax_graph(jcfg), jcfg)
    calib = rows(32, seed=100).reshape(32, 1, 1, 16)
    qblob, qm = jax_quant.quantize_blob(
        net, jax_ckpt.load_for_inference(src), [calib],
        jax_qc([("quant_calib_batches", "1")]))
    q = str(td / "int8.model")
    jax_quant.write_quantized_round(
        q, build_graph(parse_config_string(NET_CFG)).structure_signature(),
        qblob, qm)
    reqs = [rows(n, seed=10 + i) for i, n in enumerate(SIZES)]
    return {"src": src, "int8": q, "reqs": reqs, "devices": jax.devices()}


def _threshold(router, reqs) -> float:
    """Half way between the two middle int8 margins over ``reqs``."""
    fast = router.replicas[0].engine
    m = np.sort(np.concatenate([row_confidence(fast.predict_raw(x))
                                for x in reqs]))
    k = len(m) // 2
    return float((m[k - 1] + m[k]) / 2)


def _port_router(r, thr: float):
    qc = parse_quant_config([("cascade_threshold", repr(thr))])
    return CascadeRouter.build_two_tier(
        PORT_CFG, flagship_blob=ckpt.load_for_inference(r["src"]),
        fast_blob=ckpt.load_for_inference(r["int8"]), qc=qc, **KW)


def _jax_router(r, thr: float):
    from cxxnet_tpu import checkpoint as jax_ckpt
    from cxxnet_tpu.config import parse_quant_config as jax_qc
    from cxxnet_tpu.serve import CascadeRouter as JaxRouter
    qc = jax_qc([("cascade_threshold", repr(thr))])
    return JaxRouter.build_two_tier(
        NET_CFG, flagship_blob=jax_ckpt.load_for_inference(r["src"]),
        fast_blob=jax_ckpt.load_for_inference(r["int8"]), qc=qc,
        devices=r["devices"][:1], **KW)


COUNTERS = ("requests", "requests_escalated", "rows", "rows_escalated",
            "failed")


def test_cascade_matches_the_jax_router(rounds):
    reqs = rounds["reqs"]
    probe = _port_router(rounds, 0.5)
    thr = _threshold(probe, reqs)
    probe.close()
    port, jaxr = _port_router(rounds, thr), _jax_router(rounds, thr)
    try:
        assert port.fast_version == jaxr.fast_version == "r0001-int8"
        assert port.flagship_version == jaxr.flagship_version == "r0001"
        got = [port.submit(x, "raw").result(timeout=60) for x in reqs]
        want = [jaxr.submit(x, "raw").result(timeout=60) for x in reqs]
        fast, flag = port.replicas[0].engine, port.replicas[1].engine
        jfast = jaxr.replicas[0].engine
        n_esc = 0
        for x, g, w in zip(reqs, got, want):
            assert g.shape == w.shape == (x.shape[0], 5)
            assert np.linalg.norm(g - w) / np.linalg.norm(w) <= PORT_VS_JAX
            conf = row_confidence(fast.predict_raw(x))
            jconf = row_confidence(np.asarray(jfast.predict_raw(x)))
            esc, jesc = conf < thr, jconf < thr
            sure = np.abs(jconf - thr) > BAND
            assert sure.all()
            assert (esc == jesc).all()
            n_esc += int(esc.sum())
            # escalated rows answer from the flagship, the rest from int8
            np.testing.assert_allclose(g[esc], flag.predict_raw(x)[esc],
                                       rtol=0, atol=1e-6)
            np.testing.assert_allclose(g[~esc], fast.predict_raw(x)[~esc],
                                       rtol=0, atol=1e-6)
        assert 0 < n_esc < sum(SIZES)
        ps, js = port.cascade_stats(), jaxr.cascade_stats()
        assert {k: ps[k] for k in COUNTERS} == {k: js[k] for k in COUNTERS}
        assert ps["rows_escalated"] == n_esc and ps["failed"] == 0
        assert ps["escalation_rate"] == js["escalation_rate"]
        # predict answers are the raw answers' argmax
        pred = port.submit(reqs[2], "predict").result(timeout=60)
        np.testing.assert_array_equal(pred, got[2].argmax(1))
        # pins and extract bypass the cascade
        before = port.cascade_stats()["requests"]
        pinned = port.submit(reqs[2], "raw",
                             version="r0001").result(timeout=60)
        np.testing.assert_allclose(pinned, flag.predict_raw(reqs[2]),
                                   rtol=0, atol=1e-6)
        top = port.submit(reqs[2], "extract", "top").result(timeout=60)
        assert top.shape == (8, 5)
        assert port.cascade_stats()["requests"] == before
        snap = port.snapshot()
        assert snap["cascade"]["threshold"] == thr
        assert set(snap["versions"]) == {"r0001", "r0001-int8"}
    finally:
        port.close()
        jaxr.close()


def test_cascade_refuses_one_version_for_both_tiers(rounds):
    qc = parse_quant_config([])
    blob = ckpt.load_for_inference(rounds["int8"])
    with pytest.raises(ValueError, match="distinct versions"):
        CascadeRouter.build_two_tier(PORT_CFG, flagship_blob=blob,
                                     fast_blob=blob, qc=qc,
                                     flagship_dtype="int8", **KW)


def test_task_serve_runs_the_cascade_over_http(rounds):
    cfg = parse_config_string(PORT_CFG) + parse_cli_overrides(
        ["task=serve", f"model_in={rounds['src']}", "serve_port=0",
         "cascade_enable=1", f"cascade_model={rounds['int8']}",
         "cascade_threshold=0.99", "serve_buckets=2,4,8",
         "serve_max_batch=8", "silent=1"])
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
        assert isinstance(srv.pool, CascadeRouter)
        x = rounds["reqs"][2]
        req = urllib.request.Request(
            base + "/predict",
            data=json.dumps({"data": x.tolist(), "raw": 1}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            got = np.asarray(json.loads(r.read())["prob"], np.float32)
        flag = srv.pool.replicas[1].engine.predict_raw(x)
        fast = srv.pool.replicas[0].engine.predict_raw(x)
        esc = row_confidence(fast) < 0.99
        assert esc.any()
        np.testing.assert_allclose(got[esc], flag[esc], rtol=0, atol=1e-6)
        np.testing.assert_allclose(got[~esc], fast[~esc], rtol=0, atol=1e-6)
        with urllib.request.urlopen(base + "/statz", timeout=30) as r:
            statz = json.loads(r.read())
        assert statz["cascade"]["rows"] == 8
        assert statz["cascade"]["rows_escalated"] == int(esc.sum())
        assert [rep["version"] for rep in statz["replicas"]] \
            == ["r0001-int8", "r0001"]
    finally:
        srv.stop()
        t.join(timeout=30)
