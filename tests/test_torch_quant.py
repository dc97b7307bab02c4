"""The port's PTQ pass and int8 serving (``cxxnet_tpu_torch/quant``,
``serve_dtype = int8``) on the CPU against the JAX package's.

Rounds move between the packages as files. The narrow Inception-BN of
``torch_ibn_fixture`` (69 convs and fc1 quantize) serves in float32:

* PTQ: ``quantize_weight`` bit-equal to the JAX package's; activation
  scales from the two packages' own f32 forwards within rel 1e-5 (two
  implementations, so not bitwise); the drift verdicts equal.
* Interchange: one derived round served by both int8 engines. Every
  int8 layer of the served net agrees to one f32 rounding from the same
  inputs; the softmax rows agree to atol INT8_ROW_ATOL with the same
  top-1 where the margin exceeds 1e-3, except rows where the packages'
  roundings crossed a code boundary (readings in the test).
* A round quantized by the port's CLI loads digest-verified in the JAX
  package, is quantized there, and serves in its int8 engine.
* An fp engine dequantizes a quantized round on load in both packages
  (probabilities atol 1e-5, as the fp engines agree).
* The refusals raise with the JAX package's messages.
"""

import io
import json
import os
import threading
import types
import urllib.request
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch

from cxxnet_tpu import checkpoint as jax_ckpt
from cxxnet_tpu import quant as jax_quant
from cxxnet_tpu.config import parse_config_string as jax_parse
from cxxnet_tpu.config import parse_quant_config as jax_parse_quant_config
from cxxnet_tpu.serve.engine import InferenceEngine as JaxEngine
from cxxnet_tpu.serve.engine import negotiate_blob as jax_negotiate_blob
from cxxnet_tpu.serve.engine import restore_inference_blob
from cxxnet_tpu.trainer import Trainer
from cxxnet_tpu_torch import checkpoint as ckpt
from cxxnet_tpu_torch import quant
from cxxnet_tpu_torch.config import (ConfigError, parse_cli_overrides,
                                     parse_config_string, parse_quant_config,
                                     parse_serve_config, split_sections)
from cxxnet_tpu_torch.graph import build_graph
from cxxnet_tpu_torch.io import create_iterator
from cxxnet_tpu_torch.main import run
from cxxnet_tpu_torch.quant.__main__ import main as quant_main
from cxxnet_tpu_torch.serve import InferenceEngine
from cxxnet_tpu_torch.serve.engine import negotiate_blob

from torch_ibn_fixture import IBN_TEXT, jax_weights, port_net

F32 = "compute_dtype = float32\n"
WIDTH = 3 * 64 * 64
#: the narrow net's 3x3 stem reduction has fan-in 8 per channel, so 1/8
#: of its codes sit at 127 by construction: a ceiling above that floor
QC = "quant_calib_batches=2\nquant_max_sat_frac=0.2\n"
DATA = """
data = train
iter = synthetic
  num_inst = 32
  num_class = 10
  input_shape = 3,64,64
  seed_data = 4
iter = end
"""
#: int8 rows, port vs JAX engine on one derived round, where no code
#: boundary was crossed: readings up to 3e-8
INT8_ROW_ATOL = 1e-5


def rows(n, seed=0):
    """Flat request rows in NCHW element order, as clients send them."""
    return np.random.RandomState(seed).randn(n, WIDTH).astype(np.float32)


def calib_batches():
    """The first two batches of DATA, what the CLI calibrates over (the
    synthetic iterator's data is bit-equal to the JAX package's)."""
    itr = create_iterator(parse_config_string("batch_size = 16\n" + DATA)
                          [:1] + split_sections(parse_config_string(
                              DATA))[1][0][2])
    return [b.data for b in list(itr)[:2]]


def jax_trainer():
    from cxxnet_tpu.parallel import make_mesh_context
    return Trainer(jax_parse(IBN_TEXT + F32 + "dev = cpu\n"),
                   mesh_ctx=make_mesh_context(devices=jax.devices()[:1]))


def jax_engine(blob, dtype=None):
    tr = jax_trainer()
    restore_inference_blob(tr, jax_negotiate_blob(blob, dtype))
    return JaxEngine(tr, buckets="16", max_batch=16, dtype=dtype)


def port_engine(path, dtype=None):
    return InferenceEngine.from_checkpoint(
        IBN_TEXT + F32 + "dev = cpu\n", path, dtype=dtype, buckets="4,16",
        max_batch=16)


@pytest.fixture(scope="module")
def arts(tmp_path_factory):
    """A plain round written by the JAX package, the round the JAX
    package's PTQ derives from it, and the one the port's CLI derives."""
    td = tmp_path_factory.mktemp("quant")
    params, state = jax_weights()
    sig = build_graph(parse_config_string(IBN_TEXT)).structure_signature()
    src = str(td / "0003.model")
    jax_ckpt.save_model(src, structure_sig=sig, round_counter=3,
                        epoch_counter=1, params=params, net_state=state)
    blob = jax_ckpt.load_for_inference(src)
    qc = jax_parse_quant_config(jax_parse(QC))
    tr = jax_trainer()
    qblob, qm = jax_quant.quantize_blob(tr.net, blob, calib_batches(), qc)
    jpath = str(td / "0003.jax-int8.model")
    jax_quant.write_quantized_round(jpath, sig, qblob, qm)
    conf = str(td / "ibn.conf")
    with open(conf, "w") as f:
        f.write(IBN_TEXT + F32 + "batch_size = 16\n" + DATA)
    ppath = str(td / "0003.port-int8.model")
    out = io.StringIO()
    with redirect_stdout(out):
        rc = quant_main([conf, src, ppath, "--json", "dev=cpu",
                         *QC.split()])
    return types.SimpleNamespace(td=td, src=src, blob=blob, qm=qm, jpath=jpath,
                                 conf=conf, ppath=ppath, rc=rc,
                                 cli=json.loads(out.getvalue()), sig=sig)


# -- config -------------------------------------------------------------------

def test_parse_quant_config_defaults():
    qc = parse_quant_config([])
    assert qc.calib_batches == 4 and qc.calib_percentile == 100.0
    assert qc.max_rel_err == 0.05 and qc.max_sat_frac == 0.05
    assert qc.parity_tol == 0.02
    assert qc.cascade_enable == 0 and qc.cascade_threshold == 0.5
    assert qc.cascade_metric == "margin" and qc.cascade_replicas == 1
    assert qc == parse_quant_config([("cascade_enable", "0")])


def test_parse_quant_config_typo_raises():
    with pytest.raises(ConfigError):
        parse_quant_config([("quant_calib_batchs", "4")])
    with pytest.raises(ConfigError):
        parse_quant_config([("cascade_treshold", "0.5")])


@pytest.mark.parametrize("key,val", [
    ("quant_calib_batches", "0"), ("quant_calib_percentile", "0"),
    ("quant_calib_percentile", "100.5"), ("quant_max_rel_err", "0"),
    ("quant_max_sat_frac", "-1"), ("quant_parity_tol", "0"),
    ("cascade_threshold", "1.5"), ("cascade_metric", "vibes"),
    ("cascade_replicas", "0"), ("cascade_enable", "2"),
    ("quant_calib_batches", "four")])
def test_parse_quant_config_range_validation(key, val):
    with pytest.raises(ConfigError):
        parse_quant_config([(key, val)])
    with pytest.raises(Exception):       # the JAX package refuses it too
        jax_parse_quant_config([(key, val)])


def test_serve_dtype_int8_is_accepted_and_the_cascade_names_queue_a4():
    assert parse_serve_config([("serve_dtype", "int8")]).dtype == "int8"
    assert parse_serve_config([("cascade_enable", "0")]).dtype == ""
    for parse in (parse_quant_config, parse_serve_config):
        with pytest.raises(ConfigError, match="Queue A 4"):
            parse([("cascade_enable", "1")])


# -- PTQ ----------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(64, 8), (3, 3, 5, 7), (16, 1000)])
def test_quantize_weight_is_bit_equal_to_the_jax_package(shape):
    w = np.random.RandomState(sum(shape)).randn(*shape).astype(np.float32)
    w[..., 0] = 0.0                              # the scale-1 guard
    q, s = quant.quantize_weight(w)
    jq, js = jax_quant.quantize_weight(w)
    assert q.dtype == np.int8 and s.dtype == np.float32
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(s, js)
    assert quant.weight_drift(w, q, s) == jax_quant.weight_drift(w, jq, js)


@pytest.mark.parametrize("percentile", [100.0, 99.9])
def test_act_scales_match_the_jax_package(percentile):
    """Both packages' f32 forwards of the narrow net over the same
    batches: rel 1e-5."""
    net = port_net(F32)
    got = quant.calibrate_act_scales(net, calib_batches(), percentile)
    params, state = jax_weights()
    want = jax_quant.calibrate_act_scales(jax_trainer().net, params, state,
                                          calib_batches(), percentile)
    assert len(got) == 70 and set(got) == set(want)
    assert got == pytest.approx(want, rel=1e-5)
    assert quant.quantizable_layers(net) == \
        jax_quant.quantizable_layers(jax_trainer().net)


def test_calibration_requires_batches():
    with pytest.raises(ValueError, match="no batches"):
        quant.calibrate_act_scales(port_net(F32), [])


def test_drift_verdicts_equal_the_jax_package(arts):
    for thresholds in ((0.05, 0.2), (0.05, 0.05), (1e-4, 1.0)):
        got = quant.drift_verdict(arts.qm, *thresholds)
        want = jax_quant.drift_verdict(arts.qm, *thresholds)
        assert got == want
    assert quant.drift_verdict(arts.qm, 0.05, 0.05)["verdict"] == "UNSAFE"


def test_quantize_params_and_dequantize_match_the_jax_package(arts):
    params, _ = jax_weights()
    scales = arts.qm["act_scales"]
    got, drift = quant.quantize_params(params, scales)
    want, jdrift = jax_quant.quantize_params(params, scales)
    assert drift == jdrift
    for layer in want:
        for leaf, v in want[layer].items():
            np.testing.assert_array_equal(got[layer][leaf], v)
            assert np.asarray(got[layer][leaf]).dtype == np.asarray(v).dtype
    deq = quant.dequantize_params(got)
    assert not quant.is_quantized_params(deq)
    assert quant.is_quantized_params(got)
    jdeq = jax_quant.dequantize_params(want)
    for layer in jdeq:
        for leaf, v in jdeq[layer].items():
            np.testing.assert_array_equal(deq[layer][leaf], v)


# -- the CLI and the derived round --------------------------------------------

def test_cli_json_and_the_round_in_the_jax_package(arts):
    """The port's round loads digest-verified in the JAX package, is
    quantized there, and keeps the source's round and structure."""
    out = arts.cli
    assert out["exit_code"] == arts.rc == 0
    assert out["source_round"] == 3 and len(out["quantized_layers"]) == 70
    assert out["calib"] == {"batches": 2, "percentile": 100.0}
    assert out["drift"]["verdict"] == "SAFE"
    meta = jax_ckpt.verify_model(arts.ppath)
    assert jax_ckpt.is_quantized(meta) and ckpt.is_quantized(meta)
    assert jax_ckpt.blob_digest(meta) == out["out_digest"]
    assert ckpt.quant_meta(meta)["source_digest"] == \
        jax_ckpt.blob_digest(arts.blob["meta"])
    assert meta["round"] == 3 and meta["structure_sig"] == \
        arts.blob["meta"]["structure_sig"]
    blob = jax_ckpt.load_for_inference(arts.ppath)
    assert blob["params"]["cv_3a_3x3"]["wmat"].dtype == np.int8
    assert blob["params"]["cv_3a_3x3"]["wmat"].ndim == 4       # HWIO
    assert jax_quant.is_quantized_params(blob["params"])
    # the weights are the JAX package's bytes; the scales its own forward's
    np.testing.assert_array_equal(
        blob["params"]["fc1"]["wmat"],
        jax_quant.quantize_weight(jax_weights()[0]["fc1"]["wmat"])[0])
    # over the same batches: the JAX package's PTQ
    assert ckpt.quant_meta(meta)["act_scales"] == pytest.approx(
        arts.qm["act_scales"], rel=1e-5)


def test_cli_exits_2_on_an_unsafe_verdict(arts, capsys):
    out = str(arts.td / "unsafe.model")
    rc = quant_main([arts.conf, arts.src, out, "dev=cpu",
                     "quant_calib_batches=1", "quant_max_rel_err=1e-4"])
    text = capsys.readouterr().out
    assert rc == 2 and "quant drift UNSAFE" in text.splitlines()[-1]
    assert ckpt.is_quantized(ckpt.verify_model(out))   # written all the same


def test_extra_meta_clash_raises(tmp_path):
    with pytest.raises(ValueError, match="clash"):
        ckpt.save_model(str(tmp_path / "x.model"), structure_sig=(),
                        round_counter=0, epoch_counter=0, params={},
                        net_state={}, extra_meta={"round": 5})


def test_port_layouts_round_trip_int8(arts):
    """convert keeps int8 int8: a conv wmat OIHW in the port, HWIO back."""
    from cxxnet_tpu_torch.convert import params_from_jax, params_to_jax
    blob = ckpt.load_for_inference(arts.ppath)
    p, s = params_from_jax(blob["params"], blob["state"])
    assert p["cv_3a_3x3"]["wmat"].dtype == torch.int8
    assert p["cv_3a_3x3"]["act_scale"].dtype == torch.float32
    hw = blob["params"]["cv_3a_3x3"]["wmat"]
    assert tuple(p["cv_3a_3x3"]["wmat"].shape) == \
        (hw.shape[3], hw.shape[2], hw.shape[0], hw.shape[1])
    back, _ = params_to_jax(p, s)
    for layer, leaves in blob["params"].items():
        for leaf, v in leaves.items():
            assert back[layer][leaf].dtype == v.dtype
            np.testing.assert_array_equal(back[layer][leaf], v)


# -- serving ------------------------------------------------------------------

def _rows_and_engines(arts, which):
    path = arts.jpath if which == "jax-quantized" else arts.ppath
    x = np.concatenate([rows(16, seed=s) for s in range(5)])
    return (path, x, port_engine(path, "int8"),
            jax_engine(jax_ckpt.load_for_inference(path), "int8"))


@pytest.mark.parametrize("which", ["jax-quantized", "port-quantized"])
def test_int8_engines_agree_on_one_derived_round(arts, which):
    """The port's int8 engine against the JAX package's on the same
    derived round (one quantized by each package), 80 rows. Where the
    two packages' f32 roundings put an activation on either side of a
    code boundary, that code differs by one step, and the random-weight
    net's 69 BN layers amplify it: readings, 0 of 80 rows beyond 1e-5
    on the JAX-quantized round, 1 of 80 (by 0.19) on the port-quantized
    one; every other row within 3e-8. So at most 4 of 80 rows may leave
    atol INT8_ROW_ATOL, and every layer is held to 2 ulp from the same
    inputs (next test)."""
    path, x, eng, jeng = _rows_and_engines(arts, which)
    assert eng.serve_int8 and eng.weights_version == "r0003-int8"
    assert eng.weights_digest == ckpt.blob_digest(
        ckpt.load_for_inference(path)["meta"])
    got, want = eng.predict_raw(x), jeng.predict_raw(x)
    assert np.isfinite(got).all() and got.shape == (80, 10)
    np.testing.assert_allclose(got.sum(1), 1.0, atol=1e-5)
    near = np.abs(got - want).max(1) <= INT8_ROW_ATOL
    assert near.sum() >= 76, np.abs(got - want).max(1)
    srt = np.sort(want, 1)
    sure = near & (srt[:, -1] - srt[:, -2] > 1e-3)
    assert sure.sum() >= 60
    np.testing.assert_array_equal(got.argmax(1)[sure], want.argmax(1)[sure])


@pytest.mark.parametrize("which", ["jax-quantized", "port-quantized"])
def test_int8_layers_agree_inside_the_served_net(arts, which):
    """Each of the 70 int8 layers of the served net, from the node the
    JAX int8 engine feeds it (16 served rows), in the port and in the
    JAX layer: within 2 f32 ulp of max|y| (one rounding of the epilogue,
    tests/test_torch_fused_quant.py)."""
    from cxxnet_tpu.layers.base import ApplyCtx as JaxCtx
    from cxxnet_tpu_torch.layers import ApplyCtx
    path, x, eng, jeng = _rows_and_engines(arts, which)
    tr = jeng.trainer
    xin = eng._to_input(x[:16])
    nodes = jax.jit(lambda p, s, d: tr.net.apply(
        p, s, d, train=False, capture_nodes=True).nodes)(
        tr.params, tr.net_state, xin)
    net = eng.net
    placed = net.weights_for(torch.float32)
    checked = 0
    for li, spec in enumerate(net.graph.layers):
        if "wmat_scale" not in placed.get(spec.name, {}):
            continue
        v = np.array(nodes[net.graph.node_names[spec.nindex_in[0]]])
        act = net._fuse_act.get(li)
        got = net.layers[li].forward(
            placed[spec.name], {}, [torch.from_numpy(v)],
            ApplyCtx(compute_dtype=torch.float32, fused=net.fused,
                     fuse_act=act))[0].numpy()
        jl = tr.net.layers[li]
        want = np.asarray(jax.jit(lambda p, v: jl.apply(
            p, {}, [v], JaxCtx(train=False, fuse_act=act))[0][0])(
            tr.params[spec.name], v))
        tol = 2 * np.spacing(np.float32(np.abs(want).max()))
        assert np.abs(got - want).max() <= tol, spec.name
        checked += 1
    assert checked == 70


def test_fp_engine_serves_a_quantized_round_dequantized(arts):
    """The port's fp engine on a quantized round equals the JAX package's
    fp engine, which dequantizes on load."""
    eng = port_engine(arts.jpath)
    assert not eng.serve_int8 and eng.weights_version == "r0003"
    x = rows(16, seed=6)
    want = jax_engine(jax_ckpt.load_for_inference(arts.jpath)) \
        .predict_raw(x)
    np.testing.assert_allclose(eng.predict_raw(x), want, atol=1e-5)
    np.testing.assert_array_equal(eng.predict(x), want.argmax(1))


def _message(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_refusals_raise_with_the_jax_packages_messages(arts):
    plain = ckpt.load_for_inference(arts.src)
    assert _message(lambda: negotiate_blob(plain, "int8")) == \
        _message(lambda: jax_negotiate_blob(plain, "int8"))
    assert _message(lambda: port_engine(arts.src, "int8")) == \
        _message(lambda: jax_negotiate_blob(plain, "int8"))
    # an engine handed a quantized net without negotiation
    qnet = port_net(F32, weights=(
        ckpt.load_for_inference(arts.jpath)["params"], plain["state"]))
    tr = jax_trainer()
    tr.params, tr.net_state = tr._place(
        jax_ckpt.load_for_inference(arts.jpath)["params"], plain["state"])
    assert _message(lambda: InferenceEngine(qnet, buckets="4")) == \
        _message(lambda: JaxEngine(tr, buckets="4"))
    # an int8 engine handed a plain net
    tr.params, tr.net_state = tr._place(plain["params"], plain["state"])
    assert _message(lambda: InferenceEngine(port_net(F32), buckets="4",
                                            dtype="int8")) == \
        _message(lambda: JaxEngine(tr, buckets="4", dtype="int8"))


def test_load_weights_checks_the_quantized_leaves(arts):
    from cxxnet_tpu_torch.convert import params_from_jax
    blob = ckpt.load_for_inference(arts.ppath)
    net = port_net(F32)
    p, s = params_from_jax(blob["params"], blob["state"])
    net.load_weights(p, s)
    assert net.params["fc1"]["wmat"].dtype == torch.int8
    placed = net.weights_for(torch.bfloat16)["cv_3a_3x3"]
    assert placed["wmat"].dtype == torch.int8      # never cast
    assert placed["wmat"].shape[0] == p["cv_3a_3x3"]["wmat"].shape[0]
    bad = {k: dict(v) for k, v in p.items()}
    bad["fc1"]["wmat_scale"] = torch.ones(3)
    with pytest.raises(ValueError, match="wmat_scale"):
        net.load_weights(bad, s)
    bad = {k: dict(v) for k, v in p.items()}
    bad["fc1"]["wmat"] = bad["fc1"]["wmat"].float()
    with pytest.raises(ValueError, match="int8"):
        net.load_weights(bad, s)
    bad = {k: dict(v) for k, v in p.items()}
    bad["bn_3a_1x1"] = dict(bad["bn_3a_1x1"], wmat_scale=torch.ones(1))
    with pytest.raises(ValueError, match="does not quantize"):
        net.load_weights(bad, s)


def test_task_serve_int8_over_http(arts):
    """``task = serve serve_dtype = int8`` through the port's entry point:
    the derived round's version and its answers, as the engine gives
    them."""
    cfg = parse_config_string(IBN_TEXT + F32) + parse_cli_overrides(
        ["task=serve", "dev=cpu", f"model_in={arts.ppath}",
         "serve_dtype=int8", "serve_port=0", "serve_buckets=4",
         "serve_max_batch=4", "silent=1"])
    box, ready = {}, threading.Event()

    def on_ready(srv):
        box["srv"] = srv
        ready.set()

    t = threading.Thread(target=run, args=(cfg, on_ready), daemon=True)
    t.start()
    assert ready.wait(120)
    srv = box["srv"]
    try:
        x = rows(3, seed=8)
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/predict",
            data=json.dumps({"data": x.tolist(), "raw": 1,
                             "version": "r0003-int8"}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            out = json.loads(r.read())
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/statz", timeout=60) as r:
            statz = json.loads(r.read())
    finally:
        srv.stop()
        t.join(60)
    assert not t.is_alive()
    assert srv.engine.serve_int8
    assert statz["version"] == "r0003-int8"
    np.testing.assert_array_equal(np.asarray(out["prob"], np.float32),
                                  srv.engine.predict_raw(x))
