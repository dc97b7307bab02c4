"""Resumed training and the resume scan of the port against the JAX
package's task driver, on the CPU in float32 (the nets, rounds and
writers of ``test_torch_tasks.py``; a file of its own, so that it runs
beside the batch tasks on another worker).

* ``continue = 1``: both packages resume at the same round, skipping a
  torn newer one, and one more round later write a round whose
  parameters agree: synthetic_mlp within rtol 1e-5 (atol 1e-7);
  Inception-BN, one step a round, by the step tolerances of
  ``test_torch_train`` (its batch-norm gradients at init are chaotic:
  the packages' float32 steps from one state differ by up to 0.15 of
  the update per leaf), the loss within rtol 1e-4.
* ``model_in`` with ``task = train`` starts at the round after it;
  ``finetune`` copies by layer name with the JAX package's lines.
* The resume scan, the orphan sweep, ``task = serve`` with
  ``continue = 1``, and two data-parallel ranks resolving the round.
"""

import os
import threading
import time

import numpy as np
import pytest

from cxxnet_tpu import checkpoint as jax_ckpt
from cxxnet_tpu import main as jax_main
from cxxnet_tpu.config import parse_config_string as jax_parse
from cxxnet_tpu_torch import checkpoint as ckpt
from cxxnet_tpu_torch import main as port_main
from cxxnet_tpu_torch.config import parse_config_string
from cxxnet_tpu_torch.convert import params_to_jax

from test_torch_tasks import (NETS, ROUND, WRITERS, _bytes, _jax, _port,
                              _text, _weights, _write_round)


# -- continue = 1, model_in, finetune ---------------------------------------------

def _params_close(got_path, want_path, rtol, atol):
    got, want = (jax_ckpt.load_model(p) for p in (got_path, want_path))
    for k in ("round", "epoch", "step_count"):
        assert got["meta"][k] == want["meta"][k], k
    for tree in ("params", "state"):
        g, w = _flat(got[tree]), _flat(want[tree])
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=atol,
                                       err_msg=f"{tree}/{k}")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _torn_dirs(net, writer, tmp_path):
    """Two model_dirs (one a package) with rounds 2 and ROUND by
    ``writer`` and a torn round ROUND + 1."""
    dirs = {}
    for who in WRITERS:
        d = tmp_path / f"{who}_models"
        _write_round(net, writer, d, r=2)
        path = _write_round(net, writer, d)
        with open(path, "rb") as f:
            head = f.read(4096)
        with open(d / ("%04d.model" % (ROUND + 1)), "wb") as f:
            f.write(head)
        dirs[who] = d
    return dirs


@pytest.mark.parametrize("writer", WRITERS)
@pytest.mark.parametrize("net", NETS)
def test_continue_resumes_like_the_jax_package(tmp_path, capsys, net,
                                               writer):
    dirs = _torn_dirs(net, writer, tmp_path)
    out, loss = {}, {}
    for who, fn in (("jax", _jax), ("port", _port)):
        capsys.readouterr()
        ran = fn(_text(net, dirs[who], num_round=ROUND + 2),
                 **{"continue": 1})
        loss[who] = (ran.trainer if who == "jax" else ran).last_loss
        out[who] = capsys.readouterr().out
    for who in WRITERS:
        assert f"continuing from round {ROUND} " in out[who], out[who]
        assert "checkpoint scan: skipping invalid" in out[who]
        assert os.path.exists(dirs[who] / ("%04d.model" % (ROUND + 1)))
    got = str(dirs["port"] / ("%04d.model" % (ROUND + 1)))
    want = str(dirs["jax"] / ("%04d.model" % (ROUND + 1)))
    if net == "mlp":
        np.testing.assert_allclose(loss["port"], loss["jax"], rtol=1e-5)
        _params_close(got, want, rtol=1e-5, atol=1e-7)
        return
    # one step of the chaotic narrow Inception-BN: test_torch_train's
    # float32 step tolerances on the update from the round
    from test_torch_train import _check_step
    g, w = jax_ckpt.load_model(got), jax_ckpt.load_model(want)
    p, s, opt = _weights("ibn")
    _check_step("float32", 1, loss["port"], loss["jax"],
                (g["params"], g["opt"], g["state"]), (p, opt, s),
                (w["params"], w["opt"], w["state"]))


@pytest.mark.parametrize("writer", WRITERS)
def test_model_in_trains_from_the_round_after_it(tmp_path, capsys, writer):
    path = _write_round("mlp", writer, tmp_path / "round")
    got = {}
    for who, fn in (("jax", _jax), ("port", _port)):
        d = tmp_path / f"{who}_models"
        fn(_text("mlp", d, num_round=ROUND + 2), model_in=path)
        got[who] = sorted(os.listdir(d))
        assert got[who] == ["%04d.model" % (ROUND + 1)], who
    _params_close(str(tmp_path / "port_models" / got["port"][0]),
                  str(tmp_path / "jax_models" / got["jax"][0]),
                  rtol=1e-5, atol=1e-7)


def _finetune_text(net, model_dir):
    """The net with its last fullc's width changed (7 classes)."""
    text = _text(net, model_dir)
    old = 10 if net == "ibn" else 5
    return text.replace(f"nhidden = {old}", "nhidden = 7").replace(
        f"num_class = {old}", "num_class = 7")


@pytest.mark.parametrize("writer", WRITERS)
@pytest.mark.parametrize("net", NETS)
def test_finetune_copies_by_layer_name_like_the_jax_package(
        tmp_path, capsys, net, writer):
    from cxxnet_tpu_torch.trainer import Trainer
    path = _write_round(net, writer, tmp_path / "round")
    text = _finetune_text(net, tmp_path / "models") \
        + f"task = finetune\nmodel_in = {path}\n"
    head = "fc1" if net == "ibn" else "fc2"
    assert text.count("nhidden = 7") == 1
    capsys.readouterr()
    jt = jax_main.LearnTask(jax_parse(text))
    jt._init_model()
    want_lines = capsys.readouterr().out.splitlines()
    tr = Trainer(parse_config_string(text))
    start = port_main._init_model(tr, parse_config_string(text))
    got_lines = [ln for ln in capsys.readouterr().out.splitlines()
                 if ln.startswith("CopyModelFrom")]
    assert start == 0
    assert got_lines == want_lines
    assert f"CopyModelFrom: shape mismatch, skip layer {head!r}" in got_lines
    src = _weights(net)[0]
    got = params_to_jax(tr.params, {})[0]
    fresh = Trainer(parse_config_string(text))
    fresh.init_model()
    fresh = params_to_jax(fresh.params, {})[0]
    for layer, leaves in got.items():
        want = fresh[layer] if layer == head else src[layer]
        for leaf, v in leaves.items():
            np.testing.assert_array_equal(v, want[leaf], err_msg=layer)
    assert not np.array_equal(got[head]["wmat"][:, :5],
                              src[head]["wmat"][:, :5])
    # the whole task trains from there and writes round 0
    _port(_finetune_text(net, tmp_path / "models"), task="finetune",
          model_in=path, num_round=1)
    assert sorted(os.listdir(tmp_path / "models")) == ["0000.model"]


# -- the resume scan --------------------------------------------------------------

def test_the_scan_skips_a_torn_round_like_the_jax_package(tmp_path, capsys):
    d = tmp_path / "models"
    _write_round("mlp", "port", d, r=2)
    path = _write_round("mlp", "port", d)
    data = _bytes(path)
    with open(path, "wb") as f:           # the newest round torn
        f.write(data[:len(data) // 2])
    want = jax_ckpt.find_latest_valid(str(d), verbose=True)
    jax_out = capsys.readouterr().out
    got = ckpt.find_latest_valid(str(d), verbose=True, want_blob=True)
    out = capsys.readouterr().out
    assert got[:2] == want == (2, str(d / "0002.model"))
    assert got[2]["meta"]["round"] == 2 and got[2]["opt"] is not None
    assert out.startswith(f"checkpoint scan: skipping invalid {path}: ")
    assert jax_out.startswith(f"checkpoint scan: skipping invalid {path}: ")
    assert ckpt.find_latest(str(d)) == (ROUND, path)


def test_the_scan_finds_a_five_digit_round(tmp_path):
    d = tmp_path / "models"
    _write_round("mlp", "jax", d, r=9999)
    _write_round("mlp", "jax", d, r=10000)
    assert ckpt.find_latest_valid(str(d)) == \
        jax_ckpt.find_latest_valid(str(d)) == (10000,
                                               str(d / "10000.model"))
    assert ckpt.find_latest_valid(str(tmp_path / "none")) is None


def test_the_scan_sweeps_only_stale_foreign_temp_files(tmp_path, capsys):
    d = tmp_path / "models"
    _write_round("mlp", "port", d)
    stale, fresh = d / "0004.model.1.tmp", d / "0004.model.2.tmp"
    own = d / f"0005.model.{os.getpid()}.tmp"
    other = d / "notes.tmp"
    for p in (stale, fresh, own, other):
        p.write_bytes(b"partial")
    old = time.time() - 2 * ckpt.TMP_SWEEP_MIN_AGE_S
    for p in (stale, own, other):
        os.utime(p, (old, old))
    assert ckpt.find_latest_valid(str(d), verbose=True)[0] == ROUND
    assert capsys.readouterr().out == \
        "checkpoint scan: swept orphan 0004.model.1.tmp\n"
    assert sorted(os.listdir(d)) == sorted(
        ["0003.model", fresh.name, own.name, other.name])


def test_the_scan_names_the_shard_set_rounds_it_skips(tmp_path, capsys):
    d = tmp_path / "models"
    _write_round("mlp", "port", d)
    (d / "r0007").mkdir()
    (d / "r0008").mkdir()
    for _ in range(2):
        assert ckpt.find_latest_valid(str(d))[0] == ROUND
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2 and out[0] == out[1]
    assert "r0007, r0008" in out[0]
    assert "Queue A 11 (sharded checkpoints)" in out[0]


def test_serve_continue_serves_the_newest_valid_round(tmp_path, capsys):
    """``task = serve`` with ``continue = 1`` serves the newest round of
    model_dir that verifies, not a torn newer one, over model_in."""
    dirs = _torn_dirs("mlp", "port", tmp_path)
    cfg = parse_config_string(_text("mlp", dirs["port"])) + [
        ("task", "serve"), ("continue", "1"), ("serve_port", "0"),
        ("model_in", "/nowhere/0001.model"), ("serve_buckets", "4"),
        ("serve_max_batch", "4")]
    box = {}

    def ready(srv):
        box["version"] = srv.engine.weights_version
        srv.stop()

    t = threading.Thread(target=port_main.run, args=(cfg, ready),
                         daemon=True)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive()
    assert box["version"] == "r%04d" % ROUND
    out = capsys.readouterr().out
    assert f"serving model {dirs['port'] / ('%04d.model' % ROUND)}" in out


def test_dp_ranks_agree_on_the_round_or_raise(tmp_path):
    import torch.multiprocessing as mp
    from cxxnet_tpu_torch.parallel import launch
    import torch_dp_fixture
    a, b = tmp_path / "a", tmp_path / "b"
    _write_round("mlp", "port", a)
    _write_round("mlp", "port", b, r=2)
    got = launch(torch_dp_fixture.agree_latest_rank, ([str(a), str(a)],),
                 devices=("cpu", "cpu"), timeout_s=60, deadline_s=120)
    assert got == [ROUND, ROUND]
    with pytest.raises(mp.ProcessRaisedException,
                       match=r"ranks resolved different latest checkpoint "
                             r"rounds \[2, 3\]"):
        launch(torch_dp_fixture.agree_latest_rank, ([str(a), str(b)],),
               devices=("cpu", "cpu"), timeout_s=60, deadline_s=120)


def test_dp_continue_resumes_on_every_rank(tmp_path, capsys):
    d = tmp_path / "models"
    _write_round("mlp", "port", d)
    text = _text("mlp", d, num_round=ROUND + 2) + "continue = 1\n"
    port_main.run(parse_config_string(text), devices=("cpu", "cpu"))
    single = tmp_path / "single"
    _write_round("mlp", "port", single)
    _port(_text("mlp", single, num_round=ROUND + 2), **{"continue": 1})
    name = "%04d.model" % (ROUND + 1)
    _params_close(str(d / name), str(single / name), rtol=1e-5, atol=1e-6)
