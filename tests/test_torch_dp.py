"""The port's data-parallel training (two CPU ranks over gloo, a
``file://`` rendezvous) against the JAX package's single-device trainer
and the port's own single-device run on the same global batch.

* One SGD step of the narrow Inception-BN of ``torch_ibn_fixture`` (69
  batch_norm layers, global batch 16, 8 rows a rank), from the same
  weights carried to both packages by ``convert.py``, with the kernels'
  plain versions and with ``fused_kernels = 0``, against the JAX
  package's single-device step on the global batch (``fused_kernels =
  0``, compiled with excess precision off). float32 tolerances of
  ``test_torch_train.py``'s step check: loss rtol 1e-4, the update
  (after - before) of each parameter and momentum leaf within a
  relative L2 difference of 0.15 and 5e-2 in the median over leaves
  (the gradient of a deep BN net at init is chaotic under f32 rounding;
  see that file), each BN running statistic 1e-3. The two ranks end
  bit-equal.
* The narrow AlexNet (dropout) and SPP net (insanity) of
  ``torch_convnet_fixture``: one dp step against the port's
  single-device step on the global batch (each rank draws the global
  batch's draws and keeps its rows).
* ``examples/synthetic_mlp.conf`` trained two rounds through
  ``python -m cxxnet_tpu_torch.main``'s ``run`` with ``devices=("cpu",
  "cpu")``, its training set cut to 504 rows so that the last batch of
  64 holds 8 padded rows, all on rank 1, and its test set to 250 (6
  padded): the round lines' metrics equal the single-device run's, and
  the written round, which the JAX package loads, has the same
  parameters and momenta (atol 1e-5: the two halves' gradients are
  summed in another order).
* Refusals: ``batch_size`` not divisible by the ranks, ``bn_two_pass``
  under dp, the multi-host keys, and a rank that raises (the launcher
  stops the other rank and raises with the failing rank's traceback
  within its timeout).
"""

import functools
import os
import re
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cxxnet_tpu import checkpoint as jax_ckpt
from cxxnet_tpu.config import parse_config_string as jax_parse
from cxxnet_tpu.trainer import Trainer as JaxTrainer
from cxxnet_tpu_torch.config import (ConfigError, parse_config_string,
                                     split_sections)
from cxxnet_tpu_torch.io import create_iterator
from cxxnet_tpu_torch.parallel import DpContext, launch
from cxxnet_tpu_torch.trainer import Trainer

import torch_dp_fixture
from torch_convnet_fixture import narrow_pairs, synthetic_section
from torch_ibn_fixture import BATCH, IBN_TEXT, REPO

HYPER = """
eta = 0.1
momentum = 0.9
wd = 0.0001
batch_size = 16
dev = cpu
compute_dtype = float32
fused_kernels = {fused}
"""
SYNTH = """
iter = synthetic
  num_inst = {n}
  num_class = 10
  input_shape = 3,64,64
  seed_data = {seed}
iter = end
"""
#: per step (loss rtol; bound on a leaf's update rel L2; on its median
#: over leaves; on a BN running statistic's rel L2): test_torch_train's
#: float32 bounds
TOL = (1e-4, 0.15, 5e-2, 1e-3)
CPU2 = ("cpu", "cpu")


def _np_tree(t):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), t)


def _leafs(tree):
    return {(l, k): v for l, d in tree.items() for k, v in d.items()}


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


@functools.lru_cache(maxsize=None)
def _batch():
    pairs = [("batch_size", str(BATCH))] + parse_config_string(
        SYNTH.format(n=BATCH, seed=3))
    return next(iter(create_iterator(pairs)))


@functools.lru_cache(maxsize=None)
def _weights():
    """The narrow net's weights drawn by the port (seed 0) in the JAX
    layout, carried to both packages by ``convert.py``. The BN running
    statistics are the init's zeros: a training step only moves them by
    its batch's moments."""
    from cxxnet_tpu_torch.convert import params_to_jax
    from cxxnet_tpu_torch.graph import build_graph
    from cxxnet_tpu_torch.model import Network
    cfg = parse_config_string(IBN_TEXT + HYPER.format(fused=0))
    net = Network(build_graph(cfg), cfg)
    return params_to_jax(*net.init(torch.Generator().manual_seed(0)))


@functools.lru_cache(maxsize=None)
def _jax_step():
    """(loss, before, after) of one JAX single-device step of the narrow
    net on the global batch, fused_kernels = 0, from :func:`_weights`."""
    tr = JaxTrainer(jax_parse(IBN_TEXT + HYPER.format(fused=0)))
    params, state = _weights()
    tr.params, tr.net_state, tr.opt_state = tr._place(
        params, state, tr.optimizer.init_state(params))
    b = _batch()
    sched = {tag: (jnp.float32(lr), jnp.float32(m))
             for tag, (lr, m) in tr.optimizer.schedules(0).items()}
    args = (tr.params, tr.opt_state, tr.net_state, {}, jnp.asarray(b.data),
            jnp.asarray(b.label), jnp.ones((BATCH,), jnp.float32), (),
            jax.random.PRNGKey(0), sched)
    before = (_np_tree(tr.params), _np_tree(tr.opt_state),
              _np_tree(tr.net_state))
    step = tr._make_train_step(True).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})
    p, o, s, _, loss, _, _ = step(*args)
    return float(loss), before, (_np_tree(p), _np_tree(o), _np_tree(s))


@pytest.fixture(scope="module")
def ibn_dp():
    """fused -> both ranks' (losses, trees after one step)."""
    texts = {f: IBN_TEXT + HYPER.format(fused=f) for f in ("auto", "0")}
    return {f: launch(torch_dp_fixture.train_step_rank,
                      (t, _weights(), [_batch()]), devices=CPU2,
                      timeout_s=120, deadline_s=240)
            for f, t in texts.items()}


@pytest.mark.parametrize("fused", ["auto", "0"])
def test_ibn_dp_step_matches_the_jax_single_device_step(ibn_dp, fused):
    want_loss, before, after = _jax_step()
    (l0, t0), (l1, t1) = ibn_dp[fused]
    assert l0 == l1
    for a, b in zip(t0, t1):                 # the replicas stay bit-equal
        for k, v in _leafs(a if "mom" not in a else a["mom"]).items():
            np.testing.assert_array_equal(
                v, _leafs(b if "mom" not in b else b["mom"])[k])
    loss_rtol, leaf_tol, median_tol, state_tol = TOL
    np.testing.assert_allclose(l0[0], want_loss, rtol=loss_rtol)
    gp, go, gs = t0
    rels = []
    for g, w, b in ((gp, after[0], before[0]),
                    (go["mom"], after[1]["mom"], before[1]["mom"])):
        g, w, b = _leafs(g), _leafs(w), _leafs(b)
        assert set(g) == set(w)
        rels += [(_rel(g[k] - b[k], w[k] - b[k]), k) for k in w]
    assert max(rels)[0] <= leaf_tol, max(rels)
    assert float(np.median([r for r, _ in rels])) <= median_tol
    gs, ws = _leafs(gs), _leafs(after[2])
    assert set(gs) == set(ws)
    worst = max((_rel(gs[k], ws[k]), k) for k in ws)
    assert worst[0] <= state_tol, worst


# -- nets that draw: dropout and insanity ------------------------------------------

def _drawing_case(net):
    """(config pairs, global batch) of the narrow ``net`` of
    ``torch_convnet_fixture``, float32, its draws left as they are."""
    pairs = narrow_pairs(net)
    data = synthetic_section("data", "train", BATCH, 5, net)[1:]
    batch = next(iter(create_iterator([("batch_size", str(BATCH))] + data)))
    return pairs, batch


@pytest.mark.parametrize("net", ["alexnet", "spp"])
def test_drawing_net_dp_step_equals_the_single_device_step(net):
    """AlexNet (dropout on fc6 and fc7) and the SPP net (seven insanity
    layers): one dp step on two ranks against the port's single-device
    step on the global batch from the same seeded init. Each rank draws
    the global batch's mask or slopes and keeps its rows, so the two
    steps draw alike and differ only in the order of the gradient's
    sums: loss rtol 1e-5, every leaf of the update within a relative L2
    difference of 1e-3, the layer state (insanity's step) equal."""
    pairs, batch = _drawing_case(net)
    (l0, t0), (l1, t1) = launch(torch_dp_fixture.train_step_rank,
                                (pairs, None, [batch]), devices=CPU2,
                                timeout_s=120, deadline_s=240)
    from cxxnet_tpu_torch.convert import opt_to_jax, params_to_jax
    tr = Trainer(pairs)
    tr.init_model()
    before = params_to_jax(tr.params, tr.net.state)[0], \
        opt_to_jax(tr.opt_state)
    tr.update(batch)
    want_p, want_s = params_to_jax(tr.params, tr.net.state)
    want_o = opt_to_jax(tr.opt_state)
    assert l0 == l1
    np.testing.assert_allclose(l0[0], tr.last_loss, rtol=1e-5)
    rels = []
    for g, w, b in ((t0[0], want_p, before[0]),
                    (t0[1]["mom"], want_o["mom"], before[1]["mom"])):
        g, w, b = _leafs(g), _leafs(w), _leafs(b)
        assert set(g) == set(w)
        rels += [(_rel(g[k] - b[k], w[k] - b[k]), k) for k in w]
    assert max(rels)[0] <= 1e-3, max(rels)
    gs, ws = _leafs(t0[2]), _leafs(want_s)
    assert set(gs) == set(ws)
    for k in ws:
        np.testing.assert_array_equal(gs[k], ws[k], err_msg=str(k))


# -- synthetic_mlp through main.run ------------------------------------------------

#: a round line: its round and its metric fields; the step-time probe's
#: timings (``data_ms`` .. ``bound``) at its end differ run to run
ROUND_RE = re.compile(r"^round +(\d+):\[\d+ sec\](.*?)(?:\tdata_ms:.*)?$")


def _mlp_text():
    text = open(os.path.join(REPO, "examples", "synthetic_mlp.conf")).read()
    assert "num_inst = 512" in text and "num_inst = 256" in text
    return text.replace("num_inst = 512", "num_inst = 504") \
        .replace("num_inst = 256", "num_inst = 250")


@pytest.fixture(scope="module")
def mlp_runs(tmp_path_factory):
    """{"single"|"dp": (round lines, model dir)}: the config trained
    two rounds by ``main.run`` on one device and on two CPU ranks, each
    in a fresh process whose output (the ranks' too) is read."""
    tmp = tmp_path_factory.mktemp("mlp")
    conf = tmp / "mlp.conf"
    conf.write_text(_mlp_text())
    out = {}
    for kind in ("single", "dp"):
        d = str(tmp / kind)
        code = ("from cxxnet_tpu_torch.main import run\n"
                "from cxxnet_tpu_torch.config import (parse_config_file,\n"
                "    parse_cli_overrides)\n"
                "if __name__ == '__main__':\n"
                "    run(parse_config_file(%r) + parse_cli_overrides(\n"
                "        ['model_dir=%s', 'num_round=2'])%s)\n"
                % (str(conf), d, ", devices=('cpu', 'cpu')"
                   if kind == "dp" else ""))
        r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                           text=True, timeout=120, cwd=REPO)
        assert r.returncode == 0, r.stderr[-3000:]
        out[kind] = ([m.group(1, 2) for m in map(ROUND_RE.match,
                                                 r.stdout.splitlines())
                      if m], d)
    return out


def test_mlp_padded_tail_falls_on_rank_1():
    g, sections = split_sections(parse_config_string(_mlp_text()))
    data = [p for kind, _, p in sections if kind == "data"][0]
    batches = list(create_iterator(g + data))
    last = batches[-1]
    assert last.batch_size == 64 and last.num_batch_padd == 8
    dp1 = DpContext(rank=1, world=2, device=torch.device("cpu"))
    tr = Trainer(g, dp=DpContext(rank=0, world=2,
                                 device=torch.device("cpu")))
    assert tr._rows(last) == (slice(0, 32), 32)
    tr.dp = dp1
    assert tr._rows(last) == (slice(32, 64), 24)
    assert tr._mask(last).tolist() == [1.0] * 24 + [0.0] * 8


def test_mlp_dp_round_lines_and_metrics_equal_single_device(mlp_runs):
    single, dp = mlp_runs["single"][0], mlp_runs["dp"][0]
    assert [r for r, _ in dp] == ["0", "1"]
    assert dp == single
    assert "train-error" in dp[0][1] and "test-error" in dp[0][1]


def test_mlp_dp_round_loads_in_the_jax_package(mlp_runs):
    path = os.path.join(mlp_runs["dp"][1], "0001.model")
    want = jax_ckpt.load_model(os.path.join(mlp_runs["single"][1],
                                            "0001.model"))
    blob = jax_ckpt.load_model(path)
    assert blob["meta"]["has_opt"] and blob["meta"]["round"] == 1
    assert blob["meta"]["epoch"] == want["meta"]["epoch"] == 16
    assert sorted(os.listdir(mlp_runs["dp"][1])) == ["0000.model",
                                                      "0001.model"]
    for tree in ("params", "state"):
        g, w = _leafs(blob[tree]), _leafs(want[tree])
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], atol=1e-5, err_msg=str(k))
    g, w = _leafs(blob["opt"]["mom"]), _leafs(want["opt"]["mom"])
    for k in w:
        np.testing.assert_allclose(g[k], w[k], atol=1e-5, err_msg=str(k))


# -- refusals -------------------------------------------------------------------------

def _fake_dp(rank=0):
    """A rank's context without a process group: enough for what raises
    before the first collective."""
    return DpContext(rank=rank, world=2, device=torch.device("cpu"))


def test_batch_size_not_divisible_by_the_ranks_raises():
    cfg = parse_config_string(IBN_TEXT + HYPER.format(fused="auto")
                              + "batch_size = 15\n")
    with pytest.raises(ValueError, match="not divisible by data-parallel "
                                         "degree 2"):
        Trainer(cfg, dp=_fake_dp())


def test_bn_two_pass_under_dp_raises():
    cfg = parse_config_string(IBN_TEXT + HYPER.format(fused="auto")
                              + "bn_two_pass = 1\n")
    tr = Trainer(cfg, dp=_fake_dp())
    tr.init_model(_weights())
    with pytest.raises(ConfigError, match="Queue A 5, still queued: "
                                          "two-pass moments across ranks"):
        tr.update(_batch())


@pytest.mark.parametrize("key,val", [("dist_coordinator", "10.0.0.1:1234"),
                                     ("dist_num_proc", "2"),
                                     ("dist_rank", "1")])
def test_multi_host_keys_raise(key, val):
    cfg = parse_config_string(IBN_TEXT + HYPER.format(fused="auto")
                              + f"{key} = {val}\n")
    with pytest.raises(ConfigError, match="Queue A 5, still queued: "
                                          "multi-host launch"):
        Trainer(cfg)


def test_serve_on_several_cards_names_the_fleet(monkeypatch):
    from cxxnet_tpu_torch.device import resolve_device, resolve_devices
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_devices("gpu:0-1") == [torch.device("cuda", 0),
                                          torch.device("cuda", 1)]
    assert resolve_devices("gpu:0,2") == [torch.device("cuda", 0),
                                          torch.device("cuda", 2)]
    with pytest.raises(ConfigError,
                       match="Queue A 4: replicas over several cards"):
        resolve_device("gpu:0-1")


def test_a_rank_that_raises_fails_the_run_within_its_timeout():
    from torch.multiprocessing import ProcessRaisedException
    t0 = time.monotonic()
    with pytest.raises(ProcessRaisedException,
                       match="rank 1 fails on purpose"):
        launch(torch_dp_fixture.raising_rank, devices=CPU2, timeout_s=30,
               deadline_s=60)
    assert time.monotonic() - t0 < 60


def test_the_rank_that_failed_first_is_raised_when_another_exits_first(
        tmp_path):
    # rank 0 raises after rank 1 and its process ends first, so the first
    # exit that the launcher sees is not the first failure
    from torch.multiprocessing import ProcessRaisedException
    with pytest.raises(ProcessRaisedException,
                       match="rank 1 fails first") as err:
        launch(torch_dp_fixture.second_failure_exits_first_rank,
               args=(str(tmp_path),), devices=CPU2, timeout_s=30,
               deadline_s=60)
    assert err.value.error_index == 1
    assert "rank 0 fails second" not in str(err.value)


def test_launch_refuses_one_device_and_nccl_on_a_shared_card():
    with pytest.raises(ValueError, match="two or more"):
        launch(torch_dp_fixture.raising_rank, devices=("cpu",))
    with pytest.raises(ValueError, match="one card per rank"):
        launch(torch_dp_fixture.raising_rank, devices=("cuda:0", "cuda:0"),
               backend="nccl")
