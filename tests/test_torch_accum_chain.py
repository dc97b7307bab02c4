"""The port's gradient accumulation (``update_period``) and chained
steps (``train_chain``, ``Trainer.update_chain_batches``) against the
JAX package's and against the port's own sequential steps.

The small net of ``test_torch_train.py`` from the JAX package's weights,
SGD (eta 0.1, momentum 0.9, wd 1e-4), batch 16, through both packages'
trainers (``torch_mp_fixture``):

* ``update_period = 2``: a mid-period step leaves every master and
  moment bit for bit as it was, the accumulator (float32, the masters'
  layout) holds the step's gradients, ``epoch_counter`` advances once
  per period; the losses and train metrics are per step; each apply
  against the JAX package's: float32 losses within atol 1e-5 and masters
  and moments within atol 1e-5 (readings below 1e-7); under float16 the
  scaler's ``scale`` and ``good`` equal the JAX package's after every
  step, losses, masters and moments within atol 1e-2, and an overflow
  in the period's first step skips the apply at its end;
* chains equal sequential ``update()`` calls bit for bit on the CPU
  (losses, masters, moments, layer state, scaler, accumulator, counters
  and train metrics) in bfloat16 and float16, with and without
  ``update_period = 2``, the chains of 3 not aligned with the periods;
  their float32 losses and masters against the JAX package's
  ``update_chain_batches`` within atol 1e-5;
* ``main.run`` with ``train_chain = 4`` over 10 batches: two chains and
  a tail of two ``update()`` calls, the written round bit-equal to the
  run without chains, the progress line where the dispatched count
  crosses a multiple of ``print_step``;
* two gloo ranks on the CPU (``torch_dp_fixture``) with ``update_period
  = 2``, in float32 and float16: the replicas bit-equal, their losses and
  masters against the single-device run within atol 1e-5 (float32; the
  two halves' gradients summed in another order) and 1e-2 (float16),
  the scaler equal; in float16 the same four steps as a chain of 3 and
  one step bit-equal to them;
* the three keys no longer refused.
"""

import re

import numpy as np
import pytest

from cxxnet_tpu_torch import checkpoint as ckpt
from cxxnet_tpu_torch import main as port_main
from cxxnet_tpu_torch.config import parse_config_string
from cxxnet_tpu_torch.parallel import launch
from cxxnet_tpu_torch.trainer import Trainer

import torch_dp_fixture
from test_torch_train import SYNTH, _cfg, _small_weights
from torch_mp_fixture import (assert_same_bits, batches, flat, jax_batch,
                              jax_trainer, jax_trees, planted, port_trainer,
                              port_trees, scaler, text)

F32_ATOL = 1e-5
FP16_ATOL = 1e-2
PERIOD = "update_period = 2\n"
METRIC = "metric = error\n"


def _grads(tr, b):
    _, _, _, g = tr.gradients(b)
    return flat(g)


@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_update_period_applies_like_jax(dtype):
    cfg = text(dtype, "auto", PERIOD + METRIC)
    j, p = jax_trainer(cfg), port_trainer(cfg)
    atol = F32_ATOL if dtype == "float32" else FP16_ATOL
    for i, b in enumerate(batches()[:4]):
        before = port_trees(p)
        want_acc = None
        if i % 2 == 0:
            want_acc = _grads(p, b)
        j.update(jax_batch(b))
        p.update(b)
        np.testing.assert_allclose(p.last_loss, float(j._last_loss),
                                   atol=atol)
        assert scaler(p) == scaler(j)
        assert (p.sample_counter, p.epoch_counter) \
            == (j.sample_counter, j.epoch_counter) == ((i + 1) % 2,
                                                       (i + 1) // 2)
        acc = flat(p.accum)
        assert all(v.dtype == np.float32 for v in acc.values())
        if i % 2 == 0:               # mid-period: nothing applied
            assert_same_bits(port_trees(p)[0], before[0], "params")
            assert_same_bits(port_trees(p)[1], before[1], "optimizer state")
            for k, v in want_acc.items():
                np.testing.assert_array_equal(acc[k], v, err_msg=str(k))
            continue
        assert all(not v.any() for v in acc.values())
        (gp, go, gs), (wp, wo, ws) = port_trees(p), jax_trees(j)
        for got, want in ((gp, wp), (go["mom"], wo["mom"]), (gs, ws)):
            got, want = flat(got), flat(want)
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], atol=atol,
                                           err_msg=str(k))
    assert p.train_metric_report() == j.train_metric_report()


def test_fp16_overflow_in_a_period_skips_its_apply_like_jax():
    cfg = text("float16", "auto", PERIOD)
    j, p = jax_trainer(cfg), port_trainer(cfg)
    b0, b1, b2, b3 = batches()[:4]
    before = port_trees(p)
    for b in (planted(b0), b1):
        j.update(jax_batch(b))
        p.update(b)
    assert scaler(p) == scaler(j) == (2.0 ** 14, 0)
    assert_same_bits(port_trees(p)[0], before[0], "params")
    assert_same_bits(port_trees(p)[1]["mom"], before[1]["mom"], "momenta")
    assert all(not v.any() for v in flat(p.accum).values())
    assert p.epoch_counter == j.epoch_counter == 1
    for b in (b2, b3):
        j.update(jax_batch(b))
        p.update(b)
        np.testing.assert_allclose(p.last_loss, float(j._last_loss),
                                   atol=FP16_ATOL)
    assert scaler(p) == scaler(j) == (2.0 ** 14, 1)
    got, want = flat(port_trees(p)[0]), flat(jax_trees(j)[0])
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=FP16_ATOL)


def _counters(tr):
    return (tr.step_count, tr.sample_counter, tr.epoch_counter)


@pytest.mark.parametrize("extra", ["", PERIOD], ids=["period1", "period2"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_chains_equal_sequential_updates_bit_for_bit(dtype, extra):
    cfg = text(dtype, "auto", extra + METRIC)
    seq, chn = port_trainer(cfg), port_trainer(cfg)
    bs = batches()
    want = []
    for b in bs:
        seq.update(b)
        want.append(seq.last_loss)
    got = []
    for chain in (bs[:3], bs[3:]):
        losses = chn.update_chain_batches(list(chain))
        assert losses.shape == (len(chain),)
        got += losses.tolist()
    assert got == want
    assert_same_bits(port_trees(chn), port_trees(seq), "trees")
    assert _counters(chn) == _counters(seq) == (5, 1 if extra else 0,
                                                2 if extra else 5)
    if extra:
        assert_same_bits(chn.accum, seq.accum, "accumulator")
    assert chn.train_metric_report() == seq.train_metric_report()


@pytest.mark.parametrize("extra", ["", PERIOD], ids=["period1", "period2"])
def test_chain_losses_match_the_jax_chains(extra):
    cfg = text("float32", "auto", extra)
    j, p = jax_trainer(cfg), port_trainer(cfg)
    bs = batches()
    want, got = [], []
    for chain in (bs[:3], bs[3:]):
        want += np.asarray(j.update_chain_batches(
            [jax_batch(b) for b in chain])).tolist()
        got += p.update_chain_batches(list(chain)).tolist()
    np.testing.assert_allclose(got, want, atol=F32_ATOL)
    assert _counters(p)[1:] == (j.sample_counter, j.epoch_counter)
    gp, wp = flat(port_trees(p)[0]), flat(jax_trees(j)[0])
    for k in wp:
        np.testing.assert_allclose(gp[k], wp[k], atol=F32_ATOL)


PROGRESS_RE = re.compile(r"^round\s+0:\[\s*(\d+)\] ")


def test_main_chain_loop_runs_the_tail_and_matches_sequential(tmp_path,
                                                              capsys):
    rounds, printed = {}, {}
    for chain in (4, 0):
        model_dir = tmp_path / f"chain{chain}"
        conf = tmp_path / f"chain{chain}.conf"
        conf.write_text(text("bfloat16", "auto", METRIC)
                        + "data = train\n"
                        + SYNTH.format(n=160, seed=3, shape="3,16,16")
                        + f"train_chain = {chain}\nprint_step = 3\n"
                        "num_round = 1\n")
        assert port_main.main([str(conf), f"model_dir={model_dir}"]) == 0
        out = capsys.readouterr().out.splitlines()
        printed[chain] = [int(PROGRESS_RE.match(ln).group(1))
                          for ln in out if PROGRESS_RE.match(ln)]
        rounds[chain] = ckpt.load_model(ckpt.model_path(str(model_dir), 0))
    assert printed == {4: [4, 8], 0: [3, 6, 9]}
    assert rounds[4]["meta"]["step_count"] == 10
    assert rounds[4]["meta"]["epoch"] == rounds[0]["meta"]["epoch"] == 10
    for what in ("params", "state", "opt"):
        assert_same_bits(rounds[4][what], rounds[0][what], what)


def _dp_run(cfg_text, bs, chain=0):
    return launch(torch_dp_fixture.train_step_rank,
                  (cfg_text, _small_weights(), list(bs), chain),
                  devices=("cpu", "cpu"), timeout_s=120, deadline_s=240)


@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_dp_update_period_keeps_replicas_equal_and_matches_one_device(
        dtype):
    cfg = text(dtype, "auto", PERIOD)
    bs = batches()[:4]
    (l0, t0), (l1, t1) = _dp_run(cfg, bs)
    assert l0 == l1
    assert_same_bits(t0, t1, "replicas")
    if dtype == "float16":            # chains of 3 on the ranks: the same
        (c0, u0), (c1, u1) = _dp_run(cfg, batches()[:3] + bs[3:], chain=3)
        assert c0 == c1 == l0
        assert_same_bits(u0, t0, "chained replica")
        assert_same_bits(u1, t0, "chained replica")
    one = port_trainer(cfg)
    want = []
    for b in bs:
        one.update(b)
        want.append(one.last_loss)
    atol = F32_ATOL if dtype == "float32" else FP16_ATOL
    np.testing.assert_allclose(l0, want, atol=atol)
    if dtype == "float16":
        assert (float(t0[1]["_mp"]["scale"]), int(t0[1]["_mp"]["good"])) \
            == scaler(one)
    got, ref = flat(t0[0]), flat(port_trees(one)[0])
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], atol=atol, err_msg=str(k))


@pytest.mark.parametrize("key,val", [("compute_dtype", "float16"),
                                     ("update_period", "2"),
                                     ("train_chain", "4")])
def test_the_rest_of_training_keys_train(key, val):
    """The three keys of ROADMAP Queue A 3 build a trainer that trains
    (they raised ConfigError before the port ran them)."""
    tr = Trainer(parse_config_string(_cfg("small", "float32", "auto")
                                     + f"{key} = {val}\n"))
    tr.init_model(_small_weights())
    tr.update(batches()[0])
    assert np.isfinite(tr.last_loss)
    assert (tr.optimizer.fp16, tr.update_period) == (
        key == "compute_dtype", 2 if key == "update_period" else 1)
