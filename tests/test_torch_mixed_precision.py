"""The port's float16 training (``compute_dtype = float16``: the
dynamic loss scaler) against the JAX package's.

The small net of ``test_torch_train.py`` (every training layer kind)
from the JAX package's weights, through both packages' ``Trainer.update``
on the same seeded batches (``torch_mp_fixture``; the JAX steps compiled
with excess precision off), SGD (eta 0.1, momentum 0.9, wd 1e-4) and Adam
(eta 1e-3), with the kernels' plain versions and with ``fused_kernels =
0``:

* the scaler's ``scale`` and ``good`` equal the JAX package's after every
  step; the losses within atol 1e-2 and, after four free-running steps,
  every master and moment within atol 1e-2 (the bf16 bound of
  ``test_torch_train.py``; readings up to 4.9e-3 and 3.7e-3: the two
  packages sum in other orders and the net's batch_norm layers carry
  the difference forward);
* a planted overflow (inputs of 1e8, past float16's 65504) skips the
  apply in both packages: masters, moments and Adam's ``t`` bit for bit
  as they were, the scale halved, ``good`` 0; the next clean batch
  applies, the masters finite;
* the scale doubles after ``loss_scale_window`` clean applies, stays at
  ``loss_scale_max`` and at ``loss_scale_min``, as in the JAX package;
* rounds carry the scaler as ``opt/_mp/scale`` and ``opt/_mp/good``: a
  port round resumes in the JAX package and a JAX round in the port with
  the scaler, masters and moments bit-exact, and the next step agrees;
  a bfloat16 round resumed under float16 gets a fresh scaler and a
  float16 round resumed under bfloat16 drops it, the masters and moments
  bit-exact either way;
* the SGD, NAG and Adam applies and their plain versions with the skip
  flag set leave every bit as it was, and with it clear compute what
  they compute without it.
"""

import numpy as np
import pytest
import torch

from cxxnet_tpu import checkpoint as jax_ckpt
from cxxnet_tpu_torch import checkpoint as ckpt
from cxxnet_tpu_torch.ops.fused_optim import (adam_apply_plain,
                                              fused_adam_apply,
                                              fused_sgd_apply, sgd_apply_plain)

from test_torch_train import HYPER
from test_torch_train import _batches as _train_batches
from torch_ibn_fixture import IBN_TEXT, jax_weights
from torch_mp_fixture import (ADAM, assert_same_bits, batches, flat,
                              jax_batch, jax_trainer, jax_trees, planted,
                              port_trainer, port_trees, scaler, text)


def ibn_batches():
    """The narrow Inception-BN's three seeded batches of 16."""
    return list(_train_batches("ibn"))

#: loss, and masters and moments after four steps (readings 4.9e-3, 3.7e-3)
FP16_ATOL = 1e-2
UPDATERS = {"sgd": "", "adam": ADAM}


def _both(cfg_text):
    return jax_trainer(cfg_text), port_trainer(cfg_text)


def _step(j, p, b):
    j.update(jax_batch(b))
    p.update(b)
    return float(j._last_loss), p.last_loss


@pytest.mark.parametrize("fused", ["auto", "0"])
@pytest.mark.parametrize("updater", sorted(UPDATERS))
def test_fp16_steps_and_scaler_match_jax(updater, fused):
    j, p = _both(text("float16", fused, UPDATERS[updater]))
    assert scaler(p) == scaler(j) == (2.0 ** 15, 0)
    for i, b in enumerate(batches()[:4]):
        want, got = _step(j, p, b)
        assert scaler(p) == scaler(j) == (2.0 ** 15, i + 1)
        np.testing.assert_allclose(got, want, atol=FP16_ATOL)
    (gp, go, _), (wp, wo, _) = port_trees(p), jax_trees(j)
    for got, want in ((flat(gp), flat(wp)),
                      (flat({k: v for k, v in go.items() if k != "_mp"}),
                       flat({k: v for k, v in wo.items() if k != "_mp"}))):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=FP16_ATOL,
                                       err_msg=str(k))
    for _, v in flat(gp).items():
        assert v.dtype == np.float32


@pytest.mark.parametrize("fused", ["auto", "0"])
@pytest.mark.parametrize("updater", sorted(UPDATERS))
def test_planted_overflow_skips_the_apply_like_jax(updater, fused):
    j, p = _both(text("float16", fused, UPDATERS[updater]))
    b0, b1 = batches()[:2]
    _step(j, p, b0)
    before_p, before_j = port_trees(p), jax_trees(j)
    _, loss = _step(j, p, planted(b0))
    assert not np.isfinite(loss)
    assert scaler(p) == scaler(j) == (2.0 ** 14, 0)
    for got, before in ((port_trees(p), before_p), (jax_trees(j), before_j)):
        assert_same_bits(got[0], before[0], "params")
        assert_same_bits({k: v for k, v in got[1].items() if k != "_mp"},
                         {k: v for k, v in before[1].items() if k != "_mp"},
                         "optimizer state")
    if updater == "adam":
        assert int(p.opt_state["t"]) == int(j.opt_state["t"]) == 1
    want, got = _step(j, p, b1)
    np.testing.assert_allclose(got, want, atol=FP16_ATOL)
    assert scaler(p) == scaler(j) == (2.0 ** 14, 1)
    after = flat(port_trees(p)[0])
    assert all(np.isfinite(v).all() for v in after.values())
    assert any(not np.array_equal(after[k], v)
               for k, v in flat(before_p[0]).items())


@pytest.mark.parametrize("extra,plant", [
    ("loss_scale_window = 2\n", ()),
    ("loss_scale_window = 1\nloss_scale_max = 65536\n", ()),
    ("loss_scale_init = 4\nloss_scale_min = 2\n", (1, 2, 3)),
], ids=["window", "cap", "floor"])
def test_scale_grows_caps_and_floors_like_jax(extra, plant):
    j, p = _both(text("float16", "auto", extra))
    seen = []
    for i, b in enumerate(batches()[:5]):
        _step(j, p, planted(b) if i in plant else b)
        assert scaler(p) == scaler(j)
        seen.append(scaler(p))
    want = {"window": [(2.0 ** 15, 1), (2.0 ** 16, 0), (2.0 ** 16, 1),
                       (2.0 ** 17, 0), (2.0 ** 17, 1)],
            "cap": [(2.0 ** 16, 0)] * 5,
            "floor": [(4.0, 1), (2.0, 0), (2.0, 0), (2.0, 0), (2.0, 1)]}
    assert seen == want[("window" if "window = 2" in extra else
                         "cap" if "max" in extra else "floor")]


def test_narrow_inception_bn_skips_and_halves_like_jax():
    """The narrow Inception-BN of ``torch_ibn_fixture`` (69 batch_norm
    layers) from the JAX package's weights: its float16 gradients
    overflow at the first scales, as a deep batch-norm net's do at init.
    Over 8 steps the scale and ``good`` equal the JAX package's after
    every step (6 applies skipped, from 2^15 down to 2^9, then 2
    applied), the masters bit-unchanged through the skips, the losses
    within atol 1e-2 while both packages step from the same weights
    (steps 1-7: after an apply the net's gradient chaos at init parts
    the two trajectories, see ``test_torch_train.py``)."""
    cfg = IBN_TEXT + HYPER.format(dtype="float16", fused="0")
    j = jax_trainer(cfg, jax_weights)
    p = port_trainer(cfg, jax_weights)
    init = port_trees(p)[0]
    bs = ibn_batches()
    seen = []
    for b in bs + bs + bs[:2]:
        same_weights = not seen or seen[-1][1] == 0
        want, got = _step(j, p, b)
        if same_weights:
            np.testing.assert_allclose(got, want, atol=FP16_ATOL)
        assert scaler(p) == scaler(j)
        seen.append(scaler(p))
        if scaler(p)[1] == 0:
            assert_same_bits(port_trees(p)[0], init, "params")
    assert seen == [(2.0 ** (14 - i), 0) for i in range(6)] + [
        (2.0 ** 9, 1), (2.0 ** 9, 2)]


def _round_trees(path):
    blob = jax_ckpt.load_model(path)
    return blob["params"], blob["opt"], blob["state"]


def test_port_fp16_round_resumes_in_jax(tmp_path):
    cfg = text("float16", "auto")
    p = port_trainer(cfg)
    b0, b1, b2 = batches()[:3]
    p.update(b0)
    p.update(planted(b1))
    path = str(tmp_path / "0000.model")
    p.save_model(path)
    params, opt, state = _round_trees(path)
    assert float(opt["_mp"]["scale"]) == 2.0 ** 14
    assert int(opt["_mp"]["good"]) == 0
    assert np.asarray(opt["_mp"]["good"]).dtype == np.int32
    j = jax_trainer(cfg)
    j.load_model(path)
    assert scaler(j) == scaler(p)
    assert_same_bits(jax_trees(j)[0], port_trees(p)[0], "params")
    assert_same_bits(jax_trees(j)[1], port_trees(p)[1], "optimizer state")
    want, got = _step(j, p, b2)
    np.testing.assert_allclose(got, want, atol=FP16_ATOL)
    assert scaler(p) == scaler(j) == (2.0 ** 14, 1)


def test_jax_fp16_round_resumes_in_the_port(tmp_path):
    cfg = text("float16", "auto")
    j = jax_trainer(cfg)
    b0, b1, b2 = batches()[:3]
    j.update(jax_batch(b0))
    j.update(jax_batch(planted(b1)))
    path = str(tmp_path / "0000.model")
    j.save_model(path)
    p = port_trainer(cfg)
    p.load_model(path)
    assert scaler(p) == scaler(j) == (2.0 ** 14, 0)
    assert p.opt_state["_mp"]["scale"].dtype == torch.float32
    assert p.opt_state["_mp"]["good"].dtype == torch.int32
    assert_same_bits(port_trees(p)[0], jax_trees(j)[0], "params")
    assert_same_bits(port_trees(p)[1], jax_trees(j)[1], "optimizer state")
    want, got = _step(j, p, b2)
    np.testing.assert_allclose(got, want, atol=FP16_ATOL)
    assert scaler(p) == scaler(j)


@pytest.mark.parametrize("src,dst", [("bfloat16", "float16"),
                                     ("float16", "bfloat16"),
                                     ("float16", "float32")])
@pytest.mark.parametrize("updater", sorted(UPDATERS))
def test_rounds_adapt_to_the_policy_bit_exact(tmp_path, src, dst, updater):
    p = port_trainer(text(src, "auto", UPDATERS[updater]))
    b0, b1 = batches()[:2]
    p.update(b0)
    if src == "float16":
        p.update(planted(b1))           # a scale the fresh one is not
    path = str(tmp_path / "0000.model")
    p.save_model(path)
    q = port_trainer(text(dst, "auto", UPDATERS[updater]))
    q.load_model(path)
    assert scaler(q) == ((2.0 ** 15, 0) if dst == "float16" else None)
    saved = _round_trees(path)
    assert_same_bits(port_trees(q)[0], saved[0], "params")
    assert_same_bits({k: v for k, v in port_trees(q)[1].items()
                      if k != "_mp"},
                     {k: v for k, v in saved[1].items() if k != "_mp"},
                     "optimizer state")
    q.update(b1)
    assert np.isfinite(q.last_loss)
    again = str(tmp_path / "0001.model")
    q.save_model(again)
    keys = set(ckpt.load_model(again)["opt"])
    assert ("_mp" in keys) == (dst == "float16")


@pytest.mark.parametrize("flag", [0, 1])
@pytest.mark.parametrize("kind", ["sgd", "nag", "adam"])
def test_apply_wrappers_and_plain_versions_take_the_skip_flag(kind, flag):
    """On the CPU the wrappers compute the plain versions: with the flag
    set every leaf and moment keeps its bits; clear, the result equals
    the apply without a flag."""
    gen = torch.Generator().manual_seed(0)
    shapes = [(16, 3, 3, 3), (16,), (1000,), (1,)]
    mk = lambda s: torch.randn(s, generator=gen)
    ws = [mk(s) for s in shapes]
    gs = [mk(s) for s in shapes]
    gs[0].view(-1)[::7] = float("inf")
    gs[2].view(-1)[::5] = float("nan")
    ms = [mk(s).abs() * 0.1 for s in shapes]
    m2 = [mk(s).abs() * 0.1 for s in shapes]
    skip = torch.tensor(flag, dtype=torch.int32)
    before = [t.clone() for t in ws + ms + m2]
    if kind == "adam":
        free = sum(adam_apply_plain(ws, gs, ms, m2, 3e-4, 0.1, 0.001, 1e-4,
                                    0.5), [])
        plain = sum(adam_apply_plain(ws, gs, ms, m2, 3e-4, 0.1, 0.001, 1e-4,
                                     0.5, skip), [])
        fused_adam_apply(ws, gs, ms, m2, 3e-4, d1=0.1, d2=0.001, wd=1e-4,
                         clip=0.5, skip=skip)
        got = ws + ms + m2
    else:
        nag = kind == "nag"
        free = sum(sgd_apply_plain(ws, gs, ms, 0.1, 0.9, 1e-4, 0.0, nag), [])
        plain = sum(sgd_apply_plain(ws, gs, ms, 0.1, 0.9, 1e-4, 0.0, nag,
                                    skip), [])
        fused_sgd_apply(ws, gs, ms, 0.1, 0.9, wd=1e-4, clip=0.0, nag=nag,
                        skip=skip)
        got = ws + ms
    for i, (a, b, c) in enumerate(zip(got, plain, free)):
        want = before[i] if flag else c
        np.testing.assert_array_equal(a.numpy(), want.numpy())
        np.testing.assert_array_equal(b.numpy(), want.numpy())


def test_the_skip_flag_must_be_one_int32_on_the_leaves_device():
    w, g, m = torch.zeros(4), torch.zeros(4), torch.zeros(4)
    for bad in (torch.tensor(1.0), torch.zeros(2, dtype=torch.int32)):
        with pytest.raises(ValueError, match="skip flag"):
            fused_sgd_apply([w], [g], [m], 0.1, 0.9, wd=0.0, clip=0.0,
                            nag=False, skip=bad)
        with pytest.raises(ValueError, match="skip flag"):
            fused_adam_apply([w], [g], [m], [m.clone()], 1e-3, d1=0.1,
                             d2=0.001, wd=0.0, clip=0.0, skip=bad)
