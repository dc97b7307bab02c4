"""The port's uint8 input fold against the JAX package's.

A ``device_normalize`` batch (uint8 with its ``norm``: a mean image and
``divideby = 255`` here) goes through the port's ``Trainer``, which
normalizes it at the head of the step (``ops/fused_stem``'s plain
version on the CPU), and through the JAX package's train step, which
folds it in-trace through its Pallas stem kernel in interpret mode
(``pallas_call`` asserted in the step's jaxpr; every other layer with
``fused_kernels = 0``), on the narrow Inception-BN of
``torch_ibn_fixture`` with the JAX package's weights.

* The network's input under the fold is bit-equal to the JAX fold's, in
  float32 and in bfloat16.
* Steps 1-3, each from the JAX package's state after the step before,
  with ``test_torch_train``'s step tolerances (float32: loss rtol 1e-4,
  update 0.15 per leaf and 0.05 in the median, statistics 1e-3;
  bfloat16: loss rtol 1e-2, update 2.5 and 1.0, statistics 3e-2). On
  these inputs the bfloat16 gradient stays rounding-dominated through
  step 3 (the JAX package's own bf16 step differs from its f32 step
  from the same state by a median over leaves of 0.89, 0.42 and 0.32 at
  steps 1-3; on ``test_torch_train``'s synthetic batches it is 0.03 by
  step 3), so each bfloat16 step holds the ratio of the norms of a
  leaf's gradient part, port / JAX, within [1/3, 3], and the median
  over leaves of their relative L2 difference at most that yardstick,
  measured in the same test (readings 0.15 against 0.32 at step 3).
  Each layer's bf16 backward is held from the same inputs by
  ``test_torch_train``; the fold changes only the input, which is
  bit-equal.
* The fold is bit-equal to ``input_fold = 0`` under a float32 policy (as
  ``tests/test_fused_stem_pool.py`` holds it for the JAX package), and
  evaluation, which always normalizes eagerly, is unchanged by it.
* Two CPU ranks fold their own rows: a data-parallel step against the
  single-device step from the same state (the float32 tolerances).
* ``main.run`` of a narrow imgrec config trains a round from PNG
  records, and the JAX package loads it.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cxxnet_tpu.config import parse_config_string as jax_parse
from cxxnet_tpu.ops import fused_stem as jax_stem
from cxxnet_tpu.trainer import Trainer as JaxTrainer
from cxxnet_tpu.trainer import _fold_input
from cxxnet_tpu_torch.config import ConfigError, parse_config_string
from cxxnet_tpu_torch.io.data import DataBatch
from cxxnet_tpu_torch.trainer import Trainer

import torch_dp_fixture
from test_torch_train import (_cfg, _check_step, _grad_parts, _jax_place,
                              _jax_snap, _port_snap, _rel)
from torch_ibn_fixture import BATCH, IBN_TEXT, IMAGE, jax_weights
from torch_imgrec_fixture import image, png_bytes, write_records

STEPS = 3
RNG = np.random.RandomState(17)
MEAN = (RNG.rand(*IMAGE) * 40 + 100).astype(np.float32)
NORM = {"mean": MEAN, "divideby": 255.0, "scale": 1.0}
FACTOR = np.float32(1.0 / 255.0)


def _u8_batches(n=STEPS, seed=5):
    rng = np.random.RandomState(seed)
    return [DataBatch(data=rng.randint(0, 256, (BATCH,) + IMAGE)
                      .astype(np.uint8),
                      label=rng.randint(0, 10, (BATCH, 1)).astype(np.float32),
                      norm=dict(NORM))
            for _ in range(n)]


BATCHES = _u8_batches()


def _stem_forced(x, mean, factor, out_dtype, fused=False, spmd=None):
    """The JAX dispatcher with the Pallas kernel forced on (interpret
    mode on the CPU), whatever the rest of the net's fused setting."""
    y = jax_stem.fused_decode_normalize(x, mean, factor, out_dtype,
                                        spmd=spmd)
    assert y is not None
    return y


def _jax_args(tr, batch, epoch):
    sched = {tag: (jnp.float32(lr), jnp.float32(m))
             for tag, (lr, m) in tr.optimizer.schedules(epoch).items()}
    data = (jnp.asarray(batch.data), jnp.asarray(MEAN), jnp.float32(FACTOR))
    return (tr.params, tr.opt_state, tr.net_state, {}, data,
            jnp.asarray(batch.label), jnp.ones((BATCH,), jnp.float32), (),
            jax.random.PRNGKey(0), sched)


@functools.lru_cache(maxsize=None)
def _jax_folded(dtype):
    """The JAX package's folded steps (losses, states before and after
    each) and the folded input of the first batch."""
    orig = jax_stem.decode_normalize
    jax_stem.decode_normalize = _stem_forced
    try:
        tr = JaxTrainer(jax_parse(_cfg("ibn", dtype, 0)))
        assert tr.input_fold
        tr.init_model()
        _jax_place(tr, *jax_weights())
        fn = tr._make_train_step(True)
        args = _jax_args(tr, BATCHES[0], 0)
        assert "pallas_call" in str(jax.make_jaxpr(fn)(*args))
        step = fn.lower(*args).compile(
            compiler_options={"xla_allow_excess_precision": False})
        folded = np.asarray(jax.jit(lambda d: _fold_input(d, tr.net))(
            args[4]).astype(jnp.float32))
    finally:
        jax_stem.decode_normalize = orig
    losses, snaps = [], [_jax_snap(tr)]
    for i, b in enumerate(BATCHES):
        losses.append(_jax_take(tr, step, b, i))
        snaps.append(_jax_snap(tr))
    return losses, snaps, folded, tr, step


def _jax_take(tr, step, batch, epoch):
    (tr.params, tr.opt_state, tr.net_state, _, loss, _, _) = step(
        *_jax_args(tr, batch, epoch))
    return float(loss)


def _median_grad_rel(got, want, before):
    g, w = _grad_parts(got, before), _grad_parts(want, before)
    return float(np.median([_rel(g[k], w[k]) for k in w]))


def _trainer(dtype, extra=""):
    tr = Trainer(parse_config_string(_cfg("ibn", dtype, "auto") + extra))
    tr.init_model(jax_weights())
    return tr


def _load(tr, snap, epoch):
    from cxxnet_tpu_torch import checkpoint as ckpt
    p, o, s = snap
    tr.load_blob({"meta": {"structure_sig": ckpt._sig_to_json(
        tr.graph.structure_signature()), "round": 0, "epoch": epoch},
        "params": p, "state": s, "opt": o})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_folded_input_is_bit_equal_to_the_jax_fold(dtype):
    want = _jax_folded(dtype)[2]
    tr = _trainer(dtype)
    got = tr._input(BATCHES[0], fold=True)
    assert got.dtype == tr.net.compute_dtype
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("step", range(1, STEPS + 1))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_folded_steps_match_the_jax_folded_steps(dtype, step):
    losses, snaps = _jax_folded(dtype)[:2]
    tr = _trainer(dtype)
    _load(tr, snaps[step - 1], step - 1)
    tr.update(BATCHES[step - 1])
    got = _port_snap(tr)
    if dtype == "float32":
        _check_step(dtype, step, tr.last_loss, losses[step - 1], got,
                    snaps[step - 1], snaps[step])
        return
    # bfloat16: the ratio checks of the rounding-dominated steps (given
    # as step 1), and the median against the bf16-vs-f32 yardstick
    _check_step(dtype, 1, tr.last_loss, losses[step - 1], got,
                snaps[step - 1], snaps[step])
    j32, step32 = _jax_folded("float32")[3:]
    p, o, st = snaps[step - 1]
    j32.params, j32.net_state, j32.opt_state = j32._place(p, st, o)
    _jax_take(j32, step32, BATCHES[step - 1], step - 1)
    yardstick = _median_grad_rel(snaps[step], _jax_snap(j32),
                                 snaps[step - 1])
    assert _median_grad_rel(got, snaps[step], snaps[step - 1]) <= yardstick


def test_the_fold_is_bit_equal_to_input_fold_0_in_float32():
    runs = []
    for fold in ("auto", "0"):
        tr = _trainer("float32", f"input_fold = {fold}\n")
        assert tr.input_fold == (fold == "auto")
        losses = []
        for b in BATCHES[:2]:
            tr.update(b)
            losses.append(tr.last_loss)
        runs.append((losses, _port_snap(tr)))
    (la, sa), (lb, sb) = runs
    assert la == lb
    for ta, tb in zip(sa, sb):
        for a, b in zip(jax.tree_util.tree_leaves(ta),
                        jax.tree_util.tree_leaves(tb)):
            np.testing.assert_array_equal(a, b)


def test_evaluation_is_unchanged_by_the_fold():
    """``evaluate`` normalizes a uint8 batch eagerly in f32, fold or not:
    the same metric as the same images normalized on the host."""
    host = [DataBatch(data=((b.data.astype(np.float32) - MEAN)
                            * (1.0 / 255.0)).astype(np.float32),
                      label=b.label) for b in BATCHES]
    out = []
    for fold, batches in (("auto", BATCHES), ("0", BATCHES), ("auto", host)):
        tr = _trainer("float32", f"input_fold = {fold}\nmetric = logloss\n")
        out.append(tr.evaluate(batches, "val"))
        x = tr._input(BATCHES[0], fold=False)
        assert x.dtype == torch.float32
    assert out[0] == out[1] == out[2] and "val-logloss" in out[0]


@pytest.mark.parametrize("val", ["auto", "1", "0", "on", "off"])
def test_input_fold_values(val):
    Trainer(parse_config_string(_cfg("ibn", "float32", "auto")
                                + f"input_fold = {val}\n"))


def test_a_bad_input_fold_value_raises():
    with pytest.raises(ConfigError, match="input_fold"):
        Trainer(parse_config_string(_cfg("ibn", "float32", "auto")
                                    + "input_fold = 2\n"))


def test_two_cpu_ranks_fold_their_rows_like_one_device():
    from cxxnet_tpu_torch.parallel import launch
    cfg = _cfg("ibn", "float32", "auto")
    tr = _trainer("float32")
    before = _port_snap(tr)
    tr.update(BATCHES[0])
    want_loss, after = tr.last_loss, _port_snap(tr)
    (l0, t0), (l1, t1) = launch(
        torch_dp_fixture.train_step_rank,
        (cfg, jax_weights(), BATCHES[:1]), devices=("cpu", "cpu"),
        deadline_s=240)
    assert l0 == l1
    for a, b in zip(jax.tree_util.tree_leaves(t0),
                    jax.tree_util.tree_leaves(t1)):
        np.testing.assert_array_equal(a, b)
    _check_step("float32", 1, l0[0], want_loss, t0, before, after)


def test_main_run_trains_an_imgrec_config_and_the_jax_package_loads_it(
        tmp_path, capsys):
    from cxxnet_tpu import checkpoint as jax_ckpt
    from cxxnet_tpu_torch import checkpoint as ckpt
    from cxxnet_tpu_torch.io import recordio
    from cxxnet_tpu_torch.main import run
    rng = np.random.RandomState(9)
    for name, n in (("train", 2 * BATCH), ("val", BATCH)):
        write_records(str(tmp_path / f"{name}.rec"),
                      [png_bytes(image(rng, 72, 70)) for _ in range(n)],
                      recordio.RecordWriter, recordio.ImageRecord)
    mean = str(tmp_path / "mean.bin")
    conf = (f"data = train\niter = imgrec\n"
            f"  image_rec = {tmp_path / 'train.rec'}\n"
            f"  image_mean = {mean}\n  rand_crop = 1\n  rand_mirror = 1\n"
            f"  shuffle = 1\n  decode_threads = 2\niter = threadbuffer\n"
            f"iter = end\neval = val\niter = imgrec\n"
            f"  image_rec = {tmp_path / 'val.rec'}\n"
            f"  image_mean = {mean}\niter = end\n"
            + _cfg("ibn", "float32", "auto")
            + f"num_round = 1\nmodel_dir = {tmp_path / 'm'}\n"
            "metric = error\ndivideby = 255\n")
    tr = run(parse_config_string(conf))
    out = capsys.readouterr().out
    assert "device_normalize auto-resolved to 1" in out
    assert "val-error:" in out and "train-error:" in out
    assert os.path.exists(mean + ".npy")
    assert tr.step_count == 2 and np.isfinite(tr.last_loss)
    path = ckpt.model_path(str(tmp_path / "m"), 0)
    blob = jax_ckpt.load_model(path)
    assert blob["meta"]["round"] == 0
    want = set(jax_weights()[0])
    assert set(blob["params"]) == want
