"""AlexNet, the SPP net of ``kaiming.conf`` and the digits LeNet through
the port, against the JAX package, on the CPU.

* The ``mnist`` iterator: batches bit-equal to
  ``cxxnet_tpu.io.iter_mnist``'s, gzipped or plain, flat or image,
  shuffled over two epochs, with the padded (or, with ``round_batch``,
  wrapped) tail.
* The narrow nets of ``torch_convnet_fixture`` (widths / 8; AlexNet at
  3x99x99, so that its flatten is 2x2xC and batch 16 puts both LRN layers
  through the JAX gate; the SPP net at 3x125x125, so that conv5 is 15x15,
  spp1 tiles and spp4 fits), with the JAX package's weights carried in:
  - three float32 SGD steps with every dropout threshold 0 and every
    insanity layer at lb = ub (the deterministic cases of the same
    code), freely in both packages from the same weights: loss per step
    atol 1e-5 (readings 4.8e-7), every parameter and momentum leaf atol
    1e-5 (readings up to 3.0e-8), insanity's step counters equal;
  - one float32 training pass at the configs' own dropout 0.5 and
    insanity U[5, 10) with the JAX package's draws handed to the port
    (``JaxDraws``): loss rtol 1e-6 (readings up to 1.7e-7), each
    parameter gradient within a relative L2 difference of 1e-5
    (readings up to 1.1e-6); with the
    kernels selected the graph holds the LRN and pooling functions;
  - every layer in bfloat16: ``test_torch_convnets_layers.py``;
  - a round written by the port's ``main.main`` loads in the JAX package
    and resumes there with ``continue = 1``, insanity's counters
    included.
* ``examples/digits/digits_lenet.conf`` trains through ``main.main``
  with ``dev = cpu`` from idx files the test writes, printing the JAX
  package's round lines.
"""

import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cxxnet_tpu import main as jax_main
from cxxnet_tpu.graph import build_graph as jax_build_graph
from cxxnet_tpu.io.data import create_iterator as jax_create_iterator
from cxxnet_tpu.model import Network as JaxNetwork
from cxxnet_tpu.trainer import Trainer as JaxTrainer
from cxxnet_tpu_torch import main as port_main
from cxxnet_tpu_torch.convert import (opt_to_jax, params_from_jax,
                                      params_to_jax)
from cxxnet_tpu_torch.graph import build_graph
from cxxnet_tpu_torch.io import create_iterator
from cxxnet_tpu_torch.model import Network
from cxxnet_tpu_torch.optim import leaves, unflatten
from cxxnet_tpu_torch.trainer import Trainer

from torch_convnet_fixture import (BATCH, NARROW, jax_net_draws,
                                   narrow_pairs, synthetic_section,
                                   write_digits)
from torch_ibn_fixture import REPO, jax_run

NETS = sorted(NARROW)
STEPS = 3


# -- the mnist iterator -------------------------------------------------------

@pytest.mark.parametrize("gz", [True, False], ids=["gz", "plain"])
@pytest.mark.parametrize("flat,shuffle,round_batch", [
    (1, 0, 0), (0, 1, 0), (0, 1, 1), (1, 1, 1)])
def test_mnist_batches_are_bit_equal_to_the_jax_iterator(
        tmp_path, gz, flat, shuffle, round_batch):
    paths = write_digits(str(tmp_path), n_train=53, n_test=5, gz=gz)
    img, lab = paths["train"]
    pairs = [("batch_size", "16"), ("iter", "mnist"), ("path_img", img),
             ("path_label", lab), ("input_flat", str(flat)),
             ("shuffle", str(shuffle)), ("round_batch", str(round_batch)),
             ("seed_data", "4"), ("silent", "1"), ("iter", "end")]
    ours, ref = create_iterator(pairs), jax_create_iterator(pairs)
    for _ in range(2):                         # two epochs: reshuffled
        a_all, b_all = list(ours), list(ref)
        assert len(a_all) == len(b_all) == 4
        for a, b in zip(a_all, b_all):
            assert a.num_batch_padd == b.num_batch_padd
            assert a.data.dtype == b.data.dtype == np.float32
            np.testing.assert_array_equal(a.data, b.data)
            np.testing.assert_array_equal(a.label, b.label)
            np.testing.assert_array_equal(a.inst_index, b.inst_index)
        assert a_all[-1].num_batch_padd == 11
        assert a_all[0].data.shape == ((16, 1, 1, 64) if flat
                                       else (16, 8, 8, 1))


def test_mnist_remote_paths_name_roadmap_a2(tmp_path):
    """Remote mnist paths are read through the stream layer now (ROADMAP
    Queue A 2 brought them): a pair on fsspec's ``memory://`` gives the
    batches of the same files on disk."""
    import fsspec
    from cxxnet_tpu_torch.io import stream
    rs = np.random.RandomState(0)
    img = rs.randint(0, 256, (10, 4, 4)).astype(np.uint8)
    lab = rs.randint(0, 10, 10).astype(np.uint8)
    root = f"memory://convnets{os.getpid()}"
    cfgs = []
    for where in (root, str(tmp_path)):
        for name, arr, magic in (("x", img, 2051), ("y", lab, 2049)):
            raw = (np.int32(magic).byteswap().tobytes() + b"".join(
                np.int32(d).byteswap().tobytes() for d in arr.shape)
                + arr.tobytes())
            stream.write_bytes_atomic(f"{where}/{name}", raw)
        cfgs.append([("iter", "mnist"), ("path_img", f"{where}/x"),
                     ("path_label", f"{where}/y"), ("batch_size", "4"),
                     ("silent", "1"), ("iter", "end")])
    try:
        got, want = (list(create_iterator(c)) for c in cfgs)
    finally:
        fsspec.filesystem("memory").rm(root, recursive=True)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.data, b.data)
        np.testing.assert_array_equal(a.label, b.label)


# -- the narrow nets against the JAX trainer ----------------------------------

def _np_tree(t):
    return jax.tree_util.tree_map(lambda a: np.array(a), t)


@functools.lru_cache(maxsize=None)
def _jax_init(net):
    """JAX-layout (params, state) of the narrow net: the JAX package's
    init from its seed."""
    jtr = JaxTrainer(narrow_pairs(net))
    jtr.init_model()
    return _np_tree(jtr.params), _np_tree(jtr.net_state)


@functools.lru_cache(maxsize=None)
def _batches(net, n=BATCH * STEPS, seed=3):
    return list(create_iterator([("batch_size", str(BATCH))]
                                + synthetic_section("data", "t", n, seed,
                                                    net)[1:]))


def _jax_args(tr, batch, epoch):
    sched = {tag: (jnp.float32(lr), jnp.float32(m))
             for tag, (lr, m) in tr.optimizer.schedules(epoch).items()}
    mask = np.ones((batch.batch_size,), np.float32)
    return (tr.params, tr.opt_state, tr.net_state, {},
            jnp.asarray(batch.data), jnp.asarray(batch.label),
            jnp.asarray(mask), (), jax.random.PRNGKey(0), sched)


@functools.lru_cache(maxsize=None)
def _jax_trajectory(net):
    """float32, deterministic: losses of STEPS JAX steps from the net's
    weights and the (params, momenta, state) trees after the last."""
    tr = JaxTrainer(narrow_pairs(net, fused="0", deterministic=True))
    tr.init_model()
    p, s = _jax_init(net)
    tr.params, tr.net_state, tr.opt_state = tr._place(
        p, s, tr.optimizer.init_state(p))
    step = tr._make_train_step(True).lower(
        *_jax_args(tr, _batches(net)[0], 0)).compile(
        compiler_options={"xla_allow_excess_precision": False})
    losses = []
    for i, b in enumerate(_batches(net)):
        (tr.params, tr.opt_state, tr.net_state, _, loss, _,
         _) = step(*_jax_args(tr, b, i))
        losses.append(float(loss))
    return losses, (_np_tree(tr.params), _np_tree(tr.opt_state),
                    _np_tree(tr.net_state))


def _flat(tree):
    return {"/".join(p): np.asarray(v) for p, v in leaves(tree)}


@pytest.mark.parametrize("fused", ["auto", "0"])
@pytest.mark.parametrize("net", NETS)
def test_narrow_net_trains_like_the_jax_trainer(net, fused):
    want_losses, (wp, wo, ws) = _jax_trajectory(net)
    tr = Trainer(narrow_pairs(net, fused=fused, deterministic=True))
    tr.init_model(_jax_init(net))
    losses = []
    for b in _batches(net):
        tr.update(b)
        losses.append(tr.last_loss)
    np.testing.assert_allclose(losses, want_losses, atol=1e-5)
    gp, gs = params_to_jax(tr.params, tr.net.state)
    go = opt_to_jax(tr.opt_state)
    for got, want, what in ((gp, wp, "params"), (go, wo, "opt"),
                            (gs, ws, "state")):
        got, want = _flat(got), _flat(want)
        assert set(got) == set(want), what
        for k in want:
            if want[k].dtype.kind == "i":
                assert got[k].dtype == np.int32 and got[k] == want[k] == \
                    STEPS, k
            else:
                np.testing.assert_allclose(got[k], want[k], atol=1e-5,
                                           err_msg=f"{what} {k}")


def _grad_fn_names(t):
    seen, todo = set(), [t.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        todo += [f for f, _ in fn.next_functions]
    return {type(f).__name__ for f in seen}


@pytest.mark.parametrize("fused", ["auto", "0"])
@pytest.mark.parametrize("net", NETS)
def test_training_pass_with_the_jax_draws_matches(net, fused):
    """The configs' own dropout and insanity, the JAX package's draws."""
    p, s = _jax_init(net)
    b = _batches(net)[0]
    key = jax.random.PRNGKey(11)
    jcfg = narrow_pairs(net, fused="0")
    jnet = JaxNetwork(jax_build_graph(jcfg), jcfg)
    mask = jnp.ones((BATCH,), jnp.float32)

    def jloss(params):
        return jnet.apply(params, s, jnp.asarray(b.data),
                          jnp.asarray(b.label), mask, rng=key,
                          train=True).loss
    want_loss, want_g = jax_run(jax.value_and_grad(jloss), p)
    cfg = narrow_pairs(net, fused=fused)
    pnet = Network(build_graph(cfg), cfg)
    pnet.load_weights(*params_from_jax(p, s))
    params = {l: {k: v.clone().requires_grad_(True) for k, v in d.items()}
              for l, d in pnet.params.items()}
    loss, new_state, _ = pnet.apply(
        params, pnet.state, torch.from_numpy(b.data),
        torch.from_numpy(b.label), train=True, draws=jax_net_draws(key))
    names = _grad_fn_names(loss)
    kernel_fns = {"alexnet": {"LrnBackward"},
                  "spp": {"PoolBackward"}}[net] | {"BiasActBackward"}
    assert kernel_fns <= names if fused == "auto" else \
        not kernel_fns & names
    flat = leaves(params)
    grads = torch.autograd.grad(loss, [v for _, v in flat])
    got_j, _ = params_to_jax(unflatten(
        (path, g) for (path, _), g in zip(flat, grads)), {})
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-6)
    want_f, got_f = _flat(_np_tree(want_g)), _flat(got_j)
    assert set(want_f) == set(got_f)
    for k, w in want_f.items():
        rel = np.linalg.norm(got_f[k] - w) / max(np.linalg.norm(w), 1e-30)
        assert rel <= 1e-5, (k, rel)
    for layer, st in new_state.items():
        if "step" in st:
            assert int(st["step"]) == 1, layer


# -- rounds resumed by the JAX package, and the LeNet -------------------------

ROUND_RE = re.compile(r"^round +(\d+):\[\d+ sec\]((\t[a-z]+-[a-z@0-9]+:"
                      r"[0-9.]+)+)$")


def _conf_text(pairs):
    return "".join(f'{k} = "{v}"\n' for k, v in pairs)


@pytest.mark.parametrize("net", NETS)
def test_port_round_resumes_in_the_jax_package(net, tmp_path, capsys):
    model_dir = tmp_path / "models"
    pairs = (narrow_pairs(net) + synthetic_section("data", "train", 32, 3,
                                                   net)
             + synthetic_section("eval", "val", 16, 4, net)
             + [("num_round", "1"), ("print_step", "1"),
                ("model_dir", str(model_dir))])
    conf = tmp_path / "net.conf"
    conf.write_text(_conf_text(pairs))
    assert port_main.main([str(conf)]) == 0
    out = capsys.readouterr().out.splitlines()
    rounds = [ln for ln in out if ROUND_RE.match(ln)]
    assert len(rounds) == 1 and "train-rec@1" in rounds[0] \
        and "val-rec@5" in rounds[0]
    assert sorted(os.listdir(model_dir)) == ["0000.model"]
    assert jax_main.main([str(conf), "continue=1", "num_round=2"]) == 0
    out = capsys.readouterr().out
    assert "continuing from round 0" in out.lower() or \
        "continu" in out.lower(), out
    assert sorted(os.listdir(model_dir)) == ["0000.model", "0001.model"]
    from cxxnet_tpu import checkpoint as jax_ckpt
    blob = jax_ckpt.load_model(str(model_dir / "0001.model"))
    assert blob["meta"]["step_count"] == 4
    steps = {l: int(d["step"]) for l, d in blob["state"].items()
             if "step" in d}
    assert steps == ({} if net == "alexnet" else
                     {f"ac{i}": 4 for i in range(1, 8)})


def test_digits_lenet_trains_from_idx_files(tmp_path, capsys):
    data = tmp_path / "data"
    data.mkdir()
    paths = write_digits(str(data))
    conf = os.path.join(REPO, "examples", "digits", "digits_lenet.conf")
    args = [conf, "dev=cpu", "num_round=2", "print_step=1", "silent=0",
            f"model_dir={tmp_path / 'm'}"]
    # the config's own paths, pointed at the test's files
    text = open(conf).read().replace("./examples/digits/data", str(data))
    conf2 = tmp_path / "digits_lenet.conf"
    conf2.write_text(text)
    args[0] = str(conf2)
    assert port_main.main(args) == 0
    out = capsys.readouterr().out.splitlines()
    rounds = [ln for ln in out if ROUND_RE.match(ln)]
    assert [ROUND_RE.match(ln).group(1) for ln in rounds] == ["0", "1"]
    for ln in rounds:
        assert [f.split(":")[0] for f in ln.split("\t")[1:]] == \
            ["train-error", "test-error"], ln
    assert any(ln.startswith("MNISTIterator: load 250 images, shuffle=1")
               for ln in out)
    assert not os.path.exists(tmp_path / "m")          # save_model = 0
    assert len(paths) == 2
