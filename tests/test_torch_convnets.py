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
  - every layer in bfloat16, from the same inputs (the JAX package's
    bf16 training forward's nodes) and upstream gradient, the drawing
    layers given the JAX layers' draws: output, input and master
    gradients within a relative L2 difference of 2e-2, the bound of
    ``test_torch_train.py``'s layer tests (worst reading 1.9e-3); a conv
    bias's gradient, which XLA sums in bf16 over up to 8464 rows, against
    the exact sum of the upstream gradient;
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
from cxxnet_tpu.layers.base import ApplyCtx as JaxCtx
from cxxnet_tpu.model import Network as JaxNetwork
from cxxnet_tpu.trainer import Trainer as JaxTrainer
from cxxnet_tpu_torch import main as port_main
from cxxnet_tpu_torch.config import ConfigError, parse_config_string
from cxxnet_tpu_torch.convert import (opt_to_jax, params_from_jax,
                                      params_to_jax)
from cxxnet_tpu_torch.graph import build_graph
from cxxnet_tpu_torch.io import create_iterator
from cxxnet_tpu_torch.layers import ApplyCtx
from cxxnet_tpu_torch.model import Network
from cxxnet_tpu_torch.optim import leaves, unflatten
from cxxnet_tpu_torch.trainer import Trainer

from torch_convnet_fixture import (BATCH, NARROW, JaxDraws, jax_net_draws,
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


def test_mnist_remote_paths_name_roadmap_a2():
    with pytest.raises(ConfigError, match="ROADMAP Queue A 2"):
        create_iterator([("iter", "mnist"), ("path_img", "gs://b/x.gz"),
                         ("path_label", "gs://b/y.gz"), ("iter", "end")])


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


def _bf16_layer_rels(net, fused):
    """Every layer of the narrow net in bfloat16 training mode in both
    packages, from the same inputs (the nodes of the JAX package's bf16
    training forward under key 5) and the same seeded upstream gradient,
    each drawing layer given the JAX layer's key's draws. Returns
    {(layer, what): relative L2 difference}."""
    p, s = _jax_init(net)
    jcfg = narrow_pairs(net, dtype="bfloat16", fused=fused)
    jnet = JaxNetwork(jax_build_graph(jcfg), jcfg)
    cfg = narrow_pairs(net, dtype="bfloat16", fused=fused)
    pnet = Network(build_graph(cfg), cfg)
    assert pnet._act_folded == jnet._act_folded
    pp, ps = params_from_jax(p, s)
    b = _batches(net)[0]
    key = jax.random.PRNGKey(5)
    mask = np.ones((BATCH,), np.float32)
    nodes = jax_run(lambda p_, s_, x: jnet.apply(
        p_, s_, x, rng=key, train=True, capture_nodes=True).nodes,
        p, s, jnp.asarray(b.data))
    rs = np.random.RandomState(5)
    g, rels = jnet.graph, {}
    f32 = lambda a: np.asarray(a, np.float32)
    for li, (spec, jl) in enumerate(zip(g.layers, jnet.layers)):
        if li in jnet._act_folded:
            continue
        name, lkey = jl.name, jax.random.fold_in(key, li)
        ins = [nodes[g.node_names[ni]] for ni in spec.nindex_in]
        jctx = JaxCtx(train=True, rng=lkey, compute_dtype=jnp.bfloat16,
                      fuse_act=jnet._fuse_act.get(li))

        def fj(lp, xs, _l=jl, _c=jctx, _s=s.get(name, {})):
            outs, _ = _l.apply(lp, _s, list(xs), _c)
            if _l.is_loss:
                return [_l.loss(outs, jnp.asarray(b.label), mask)]
            return outs
        lp_j = {k: jnp.asarray(v) for k, v in p.get(name, {}).items()}
        outs, vjp = jax.vjp(fj, lp_j, ins)
        dys = [jnp.ones_like(o) if jl.is_loss else
               jnp.asarray(rs.randn(*o.shape), o.dtype) for o in outs]
        dlp, dxs = vjp(dys)
        layer = pnet.layers[li]
        lp = {k: v.clone().requires_grad_(True)
              for k, v in pp.get(name, {}).items()}
        xs = [torch.from_numpy(np.array(x, np.float32)).to(
            getattr(torch, str(x.dtype))).requires_grad_(True) for x in ins]
        ctx = ApplyCtx(compute_dtype=torch.bfloat16, fused=pnet.fused,
                       fuse_act=pnet._fuse_act.get(li), train=True,
                       state_sink={}, draws=JaxDraws(lkey))
        touts = layer.forward(pnet._cast_tree({name: lp}, torch.bfloat16)
                              .get(name, {}), ps.get(name, {}), xs, ctx)
        if layer.is_loss:
            touts = [layer.loss(touts, torch.from_numpy(b.label),
                                torch.from_numpy(mask))]
        tdys = [torch.from_numpy(np.array(d, np.float32)).to(o.dtype)
                for d, o in zip(dys, touts)]
        grads = torch.autograd.grad(touts, list(lp.values()) + xs, tdys)
        tlp = dict(zip(lp, grads[:len(lp)]))
        assert all(v.dtype == torch.float32 for v in tlp.values())
        tlp, _ = params_to_jax({name: tlp} if tlp else {}, {})
        rel = lambda a, w: float(np.linalg.norm(a - w)
                                 / max(np.linalg.norm(w), 1e-12))
        for i, (o, to) in enumerate(zip(outs, touts)):
            rels[(name, f"out{i}")] = rel(f32(to.detach().float()), f32(o))
        for i, (d, td) in enumerate(zip(dxs, grads[len(lp):])):
            rels[(name, f"dx{i}")] = rel(f32(td.float()), f32(d))
        for k, d in dlp.items():
            want = f32(d)
            if k == "bias" and outs[0].ndim == 4:
                # a conv bias's gradient sums B*H*W upstream values: XLA
                # adds them in bf16 (JAX's value reads up to 9.6e-2 from
                # the exact sum at cv1's 8464 rows), the port in f32;
                # both are held to the exact sum of the upstream gradient
                # (masked by the folded relu's output) instead
                up = np.asarray(dys[0], np.float64)
                if jnet._fuse_act.get(li) == "relu":
                    up = up * (f32(outs[0]) > 0)
                want = up.sum(axis=(0, 1, 2))
            rels[(name, f"d{k}")] = rel(tlp[name][k], want)
    return rels


@pytest.mark.parametrize("fused", ["auto", "0"])
@pytest.mark.parametrize("net", NETS)
def test_bf16_layers_backward_like_the_jax_layers(net, fused):
    rels = _bf16_layer_rels(net, fused)
    kinds = {t for _, t in {(n, w.split("_")[0][:2]) for n, w in rels}}
    assert {"ou", "dx", "dw", "db"} <= kinds
    types = {"alexnet": ("lrn1", "lrn2", "dp6", "dp7"),
             "spp": ("ac1", "ac7", "dp6", "spp1", "spp4")}[net]
    assert {n for n, _ in rels} >= set(types)
    bad = {k: r for k, r in rels.items() if not r <= 2e-2}
    assert not bad, bad


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
