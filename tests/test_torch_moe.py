"""The port's mixture-of-experts layer and ``tiny_moe_lm.conf`` against the
JAX package, on the CPU.

* The layer (``layers/moe.py``) against ``cxxnet_tpu/layers/moe.py`` on
  a sequence node of 16 features and 12 tokens, batch 3, 4 experts, the
  JAX layer's initial parameters carried across: top-1 and top-2, a
  ``capacity_factor`` that drops tokens (checked: some expert of some
  sequence is chosen past its capacity), ``no_drop = 1``, gelu and relu,
  float32 and bfloat16. The objective ``sum(out * dy) + aux`` is
  differentiated in both; the output, the load-balance loss (the
  ``_aux_loss`` state), the input gradient and every parameter gradient
  agree within 1e-5 (float32) or 1e-2 relative L2 (bfloat16). The seeded
  inputs' gates (``init_sigma = 0.5``) are checked to be at least 1e-5
  apart between the first, second and third choice, a hundred times the
  router's difference between the packages, so that a last-bit
  difference cannot flip a choice.
* ``examples/LM/tiny_moe_lm.conf`` as written (batch 64, S 64, E 64, 4
  experts top-2, Adam) trains 3 steps in both trainers from the JAX
  package's init: each step's loss within 1e-5 relative, every leaf's
  update within 1e-4 relative L2 of the JAX trainer's (the LM slice's
  bounds; the attention's k bias, whose true gradient is 0, within
  Adam's step bound). At the conf's init the gates are near uniform (the router's
  ``init_sigma`` 0.01: the closest two of a token 2.7e-7 apart), so the
  test checks that the first step routes every token to the same two
  experts as the JAX layer's gates do on the same input; a choice that
  flipped later would show in the losses and updates.
* Rounds: a round the port writes loads in the JAX package, one the JAX
  package writes loads in the port (the router / h / o trees, the
  ``_aux_loss`` state, Adam's moments), leaf for leaf; ``task =
  pred_raw`` on a port round gives the JAX task driver's file.
* Data parallelism: two gloo ranks (``dev = cpu``) of a narrow MoE LM
  with ``moe_loss_coef = 1`` take one SGD step whose update equals the
  JAX single-device step over the global batch (loss 1e-5 relative, each
  leaf's update 1e-4 relative L2): the load-balance loss takes the
  global batch's means, and its gradient is not counted once a rank.
* ``model_parallel = 2`` with a moe layer raises naming ROADMAP Queue A 9;
  the LM serving engine refuses a moe graph, as the JAX package's does.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cxxnet_tpu import checkpoint as jax_ckpt
from cxxnet_tpu.config import parse_config_string as jax_parse
from cxxnet_tpu.graph import build_graph as jax_build_graph
from cxxnet_tpu.layers.base import ApplyCtx as JaxCtx
from cxxnet_tpu.model import Network as JaxNetwork
from cxxnet_tpu.trainer import Trainer as JaxTrainer
from cxxnet_tpu_torch import checkpoint as ckpt
from cxxnet_tpu_torch.config import (ConfigError, parse_config_file,
                                     parse_config_string, split_sections)
from cxxnet_tpu_torch.convert import (opt_to_jax, params_from_jax,
                                      params_to_jax)
from cxxnet_tpu_torch.graph import build_graph
from cxxnet_tpu_torch.io import create_iterator
from cxxnet_tpu_torch.layers import ApplyCtx
from cxxnet_tpu_torch.model import Network
from cxxnet_tpu_torch.optim import leaves
from cxxnet_tpu_torch.parallel import launch
from cxxnet_tpu_torch.trainer import Trainer

import torch_dp_fixture
from torch_ibn_fixture import REPO

MOE_CONF = os.path.join(REPO, "examples", "LM", "tiny_moe_lm.conf")
STEPS = 3

ONE_MOE = """
netconfig = start
layer[in->o] = moe:mx
  num_expert = 4
  nhidden = 24
  init_sigma = 0.5
{keys}
netconfig = end
input_shape = 16,12,1
compute_dtype = {dtype}
"""

#: case -> (keys, dtype)
CASES = {
    "top1": ("  topk = 1", "float32"),
    "top2": ("  topk = 2", "float32"),
    "top2-drops": ("  topk = 2\n  capacity_factor = 0.5", "float32"),
    "top1-no_drop": ("  topk = 1\n  no_drop = 1", "float32"),
    "top2-relu": ("  topk = 2\n  act = relu", "float32"),
    "top2-bf16": ("  topk = 2", "bfloat16"),
    "no_drop-bf16": ("  no_drop = 1\n  act = relu", "bfloat16"),
}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _np_tree(t):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), t)


def _paths(tree):
    return dict(leaves(tree))


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - b)
                 / max(np.linalg.norm(np.asarray(b, np.float64)), 1e-30))


def _margin(gates: np.ndarray, k: int = 3) -> float:
    """The least gap between the first k gates of a token, sorted."""
    g = -np.sort(-gates.reshape(-1, gates.shape[-1]), axis=-1)[:, :k]
    return float(np.min(g[:, :-1] - g[:, 1:]))


def _run_layer(case):
    keys, dtype = CASES[case]
    text = ONE_MOE.format(keys=keys, dtype=dtype)
    jcfg = jax_parse(text)
    cfg = parse_config_string(text + "dev = cpu\n")
    jnet = JaxNetwork(jax_build_graph(jcfg), jcfg)
    net = Network(build_graph(cfg), cfg)
    jl, pl = jnet.layers[0], net.layers[0]
    jparams, jstate = jnet.init(jax.random.PRNGKey(3))
    rs = np.random.RandomState(21)
    x = rs.randn(3, 12, 1, 16).astype(np.float32)
    dy = rs.randn(3, 12, 1, 16).astype(np.float32)
    jdt, tdt = JDT[dtype], TDT[dtype]
    ctx = JaxCtx(train=True, rng=jax.random.PRNGKey(0), compute_dtype=jdt)

    def fj(p, a):
        outs, st = jl.apply(p, jstate["mx"], [a.astype(jdt)], ctx)
        y = outs[0].astype(jnp.float32)
        return jnp.sum(y * dy) + st["_aux_loss"], (y, st["_aux_loss"])
    (_, (yj, auxj)), (gpj, gxj) = jax.value_and_grad(
        fj, argnums=(0, 1), has_aux=True)(jparams["mx"], jnp.asarray(x))
    pp, _ = params_from_jax(_np_tree(jparams), {})
    flat = []

    def req(t):
        if isinstance(t, dict):
            return {k: req(v) for k, v in t.items()}
        flat.append(t.requires_grad_(True))
        return t
    lp = req(pp["mx"])
    xt = torch.from_numpy(x).requires_grad_(True)
    sink = {}
    (y,) = pl.forward(lp, {}, [xt.to(tdt)], ApplyCtx(
        compute_dtype=tdt, train=True, state_sink=sink))
    aux = sink["mx"]["_aux_loss"]
    obj = (y.float() * torch.from_numpy(dy)).sum() + aux
    grads = torch.autograd.grad(obj, [xt] + flat)
    it = iter(grads[1:])
    gp = params_to_jax({"mx": jax.tree_util.tree_map(
        lambda _: next(it), lp)}, {})[0]["mx"]
    gates, _, _ = pl.route(xt.detach().to(tdt).reshape(3, 12, 16),
                           lp["router"]["wmat"])
    return (dict(y=np.asarray(yj), aux=float(auxj), dx=np.asarray(gxj),
                 dp=_np_tree(gpj)),
            dict(y=y.detach().float().numpy(), aux=float(aux.detach()),
                 dx=grads[0].numpy(), dp=gp),
            pl, gates.detach().numpy())


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_layer_matches_the_jax_layer(case):
    want, got, layer, gates = _run_layer(case)
    assert _margin(gates) > 1e-5
    if case == "top2-drops":
        # some expert of some sequence is chosen past its capacity
        x = gates.shape[-1]
        cap = int(12 / x * layer.capacity_factor * layer.topk)
        top = np.argsort(-gates, axis=-1)[..., :2]
        counts = np.stack([(top == e).sum(axis=(1, 2)) for e in range(x)])
        assert counts.max() > cap, (counts, cap)
    if CASES[case][1] == "float32":
        np.testing.assert_allclose(got["y"], want["y"], rtol=1e-5, atol=1e-5)
        assert abs(got["aux"] - want["aux"]) <= 1e-6 * abs(want["aux"])
        np.testing.assert_allclose(got["dx"], want["dx"], rtol=1e-5,
                                   atol=1e-5)
        for p, w in _paths(want["dp"]).items():
            np.testing.assert_allclose(_paths(got["dp"])[p], w, rtol=1e-5,
                                       atol=1e-5, err_msg=str(p))
    else:
        assert _rel(got["y"], want["y"]) <= 1e-2
        assert abs(got["aux"] - want["aux"]) <= 1e-5 * abs(want["aux"])
        assert _rel(got["dx"], want["dx"]) <= 1e-2
        for p, w in _paths(want["dp"]).items():
            assert _rel(_paths(got["dp"])[p], w) <= 1e-2, p


# -- tiny_moe_lm.conf through both trainers ------------------------------------

def _cfg():
    glob, _ = split_sections(parse_config_file(MOE_CONF))
    return glob + [("dev", "cpu"), ("silent", "1")]


@functools.lru_cache(maxsize=None)
def _batches():
    _, sections = split_sections(parse_config_file(MOE_CONF))
    pairs = [("batch_size", "64")] + sections[0][2]
    it = create_iterator(pairs)
    out = []
    for b in it:
        out.append(b)
        if len(out) == STEPS:
            break
    return out


def _jax_args(tr, batch, epoch):
    sched = {tag: (jnp.float32(lr), jnp.float32(m))
             for tag, (lr, m) in tr.optimizer.schedules(epoch).items()}
    mask = np.ones((batch.batch_size,), np.float32)
    return (tr.params, tr.opt_state, tr.net_state, {},
            jnp.asarray(batch.data), jnp.asarray(batch.label),
            jnp.asarray(mask), (), jax.random.PRNGKey(0), sched)


@functools.lru_cache(maxsize=None)
def _jax_run():
    """The JAX trainer's init, its losses and (params, opt, state) after
    each step of tiny_moe_lm.conf."""
    tr = JaxTrainer(_cfg())
    tr.init_model()
    init = (_np_tree(tr.params), _np_tree(tr.net_state))
    step = tr._make_train_step(True).lower(
        *_jax_args(tr, _batches()[0], 0)).compile()
    losses, snaps = [], []
    for i, b in enumerate(_batches()):
        (tr.params, tr.opt_state, tr.net_state, _, loss, _,
         _) = step(*_jax_args(tr, b, i))
        losses.append(float(loss))
        snaps.append((_np_tree(tr.params), _np_tree(tr.opt_state),
                      _np_tree(tr.net_state)))
    return init, losses, snaps


def _adam_step_bound(lr, t, d1=0.1, d2=0.001):
    """The most Adam's step t moves an element (lr times the
    Cauchy-Schwarz bound of |m1_hat| / sqrt(m2_hat))."""
    i = np.arange(1, t + 1)
    a = d1 * (1 - d1) ** (t - i) / (1 - (1 - d1) ** t)
    b = d2 * (1 - d2) ** (t - i) / (1 - (1 - d2) ** t)
    return lr * float(np.sqrt(np.sum(a * a / b)))


def test_tiny_moe_lm_trains_like_the_jax_trainer():
    init, want_losses, snaps = _jax_run()
    tr = Trainer(_cfg())
    tr.init_model(init)
    assert tr.optimizer.type == "adam" and tr.net.layers[5].topk == 2
    # the first step's choices are the JAX layer's on the same input
    _, _, nodes = tr.net.apply(
        tr.params, tr.net.state, tr.stage_batch(_batches()[0]).data,
        capture_nodes=True)
    n2 = nodes["n2"].detach()
    x = n2.reshape(n2.shape[0], n2.shape[1], -1)
    router = tr.params["moe1"]["router"]["wmat"].detach()
    _, sel, _ = tr.net.layers[5].route(x, router)
    jg = jax.nn.softmax(jnp.einsum("bte,ex->btx", jnp.asarray(x.numpy()),
                                   jnp.asarray(router.numpy())), axis=-1)
    j1 = jnp.argmax(jg, axis=-1)
    oh1 = jax.nn.one_hot(j1, 4)
    j2 = jnp.argmax(jg - jg * oh1 - oh1, axis=-1)
    for (oh, _), want in zip(sel, (j1, j2)):
        np.testing.assert_array_equal(oh.argmax(-1).numpy(),
                                      np.asarray(want))
    w0 = _paths(init[0])
    lr = tr.optimizer.hypers["bias"].base_lr
    for i, b in enumerate(_batches()):
        tr.update(b)
        assert abs(tr.last_loss - want_losses[i]) <= 1e-5 * abs(
            want_losses[i]), (i, tr.last_loss, want_losses[i])
        want_p, want_o, want_s = snaps[i]
        got_p, got_s = params_to_jax(tr.params, tr.net.state)
        got_o = opt_to_jax(tr.opt_state)
        assert int(got_o["t"]) == i + 1
        assert abs(float(got_s["moe1"]["_aux_loss"])
                   - float(want_s["moe1"]["_aux_loss"])) <= 1e-6
        for name, got, want, base in (("params", got_p, want_p, w0),
                                      ("m1", got_o["m1"], want_o["m1"], None),
                                      ("m2", got_o["m2"], want_o["m2"], None)):
            g, w = _paths(got), _paths(want)
            assert set(g) == set(w) == set(w0)
            for p in w:
                b0 = 0.0 if base is None else base[p]
                if p[1:] == ("k", "bias"):
                    # its true gradient is 0 (softmax ignores a shift of
                    # the scores): Adam moves it by rounding noise, at
                    # most a step's bound a step, in both packages
                    if base is not None:
                        drift = sum(_adam_step_bound(lr, t)
                                    for t in range(1, i + 2))
                        for tree in (g, w):
                            assert np.abs(tree[p] - b0).max() <= \
                                drift * (1 + 1e-3)
                    continue
                rel = _rel(g[p] - b0, w[p] - b0)
                assert rel <= 1e-4, (i, name, p, rel)


def test_moe_rounds_load_in_both_packages(tmp_path):
    """A port round (after one step: Adam's moments, the aux state) loads
    in the JAX package, and a JAX round in the port, leaf for leaf."""
    init, _, _ = _jax_run()
    tr = Trainer(_cfg())
    tr.init_model(init)
    tr.update(_batches()[0])
    path = str(tmp_path / "0000.model")
    tr.save_model(path)
    blob = jax_ckpt.load_model(path)
    assert blob["params"]["moe1"]["h"]["wmat"].shape == (4, 64, 256)
    assert set(blob["state"]["moe1"]) == {"_aux_loss"}
    jtr = JaxTrainer(_cfg())
    jtr.init_model()
    jtr.load_model(path)
    got_p, got_s = params_to_jax(tr.params, tr.net.state)
    for mine, theirs in ((got_p, jtr.params), (got_s, jtr.net_state),
                         (opt_to_jax(tr.opt_state)["m1"],
                          jtr.opt_state["m1"])):
        t = _paths(_np_tree(theirs))
        for p, v in _paths(mine).items():
            np.testing.assert_array_equal(v, t[p], err_msg=str(p))
    jpath = str(tmp_path / "0001.model")
    jtr.save_model(jpath)
    back = Trainer(_cfg())
    back.load_model(jpath)
    bp, bs = params_to_jax(back.params, back.net.state)
    for mine, theirs in ((bp, got_p), (bs, got_s)):
        for p, v in _paths(mine).items():
            np.testing.assert_array_equal(v, _paths(theirs)[p],
                                          err_msg=str(p))


# -- data parallelism ----------------------------------------------------------

DP_TEXT = """
netconfig = start
layer[+1:e0] = embed:tok_embed
  nhidden = 16
  vocab_size = 32
  random_type = gaussian
  init_sigma = 0.5
layer[+1:n1] = layernorm:ln1
layer[+1:f1] = moe:moe1
  num_expert = 4
  topk = 2
  nhidden = 32
  init_sigma = 0.3
  moe_loss_coef = 1.0
layer[e0,f1->r1] = add:res1
layer[+1:lg] = seqfc:lm_head
  nhidden = 32
layer[+0] = lmloss
netconfig = end
input_shape = 1,1,16
label_vec[0,16) = label
batch_size = 8
updater = sgd
eta = 0.5
momentum = 0.0
wd = 0.0
dev = cpu
silent = 1
"""


@functools.lru_cache(maxsize=None)
def _dp_batch():
    pairs = [("batch_size", "8"), ("iter", "synthetic_lm"),
             ("num_inst", "8"), ("vocab_size", "32"), ("seq_len", "16"),
             ("seed_data", "3")]
    return next(iter(create_iterator(pairs)))


@functools.lru_cache(maxsize=None)
def _dp_weights():
    cfg = parse_config_string(DP_TEXT)
    net = Network(build_graph(cfg), cfg)
    return params_to_jax(*net.init(torch.Generator().manual_seed(4)))


def test_moe_dp_step_matches_the_jax_single_device_step():
    params, state = _dp_weights()
    b = _dp_batch()
    jtr = JaxTrainer(jax_parse(DP_TEXT))
    jtr.params, jtr.net_state, jtr.opt_state = jtr._place(
        params, state, jtr.optimizer.init_state(params))
    step = jtr._make_train_step(True)
    p, _, s, _, loss, _, _ = step(*_jax_args(jtr, b, 0))
    want_p, want_s = _np_tree(p), _np_tree(s)
    (l0, t0), (l1, t1) = launch(torch_dp_fixture.train_step_rank,
                                (DP_TEXT, (params, state), [b]),
                                devices=("cpu", "cpu"), timeout_s=60,
                                deadline_s=240)
    assert l0 == l1
    assert abs(l0[0] - float(loss)) <= 1e-5 * abs(float(loss))
    for p_, v in _paths(t0[0]).items():
        np.testing.assert_array_equal(v, _paths(t1[0])[p_])
    w0, w = _paths(params), _paths(want_p)
    for p_, v in _paths(t0[0]).items():
        assert _rel(v - w0[p_], w[p_] - w0[p_]) <= 1e-4, p_
    aux = float(want_s["moe1"]["_aux_loss"])
    assert aux > 0.5 and abs(float(t0[2]["moe1"]["_aux_loss"]) - aux) \
        <= 1e-6 * aux


def test_expert_parallelism_and_moe_serving_stay_refused():
    with pytest.raises(ConfigError, match="Queue A 9"):
        Trainer(_cfg() + [("model_parallel", "2")])
    from cxxnet_tpu_torch.serve.lm.engine import SUPPORTED_TYPES
    assert "moe" not in SUPPORTED_TYPES


def test_moe_batch_task_files_are_the_jax_drivers(tmp_path):
    """A round of tiny_moe_lm.conf (its data cut to 128 rows) trained by
    the port's task driver answers ``task = pred_raw`` with the JAX task
    driver's file within 1e-5."""
    from cxxnet_tpu import main as jax_main
    from cxxnet_tpu_torch import main as port_main
    conf = tmp_path / "moe.conf"
    conf.write_text(open(MOE_CONF).read()
                    .replace("num_inst = 2048", "num_inst = 128")
                    .replace("num_inst = 512", "num_inst = 64"))
    models = tmp_path / "m"
    port_main.main([str(conf), "dev=cpu:0", f"model_dir={models}",
                    "num_round=1", "silent=1"])
    rnd = str(models / "0000.model")
    out = {}
    for name, main in (("port", port_main.main), ("jax", jax_main.main)):
        dest = str(tmp_path / f"{name}.txt")
        main([str(conf), "dev=cpu:0", "task=pred_raw", f"model_in={rnd}",
              f"name_pred={dest}"])
        out[name] = np.loadtxt(dest, ndmin=2)
    assert out["port"].shape == out["jax"].shape == (128, 64 * 32)
    np.testing.assert_allclose(out["port"], out["jax"], rtol=1e-5,
                               atol=1e-6)
