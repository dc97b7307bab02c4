"""The port's training path against the JAX package's.

The same JAX-drawn weights and the same synthetic batches go through the
port's ``Trainer`` on the CPU (the kernels' autograd functions with their
plain versions, or ``fused_kernels = 0``) and through the JAX package's
train step with ``fused_kernels = 0``, compiled with excess precision off
(``jax_run``'s options), with the flagship's SGD hyperparameters (eta
0.1, momentum 0.9, wd 1e-4) at batch 16.

* A small net of every training layer kind (conv, batch_norm with a
  folded relu, ceil-mode max pool, padded avg pool, ch_concat, the
  global average pool, fullc with bias, softmax) trains 1 and 3 steps
  freely in both packages; the loss per step, every parameter and
  momentum leaf and the BN running statistics are compared. float32:
  loss atol 1e-5, params and momenta atol 1e-4, running statistics
  atol 1e-5. bfloat16: loss, params, momenta and statistics atol 1e-2
  (the packages round activations at the same places but sum in other
  orders, and the port's pooling and epilogue kernels sum in f32 where
  XLA's reduce_window adds in bf16).
* The narrow Inception-BN of ``torch_ibn_fixture`` (69 batch_norm
  layers) is compared step by step, each step taken by the port from
  the JAX package's state after the step before: at its init a
  1e-6 relative change of the input data moves the port's own float32
  gradients by 1.5e-2 (median over leaves; up to 5.6e-2), and after one
  step the two packages' float32 trajectories are as far apart as that
  (deep batch-norm nets explode gradients at init), so free-running
  comparisons measure that chaos, not the port. Per step: the loss, the
  update (after - before) of every parameter and momentum leaf as a
  relative L2 difference, and every running statistic. float32: loss
  rtol 1e-4, update at most 0.15 per leaf and 0.05 in the median over
  leaves, statistics 1e-3. bfloat16: loss rtol 1e-2, statistics 3e-2,
  update at most 2.5 per leaf and 1.0 in the median; and the gradient
  part of each leaf's step (``-eta * (g + wd * w)``, the new momentum
  less 0.9 times the old): at steps 1 and 2 the JAX package's own bf16
  step differs from its f32 step by a median of 0.87 (up to 1.86;
  measured by ``test_ibn_gradients_at_init_are_chaotic``), so there
  only the ratio of its norms, port / JAX, is held within [1/3, 3]
  (readings 0.57 to 1.62; a leaf the gradient does not reach reads about
  0); from the JAX state after two bf16 steps the chaos has gone, and
  at step 3 its relative L2 difference is at most 0.4 per leaf and 0.1
  in the median (readings 0.143 and 0.027; a frozen leaf reads 1).
* Every layer of that net and of the small net in bfloat16, from the
  same inputs (the JAX package's bf16 training forward's node values)
  and the same seeded upstream gradient in both packages, with the port
  casting its f32 masters inside the graph: output, input gradients and
  the masters' f32 gradients within a relative L2 difference of 2e-2
  (worst reading 6.4e-3), 5e-2 where XLA adds many bf16 terms in bf16
  and the port sums in f32 (readings 3.2e-2 and 2.8e-2). No chaos
  enters here, so this holds each layer's bf16 backward and the casts
  to the precision of bf16.
* ``python -m cxxnet_tpu_torch.main <conf> task=train dev=cpu`` prints
  the JAX package's round lines and writes ``%04d.model`` rounds with
  the optimizer state, which ``cxxnet_tpu.checkpoint`` loads
  (``has_opt``) and from which the JAX trainer takes the same next step
  as the port (the float32 step tolerances above).
* Training keys of features outside this slice raise ``ConfigError``
  naming their ROADMAP item unless they hold their off value.
"""

import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cxxnet_tpu import checkpoint as jax_ckpt
from cxxnet_tpu.config import parse_config_string as jax_parse
from cxxnet_tpu.graph import build_graph as jax_build_graph
from cxxnet_tpu.io.data import create_iterator as jax_create_iterator
from cxxnet_tpu.model import Network as JaxNetwork
from cxxnet_tpu.trainer import Trainer as JaxTrainer
from cxxnet_tpu_torch import checkpoint as ckpt
from cxxnet_tpu_torch import main as port_main
from cxxnet_tpu_torch.config import (TRAIN_NOT_YET, ConfigError,
                                     parse_config_string)
from cxxnet_tpu_torch.convert import opt_to_jax, params_to_jax
from cxxnet_tpu_torch.io import create_iterator
from cxxnet_tpu_torch.trainer import Trainer

from torch_ibn_fixture import BATCH, IBN_TEXT, jax_weights

HYPER = """
eta = 0.1
momentum = 0.9
wd = 0.0001
batch_size = 16
dev = cpu:0
compute_dtype = {dtype}
fused_kernels = {fused}
"""

SYNTH = """
iter = synthetic
  num_inst = {n}
  num_class = 10
  input_shape = {shape}
  seed_data = {seed}
iter = end
"""

SMALL_TEXT = """
netconfig = start
layer[in->c1] = conv:cv1
  kernel_size = 3
  nchannel = 16
  pad = 1
  no_bias = 1
  random_type = kaiming
layer[c1->b1] = batch_norm:bn1
layer[b1->r1] = relu:ac1
layer[r1->p1] = max_pooling:mp1
  kernel_size = 3
  stride = 2
layer[p1->c2] = conv:cv2
  kernel_size = 3
  nchannel = 16
  pad = 1
  random_type = kaiming
layer[c2->r2] = relu:ac2
layer[r2->p2] = avg_pooling:ap2
  kernel_size = 3
  stride = 1
  pad = 1
layer[p2,r2->cc] = ch_concat:cc
layer[cc->b3] = batch_norm:bn3
layer[b3->g] = avg_pooling:gap
  kernel_size = 8
  stride = 1
layer[g->f] = flatten:fl
layer[f->o] = fullc:fc
  nhidden = 10
  random_type = xavier
layer[o->o] = softmax:sm
netconfig = end
input_shape = 3,16,16
"""


@functools.lru_cache(maxsize=None)
def _small_weights():
    cfg = jax_parse(SMALL_TEXT)
    params, state = JaxNetwork(jax_build_graph(cfg), cfg).init(
        jax.random.PRNGKey(1))
    return _np_tree(params), _np_tree(state)


#: net -> (config text, JAX-layout weights, input shape)
NETS = {"small": (SMALL_TEXT, _small_weights, "3,16,16"),
        "ibn": (IBN_TEXT, jax_weights, "3,64,64")}
STEPS = 3


def _section(n, seed, shape):
    return parse_config_string(SYNTH.format(n=n, seed=seed, shape=shape))


@functools.lru_cache(maxsize=None)
def _batches(net, n=BATCH * STEPS, seed=3):
    pairs = [("batch_size", str(BATCH))] + _section(n, seed, NETS[net][2])
    return list(create_iterator(pairs))


def test_synthetic_data_is_bit_equal_to_the_jax_iterator():
    pairs = [("batch_size", "16")] + _section(40, 5, "3,64,64")
    ours, ref = list(create_iterator(pairs)), list(jax_create_iterator(pairs))
    assert len(ours) == len(ref) == 3
    for a, b in zip(ours, ref):
        assert a.num_batch_padd == b.num_batch_padd
        np.testing.assert_array_equal(a.data, b.data)
        np.testing.assert_array_equal(a.label, b.label)
        np.testing.assert_array_equal(a.inst_index, b.inst_index)
    assert ours[-1].num_batch_padd == 8


def _np_tree(t):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), t)


def _cfg(net, dtype, fused):
    return NETS[net][0] + HYPER.format(dtype=dtype, fused=fused)


@functools.lru_cache(maxsize=None)
def _jax_step(net, dtype):
    """(trainer, compiled train step) of the JAX package, fused_kernels
    = 0, compiled without excess precision."""
    tr = JaxTrainer(jax_parse(_cfg(net, dtype, 0)))
    tr.init_model()
    _jax_place(tr, *NETS[net][1]())
    args = _jax_args(tr, _batches(net)[0], 0)
    step = tr._make_train_step(True).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})
    return tr, step


def _jax_place(tr, params, state):
    tr.params, tr.net_state, tr.opt_state = tr._place(
        params, state, tr.optimizer.init_state(params))


def _jax_args(tr, batch, epoch):
    sched = {tag: (jnp.float32(lr), jnp.float32(m))
             for tag, (lr, m) in tr.optimizer.schedules(epoch).items()}
    mask = np.ones((batch.batch_size,), np.float32)
    mask[batch.batch_size - batch.num_batch_padd:] = 0.0
    return (tr.params, tr.opt_state, tr.net_state, {},
            jnp.asarray(batch.data), jnp.asarray(batch.label),
            jnp.asarray(mask), (), jax.random.PRNGKey(0), sched)


def _jax_take_step(tr, step, batch, epoch):
    (tr.params, tr.opt_state, tr.net_state, _, loss, _,
     _) = step(*_jax_args(tr, batch, epoch))
    return float(loss)


def _jax_snap(tr):
    return (_np_tree(tr.params), _np_tree(tr.opt_state),
            _np_tree(tr.net_state))


def _port_snap(tr):
    p, s = params_to_jax(tr.params, tr.net.state)
    return p, opt_to_jax(tr.opt_state), s


@functools.lru_cache(maxsize=None)
def _jax_trajectory(net, dtype):
    """Losses of STEPS JAX steps from the net's weights with zero
    momenta, and the (params, opt, state) trees before the first step
    and after each step."""
    tr, step = _jax_step(net, dtype)
    _jax_place(tr, *NETS[net][1]())
    losses, snaps = [], [_jax_snap(tr)]
    for i, b in enumerate(_batches(net)):
        losses.append(_jax_take_step(tr, step, b, i))
        snaps.append(_jax_snap(tr))
    return losses, snaps


@functools.lru_cache(maxsize=None)
def _port_trajectory(net, dtype, fused, forced):
    """The port's STEPS steps: from the same weights freely, or with
    ``forced`` each step k from the JAX package's state after step k-1
    (params, momenta, BN statistics, epoch counter). Losses and the
    trees after each step."""
    _, snaps = _jax_trajectory(net, dtype)
    tr = Trainer(parse_config_string(_cfg(net, dtype, fused)))
    tr.init_model(NETS[net][1]())
    sig = ckpt._sig_to_json(tr.graph.structure_signature())
    losses, out = [], []
    for i, b in enumerate(_batches(net)):
        if forced:
            p, o, s = snaps[i]
            tr.load_blob({"meta": {"structure_sig": sig, "round": 0,
                                   "epoch": i},
                          "params": p, "state": s, "opt": o})
        tr.update(b)
        losses.append(tr.last_loss)
        out.append(_port_snap(tr))
    return losses, out


def _leafs(tree):
    return {(l, k): v for l, d in tree.items() for k, v in d.items()}


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


@pytest.mark.parametrize("steps", [1, STEPS])
@pytest.mark.parametrize("fused", ["auto", "0"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_small_net_trains_like_the_jax_trainer(dtype, fused, steps):
    want_losses, snaps = _jax_trajectory("small", dtype)
    got_losses, got = _port_trajectory("small", dtype, fused, False)
    f32 = dtype == "float32"
    np.testing.assert_allclose(got_losses[:steps], want_losses[:steps],
                               atol=1e-5 if f32 else 1e-2)
    for g, w, what in zip(got[steps - 1], snaps[steps],
                          ("params", "opt", "state")):
        if what == "opt":
            assert set(g) == set(w) == {"mom"}
            g, w = g["mom"], w["mom"]
        g, w = _leafs(g), _leafs(w)
        assert set(g) == set(w)
        atol = (1e-5 if what == "state" else 1e-4) if f32 else 1e-2
        for k in w:
            np.testing.assert_allclose(g[k], w[k], atol=atol,
                                       err_msg=f"{what} {k}")


#: per dtype: (loss rtol; bound on the relative L2 difference of one
#: step's update (after - before) of a parameter or momentum leaf, and
#: on its median over leaves; bound on that of each BN running statistic)
TOL = {"float32": (1e-4, 0.15, 0.05, 1e-3),
       "bfloat16": (1e-2, 2.5, 1.0, 3e-2)}
#: bfloat16, steps 1 and 2 (gradient-chaotic, see the module docstring):
#: range of the ratio of the norms of a leaf's gradient part, port / JAX
#: (readings 0.57 to 1.62)
BF16_RATIO = (1 / 3, 3.0)
#: bfloat16, step 3: bound on the relative L2 difference of a leaf's
#: gradient part, and on its median over leaves (readings 0.143, 0.027)
BF16_GRAD = (0.4, 0.1)
MOMENTUM = 0.9               # HYPER's, with no momentum schedule


def _grad_parts(snap, before):
    """Each leaf's gradient part of one SGD step, ``-eta * (g + wd *
    w)``: the new momentum less the decayed old one."""
    m1, m0 = _leafs(snap[1]["mom"]), _leafs(before[1]["mom"])
    return {k: m1[k] - MOMENTUM * m0[k] for k in m0}


def _check_step(dtype, step, got_loss, want_loss, got, before, after):
    """Step ``step`` of the port against the JAX package's from the same
    state ``before`` (see the module docstring)."""
    loss_rtol, leaf_tol, median_tol, state_tol = TOL[dtype]
    np.testing.assert_allclose(got_loss, want_loss, rtol=loss_rtol)
    gp, go, gs = got
    rels = []
    for g, w, b in ((gp, after[0], before[0]),
                    (go["mom"], after[1]["mom"], before[1]["mom"])):
        g, w, b = _leafs(g), _leafs(w), _leafs(b)
        assert set(g) == set(w)
        rels += [(_rel(g[k] - b[k], w[k] - b[k]), k) for k in w]
    worst = max(rels)
    assert worst[0] <= leaf_tol, worst
    assert float(np.median([r for r, _ in rels])) <= median_tol
    if dtype == "bfloat16":
        g, w = _grad_parts(got, before), _grad_parts(after, before)
        if step < 3:
            ratios = {k: float(np.linalg.norm(g[k]) / np.linalg.norm(w[k]))
                      for k in w}
            bad = {k: r for k, r in ratios.items()
                   if not BF16_RATIO[0] <= r <= BF16_RATIO[1]}
            assert not bad, bad
        else:
            grels = sorted((_rel(g[k], w[k]), k) for k in w)
            assert grels[-1][0] <= BF16_GRAD[0], grels[-1]
            assert float(np.median([r for r, _ in grels])) <= BF16_GRAD[1]
    gs, ws = _leafs(gs), _leafs(after[2])
    assert set(gs) == set(ws)
    for k in ws:
        assert _rel(gs[k], ws[k]) <= state_tol, (k, _rel(gs[k], ws[k]))


@pytest.mark.parametrize("step", range(1, STEPS + 1))
@pytest.mark.parametrize("fused", ["auto", "0"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ibn_steps_match_the_jax_trainer(dtype, fused, step):
    """Inception-BN step ``step`` (1..3) from the JAX state after the
    step before."""
    want_losses, snaps = _jax_trajectory("ibn", dtype)
    got_losses, got = _port_trajectory("ibn", dtype, fused, True)
    _check_step(dtype, step, got_losses[step - 1], want_losses[step - 1],
                got[step - 1], snaps[step - 1], snaps[step])


#: bound on the relative L2 difference of each layer's output, input
#: gradients and master gradients in bfloat16 (worst reading 6.4e-3,
#: fc1's dbias: f32 sums in another order)
BF16_LAYER = 2e-2
#: the bound where XLA adds many bf16 terms in bf16 and the port sums in
#: f32 and rounds once: the small net's conv bias gradient (a sum over
#: 1024 rows; reads 3.2e-2) and its 8x8 global average pool through the
#: pooling kernel's function (64 cells; reads 2.8e-2). Summing 1024
#: seeded bf16 values so, the JAX package is 5.5e-2 from the exact sum
#: and the port 1.5e-3.
BF16_LAYER_WIDE_SUMS = {("cv2", "dbias"): 5e-2, ("gap", "out0"): 5e-2}


@functools.lru_cache(maxsize=None)
def _bf16_layer_rels(net, fused):
    """Every layer of ``net`` in bfloat16 training mode, in both
    packages, from the same inputs (the node values of the JAX package's
    bf16 training forward from the net's weights, compiled with excess
    precision off) and the same seeded upstream gradient in the layer's
    output dtype; the loss layer's upstream is its loss.
    The port casts its f32 masters inside the graph
    (``Network._cast_tree``), the JAX layer casts them in its apply.
    Returns {(layer, what): relative L2 difference} for ``what`` in
    ``out``, ``dx<i>`` (gradient of input i) and ``d<leaf>`` (gradient
    of an f32 master, which must be f32)."""
    from cxxnet_tpu.layers.base import ApplyCtx as JaxCtx
    from cxxnet_tpu_torch.convert import params_from_jax
    from cxxnet_tpu_torch.graph import build_graph
    from cxxnet_tpu_torch.layers import ApplyCtx
    from cxxnet_tpu_torch.model import Network
    from torch_ibn_fixture import jax_run
    text = NETS[net][0] + f"compute_dtype = bfloat16\nfused_kernels = {fused}\n"
    jcfg = jax_parse(text)
    jnet = JaxNetwork(jax_build_graph(jcfg), jcfg)
    cfg = parse_config_string(text + "dev = cpu\n")
    pnet = Network(build_graph(cfg), cfg)
    assert pnet._act_folded == jnet._act_folded
    p, s = NETS[net][1]()
    pp, ps = params_from_jax(p, s)
    b = _batches(net)[0]
    mask = np.ones((BATCH,), np.float32)
    old = os.environ.get("CXXNET_BN_CLAMP_WARN")
    os.environ["CXXNET_BN_CLAMP_WARN"] = "0"    # no host callback
    try:
        nodes = jax_run(lambda p_, s_, x: jnet.apply(
            p_, s_, x, train=True, capture_nodes=True).nodes,
            p, s, jnp.asarray(b.data))
        rs = np.random.RandomState(5)
        g, rels = jnet.graph, {}
        for li, (spec, jl) in enumerate(zip(g.layers, jnet.layers)):
            if li in jnet._act_folded:
                continue
            name = jl.name
            ins = [nodes[g.node_names[ni]] for ni in spec.nindex_in]
            jctx = JaxCtx(train=True, compute_dtype=jnp.bfloat16,
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
            # the port's layer on the same values
            layer = pnet.layers[li]
            lp = {k: v.clone().requires_grad_(True)
                  for k, v in pp.get(name, {}).items()}
            xs = [torch.from_numpy(np.array(x, np.float32)).to(
                getattr(torch, str(x.dtype))).requires_grad_(True)
                for x in ins]
            ctx = ApplyCtx(compute_dtype=torch.bfloat16, fused=pnet.fused,
                           fuse_act=pnet._fuse_act.get(li), train=True,
                           state_sink={})
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
            f32 = lambda a: np.asarray(a, np.float32)
            for i, (o, to) in enumerate(zip(outs, touts)):
                rels[(name, f"out{i}")] = _rel(f32(to.detach().float()),
                                               f32(o))
            for i, (d, td) in enumerate(zip(dxs, grads[len(lp):])):
                rels[(name, f"dx{i}")] = _rel(f32(td.float()), f32(d))
            for k, d in dlp.items():
                rels[(name, f"d{k}")] = _rel(tlp[name][k], f32(d))
    finally:
        if old is None:
            del os.environ["CXXNET_BN_CLAMP_WARN"]
        else:
            os.environ["CXXNET_BN_CLAMP_WARN"] = old
    return rels


@pytest.mark.parametrize("fused", ["auto", "0"])
@pytest.mark.parametrize("net", ["small", "ibn"])
def test_bf16_layers_backward_like_the_jax_layers(net, fused):
    """Each layer of the net in bfloat16, from the same inputs and
    upstream gradient as the JAX package's layer: output, input
    gradients and the f32 masters' gradients within BF16_LAYER (or
    BF16_LAYER_WIDE_SUMS)."""
    rels = _bf16_layer_rels(net, fused)
    kinds = {what[:2] for _, what in rels}
    assert kinds == {"ou", "dx", "dw", "db"}, kinds
    masters = {"small": 9, "ibn": 2 * (69 + 69 + 1) - 69}[net]
    assert sum(what[:2] in ("dw", "db") for _, what in rels) == masters
    bad = {k: r for k, r in rels.items()
           if not r <= BF16_LAYER_WIDE_SUMS.get(k, BF16_LAYER)}
    assert not bad, bad


def test_bias_gradient_sums_in_f32_where_xla_adds_in_bf16():
    """Why BF16_LAYER_WIDE_SUMS: the gradient of a bf16 bias over 1024
    rows, against its exact sum."""
    from torch_ibn_fixture import jax_run
    x = jnp.asarray(np.random.RandomState(0).randn(16, 8, 8, 16),
                    jnp.bfloat16)
    exact = np.asarray(x, np.float64).sum((0, 1, 2))
    want = jax_run(lambda b, x_: jax.vjp(
        lambda bb: x_ + bb.astype(jnp.bfloat16), b)[1](x_)[0],
        jnp.zeros((16,), jnp.float32), x)
    tb = torch.zeros(16, requires_grad=True)
    tx = torch.from_numpy(np.array(x, np.float32)).to(torch.bfloat16)
    (tx + tb.to(torch.bfloat16)).backward(tx)
    assert _rel(np.asarray(want, np.float64), exact) > 2e-2
    assert _rel(tb.grad.double().numpy(), exact) < 5e-3


def test_trainer_steps_go_through_the_kernel_functions_on_the_cpu():
    """With the kernels selected the training graph holds the kernels'
    autograd functions (their plain versions run on the CPU); with
    fused_kernels = 0 it holds none of them."""
    names = {}
    for fused in ("auto", "0"):
        tr = Trainer(parse_config_string(_cfg("ibn", "float32", fused)))
        tr.init_model(jax_weights())
        b = _batches("ibn")[0]
        loss, _, _ = tr.net.apply(tr.params, tr.net.state,
                                  torch.from_numpy(b.data),
                                  torch.from_numpy(b.label), train=True)
        seen, todo = set(), [loss.grad_fn]
        while todo:
            fn = todo.pop()
            if fn is None or fn in seen:
                continue
            seen.add(fn)
            todo += [f for f, _ in fn.next_functions]
        names[fused] = {type(f).__name__ for f in seen}
    assert {"BnActBackward", "PoolBackward", "BiasActBackward"} \
        <= names["auto"]
    assert not {"BnActBackward", "PoolBackward", "BiasActBackward"} \
        & names["0"]


ROUND_RE = re.compile(r"^round +(\d+):\[\d+ sec\]((\t[a-z]+-[a-z@0-9]+:"
                      r"[0-9.]+)+)$")


def test_main_train_writes_rounds_the_jax_package_resumes(tmp_path, capsys):
    model_dir = tmp_path / "models"
    conf = tmp_path / "ibn.conf"
    shape = NETS["ibn"][2]
    conf.write_text(_cfg("ibn", "float32", "auto")
                    + "data = train\n" + SYNTH.format(n=32, seed=3, shape=shape)
                    + "eval = test\n" + SYNTH.format(n=16, seed=9, shape=shape)
                    + "metric = error\nnum_round = 2\nprint_step = 1\n")
    assert port_main.main([str(conf), "dev=cpu", "task=train",
                           f"model_dir={model_dir}"]) == 0
    out = capsys.readouterr().out.splitlines()
    rounds = [ln for ln in out if ROUND_RE.match(ln)]
    assert [ROUND_RE.match(ln).group(1) for ln in rounds] == ["0", "1"]
    for ln in rounds:
        frags = [f.split(":")[0] for f in ln.split("\t")[1:]]
        assert frags == ["train-rec@1", "train-rec@5", "train-error",
                         "test-rec@1", "test-rec@5", "test-error"], ln
    assert any(re.match(r"^round +1:\[ +2\] \d+ sec elapsed, loss=[0-9.]+, "
                        r"[0-9.]+ images/sec$", ln) for ln in out)
    assert sorted(os.listdir(model_dir)) == ["0000.model", "0001.model"]
    path = str(model_dir / "0001.model")
    blob = jax_ckpt.load_model(path)
    assert blob["meta"]["has_opt"] and blob["meta"]["round"] == 1
    assert blob["meta"]["epoch"] == 4 and blob["meta"]["step_count"] == 4
    assert set(_leafs(blob["opt"]["mom"])) == set(_leafs(blob["params"]))
    # the next step from that round, in both packages
    batch = _batches("ibn", BATCH, 11)[0]
    jtr, step = _jax_step("ibn", "float32")
    jtr.load_model(path)
    assert jtr.epoch_counter == 4
    before = _jax_snap(jtr)
    want_loss = _jax_take_step(jtr, step, batch, jtr.epoch_counter)
    tr = Trainer(parse_config_string(_cfg("ibn", "float32", "auto")))
    tr.load_blob(ckpt.load_model(path))
    assert tr.epoch_counter == 4 and tr.step_count == 4
    tr.update(batch)
    _check_step("float32", 1, tr.last_loss, want_loss, _port_snap(tr),
                before, _jax_snap(jtr))


#: a value that switches on each training key outside this slice
SWITCHED_ON = {
    "continue": "1", "model_in": "/nowhere/0003.model",
    "telemetry_port": "9099",
    "compute_dtype": "float16", "update_period": "2",
    "train_chain": "4", "health": "1", "sentinel": "1",
    "failpoints": "device.step=every:3", "profile_dir": "/nowhere/prof",
    "shard_ckpt": "1", "save_async": "1", "keep_last_n": "3",
    "data_service": "127.0.0.1:9400", "test_io": "1",
    "model_parallel": "2", "seq_parallel": "2", "pipeline_parallel": "2",
    "elastic_dir": "/nowhere/elastic", "telemetry_trace": "/nowhere/t.json",
    "dist_coordinator": "10.0.0.1:1234", "dist_num_proc": "2",
    "dist_rank": "1",
}


def test_every_rejected_key_is_covered():
    assert set(TRAIN_NOT_YET) <= set(SWITCHED_ON)


@pytest.mark.parametrize("key", sorted(SWITCHED_ON))
def test_training_keys_outside_the_slice_name_their_roadmap_item(key):
    base = _cfg("ibn", "float32", "auto")
    with pytest.raises(ConfigError, match=r"ROADMAP Queue .*" + {
            "compute_dtype": "fp16 loss scaler",
            "continue": "continue = 1 and finetune",
            "update_period": "update_period"}.get(key, "")):
        Trainer(parse_config_string(base + f'{key} = "{SWITCHED_ON[key]}"\n'))
    off = {"model_in": "NULL", "compute_dtype": "bfloat16",
           "update_period": "1", "train_chain": "1",
           "model_parallel": "1", "seq_parallel": "1",
           "pipeline_parallel": "1", "dist_num_proc": "1"}.get(
               key, "0" if key not in (
                   "failpoints", "profile_dir", "data_service", "elastic_dir",
                   "telemetry_trace", "dist_coordinator") else "")
    Trainer(parse_config_string(base + f'{key} = "{off}"\n'))


def test_task_finetune_and_batch_tasks_name_their_roadmap_item(tmp_path):
    conf = tmp_path / "ibn.conf"
    conf.write_text(IBN_TEXT)
    for task, item in (("finetune", "finetune"), ("pred", "Queue A 2"),
                       ("extract", "Queue A 2")):
        with pytest.raises(ConfigError, match=item):
            port_main.main([str(conf), "dev=cpu", f"task={task}"])


@pytest.mark.parametrize("name,width", [
    ("error", 1), ("rec@1", 1), ("rec@5", 1), ("rec@5", 3), ("logloss", 1),
    ("logloss", 3), ("rmse", 1)])
def test_metrics_match_the_jax_metrics(name, width):
    from cxxnet_tpu.metrics import MetricSet as JaxMetricSet
    from cxxnet_tpu_torch.metrics import MetricSet
    rs = np.random.RandomState(7)
    pred = rs.rand(40, 10).astype(np.float32)
    pred /= pred.sum(1, keepdims=True)
    label = rs.randint(0, 10, (40, width)).astype(np.float32)
    if name == "logloss" and width > 1:
        label = (label > 4).astype(np.float32)
    got, want = MetricSet(), JaxMetricSet()
    for m in (got, want):
        m.add(name)
        for lo in (0, 25):
            m.add_eval({None: pred[lo:lo + 25]}, {None: label[lo:lo + 25]},
                       {"label": (0, width)})
    assert got.get("test") == want.get("test")


def test_evaluate_scores_the_weights_just_trained():
    """The eval forward's cast weights are dropped after every update:
    an evaluation after a step equals a fresh network loaded with the
    trained weights."""
    from cxxnet_tpu_torch.convert import params_from_jax
    from cxxnet_tpu_torch.model import Network
    cfg = parse_config_string(_cfg("small", "bfloat16", "auto"))
    tr = Trainer(cfg)
    tr.init_model(_small_weights())
    b = _batches("small")[0]
    x = torch.from_numpy(b.data)
    before = tr.net(x).out.clone()
    tr.update(b)
    after = tr.net(x).out
    fresh = Network(tr.graph, cfg)
    fresh.load_weights(*params_from_jax(*params_to_jax(tr.params,
                                                       tr.net.state)))
    assert not torch.equal(before, after)
    assert torch.equal(after, fresh(x).out)


@pytest.mark.parametrize("pairs", [
    [("iter", "imgrec"), ("image_bin", "x.bin"), ("image_list", "x.lst")],
    [("iter", "synthetic"), ("iter", "throttle")],
    [("iter", "synthetic"), ("dist_num_worker", "2")],
    [("iter", "synthetic"), ("data_gen_seed", "3")],
    [("iter", "synthetic"), ("test_skipread", "1")],
], ids=["imgrec", "chain", "dist", "gen_seed", "skipread"])
def test_iterators_outside_the_slice_name_roadmap_a2(pairs):
    with pytest.raises(ConfigError, match="ROADMAP Queue A 2"):
        create_iterator(pairs + [("iter", "end")])


def _update_rels(after_a, after_b, before):
    a, b, p = _leafs(after_a[0]), _leafs(after_b[0]), _leafs(before[0])
    return np.array([_rel(a[k] - p[k], b[k] - p[k]) for k in b])


def test_ibn_gradients_at_init_are_chaotic():
    """Why the Inception-BN comparisons go step by step: a 1e-6 relative
    change of the input moves the port's own float32 step-1 update by
    about 1.5e-2 (median over leaves; up to 5.6e-2), and the JAX
    package's bf16 step differs from its f32 step by a median of 0.87 (up
    to 1.86). Run with ``-s`` to print the measured values."""
    b = _batches("ibn")[0]
    cfg = parse_config_string(_cfg("ibn", "float32", "auto"))
    rs = np.random.RandomState(0)
    snaps = []
    for data in (b.data, (b.data * (1 + 1e-6 * rs.randn(*b.data.shape)))
                 .astype(np.float32)):
        tr = Trainer(cfg)
        tr.init_model(jax_weights())
        tr.update(type(b)(data=data, label=b.label))
        snaps.append(_port_snap(tr))
    before = _jax_trajectory("ibn", "float32")[1][0]
    pert = _update_rels(snaps[1], snaps[0], before)
    s16, s32 = (_jax_trajectory("ibn", d)[1] for d in ("bfloat16",
                                                       "float32"))
    bf16 = _update_rels(s16[1], s32[1], s32[0])
    print(f"1e-6 input change: f32 update rel L2 median "
          f"{np.median(pert):.3g}, worst {pert.max():.3g}; JAX bf16 vs f32 "
          f"step: median {np.median(bf16):.3g}, worst {bf16.max():.3g}")
    assert np.median(pert) > 1e-3 and np.median(bf16) > 0.1
