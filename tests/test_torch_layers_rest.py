"""The layers of the grammar slice against the JAX package's, on the CPU.

Each case builds one layer from the same netconfig in both packages,
carries the JAX layer's initial parameters across (``convert``), runs a
training forward on the same seeded input with the JAX layer's draws
(``torch_convnet_fixture.JaxDraws``, the JAX key handed to the port),
and holds the output, the input gradient and every parameter gradient
against the JAX layer's (``jax.vjp``) in float32 within 1e-5 absolute
and relative (only the order of sums may differ: fixconn's product).
The cases: ``bias`` (a flat node), ``prelu`` (a conv node with the
train-time slope noise ``random = 0.3``, and a flat node), ``fixconn``
(its ``rows cols`` file, from a conv node and a flat one), ``maxout``
(a conv node's channels, a flat node's features, a node with ties),
``pairtest-conv-conv`` (the master's output, ``diff`` 0 with the
mirrored params, the slave's params unchanged) and the training pick
of ``insanity_max_pooling`` (3x3 windows, stride 2, a padded edge
window). The eval forwards are held the same way. A ``plugin`` layer
from a torch-only module (``tests/torch_plugin_layer.py``) trains a
step of a net through the port's trainer and its gradients are the
analytic ones; a class that is not a port ``Layer`` raises. A round of
a net of bias, prelu, maxout, fixconn and a pairtest moves between the
packages both ways leaf for leaf, and PTQ quantizes its fullc only in
both (the new layers stay float32 under ``serve_dtype = int8``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cxxnet_tpu.config import parse_config_string as jax_parse
from cxxnet_tpu.graph import build_graph as jax_build_graph
from cxxnet_tpu.layers.base import ApplyCtx as JaxCtx
from cxxnet_tpu.model import Network as JaxNetwork
from cxxnet_tpu_torch.config import parse_config_string
from cxxnet_tpu_torch.convert import params_from_jax, params_to_jax
from cxxnet_tpu_torch.graph import build_graph
from cxxnet_tpu_torch.layers import ApplyCtx
from cxxnet_tpu_torch.model import Network

from torch_convnet_fixture import JaxDraws

TOL = dict(rtol=1e-5, atol=1e-5)

ONE_LAYER = """
netconfig = start
layer[in->o] = {kind}:ly
{keys}
netconfig = end
input_shape = {shape}
"""

#: case -> (layer type, keys, input shape (c, y, x))
CASES = {
    "bias": ("bias", "  init_bias = 0.5", (1, 1, 12)),
    "prelu-conv-noise": ("prelu", "  random = 0.3\n  random_slope = 1",
                         (4, 6, 6)),
    "prelu-flat": ("prelu", "  init_slope = 0.3", (1, 1, 10)),
    "fixconn-conv": ("fixconn", "  weight_file = {wfile}", (2, 3, 2)),
    "fixconn-flat": ("fixconn", "  weight_file = {wfile}", (1, 1, 12)),
    "maxout-conv": ("maxout", "  num_piece = 3", (6, 5, 5)),
    "maxout-flat": ("maxout", "  num_piece = 4", (1, 1, 12)),
    "maxout-ties": ("maxout", "  num_piece = 2", (1, 1, 8)),
    "pairtest-conv-conv": ("pairtest-conv-conv",
                           "  nchannel = 4\n  kernel_size = 3\n  pad = 1",
                           (3, 6, 6)),
    "insanity_max_pooling": ("insanity_max_pooling",
                             "  kernel_size = 3\n  stride = 2", (4, 8, 8)),
}


def _wfile(tmp_path):
    rs = np.random.RandomState(5)
    w = rs.randn(12, 5).astype(np.float32)
    path = tmp_path / "fix.txt"
    # one line: the header, then the entries (np.loadtxt's 1-D case)
    path.write_text("12 5 " + " ".join(repr(float(v)) for v in w.ravel())
                    + "\n")
    return str(path), w


def _build(case, tmp_path):
    kind, keys, shape = CASES[case]
    wfile, w = _wfile(tmp_path)
    text = ONE_LAYER.format(kind=kind, keys=keys.format(wfile=wfile),
                            shape=",".join(map(str, shape)))
    jcfg = jax_parse(text)
    cfg = parse_config_string(text + "dev = cpu\n")
    jnet = JaxNetwork(jax_build_graph(jcfg), jcfg)
    net = Network(build_graph(cfg), cfg)
    return jnet, net, shape, w


def _x(shape, case, rs):
    c, y, x = shape
    nhwc = (3, 1, 1, x) if (c == 1 and y == 1) else (3, y, x, c)
    a = rs.randn(*nhwc).astype(np.float32)
    if case == "maxout-ties":
        a[..., 1::2] = a[..., 0::2]           # every pair tied
    return a


def _run(case, tmp_path, train=True):
    """(JAX out, dx, dparams, state), (port out, dx, dparams in the JAX
    layout, state sink) of one forward and backward."""
    jnet, net, shape, _ = _build(case, tmp_path)
    jl, pl = jnet.layers[0], net.layers[0]
    jparams, jstate = jnet.init(jax.random.PRNGKey(3))
    jp, js = jparams.get("ly", {}), jstate.get("ly", {})
    rs = np.random.RandomState(11)
    x = _x(shape, case, rs)
    key = jax.random.PRNGKey(7)
    ctx = JaxCtx(train=train, rng=key, compute_dtype=jnp.float32)

    def fj(p, a):
        outs, st = jl.apply(p, js, [a], ctx)
        return outs[0], st
    yj, vjp, sj = jax.vjp(fj, jp, jnp.asarray(x), has_aux=True)
    dy = rs.randn(*yj.shape).astype(np.float32)
    dpj, dxj = vjp(jnp.asarray(dy))
    np_tree = jax.tree_util.tree_map(np.asarray, {"ly": jp})
    pp, ps = params_from_jax(np_tree, jax.tree_util.tree_map(
        np.asarray, {"ly": js} if js else {}))
    flat = []

    def grads_on(t):
        if isinstance(t, dict):
            return {k: grads_on(v) for k, v in t.items()}
        t.requires_grad_(True)
        flat.append(t)
        return t
    lp = grads_on(pp["ly"])
    xt = torch.from_numpy(x).requires_grad_(True)
    sink = {}
    (y,) = pl.forward(pl.cast_params(lp, torch.float32), ps.get("ly", {}),
                      [xt], ApplyCtx(compute_dtype=torch.float32,
                                     train=train, state_sink=sink,
                                     draws=JaxDraws(key)))
    gs = torch.autograd.grad(y, [xt] + flat, torch.from_numpy(dy),
                             allow_unused=True)
    got = {}
    it = iter(gs[1:])

    def back(t):
        if isinstance(t, dict):
            return {k: back(v) for k, v in t.items()}
        g = next(it)
        return torch.zeros_like(t) if g is None else g
    got = params_to_jax({"ly": back(lp)}, {})[0]["ly"] if flat else {}
    return ((np.asarray(yj), np.asarray(dxj),
             jax.tree_util.tree_map(np.asarray, dpj), sj),
            (y.detach().numpy(), gs[0].numpy(), got, sink))


def _close_tree(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b), (sorted(a), sorted(b))
        for k in a:
            _close_tree(a[k], b[k])
        return
    np.testing.assert_allclose(b, a, **TOL)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_layer_matches_the_jax_layer(case, train, tmp_path):
    (yj, dxj, dpj, sj), (y, dx, dp, sink) = _run(case, tmp_path, train)
    assert y.shape == yj.shape
    np.testing.assert_allclose(y, yj, **TOL)
    np.testing.assert_allclose(dx, dxj, **TOL)
    _close_tree(dpj, dp)
    if case.startswith("pairtest") and train:
        assert float(sj["diff"]) == 0.0
        assert float(sink["ly"]["diff"]) == 0.0
    if case == "insanity_max_pooling" and train:
        # the pick is random, not the max: some windows differ from it
        jnet, net, _, _ = _build(case, tmp_path)
        assert not np.allclose(y, _run(case, tmp_path, False)[1][0])


def test_fixconn_is_a_buffer_and_checks_its_rows(tmp_path):
    """fixconn's matrix is the file's (no parameter), on the node's
    device; an input of another size raises the JAX message."""
    jnet, net, _, w = _build("fixconn-flat", tmp_path)
    params, _ = net.init(torch.Generator())
    assert "ly" not in params
    np.testing.assert_array_equal(net.layers[0]._wmat, w)
    wfile, _ = _wfile(tmp_path)
    text = ONE_LAYER.format(kind="fixconn", keys=f"  weight_file = {wfile}",
                            shape="1,1,11")
    cfg = parse_config_string(text + "dev = cpu\n")
    with pytest.raises(ValueError, match="does not match weight rows 12"):
        Network(build_graph(cfg), cfg)


PLUGIN_NET = """
data = train
iter = synthetic
  num_inst = 32
  num_class = 3
  input_shape = 1,1,6
iter = end
netconfig = start
layer[+1:sc] = plugin:sc
  plugin_module = torch_plugin_layer
  plugin_layer = {cls}
  init_scale = 2
layer[+1:fc1] = fullc:fc1
  nhidden = 3
layer[+0] = softmax
netconfig = end
input_shape = 1,1,6
batch_size = 16
dev = cpu
eta = 0.1
"""


def test_plugin_layer_from_a_torch_module_trains():
    """``plugin_module``/``plugin_layer`` build a user layer of the port:
    its keys reach ``set_param``, its params join the tree, and a
    trainer step's gradients of them are the analytic ones (the fullc's
    input gradient times x, summed over the batch)."""
    from cxxnet_tpu_torch.config import split_sections
    from cxxnet_tpu_torch.io import create_iterator
    from cxxnet_tpu_torch.trainer import Trainer
    cfg = parse_config_string(PLUGIN_NET.format(cls="ScaleShift"))
    glob, sections = split_sections(cfg)
    tr = Trainer(glob)
    tr.init_model()
    assert tr.get_weight("sc", "scale").tolist() == [2.0] * 6
    it = create_iterator(glob + sections[0][2])
    batch = next(iter(it))
    loss, _, _, g = tr.gradients(batch)
    x = torch.from_numpy(np.asarray(batch.data)).reshape(16, 6)
    xs = (x * tr.params["sc"]["scale"] + tr.params["sc"]["shift"]).detach()
    xs.requires_grad_(True)
    wmat = tr.params["fc1"]["wmat"].detach()
    logits = xs @ wmat + tr.params["fc1"]["bias"].detach()
    lab = torch.from_numpy(np.asarray(batch.label)[:, 0]).long()
    ref = torch.nn.functional.cross_entropy(logits, lab, reduction="sum") / 16
    (dxs,) = torch.autograd.grad(ref, [xs])
    np.testing.assert_allclose(g["sc"]["shift"].numpy(),
                               dxs.sum(0).numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(g["sc"]["scale"].numpy(),
                               (dxs * x).sum(0).numpy(), rtol=1e-5,
                               atol=1e-6)
    tr.update(batch)
    assert np.isfinite(tr.last_loss)
    bad = parse_config_string(PLUGIN_NET.format(cls="NotALayer"))
    with pytest.raises(ValueError, match="not a cxxnet_tpu_torch.layers.Layer"):
        Trainer(split_sections(bad)[0])


MIXED = """
netconfig = start
layer[in->b] = bias:b1
layer[b->p] = prelu:p1
layer[p->m] = maxout:m1
  num_piece = 2
layer[m->f] = fixconn:fx
  weight_file = {wfile}
layer[f->t] = pairtest-fullc-fullc:pt
  nhidden = 4
layer[t->o] = fullc:fc
  nhidden = 3
layer[+0] = softmax
netconfig = end
input_shape = 1,1,24
batch_size = 4
dev = cpu:0
"""


def test_rounds_with_the_new_layers_load_in_both_packages(tmp_path):
    """A round of a net with bias, prelu, maxout, fixconn and a pairtest
    written by the port loads in the JAX package (pairtest's
    master/slave params, prelu's slope, bias's vector) and one the JAX
    package writes loads in the port, leaf for leaf, and both forwards
    agree on it (the JAX one from its fresh layer state: the JAX pairtest
    cannot run on a reloaded state, a reference quirk); PTQ quantizes the fullc layers only in both packages
    (``QUANT_LAYER_TYPES``), the new layers pass through untouched."""
    from cxxnet_tpu import checkpoint as jax_ckpt
    from cxxnet_tpu.quant.ptq import quantizable_layers as jax_quantizable
    from cxxnet_tpu.trainer import Trainer as JaxTrainer
    from cxxnet_tpu_torch.optim import leaves
    from cxxnet_tpu_torch.quant.ptq import quantizable_layers, quantize_params
    from cxxnet_tpu_torch.trainer import Trainer
    wfile, _ = _wfile(tmp_path)
    text = MIXED.format(wfile=wfile)
    tr = Trainer(parse_config_string(text))
    tr.init_model()
    path = str(tmp_path / "0000.model")
    tr.save_model(path)
    blob = jax_ckpt.load_model(path)
    assert blob["params"]["pt"]["master"]["wmat"].shape == (5, 4)
    assert blob["params"]["p1"]["bias"].shape == (24,)
    assert blob["params"]["b1"]["bias"].shape == (24,)
    jtr = JaxTrainer(jax_parse(text))
    jtr.init_model()
    fresh_state = jtr.net_state
    jtr.load_model(path)
    mine = dict(leaves(params_to_jax(tr.params, {})[0]))
    theirs = dict(leaves(jax.tree_util.tree_map(np.asarray, jtr.params)))
    assert set(mine) == set(theirs)
    for p, v in mine.items():
        np.testing.assert_array_equal(v, theirs[p])
    x = np.random.RandomState(2).randn(4, 1, 1, 24).astype(np.float32)
    # a reference quirk: a round keeps no empty subtree, so pairtest's
    # reloaded state lacks "master" and "slave" and the JAX layer's
    # apply raises on it (its own rounds too); the port's takes it
    with pytest.raises(KeyError, match="master"):
        jtr.net.apply(jtr.params, jtr.net_state, jnp.asarray(x))
    want = np.asarray(jtr.net.apply(jtr.params, fresh_state,
                                    jnp.asarray(x)).out)
    jpath = str(tmp_path / "0001.model")
    jtr.save_model(jpath)
    back = Trainer(parse_config_string(text))
    back.load_model(jpath)
    got = back.net(torch.from_numpy(x)).out.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert quantizable_layers(back.net) == jax_quantizable(jtr.net) == {
        "fc": "t"}
    q, drift = quantize_params(params_to_jax(back.params, {})[0],
                               {"fc": 1.0})
    assert set(drift) == {"fc"} and q["fc"]["wmat"].dtype == np.int8
    for name in ("b1", "p1", "pt"):
        assert all(v.dtype == np.float32 for _, v in leaves(q[name]))
