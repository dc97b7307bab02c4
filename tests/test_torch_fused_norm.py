"""The port's batch-norm kernels' plain versions against the JAX
package's Pallas BN kernels (``cxxnet_tpu/ops/fused_norm.py``).

Forward: ``bn_act_plain`` (what ``csrc/bn_fwd.cu`` computes) against
``fused_bn_act(..., interpret=True)``; backward: the port's ``BnAct``
autograd function on the CPU (the plain formula of ``csrc/bn_bwd.cu``)
against ``jax.vjp`` of the same Pallas call. Each Pallas case asserts
``pallas_call`` in its jaxpr; their row counts (16, 32 and 16*7*7) are
multiples of the 16 rows the JAX gate needs for bf16. Row counts it
refuses, such as 4*7*7, are held against the JAX package's jnp
definition ``bn_act_reference`` (port only: the card's kernels take
any N).

Tolerances:
* float32: y, mean and var atol 1e-5; dx atol 1e-5 plus rtol 1e-5;
  dgamma and dbeta rtol 1e-4 (atol 1e-4 where a sum cancels).
* bfloat16: y and dx within one bf16 ulp of the reference value
  (both sides round f32 values that differ in the last f32 bits),
  plus 1e-5 absolute for that f32 noise near 0; the reference for y is
  the same kernel run in f32 on the bf16 input. dgamma and dbeta are
  f32 sums of the same products: as float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cxxnet_tpu.ops.fused_norm import bn_act_reference
from cxxnet_tpu.ops.fused_norm import fused_bn_act as jax_bn_act
from cxxnet_tpu_torch.ops.fused import row_blocks
from cxxnet_tpu_torch.ops.fused_norm import (bn_act_plain, bn_bwd_plain,
                                             fused_bn_act)

EPS = 1e-5
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SHAPES = [(16, 1, 1, 8), (2, 4, 4, 24), (16, 7, 7, 64)]


def _inputs(shape, seed=0):
    rs = np.random.RandomState(seed)
    c = shape[-1]
    x = (rs.randn(*shape) * 1.5 + 0.3).astype(np.float32)
    gamma = (1.0 + 0.2 * rs.randn(c)).astype(np.float32)
    beta = (0.1 * rs.randn(c)).astype(np.float32)
    dy = rs.randn(*shape).astype(np.float32)
    return x, gamma, beta, dy


def _cast(a, jdt):
    """``a`` rounded to ``jdt`` and back to float32 numpy."""
    return np.asarray(jnp.asarray(a).astype(jdt).astype(jnp.float32))


def _t(a, tdt, grad=False):
    return torch.from_numpy(np.array(a, np.float32)).to(tdt) \
        .requires_grad_(grad)


def _np(t):
    return t.detach().float().numpy()


def _within_bf16_ulp(got, want, atol=1e-5):
    """|got - want| <= one bf16 ulp of the larger magnitude + atol."""
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.where(mag > 0, 2.0 ** (np.floor(np.log2(np.maximum(
        mag, 1e-30))) - 7), 0.0)
    err = np.abs(got - want)
    assert (err <= ulp + atol).all(), (err - ulp).max()


def _jax_call(act, two_pass):
    return lambda a, g, b: jax_bn_act(a, g, b, EPS, act, two_pass,
                                      interpret=True)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("two_pass", [False, True])
@pytest.mark.parametrize("act", ["none", "relu"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_bn_forward_plain_matches_jax_kernel(shape, act, two_pass, dtype):
    jdt, tdt = DTYPES[dtype]
    x, gamma, beta, _ = _inputs(shape)
    xj = jnp.asarray(x).astype(jdt)
    call = _jax_call(act, two_pass)
    assert "pallas_call" in str(jax.make_jaxpr(call)(xj, gamma, beta))
    y_j, mean_j, var_j = call(xj, gamma, beta)
    y, mean, var = bn_act_plain(_t(_cast(x, jdt), tdt), _t(gamma, torch.float32),
                                _t(beta, torch.float32), EPS, act, two_pass)
    assert y.dtype == tdt and mean.dtype == var.dtype == torch.float32
    np.testing.assert_allclose(_np(mean), np.asarray(mean_j), atol=1e-5)
    np.testing.assert_allclose(_np(var), np.asarray(var_j), atol=1e-5)
    if dtype == "float32":
        np.testing.assert_allclose(_np(y), np.asarray(y_j), atol=1e-5)
    else:
        y32 = np.asarray(call(xj.astype(jnp.float32), gamma, beta)[0])
        _within_bf16_ulp(_np(y), y32)
        _within_bf16_ulp(np.asarray(y_j.astype(jnp.float32)), y32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("two_pass", [False, True])
@pytest.mark.parametrize("act", ["none", "relu"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_bn_backward_matches_jax_vjp(shape, act, two_pass, dtype):
    jdt, tdt = DTYPES[dtype]
    x, gamma, beta, dy = _inputs(shape, seed=1)
    xj, dyj = jnp.asarray(x).astype(jdt), jnp.asarray(dy).astype(jdt)
    call = _jax_call(act, two_pass)
    (y_j, mean_j, var_j), vjp = jax.vjp(call, xj, jnp.asarray(gamma),
                                        jnp.asarray(beta))
    dx_j, dg_j, db_j = vjp((dyj, jnp.zeros_like(mean_j),
                            jnp.zeros_like(var_j)))
    xt = _t(_cast(x, jdt), tdt, grad=True)
    gt = _t(gamma, torch.float32, grad=True)
    bt = _t(beta, torch.float32, grad=True)
    y, mean, var = fused_bn_act(xt, gt, bt, EPS, act, two_pass)
    assert not mean.requires_grad and not var.requires_grad
    dx, dg, db = torch.autograd.grad(y, [xt, gt, bt],
                                     _t(_cast(dy, jdt), tdt))
    assert dx.dtype == tdt and dg.dtype == db.dtype == torch.float32
    np.testing.assert_allclose(_np(dg), np.asarray(dg_j), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(_np(db), np.asarray(db_j), rtol=1e-4,
                               atol=1e-4)
    if dtype == "float32":
        np.testing.assert_allclose(_np(dx), np.asarray(dx_j), rtol=1e-5,
                                   atol=1e-5)
    else:
        _within_bf16_ulp(_np(dx), np.asarray(dx_j.astype(jnp.float32)))


@pytest.mark.parametrize("two_pass", [False, True])
@pytest.mark.parametrize("act", ["none", "relu"])
@pytest.mark.parametrize("shape", [(4, 7, 7, 8), (13, 1, 1, 24)],
                         ids=["4x7x7x8", "13x1x1x24"])
def test_bn_rows_the_jax_gate_refuses_match_the_jnp_definition(
        shape, act, two_pass):
    """N = 196 and 13, not multiples of 16: the Pallas gate falls back,
    the port's kernels take them. float32 forward and backward against
    ``bn_act_reference`` and its jax.vjp (autodiff through the moments
    gives the backward kernel's formula)."""
    x, gamma, beta, dy = _inputs(shape, seed=2)
    ref = lambda a, g, b: bn_act_reference(a, g, b, EPS, act, two_pass)
    assert jax_bn_act(jnp.asarray(x).astype(jnp.bfloat16), gamma, beta,
                      EPS, act, two_pass, interpret=True) is None
    (y_j, mean_j, var_j), vjp = jax.vjp(ref, jnp.asarray(x),
                                        jnp.asarray(gamma), jnp.asarray(beta))
    dx_j, dg_j, db_j = vjp((jnp.asarray(dy), jnp.zeros_like(mean_j),
                            jnp.zeros_like(var_j)))
    xt, gt, bt = (_t(a, torch.float32, grad=True) for a in (x, gamma, beta))
    y, mean, var = fused_bn_act(xt, gt, bt, EPS, act, two_pass)
    np.testing.assert_allclose(_np(y), np.asarray(y_j), atol=1e-5)
    np.testing.assert_allclose(_np(mean), np.asarray(mean_j), atol=1e-5)
    np.testing.assert_allclose(_np(var), np.asarray(var_j), atol=1e-5)
    dx, dg, db = torch.autograd.grad(y, [xt, gt, bt], _t(dy, torch.float32))
    np.testing.assert_allclose(_np(dx), np.asarray(dx_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(_np(dg), np.asarray(dg_j), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(_np(db), np.asarray(db_j), rtol=1e-4,
                               atol=1e-4)


def test_bn_backward_plain_masks_by_the_forward_output():
    """With relu, rows whose y is 0 pass no gradient into the sums."""
    x, gamma, beta, dy = _inputs((32, 1, 1, 4), seed=3)
    x2, dy2 = torch.from_numpy(x.reshape(32, 4)), torch.from_numpy(
        dy.reshape(32, 4))
    g = torch.from_numpy(gamma)
    y, mean, var = bn_act_plain(x2, g, torch.from_numpy(beta), EPS, "relu")
    rstd = torch.rsqrt(var + EPS)
    _, dg, db = bn_bwd_plain(x2, dy2, y, g, mean, rstd)
    keep = (y > 0).float()
    np.testing.assert_allclose(db.numpy(), (dy2 * keep).sum(0).numpy(),
                               rtol=1e-6, atol=1e-6)
    assert bool((dg != bn_bwd_plain(x2, dy2, None, g, mean, rstd)[1]).any())


@pytest.mark.parametrize("n,c,want", [(16, 8, 1), (128 * 112 * 112, 64, 528),
                                      (128 * 7 * 7, 1024, 33),
                                      (128, 1000, 2)])
def test_row_blocks_fill_the_card_and_keep_64_rows(n, c, want):
    assert row_blocks(n, c) == want


NO_MA_NET = """
netconfig = start
layer[in->c] = conv:cv
  kernel_size = 3
  nchannel = 16
  pad = 1
  no_bias = 1
layer[c->b] = batch_norm_no_ma:bn
layer[b->r] = relu:ac
layer[r->f] = flatten:fl
layer[f->o] = fullc:fc
  nhidden = 5
layer[o->o] = softmax:sm
netconfig = end
input_shape = 4,4,4
batch_size = 4
fused_kernels = 1
"""


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_batch_norm_no_ma_eval_matches_the_jax_fused_eval(dtype):
    """batch_norm_no_ma at eval with the kernels selected: the JAX
    package runs the Pallas BN forward (asserted in the jaxpr), the port
    its plain version on the CPU (the forward kernel on the card).
    Softmax outputs atol 1e-5 (f32) and 1e-2 (bf16, the JAX side
    compiled without excess precision)."""
    from cxxnet_tpu.config import parse_config_string as jparse
    from cxxnet_tpu.graph import build_graph as jbuild
    from cxxnet_tpu.model import Network as JNetwork
    from cxxnet_tpu_torch.config import parse_config_string
    from cxxnet_tpu_torch.convert import params_from_jax
    from cxxnet_tpu_torch.graph import build_graph
    from cxxnet_tpu_torch.model import Network
    from torch_ibn_fixture import jax_run
    text = NO_MA_NET + f"compute_dtype = {dtype}\n"
    jcfg = jparse(text)
    jnet = JNetwork(jbuild(jcfg), jcfg)
    params, state = jnet.init(jax.random.PRNGKey(0))
    x = np.random.RandomState(4).randn(4, 4, 4, 4).astype(np.float32)
    fwd = lambda p, s, d: jnet.apply(p, s, d, train=False).out
    assert "pallas_call" in str(jax.make_jaxpr(fwd)(params, state, x))
    want = np.asarray(jax_run(fwd, params, state, x), np.float32)
    cfg = parse_config_string(text + "dev = cpu\n")
    net = Network(build_graph(cfg), cfg)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    net.load_weights(*params_from_jax(to_np(params), to_np(state)))
    got = net(torch.from_numpy(x)).out.float().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 if dtype == "float32"
                               else 1e-2)


def test_plain_training_warns_once_when_the_variance_clamps(capsys):
    """fused_kernels = 0: a large-mean, low-variance channel drives the
    one-pass moment below -eps; the layer warns once, like the JAX
    package's host callback."""
    from cxxnet_tpu_torch.config import parse_config_string
    from cxxnet_tpu_torch.graph import build_graph
    from cxxnet_tpu_torch.model import Network
    cfg = parse_config_string("""
netconfig = start
layer[in->b] = batch_norm:bn
layer[b->f] = flatten:fl
layer[f->o] = fullc:fc
  nhidden = 3
layer[o->o] = softmax:sm
netconfig = end
input_shape = 4,4,4
fused_kernels = 0
dev = cpu
""")
    net = Network(build_graph(cfg), cfg)
    net.load_weights(*net.init(torch.Generator().manual_seed(0)))
    x = torch.from_numpy((3000.0 + 1e-3 * np.random.RandomState(0).randn(
        8, 4, 4, 4)).astype(np.float32))
    for _ in range(2):
        net.apply(net.params, net.state, x, train=True)
    out = capsys.readouterr().out
    assert out.count("WARNING batch_norm 'bn': one-pass variance") == 1
