"""The port's LRN against the JAX package's, on the CPU.

* ``lrn_plain`` / ``lrn_bwd_plain`` and the ``Lrn`` autograd function
  (their CPU path) against ``cxxnet_tpu.ops.fused_lrn.fused_lrn`` and its
  vjp, the Pallas kernels run in interpret mode (``pallas_call`` asserted
  in the jaxpr), at nsize 3, 4 and 5, knorm 1 and 2, in float32 and
  bfloat16, on shapes the JAX gate takes (C 24, and C 7, 33, 34 and 36,
  where the kernels' plan narrows its vector). Both compute in float32 and
  round once; the TPU sums the window as a band matmul, the port adds it
  in ascending order. Tolerance: float32 1e-6 of max|JAX| (readings up to
  1.7e-7), bfloat16 one bf16 ulp of the value (readings: equal).
* Where the JAX gate refuses (C past 1024, a row count no row block
  divides), against the JAX package's ``lrn_reference`` in float32
  (1e-6 of max|JAX|).
* The layer: with the kernels selected it is the ``Lrn`` function; with
  ``fused_kernels = 0`` or ``knorm <= 0`` it runs the JAX layer's unfused
  arithmetic in the node's dtype, held against the JAX layer with the
  fused suite off: float32 1e-6 of max|JAX|; bfloat16, the output
  within one bf16 ulp of the value (readings: equal) and the input
  gradient within a relative L2 difference of 2e-2, the bound of the
  bf16 layer tests of ``test_torch_train.py`` (readings up to 4.2e-3:
  autograd and JAX's vjp of the unfused chain round their bf16 products
  in other orders, up to 8 ulp on single elements).
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
from cxxnet_tpu.ops.fused_lrn import fused_lrn as jax_fused_lrn
from cxxnet_tpu.ops.fused_lrn import lrn_reference
from cxxnet_tpu_torch.config import parse_config_string
from cxxnet_tpu_torch.graph import build_graph
from cxxnet_tpu_torch.layers import ApplyCtx
from cxxnet_tpu_torch.model import Network
from cxxnet_tpu_torch.ops.fused_lrn import (fused_lrn_bwd, fused_lrn_fwd, lrn,
                                            lrn_bwd_plain, lrn_plain,
                                            lrn_takes)

from torch_ibn_fixture import jax_run

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
ALPHA, BETA = 0.01, 0.75


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _t(a, tdt, grad=False):
    return torch.from_numpy(np.array(a, np.float32)).to(tdt) \
        .requires_grad_(grad)


def _close(got, want, dtype):
    """float32: 1e-6 of max|want|; bfloat16: one bf16 ulp of the value."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if dtype == "float32":
        tol = 1e-6 * np.abs(want).max()
    else:
        tol = 2.0 ** -7 * np.abs(want) + 1e-30
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()


def _inputs(shape, jdt, seed=0):
    rs = np.random.RandomState(seed)
    x = jnp.asarray(rs.randn(*shape).astype(np.float32) * 3).astype(jdt)
    dy = jnp.asarray(rs.randn(*shape).astype(np.float32)).astype(jdt)
    return x, dy


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("knorm", [1.0, 2.0])
@pytest.mark.parametrize("nsize", [3, 4, 5])
def test_lrn_plain_matches_the_pallas_kernels(nsize, knorm, dtype):
    jdt, tdt = DTYPES[dtype]
    x, dy = _inputs((2, 4, 4, 24), jdt)                 # 32 rows
    call = lambda a: jax_fused_lrn(a, nsize, ALPHA, BETA, knorm,
                                   interpret=True)
    assert "pallas_call" in str(jax.make_jaxpr(
        lambda a, d: jax.vjp(call, a)[1](d))(x, dy))
    y_j, vjp = jax.vjp(call, x)
    dx_j = vjp(dy)[0]
    xt, dyt = _t(_f32(x), tdt, grad=True), _t(_f32(dy), tdt)
    _close(lrn_plain(xt.detach(), nsize, ALPHA, BETA, knorm).float(),
           _f32(y_j), dtype)
    _close(lrn_bwd_plain(xt.detach(), dyt, nsize, ALPHA, BETA, knorm)
           .float(), _f32(dx_j), dtype)
    y = lrn(xt, nsize, ALPHA, BETA, knorm)
    (dx,) = torch.autograd.grad(y, [xt], dyt)
    assert y.dtype == dx.dtype == tdt
    _close(y.detach().float(), _f32(y_j), dtype)
    _close(dx.float(), _f32(dx_j), dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("c", [7, 33, 34, 36])
def test_lrn_plain_matches_the_pallas_kernels_at_narrow_vectors(c, dtype):
    """C that the kernels' plan takes a vector of 1, 2 or 4 channels for
    (``lrn_plan``), at a row count the JAX gate takes, nsize 4."""
    jdt, tdt = DTYPES[dtype]
    x, dy = _inputs((2, 4, 4, c), jdt, seed=c)
    call = lambda a: jax_fused_lrn(a, 4, ALPHA, BETA, 1.0, interpret=True)
    assert "pallas_call" in str(jax.make_jaxpr(call)(x))
    y_j, vjp = jax.vjp(call, x)
    xt, dyt = _t(_f32(x), tdt), _t(_f32(dy), tdt)
    _close(lrn_plain(xt, 4, ALPHA, BETA, 1.0).float(), _f32(y_j), dtype)
    _close(lrn_bwd_plain(xt, dyt, 4, ALPHA, BETA, 1.0).float(),
           _f32(vjp(dy)[0]), dtype)


@pytest.mark.parametrize("shape", [(1, 1, 7, 7), (1, 1, 3, 1500),
                                   (3, 5, 7, 33)], ids=str)
@pytest.mark.parametrize("nsize", [4, 5])
def test_lrn_plain_takes_what_the_jax_gate_refuses(shape, nsize):
    x, dy = _inputs(shape, jnp.float32, seed=1)
    assert jax_fused_lrn(x, nsize, ALPHA, BETA, 1.0, interpret=True) is None
    ref = lambda a: lrn_reference(a, nsize, ALPHA, BETA, 1.0)
    y_j, vjp = jax.vjp(ref, x)
    xt, dyt = _t(x, torch.float32), _t(dy, torch.float32)
    _close(fused_lrn_fwd(xt, nsize, ALPHA, BETA, 1.0), _f32(y_j), "float32")
    _close(fused_lrn_bwd(xt, dyt, nsize, ALPHA, BETA, 1.0), _f32(vjp(dy)[0]),
           "float32")


def test_lrn_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.randn(2, 3, 3, 8)
    assert lrn_takes(x, 1.0) and not lrn_takes(x, 0.0)
    assert not lrn_takes(x.reshape(18, 8), 1.0)
    with pytest.raises(ValueError, match="knorm"):
        fused_lrn_fwd(x, 5, ALPHA, BETA, 0.0)
    with pytest.raises(ValueError, match="local_size"):
        fused_lrn_fwd(x, 0, ALPHA, BETA, 1.0)
    with pytest.raises(ValueError, match="dy"):
        fused_lrn_bwd(x, x[:1], 5, ALPHA, BETA, 1.0)


LRN_NET = """
netconfig = start
layer[in->o] = lrn:norm
  local_size = {nsize}
  alpha = 0.01
  beta = 0.75
  knorm = {knorm}
netconfig = end
input_shape = 24,4,4
compute_dtype = {dtype}
fused_kernels = {fused}
"""


def _layer_pair(nsize, knorm, dtype, fused):
    text = LRN_NET.format(nsize=nsize, knorm=knorm, dtype=dtype, fused=fused)
    jcfg = jax_parse(text.replace(f"fused_kernels = {fused}",
                                  "fused_kernels = 0"))
    jnet = JaxNetwork(jax_build_graph(jcfg), jcfg)
    cfg = parse_config_string(text + "dev = cpu\n")
    return jnet.layers[0], Network(build_graph(cfg), cfg)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("nsize,knorm", [(5, 1.0), (4, 2.0), (3, 0.0)])
def test_unfused_layer_matches_the_jax_layer(nsize, knorm, dtype):
    """``fused_kernels = 0`` (and ``knorm = 0`` with the kernels on, which
    the kernels do not take): the JAX layer's own arithmetic."""
    jdt, tdt = DTYPES[dtype]
    x, dy = _inputs((2, 4, 4, 24), jdt, seed=2)
    if knorm == 0.0:
        x = x + jnp.asarray(0.5, jdt)          # keep norm > 0 at knorm 0
    jl, pnet = _layer_pair(nsize, knorm, dtype, "auto" if knorm == 0 else 0)
    ctx = JaxCtx(train=True, compute_dtype=jdt, fused=False)
    fj = lambda a: jl.apply({}, {}, [a], ctx)[0][0]
    y_j, vjp = jax_run(lambda a, d: (lambda r: (r[0], r[1](d)[0]))(
        jax.vjp(fj, a)), x, dy)
    layer = pnet.layers[0]
    assert pnet.fused == (knorm == 0.0)
    xt = _t(_f32(x), tdt, grad=True)
    (y,) = layer.forward({}, {}, [xt], ApplyCtx(
        compute_dtype=tdt, fused=pnet.fused, train=True))
    assert y.grad_fn is not None and type(y.grad_fn).__name__ != \
        "LrnBackward"
    (dx,) = torch.autograd.grad(y, [xt], _t(_f32(dy), tdt))
    _close(y.detach().float(), _f32(y_j), dtype)
    if dtype == "float32":
        _close(dx.float(), _f32(vjp), dtype)
    else:
        want = _f32(vjp)
        rel = np.linalg.norm(dx.float().numpy() - want) / np.linalg.norm(want)
        assert rel <= 2e-2, rel


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_fused_layer_runs_the_lrn_function(dtype):
    jdt, tdt = DTYPES[dtype]
    x, dy = _inputs((2, 4, 4, 24), jdt, seed=3)
    jl, pnet = _layer_pair(5, 1.0, dtype, "auto")
    layer = pnet.layers[0]
    xt = _t(_f32(x), tdt, grad=True)
    (y,) = layer.forward({}, {}, [xt], ApplyCtx(compute_dtype=tdt,
                                                fused=True, train=True))
    assert type(y.grad_fn).__name__ == "LrnBackward"
    call = lambda a: jax_fused_lrn(a, 5, 0.01, 0.75, 1.0, interpret=True)
    y_j, vjp = jax.vjp(call, x)
    (dx,) = torch.autograd.grad(y, [xt], _t(_f32(dy), tdt))
    _close(y.detach().float(), _f32(y_j), dtype)
    _close(dx.float(), _f32(vjp(dy)[0]), dtype)
