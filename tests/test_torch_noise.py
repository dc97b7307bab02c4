"""The port's drawing layers (dropout, insanity) and xelu against the JAX
package's, and the port's draws on their own, on the CPU.

* Layer level: each layer is held against the JAX layer given the same
  draws, the JAX layer's own mask or slopes handed to the port through
  its draw source (``torch_convnet_fixture.JaxDraws``), in float32 and
  bfloat16, training forward and gradient, and eval: equal (both round
  the same operations in the node's dtype). The JAX layers run eagerly,
  operation by operation, as the program is written: XLA's compiler
  turns dropout's ``x / pkeep`` into a product with the float32
  reciprocal of ``pkeep`` (at pkeep 0.7, 9.3% of float32 elements then
  differ from the division by one ulp); the port divides, as the JAX
  program says. Insanity's int32 ``step``
  state advances by one per training forward in both; with
  ``calm_start``/``calm_end`` annealing the bounds move with it.
* The draws (``layers.base.Draws``): the keep fraction within 4 sigma of
  1 - threshold; insanity's slopes inside [lb, ub) in float32; the same
  (seed, step, layer) gives the same draw, another step or layer
  another; a forward recomputed in the backward by
  ``torch.utils.checkpoint`` draws the same mask; and a trainer resumed
  from a round draws what the unbroken run drew.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from cxxnet_tpu.config import parse_config_string as jax_parse
from cxxnet_tpu.graph import build_graph as jax_build_graph
from cxxnet_tpu.layers.base import ApplyCtx as JaxCtx
from cxxnet_tpu.model import Network as JaxNetwork
from cxxnet_tpu_torch import checkpoint as ckpt
from cxxnet_tpu_torch.config import parse_config_string
from cxxnet_tpu_torch.graph import build_graph
from cxxnet_tpu_torch.io import create_iterator
from cxxnet_tpu_torch.layers import ApplyCtx
from cxxnet_tpu_torch.layers.base import Draws
from cxxnet_tpu_torch.model import Network
from cxxnet_tpu_torch.trainer import Trainer

from torch_convnet_fixture import JaxDraws

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}

ONE_LAYER = """
netconfig = start
layer[in->o] = {kind}:ly
{keys}
netconfig = end
input_shape = 4,6,6
compute_dtype = {dtype}
"""


def _layers(kind, keys, dtype):
    text = ONE_LAYER.format(kind=kind, keys=keys, dtype=dtype)
    jcfg = jax_parse(text)
    cfg = parse_config_string(text + "dev = cpu\n")
    return (JaxNetwork(jax_build_graph(jcfg), jcfg).layers[0],
            Network(build_graph(cfg), cfg).layers[0])


def _f32(a):
    return np.array(jnp.asarray(a).astype(jnp.float32))


def _run_both(kind, keys, dtype, train, state=None, seed=0):
    """The JAX layer and the port's on the same input, key 7's draws and
    upstream gradient: (JAX out, JAX dx, JAX state, port out, port dx,
    port state sink)."""
    jdt, tdt = DTYPES[dtype]
    jl, pl = _layers(kind, keys, dtype)
    rs = np.random.RandomState(seed)
    x = jnp.asarray(rs.randn(3, 6, 6, 4).astype(np.float32)).astype(jdt)
    dy = jnp.asarray(rs.randn(3, 6, 6, 4).astype(np.float32)).astype(jdt)
    key = jax.random.PRNGKey(7)
    st = {} if state is None else {"step": jnp.asarray(state, jnp.int32)}
    ctx = JaxCtx(train=train, rng=key, compute_dtype=jdt)

    def fj(a):
        outs, s = jl.apply({}, st, [a], ctx)
        return outs[0], s
    yj, sj = fj(x)
    dxj = jax.vjp(lambda b: fj(b)[0], x)[1](dy.astype(yj.dtype))[0]
    xt = torch.from_numpy(_f32(x)).to(tdt).requires_grad_(True)
    sink = {}
    pst = {} if state is None else {"step": torch.tensor(state,
                                                         dtype=torch.int32)}
    (y,) = pl.forward({}, pst, [xt], ApplyCtx(
        compute_dtype=tdt, train=train, state_sink=sink,
        draws=JaxDraws(key)))
    (dx,) = torch.autograd.grad(y, [xt], torch.from_numpy(_f32(dy)).to(
        y.dtype))
    return yj, dxj, sj, y, dx, sink


def _equal(t, a):
    np.testing.assert_array_equal(t.detach().float().numpy(), _f32(a))


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_dropout_matches_the_jax_layer_given_its_mask(dtype, train):
    yj, dxj, _, y, dx, _ = _run_both("dropout", "  threshold = 0.3",
                                     dtype, train)
    assert y.dtype == DTYPES[dtype][1]
    _equal(y, yj)
    _equal(dx, dxj)
    if train:
        kept = (y != 0).float().mean().item()
        assert 0.5 < kept < 0.9


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_insanity_matches_the_jax_layer_given_its_slopes(dtype, train):
    yj, dxj, sj, y, dx, sink = _run_both(
        "insanity", "  lb = 3\n  ub = 8", dtype, train, state=4)
    assert y.dtype == DTYPES[dtype][1]
    _equal(y, yj)
    _equal(dx, dxj)
    if train:
        assert int(sj["step"]) == 5 and sink["ly"]["step"].item() == 5
        assert sink["ly"]["step"].dtype == torch.int32
    else:
        assert sink == {}


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("step", [0, 5, 12])
def test_insanity_annealing_matches_the_jax_layer(step, train):
    """calm_start 2, calm_end 10: the bounds move from (3, 8) toward their
    midpoint; in bfloat16 the float32 bounds make a training output
    float32, as the JAX package's type promotion does."""
    keys = "  lb = 3\n  ub = 8\n  calm_start = 2\n  calm_end = 10"
    for dtype in sorted(DTYPES):
        yj, dxj, sj, y, dx, _ = _run_both("insanity", keys, dtype, train,
                                          state=step, seed=1)
        assert str(y.dtype)[6:] == str(yj.dtype)
        np.testing.assert_allclose(y.detach().float().numpy(), _f32(yj),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(dx.float().numpy(), _f32(dxj), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_xelu_matches_the_jax_layer(dtype):
    yj, dxj, _, y, dx, _ = _run_both("xelu", "  b = 3", dtype, True)
    _equal(y, yj)
    _equal(dx, dxj)


def test_keep_fraction_is_one_minus_threshold():
    n, pkeep = 400_000, 0.7
    kept = Draws(0, 0, 3, "cpu").keep_mask((n,), pkeep).double().mean()
    sigma = (pkeep * (1 - pkeep) / n) ** 0.5
    assert abs(kept.item() - pkeep) < 4 * sigma


def test_insanity_slopes_lie_in_lb_ub():
    _, layer = _layers("insanity", "  lb = 3\n  ub = 8", "float32")
    x = -torch.ones(20, 6, 6, 4)
    (y,) = layer.forward({}, {"step": torch.tensor(0, dtype=torch.int32)},
                         [x], ApplyCtx(train=True, state_sink={},
                                       draws=Draws(1, 2, 0, "cpu")))
    u = Draws(1, 2, 0, "cpu").uniform(x.shape, torch.float32)
    slope = u * 5.0 + 3.0
    assert 0.0 <= u.min() and u.max() < 1.0
    assert 3.0 <= slope.min() and slope.max() < 8.0
    torch.testing.assert_close(y, x / slope, rtol=0, atol=0)
    assert slope.std() > 1.0                   # spread over the range


def test_same_seed_step_layer_draws_the_same():
    d = lambda *a: Draws(*a, device="cpu").keep_mask((4096,), 0.5)
    assert torch.equal(d(3, 10, 2), d(3, 10, 2))
    assert not torch.equal(d(3, 10, 2), d(3, 11, 2))
    assert not torch.equal(d(3, 10, 2), d(3, 10, 4))
    assert not torch.equal(d(3, 10, 2), d(4, 10, 2))
    u = lambda *a: Draws(*a, device="cpu").uniform((4096,), torch.float32)
    assert torch.equal(u(0, 1, 1), u(0, 1, 1))
    assert not torch.equal(u(0, 1, 1), u(0, 2, 1))


def test_a_remat_recompute_draws_the_same_mask():
    _, layer = _layers("dropout", "  threshold = 0.5", "float32")
    x = torch.randn(8, 6, 6, 4, requires_grad=True)
    ctx = ApplyCtx(train=True, draws=Draws(0, 3, 1, "cpu"))
    y = checkpoint(lambda a: layer.forward({}, {}, [a * 1.0], ctx)[0], x,
                   use_reentrant=False)
    torch.manual_seed(123)          # move the default generator on
    torch.rand(1000)
    (dx,) = torch.autograd.grad(y, [x], torch.ones_like(y))
    assert torch.equal(dx != 0, y != 0)
    assert torch.equal(dx[y != 0], torch.full_like(dx[y != 0], 2.0))


DROP_NET = """
netconfig = start
layer[in->h] = fullc:fc1
  nhidden = 32
layer[h->h] = dropout:dp
  threshold = 0.5
layer[h->o] = fullc:fc2
  nhidden = 10
layer[o->o] = softmax:sm
netconfig = end
input_shape = 1,1,24
batch_size = 8
eta = 0.5
momentum = 0.9
dev = cpu
seed = 3
"""


def test_a_resumed_trainer_draws_what_the_unbroken_run_drew(tmp_path):
    batches = list(create_iterator(parse_config_string(
        "batch_size = 8\niter = synthetic\nnum_inst = 24\n"
        "input_shape = 1,1,24\nseed_data = 2\niter = end\n")))
    cfg = parse_config_string(DROP_NET)
    run = Trainer(cfg)
    run.init_model()
    run.update(batches[0])
    path = str(tmp_path / "0000.model")
    run.save_model(path)
    run.update(batches[1])
    resumed = Trainer(cfg)
    resumed.load_blob(ckpt.load_model(path))
    assert resumed.step_count == 1
    resumed.update(batches[1])
    for layer, leaves in run.params.items():
        for k, v in leaves.items():
            assert torch.equal(v, resumed.params[layer][k]), (layer, k)
    other = Trainer(cfg)            # step 0's mask on step 1's batch
    other.load_blob(ckpt.load_model(path))
    other.step_count = 0
    other.update(batches[1])
    assert not torch.equal(other.params["fc1"]["wmat"],
                           run.params["fc1"]["wmat"])
