"""The port's training kernels' plain versions against the JAX package's
Pallas kernels, run in interpret mode on the CPU:

* ``pool_bwd_lin_plain`` and the ``Pool`` autograd function against the
  vjp of ``cxxnet_tpu/ops/fused_pool.fused_pool`` (``_pool_bwd_lin_kernel``
  for sum and avg, ``_pool_bwd_max_kernel`` for max, whose plain version
  is ``pool_bwd_max_plain``); a max window past the JAX kernel's 16
  cells (the 7x7 global max) against the JAX package's
  ``pool_reference``, whose vjp is XLA's select-and-scatter;
* ``epilogue_bwd_plain`` and the ``BiasAct`` function against the vjp of
  ``fused_epilogue.fused_bias_act`` (``_epi_bwd_kernel``);
* ``sgd_apply_plain`` and the port's ``Optimizer`` against
  ``fused_optim.fused_sgd_apply`` (``_sgd_kernel``) and the JAX
  ``Optimizer._apply``, fused and per leaf.

Each Pallas case asserts ``pallas_call`` in its jaxpr. Tolerances: the
pooling and epilogue backwards copy or scale by one rounded factor and
sum in f32, so dx is equal and dbias within rtol 1e-6; the SGD step is
elementwise f32 arithmetic, within 2 f32 ulp (rtol 2.4e-7, atol 1e-7:
the order of operations is the same, but XLA may contract a multiply
and an add into one rounding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cxxnet_tpu.config import parse_config_string as jax_parse
from cxxnet_tpu.ops.fused_epilogue import fused_bias_act as jax_bias_act
from cxxnet_tpu.ops.fused_optim import fused_sgd_apply as jax_sgd_apply
from cxxnet_tpu.ops.fused_pool import fused_pool as jax_pool
from cxxnet_tpu.ops.fused_pool import pool_reference
from cxxnet_tpu.optim import Optimizer as JaxOptimizer
from cxxnet_tpu_torch.config import parse_config_string
from cxxnet_tpu_torch.ops import KERNELS
from cxxnet_tpu_torch.ops.fused_epilogue import bias_act, epilogue_bwd_plain
from cxxnet_tpu_torch.ops.fused_optim import fused_sgd_apply, sgd_apply_plain
from cxxnet_tpu_torch.ops.fused_pool import (pool, pool_bwd_lin_plain,
                                             pool_bwd_max_plain,
                                             pool_fwd_plain)
from cxxnet_tpu_torch.optim import Optimizer

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _t(a, tdt, grad=False):
    return torch.from_numpy(np.array(a, np.float32)).to(tdt) \
        .requires_grad_(grad)


def _np(t):
    return t.detach().float().numpy()


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


# (id, x shape, kh, kw, reducer, scale_avg, pre_relu): global 7x7 and 2x2
# windows (16 rows), 2x2/2 tiles, the SPP net's 3x3/3 tile (spp1) and a
# 7x7 global max, which the JAX kernel refuses (49 cells > 16)
POOLS = [("global7-avg", (16, 7, 7, 32), 7, 7, "sum", True, False),
         ("global7-sum", (16, 7, 7, 32), 7, 7, "sum", False, False),
         ("global2-avg", (16, 2, 2, 24), 2, 2, "sum", True, False),
         ("tile-avg", (4, 8, 8, 16), 2, 2, "sum", True, False),
         ("tile-max", (4, 8, 8, 16), 2, 2, "max", False, False),
         ("tile-relumax", (4, 8, 8, 16), 2, 2, "max", False, True),
         ("tile3-max", (16, 9, 9, 16), 3, 3, "max", False, False),
         ("tile3-relumax", (16, 9, 9, 16), 3, 3, "max", False, True),
         ("global7-max", (16, 7, 7, 16), 7, 7, "max", False, False)]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", POOLS, ids=[p[0] for p in POOLS])
def test_pool_backward_matches_jax_vjp(case, dtype):
    _, shape, kh, kw, red, avg, relu = case
    jdt, tdt = DTYPES[dtype]
    rs = np.random.RandomState(5)
    x = rs.randn(*shape).astype(np.float32)
    if red == "max":      # ties: repeated values in each window
        x = np.round(x * 2) / 2
    b, h, w, c = shape
    dy = rs.randn(b, h // kh, w // kw, c).astype(np.float32)
    xj, dyj = jnp.asarray(x).astype(jdt), jnp.asarray(dy).astype(jdt)
    call = lambda a: jax_pool(a, kh, kw, kh, (0, 0), (0, 0), red, avg, relu,
                              interpret=True)
    if call(xj) is None:          # past the JAX kernel's max-window cap
        assert red == "max" and kh * kw > 16
        call = lambda a: pool_reference(a, kh, kw, kh, red, avg, relu)
        site = "select_and_scatter"
    else:
        site = "pallas_call"
    assert site in str(jax.make_jaxpr(
        lambda a, d: jax.vjp(call, a)[1](d))(xj, dyj))
    _, vjp = jax.vjp(call, xj)
    want = _f32(vjp(dyj)[0])
    xt = _t(_f32(xj), tdt, grad=True)
    y = pool(xt, kh, kw, red, avg, relu)
    (got,) = torch.autograd.grad(y, [xt], _t(_f32(dyj), tdt))
    assert got.dtype == tdt
    np.testing.assert_array_equal(_np(got), want)
    if red == "max":
        xd = xt.detach()
        np.testing.assert_array_equal(_np(pool_bwd_max_plain(
            xd, pool_fwd_plain(xd, kh, kw, red, avg, relu),
            _t(_f32(dyj), tdt), kh, kw, relu)), want)
    if red == "sum":
        np.testing.assert_array_equal(
            _np(pool_bwd_lin_plain(_t(_f32(dyj), tdt), kh, kw, avg)), want)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("with_bias,act", [(True, "none"), (True, "relu"),
                                           (False, "relu")])
def test_epilogue_backward_matches_jax_vjp(with_bias, act, dtype):
    jdt, tdt = DTYPES[dtype]
    rs = np.random.RandomState(6)
    x = rs.randn(2, 4, 4, 24).astype(np.float32)          # 32 rows
    bias = rs.randn(24).astype(np.float32)
    dy = rs.randn(2, 4, 4, 24).astype(np.float32)
    xj, dyj = jnp.asarray(x).astype(jdt), jnp.asarray(dy).astype(jdt)
    if with_bias:
        call = lambda a, bb: jax_bias_act(a, bb, act, interpret=True)
        args = (xj, jnp.asarray(bias))
    else:
        call = lambda a: jax_bias_act(a, None, act, interpret=True)
        args = (xj,)
    assert "pallas_call" in str(jax.make_jaxpr(
        lambda *a: jax.vjp(call, *a)[1](dyj))(*args))
    y_j, vjp = jax.vjp(call, *args)
    grads = vjp(dyj)
    xt = _t(_f32(xj), tdt, grad=True)
    bt = _t(bias, torch.float32, grad=True) if with_bias else None
    y = bias_act(xt, bt, act)
    np.testing.assert_array_equal(_np(y), _f32(y_j))
    got = torch.autograd.grad(y, [xt] + ([bt] if with_bias else []),
                              _t(_f32(dyj), tdt))
    np.testing.assert_array_equal(_np(got[0]), _f32(grads[0]))
    dx, db = epilogue_bwd_plain(y.detach(), _t(_f32(dyj), tdt), act,
                                with_bias)
    np.testing.assert_array_equal(_np(dx), _f32(grads[0]))
    if with_bias:
        assert got[1].dtype == torch.float32 and db.dtype == torch.float32
        np.testing.assert_allclose(_np(got[1]), _f32(grads[1]), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(_np(db), _f32(grads[1]), rtol=1e-6,
                                   atol=1e-6)
    else:
        assert db is None


def _leaves(seed, nan=False):
    rs = np.random.RandomState(seed)
    shapes = [(3, 3, 4, 8), (8,), (37,), (5, 7)]
    ws = [rs.randn(*s).astype(np.float32) for s in shapes]
    gs = [rs.randn(*s).astype(np.float32) * 3 for s in shapes]
    ms = [rs.randn(*s).astype(np.float32) * 0.1 for s in shapes]
    if nan:
        gs[0].reshape(-1)[::7] = np.nan
        gs[2][3] = np.nan
    return ws, gs, ms


SGD_CASES = [(0.0, 0.0, False, False), (1e-3, 0.0, False, False),
             (1e-3, 1.5, False, True), (0.0, 0.5, True, False),
             (1e-4, 1.0, True, True)]


@pytest.mark.parametrize("wd,clip,nag,nan", SGD_CASES,
                         ids=[f"wd{c[0]}-clip{c[1]}-nag{int(c[2])}-nan{int(c[3])}"
                              for c in SGD_CASES])
def test_sgd_apply_plain_matches_jax_kernel(wd, clip, nag, nan):
    ws, gs, ms = _leaves(7, nan)
    lr, mom = 0.1, 0.9
    call = lambda w, g, m: jax_sgd_apply(w, g, m, lr, mom, wd=wd, clip=clip,
                                         nag=nag, interpret=True)
    assert "pallas_call" in str(jax.make_jaxpr(call)(ws, gs, ms))
    want_w, want_m = call(ws, gs, ms)
    tw = [torch.from_numpy(a.copy()) for a in ws]
    tm = [torch.from_numpy(a.copy()) for a in ms]
    tg = [torch.from_numpy(a) for a in gs]
    got_w, got_m = sgd_apply_plain(tw, tg, tm, lr, mom, wd, clip, nag)
    for a, b in zip(got_w + got_m, list(want_w) + list(want_m)):
        assert bool(torch.isfinite(a).all())
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-7,
                                   rtol=2.4e-7)
    for k in KERNELS.values():
        k.launches = 0
    fused_sgd_apply(tw, tg, tm, lr, mom, wd=wd, clip=clip, nag=nag)
    for a, b in zip(tw + tm, got_w + got_m):          # in place on the CPU
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert KERNELS["sgd_apply"].launches == 0         # no kernel on the CPU


OPT_CFG = """
eta = 0.05
momentum = 0.8
wd = 0.001
bias:wd = 0
clip_gradient = 2.0
updater = {updater}
fused_kernels = {fused}
"""


@pytest.mark.parametrize("jax_fused", ["1", "0"])
@pytest.mark.parametrize("port_fused", ["1", "0"])
@pytest.mark.parametrize("updater", ["sgd", "nag"])
def test_optimizer_step_matches_jax_optimizer(updater, port_fused, jax_fused):
    """Tag-scoped wd, clip and NaN gradients through the port's
    ``Optimizer.update`` (fused group apply or per leaf, in place)
    against the JAX ``Optimizer._apply`` (Pallas group apply in interpret
    mode, or per leaf)."""
    ws, gs, ms = _leaves(8, nan=True)
    keys = [("cv", "wmat"), ("cv", "bias"), ("bn", "bias"), ("fc", "wmat")]
    tree = lambda arrs: {l: {k: a for (l2, k), a in zip(keys, arrs)
                             if l2 == l} for l, _ in keys}
    jopt = JaxOptimizer(updater, jax_parse(OPT_CFG.format(
        updater=updater, fused=jax_fused)))
    sched = jopt.schedules(3)
    call = lambda p, g, o: jopt._apply(p, g, o, sched)
    jargs = (tree([jnp.asarray(a) for a in ws]),
             tree([jnp.asarray(a) for a in gs]),
             {"mom": tree([jnp.asarray(a) for a in ms])})
    assert ("pallas_call" in str(jax.make_jaxpr(call)(*jargs))) \
        == (jax_fused == "1")
    want_p, want_o = call(*jargs)
    opt = Optimizer(updater, parse_config_string(OPT_CFG.format(
        updater=updater, fused=port_fused)))
    assert opt.schedules(3) == sched
    params = tree([torch.from_numpy(a.copy()) for a in ws])
    state = {"mom": tree([torch.from_numpy(a.copy()) for a in ms])}
    opt.update(params, tree([torch.from_numpy(a) for a in gs]), state,
               opt.schedules(3))
    for l, k in keys:
        np.testing.assert_allclose(params[l][k].numpy(),
                                   np.asarray(want_p[l][k]), atol=1e-6)
        np.testing.assert_allclose(state["mom"][l][k].numpy(),
                                   np.asarray(want_o["mom"][l][k]), atol=1e-6)


def test_update_period_still_names_its_queue_item():
    """Adam trains now; gradient accumulation is still queued and its key
    still raises naming its ROADMAP item (the unknown updater too)."""
    from cxxnet_tpu_torch.config import ConfigError, check_train_config
    with pytest.raises(ConfigError,
                       match="Queue A 3, still queued: update_period"):
        check_train_config([("updater", "adam"), ("update_period", "2")])
    check_train_config([("updater", "adam"), ("update_period", "1")])
    with pytest.raises(ConfigError, match="unknown updater"):
        Optimizer("adagrad", [])
