"""The batch-norm backward's launch plans (``bn_bwd``, ``bn_bwd_dx``:
``csrc/bn_bwd_vec.cuh``) on the CPU.

``bn_dx_plan`` lays the dx pass's threads over (n, c) rows: each thread
keeps one channel group for its whole loop, so the walk must take every
vector exactly once, and each from the thread's own channel group.
``bn_bwd``'s sums pass runs under ``colsum_vec_plan`` and, with relu on
the 16-byte path, packs y > 0 as bits that the dx pass reads back. The
walk, the bit layout, the order of the sums and the dx arithmetic are
emulated in numpy float32 (``tests/torch_colsum_order.py``): the sums at
the single-device path's shapes meet the ``colsum_vec_depth`` bound, dx
from the emulated kernels equals the plain version given the same sums
bit for bit, and both passes together stay within the tolerances of
``tests/test_torch_fused_norm.py`` of the JAX package's Pallas backward
(interpreted).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cxxnet_tpu.ops.fused_norm import _bn_backward as jax_bn_backward
from cxxnet_tpu_torch.ops import fused_norm as N

import torch_colsum_order as order
from test_torch_colsum_plan import IBN_BN_64, ODD, ibn_bn_shapes

#: (n, c, itemsize, aligned): Inception-BN at 64 and 128 images a rank in
#: bf16, the odd shapes in bf16 and f32, bases past a 16-byte boundary
PLAN_CASES = [(n * r, c, 2, True) for r in (1, 2) for n, c in IBN_BN_64]
PLAN_CASES += [(n, c, s, True) for n, c in ODD for s in (2, 4)]
PLAN_CASES += [(12345, 64, 2, False), (802816, 64, 2, False),
               (999, 36, 4, False), (1000, 1500, 2, False), (37, 3, 2, True),
               (5, 1, 4, False)]


@pytest.mark.parametrize("n,c,size,aligned", PLAN_CASES)
def test_dx_plan_takes_every_vector_once_in_its_channel_group(n, c, size,
                                                              aligned):
    plan = N.bn_dx_plan(n, c, size, aligned)
    assert plan.vec == N.colsum_vec_plan(n, c, size, aligned).vec
    groups = c // plan.vec
    assert 1 <= plan.lanes <= n
    assert plan.blocks * N.BN_DX_THREADS - N.BN_DX_THREADS \
        < plan.lanes * groups <= plan.blocks * N.BN_DX_THREADS
    wave = N.BN_DX_CTAS_PER_SM * 132
    assert plan.blocks <= wave or plan.lanes == 1
    assert plan.lanes == n or \
        (plan.lanes + 1) * groups > wave * N.BN_DX_THREADS
    seen = np.zeros(n * c // plan.vec, np.uint8)
    for t, v in order.dx_walk(plan, n, c):
        assert (v % groups == t % groups).all()     # the thread's channels
        seen[v] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("n,c,size", [(802816 * 2, 64, 2), (200704, 192, 2),
                                      (12544, 224, 2), (333, 7, 2),
                                      (999, 36, 4), (64, 1024, 4)])
def test_mask_bits_packed_by_the_sums_read_back_by_dx(n, c, size):
    """The bytes the sums pass writes under ``colsum_vec_plan`` and the
    dx pass reads under ``bn_dx_plan`` give back y > 0 at every element:
    NaNs, zeros and negative zeros read as off."""
    y = np.random.default_rng(n % 1000 + c).standard_normal((n, c),
                                                            np.float32)
    flat = y.reshape(-1)
    flat[::7] = np.nan
    flat[3::11] = 0.0
    flat[5::13] = -0.0
    plan = N.colsum_vec_plan(n, c, size)
    dplan = N.bn_dx_plan(n, c, size)
    if plan.vec == 1:           # the one-element path reads y itself
        assert dplan.vec == 1 and c % (16 // size)
        return
    bits, writes = order.pack_bits(y, plan)
    assert (writes == 1).all()
    np.testing.assert_array_equal(order.unpack_bits(bits, dplan, n, c),
                                  y > 0)


@pytest.mark.parametrize("n,c", sorted(set(ibn_bn_shapes(128))),
                         ids=lambda v: str(v))
def test_bn_bwd_sums_meet_the_depth_bound_at_the_single_device_shapes(n, c):
    """``bn_bwd``'s two sums at each BN shape of Inception-BN at batch 128,
    bf16 rows with the relu mask, in the kernel's order (emulated a run of
    row blocks at a time): the longest chain equals ``colsum_vec_depth``
    and each sum is within depth * 2^-24 * sum|term| of the float64 sum
    of the same float32 terms."""
    plan = N.colsum_vec_plan(n, c, 2)
    depth = N.colsum_vec_depth(plan, c)
    assert order.colsum_vec_chain(plan, n, c) == depth
    rs = np.random.RandomState(c)
    mean = (0.25 + 0.1 * rs.randn(c)).astype(np.float32)
    rstd = (1 / 1.5 + 0.05 * rs.randn(c)).astype(np.float32)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16).float().numpy()

    def terms_of(r0, r1):
        g = np.random.default_rng([n, c, r0])
        x, dy, y = (bf(g.standard_normal((r1 - r0, c), np.float32) * s + m)
                    for s, m in ((1.5, 0.25), (1.0, 0.0), (1.0, 0.0)))
        return order.bwd_sums_terms(x, dy, y, mean, rstd)
    for got, exact, mag in order.colsum_vec_sum_blocks(terms_of, plan, n, c):
        assert (np.abs(got - exact) <= depth * 2.0 ** -24 * mag).all()


def _rows(n, c, dtype, seed):
    rs = np.random.RandomState(seed)
    x = torch.from_numpy((rs.randn(n, c) * 1.5 + 0.25).astype(np.float32))
    dy = torch.from_numpy(rs.randn(n, c).astype(np.float32))
    gamma = torch.from_numpy((1 + 0.2 * rs.randn(c)).astype(np.float32))
    x, dy = x.to(dtype), dy.to(dtype)
    mean = x.float().mean(0)
    rstd = torch.rsqrt(x.float().var(0, unbiased=False) + 1e-5)
    y = ((x.float() - mean) * rstd * gamma).to(dtype)   # the forward's y
    y.view(-1)[::29] = float("nan")
    return x, dy, y, gamma, mean, rstd


def _emulated_bn_bwd(x, dy, y, gamma, mean, rstd):
    """``bn_bwd``'s two launches emulated: the sums in colsum_vec's order,
    the mask through the bits where the plan packs them, dx with the sums
    divided once a channel. Returns (dx f32, dgamma, dbeta)."""
    n, c = x.shape
    size = x.element_size()
    plan, dplan = N.colsum_vec_plan(n, c, size), N.bn_dx_plan(n, c, size)
    f = lambda t: t.float().numpy()
    ynp = None if y is None else f(y)
    db, dg = (order.colsum_vec_sum(t, plan)[0] for t in order.bwd_sums_terms(
        f(x), f(dy), ynp, f(mean), f(rstd)))
    on = None
    if ynp is not None:
        on = (order.unpack_bits(order.pack_bits(ynp, plan)[0], dplan, n, c)
              if plan.vec > 1 else ynp > 0)
    dx = order.dx_emulated(f(x), f(dy), on, f(gamma), f(mean), f(rstd), db,
                           dg, rows=n)
    return dx, dg, db


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("n,c", [(784, 64), (96, 24), (48, 1000), (64, 7)])
def test_emulated_bn_bwd_is_the_plain_dx_and_near_the_jax_kernel(n, c, relu,
                                                                 dtype):
    """dx of the emulated kernels equals ``bn_bwd_dx_plain`` given the same
    sums over N (true division) bit for bit; against the JAX package's
    Pallas backward (interpreted, row blocks of 16) dgamma and dbeta
    within rtol 1e-4 plus atol 1e-4, dx within 1e-5 plus rtol 1e-5 in
    float32 and one bf16 ulp plus 1e-5 in bf16 (sums in another order)."""
    x, dy, y, gamma, mean, rstd = _rows(n, c, dtype, seed=n + c)
    yy = y if relu else None
    dx, dg, db = _emulated_bn_bwd(x, dy, yy, gamma, mean, rstd)
    t = torch.from_numpy
    plain = N.bn_bwd_dx_plain(x, dy, yy, gamma, mean, rstd,
                              t(db) / n, t(dg) / n)
    assert torch.equal(t(dx).to(dtype), plain)
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}[dtype]
    j = lambda a: jnp.asarray(a.float().numpy()).astype(jdt)
    v = lambda a: jnp.asarray(a.numpy()).reshape(1, c)
    dx_j, dg_j, db_j = jax_bn_backward(
        j(x), jnp.asarray(gamma.numpy()), v(mean), v(rstd),
        j(y) if relu else None, j(dy), "relu" if relu else "none", True, 16)
    np.testing.assert_allclose(dg, np.asarray(dg_j)[0], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(db, np.asarray(db_j)[0], rtol=1e-4, atol=1e-4)
    got = t(dx).to(dtype).float().numpy()
    want = np.asarray(dx_j.astype(jnp.float32))
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        mag = np.maximum(np.abs(got), np.abs(want))
        ulp = np.where(mag > 0, 2.0 ** (np.floor(np.log2(np.maximum(
            mag, 1e-30))) - 7), 0.0)
        assert (np.abs(got - want) <= ulp + 1e-5).all()
