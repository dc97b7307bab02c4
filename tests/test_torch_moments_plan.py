"""The batch-norm moments of ``bn_fwd`` and ``bn_sums`` on the CPU.

Both take ``csrc/colsum_vec.cuh``'s column sums under
``colsum_vec_plan`` with the ops of ``csrc/bn_moments.cuh``: sum x and
sum x^2 in one launch (two sums a channel), or for the two-pass forward
sum x (one sum) and then sum (x - mean)^2 (one sum). The order they add
in is emulated in float32 (``tests/torch_colsum_order.py``): its longest
addition chain must equal ``colsum_vec_depth`` for one and for two sums,
its sums must meet that bound against the float64 sum at every BN shape
of Inception-BN (64 and 128 images a rank) and at odd shapes, and agree
with the JAX package's Pallas moments (interpreted). The statistics
``bn_fwd``'s normalize forms from the sums keep a NaN or an inf of a
channel as a NaN variance, as ``bn_act_plain`` and the JAX package's
``bn_act_reference`` do; and its walk writes each statistic once and
takes every vector once.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from cxxnet_tpu.ops.fused_norm import (_bn_forward, _bn_sums_kernel,
                                       _row_vec_specs, bn_act_reference)
from cxxnet_tpu_torch.ops import fused_norm as N

import torch_colsum_order as order
from test_torch_colsum_plan import ODD, PLAN_CASES, ibn_bn_shapes

#: (n, c) of the bound test: every BN shape of Inception-BN at 64 and 128
#: images a rank, and the odd shapes
BOUND_SHAPES = sorted(set(ibn_bn_shapes(64)) | set(ibn_bn_shapes(128))
                      | set(ODD))


@pytest.mark.parametrize("n,c,size,aligned", PLAN_CASES)
def test_moments_chain_equals_the_depth_for_one_and_two_sums(n, c, size,
                                                             aligned):
    """The emulated order's longest chain is ``colsum_vec_depth``'s for
    the one-pass launch (two sums a channel) and for each two-pass launch
    (one sum a channel, whose last CTA spreads the runs wider)."""
    plan = N.colsum_vec_plan(n, c, size, aligned)
    for sums in (1, 2):
        assert order.colsum_vec_chain(plan, n, c, sums) == \
            N.colsum_vec_depth(plan, c, sums)


@pytest.mark.parametrize("n,c", BOUND_SHAPES, ids=str)
def test_moments_meet_the_depth_bound(n, c):
    """bf16 rows in the kernels' order (emulated a run of row blocks at a
    time): sum x and sum x^2 of the one-pass launch, sum x and sum (x -
    mean)^2 of the two-pass launches, each within depth * 2^-24 *
    sum|term| of the float64 sum of the same float32 terms."""
    plan = N.colsum_vec_plan(n, c, 2)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16).float().numpy()

    def x_of(r0, r1):
        g = np.random.default_rng([n, c, r0])
        return bf(g.standard_normal((r1 - r0, c), np.float32) * 1.5 + 0.25)

    def check(terms_of, sums):
        depth = N.colsum_vec_depth(plan, c, sums)
        out = order.colsum_vec_sum_blocks(terms_of, plan, n, c, sums=sums)
        for got, exact, mag in out:
            assert (np.abs(got - exact) <= depth * 2.0 ** -24 * mag).all()
        return [got for got, _, _ in out]
    check(lambda r0, r1: order.moments_terms(x_of(r0, r1)), 2)
    s1, = check(lambda r0, r1: (x_of(r0, r1),), 1)
    check(lambda r0, r1: (order.sqdev_terms(x_of(r0, r1), s1, n),), 1)


def _jax_sums(x):
    """The JAX package's ``_bn_sums_kernel`` over all rows in one shard,
    interpreted (row blocks of 16): (2, C) float32."""
    n, c = x.shape
    row, vec = _row_vec_specs(16, c)
    s1, s2 = pl.pallas_call(
        functools.partial(_bn_sums_kernel, nb=n // 16),
        grid=(n // 16,), in_specs=[row], out_specs=[vec, vec],
        out_shape=[jax.ShapeDtypeStruct((1, c), jnp.float32)] * 2,
        scratch_shapes=[pltpu.VMEM((1, c), jnp.float32)] * 2,
        interpret=True)(x)
    return np.concatenate([np.asarray(s1), np.asarray(s2)])


def _bf16_rows(n, c, seed):
    rs = np.random.RandomState(seed)
    x = (rs.randn(n, c) * 1.5 + 0.25).astype(np.float32)
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16)
                      .astype(jnp.float32))


@pytest.mark.parametrize("n,c", [(64, 24), (256, 64), (48, 1000),
                                 (4096, 8)])
def test_moments_order_matches_the_jax_kernel(n, c):
    """The emulated one-pass sums against the JAX package's
    ``_bn_sums_kernel`` on the same bf16 rows: both within their addition
    depths (ours, and n for the JAX kernel's row blocks) times 2^-24 of
    sum|term|; the plain version within 1e-4."""
    x = _bf16_rows(n, c, seed=c)
    want = _jax_sums(jnp.asarray(x).astype(jnp.bfloat16))
    plan = N.colsum_vec_plan(n, c, 2)
    depth = N.colsum_vec_depth(plan, c) + n
    for row, t in zip(want, order.moments_terms(x)):
        got, chain = order.colsum_vec_sum(t, plan)
        assert chain == N.colsum_vec_depth(plan, c)
        bound = depth * 2.0 ** -24 * np.abs(t.astype(np.float64)).sum(0)
        assert (np.abs(got - row) <= bound).all()
    plain = N.bn_sums_plain(torch.from_numpy(x).to(torch.bfloat16))
    np.testing.assert_allclose(plain.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("two_pass", [False, True])
@pytest.mark.parametrize("n,c", [(64, 24), (256, 64), (48, 1000)])
def test_emulated_statistics_match_the_jax_kernel(n, c, two_pass):
    """mean and var from the emulated sums through ``bn_moments.cuh``'s
    formula against the JAX package's Pallas forward (interpreted) on the
    same bf16 rows: within 1e-5 of max(1, |v|), the f32 noise of sums
    taken in two orders."""
    x = _bf16_rows(n, c, seed=n + c)
    plan = N.colsum_vec_plan(n, c, 2)
    if two_pass:
        s1, _ = order.colsum_vec_sum(x, plan, 1)
        s2, _ = order.colsum_vec_sum(order.sqdev_terms(x, s1, n), plan, 1)
    else:
        s1, s2 = (order.colsum_vec_sum(t, plan)[0]
                  for t in order.moments_terms(x))
    mean, var = order.bn_stats(s1, s2, n, two_pass)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    g, b = jnp.ones((c,), jnp.float32), jnp.zeros((c,), jnp.float32)
    _, jmean, jvar = _bn_forward(jx, g, b, 1e-5, "relu", two_pass, True, 16)
    for got, want in ((mean, jmean), (var, jvar)):
        want = np.asarray(want).reshape(c)
        assert (np.abs(got - want) <= 1e-5 * np.maximum(1, np.abs(want))
                ).all()


@pytest.mark.parametrize("two_pass", [False, True])
@pytest.mark.parametrize("bad", [np.nan, np.inf])
def test_statistics_keep_a_nan_channel(bad, two_pass):
    """One NaN or inf in channel 2: the emulated formula (sums in the
    kernels' order) gives that channel a NaN variance and the others
    their values without it, as ``bn_act_plain`` and the JAX package's
    ``bn_act_reference`` give NaN there; a negative one-pass variance
    (cancellation) clamps to 0."""
    n, c = 256, 8
    x = _bf16_rows(n, c, seed=7)
    xb = x.copy()
    xb[17, 2] = bad
    plan = N.colsum_vec_plan(n, c, 2)

    def stats(a):
        with np.errstate(invalid="ignore"):     # inf - inf is the NaN
            return sums_to_stats(a)

    def sums_to_stats(a):
        if two_pass:
            s1, _ = order.colsum_vec_sum(a, plan, 1)
            s2, _ = order.colsum_vec_sum(order.sqdev_terms(a, s1, n), plan,
                                         1)
        else:
            s1, s2 = (order.colsum_vec_sum(t, plan)[0]
                      for t in order.moments_terms(a))
        return order.bn_stats(s1, s2, n, two_pass)
    mean, var = stats(xb)
    mean0, var0 = stats(x)
    others = np.arange(c) != 2
    assert np.isnan(var[2]) and not np.isnan(var[others]).any()
    np.testing.assert_array_equal(mean[others], mean0[others])
    np.testing.assert_array_equal(var[others], var0[others])
    _, pmean, pvar = N.bn_act_plain(torch.from_numpy(xb),
                                    torch.ones(c), torch.zeros(c), 1e-5,
                                    "relu", two_pass)
    _, jmean, jvar = bn_act_reference(jnp.asarray(xb), jnp.ones(c),
                                      jnp.zeros(c), 1e-5, "relu", two_pass)
    for m, v in ((pmean.numpy(), pvar.numpy()),
                 (np.asarray(jmean), np.asarray(jvar))):
        assert np.isnan(v[2]) and not np.isnan(v[others]).any()
        assert np.isnan(m[2]) == np.isnan(mean[2])
    if not two_pass:
        m, v = order.bn_stats(np.float32([3.0]), np.float32([2.9]), 1)
        assert v[0] == 0 and m[0] == 3


@pytest.mark.parametrize("n,c,size,aligned", [
    (802816, 64, 2, True), (25088, 256, 2, True), (245, 8, 4, True),
    (333, 7, 2, True), (12345, 64, 2, False), (1000, 1500, 4, True)])
def test_fwd_normalize_writes_each_statistic_once(n, c, size, aligned):
    """``bn_fwd``'s normalize under ``bn_dx_plan`` (the walk of
    ``bn_norm_vec.cuh``, N.BN_NORM_ROWS vectors in flight) takes every
    vector once, from the thread's own channel group, for V = 8 and V =
    1; its threads of row lane 0 (t < c // vec) write the statistics of
    every channel once; and both of ``bn_fwd``'s plans take the same
    V."""
    plan = N.bn_dx_plan(n, c, size, aligned)
    assert plan.vec == N.colsum_vec_plan(n, c, size, aligned).vec
    vw = 16 // size
    assert plan.vec == (vw if aligned and c % vw == 0 else 1)
    groups = c // plan.vec
    seen = np.zeros(n * c // plan.vec, np.uint8)
    for t, v in order.dx_walk(plan, n, c, N.BN_NORM_ROWS):
        assert (v % groups == t % groups).all()
        seen[v] += 1
    assert (seen == 1).all()
    writers = np.arange(min(groups, plan.lanes * groups))
    chans = ((writers % groups)[:, None] * plan.vec
             + np.arange(plan.vec)[None, :]).reshape(-1)
    assert sorted(chans.tolist()) == list(range(c))
