"""The port's synchronized batch norm (data parallelism) against the JAX
package's dp-mesh batch norm (``cxxnet_tpu/ops/fused_norm.py``).

* The four plain versions (what ``csrc/bn_sync.cu`` computes) against
  the JAX kernel bodies ``_bn_sums_kernel``, ``_bn_norm_kernel``,
  ``_bn_bwd_sums_kernel`` and ``_bn_bwd_dx_kernel``, each run through
  ``pl.pallas_call(..., interpret=True)`` shard by shard as
  ``_mesh_fwd_local`` / ``_mesh_bwd_local`` run them (``pallas_call``
  asserted in each jaxpr), with their psum replaced by a numpy sum over
  the shards: 2 and 4 shards of a seeded batch, relu and none, float32
  and bfloat16, conv-shaped (NHWC) and flat nodes. The row block is 16
  rows, so each shard runs two or more grid steps. Tolerances: the sums
  (f32 both sides, in another order) rtol 1e-5 plus atol 1e-5 times
  the sum of the terms' magnitudes; y and dx in float32 atol 1e-5 plus
  rtol 1e-5; in bfloat16 within one bf16 ulp plus 1e-5 (both round the
  same f32 values, which differ in their last bits).
* ``SyncBnAct`` at world 2 (two CPU ranks over gloo, ``file://``
  rendezvous), its kernels' plain versions and under ``fused_kernels =
  0``: forward and gradients against ``bn_act_reference`` (``jax.vjp``)
  over the global batch and against the port's single-device ``BnAct``
  on the global batch; the ranks' dgamma and dbeta are their own sums,
  which add up to the global ones. float32: y, mean, var, dx rtol and
  atol 1e-5; dgamma, dbeta rtol 1e-4 + atol 1e-4. bfloat16: y and dx
  within one bf16 ulp + 1e-5 of the single-device port and of the
  reference taken in float32 on the same bf16 inputs and rounded to
  bfloat16 (JAX's own bf16 vjp of the reference rounds dx's three
  terms to bf16 one by one).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from cxxnet_tpu.ops.fused_norm import (_bn_bwd_dx_kernel, _bn_bwd_sums_kernel,
                                       _bn_norm_kernel, _bn_sums_kernel,
                                       _row_vec_specs, bn_act_reference)
from cxxnet_tpu_torch.ops.fused_norm import (bn_bwd_dx_plain,
                                             bn_bwd_sums_plain, bn_norm_plain,
                                             bn_sums_plain, fused_bn_act)
from cxxnet_tpu_torch.parallel import launch

import torch_dp_fixture

EPS = 1e-5
BLOCK = 16                       # rows per Pallas grid step
#: node -> global NHWC shape: 128 and 64 rows, whole row blocks per shard
NODES = {"conv": (8, 4, 4, 8), "flat": (64, 1, 1, 24)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _inputs(shape, seed):
    rs = np.random.RandomState(seed)
    c = shape[-1]
    x = (rs.randn(*shape) * 1.5 + 0.3).astype(np.float32)
    gamma = (1.0 + 0.2 * rs.randn(c)).astype(np.float32)
    beta = (0.1 * rs.randn(c)).astype(np.float32)
    dy = rs.randn(*shape).astype(np.float32)
    return x, gamma, beta, dy


def _round(a, dtype):
    """``a`` rounded to ``dtype`` and back to float32 numpy."""
    return np.asarray(jnp.asarray(a).astype(JDT[dtype]).astype(jnp.float32))


def _ulp_ok(got, want, atol=1e-5):
    """|got - want| within one bf16 ulp of the larger magnitude."""
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.where(mag > 0, 2.0 ** (np.floor(np.log2(np.maximum(
        mag, 1e-30))) - 7), 0.0)
    err = np.abs(got - want)
    assert (err <= ulp + atol).all(), (err - ulp).max()


def _close(got, want, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        _ulp_ok(got, want)


# -- the JAX kernel bodies, shard by shard --------------------------------------

def _pallas(kernel, shards, in_specs, out_specs, out_shape, scratch=()):
    """The kernel over each shard's inputs (``shards``: one input list
    per shard, equal shapes): one jitted ``pallas_call``, its jaxpr
    checked once."""
    fn = lambda *a: pl.pallas_call(
        kernel, grid=(shards[0][0].shape[0] // BLOCK,), in_specs=in_specs,
        out_specs=out_specs, out_shape=out_shape,
        scratch_shapes=list(scratch), interpret=True)(*a)
    assert "pallas_call" in str(jax.make_jaxpr(fn)(*shards[0]))
    fn = jax.jit(fn)
    return [fn(*ins) for ins in shards]


def _jax_sums(xs):
    n, c = xs[0].shape
    row, vec = _row_vec_specs(BLOCK, c)
    f32 = jax.ShapeDtypeStruct((1, c), jnp.float32)
    out = _pallas(functools.partial(_bn_sums_kernel, nb=n // BLOCK),
                  [[x2] for x2 in xs], [row], [vec, vec], [f32, f32],
                  [pltpu.VMEM((1, c), jnp.float32)] * 2)
    return [np.concatenate([np.asarray(s1), np.asarray(s2)])
            for s1, s2 in out]


def _jax_norm(xs, gamma, beta, mean, rstd, act):
    n, c = xs[0].shape
    row, vec = _row_vec_specs(BLOCK, c)
    vecs = [v.reshape(1, c) for v in (gamma, beta, mean, rstd)]
    out = _pallas(functools.partial(_bn_norm_kernel, act=act),
                  [[x2] + vecs for x2 in xs], [row, vec, vec, vec, vec], row,
                  jax.ShapeDtypeStruct(xs[0].shape, xs[0].dtype))
    return [np.asarray(y.astype(jnp.float32)) for y in out]


def _jax_bwd_sums(xs, dys, ys, mean, rstd, act):
    n, c = xs[0].shape
    row, vec = _row_vec_specs(BLOCK, c)
    f32 = jax.ShapeDtypeStruct((1, c), jnp.float32)
    relu = act == "relu"
    out = _pallas(
        functools.partial(_bn_bwd_sums_kernel, nb=n // BLOCK, act=act),
        [[x2, d] + ([y] if relu else []) + [mean.reshape(1, c),
                                            rstd.reshape(1, c)]
         for x2, d, y in zip(xs, dys, ys)],
        [row, row] + [row] * relu + [vec, vec], [vec, vec], [f32, f32],
        [pltpu.VMEM((1, c), jnp.float32)] * 2)
    return [np.concatenate([np.asarray(sb), np.asarray(sxh)])
            for sb, sxh in out]


def _jax_dx(xs, dys, ys, gamma, mean, rstd, sbn, sxhn, act):
    n, c = xs[0].shape
    row, vec = _row_vec_specs(BLOCK, c)
    relu = act == "relu"
    vecs = [v.reshape(1, c) for v in (gamma, mean, rstd, sbn, sxhn)]
    out = _pallas(functools.partial(_bn_bwd_dx_kernel, act=act),
                  [[x2, d] + ([y] if relu else []) + vecs
                   for x2, d, y in zip(xs, dys, ys)],
                  [row, row] + [row] * relu + [vec] * 5, row,
                  jax.ShapeDtypeStruct(xs[0].shape, xs[0].dtype))
    return [np.asarray(dx.astype(jnp.float32)) for dx in out]


def _t(a, dtype):
    return torch.from_numpy(np.array(a, np.float32)).to(getattr(torch, dtype))


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("node", sorted(NODES))
@pytest.mark.parametrize("dtype", sorted(JDT))
@pytest.mark.parametrize("act", ["none", "relu"])
@pytest.mark.parametrize("shards", [2, 4])
def test_plain_versions_match_the_jax_kernel_bodies(shards, act, dtype, node):
    """Forward and backward of the dp-mesh island, shard by shard: the
    JAX kernel bodies in interpret mode against the port's plain
    versions on the same shard inputs and the same global vectors."""
    shape = NODES[node]
    x, gamma, beta, dy = _inputs(shape, seed=shards)
    c = shape[-1]
    x2 = _round(x, dtype).reshape(-1, c)
    dy2 = _round(dy, dtype).reshape(-1, c)
    n = x2.shape[0]
    parts = np.split(np.arange(n), shards)
    assert all(len(p) % BLOCK == 0 for p in parts)
    jx = [jnp.asarray(x2[p]).astype(JDT[dtype]) for p in parts]
    jdy = [jnp.asarray(dy2[p]).astype(JDT[dtype]) for p in parts]
    tx = [_t(x2[p], dtype) for p in parts]
    tdy = [_t(dy2[p], dtype) for p in parts]

    # forward: local sums -> (psum) -> global moments -> normalize
    sums_j = _jax_sums(jx)
    sums_t = [_np(bn_sums_plain(a)) for a in tx]
    mag = sum(np.stack([np.abs(x2[p]).sum(0), (x2[p] ** 2).sum(0)])
              for p in parts)
    for a, b in zip(sums_t, sums_j):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=0)
    tot = np.sum(sums_j, axis=0)
    np.testing.assert_allclose(np.sum(sums_t, axis=0), tot, rtol=1e-5,
                               atol=1e-5 * mag.max())
    mean = (tot[0] / n).astype(np.float32)
    var = np.maximum(tot[1] / n - mean * mean, 0.0).astype(np.float32)
    rstd = (1.0 / np.sqrt(var + EPS)).astype(np.float32)
    mean_t, rstd_t = torch.from_numpy(mean), torch.from_numpy(rstd)
    ys_j = _jax_norm(jx, *map(jnp.asarray, (gamma, beta, mean, rstd)), act)
    for ta, yj in zip(tx, ys_j):
        got = bn_norm_plain(ta, torch.from_numpy(gamma),
                            torch.from_numpy(beta), mean_t, rstd_t, act)
        _close(_np(got), yj, dtype)

    # backward: local sums -> (psum) -> dx from the global sums over n,
    # both sides masked by the same y (the JAX kernel's)
    jys = [jnp.asarray(y).astype(JDT[dtype]) for y in ys_j]
    tys = [_t(y, dtype) if act == "relu" else None for y in ys_j]
    bsums_j = _jax_bwd_sums(jx, jdy, jys, jnp.asarray(mean),
                            jnp.asarray(rstd), act)
    for ta, td, yt, want in zip(tx, tdy, tys, bsums_j):
        got = _np(bn_bwd_sums_plain(ta, td, yt, mean_t, rstd_t))
        dyf = np.abs(_np(td))
        bmag = np.stack([dyf.sum(0),
                         (dyf * np.abs((_np(ta) - mean) * rstd)).sum(0)])
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * bmag.max())
    btot = np.sum(bsums_j, axis=0)
    sbn, sxhn = (btot[0] / n).astype(np.float32), \
        (btot[1] / n).astype(np.float32)
    dxs_j = _jax_dx(jx, jdy, jys, *map(jnp.asarray,
                                       (gamma, mean, rstd, sbn, sxhn)), act)
    for ta, td, yt, want in zip(tx, tdy, tys, dxs_j):
        got = bn_bwd_dx_plain(ta, td, yt, torch.from_numpy(gamma), mean_t,
                              rstd_t, torch.from_numpy(sbn),
                              torch.from_numpy(sxhn))
        _close(_np(got), want, dtype)


def test_plain_sums_are_the_defined_moments():
    x = np.random.RandomState(0).randn(37, 5).astype(np.float32)
    s = _np(bn_sums_plain(torch.from_numpy(x)))
    np.testing.assert_allclose(s, [x.sum(0), (x * x).sum(0)], rtol=1e-5)


# -- SyncBnAct at world 2 ---------------------------------------------------------

#: cases of the world-2 run: (node, dtype, act, fused)
CASES = [(node, dtype, act, fused) for node in sorted(NODES)
         for dtype in sorted(JDT) for act in ("none", "relu")
         for fused in (True, False)]


def _case_inputs(node, dtype):
    x, gamma, beta, dy = _inputs(NODES[node], seed=11)
    return _round(x, dtype), gamma, beta, _round(dy, dtype)


@pytest.fixture(scope="module")
def world2():
    """Every case through ``SyncBnAct`` on two CPU ranks (one launch)."""
    cases = []
    for node, dtype, act, fused in CASES:
        x, g, b, dy = _case_inputs(node, dtype)
        cases.append((x, g, b, dy, EPS, act, dtype, fused))
    return launch(torch_dp_fixture.sync_bn_rank, (cases,),
                  devices=("cpu", "cpu"), timeout_s=60, deadline_s=120)


def _jax_reference(x, gamma, beta, dy, act, dtype):
    """``bn_act_reference`` and its vjp in float32 on the (already
    rounded) inputs, y and dx then rounded to ``dtype``. In bfloat16
    JAX's autodiff would round each of dx's three terms (the direct one
    and those through mean and var) to bfloat16 before adding them."""
    f = lambda a, g, b: bn_act_reference(a, g, b, EPS, act)
    (y, mean, var), vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(gamma),
                                  jnp.asarray(beta))
    zero = jnp.zeros_like(mean)
    dx, dg, db = vjp((jnp.asarray(dy), zero, zero))
    y, mean, var, dx, dg, db = (np.asarray(a) for a in
                                (y, mean, var, dx, dg, db))
    return _round(y, dtype), mean, var, _round(dx, dtype), dg, db


def _port_single(x, gamma, beta, dy, act, dtype):
    xt = _t(x, dtype).requires_grad_(True)
    g = torch.from_numpy(gamma).requires_grad_(True)
    b = torch.from_numpy(beta).requires_grad_(True)
    y, mean, var = fused_bn_act(xt, g, b, EPS, act)
    dx, dg, db = torch.autograd.grad(y, [xt, g, b], _t(dy, dtype))
    return tuple(map(_np, (y, mean, var, dx, dg, db)))


def _gathered(res):
    """The two ranks' results as the global batch's: rows concatenated,
    the statistics rank 0's (checked equal on both), the gradients of
    gamma and beta summed."""
    r0, r1 = res
    np.testing.assert_array_equal(r0[1], r1[1])
    np.testing.assert_array_equal(r0[2], r1[2])
    return (np.concatenate([r0[0], r1[0]]), r0[1], r0[2],
            np.concatenate([r0[3], r1[3]]), r0[4] + r1[4], r0[5] + r1[5])


@pytest.mark.parametrize("node,dtype,act,fused", CASES)
def test_sync_bn_at_world_2_matches_the_global_batch(world2, node, dtype, act,
                                                     fused):
    i = CASES.index((node, dtype, act, fused))
    x, gamma, beta, dy = _case_inputs(node, dtype)
    got = _gathered([world2[0][i], world2[1][i]])
    # each rank's dgamma/dbeta is its own share, not the global sum
    assert not np.allclose(world2[0][i][4], got[4])
    single = _port_single(x, gamma, beta, dy, act, dtype)
    ref = _jax_reference(x, gamma, beta, dy, act, dtype)
    for want in (single, ref):
        for k in (0, 3):                              # y, dx
            _close(got[k].reshape(want[k].shape), want[k], dtype)
        for k in (1, 2):                              # mean, var
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       atol=1e-5)
        for k in (4, 5):                              # dgamma, dbeta
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=1e-4)
