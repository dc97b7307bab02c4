"""The launch plans of the vectorised column sums (``bn_bwd_sums``,
``csrc/colsum_vec.cuh``) and of the pooling forward
(``csrc/pool_fwd.cu``) on the CPU.

``colsum_vec_plan`` splits (n, c) rows over row blocks, row lanes,
channel tiles and 16-byte channel groups; ``pool_fwd_plan`` splits a
window's rows over threads. Each plan must take every row and channel,
or every window cell, exactly once. The orders they add in are emulated
in float32 (``tests/torch_colsum_order.py``): the longest addition chain
must equal the depth function that the order-of-summation bound uses,
the sums must meet that bound against the float64 sum, and the window
sums rounded to bf16 and f16 must meet the pooling kernels' one-ulp
tolerance against the plain version and the JAX package's kernel.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from cxxnet_tpu.ops.fused_norm import _bn_bwd_sums_kernel, _row_vec_specs
from cxxnet_tpu.ops.fused_pool import fused_pool as jax_pool
from cxxnet_tpu_torch.ops import fused_norm as N
from cxxnet_tpu_torch.ops import fused_pool as P

import torch_colsum_order as order

#: odd (n, c): C 1, 7, 1500, ragged rows, a flat node
ODD = [(4099, 1), (333, 7), (1000, 1500), (12345, 64), (64, 1024),
       (37, 3), (1, 8), (17, 12)]
ULP = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}


#: the distinct (rows, channels) of Inception-BN's 69 BN layers at 64
#: images a rank (held against the config below); at 128, twice the rows
IBN_BN_64 = [(802816, 64), (200704, 64), (200704, 192), (50176, 64),
             (50176, 96), (50176, 32), (50176, 128), (12544, 128),
             (12544, 160), (12544, 64), (12544, 96), (12544, 192),
             (12544, 224), (12544, 256), (3136, 192), (3136, 160),
             (3136, 224), (3136, 320), (3136, 128), (3136, 352),
             (3136, 256)]


def ibn_bn_shapes(batch: int):
    """The (rows, channels) of Inception-BN's BN layers at ``batch``
    images, from ``inception_bn.conf``."""
    from cxxnet_tpu_torch.config import parse_config_file, split_sections
    from cxxnet_tpu_torch.graph import build_graph
    from cxxnet_tpu_torch.model import Network
    cfg, _ = split_sections(parse_config_file(
        "examples/ImageNet/inception_bn.conf"))
    graph = build_graph(cfg)
    net = Network(graph, cfg, device="cpu")
    shapes = []
    for spec in graph.layers:
        if spec.type.startswith("batch_norm"):
            c, y, x = net.node_shapes[spec.nindex_in[0]]
            shapes.append((batch * y * x, c))
    return shapes


def test_ibn_bn_shapes_are_the_configs():
    shapes = ibn_bn_shapes(64)
    assert len(shapes) == 69
    assert sorted(set(shapes)) == sorted(IBN_BN_64)


#: (n, c, itemsize, aligned) of the plan cases: Inception-BN at 64 and 128
#: a rank in bf16, the odd shapes in bf16 and f32, misaligned bases
PLAN_CASES = [(n * r, c, 2, True) for r in (1, 2) for n, c in IBN_BN_64]
PLAN_CASES += [(n, c, s, True) for n, c in ODD for s in (2, 4)]
PLAN_CASES += [(12345, 64, 2, False), (802816, 64, 2, False),
               (999, 36, 4, False), (1000, 1500, 2, False)]


@pytest.mark.parametrize("n,c,size,aligned", PLAN_CASES)
def test_colsum_plan_covers_every_row_and_channel_once(n, c, size, aligned):
    plan = N.colsum_vec_plan(n, c, size, aligned)
    vw = 16 // size
    assert plan.vec == (vw if aligned and c % vw == 0 else 1)
    assert plan.lanes * plan.cgt <= N.COLSUM_VEC_THREADS
    assert plan.blocks * plan.rows_per >= n > (plan.blocks - 1) * plan.rows_per
    # channels: each exactly once over (tile, channel group, element)
    seen = np.zeros(c, np.int64)
    for t in range(plan.tiles):
        for cg in range(plan.cgt):
            np.add.at(seen, order.tile_channels(plan, c, t, cg), 1)
    assert (seen == 1).all()
    assert len(order.tile_channels(plan, c, plan.tiles - 1, 0)) > 0
    # rows: the lanes of each row block partition its rows
    rows = np.zeros(n, np.int64)
    for b in range(plan.blocks):
        for lane in range(plan.lanes):
            np.add.at(rows, order.lane_rows(plan, n, b, lane), 1)
    assert (rows == 1).all()
    assert order.colsum_vec_chain(plan, n, c) == N.colsum_vec_depth(plan, c)


def _rows(n, c, dtype, seed):
    """Seeded (x, dy, y) rows rounded to ``dtype`` and the f32 moments."""
    rs = np.random.RandomState(seed)
    x = torch.from_numpy((rs.randn(n, c) * 1.5 + 0.25).astype(np.float32))
    dy = torch.from_numpy(rs.randn(n, c).astype(np.float32))
    y = torch.from_numpy(rs.randn(n, c).astype(np.float32))
    x, dy, y = (t.to(dtype) for t in (x, dy, y))
    mean = x.float().mean(0)
    rstd = torch.rsqrt(x.float().var(0, unbiased=False) + 1e-5)
    return x, dy, y, mean, rstd


def _f32(t):
    return t.float().numpy()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32], ids=str)
@pytest.mark.parametrize("n,c,relu,aligned", [
    (50176, 128, True, True), (3136, 320, True, True), (12345, 64, True, True),
    (12345, 64, True, False), (4099, 1, False, True), (333, 7, True, True),
    (1000, 1500, False, True), (64, 1024, False, True)])
def test_colsum_order_meets_its_bound(n, c, relu, aligned, dtype):
    """The kernel's order (emulated) against the float64 sum of the same
    float32 terms: within depth * 2^-24 * sum|term|, with depth the
    emulation's longest chain, which is ``colsum_vec_depth``'s."""
    x, dy, y, mean, rstd = _rows(n, c, dtype, seed=n + c)
    plan = N.colsum_vec_plan(n, c, x.element_size(), aligned)
    terms = order.bwd_sums_terms(_f32(x), _f32(dy), _f32(y) if relu else
                                 None, mean.numpy(), rstd.numpy())
    depth = N.colsum_vec_depth(plan, c)
    for t in terms:
        got, chain = order.colsum_vec_sum(t, plan)
        assert chain == depth
        exact = t.astype(np.float64).sum(0)
        bound = depth * 2.0 ** -24 * np.abs(t.astype(np.float64)).sum(0)
        assert (np.abs(got - exact) <= bound).all()


def _jax_bwd_sums(x, dy, y, mean, rstd):
    """The JAX package's ``_bn_bwd_sums_kernel`` over all rows in one
    shard, interpreted (row blocks of 16)."""
    n, c = x.shape
    row, vec = _row_vec_specs(16, c)
    f32 = jax.ShapeDtypeStruct((1, c), jnp.float32)
    act = "none" if y is None else "relu"
    ins = [x, dy] + ([] if y is None else [y]) + [mean.reshape(1, c),
                                                  rstd.reshape(1, c)]
    specs = [row, row] + ([] if y is None else [row]) + [vec, vec]
    sb, sxh = pl.pallas_call(
        functools.partial(_bn_bwd_sums_kernel, nb=n // 16, act=act),
        grid=(n // 16,), in_specs=specs, out_specs=[vec, vec],
        out_shape=[f32, f32],
        scratch_shapes=[pltpu.VMEM((1, c), jnp.float32)] * 2,
        interpret=True)(*ins)
    return np.concatenate([np.asarray(sb), np.asarray(sxh)])


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("n,c", [(64, 24), (256, 64), (48, 1000)])
def test_colsum_order_matches_the_jax_kernel(n, c, relu):
    """The emulated kernel order against the JAX package's kernel on the
    same bf16 rows: both within their addition depths (ours, and n for
    the JAX kernel's row blocks) times 2^-24 of sum|term|."""
    x, dy, y, mean, rstd = _rows(n, c, torch.bfloat16, seed=c)
    j = lambda t: jnp.asarray(_f32(t)).astype(jnp.bfloat16)
    want = _jax_bwd_sums(j(x), j(dy), j(y) if relu else None,
                         jnp.asarray(mean.numpy()), jnp.asarray(rstd.numpy()))
    plan = N.colsum_vec_plan(n, c, 2)
    terms = order.bwd_sums_terms(_f32(x), _f32(dy), _f32(y) if relu else
                                 None, mean.numpy(), rstd.numpy())
    depth = N.colsum_vec_depth(plan, c) + n
    for row, t in zip(want, terms):
        got, _ = order.colsum_vec_sum(t, plan)
        bound = depth * 2.0 ** -24 * np.abs(t.astype(np.float64)).sum(0)
        assert (np.abs(got - row) <= bound).all()
    plain = N.bn_bwd_sums_plain(x, dy, y if relu else None, mean, rstd)
    np.testing.assert_allclose(plain.numpy(), want, rtol=1e-4, atol=1e-4)


POOL_WINDOWS = [(7, 7), (2, 2), (3, 3), (8, 8), (13, 13), (4, 5), (56, 56),
                (1, 1), (20, 3)]


@pytest.mark.parametrize("kh,kw", POOL_WINDOWS)
@pytest.mark.parametrize("c,size,aligned", [(1024, 2, True), (32, 4, True),
                                            (20, 2, True), (64, 2, False)])
def test_pool_plan_takes_every_cell_once(kh, kw, c, size, aligned):
    plan = P.pool_fwd_plan(c, kh, kw, size, aligned)
    vw = 16 // size
    assert plan.vec == (vw if aligned and c % vw == 0 else 1)
    assert 1 <= plan.ry <= min(kh, P.POOL_MAX_SPLIT)
    assert plan.bx % 32 == 0 and plan.bx * plan.ry <= 512
    cells = [cell for ty in range(plan.ry)
             for cell in order.pool_cells(plan, kh, kw, ty)]
    assert sorted(cells) == [(r, s) for r in range(kh) for s in range(kw)]
    chain = max(len(order.pool_cells(plan, kh, kw, ty))
                for ty in range(plan.ry)) + plan.ry
    assert chain == order.pool_fwd_depth(plan, kh, kw)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("shape,kh,kw,avg,relu", [
    ((16, 7, 7, 256), 7, 7, True, False),       # Inception-BN's head
    ((8, 8, 8, 32), 2, 2, False, False),         # the digits LeNet's tiles
    ((16, 12, 20, 40), 4, 4, False, True),
    ((16, 13, 13, 64), 13, 13, True, False),
    ((16, 56, 56, 8), 56, 56, True, False),      # rows split 16 ways
])
def test_pool_order_meets_one_ulp(shape, kh, kw, avg, relu, dtype):
    """The kernel's order of a window sum (emulated in f32), rounded to
    the dtype and scaled as the kernel scales avg: within one ulp of the
    dtype (plus 1e-6) of the plain version and of the JAX package's
    interpreted kernel."""
    rs = np.random.RandomState(kh * 100 + kw)
    x = torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(dtype)
    xin = torch.relu(x) if relu else x
    plan = P.pool_fwd_plan(shape[-1], kh, kw, x.element_size())
    s, chain = order.pool_sum(_f32(xin), kh, kw, plan)
    assert chain == order.pool_fwd_depth(plan, kh, kw)
    got = torch.from_numpy(s).to(dtype)
    if avg:
        scale = P.scale_in_dtype(1.0 / (kh * kw), dtype)
        got = (got.float() * scale).to(dtype)
    plain = P.pool_fwd_plain(x, kh, kw, "sum", avg, relu)
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}[dtype]
    jax_y = jax_pool(jnp.asarray(_f32(x)).astype(jdt), kh, kw, kh, (0, 0),
                     (0, 0), "sum", avg, relu, interpret=True)
    assert jax_y is not None
    for want in (plain.float().numpy(), np.asarray(jax_y.astype(jnp.float32))):
        err = np.abs(_f32(got) - want)
        assert (err <= ULP[dtype] * np.abs(want) + 1e-6).all(), err.max()
