"""The launch plan of the first-match max-pool backward
(``csrc/pool_bwd_max.cu``) on the CPU, and its arithmetic emulated.

``pool_bwd_max_plan`` gives a thread one vector of channels of one
output and one row of its window (a block of bx output vectors by ry
rows; a window taller than ry rows goes in rounds). The plan must take
every cell of x once, with a vector that divides C and the bases'
alignment, within the kernel's launch bound of 512 threads a block (one
mask byte each in shared memory).

The kernel's per-thread work is emulated in numpy on the plan's mapping,
with the kernel's own index arithmetic (the output's window from the
output vector's index, the row from the round and thread y): y and dy
loaded once, the row's x vectors in chunks of CHUNK (the kernel's rows
of kw 2 and 3 compiled in are one such chunk), the row's first matching
column per lane, the row masks, the OR of
the earlier rows' masks (and of the earlier rounds'), then kw stores of
dy or +0 a row into a dx filled with NaN first, so that a cell nothing
wrote shows, and a count of the writes. The emulation must be bit-equal
to ``pool_bwd_max_plain`` on tie-ridden integer inputs, NaN cells and
maxima, windows of non-positive values, with ``pre_relu`` on and off,
and, where the JAX kernel reaches (16 cells at most), to the vjp of the
JAX package's ``fused_pool`` in interpret mode. The inputs are
``chip_smoke.pool_bwd_case``'s, as the card test and phase 3 make them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import pool_bwd_case
from cxxnet_tpu.ops.fused_pool import fused_pool as jax_pool
from cxxnet_tpu_torch.ops import fused_pool as P

ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2, torch.float16: 2}
DTYPES = list(ITEMSIZE)
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
       torch.float16: jnp.float16}

#: x vectors a run-time row loads before it compares (csrc/pool_bwd_max.cu
#: kChunk); first match in ascending column order makes any chunk
#: bit-equal, so CHUNK only decides which cases take a row in more than
#: one chunk
CHUNK = 4

PLAN_C = [1, 5, 20, 40, 64, 256]
PLAN_K = [1, 2, 3, 7, 13, 16, 17, 27]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("k", PLAN_K)
@pytest.mark.parametrize("c", PLAN_C)
def test_plan_vector_rows_and_block(c, k, dtype):
    s = ITEMSIZE[dtype]
    for align in (16, 8, s):
        p = P.pool_bwd_max_plan(c, k, k, s, align)
        assert c % p.vec == 0 and align % (p.vec * s) == 0
        assert p.vec * s <= 16 and p.vec & (p.vec - 1) == 0
        # the widest such vector
        assert p.vec == max(v for v in (1, 2, 4, 8) if v * s <= 16
                            and c % v == 0 and align % (v * s) == 0)
        assert p.ry == min(k, P.POOL_MAX_SPLIT)
        assert p.bx % 32 == 0 and p.bx >= 32
        assert p.bx * p.ry <= 512       # the kernel's launch bound
        assert p.bx * p.ry <= max(P.POOL_BWD_THREADS, 32 * p.ry)


def test_plan_refuses_an_empty_window():
    with pytest.raises(ValueError, match="c, kh, kw"):
        P.pool_bwd_max_plan(0, 3, 3, 2)
    with pytest.raises(ValueError, match="c, kh, kw"):
        P.pool_bwd_max_plan(8, 0, 3, 2)


# -- the kernel, emulated -----------------------------------------------------

def emulate(x, y, dy, kh, kw, pre_relu, plan):
    """dx of the kernel and how many times each cell was written, for x
    (B, H, W, C) and y, dy (B, H/kh, W/kw, C) as float32 arrays of the
    dtype's values, walking the plan's threads as the kernel does."""
    B, H, W, C = x.shape
    oy, ox, V = H // kh, W // kw, plan.vec
    xf, yf, gf = x.reshape(-1), y.reshape(-1), dy.reshape(-1)
    dx = np.full(xf.shape, np.nan, np.float32)
    writes = np.zeros(xf.shape, np.int64)
    n_vec = B * oy * ox * (C // V)
    blocks = -(-n_vec // plan.bx)
    o = (np.arange(blocks)[:, None] * plan.bx
         + np.arange(plan.bx)[None, :]).ravel()
    o = o[o < n_vec]                                   # the live threads
    cvs = C // V
    r, cv = o // cvs, o % cvs
    q, j = r // ox, r % ox
    b, i = q // oy, q % oy
    off = ((b * H + i * kh) * W + j * kw) * C + cv * V
    lanes = np.arange(V)
    ym = yf[o[:, None] * V + lanes]                    # (n, V)
    g = gf[o[:, None] * V + lanes]
    taken = np.zeros(len(o), np.uint32)
    for rd in range(-(-kh // plan.ry)):
        masks, firsts = [], []
        for ty in range(plan.ry):
            u = rd * plan.ry + ty
            first = np.full((len(o), V), -1)
            if u < kh:
                row = off + u * W * C
                for w0 in range(0, kw, CHUNK):
                    v = [xf[(row + (w0 + c) * C)[:, None] + lanes]
                         for c in range(min(CHUNK, kw - w0))]
                    for c, e in enumerate(v):
                        hit = (first < 0) & (e == ym)
                        if pre_relu:
                            hit &= e > 0
                        first[hit] = w0 + c
            masks.append(((first >= 0) << lanes).sum(1).astype(np.uint32))
            firsts.append(first)
        # one __syncthreads(): each row reads every row's mask
        for ty in range(plan.ry):
            u = rd * plan.ry + ty
            before = taken.copy()
            for t in range(ty):
                before |= masks[t]
            first = np.where((before[:, None] >> lanes) & 1, -1, firsts[ty])
            if u < kh:
                row = off + u * W * C
                for w in range(kw):
                    cells = (row + w * C)[:, None] + lanes
                    dx[cells] = np.where(first == w, g, np.float32(0))
                    writes[cells] += 1
        for m in masks:
            taken |= m
    return dx.reshape(x.shape), writes.reshape(x.shape)


def _f32(t):
    return t.float().numpy()


def _same(a, b):
    """Bit-equal float32 arrays (NaN and the sign of zero included)."""
    return np.array_equal(np.asarray(a, np.float32).view(np.uint32),
                          np.asarray(b, np.float32).view(np.uint32))


# (inputs, x shape, window): spp1's 3x3 and the LeNet's 2x2 tiles, the
# first match in another row on each lane, C that no 16-byte vector
# divides, NaN, non-positive windows, global 7x7 and 13x13 (rows in
# chunks) and a global 27x27 (two rounds of 16 rows)
CASES = [("ints", (4, 9, 9, 64), 3), ("ints", (4, 8, 8, 32), 2),
         ("rows", (3, 9, 9, 64), 3), ("rows", (3, 8, 8, 16), 2),
         ("ints", (3, 9, 9, 5), 3), ("ints", (3, 6, 6, 20), 2),
         ("ints", (3, 9, 9, 40), 3), ("nan", (4, 9, 9, 64), 3),
         ("nonpos", (4, 9, 9, 64), 3), ("ints", (6, 7, 7, 40), 7),
         ("rows", (4, 7, 7, 24), 7), ("ints", (4, 13, 13, 16), 13),
         ("rows", (2, 13, 13, 16), 13), ("ints", (2, 27, 27, 8), 27)]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("relu", [False, True], ids=["max", "relu_max"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[2]}x"
                         f"{c[2]}-C{c[1][3]}")
def test_emulated_kernel_is_bit_equal_to_plain(case, relu, dtype):
    kind, shape, k = case
    s = ITEMSIZE[dtype]
    x, y, dy = pool_bwd_case(shape[3] + k, kind, shape, k, dtype, relu,
                             "cpu")
    want = _f32(P.pool_bwd_max_plain(x, y, dy, k, k, relu))
    for align in (16, s):                   # a base one element past 16
        plan = P.pool_bwd_max_plan(shape[3], k, k, s, align)
        got, writes = emulate(_f32(x), _f32(y), _f32(dy), k, k, relu, plan)
        assert (writes == 1).all()
        assert _same(got, want)
    if kind == "nonpos" and relu:
        assert not want.any()               # relu's zero-at-zero gradient
    if kind == "nan":
        assert np.isnan(_f32(y)).any() and np.isnan(_f32(x)).any()


def test_the_cases_reach_every_kernel_path():
    """16-byte and narrower vectors, rows in one chunk and in more, and
    more than one round."""
    seen = set()
    for _, shape, k in CASES:
        for s in (2, 4):
            p = P.pool_bwd_max_plan(shape[3], k, k, s)
            seen.add(("16 bytes" if p.vec * s == 16 else "narrow",
                      -(-k // p.ry) > 1, k > CHUNK))
    assert ("16 bytes", False, False) in seen
    assert ("narrow", False, False) in seen
    assert ("16 bytes", False, True) in seen
    assert ("16 bytes", True, True) in seen


# cases within the JAX kernel's reach: tiling windows of at most 16 cells
JAX_CASES = [("ints", (16, 9, 9, 16), 3), ("rows", (16, 9, 9, 16), 3),
             ("ints", (16, 8, 8, 16), 2), ("rows", (16, 8, 8, 16), 2),
             ("nonpos", (16, 9, 9, 16), 3)]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("relu", [False, True], ids=["max", "relu_max"])
@pytest.mark.parametrize("case", JAX_CASES, ids=lambda c: f"{c[0]}-{c[2]}x"
                         f"{c[2]}")
def test_emulated_kernel_matches_the_jax_kernel(case, relu, dtype):
    kind, shape, k = case
    s = ITEMSIZE[dtype]
    x, y, dy = pool_bwd_case(7 + k, kind, shape, k, dtype, relu, "cpu")
    call = lambda a: jax_pool(a, k, k, k, (0, 0), (0, 0), "max", False,
                              relu, interpret=True)
    xj = jnp.asarray(_f32(x)).astype(JDT[dtype])
    dyj = jnp.asarray(_f32(dy)).astype(JDT[dtype])
    assert "pallas_call" in str(jax.make_jaxpr(
        lambda a, d: jax.vjp(call, a)[1](d))(xj, dyj))
    yj, vjp = jax.vjp(call, xj)
    np.testing.assert_array_equal(np.asarray(yj.astype(jnp.float32)),
                                  _f32(y))
    want = np.asarray(vjp(dyj)[0].astype(jnp.float32))
    plan = P.pool_bwd_max_plan(shape[3], k, k, s)
    got, _ = emulate(_f32(x), _f32(y), _f32(dy), k, k, relu, plan)
    np.testing.assert_array_equal(got, want)
