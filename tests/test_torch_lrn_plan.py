"""The launch plan of the LRN kernels (``csrc/lrn_fwd.cu``,
``csrc/lrn_bwd.cu``, ``csrc/lrn_tile.cuh``) on the CPU.

``lrn_plan`` gives a block whole rows, or chunks of a row where a row's
vectors outgrow one block, and each thread one vector of channels. The
plan must take every row once and every channel of it once, with a
vector that divides C and the bases' alignment, within the shared memory
of an H100, and chunk exactly where a row does not fit a block.

The kernels' per-thread arithmetic is emulated in numpy float32 on the
plan's mapping (each operation rounded as the card's ``__fmul_rn``,
``__fadd_rn`` and ``__fdiv_rn``; ``exp`` and ``log`` through torch, as
the plain versions take them): the f32 tile at its padded positions,
filled with NaN first so that a read of a slot nothing wrote shows; the
window sums added in ascending order from the tile; the halo of a chunk.
The emulation must be bit-equal to ``lrn_plain`` and ``lrn_bwd_plain``:
the redesign kept both orders of summation.
"""

import numpy as np
import pytest
import torch

from cxxnet_tpu_torch.ops import fused_lrn as L

ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2, torch.float16: 2}
DTYPES = list(ITEMSIZE)
ALPHA, BETA = 0.1, 0.75


def _one_past(itemsize):
    """The first C, a multiple of the widest vector, whose row outgrows a
    block."""
    return (L.LRN_MAX_TPR + 1) * (16 // itemsize)


PLAN_C = [1, 7, 33, 96, 256, 1500, 4096, "one past"]
PLAN_N = {1: 1, 7: 37, 33: 105, 96: 186624, 256: 43264, 1500: 3,
          4096: 5, "one past": 3}


def _owners(n, c, plan):
    """(row, channel) -> how many threads of the grid take it (block x
    owns rows [x * rows, (x + 1) * rows), masked past n)."""
    seen = np.zeros((n, c), np.int64)
    for by in range(-(-c // plan.chunk)):
        c0 = by * plan.chunk
        ch = c0 + np.arange(plan.tpr)[:, None] * plan.vec \
            + np.arange(plan.vec)[None, :]
        ok = (c0 + np.arange(plan.tpr) * plan.vec < c)
        cols = ch[ok].ravel()
        np.add.at(seen, (slice(None), cols), 1)
    return seen


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("nsize", [1, 3, 4, 5, 9])
@pytest.mark.parametrize("c", PLAN_C, ids=str)
def test_plan_takes_every_row_and_channel_once(c, nsize, dtype):
    s = ITEMSIZE[dtype]
    n = PLAN_N[c]
    if c == "one past":
        c = _one_past(s)
    for align in (16, s):
        p = L.lrn_plan(n, c, s, nsize, align)
        assert c % p.vec == 0 and align % (p.vec * s) == 0
        assert p.vec * s <= 16 and p.vec & (p.vec - 1) == 0
        if align == 16:           # the widest vector C allows
            assert p.vec == max(v for v in (1, 2, 4, 8)
                                if v * s <= 16 and c % v == 0)
        else:
            assert p.vec == 1
        assert p.tpr * p.vec == p.chunk
        assert p.tpr * p.rows <= L.LRN_MAX_TPR
        assert p.smem == p.rows * p.stride * 4 <= 227 * 1024
        assert p.stride >= L.tile_pos(p.chunk + 2 * (nsize - 1) - 1,
                                      p.vec) + 1
        chunked = p.chunk < c
        assert chunked == (c // p.vec > L.LRN_MAX_TPR)
        if chunked:
            assert p.chunk == L.LRN_MAX_TPR * p.vec and p.rows == 1
            assert p.tpr >= nsize - 1
        else:
            assert p.chunk == c
            assert p.rows == max(1, min(L.LRN_THREADS // p.tpr, n))
        seen = _owners(min(n, 64), c, p)
        assert (seen == 1).all()


def test_the_chunks_start_one_past_the_one_row_limit():
    for s in (2, 4):
        last = L.LRN_MAX_TPR * (16 // s)
        assert L.lrn_plan(7, last, s, 5).chunk == last
        assert L.lrn_plan(7, _one_past(s), s, 5).chunk == last
    # a misaligned base narrows the vector, and the row then outgrows a
    # block sooner
    assert L.lrn_plan(7, 4096, 2, 5, align=2).chunk == L.LRN_MAX_TPR


def test_the_plan_refuses_a_tile_past_the_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        L.lrn_plan(4, 96, 2, 60000)
    with pytest.raises(ValueError, match="halo"):
        L.lrn_plan(4, 8 * 1024, 2, L.LRN_MAX_TPR + 2)


# -- the kernels' arithmetic, emulated ---------------------------------------

F32 = np.float32


def _pos(q, vec):
    return q + q // vec if vec > 1 else q


class _Block:
    """One block's shared tile and its threads' places (thread_tile +
    tile_pos of the kernels), vectorised over (row, thread, k)."""

    def __init__(self, x, plan, nsize, bx, by):
        self.n, self.c = x.shape
        self.p, self.h, self.half = plan, nsize - 1, nsize // 2
        self.nsize = nsize
        R, tpr, V = plan.rows, plan.tpr, plan.vec
        self.rows = bx * R + np.arange(R)
        self.c0 = by * plan.chunk
        self.row_ok = self.rows < self.n
        ch = self.c0 + np.arange(tpr)[:, None] * V + np.arange(V)
        self.ch = np.broadcast_to(ch, (R, tpr, V))
        self.ok = self.row_ok[:, None, None] & (
            (self.c0 + np.arange(tpr) * V) < self.c)[None, :, None]
        self.ok = np.broadcast_to(self.ok, (R, tpr, V))
        self.base = (np.arange(R) * plan.stride)[:, None, None] \
            + (np.arange(tpr) * (V + 1 if V > 1 else 1))[None, :, None]
        self.tile = np.full(R * plan.stride, np.nan, F32)

    def own(self, a):
        """``a`` (n, c) at the threads' channels, 0 where not ok."""
        r = np.minimum(self.rows, self.n - 1)[:, None, None]
        return np.where(self.ok, a[r, np.minimum(self.ch, self.c - 1)],
                        F32(0)).astype(F32)

    def slot(self, q):
        """Where slot tx * V + q of each thread's row lies."""
        return self.base + _pos(q, self.p.vec)

    def stage_own(self, v):
        k = np.arange(self.p.vec)
        self.tile[self.slot(self.h + k)] = v

    def stage_halo(self, sq):
        h, R, chunk = self.h, self.p.rows, self.p.chunk
        for s in range(2 * h):
            slot = s if s < h else chunk + s
            c = self.c0 - h + slot
            for r in range(R):
                row = self.rows[r]
                v = sq[row, c] if self.row_ok[r] and 0 <= c < self.c \
                    else F32(0)
                self.tile[r * self.p.stride + _pos(slot, self.p.vec)] = v

    def window(self, off):
        """The window sums from slot tx * V + off + k, in ascending
        order from 0."""
        k = np.arange(self.p.vec)
        s = np.zeros(self.ok.shape, F32)
        for m in range(self.nsize):
            s = (s + self.tile[self.slot(off + k + m)]).astype(F32)
        return s


def _scale(win, ab, knorm, nbeta):
    """norm and p as the kernels (and the plain versions) round them."""
    norm = (F32(knorm) + F32(ab) * win).astype(F32)
    return norm, torch.exp(nbeta * torch.log(torch.from_numpy(norm))).numpy()


def emulate_fwd(x, plan, nsize, alpha, beta, knorm):
    """``lrn_fwd``'s f32 y over (n, c) rows ``x`` (float32 numpy)."""
    n, c = x.shape
    ab, sq = alpha / nsize, (x * x).astype(F32)
    y = np.full((n, c), np.nan, F32)
    for bx in range(-(-n // plan.rows)):
        for by in range(-(-c // plan.chunk)):
            b = _Block(x, plan, nsize, bx, by)
            xv = b.own(x)
            b.stage_own((xv * xv).astype(F32))
            b.stage_halo(sq)
            win = b.window(b.h - b.half)
            _, p = _scale(win, ab, knorm, -beta)
            out = (xv * p).astype(F32)
            y[b.rows[:, None, None].repeat(plan.tpr, 1).repeat(
                plan.vec, 2)[b.ok], b.ch[b.ok]] = out[b.ok]
    return y


def emulate_bwd(x, dy, plan, nsize, alpha, beta, knorm):
    """``lrn_bwd``'s f32 dx over (n, c) rows (float32 numpy)."""
    n, c = x.shape
    ab = alpha / nsize
    coef = F32(2.0 * ab * beta)
    sq = (x * x).astype(F32)
    dx = np.full((n, c), np.nan, F32)
    for bx in range(-(-n // plan.rows)):
        for by in range(-(-c // plan.chunk)):
            b = _Block(x, plan, nsize, bx, by)
            h, half = b.h, b.half
            xv, dyv = b.own(x), b.own(dy)
            b.stage_own((xv * xv).astype(F32))
            b.stage_halo(sq)
            norm, p = _scale(b.window(h - half), ab, knorm, -beta)
            t = np.where(b.ok, ((dyv * xv).astype(F32)
                                * (p / norm).astype(F32)).astype(F32),
                         F32(0))
            halo = []
            if plan.chunk < c:                  # chunks: t of the halo
                for tx in range(min(h, plan.tpr)):
                    ht = half + tx if tx < h - half else plan.chunk + half + tx
                    ch = b.c0 - h + ht
                    for r in range(plan.rows):
                        th = F32(0)
                        row = b.rows[r]
                        if b.row_ok[r] and 0 <= ch < c:
                            win = F32(0)
                            for m in range(nsize):
                                win = F32(win + b.tile[
                                    r * plan.stride
                                    + _pos(ht - half + m, plan.vec)])
                            hn, hp = _scale(np.array([win], F32), ab, knorm,
                                            -beta)
                            th = F32(F32(dy[row, ch] * x[row, ch])
                                     * F32(hp[0] / hn[0]))
                        halo.append((r * plan.stride + _pos(ht, plan.vec),
                                     th))
            b.stage_own(t)
            for at, th in halo:
                b.tile[at] = th
            back = b.window(half)
            g = ((dyv * p).astype(F32)
                 - ((coef * xv).astype(F32) * back).astype(F32)).astype(F32)
            rows = b.rows[:, None, None].repeat(plan.tpr, 1).repeat(
                plan.vec, 2)
            dx[rows[b.ok], b.ch[b.ok]] = g[b.ok]
    return dx


def _bits_equal(got, want):
    """Equal bit for bit, a NaN wherever the other has one."""
    g, w = got.float().numpy(), want.float().numpy()
    nan = np.isnan(w)
    return (np.isnan(g) == nan).all() and np.array_equal(
        g[~nan].view(np.uint32), w[~nan].view(np.uint32))


#: (n, c, align in bytes): whole rows at the widest vectors and at narrow
#: ones (C 7 and 33 odd, a misaligned base), ragged row blocks, and a
#: row cut into chunks (the second one ragged)
EMU_CASES = [(5, 7, 16), (37, 33, 16), (23, 96, 16), (9, 40, 16),
             (11, 36, 16), (30, 96, 2), (2, 520, 2)]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("nsize,knorm", [(1, 1.0), (3, 2.0), (4, 1.0),
                                         (5, 1.0), (9, 2.0)])
@pytest.mark.parametrize("n,c,align", EMU_CASES, ids=str)
def test_emulated_kernels_are_bit_equal_to_the_plain_versions(
        n, c, align, nsize, knorm, dtype):
    rs = np.random.RandomState(n * 131 + c)
    x = torch.from_numpy(rs.randn(n, c).astype(F32) * 3).to(dtype)
    dy = torch.from_numpy(rs.randn(n, c).astype(F32)).to(dtype)
    plan = L.lrn_plan(n, c, ITEMSIZE[dtype], nsize, align)
    assert (plan.chunk < c) == (c == 520)
    x4, dy4 = x.reshape(1, 1, n, c), dy.reshape(1, 1, n, c)
    xf, dyf = x.float().numpy(), dy.float().numpy()
    y = torch.from_numpy(emulate_fwd(xf, plan, nsize, ALPHA, BETA, knorm))
    assert _bits_equal(y.to(dtype), L.lrn_plain(x4, nsize, ALPHA, BETA,
                                                knorm).reshape(n, c))
    dx = torch.from_numpy(emulate_bwd(xf, dyf, plan, nsize, ALPHA, BETA,
                                      knorm))
    assert _bits_equal(dx.to(dtype), L.lrn_bwd_plain(
        x4, dy4, nsize, ALPHA, BETA, knorm).reshape(n, c))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_emulated_kernels_keep_the_plain_nan_and_inf(dtype):
    rs = np.random.RandomState(7)
    n, c = 6, 33
    xa = rs.randn(n, c).astype(F32) * 3
    xa[1, 4], xa[3, 20] = np.inf, np.nan
    x = torch.from_numpy(xa).to(dtype)
    dy = torch.from_numpy(rs.randn(n, c).astype(F32)).to(dtype)
    plan = L.lrn_plan(n, c, ITEMSIZE[dtype], 5)
    x4, dy4 = x.reshape(1, 1, n, c), dy.reshape(1, 1, n, c)
    xf, dyf = x.float().numpy(), dy.float().numpy()
    want = L.lrn_plain(x4, 5, ALPHA, BETA, 1.0).reshape(n, c)
    assert torch.isnan(want).any() and (want == 0).any()
    with np.errstate(invalid="ignore"):     # inf * 0 is the NaN expected
        y = torch.from_numpy(emulate_fwd(xf, plan, 5, ALPHA, BETA, 1.0))
        dx = torch.from_numpy(emulate_bwd(xf, dyf, plan, 5, ALPHA, BETA,
                                          1.0))
    assert _bits_equal(y.to(dtype), want)
    assert _bits_equal(dx.to(dtype), L.lrn_bwd_plain(
        x4, dy4, 5, ALPHA, BETA, 1.0).reshape(n, c))
