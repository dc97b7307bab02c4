"""The orders in which the port's vectorised reductions add, emulated
in numpy float32 (each addition rounded as the card's ``__fadd_rn``):

* the batch-norm moments of ``bn_fwd`` and ``bn_sums``, ``bn_bwd_sums``
  and the epilogue's dbias (``csrc/colsum_vec.cuh`` under
  ``colsum_vec_plan``, with two sums a channel and with one): each
  lane of a row block adds its rows in order, the lanes' sums are added
  in lane order, the last CTA adds the row blocks' partials in runs and
  then the runs in order;
* ``pool_fwd`` (``csrc/pool_fwd.cu`` under ``pool_fwd_plan``): thread y
  of a window adds its rows y, y + ry, ... cell by cell, then the ry
  threads' sums are added in order.

The statistics ``bn_fwd``'s normalize forms from the moments
(``csrc/bn_moments.cuh``'s formula), and the walk of the batch-norm
backward's dx pass (``bn_dx_vec`` of
``csrc/bn_bwd_vec.cuh`` under ``bn_dx_plan``) over the vectors of the
rows, which the normalize (``bn_norm_vec`` of ``csrc/bn_norm_vec.cuh``)
takes with its own rows in flight, with the relu mask bits that
``bn_bwd``'s sums pass packs and its dx pass reads.

Each emulation also counts the additions on the longest chain behind
one result, which the depth functions (``colsum_vec_depth`` of the
port, :func:`pool_fwd_depth` here) must equal. No jax here:
``tests/test_torch_cuda.py`` imports this module on the card.
"""

from typing import Tuple

import numpy as np

from cxxnet_tpu_torch.ops import fused_norm as N
from cxxnet_tpu_torch.ops import fused_pool as P


def _seq(parts: np.ndarray, axis: int) -> np.ndarray:
    """float32 sum of ``parts`` along ``axis``, one rounded addition at a
    time from 0, in index order."""
    parts = np.moveaxis(parts.astype(np.float32), axis, 0)
    t = np.zeros(parts.shape[1:], np.float32)
    for p in parts:
        t = t + p
    return t


def bwd_sums_terms(x, dy, y, mean, rstd) -> Tuple[np.ndarray, np.ndarray]:
    """The kernel's f32 terms over (n, c) rows (numpy, any float dtype):
    ``dy'`` (dy masked by y > 0 when y is given) and ``dy' * x_hat`` with
    ``x_hat = (x - mean) * rstd``, each operation rounded to f32."""
    d = np.asarray(dy, np.float32)
    if y is not None:
        d = np.where(np.asarray(y, np.float32) > 0, d, np.float32(0))
    xh = (np.asarray(x, np.float32) - np.asarray(mean, np.float32)) \
        * np.asarray(rstd, np.float32)
    return d, (d * xh).astype(np.float32)


def moments_terms(x) -> Tuple[np.ndarray, np.ndarray]:
    """The one-pass moments' f32 terms over (n, c) rows (numpy, any float
    dtype): ``x`` and ``x * x``, the product rounded to f32."""
    x = np.asarray(x, np.float32)
    return x, (x * x).astype(np.float32)


def sqdev_terms(x, s1, n: int) -> np.ndarray:
    """The two-pass second sum's f32 terms: ``(x - mean)^2`` with ``mean
    = s1 / n`` rounded once a channel, each operation rounded to f32."""
    d = np.asarray(x, np.float32) - bn_mean(s1, n)
    return (d * d).astype(np.float32)


def bn_mean(s1, n: int) -> np.ndarray:
    """``mean = S1 / n`` in float32, rounded once (``__fdiv_rn``)."""
    return (np.asarray(s1, np.float32) / np.float32(n)).astype(np.float32)


def bn_stats(s1, s2, n: int, two_pass: bool = False):
    """``(mean, var)`` of ``csrc/bn_moments.cuh``'s formula in float32:
    ``mean = S1 / n``; one-pass ``var = S2 / n - mean * mean`` clamped at
    0 with a NaN kept (``v < 0 ? 0 : v``); two-pass ``var = S2 / n`` with
    S2 the sum of squared deviations. Each operation rounded to f32."""
    mean = bn_mean(s1, n)
    s2n = (np.asarray(s2, np.float32) / np.float32(n)).astype(np.float32)
    if two_pass:
        return mean, s2n
    var = (s2n - mean * mean).astype(np.float32)
    return mean, np.where(var < 0, np.float32(0), var).astype(np.float32)


def lane_rows(plan: N.ColsumPlan, n: int, block: int, lane: int):
    """The rows lane ``lane`` of row block ``block`` adds, in order."""
    r0 = block * plan.rows_per
    return np.arange(r0 + lane, min(n, r0 + plan.rows_per), plan.lanes)


def tile_channels(plan: N.ColsumPlan, c: int, tile: int, cg: int):
    """The channels channel group ``cg`` of tile ``tile`` loads (none
    past the last channel)."""
    c0 = (tile * plan.cgt + cg) * plan.vec
    return np.arange(c0, min(c, c0 + plan.vec))


def colsum_vec_sum(terms: np.ndarray, plan: N.ColsumPlan, sums: int = 2
                   ) -> Tuple[np.ndarray, int]:
    """The column sums of ``terms`` (n, c) float32 in the kernel's order
    for an op of ``sums`` sums a channel (the last CTA's runs depend on
    it), and the additions on the longest chain behind one of them."""
    n, c = terms.shape
    g, rp, lanes = plan.blocks, plan.rows_per, plan.lanes
    k = -(-rp // lanes)
    padded = np.zeros((g * k * lanes, c), np.float32)
    for b in range(g):          # each block's rows, then zeros to k * lanes
        rows = terms[b * rp:min(n, (b + 1) * rp)]
        padded[b * k * lanes:b * k * lanes + len(rows)] = rows
    per_lane = _seq(padded.reshape(g, k, lanes, c), 1)     # (g, lanes, c)
    part = _seq(per_lane, 1)                                # (g, c)
    out = np.zeros(c, np.float32)
    for lo, hi, runs in _tiles(plan, c, sums):
        gper = -(-g // runs)
        run_sums = np.stack([_seq(part[j * gper:(j + 1) * gper, lo:hi], 0)
                             for j in range(runs)])
        out[lo:hi] = _seq(run_sums, 0)
    return out, colsum_vec_chain(plan, n, c, sums)


def colsum_vec_sum_blocks(terms_of, plan: N.ColsumPlan, n: int, c: int,
                          chunk: int = 1 << 21, sums: int = 2):
    """:func:`colsum_vec_sum` over rows too many to hold at once:
    ``terms_of(r0, r1)`` gives a tuple of (r1 - r0, c) float32 term arrays
    of rows r0 to r1, taken a run of whole row blocks (about ``chunk``
    elements) at a time. Returns, for each array of the tuple, its sums in
    the kernel's order, the float64 sums and the float64 sums of the
    magnitudes of the same terms. ``sums``: the op's sums a channel, as
    for :func:`colsum_vec_sum`."""
    g, rp, lanes = plan.blocks, plan.rows_per, plan.lanes
    k = -(-rp // lanes)
    per = max(1, chunk // max(1, rp * c))
    part, exact, mag = None, None, None
    for b0 in range(0, g, per):
        b1 = min(g, b0 + per)
        r0, r1 = b0 * rp, min(n, b1 * rp)
        ts = [np.asarray(t, np.float32) for t in terms_of(r0, r1)]
        if part is None:
            part = np.zeros((len(ts), g, c), np.float32)
            exact = np.zeros((len(ts), c), np.float64)
            mag = np.zeros((len(ts), c), np.float64)
        for q, t in enumerate(ts):
            exact[q] += t.astype(np.float64).sum(0)
            mag[q] += np.abs(t.astype(np.float64)).sum(0)
            padded = np.zeros(((b1 - b0) * k * lanes, c), np.float32)
            for b in range(b0, b1):
                rows = t[(b - b0) * rp:min(n, (b + 1) * rp) - r0]
                at = (b - b0) * k * lanes
                padded[at:at + len(rows)] = rows
            part[q, b0:b1] = _seq(_seq(padded.reshape(b1 - b0, k, lanes, c),
                                       1), 1)
    out = []
    for q in range(len(part)):
        got = np.zeros(c, np.float32)
        for lo, hi, runs in _tiles(plan, c, sums):
            gper = -(-g // runs)
            got[lo:hi] = _seq(np.stack(
                [_seq(part[q, j * gper:(j + 1) * gper, lo:hi], 0)
                 for j in range(runs)]), 0)
        out.append((got, exact[q], mag[q]))
    return out


def _tiles(plan: N.ColsumPlan, c: int, sums: int = 2):
    """(first channel, end, runs of the last CTA) of each channel tile."""
    tile = plan.cgt * plan.vec
    for t in range(plan.tiles):
        lo, hi = t * tile, min(c, (t + 1) * tile)
        yield lo, hi, N.colsum_vec_runs(plan, hi - lo, sums)


def colsum_vec_chain(plan: N.ColsumPlan, n: int, c: int,
                     sums: int = 2) -> int:
    """The additions on the longest chain behind one column sum of an op
    of ``sums`` sums a channel, counted from the rows each lane takes,
    the lanes, and the runs of row blocks the last CTA of each tile
    adds."""
    lane_max = max(len(lane_rows(plan, n, b, lane))
                   for b in range(plan.blocks) for lane in range(plan.lanes))
    longest = 0
    for _, _, runs in _tiles(plan, c, sums):
        gper = -(-plan.blocks // runs)
        run_max = max(len(range(j * gper, min(plan.blocks, (j + 1) * gper)))
                      for j in range(runs))
        longest = max(longest, lane_max + plan.lanes + run_max + runs)
    return longest


def dx_walk(plan: N.DxPlan, n: int, c: int, rows: int = N.BN_DX_ROWS):
    """The vectors the dx pass's threads take, in the kernel's loop: thread
    t < lanes * groups starts at vector t and takes ``rows`` vectors
    ``stride`` apart while the last of them is in range, then one at a
    time (the normalize walks the same way with N.BN_NORM_ROWS). Yields
    (threads, vectors) array pairs, one a step of the loop, vector v of
    the (n * c / vec) being elements v * vec to v * vec + vec of the flat
    rows."""
    groups = c // plan.vec
    stride = plan.lanes * groups
    assert stride <= plan.blocks * N.BN_DX_THREADS
    nv = n * c // plan.vec
    t = np.arange(stride, dtype=np.int64)
    v = t.copy()
    while True:
        main = v + (rows - 1) * stride < nv
        if not main.any():
            break
        for u in range(rows):
            yield t[main], v[main] + u * stride
        v = np.where(main, v + rows * stride, v)
    while True:
        live = v < nv
        if not live.any():
            return
        yield t[live], v[live]
        v = v + stride


def pack_bits(y: np.ndarray, plan: N.ColsumPlan) -> np.ndarray:
    """The relu mask bits the sums pass of ``bn_bwd`` writes over (n, c)
    rows ``y`` under ``plan`` (16-byte loads): at each (row, channel group)
    a lane of a tile loads, byte (row * c + c0) / vec, bit k = y[row, c0 +
    k] > 0 (a NaN gives 0). Returns the bytes and how many times each was
    written."""
    n, c = y.shape
    vec = plan.vec
    out = np.zeros(n * c // vec, np.uint8)
    writes = np.zeros(n * c // vec, np.int64)
    rows = np.concatenate([lane_rows(plan, n, b, lane)
                           for b in range(plan.blocks)
                           for lane in range(plan.lanes)])
    weights = (1 << np.arange(vec)).astype(np.uint8)
    for t in range(plan.tiles):
        for cg in range(plan.cgt):
            ch = tile_channels(plan, c, t, cg)
            if len(ch) == 0:
                continue
            on = (y[rows[:, None], ch[None, :]] > 0).astype(np.uint8)
            at = (rows * c + ch[0]) // vec
            out[at] = (on * weights).sum(1)
            np.add.at(writes, at, 1)
    return out, writes


def unpack_bits(bits: np.ndarray, plan: N.DxPlan, n: int, c: int
                ) -> np.ndarray:
    """The mask the dx pass reads from ``bits`` under ``plan``: for each
    vector a thread takes, byte v, bit k for its channel k, as (n, c)
    booleans; elements no thread takes stay False."""
    vec = plan.vec
    got = np.zeros(n * c, bool)
    for _, v in dx_walk(plan, n, c):
        for k in range(vec):
            got[v * vec + k] = (bits[v] >> k) & 1 == 1
    return got.reshape(n, c)


def dx_emulated(x, dy, on, gamma, mean, rstd, sb, sxh, rows: int = 0
                ) -> np.ndarray:
    """The dx pass's f32 arithmetic over (n, c) rows (numpy float32, each
    operation rounded): per channel once ``g = gamma * rstd`` and, when
    ``rows`` > 0, ``sb / rows`` and ``sxh / rows`` (else ``sb`` and
    ``sxh`` as given); per element ``dy' = dy`` where ``on`` (the mask,
    or None) else 0, ``x_hat = (x - mean) * rstd`` and
    ``g * ((dy' - sb) - x_hat * sxh)``. float32, not yet rounded to the
    dtype of x."""
    f = lambda a: np.asarray(a, np.float32)
    g = f(gamma) * f(rstd)
    if rows:
        sb, sxh = f(sb) / np.float32(rows), f(sxh) / np.float32(rows)
    d = f(dy) if on is None else np.where(on, f(dy), np.float32(0))
    xh = (f(x) - f(mean)) * f(rstd)
    return (g * ((d - f(sb)) - xh * f(sxh))).astype(np.float32)


def pool_fwd_depth(plan: P.PoolPlan, kh: int, kw: int) -> int:
    """The longest chain of f32 additions behind one window sum of the
    forward kernel under ``plan``: a thread's rows, cell by cell, then
    the ``ry`` threads' sums in row order."""
    return -(-kh // plan.ry) * kw + plan.ry


def pool_cells(plan: P.PoolPlan, kh: int, kw: int, ty: int):
    """The (row, column) cells of a window that thread ``ty`` adds, in
    order."""
    return [(r, s) for r in range(ty, kh, plan.ry) for s in range(kw)]


def pool_sum(x: np.ndarray, kh: int, kw: int, plan: P.PoolPlan
             ) -> Tuple[np.ndarray, int]:
    """The f32 window sums of ``x`` (B, H, W, C) float32 over windows
    that tile it in the kernel's order, and the additions on the longest
    chain behind one of them."""
    b, h, w, c = x.shape
    xr = x.astype(np.float32).reshape(b, h // kh, kh, w // kw, kw, c)
    parts = []
    for ty in range(plan.ry):
        cells = pool_cells(plan, kh, kw, ty)
        parts.append(_seq(np.stack([xr[:, :, r, :, s, :]
                                    for r, s in cells]), 0))
    longest = max(len(pool_cells(plan, kh, kw, ty))
                  for ty in range(plan.ry)) + plan.ry
    return _seq(np.stack(parts), 0), longest
