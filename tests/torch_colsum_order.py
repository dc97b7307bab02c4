"""The orders in which the port's vectorised reductions add, emulated
in numpy float32 (each addition rounded as the card's ``__fadd_rn``):

* ``bn_bwd_sums`` (``csrc/colsum_vec.cuh`` under ``colsum_vec_plan``):
  each lane of a row block adds its rows in order, the lanes' sums are
  added in lane order, the last CTA adds the row blocks' partials in
  runs and then the runs in order;
* ``pool_fwd`` (``csrc/pool_fwd.cu`` under ``pool_fwd_plan``): thread y
  of a window adds its rows y, y + ry, ... cell by cell, then the ry
  threads' sums are added in order.

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


def lane_rows(plan: N.ColsumPlan, n: int, block: int, lane: int):
    """The rows lane ``lane`` of row block ``block`` adds, in order."""
    r0 = block * plan.rows_per
    return np.arange(r0 + lane, min(n, r0 + plan.rows_per), plan.lanes)


def tile_channels(plan: N.ColsumPlan, c: int, tile: int, cg: int):
    """The channels channel group ``cg`` of tile ``tile`` loads (none
    past the last channel)."""
    c0 = (tile * plan.cgt + cg) * plan.vec
    return np.arange(c0, min(c, c0 + plan.vec))


def colsum_vec_sum(terms: np.ndarray, plan: N.ColsumPlan
                   ) -> Tuple[np.ndarray, int]:
    """The column sums of ``terms`` (n, c) float32 in the kernel's order,
    and the additions on the longest chain behind one of them."""
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
    for lo, hi, runs in _tiles(plan, c):
        gper = -(-g // runs)
        run_sums = np.stack([_seq(part[j * gper:(j + 1) * gper, lo:hi], 0)
                             for j in range(runs)])
        out[lo:hi] = _seq(run_sums, 0)
    return out, colsum_vec_chain(plan, n, c)


def _tiles(plan: N.ColsumPlan, c: int):
    """(first channel, end, runs of the last CTA) of each channel tile."""
    tile = plan.cgt * plan.vec
    for t in range(plan.tiles):
        lo, hi = t * tile, min(c, (t + 1) * tile)
        yield lo, hi, N.colsum_vec_runs(plan, hi - lo)


def colsum_vec_chain(plan: N.ColsumPlan, n: int, c: int) -> int:
    """The additions on the longest chain behind one column sum, counted
    from the rows each lane takes, the lanes, and the runs of row blocks
    the last CTA of each tile adds."""
    lane_max = max(len(lane_rows(plan, n, b, lane))
                   for b in range(plan.blocks) for lane in range(plan.lanes))
    longest = 0
    for _, _, runs in _tiles(plan, c):
        gper = -(-plan.blocks // runs)
        run_max = max(len(range(j * gper, min(plan.blocks, (j + 1) * gper)))
                      for j in range(runs))
        longest = max(longest, lane_max + plan.lanes + run_max + runs)
    return longest


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
