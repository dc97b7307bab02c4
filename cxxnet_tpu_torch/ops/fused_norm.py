"""Training batch norm with an optional folded relu: the CUDA kernels,
their plain versions and the autograd function over them.

The port of ``cxxnet_tpu/ops/fused_norm.py``'s single-device part.
Activations are viewed as (N, C) rows, N = batch*H*W for conv nodes and
N = batch for flat nodes, with per-channel statistics over the rows:

* forward (``csrc/bn_fwd.cu``): f32 moments, one-pass
  ``E[x^2] - E[x]^2`` clamped at 0 (a NaN kept) or, with ``two_pass``,
  the mean and then ``E[(x - mean)^2]``; ``y = (x - mean) * rstd * gamma
  + beta``, an optional relu, y in the dtype of x; mean and var in f32:
  the column sums (:func:`colsum_vec_plan`, ``csrc/bn_moments.cuh``'s
  ops), once or twice, then the normalize (:func:`bn_dx_plan`'s walk),
  which forms the statistics from the sums, in one wrapper call.
* backward (``csrc/bn_bwd.cu``): ``dy' = dy`` masked by ``y > 0`` with
  relu, ``x_hat = (x - mean) * rstd``, ``dbeta = sum dy'``,
  ``dgamma = sum dy' * x_hat`` (f32), and
  ``dx = gamma * rstd * (dy' - dbeta / N - x_hat * dgamma / N)``: the
  column sums of ``bn_bwd_sums`` (:func:`colsum_vec_plan`), then the dx
  pass of ``bn_bwd_dx`` (:func:`bn_dx_plan`), in one wrapper call.

:class:`BnAct` saves ``(x, gamma, mean, rstd, y if relu)`` as the JAX
custom_vjp does, drops the gradients that mean and var receive (they
feed the running-statistic EMA only), and casts dgamma and dbeta to
gamma's dtype. Any N and C go to the kernels: the TPU kernel's row-block
divisibility does not apply here.

Data parallelism (the dp-mesh island of the JAX package's
``fused_norm.py``, ``_bn_act_mesh``) splits the same function around two
all-reduces, one per direction, in :class:`SyncBnAct`, through four
kernels of ``csrc/bn_sync.cu``:

* ``bn_sums``: the rank's per-channel ``S1 = sum x``, ``S2 = sum x^2``
  (f32) into one (2, C) buffer, all-reduced: the column sums of the
  one-pass forward, bit-equal to its sums of the same rows (one launch
  under :func:`colsum_vec_plan`); then ``mean = S1 / N``,
  ``var = max(S2 / N - mean^2, 0)``, ``rstd = rsqrt(var + eps)`` over the
  global row count N;
* ``bn_norm``: ``y = (x - mean) * rstd * gamma + beta`` (+ relu) with the
  global moments (the dx pass's walk, :func:`bn_dx_plan`);
* ``bn_bwd_sums``: the rank's ``SB = sum dy'``, ``SXH = sum dy' * x_hat``
  into one (2, C) buffer, all-reduced;
* ``bn_bwd_dx``: ``dx = gamma * rstd * (dy' - SB/N - x_hat * SXH/N)``
  with the global sums.

dgamma and dbeta are the rank's own SXH and SB: the trainer's gradient
all-reduce sums them with every other gradient leaf.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch

from .fused import (Kernel, check_cuda_input, register, sm_count,
                    split_scratch, stream_handle)

_P = ctypes.c_void_p
_I64, _I = ctypes.c_int64, ctypes.c_int
BN_FWD = register(Kernel(
    "bn_fwd", "bn_fwd.cu",
    replaces="cxxnet_tpu/ops/fused_norm.py:77",
    argtypes=[_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I, _I, _I, _I, _I,
              _I64, _I, _I64, _I, _I, _I, _I, ctypes.c_float, _P]))
BN_BWD = register(Kernel(
    "bn_bwd", "bn_bwd.cu",
    replaces="cxxnet_tpu/ops/fused_norm.py:168",
    argtypes=[_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I, _I, _I,
              _I, _I, _I64, _I, _I64, _I, _I, _P]))
BN_SUMS = register(Kernel(
    "bn_sums", "bn_sync.cu",
    replaces="cxxnet_tpu/ops/fused_norm.py:291",
    argtypes=[_P, _P, _P, _P, _I64, _I, _I, _I, _I, _I, _I64, _I, _I,
              _P]))
BN_NORM = register(Kernel(
    "bn_norm", "bn_sync.cu",
    replaces="cxxnet_tpu/ops/fused_norm.py:309",
    argtypes=[_P, _P, _P, _P, _P, _P, _I64, _I, _I, _I64, _I, _I, _I, _P]))
BN_BWD_SUMS = register(Kernel(
    "bn_bwd_sums", "bn_sync.cu",
    replaces="cxxnet_tpu/ops/fused_norm.py:322",
    argtypes=[_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I, _I, _I, _I, _I,
              _I64, _I, _I, _P]))
BN_BWD_DX = register(Kernel(
    "bn_bwd_dx", "bn_sync.cu",
    replaces="cxxnet_tpu/ops/fused_norm.py:350",
    argtypes=[_P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I, _I, _I64, _I, _I,
              _P]))


#: threads of a CTA of ``csrc/colsum_vec.cuh`` (its kVecThreads)
COLSUM_VEC_THREADS = 256
#: CTAs a SM the grid aims at: one wave of the CTAs a SM holds
#: (kVecCtasPerSm)
COLSUM_VEC_CTAS_PER_SM = 3
#: rows a lane takes at least before the grid grows
COLSUM_VEC_MIN_ROWS = 8


class ColsumPlan(NamedTuple):
    """The launch of ``csrc/colsum_vec.cuh`` over (n, c) rows: ``vec``
    channels a load (16 bytes, or 1 where c or a base does not allow
    it), ``cgt`` channel groups of ``vec`` a channel tile, ``lanes`` row
    lanes a CTA, a grid of ``blocks`` row blocks of ``rows_per`` rows by
    ``tiles`` channel tiles, and ``fvec`` partials the last CTA adds a
    load. The scratch is ``blocks * 2 * c`` floats and ``tiles``
    counters."""
    vec: int
    cgt: int
    lanes: int
    tiles: int
    blocks: int
    rows_per: int
    fvec: int


def colsum_vec_plan(n: int, c: int, itemsize: int, aligned: bool = True,
                    sms: int = 132) -> ColsumPlan:
    """The launch of the vectorised column sums over (n, c) rows of
    ``itemsize``-byte elements: ``vec`` channels a thread loads as one
    16-byte vector (1 when c is not a multiple of it or a base is not
    ``aligned``); about sqrt(c / 64) channel tiles, so that the last
    CTA of a tile adds few partials; row blocks to make
    COLSUM_VEC_CTAS_PER_SM CTAs a SM of ``sms`` in all, each lane taking
    at least COLSUM_VEC_MIN_ROWS rows."""
    vw = 16 // itemsize
    vec = vw if aligned and c % vw == 0 else 1
    groups = c // vec
    tiles = max(1, min(groups, round(math.sqrt(c / 64))),
                -(-groups // COLSUM_VEC_THREADS))
    cgt = -(-groups // tiles)
    tiles = -(-groups // cgt)
    lanes = COLSUM_VEC_THREADS // cgt
    want = max(1, COLSUM_VEC_CTAS_PER_SM * sms // tiles)
    blocks = max(1, min(want, -(-n // (lanes * COLSUM_VEC_MIN_ROWS))))
    rows_per = -(-n // blocks)
    blocks = -(-n // rows_per)
    fvec = 4 if c % 4 == 0 and (cgt * vec) % 4 == 0 else 1
    return ColsumPlan(vec, cgt, lanes, tiles, blocks, rows_per, fvec)


def colsum_vec_runs(plan: ColsumPlan, cw: int, sums: int = 2) -> int:
    """Runs of row blocks the last CTA of a tile of ``cw`` channels adds
    apart (one per thread that a unit of ``fvec`` sums leaves), for an
    op of ``sums`` sums a channel (2 for BN's, 1 for the epilogue's)."""
    units = sums * cw // plan.fvec
    return max(1, min(plan.blocks, COLSUM_VEC_THREADS // units))


def colsum_vec_depth(plan: ColsumPlan, c: int, sums: int = 2) -> int:
    """The longest chain of f32 additions behind one column sum of
    ``csrc/colsum_vec.cuh`` under ``plan`` for an op of ``sums`` sums a
    channel: a lane's rows of its row block, then the lanes, then a run
    of row blocks, then the runs. A sum so taken is within
    ``depth * 2**-24`` times the sum of its terms' magnitudes of the
    exact sum of its terms."""
    tile = plan.cgt * plan.vec
    fin = 0
    for t in range(plan.tiles):
        runs = colsum_vec_runs(plan, min(tile, c - t * tile), sums)
        fin = max(fin, -(-plan.blocks // runs) + runs)
    return -(-plan.rows_per // plan.lanes) + plan.lanes + fin


#: threads of a CTA of the dx pass (``csrc/bn_bwd_vec.cuh``, kDxThreads)
BN_DX_THREADS = 256
#: CTAs a SM its grid fills (kDxCtasPerSm)
BN_DX_CTAS_PER_SM = 3
#: vectors of each stream a thread has in flight (kDxRows)
BN_DX_ROWS = 2
#: vectors of x a thread of the normalize has in flight
#: (``csrc/bn_norm_vec.cuh``, kNormRows; its walk is the dx pass's)
BN_NORM_ROWS = 2


class DxPlan(NamedTuple):
    """The launch of the dx pass (``bn_dx_vec`` of ``csrc/bn_bwd_vec.cuh``)
    and of the normalize (``bn_norm_vec`` of ``csrc/bn_norm_vec.cuh``,
    the same walk) over (n, c) rows: ``vec`` channels a load (16 bytes,
    or 1 where c or a base does not allow it), ``lanes`` row lanes, each
    of ``c // vec`` threads (one a channel group), on ``blocks`` CTAs of
    BN_DX_THREADS. Thread t takes the vectors t, t + lanes * c // vec,
    ..."""
    vec: int
    lanes: int
    blocks: int


def bn_dx_plan(n: int, c: int, itemsize: int, aligned: bool = True,
               sms: int = 132) -> DxPlan:
    """The launch of the dx pass over (n, c) rows of ``itemsize``-byte
    elements: ``vec`` as :func:`colsum_vec_plan` takes it, and as many
    row lanes (at most n) as one wave of BN_DX_CTAS_PER_SM CTAs a SM of
    ``sms`` holds whole (at least one)."""
    vw = 16 // itemsize
    vec = vw if aligned and c % vw == 0 else 1
    groups = c // vec
    lanes = max(1, min(n, BN_DX_CTAS_PER_SM * sms * BN_DX_THREADS // groups))
    return DxPlan(vec, lanes, -(-lanes * groups // BN_DX_THREADS))


def _aligned(*ts) -> bool:
    return all(t is None or t.data_ptr() % 16 == 0 for t in ts)


def _check(x: torch.Tensor, gamma: torch.Tensor, act: str) -> None:
    if act not in ("none", "relu"):
        raise ValueError(f"bn: act must be none or relu, got {act!r}")
    if x.dim() < 2 or x.shape[-1] < 1 or x.numel() == 0:
        raise ValueError(f"bn: bad input shape {tuple(x.shape)}")
    if tuple(gamma.shape) != (x.shape[-1],):
        raise ValueError(f"bn: gamma shape {tuple(gamma.shape)} != "
                         f"({x.shape[-1]},)")


def bn_act_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                 eps: float, act: str = "none", two_pass: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch batch norm over the trailing channel axis, the
    definition of what the forward kernel computes (the JAX package's
    ``bn_act_reference``): ``(y, mean, var)`` with f32 statistics over
    all leading axes and y in x's dtype."""
    _check(x, gamma, act)
    axes = tuple(range(x.dim() - 1))
    xf = x.float()
    mean = xf.mean(dim=axes)
    if two_pass:
        var = (xf - mean).square().mean(dim=axes)
    else:
        var = torch.clamp(xf.square().mean(dim=axes) - mean.square(),
                          min=0.0)
    inv = torch.rsqrt(var + eps)
    out = (xf - mean) * inv * gamma.float() + beta.float()
    if act == "relu":
        out = torch.relu(out)
    return out.to(x.dtype), mean, var


def bn_bwd_plain(x: torch.Tensor, dy: torch.Tensor, y: Optional[torch.Tensor],
                 gamma: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch backward over (N, C) rows, the definition of what
    the backward kernel computes (the formula of the JAX package's
    ``_bn_bwd_kernel``): ``(dx, dgamma, dbeta)``, dx in x's dtype, the
    two sums in f32. ``y`` is the forward's output when a relu was
    folded in (its mask), else None."""
    n = x.shape[0]
    sb, sxh = bn_bwd_sums_plain(x, dy, y, mean, rstd)
    dx = bn_bwd_dx_plain(x, dy, y, gamma, mean, rstd, sb / n, sxh / n)
    return dx, sxh, sb


def _vec_on(t: torch.Tensor, dev: torch.device, what: str) -> None:
    if t.dtype != torch.float32 or t.device != dev or not t.is_contiguous():
        raise ValueError(f"bn: {what} must be a contiguous float32 tensor "
                         f"on {dev} (got {t.dtype} on {t.device})")


def bn_fwd(x2: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
           eps: float, act: str = "none", two_pass: bool = False):
    """Forward over (N, C) rows: ``(y, mean, var, rstd)``. A CUDA tensor
    goes to the kernel (gamma and beta float32 on the same device); a
    CPU tensor to :func:`bn_act_plain`. Raises on what the kernel does
    not take."""
    _check(x2, gamma, act)
    if x2.dim() != 2:
        raise ValueError(f"bn: expected (N, C) rows, got {tuple(x2.shape)}")
    if x2.device.type == "cpu":
        y, mean, var = bn_act_plain(x2, gamma, beta, eps, act, two_pass)
        return y, mean, var, torch.rsqrt(var + eps)
    y, stats, _ = bn_fwd_sums(x2, gamma, beta, eps, act, two_pass)
    return y, stats[0], stats[1], stats[2]


def bn_fwd_sums(x2: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                eps: float, act: str = "none", two_pass: bool = False):
    """The forward kernel on CUDA (N, C) rows: ``(y, stats, sums)`` with
    ``stats`` (3, C) f32 mean, var and rstd, and ``sums`` (2, C) f32 the
    column sums they were formed from: ``[sum x, sum x^2]`` (bit-equal
    to :func:`bn_sums` of the same rows), or with ``two_pass`` ``[sum x,
    sum (x - mean)^2]``. Two launches one-pass, three two-pass, in one
    wrapper call."""
    _check(x2, gamma, act)
    if x2.dim() != 2 or x2.device.type != "cuda":
        raise ValueError(f"bn: no kernel for {tuple(x2.shape)} rows on "
                         f"{x2.device}")
    code = check_cuda_input("bn", x2)
    _vec_on(gamma, x2.device, "gamma")
    _vec_on(beta, x2.device, "beta")
    n, c = x2.shape
    dev = x2.device
    y = torch.empty_like(x2)
    aligned = _aligned(x2, y)
    plan = colsum_vec_plan(n, c, x2.element_size(), aligned, sm_count(dev))
    nplan = bn_dx_plan(n, c, x2.element_size(), aligned, sm_count(dev))
    stats = torch.empty((3, c), dtype=torch.float32, device=dev)
    sums = torch.empty((2, c), dtype=torch.float32, device=dev)
    part, cnt = split_scratch(dev, "bn_fwd", 4 * plan.blocks * 2 * c,
                              plan.tiles)
    with torch.cuda.device(dev):
        BN_FWD.launch(x2.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                      y.data_ptr(), stats.data_ptr(), sums.data_ptr(),
                      part.data_ptr(), cnt.data_ptr(), n, c, plan.vec,
                      plan.cgt, plan.tiles, plan.blocks, plan.rows_per,
                      plan.fvec, nplan.lanes, nplan.blocks, code,
                      int(act == "relu"), int(two_pass), float(eps),
                      stream_handle(dev))
    return y, stats, sums


def bn_bwd(x2: torch.Tensor, dy2: torch.Tensor, y2: Optional[torch.Tensor],
           gamma: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor):
    """Backward over (N, C) rows: ``(dx, dgamma, dbeta)``. ``y2`` is the
    forward's output when a relu was folded in, else None. A CUDA tensor
    goes to the kernel; a CPU tensor to :func:`bn_bwd_plain`. On the
    16-byte path the sums pass hands the dx pass the relu mask as bits,
    one byte a vector."""
    code = _rows("bn backward", x2, dy2, y2)
    if code is None:
        return bn_bwd_plain(x2, dy2, y2, gamma, mean, rstd)
    _vecs("bn backward", x2, gamma=gamma, mean=mean, rstd=rstd)
    n, c = x2.shape
    dev = x2.device
    dx = torch.empty_like(x2)
    aligned = _aligned(x2, dy2, y2)
    plan = colsum_vec_plan(n, c, x2.element_size(), aligned, sm_count(dev))
    dplan = bn_dx_plan(n, c, x2.element_size(), aligned, sm_count(dev))
    sums = torch.empty((2, c), dtype=torch.float32, device=dev)
    part, cnt = split_scratch(dev, "bn_bwd", 4 * plan.blocks * 2 * c,
                              plan.tiles)
    bits = None
    if y2 is not None and plan.vec > 1:
        bits = torch.empty(n * c // plan.vec, dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        BN_BWD.launch(x2.data_ptr(), dy2.data_ptr(),
                      None if y2 is None else y2.data_ptr(),
                      gamma.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                      dx.data_ptr(), sums.data_ptr(), part.data_ptr(),
                      cnt.data_ptr(), None if bits is None else bits.data_ptr(),
                      n, c, plan.vec, plan.cgt, plan.tiles, plan.blocks,
                      plan.rows_per, plan.fvec, dplan.lanes, dplan.blocks,
                      code, stream_handle(dev))
    return dx, sums[1], sums[0]


class BnAct(torch.autograd.Function):
    """Batch norm (+ folded relu) over the trailing channel axis whose
    forward and backward are :func:`bn_fwd` and :func:`bn_bwd`."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, act, two_pass):
        c = x.shape[-1]
        x2 = x.reshape(-1, c)
        y, mean, var, rstd = bn_fwd(x2, gamma, beta, eps, act, two_pass)
        ctx.save_for_backward(x2, gamma, mean, rstd,
                              y if act == "relu" else None)
        ctx.mark_non_differentiable(mean, var)
        return y.reshape(x.shape), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x2, gamma, mean, rstd, y = ctx.saved_tensors
        dx, dgamma, dbeta = bn_bwd(x2, dy.reshape(x2.shape).contiguous(), y,
                                   gamma, mean, rstd)
        return (dx.reshape(dy.shape), dgamma.to(gamma.dtype),
                dbeta.to(gamma.dtype), None, None, None)


def fused_bn_act(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                 eps: float, act: str = "none", two_pass: bool = False):
    """Training batch norm (+ optional relu) of an NHWC or flat node
    through :class:`BnAct`: ``(y, mean, var)``, y in x's dtype, f32
    statistics. Differentiable in x, gamma and beta."""
    _check(x, gamma, act)
    return BnAct.apply(x.contiguous(), gamma, beta, float(eps), act,
                       bool(two_pass))


# -- synchronized batch norm (data parallelism) ------------------------------

def _masked(dy: torch.Tensor, y: Optional[torch.Tensor]) -> torch.Tensor:
    dyf = dy.float()
    if y is not None:
        dyf = torch.where(y.float() > 0, dyf, torch.zeros_like(dyf))
    return dyf


def bn_sums_plain(x2: torch.Tensor) -> torch.Tensor:
    """The rank's per-channel ``[sum x, sum x^2]`` of (N, C) rows as one
    (2, C) f32 tensor: the definition of what ``bn_sums`` computes (the
    JAX package's ``_bn_sums_kernel``)."""
    xf = x2.float()
    return torch.stack([xf.sum(dim=0), (xf * xf).sum(dim=0)])


def bn_norm_plain(x2: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  mean: torch.Tensor, rstd: torch.Tensor,
                  act: str = "none") -> torch.Tensor:
    """``(x - mean) * rstd * gamma + beta`` (+ relu) over (N, C) rows with
    given f32 moments, in x's dtype: the definition of what ``bn_norm``
    computes (the JAX package's ``_bn_norm_kernel``)."""
    out = (x2.float() - mean) * rstd * gamma.float() + beta.float()
    if act == "relu":
        out = torch.relu(out)
    return out.to(x2.dtype)


def bn_bwd_sums_plain(x2: torch.Tensor, dy2: torch.Tensor,
                      y2: Optional[torch.Tensor], mean: torch.Tensor,
                      rstd: torch.Tensor) -> torch.Tensor:
    """The rank's per-channel ``[sum dy', sum dy' * x_hat]`` as one (2, C)
    f32 tensor, ``dy'`` masked by ``y2 > 0`` when a relu was folded in:
    the definition of what ``bn_bwd_sums`` computes (the JAX package's
    ``_bn_bwd_sums_kernel``)."""
    dyf = _masked(dy2, y2)
    xh = (x2.float() - mean) * rstd
    return torch.stack([dyf.sum(dim=0), (dyf * xh).sum(dim=0)])


def bn_bwd_dx_plain(x2: torch.Tensor, dy2: torch.Tensor,
                    y2: Optional[torch.Tensor], gamma: torch.Tensor,
                    mean: torch.Tensor, rstd: torch.Tensor,
                    sbn: torch.Tensor, sxhn: torch.Tensor) -> torch.Tensor:
    """``gamma * rstd * (dy' - sbn - x_hat * sxhn)`` in x's dtype, with
    ``sbn``, ``sxhn`` the global sums over the global row count: the
    definition of what ``bn_bwd_dx`` computes (the JAX package's
    ``_bn_bwd_dx_kernel``)."""
    dyf = _masked(dy2, y2)
    xh = (x2.float() - mean) * rstd
    g = gamma.float() * rstd
    return (g * (dyf - sbn - xh * sxhn)).to(x2.dtype)


def _rows(name: str, x2: torch.Tensor, *same) -> Optional[int]:
    """Check (N, C) rows and their companions; the dtype code on the card,
    None on the CPU. Raises on what the kernels do not take."""
    if x2.dim() != 2 or x2.numel() == 0:
        raise ValueError(f"{name}: expected non-empty (N, C) rows, got "
                         f"{tuple(x2.shape)}")
    for t in same:
        if t is not None and t.shape != x2.shape:
            raise ValueError(f"{name}: x, dy and y must be equal (N, C)")
    if x2.device.type == "cpu":
        return None
    if x2.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x2.device}")
    code = check_cuda_input(name, x2)
    for t in same:
        if t is not None and check_cuda_input(name, t) != code:
            raise TypeError(f"{name}: x, dy and y must share a dtype")
    return code


def _vecs(name: str, x2: torch.Tensor, **vecs) -> None:
    for what, t in vecs.items():
        _vec_on(t, x2.device, f"{name} {what}")
        if t.shape != (x2.shape[1],):
            raise ValueError(f"{name}: {what} shape {tuple(t.shape)} != "
                             f"({x2.shape[1]},)")


def bn_sums(x2: torch.Tensor) -> torch.Tensor:
    """(2, C) f32 ``[sum x, sum x^2]`` of (N, C) rows: the ``bn_sums``
    kernel on a CUDA tensor (one launch under :func:`colsum_vec_plan`),
    :func:`bn_sums_plain` on a CPU one."""
    code = _rows("bn_sums", x2)
    if code is None:
        return bn_sums_plain(x2)
    n, c = x2.shape
    dev = x2.device
    plan = colsum_vec_plan(n, c, x2.element_size(), _aligned(x2),
                           sm_count(dev))
    sums = torch.empty((2, c), dtype=torch.float32, device=dev)
    part, cnt = split_scratch(dev, "bn_sums", 4 * plan.blocks * 2 * c,
                              plan.tiles)
    with torch.cuda.device(dev):
        BN_SUMS.launch(x2.data_ptr(), sums.data_ptr(), part.data_ptr(),
                       cnt.data_ptr(), n, c, plan.vec, plan.cgt, plan.tiles,
                       plan.blocks, plan.rows_per, plan.fvec, code,
                       stream_handle(dev))
    return sums


def bn_norm(x2: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
            mean: torch.Tensor, rstd: torch.Tensor,
            act: str = "none") -> torch.Tensor:
    """Normalize (N, C) rows with given moments: the ``bn_norm`` kernel on
    a CUDA tensor (one launch under :func:`bn_dx_plan`, bit-equal to the
    plain version on finite inputs), :func:`bn_norm_plain` on a CPU
    one."""
    if act not in ("none", "relu"):
        raise ValueError(f"bn_norm: act must be none or relu, got {act!r}")
    code = _rows("bn_norm", x2)
    if code is None:
        return bn_norm_plain(x2, gamma, beta, mean, rstd, act)
    _vecs("bn_norm", x2, gamma=gamma, beta=beta, mean=mean, rstd=rstd)
    n, c = x2.shape
    y = torch.empty_like(x2)
    plan = bn_dx_plan(n, c, x2.element_size(), _aligned(x2),
                      sm_count(x2.device))
    with torch.cuda.device(x2.device):
        BN_NORM.launch(x2.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                       mean.data_ptr(), rstd.data_ptr(), y.data_ptr(), n, c,
                       plan.vec, plan.lanes, plan.blocks, code,
                       int(act == "relu"), stream_handle(x2.device))
    return y


def bn_bwd_sums(x2: torch.Tensor, dy2: torch.Tensor,
                y2: Optional[torch.Tensor], mean: torch.Tensor,
                rstd: torch.Tensor) -> torch.Tensor:
    """(2, C) f32 ``[sum dy', sum dy' * x_hat]``: the ``bn_bwd_sums``
    kernel on a CUDA tensor (one launch under :func:`colsum_vec_plan`),
    :func:`bn_bwd_sums_plain` on a CPU one."""
    code = _rows("bn_bwd_sums", x2, dy2, y2)
    if code is None:
        return bn_bwd_sums_plain(x2, dy2, y2, mean, rstd)
    _vecs("bn_bwd_sums", x2, mean=mean, rstd=rstd)
    n, c = x2.shape
    dev = x2.device
    plan = colsum_vec_plan(n, c, x2.element_size(), _aligned(x2, dy2, y2),
                           sm_count(dev))
    sums = torch.empty((2, c), dtype=torch.float32, device=dev)
    part, cnt = split_scratch(dev, "bn_bwd_sums", 4 * plan.blocks * 2 * c,
                              plan.tiles)
    with torch.cuda.device(dev):
        BN_BWD_SUMS.launch(x2.data_ptr(), dy2.data_ptr(),
                           None if y2 is None else y2.data_ptr(),
                           mean.data_ptr(), rstd.data_ptr(), sums.data_ptr(),
                           part.data_ptr(), cnt.data_ptr(), n, c, plan.vec,
                           plan.cgt, plan.tiles, plan.blocks, plan.rows_per,
                           plan.fvec, code, stream_handle(dev))
    return sums


def bn_bwd_dx(x2: torch.Tensor, dy2: torch.Tensor, y2: Optional[torch.Tensor],
              gamma: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
              sbn: torch.Tensor, sxhn: torch.Tensor) -> torch.Tensor:
    """dx of (N, C) rows from the global sums over the global row count:
    the ``bn_bwd_dx`` kernel on a CUDA tensor (one launch under
    :func:`bn_dx_plan`), :func:`bn_bwd_dx_plain` on a CPU one."""
    code = _rows("bn_bwd_dx", x2, dy2, y2)
    if code is None:
        return bn_bwd_dx_plain(x2, dy2, y2, gamma, mean, rstd, sbn, sxhn)
    _vecs("bn_bwd_dx", x2, gamma=gamma, mean=mean, rstd=rstd, sbn=sbn,
          sxhn=sxhn)
    n, c = x2.shape
    dx = torch.empty_like(x2)
    plan = bn_dx_plan(n, c, x2.element_size(), _aligned(x2, dy2, y2),
                      sm_count(x2.device))
    with torch.cuda.device(x2.device):
        BN_BWD_DX.launch(x2.data_ptr(), dy2.data_ptr(),
                         None if y2 is None else y2.data_ptr(),
                         gamma.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                         sbn.data_ptr(), sxhn.data_ptr(), dx.data_ptr(), n, c,
                         plan.vec, plan.lanes, plan.blocks, code,
                         stream_handle(x2.device))
    return dx


#: (sums, normalize, backward sums, dx): the kernel wrappers, or the
#: plain versions under ``fused_kernels = 0``
_SYNC_OPS = {True: (bn_sums, bn_norm, bn_bwd_sums, bn_bwd_dx),
             False: (bn_sums_plain, bn_norm_plain, bn_bwd_sums_plain,
                     bn_bwd_dx_plain)}


class SyncBnAct(torch.autograd.Function):
    """Batch norm (+ folded relu) over the trailing channel axis with the
    moments of the global batch, its rows split over the ranks of ``dp``
    (a :class:`~cxxnet_tpu_torch.parallel.DpContext`): the rank's sums,
    one all-reduce of (2, C), normalize; backward: the rank's sums, one
    all-reduce of (2, C), dx. ``fused`` picks the kernels (their plain
    versions on the CPU) or, under ``fused_kernels = 0``, the plain
    versions on any device. Returns ``(y, mean, var)``; dgamma and dbeta
    are the rank's own sums (the gradient all-reduce adds the ranks')."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, act, dp, fused):
        sums_fn, norm_fn, _, _ = _SYNC_OPS[bool(fused)]
        c = x.shape[-1]
        x2 = x.reshape(-1, c)
        n_total = float(x2.shape[0] * dp.world)
        sums = dp.all_reduce(sums_fn(x2))
        mean = sums[0] / n_total
        var = torch.clamp(sums[1] / n_total - mean * mean, min=0.0)
        rstd = torch.rsqrt(var + eps)
        ctx.gamma_dtype = gamma.dtype
        gamma = gamma.float()
        y = norm_fn(x2, gamma, beta.float(), mean, rstd, act)
        ctx.save_for_backward(x2, gamma, mean, rstd,
                              y if act == "relu" else None)
        ctx.dp, ctx.fused, ctx.n_total = dp, bool(fused), n_total
        ctx.mark_non_differentiable(mean, var)
        return y.reshape(x.shape), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x2, gamma, mean, rstd, y = ctx.saved_tensors
        _, _, bwd_sums_fn, dx_fn = _SYNC_OPS[ctx.fused]
        dy2 = dy.reshape(x2.shape).contiguous()
        local = bwd_sums_fn(x2, dy2, y, mean, rstd)
        total = ctx.dp.all_reduce(local.clone())
        dx = dx_fn(x2, dy2, y, gamma, mean, rstd, total[0] / ctx.n_total,
                   total[1] / ctx.n_total)
        gdt = ctx.gamma_dtype
        return (dx.reshape(dy.shape), local[1].to(gdt), local[0].to(gdt),
                None, None, None, None)


def sync_bn_act(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                eps: float, act: str, dp, fused: bool = True):
    """Training batch norm (+ optional relu) of an NHWC or flat node over
    the global batch of ``dp``'s ranks through :class:`SyncBnAct`:
    ``(y, mean, var)``, y in x's dtype, f32 global statistics."""
    _check(x, gamma, act)
    return SyncBnAct.apply(x.contiguous(), gamma, beta, float(eps), act, dp,
                           bool(fused))
