"""Cross-channel local response normalization: the CUDA kernels, their
plain versions and the autograd function over them.

The port of ``cxxnet_tpu/ops/fused_lrn.py``. Over the trailing channel
axis of an NHWC node, viewed as (N, C) rows, with ``half = nsize // 2``:

    win[c]  = sum of x[c']^2, c' in [c - half, c + nsize - 1 - half]
    norm[c] = knorm + (alpha / nsize) * win[c]
    y[c]    = x[c] * exp(-beta * log(norm[c]))

computed in float32 with one rounding to the dtype at the end, as the
Pallas kernels compute it (fused_lrn.py:66-87); the forward kernel is
``csrc/lrn_fwd.cu``. The backward (``csrc/lrn_bwd.cu``) recomputes norm
from x, as the TPU kernel does, and sums ``t = dy * x * norm^(-beta-1)``
over the transposed window ``[c - (nsize - 1 - half), c + half]``.

Both kernels launch under one :func:`lrn_plan`: a block owns whole rows
(or, where a row needs more than LRN_MAX_TPR threads, a chunk of a row
and its halo), a thread one vector of channels.

Eligibility (:func:`lrn_takes`): an NHWC node and ``knorm > 0`` (the log
needs ``norm > 0``); any row count and any C. The TPU's C <= 1024 and
row-block gates are not carried over. The layer decides before it calls;
a wrapper handed what the kernel does not take raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .fused import Kernel, check_cuda_input, register, stream_handle
from .fused import base_align as _align

_FLOAT, _INT = ctypes.c_float, ctypes.c_int
#: vec, rows, chunk and stride of an LrnPlan
_PLAN = [_INT, _INT, _INT, _INT]

LRN_FWD = register(Kernel(
    "lrn_fwd", "lrn_fwd.cu",
    replaces="cxxnet_tpu/ops/fused_lrn.py:66",
    argtypes=[ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, _INT,
              _INT, _INT, _FLOAT, _FLOAT, _FLOAT, *_PLAN, ctypes.c_void_p]))

LRN_BWD = register(Kernel(
    "lrn_bwd", "lrn_bwd.cu",
    replaces="cxxnet_tpu/ops/fused_lrn.py:75",
    argtypes=[ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_int64, _INT, _INT, _INT, _FLOAT, _FLOAT, _FLOAT,
              _FLOAT, *_PLAN, ctypes.c_void_p]))

#: threads a block aims at: the rows of a block are LRN_THREADS // tpr
LRN_THREADS = 256
#: threads a row (or a chunk of one) takes at most: a block's threads are
#: capped there too (the kernels' launch bound)
LRN_MAX_TPR = 512
#: shared memory a block of an H100 can have
LRN_SMEM = 227 * 1024


class LrnPlan(NamedTuple):
    """The launch of ``csrc/lrn_fwd.cu`` and ``csrc/lrn_bwd.cu``: ``vec``
    channels a thread (one load of ``vec`` elements), ``rows`` rows a
    block (threadIdx.y), ``tpr`` threads a row (threadIdx.x, ``chunk /
    vec``), ``chunk`` channels a block (C where a row fits one block),
    and the shared tile: per row ``stride`` floats (the chunk and
    nsize - 1 channels each side, one pad after every ``vec``), ``smem``
    bytes in all. The grid is (ceil(n / rows), ceil(C / chunk))."""
    vec: int
    rows: int
    tpr: int
    chunk: int
    stride: int
    smem: int


def tile_pos(i: int, vec: int) -> int:
    """Where slot ``i`` of a row's tile lies in shared memory: one pad
    float after every ``vec`` slots, so that the lanes of a warp, which
    read ``vec`` slots apart, fall in different banks."""
    return i + i // vec if vec > 1 else i


def lrn_plan(n: int, c: int, itemsize: int, nsize: int, align: int = 16
             ) -> LrnPlan:
    """The kernels' launch over ``n`` rows of ``c`` channels of
    ``itemsize``-byte elements, every base address a multiple of
    ``align`` bytes: the widest vector (16 bytes, down to one element)
    that C and the bases allow; whole rows in a block where a row's
    vectors fit LRN_MAX_TPR threads, else chunks of LRN_MAX_TPR vectors,
    each with its halo; about LRN_THREADS threads a block. Raises
    ValueError where no block can hold a row's tile (a window that
    outgrows the shared memory)."""
    if n < 0 or c < 1 or nsize < 1:
        raise ValueError(f"lrn_plan: needs n >= 0 and c, nsize >= 1, got "
                         f"{n}, {c}, {nsize}")
    vec = 16 // itemsize
    while vec > 1 and (c % vec or align % (vec * itemsize)):
        vec //= 2
    chunk = c if c // vec <= LRN_MAX_TPR else LRN_MAX_TPR * vec
    tpr = chunk // vec
    if chunk < c and tpr < nsize - 1:
        raise ValueError(f"lrn_plan: a halo of {nsize - 1} channels needs "
                         f"as many threads a chunk, the chunk has {tpr}")
    stride = tile_pos(chunk + 2 * (nsize - 1) - 1, vec) + 1
    if stride * 4 > LRN_SMEM:
        raise ValueError(f"lrn_plan: a row's tile of {stride} floats "
                         f"outgrows {LRN_SMEM} bytes of shared memory")
    rows = max(1, min(LRN_THREADS // tpr, LRN_MAX_TPR // tpr, n or 1,
                      LRN_SMEM // (stride * 4)))
    return LrnPlan(vec, rows, tpr, chunk, stride, rows * stride * 4)


def lrn_takes(x: torch.Tensor, knorm: float) -> bool:
    """Whether the kernels take an LRN of ``x``: an NHWC node with
    ``knorm > 0``."""
    return x.dim() == 4 and knorm > 0


def _check(x: torch.Tensor, nsize: int, knorm: float) -> None:
    if not lrn_takes(x, knorm):
        raise ValueError(f"lrn: needs an NHWC tensor and knorm > 0, got "
                         f"{tuple(x.shape)} and knorm {knorm}")
    if nsize < 1:
        raise ValueError(f"lrn: local_size must be >= 1, got {nsize}")


def _window_sum(v: torch.Tensor, before: int, after: int) -> torch.Tensor:
    """Per channel c, the sum of ``v`` over channels [c - before,
    c + after], zeros past the edges, added in ascending channel order."""
    c = v.shape[-1]
    padded = F.pad(v, (before, after))
    return sum(padded[..., i:i + c] for i in range(before + after + 1))


def lrn_plain(x: torch.Tensor, nsize: int, alpha: float, beta: float,
              knorm: float) -> torch.Tensor:
    """Plain PyTorch LRN forward, the definition of what the kernel
    computes (module docstring)."""
    _check(x, nsize, knorm)
    xf = x.float()
    half = nsize // 2
    win = _window_sum(xf * xf, half, nsize - 1 - half)
    norm = knorm + (alpha / nsize) * win
    return (xf * torch.exp(-beta * torch.log(norm))).to(x.dtype)


def lrn_bwd_plain(x: torch.Tensor, dy: torch.Tensor, nsize: int,
                  alpha: float, beta: float, knorm: float) -> torch.Tensor:
    """Plain PyTorch LRN backward, the definition of what the backward
    kernel computes: ``dx = dy * p - 2 * (alpha / nsize) * beta * x *
    back``, ``p = norm^-beta``, ``back`` the transposed-window sum of
    ``dy * x * (p / norm)``."""
    _check(x, nsize, knorm)
    xf, dyf = x.float(), dy.float()
    half = nsize // 2
    ab = alpha / nsize
    norm = knorm + ab * _window_sum(xf * xf, half, nsize - 1 - half)
    p = torch.exp(-beta * torch.log(norm))
    t = dyf * xf * (p / norm)
    back = _window_sum(t, nsize - 1 - half, half)
    return (dyf * p - 2.0 * ab * beta * xf * back).to(x.dtype)


def _rows(x: torch.Tensor):
    return x.numel() // x.shape[-1], x.shape[-1]


def fused_lrn_fwd(x: torch.Tensor, nsize: int, alpha: float, beta: float,
                  knorm: float) -> torch.Tensor:
    """LRN forward of ``x`` (B, H, W, C). A CUDA tensor goes to the
    kernel; a CPU tensor to :func:`lrn_plain`."""
    _check(x, nsize, knorm)
    if x.device.type == "cpu":
        return lrn_plain(x, nsize, alpha, beta, knorm)
    if x.device.type != "cuda":
        raise ValueError(f"lrn: no kernel for device {x.device}")
    code = check_cuda_input("lrn", x)
    n, c = _rows(x)
    y = torch.empty_like(x)
    plan = lrn_plan(n, c, x.element_size(), nsize, _align(x, y))
    with torch.cuda.device(x.device):
        LRN_FWD.launch(x.data_ptr(), y.data_ptr(), n, c, nsize, code,
                       alpha / nsize, knorm, -beta, plan.vec, plan.rows,
                       plan.chunk, plan.stride, stream_handle(x.device))
    return y


def fused_lrn_bwd(x: torch.Tensor, dy: torch.Tensor, nsize: int,
                  alpha: float, beta: float, knorm: float) -> torch.Tensor:
    """LRN backward: dx of ``x`` (B, H, W, C) for the upstream ``dy``. A
    CUDA tensor goes to the kernel; a CPU tensor to
    :func:`lrn_bwd_plain`."""
    _check(x, nsize, knorm)
    if dy.shape != x.shape:
        raise ValueError(f"lrn backward: dy {tuple(dy.shape)} != x "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return lrn_bwd_plain(x, dy, nsize, alpha, beta, knorm)
    if x.device.type != "cuda":
        raise ValueError(f"lrn backward: no kernel for device {x.device}")
    code = check_cuda_input("lrn backward", x)
    if check_cuda_input("lrn backward", dy) != code or dy.device != x.device:
        raise ValueError("lrn backward: x and dy must share dtype and "
                         "device")
    n, c = _rows(x)
    dx = torch.empty_like(x)
    plan = lrn_plan(n, c, x.element_size(), nsize, _align(x, dy, dx))
    ab = alpha / nsize
    with torch.cuda.device(x.device):
        LRN_BWD.launch(x.data_ptr(), dy.data_ptr(), dx.data_ptr(), n, c,
                       nsize, code, ab, knorm, -beta, 2.0 * ab * beta,
                       plan.vec, plan.rows, plan.chunk, plan.stride,
                       stream_handle(x.device))
    return dx


class Lrn(torch.autograd.Function):
    """LRN: forward :func:`fused_lrn_fwd`, backward :func:`fused_lrn_bwd`
    (x saved, norm recomputed)."""

    @staticmethod
    def forward(ctx, x, nsize, alpha, beta, knorm):
        ctx.hyper = (nsize, alpha, beta, knorm)
        ctx.save_for_backward(x)
        return fused_lrn_fwd(x, nsize, alpha, beta, knorm)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        dx = fused_lrn_bwd(x, dy.contiguous(), *ctx.hyper)
        return dx, None, None, None, None


def lrn(x: torch.Tensor, nsize: int, alpha: float, beta: float,
        knorm: float) -> torch.Tensor:
    """Differentiable LRN of ``x`` (B, H, W, C) through :class:`Lrn`."""
    _check(x, nsize, knorm)
    return Lrn.apply(x.contiguous(), nsize, alpha, beta, knorm)
