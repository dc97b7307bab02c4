"""Pooling over tiling or global windows: the CUDA kernels, their plain
versions and the autograd function over them.

The port of ``cxxnet_tpu/ops/fused_pool.py``. Two window regimes go to
the forward kernel (``csrc/pool_fwd.cu``):

* **tile**: square windows with ``stride == kernel``, no padding, and
  spatial dims that the window divides (the 2x2/2 pools of the MNIST
  and bowl convnets);
* **global**: one window covering the whole spatial extent (the 7x7
  global average of Inception-BN's head).

Reducers are max and sum; ``scale_avg`` multiplies the window sum by
``1/(kh*kw)``, with the sum and the scale both rounded to the input
dtype as the JAX kernel does (fused_pool.py:86-88). ``pre_relu`` folds
relu_max_pooling's activation in. Every other geometry (padding,
ceil-mode overhang, overlapping windows) is the layers' plain padded
pooling (layers/conv.py).

The backward of sum and avg (``csrc/pool_bwd.cu``) gives every cell of
a window that window's dy, times the avg scale rounded to the dtype.
The backward of max (``csrc/pool_bwd_max.cu``) gives the whole dy to the
first cell of the window, in row-major order, that equals the max
(XLA's select-and-scatter semantics), with no cap on the window size.

Both max kernels launch under a plan: :func:`pool_fwd_plan` for the
forward and :func:`pool_bwd_max_plan` for the max backward, each a
16-byte vector of channels a thread (narrower where C or a base
forbids), one thread a window row and ``bx`` output vectors a block.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .fused import (Kernel, base_align, check_cuda_input, register,
                    stream_handle)

POOL_FWD = register(Kernel(
    "pool_fwd", "pool_fwd.cu",
    replaces="cxxnet_tpu/ops/fused_pool.py:78",
    argtypes=[ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
              ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
              ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
              ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
              ctypes.c_void_p]))

#: window rows one output's threads split at most (a block's y)
POOL_MAX_SPLIT = 16
#: threads a block of the forward kernel aims at
POOL_THREADS = 256


class PoolPlan(NamedTuple):
    """The launch of ``csrc/pool_fwd.cu`` and ``csrc/pool_bwd_max.cu``:
    ``vec`` channels a load (16 bytes, narrower where C or a base
    forbids), the window's rows split over ``ry`` threads (thread y
    takes rows y, y + ry, ...) and ``bx`` output vectors a block."""
    vec: int
    ry: int
    bx: int


def pool_fwd_plan(c: int, kh: int, kw: int, itemsize: int,
                  aligned: bool = True) -> PoolPlan:
    """The forward kernel's launch over windows of kh x kw on C channels
    of ``itemsize``-byte elements: 16-byte vectors where C and the bases
    (``aligned``) allow, one thread a window row up to POOL_MAX_SPLIT
    rows, and blocks of about POOL_THREADS threads, a whole warp of
    output vectors at least."""
    vw = 16 // itemsize
    vec = vw if aligned and c % vw == 0 else 1
    ry = min(kh, POOL_MAX_SPLIT)
    bx = max(32, POOL_THREADS // ry // 32 * 32)
    return PoolPlan(vec, ry, bx)


POOL_BWD = register(Kernel(
    "pool_bwd", "pool_bwd.cu",
    replaces="cxxnet_tpu/ops/fused_pool.py:115",
    argtypes=[ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
              ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
              ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]))


POOL_BWD_MAX = register(Kernel(
    "pool_bwd_max", "pool_bwd_max.cu",
    replaces="cxxnet_tpu/ops/fused_pool.py:92",
    argtypes=[ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
              ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
              ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
              ctypes.c_void_p]))

#: threads a block of the max backward aims at (csrc/pool_bwd_max.cu takes
#: 512 at most, its launch bound)
POOL_BWD_THREADS = 256


def pool_bwd_max_plan(c: int, kh: int, kw: int, itemsize: int,
                      align: int = 16) -> PoolPlan:
    """The max backward's launch over windows of kh x kw on C channels
    of ``itemsize``-byte elements, every base address a multiple of
    ``align`` bytes: the widest vector (16 bytes, down to one element)
    that C and the bases allow; one thread a window row, up to
    POOL_MAX_SPLIT rows (a taller window's thread y takes rows y,
    y + ry, ... in rounds); and about POOL_BWD_THREADS threads a block,
    a whole warp of output vectors at least."""
    if c < 1 or kh < 1 or kw < 1:
        raise ValueError(f"pool_bwd_max_plan: needs c, kh, kw >= 1, got "
                         f"{c}, {kh}, {kw}")
    vec = 16 // itemsize
    while vec > 1 and (c % vec or align % (vec * itemsize)):
        vec //= 2
    ry = min(kh, POOL_MAX_SPLIT)
    bx = max(32, POOL_BWD_THREADS // ry // 32 * 32)
    return PoolPlan(vec, ry, bx)


def kernel_geometry(h: int, w: int, kh: int, kw: int, stride: int,
                    pad=(0, 0), extra=(0, 0)) -> bool:
    """Whether a pooling window is one the kernel takes: no padding and
    either the single global window or exactly tiling windows."""
    if tuple(pad) != (0, 0) or tuple(extra) != (0, 0):
        return False
    if kh == h and kw == w:
        return True
    return stride == kh == kw and h % kh == 0 and w % kw == 0


def scale_in_dtype(scale: float, dtype: torch.dtype) -> float:
    """``scale`` rounded to ``dtype``, as a Python float."""
    return float(torch.tensor(scale, dtype=dtype))


def _check(x: torch.Tensor, kh: int, kw: int, reducer: str) -> None:
    if x.dim() != 4:
        raise ValueError(f"pool: expected an NHWC tensor, got {tuple(x.shape)}")
    if reducer not in ("max", "sum"):
        raise ValueError(f"pool: reducer must be max or sum, got {reducer!r}")
    _, h, w, _ = x.shape
    if kh <= 0 or kw <= 0 or h % kh or w % kw:
        raise ValueError(
            f"pool: window {kh}x{kw} neither tiles nor covers {h}x{w}")


def pool_fwd_plain(x: torch.Tensor, kh: int, kw: int, reducer: str,
                   scale_avg: bool, pre_relu: bool) -> torch.Tensor:
    """Plain PyTorch pooling over windows that tile ``x`` (B, H, W, C)
    exactly (a global window is the one-tile case). The definition of
    what the kernel computes: max, or sum accumulated in f32 and rounded
    to the dtype; for avg that sum times ``1/(kh*kw)`` rounded to the
    dtype, the product rounded to the dtype."""
    _check(x, kh, kw, reducer)
    b, h, w, c = x.shape
    if pre_relu:
        x = torch.relu(x)
    xr = x.reshape(b, h // kh, kh, w // kw, kw, c)
    if reducer == "max":
        return xr.amax(dim=(2, 4))
    y = xr.sum(dim=(2, 4), dtype=torch.float32).to(x.dtype)
    if scale_avg and kh * kw != 1:
        s = scale_in_dtype(1.0 / (kh * kw), x.dtype)
        y = (y.float() * s).to(x.dtype)
    return y


def fused_pool(x: torch.Tensor, kh: int, kw: int, reducer: str,
               scale_avg: bool, pre_relu: bool) -> torch.Tensor:
    """Pool ``x`` (B, H, W, C) over windows that tile it or cover it
    whole. A CUDA tensor goes to the kernel; a CPU tensor to
    :func:`pool_fwd_plain`. Raises on what the kernel does not take."""
    _check(x, kh, kw, reducer)
    if x.device.type == "cpu":
        return pool_fwd_plain(x, kh, kw, reducer, scale_avg, pre_relu)
    if x.device.type != "cuda":
        raise ValueError(f"pool: no kernel for device {x.device}")
    code = check_cuda_input("pool", x)
    b, h, w, c = x.shape
    y = torch.empty((b, h // kh, w // kw, c), dtype=x.dtype, device=x.device)
    scale = (scale_in_dtype(1.0 / (kh * kw), x.dtype)
             if scale_avg and kh * kw != 1 else 1.0)
    plan = pool_fwd_plan(c, kh, kw, x.element_size(),
                         (x.data_ptr() | y.data_ptr()) % 16 == 0)
    with torch.cuda.device(x.device):
        POOL_FWD.launch(x.data_ptr(), y.data_ptr(), b, h, w, c, kh, kw,
                        code, int(reducer == "max"), int(pre_relu), scale,
                        plan.vec, plan.ry, plan.bx, stream_handle(x.device))
    return y


def _bwd_scale(kh: int, kw: int, scale_avg: bool, dtype: torch.dtype):
    """The backward's scale, rounded to ``dtype``, or None for 1."""
    if scale_avg and kh * kw != 1:
        return scale_in_dtype(1.0 / (kh * kw), dtype)
    return None


def pool_bwd_lin_plain(dy: torch.Tensor, kh: int, kw: int,
                       scale_avg: bool) -> torch.Tensor:
    """Plain PyTorch sum/avg pooling backward, the definition of what
    the backward kernel computes: ``dy`` (B, OY, OX, C) times the avg
    scale (both rounded to the dtype, and the product) broadcast over
    each kh x kw window of dx (B, OY*kh, OX*kw, C)."""
    if dy.dim() != 4:
        raise ValueError(f"pool backward: expected NHWC dy, got "
                         f"{tuple(dy.shape)}")
    b, oy, ox, c = dy.shape
    s = _bwd_scale(kh, kw, scale_avg, dy.dtype)
    v = dy if s is None else (dy.float() * s).to(dy.dtype)
    return v.reshape(b, oy, 1, ox, 1, c).expand(b, oy, kh, ox, kw, c) \
        .reshape(b, oy * kh, ox * kw, c)


def pool_bwd_max_plain(x: torch.Tensor, y: torch.Tensor, dy: torch.Tensor,
                       kh: int, kw: int, pre_relu: bool) -> torch.Tensor:
    """Plain first-match max pooling backward over tiling windows (the
    JAX package's ``_pool_bwd_max_kernel``): in row-major window order,
    the first cell equal to the window's max takes the whole dy; with
    ``pre_relu`` only a cell whose input is > 0 can take it."""
    b, h, w, c = x.shape
    oy, ox = h // kh, w // kw
    xr = x.reshape(b, oy, kh, ox, kw, c)
    xa = torch.relu(xr) if pre_relu else xr
    dx = torch.zeros_like(xr)
    taken = torch.zeros((b, oy, ox, c), dtype=torch.bool, device=x.device)
    zero = torch.zeros_like(dy)
    for i in range(kh):
        for j in range(kw):
            hit = (xa[:, :, i, :, j, :] == y) & ~taken
            if pre_relu:
                hit = hit & (xr[:, :, i, :, j, :] > 0)
            taken = taken | hit
            dx[:, :, i, :, j, :] = torch.where(hit, dy, zero)
    return dx.reshape(b, h, w, c)


def fused_pool_bwd_lin(dy: torch.Tensor, kh: int, kw: int,
                       scale_avg: bool) -> torch.Tensor:
    """Sum/avg pooling backward of windows that tile the input (a global
    window is the one-tile case). A CUDA tensor goes to the kernel; a
    CPU tensor to :func:`pool_bwd_lin_plain`."""
    if dy.dim() != 4 or kh <= 0 or kw <= 0:
        raise ValueError(f"pool backward: bad dy {tuple(dy.shape)} or "
                         f"window {kh}x{kw}")
    if dy.device.type == "cpu":
        return pool_bwd_lin_plain(dy, kh, kw, scale_avg)
    if dy.device.type != "cuda":
        raise ValueError(f"pool backward: no kernel for device {dy.device}")
    code = check_cuda_input("pool backward", dy)
    b, oy, ox, c = dy.shape
    dx = torch.empty((b, oy * kh, ox * kw, c), dtype=dy.dtype,
                     device=dy.device)
    s = _bwd_scale(kh, kw, scale_avg, dy.dtype)
    with torch.cuda.device(dy.device):
        POOL_BWD.launch(dy.data_ptr(), dx.data_ptr(), b, oy * kh, ox * kw,
                        c, kh, kw, code, 1.0 if s is None else s,
                        stream_handle(dy.device))
    return dx


def fused_pool_bwd_max(x: torch.Tensor, y: torch.Tensor, dy: torch.Tensor,
                       kh: int, kw: int, pre_relu: bool) -> torch.Tensor:
    """First-match max pooling backward of windows that tile ``x`` (a
    global window is the one-tile case): ``y`` is the forward's output,
    ``dy`` its gradient. A CUDA tensor goes to the kernel; a CPU tensor
    to :func:`pool_bwd_max_plain`."""
    _check(x, kh, kw, "max")
    b, h, w, c = x.shape
    want = (b, h // kh, w // kw, c)
    if tuple(y.shape) != want or tuple(dy.shape) != want:
        raise ValueError(f"max pool backward: y {tuple(y.shape)} and dy "
                         f"{tuple(dy.shape)} must be {want}")
    if x.device.type == "cpu":
        return pool_bwd_max_plain(x, y, dy, kh, kw, pre_relu)
    if x.device.type != "cuda":
        raise ValueError(f"max pool backward: no kernel for device "
                         f"{x.device}")
    code = check_cuda_input("max pool backward", x)
    for t in (y, dy):
        if check_cuda_input("max pool backward", t) != code or \
                t.device != x.device:
            raise ValueError("max pool backward: x, y and dy must share "
                             "dtype and device")
    dx = torch.empty_like(x)
    plan = pool_bwd_max_plan(c, kh, kw, x.element_size(),
                             base_align(x, y, dy, dx))
    with torch.cuda.device(x.device):
        POOL_BWD_MAX.launch(x.data_ptr(), y.data_ptr(), dy.data_ptr(),
                            dx.data_ptr(), b, h, w, c, kh, kw, code,
                            int(pre_relu), plan.vec, plan.ry, plan.bx,
                            stream_handle(x.device))
    return dx


class Pool(torch.autograd.Function):
    """Pooling over tiling or global windows: forward :func:`fused_pool`,
    backward :func:`fused_pool_bwd_lin` for sum and avg and
    :func:`fused_pool_bwd_max` for max."""

    @staticmethod
    def forward(ctx, x, kh, kw, reducer, scale_avg, pre_relu):
        y = fused_pool(x, kh, kw, reducer, scale_avg, pre_relu)
        ctx.geom = (kh, kw, reducer, scale_avg, pre_relu)
        if reducer == "max":
            ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, dy):
        kh, kw, reducer, scale_avg, pre_relu = ctx.geom
        dy = dy.contiguous()
        if reducer == "max":
            x, y = ctx.saved_tensors
            dx = fused_pool_bwd_max(x, y, dy, kh, kw, pre_relu)
        else:
            dx = fused_pool_bwd_lin(dy, kh, kw, scale_avg)
        return dx, None, None, None, None, None


def pool(x: torch.Tensor, kh: int, kw: int, reducer: str, scale_avg: bool,
         pre_relu: bool) -> torch.Tensor:
    """Differentiable pooling of ``x`` (B, H, W, C) over windows that
    tile it or cover it whole, through :class:`Pool`."""
    _check(x, kh, kw, reducer)
    return Pool.apply(x.contiguous(), kh, kw, reducer, scale_avg, pre_relu)
