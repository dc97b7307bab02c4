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

Eligibility (:func:`lrn_takes`): an NHWC node and ``knorm > 0`` (the log
needs ``norm > 0``); any row count and any C. The TPU's C <= 1024 and
row-block gates are not carried over. The layer decides before it calls;
a wrapper handed what the kernel does not take raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .fused import Kernel, check_cuda_input, register, stream_handle

_FLOAT = ctypes.c_float

LRN_FWD = register(Kernel(
    "lrn_fwd", "lrn_fwd.cu",
    replaces="cxxnet_tpu/ops/fused_lrn.py:66",
    argtypes=[ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
              ctypes.c_int, ctypes.c_int, ctypes.c_int, _FLOAT, _FLOAT,
              _FLOAT, ctypes.c_void_p]))

LRN_BWD = register(Kernel(
    "lrn_bwd", "lrn_bwd.cu",
    replaces="cxxnet_tpu/ops/fused_lrn.py:75",
    argtypes=[ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
              _FLOAT, _FLOAT, _FLOAT, _FLOAT, ctypes.c_void_p]))


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
    with torch.cuda.device(x.device):
        LRN_FWD.launch(x.data_ptr(), y.data_ptr(), n, c, nsize, code,
                       alpha / nsize, knorm, -beta, stream_handle(x.device))
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
    ab = alpha / nsize
    with torch.cuda.device(x.device):
        LRN_BWD.launch(x.data_ptr(), dy.data_ptr(), dx.data_ptr(), n, c,
                       nsize, code, ab, knorm, -beta, 2.0 * ab * beta,
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
