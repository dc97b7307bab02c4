"""Bias + activation epilogue: the CUDA kernels, their plain versions
and the autograd function over them.

The port of ``cxxnet_tpu/ops/fused_epilogue.py``: a conv or fullc output
``x`` viewed as (N, C) rows gets ``bias`` (C,) added, cast to ``x``'s
dtype first, and then an optional relu (the graph-folded one,
graph.act_fusion_plan); the kernel is ``csrc/epilogue_fwd.cu``. Its
backward (``csrc/epilogue_bwd.cu``) is dx = dy, masked by ``y > 0`` with
relu, and dbias = the f32 column sum of that dx. The matmul or conv
itself stays PyTorch's, as the JAX package left it to XLA.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .fused import (Kernel, check_cuda_input, register, row_blocks,
                    stream_handle)

EPILOGUE_FWD = register(Kernel(
    "epilogue_fwd", "epilogue_fwd.cu",
    replaces="cxxnet_tpu/ops/fused_epilogue.py:46",
    argtypes=[ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
              ctypes.c_void_p]))


EPILOGUE_BWD = register(Kernel(
    "epilogue_bwd", "epilogue_bwd.cu",
    replaces="cxxnet_tpu/ops/fused_epilogue.py:58",
    argtypes=[ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
              ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
              ctypes.c_void_p]))


def _check(x: torch.Tensor, bias: Optional[torch.Tensor], act: str) -> None:
    if act not in ("none", "relu"):
        raise ValueError(f"epilogue: act must be none or relu, got {act!r}")
    if x.dim() < 1 or x.shape[-1] < 1:
        raise ValueError(f"epilogue: bad input shape {tuple(x.shape)}")
    if bias is not None and tuple(bias.shape) != (x.shape[-1],):
        raise ValueError(
            f"epilogue: bias shape {tuple(bias.shape)} != ({x.shape[-1]},)")


def bias_act_plain(x: torch.Tensor, bias: Optional[torch.Tensor],
                   act: str = "none") -> torch.Tensor:
    """Plain PyTorch epilogue, the definition of what the kernel
    computes: ``x + bias.to(x.dtype)`` (bias optional), then relu when
    ``act == "relu"``."""
    _check(x, bias, act)
    y = x if bias is None else x + bias.to(x.dtype)
    if act == "relu":
        y = torch.relu(y)
    return y


def fused_bias_act(x: torch.Tensor, bias: Optional[torch.Tensor],
                   act: str = "none") -> torch.Tensor:
    """Epilogue on the trailing channel axis of ``x``. A CUDA tensor goes
    to the kernel (bias float32 on the same device); a CPU tensor to
    :func:`bias_act_plain`. Raises on what the kernel does not take,
    and when there is nothing to do (no bias and no act)."""
    _check(x, bias, act)
    if bias is None and act == "none":
        raise ValueError("epilogue: nothing to do (no bias, no act)")
    if x.device.type == "cpu":
        return bias_act_plain(x, bias, act)
    if x.device.type != "cuda":
        raise ValueError(f"epilogue: no kernel for device {x.device}")
    code = check_cuda_input("epilogue", x)
    if bias is not None:
        if bias.dtype != torch.float32 or bias.device != x.device \
                or not bias.is_contiguous():
            raise ValueError(
                "epilogue: bias must be a contiguous float32 tensor on "
                f"{x.device} (got {bias.dtype} on {bias.device})")
    c = x.shape[-1]
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        EPILOGUE_FWD.launch(
            x.data_ptr(), None if bias is None else bias.data_ptr(),
            y.data_ptr(), x.numel() // c, c, code, int(act == "relu"),
            stream_handle(x.device))
    return y


def epilogue_bwd_plain(y: torch.Tensor, dy: torch.Tensor, act: str,
                       with_bias: bool):
    """Plain PyTorch epilogue backward, the definition of what the
    backward kernel computes: ``(dx, dbias)`` with dx = dy masked by
    ``y > 0`` when ``act == "relu"``, and dbias the column sum of dx in
    float32 over every leading axis (None without a bias)."""
    dx = dy
    if act == "relu":
        dx = torch.where(y > 0, dy, torch.zeros_like(dy))
    db = None
    if with_bias:
        db = dx.reshape(-1, dx.shape[-1]).sum(dim=0, dtype=torch.float32)
    return dx, db


def fused_epilogue_bwd(y: torch.Tensor, dy: torch.Tensor, act: str,
                       with_bias: bool):
    """Epilogue backward over the trailing channel axis: ``(dx, dbias)``.
    A CUDA tensor goes to the kernel; a CPU tensor to
    :func:`epilogue_bwd_plain`."""
    if act not in ("none", "relu") or y.shape != dy.shape or dy.dim() < 1:
        raise ValueError("epilogue backward: y and dy must match and act "
                         f"be none or relu (got {act!r})")
    if dy.device.type == "cpu":
        return epilogue_bwd_plain(y, dy, act, with_bias)
    if dy.device.type != "cuda":
        raise ValueError(f"epilogue backward: no kernel for {dy.device}")
    code = check_cuda_input("epilogue backward", dy)
    if act == "relu" and check_cuda_input("epilogue backward", y) != code:
        raise TypeError("epilogue backward: y and dy must share a dtype")
    c = dy.shape[-1]
    n = dy.numel() // c
    g = row_blocks(n, c)
    dx = torch.empty_like(dy)
    db = (torch.empty((c,), dtype=torch.float32, device=dy.device)
          if with_bias else None)
    part = (torch.empty((g, c), dtype=torch.float32, device=dy.device)
            if with_bias else None)
    with torch.cuda.device(dy.device):
        EPILOGUE_BWD.launch(
            y.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            None if db is None else db.data_ptr(),
            None if part is None else part.data_ptr(), n, c, g, code,
            int(act == "relu"), stream_handle(dy.device))
    return dx, db


class BiasAct(torch.autograd.Function):
    """The epilogue with forward :func:`fused_bias_act` and backward
    :func:`fused_epilogue_bwd`; dbias is cast to the bias's dtype."""

    @staticmethod
    def forward(ctx, x, bias, act):
        y = fused_bias_act(x, bias, act)
        ctx.act = act
        ctx.bias_dtype = None if bias is None else bias.dtype
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, dy):
        (y,) = ctx.saved_tensors
        dx, db = fused_epilogue_bwd(y, dy.contiguous(), ctx.act,
                                    ctx.bias_dtype is not None)
        return dx, None if db is None else db.to(ctx.bias_dtype), None


def bias_act(x: torch.Tensor, bias: Optional[torch.Tensor],
             act: str = "none") -> torch.Tensor:
    """Differentiable epilogue through :class:`BiasAct` (x contiguous;
    raises when there is nothing to do, as :func:`fused_bias_act`)."""
    return BiasAct.apply(x.contiguous(), bias, act)
