"""Bias + activation epilogue: the CUDA kernels, their plain versions
and the autograd function over them.

The port of ``cxxnet_tpu/ops/fused_epilogue.py``: a conv or fullc output
``x`` viewed as (N, C) rows gets ``bias`` (C,) added, cast to ``x``'s
dtype first, and then an optional relu (the graph-folded one,
graph.act_fusion_plan); the kernel is ``csrc/epilogue_fwd.cu``, the BN
normalize's channel-group walk (:func:`epilogue_fwd_plan`). Its
backward (``csrc/epilogue_bwd.cu``) is dx = dy, masked by ``y > 0`` with
relu, and dbias = the f32 column sum of that dx, in one launch: with a
bias, the column sums of ``csrc/colsum_vec.cuh`` (:func:`epilogue_bwd_plan`)
storing the masked dx on the way; with relu and no bias, a masked copy
(:func:`epilogue_copy_plan`). Without the relu dx is dy itself, as in the
plain version. The matmul or conv itself stays PyTorch's, as the JAX
package left it to XLA.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from .fused import (Kernel, check_cuda_input, register, sm_count,
                    split_scratch, stream_handle)
from .fused_norm import (COLSUM_VEC_THREADS, ColsumPlan, _aligned,
                         bn_dx_plan, colsum_vec_plan)

_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
EPILOGUE_FWD = register(Kernel(
    "epilogue_fwd", "epilogue_fwd.cu",
    replaces="cxxnet_tpu/ops/fused_epilogue.py:46",
    argtypes=[_P, _P, _P, _I64, _I, _I, _I64, _I, _I64, _I, _I, _P]))
EPILOGUE_BWD = register(Kernel(
    "epilogue_bwd", "epilogue_bwd.cu",
    replaces="cxxnet_tpu/ops/fused_epilogue.py:58",
    argtypes=[_P, _P, _P, _P, _P, _P, _I64, _I, _I, _I, _I, _I, _I64, _I,
              _I, _I, _P]))

#: elements a launch of the forward takes at most: longer inputs go in
#: slices of whole rows, so that the kernel's 32-bit vector indices (and
#: each thread's last one, strides past a slice's end) stay below 2^31
EPI_FWD_SLICE = 1 << 30


class EpiFwdPlan(NamedTuple):
    """The forward's launch over (n, c) rows: ``bn_dx_plan``'s ``vec``,
    ``lanes`` and ``blocks`` (thread t takes the vectors t, t + lanes *
    c // vec, ... of its channel group t % (c // vec)), each slice of
    ``slice_rows`` rows one launch."""
    vec: int
    lanes: int
    blocks: int
    slice_rows: int


def epilogue_fwd_plan(n: int, c: int, itemsize: int, aligned: bool = True,
                      sms: int = 132) -> EpiFwdPlan:
    """The forward's launch: the BN normalize's walk
    (:func:`~.fused_norm.bn_dx_plan`: 16-byte vectors where ``c`` and
    the bases allow, one wave of CTAs), in slices of at most
    EPI_FWD_SLICE elements."""
    p = bn_dx_plan(n, c, itemsize, aligned, sms)
    return EpiFwdPlan(p.vec, p.lanes, p.blocks, max(1, EPI_FWD_SLICE // c))


#: rows a lane of a one-block plan takes: one round of the kVecRows
#: rows ``csrc/colsum_vec.cuh`` keeps in flight
EPI_MIN_ROWS = 2
#: threads of a CTA of the masked copy (``csrc/epilogue_bwd.cu``,
#: kEpiThreads) and the CTAs a SM its grid fills (kEpiCtasPerSm)
EPI_COPY_THREADS = 256
EPI_COPY_CTAS_PER_SM = 3


def epilogue_bwd_plan(n: int, c: int, itemsize: int, aligned: bool = True,
                      sms: int = 132) -> ColsumPlan:
    """The launch of the dbias sums over (n, c) rows. Where one CTA's
    lanes take every row EPI_MIN_ROWS at a time with at least two
    channel groups a tile (n up to COLSUM_VEC_THREADS // 2 *
    EPI_MIN_ROWS: a fullc's batch), one row block of as many channel
    groups a tile as that leaves: each lane loads its rows in one round
    and each CTA writes its tile's sums itself, with no partials and no
    arrival counter. Else :func:`~.fused_norm.colsum_vec_plan`, as the
    BN sums take it."""
    plan = colsum_vec_plan(n, c, itemsize, aligned, sms)
    lanes = -(-n // EPI_MIN_ROWS)
    if lanes > COLSUM_VEC_THREADS // 2:
        return plan
    groups = c // plan.vec
    cgt = min(groups, COLSUM_VEC_THREADS // lanes)
    fvec = 4 if c % 4 == 0 and (cgt * plan.vec) % 4 == 0 else 1
    return ColsumPlan(plan.vec, cgt, COLSUM_VEC_THREADS // cgt,
                      -(-groups // cgt), 1, n, fvec)


class CopyPlan(NamedTuple):
    """The launch of the masked copy over ``numel`` elements: ``vec``
    elements a load (16 bytes, or 1 where the count or a base does not
    allow it) on ``blocks`` CTAs of EPI_COPY_THREADS; thread t takes the
    vectors t, t + blocks * EPI_COPY_THREADS, ..."""
    vec: int
    blocks: int


def epilogue_copy_plan(numel: int, itemsize: int, aligned: bool = True,
                       sms: int = 132) -> CopyPlan:
    """The masked copy's launch: 16-byte vectors where ``numel`` and the
    bases allow, one vector a thread up to one wave of
    EPI_COPY_CTAS_PER_SM CTAs a SM of ``sms``."""
    vw = 16 // itemsize
    vec = vw if aligned and numel % vw == 0 else 1
    nv = numel // vec
    return CopyPlan(vec, max(1, min(EPI_COPY_CTAS_PER_SM * sms,
                                    -(-nv // EPI_COPY_THREADS))))


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
    n = x.numel() // c
    y = torch.empty_like(x)
    plan = epilogue_fwd_plan(n, c, x.element_size(), _aligned(x, y),
                             sm_count(x.device))
    with torch.cuda.device(x.device):
        EPILOGUE_FWD.launch(
            x.data_ptr(), None if bias is None else bias.data_ptr(),
            y.data_ptr(), n, c, *plan, code, int(act == "relu"),
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
    A CUDA tensor goes to the kernel, one launch (none when there is
    neither a bias nor a relu); a CPU tensor to
    :func:`epilogue_bwd_plain`. Without the relu dx is ``dy`` itself."""
    if act not in ("none", "relu") or y.shape != dy.shape or dy.dim() < 1:
        raise ValueError("epilogue backward: y and dy must match and act "
                         f"be none or relu (got {act!r})")
    if dy.device.type == "cpu":
        return epilogue_bwd_plain(y, dy, act, with_bias)
    if dy.device.type != "cuda":
        raise ValueError(f"epilogue backward: no kernel for {dy.device}")
    code = check_cuda_input("epilogue backward", dy)
    relu = act == "relu"
    if relu and check_cuda_input("epilogue backward", y) != code:
        raise TypeError("epilogue backward: y and dy must share a dtype")
    if not relu and not with_bias:
        return dy, None
    dev = dy.device
    c = dy.shape[-1]
    n = dy.numel() // c
    dx = torch.empty_like(dy) if relu else dy
    aligned = _aligned(dy, y if relu else None, dx)
    db = part = cnt = None
    if with_bias:
        p = epilogue_bwd_plan(n, c, dy.element_size(), aligned, sm_count(dev))
        db = torch.empty((c,), dtype=torch.float32, device=dev)
        part, cnt = split_scratch(dev, "epilogue_bwd", 4 * p.blocks * c,
                                  p.tiles)
        args = (p.vec, p.cgt, p.tiles, p.blocks, p.rows_per, p.fvec)
    else:
        cp = epilogue_copy_plan(n * c, dy.element_size(), aligned,
                                sm_count(dev))
        args = (cp.vec, 0, 0, cp.blocks, 0, 0)
    with torch.cuda.device(dev):
        EPILOGUE_BWD.launch(
            y.data_ptr() if relu else None, dy.data_ptr(),
            dx.data_ptr() if relu else None,
            None if db is None else db.data_ptr(),
            None if part is None else part.data_ptr(),
            None if cnt is None else cnt.data_ptr(), n, c, *args, code,
            int(relu), stream_handle(dev))
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
