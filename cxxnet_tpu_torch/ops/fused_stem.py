"""uint8 decode-normalize of the input batch: the CUDA kernel, its plain
version and the dispatcher the trainer's input fold calls.

The port of ``cxxnet_tpu/ops/fused_stem.py``. A ``device_normalize``
pipeline ships uint8 NHWC batches; the trainer's input fold turns one
into the network's input at the head of the train step: cast to f32,
minus the mean (None, per channel (C,), or a mean image (H, W, C)),
times the factor (``scale / divideby``), one cast to the compute dtype.
The kernel is ``csrc/stem.cu``; it reads the batch as (B, H*W*C) rows
and the mean from its one row, and takes any B, H, W, C. It launches
under :func:`stem_plan`: a thread owns one vector of columns (one
16-byte store of the output where cols and the bases allow), holds that
vector's mean values in registers, and walks its rows.

No autograd: the data path carries no gradient.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from .fused import (DTYPE_CODES, Kernel, base_align, register,
                    stream_handle)

_INT = ctypes.c_int
STEM = register(Kernel(
    "stem", "stem.cu", replaces="cxxnet_tpu/ops/fused_stem.py:64",
    argtypes=[ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
              ctypes.c_float, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
              _INT, _INT, _INT, _INT, _INT, ctypes.c_void_p]))

#: threads a block of the stem kernel aims at (csrc/stem.cu takes 512 at
#: most)
STEM_THREADS = 256
#: rows a thread walks at most (csrc/stem.cu issues 4 rows' loads at once)
STEM_ROWS = 4
#: a grid's row groups at most (CUDA's limit of gridDim.y)
STEM_MAX_GROUPS = 65535


class StemPlan(NamedTuple):
    """The launch of ``csrc/stem.cu`` over (n, cols) rows: ``vec``
    columns a thread, ``bx`` threads a block across the column vectors
    (threadIdx.x) and ``by`` across rows (threadIdx.y), ``rows`` rows a
    thread walks (thread y of a block takes rows y, y + by, ... of the
    block's group of by * rows), and the grid: ``gx`` column blocks by
    ``gy`` row groups."""
    vec: int
    bx: int
    by: int
    rows: int
    gx: int
    gy: int


def stem_plan(n: int, cols: int, mean_len: int, out_itemsize: int,
              align: int = 16) -> StemPlan:
    """The stem kernel's launch over ``n`` rows of ``cols`` uint8
    columns to ``out_itemsize``-byte outputs, with a mean of
    ``mean_len`` floats (0: none; it divides cols) and every base
    address a multiple of ``align`` bytes: the widest vector whose
    output is one 16-byte store (8 for bf16 and f16, 4 for f32), down
    to one column where cols or a base forbids; a block's threads
    across the column vectors first (a warp at least, all of a narrow
    row's), the rest across rows; STEM_ROWS rows a thread, more only
    where the row groups would pass STEM_MAX_GROUPS."""
    if n < 0 or cols < 1 or mean_len < 0 or (mean_len and cols % mean_len):
        raise ValueError(f"stem_plan: needs n >= 0, cols >= 1 and a mean "
                         f"length dividing cols, got {n}, {cols}, "
                         f"{mean_len}")
    vec = 16 // out_itemsize
    while vec > 1 and (cols % vec or align % (vec * out_itemsize)):
        vec //= 2
    ncv = cols // vec
    bx = min(STEM_THREADS, -(-ncv // 32) * 32)
    by = STEM_THREADS // bx
    rows = max(1, min(STEM_ROWS, -(-n // by)))
    rows = max(rows, -(-n // (by * STEM_MAX_GROUPS)))
    return StemPlan(vec, bx, by, rows, -(-ncv // bx),
                    max(1, -(-n // (by * rows))))


def _factor(factor) -> float:
    """The factor as the f32 value both versions multiply by."""
    return float(np.float32(factor))


def decode_normalize_reference(x: torch.Tensor,
                               mean: Optional[torch.Tensor], factor,
                               out_dtype: torch.dtype) -> torch.Tensor:
    """Plain PyTorch version, the definition of what the kernel computes:
    ``((x.float() - mean) * factor).to(out_dtype)``, the mean broadcast
    over the trailing axes (per channel (C,) or a mean image (H, W, C))
    and ``factor`` taken as float32."""
    y = x.to(torch.float32)
    if mean is not None:
        y = y - mean.to(device=y.device, dtype=torch.float32)
    y = y * _factor(factor)
    return y.to(out_dtype)


def fused_decode_normalize(x: torch.Tensor, mean: Optional[torch.Tensor],
                           factor, out_dtype: torch.dtype) -> torch.Tensor:
    """One streaming pass: uint8 (B, H, W, C) -> normalized ``out_dtype``.
    A CUDA tensor goes to the kernel; a CPU tensor to
    :func:`decode_normalize_reference`. Raises on what the kernel does
    not take: an input other than uint8 of rank 4, a mean of another
    shape than (C,) or (H, W, C), an output dtype other than float32,
    bfloat16 or float16."""
    if x.dtype != torch.uint8 or x.dim() != 4:
        raise TypeError(f"decode_normalize: needs a uint8 (B, H, W, C) "
                        f"batch, got {x.dtype} of shape {tuple(x.shape)}")
    if out_dtype not in DTYPE_CODES:
        raise TypeError(f"decode_normalize: output dtype {out_dtype} not "
                        "supported (float32, bfloat16, float16)")
    b, h, w, c = x.shape
    if mean is not None and tuple(mean.shape) not in ((c,), (h, w, c)):
        raise ValueError(f"decode_normalize: mean of shape "
                         f"{tuple(mean.shape)}; expected ({c},) or "
                         f"({h}, {w}, {c})")
    if x.device.type == "cpu":
        return decode_normalize_reference(x, mean, factor, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"decode_normalize: no kernel for device {x.device}")
    if mean is not None and (mean.dtype != torch.float32
                             or mean.device != x.device):
        raise ValueError("decode_normalize: the mean must be float32 on "
                         f"{x.device} (got {mean.dtype} on {mean.device})")
    x = x.contiguous()
    mean = None if mean is None else mean.contiguous()
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    if y.numel() == 0:
        return y
    cols, mean_len = h * w * c, 0 if mean is None else mean.numel()
    plan = stem_plan(b, cols, mean_len, y.element_size(), base_align(x, y))
    with torch.cuda.device(x.device):
        STEM.launch(x.data_ptr(), None if mean is None else mean.data_ptr(),
                    mean_len, _factor(factor), y.data_ptr(), b, cols,
                    DTYPE_CODES[out_dtype], plan.vec, plan.bx, plan.by,
                    plan.rows, stream_handle(x.device))
    return y


def decode_normalize(x: torch.Tensor, mean: Optional[torch.Tensor], factor,
                     out_dtype: torch.dtype, fused: bool = False
                     ) -> torch.Tensor:
    """The input fold's dispatcher: the kernel wrapper when the kernels
    are on (``fused``), else the plain version."""
    if fused:
        return fused_decode_normalize(x, mean, factor, out_dtype)
    return decode_normalize_reference(x, mean, factor, out_dtype)
