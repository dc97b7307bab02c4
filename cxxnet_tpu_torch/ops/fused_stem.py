"""uint8 decode-normalize of the input batch: the CUDA kernel, its plain
version and the dispatcher the trainer's input fold calls.

The port of ``cxxnet_tpu/ops/fused_stem.py``. A ``device_normalize``
pipeline ships uint8 NHWC batches; the trainer's input fold turns one
into the network's input at the head of the train step: cast to f32,
minus the mean (None, per channel (C,), or a mean image (H, W, C)),
times the factor (``scale / divideby``), one cast to the compute dtype.
The kernel is ``csrc/stem.cu``; it reads the batch as flat (B, H*W*C)
and the mean from its one row, and takes any B, H, W, C.

No autograd: the data path carries no gradient.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from .fused import DTYPE_CODES, Kernel, register, stream_handle

STEM = register(Kernel(
    "stem", "stem.cu", replaces="cxxnet_tpu/ops/fused_stem.py:64",
    argtypes=[ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
              ctypes.c_float, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
              ctypes.c_void_p]))


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
    with torch.cuda.device(x.device):
        STEM.launch(x.data_ptr(), None if mean is None else mean.data_ptr(),
                    0 if mean is None else mean.numel(), _factor(factor),
                    y.data_ptr(), x.numel(), DTYPE_CODES[out_dtype],
                    stream_handle(x.device))
    return y


def decode_normalize(x: torch.Tensor, mean: Optional[torch.Tensor], factor,
                     out_dtype: torch.dtype, fused: bool = False
                     ) -> torch.Tensor:
    """The input fold's dispatcher: the kernel wrapper when the kernels
    are on (``fused``), else the plain version."""
    if fused:
        return fused_decode_normalize(x, mean, factor, out_dtype)
    return decode_normalize_reference(x, mean, factor, out_dtype)
