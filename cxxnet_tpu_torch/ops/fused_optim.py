"""Multi-tensor SGD / NAG momentum apply: the CUDA kernel and its plain
version.

The port of ``cxxnet_tpu/ops/fused_optim.py``'s SGD part. One launch
updates every leaf of a tag group (``wmat`` or ``bias``) in place, with
the per-leaf math of the JAX package's ``_prep`` and ``_sgd_kernel``:
NaN gradients become 0, the gradient is clipped (``clip != 0``),
``wd * w`` is added (``wd != 0``), then ``m' = momentum * m - lr * g``
and ``w' = w + m'`` or, for NAG, ``w' = w + (1 + momentum) * m' -
momentum * m``. All leaves are float32 (the master-weight contract).

The TPU kernel's pack of every leaf into one padded buffer and the
unpack after it are not carried over: the kernel (``csrc/sgd_apply.cu``)
reads each leaf where it lives through a device table of pointers and
sizes, and writes the new weights and momenta over the old ones. lr and
momentum are arguments of every launch.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .fused import Kernel, register, stream_handle

SGD_APPLY = register(Kernel(
    "sgd_apply", "sgd_apply.cu",
    replaces="cxxnet_tpu/ops/fused_optim.py:86",
    argtypes=[ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
              ctypes.c_float, ctypes.c_float, ctypes.c_float,
              ctypes.c_float, ctypes.c_int, ctypes.c_void_p]))

#: elements a CTA of the kernel updates (one leaf's chunk)
CHUNK = 8192


def _f32(v: float) -> float:
    """``v`` rounded to float32, as the kernel receives it."""
    return float(np.float32(v))


def sgd_apply_plain(ws: Sequence[torch.Tensor], gs: Sequence[torch.Tensor],
                    ms: Sequence[torch.Tensor], lr: float, momentum: float,
                    wd: float, clip: float, nag: bool
                    ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Plain PyTorch SGD / NAG step, leaf by leaf, the definition of
    what the kernel computes: returns ``(new_ws, new_ms)`` and changes
    nothing it was given. Scalars enter as float32."""
    lr, momentum = _f32(lr), _f32(momentum)
    one_plus = _f32(np.float32(1.0) + np.float32(momentum))
    new_ws, new_ms = [], []
    for w, g, m in zip(ws, gs, ms):
        g = g.float()
        g = torch.where(torch.isnan(g), torch.zeros_like(g), g)
        if clip:
            g = torch.clamp(g, -_f32(clip), _f32(clip))
        if wd:
            g = g + _f32(wd) * w
        nm = momentum * m - lr * g
        nw = (w + one_plus * nm - momentum * m) if nag else (w + nm)
        new_ws.append(nw)
        new_ms.append(nm)
    return new_ws, new_ms


def _table(ws, gs, ms) -> torch.Tensor:
    """The kernel's int64 table on the device: the w, g and m pointers
    and sizes of every leaf, then each CTA's leaf and chunk start."""
    sizes = np.array([w.numel() for w in ws], np.int64)
    per = -(-sizes // CHUNK)
    blk_leaf = np.repeat(np.arange(len(ws), dtype=np.int64), per)
    first = np.repeat(np.cumsum(per) - per, per)
    blk_start = (np.arange(len(blk_leaf), dtype=np.int64) - first) * CHUNK
    host = np.concatenate([
        np.array([t.data_ptr() for t in ws], np.int64),
        np.array([t.data_ptr() for t in gs], np.int64),
        np.array([t.data_ptr() for t in ms], np.int64),
        sizes, blk_leaf, blk_start])
    # pinned, so the copy is queued on the stream without a host sync
    return torch.from_numpy(host).pin_memory().to(ws[0].device,
                                                  non_blocking=True)


def fused_sgd_apply(ws: Sequence[torch.Tensor], gs: Sequence[torch.Tensor],
                    ms: Sequence[torch.Tensor], lr: float, momentum: float,
                    *, wd: float, clip: float, nag: bool) -> None:
    """One SGD / NAG step over a tag group's leaves, IN PLACE: ``ws``
    and ``ms`` are overwritten. CUDA tensors go to the kernel (one
    launch); CPU tensors are updated with :func:`sgd_apply_plain`.
    Raises on what the kernel does not take."""
    if not (len(ws) == len(gs) == len(ms)) or not ws:
        raise ValueError("sgd_apply: needs equal, non-empty leaf lists")
    dev = ws[0].device
    for w, g, m in zip(ws, gs, ms):
        for t in (w, g, m):
            if t.dtype != torch.float32 or t.device != dev \
                    or not t.is_contiguous():
                raise ValueError(
                    "sgd_apply: every leaf, gradient and momentum must be "
                    f"a contiguous float32 tensor on {dev} (got {t.dtype} "
                    f"on {t.device})")
        if w.shape != g.shape or w.shape != m.shape:
            raise ValueError(f"sgd_apply: shapes differ: {tuple(w.shape)}, "
                             f"{tuple(g.shape)}, {tuple(m.shape)}")
    with torch.no_grad():
        if dev.type == "cpu":
            nws, nms = sgd_apply_plain(ws, gs, ms, lr, momentum, wd, clip,
                                       nag)
            for w, m, nw, nm in zip(ws, ms, nws, nms):
                w.copy_(nw)
                m.copy_(nm)
            return
        if dev.type != "cuda":
            raise ValueError(f"sgd_apply: no kernel for device {dev}")
        table = _table(ws, gs, ms)
        n_blocks = (table.numel() - 4 * len(ws)) // 2
        with torch.cuda.device(dev):
            SGD_APPLY.launch(table.data_ptr(), len(ws), n_blocks, CHUNK,
                             _f32(lr), _f32(momentum), _f32(wd), _f32(clip),
                             int(nag), stream_handle(dev))
