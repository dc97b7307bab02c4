"""Multi-tensor SGD / NAG momentum and Adam applies: the CUDA kernels
and their plain versions.

The port of ``cxxnet_tpu/ops/fused_optim.py``. One launch updates every
leaf of a tag group (``wmat`` or ``bias``) in place, with the per-leaf
math of the JAX package's ``_prep`` and its kernels: NaN gradients
become 0, the gradient is clipped (``clip != 0``), ``wd * w`` is added
(``wd != 0``), then

* SGD (``_sgd_kernel``): ``m' = momentum * m - lr * g`` and ``w' = w +
  m'`` or, for NAG, ``w' = w + (1 + momentum) * m' - momentum * m``;
* Adam (``_adam_kernel``): ``m1' = m1 + d1 * (g - m1)``, ``m2' = m2 +
  d2 * (g * g - m2)``, ``w' = w - lr_t * m1' / (sqrt(m2') + 1e-8)``,
  with the bias correction already in ``lr_t``.

All leaves are float32 (the master-weight contract).

The TPU kernels' pack of every leaf into one padded buffer and the
unpack after it are not carried over: the kernels (``csrc/sgd_apply.cu``,
``csrc/adam_apply.cu``) read each leaf where it lives through a device
table of pointers and sizes, and write the new weights and moments over
the old ones. The scalars are arguments of every launch.
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

ADAM_APPLY = register(Kernel(
    "adam_apply", "adam_apply.cu",
    replaces="cxxnet_tpu/ops/fused_optim.py:101",
    argtypes=[ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
              ctypes.c_float, ctypes.c_float, ctypes.c_float,
              ctypes.c_float, ctypes.c_float, ctypes.c_void_p]))

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


def _table(*lists: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, int]:
    """A kernel's int64 table on the device: the pointers of every leaf
    in each of ``lists`` (w, g, then the moments), the leaf sizes, then
    each CTA's leaf and chunk start. Returns ``(table, n_blocks)``."""
    ws = lists[0]
    sizes = np.array([w.numel() for w in ws], np.int64)
    per = -(-sizes // CHUNK)
    blk_leaf = np.repeat(np.arange(len(ws), dtype=np.int64), per)
    first = np.repeat(np.cumsum(per) - per, per)
    blk_start = (np.arange(len(blk_leaf), dtype=np.int64) - first) * CHUNK
    host = np.concatenate(
        [np.array([t.data_ptr() for t in ts], np.int64) for ts in lists]
        + [sizes, blk_leaf, blk_start])
    # pinned, so the copy is queued on the stream without a host sync
    return (torch.from_numpy(host).pin_memory().to(ws[0].device,
                                                   non_blocking=True),
            len(blk_leaf))


def _check_leaves(name: str, *lists: Sequence[torch.Tensor]
                  ) -> torch.device:
    """The device of the leaves; raises unless every list has the same
    non-zero length and every tensor is a contiguous float32 one on that
    device, shaped as its leaf."""
    ws = lists[0]
    if not ws or any(len(ts) != len(ws) for ts in lists):
        raise ValueError(f"{name}: needs equal, non-empty leaf lists")
    dev = ws[0].device
    for i, w in enumerate(ws):
        for ts in lists:
            t = ts[i]
            if t.dtype != torch.float32 or t.device != dev \
                    or not t.is_contiguous():
                raise ValueError(
                    f"{name}: every leaf, gradient and moment must be a "
                    f"contiguous float32 tensor on {dev} (got {t.dtype} "
                    f"on {t.device})")
            if t.shape != w.shape:
                raise ValueError(f"{name}: shapes differ: "
                                 f"{tuple(w.shape)}, {tuple(t.shape)}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {dev}")
    return dev


def fused_sgd_apply(ws: Sequence[torch.Tensor], gs: Sequence[torch.Tensor],
                    ms: Sequence[torch.Tensor], lr: float, momentum: float,
                    *, wd: float, clip: float, nag: bool) -> None:
    """One SGD / NAG step over a tag group's leaves, IN PLACE: ``ws``
    and ``ms`` are overwritten. CUDA tensors go to the kernel (one
    launch); CPU tensors are updated with :func:`sgd_apply_plain`.
    Raises on what the kernel does not take."""
    dev = _check_leaves("sgd_apply", ws, gs, ms)
    with torch.no_grad():
        if dev.type == "cpu":
            nws, nms = sgd_apply_plain(ws, gs, ms, lr, momentum, wd, clip,
                                       nag)
            for w, m, nw, nm in zip(ws, ms, nws, nms):
                w.copy_(nw)
                m.copy_(nm)
            return
        table, n_blocks = _table(ws, gs, ms)
        with torch.cuda.device(dev):
            SGD_APPLY.launch(table.data_ptr(), len(ws), n_blocks, CHUNK,
                             _f32(lr), _f32(momentum), _f32(wd), _f32(clip),
                             int(nag), stream_handle(dev))


def adam_apply_plain(ws: Sequence[torch.Tensor], gs: Sequence[torch.Tensor],
                     m1s: Sequence[torch.Tensor],
                     m2s: Sequence[torch.Tensor], lr_t: float, d1: float,
                     d2: float, wd: float, clip: float
                     ) -> Tuple[List[torch.Tensor], List[torch.Tensor],
                                List[torch.Tensor]]:
    """Plain PyTorch Adam step, leaf by leaf, the definition of what the
    kernel computes (the JAX package's ``Optimizer._apply`` Adam leaf):
    returns ``(new_ws, new_m1s, new_m2s)`` and changes nothing it was
    given. Scalars enter as float32; every operation is its own
    correctly rounded f32 op, as in the kernel."""
    lr_t, d1, d2 = _f32(lr_t), _f32(d1), _f32(d2)
    out = ([], [], [])
    for w, g, m1, m2 in zip(ws, gs, m1s, m2s):
        g = g.float()
        g = torch.where(torch.isnan(g), torch.zeros_like(g), g)
        if clip:
            g = torch.clamp(g, -_f32(clip), _f32(clip))
        if wd:
            g = g + _f32(wd) * w
        n1 = m1 + d1 * (g - m1)
        n2 = m2 + d2 * (g * g - m2)
        for o, v in zip(out, (w - lr_t * n1 / (torch.sqrt(n2) + 1e-8), n1,
                              n2)):
            o.append(v)
    return out


def fused_adam_apply(ws: Sequence[torch.Tensor], gs: Sequence[torch.Tensor],
                     m1s: Sequence[torch.Tensor],
                     m2s: Sequence[torch.Tensor], lr_t: float, *,
                     d1: float, d2: float, wd: float, clip: float) -> None:
    """One Adam step over a tag group's leaves, IN PLACE: ``ws``,
    ``m1s`` and ``m2s`` are overwritten. ``lr_t`` carries the bias
    correction (``optim.adam_lr_t``). CUDA tensors go to the kernel (one
    launch); CPU tensors are updated with :func:`adam_apply_plain`.
    Raises on what the kernel does not take."""
    dev = _check_leaves("adam_apply", ws, gs, m1s, m2s)
    with torch.no_grad():
        if dev.type == "cpu":
            new = adam_apply_plain(ws, gs, m1s, m2s, lr_t, d1, d2, wd, clip)
            for dst, src in zip((ws, m1s, m2s), new):
                for t, v in zip(dst, src):
                    t.copy_(v)
            return
        table, n_blocks = _table(ws, gs, m1s, m2s)
        with torch.cuda.device(dev):
            ADAM_APPLY.launch(table.data_ptr(), len(ws), n_blocks, CHUNK,
                              _f32(lr_t), _f32(d1), _f32(d2), _f32(wd),
                              _f32(clip), stream_handle(dev))
