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

Skip flag (the fp16 loss scaler's overflow skip, the ``lax.cond`` of the
JAX package's ``Optimizer._update_scaled``): each apply takes an
optional ``skip``, an int32 scalar on the leaves' device; where it is
non-zero the leaves and moments keep their bits. The SGD kernel reads it
on the card (every CTA returns before its first load), so the step that
computes the flag queues the apply without a host read. The Adam wrapper
reads it on the host before it launches, since Adam's step counter
``t`` and its bias correction live on the host (``optim.adam_lr_t``): a
skipped apply must leave ``t`` as it was. The plain versions take the
same flag through ``torch.where``.

The TPU kernels' pack of every leaf into one padded buffer and the
unpack after it are not carried over: the kernels (``csrc/sgd_apply.cu``,
``csrc/adam_apply.cu``) read each leaf where it lives through a device
table of pointers and each CTA's chunk, and write the new weights and
moments over the old ones. SGD's CTAs take CHUNK elements of a leaf in a
grid-stride loop; Adam's take ADAM_CHUNK, in 16-byte vectors where the
leaf's four bases allow (:func:`adam_plan`). The scalars are arguments
of every launch.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .fused import Kernel, register, stream_handle

SGD_APPLY = register(Kernel(
    "sgd_apply", "sgd_apply.cu",
    replaces="cxxnet_tpu/ops/fused_optim.py:86",
    argtypes=[ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
              ctypes.c_float, ctypes.c_float, ctypes.c_float,
              ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
              ctypes.c_void_p]))

ADAM_APPLY = register(Kernel(
    "adam_apply", "adam_apply.cu",
    replaces="cxxnet_tpu/ops/fused_optim.py:101",
    argtypes=[ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
              ctypes.c_float, ctypes.c_float, ctypes.c_float,
              ctypes.c_float, ctypes.c_void_p]))

#: elements a CTA of the SGD kernel updates (one leaf's chunk)
CHUNK = 8192
#: threads of an Adam CTA (``csrc/adam_apply.cu``, kAdamThreads) and the
#: elements it updates at most: one 16-byte vector a thread
ADAM_THREADS = 256
ADAM_CHUNK = 4 * ADAM_THREADS


def _f32(v: float) -> float:
    """``v`` rounded to float32, as the kernel receives it."""
    return float(np.float32(v))


def _kept(skip: Optional[torch.Tensor], old: torch.Tensor,
          new: torch.Tensor) -> torch.Tensor:
    """``old`` where the skip flag is set, else ``new`` (no host read)."""
    return new if skip is None else torch.where(skip != 0, old, new)


def sgd_apply_plain(ws: Sequence[torch.Tensor], gs: Sequence[torch.Tensor],
                    ms: Sequence[torch.Tensor], lr: float, momentum: float,
                    wd: float, clip: float, nag: bool,
                    skip: Optional[torch.Tensor] = None
                    ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Plain PyTorch SGD / NAG step, leaf by leaf, the definition of
    what the kernel computes: returns ``(new_ws, new_ms)`` and changes
    nothing it was given. Scalars enter as float32. Where ``skip`` is
    set the leaves and moments come back as they were."""
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
        new_ws.append(_kept(skip, w, nw))
        new_ms.append(_kept(skip, m, nm))
    return new_ws, new_ms


def _table(*lists: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, int]:
    """The SGD kernel's int64 table on the device: the pointers of every
    leaf in each of ``lists`` (w, g, m), the leaf sizes, then each CTA's
    leaf and chunk start. Returns ``(table, n_blocks)``."""
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


def adam_plan(sizes: np.ndarray, bases: np.ndarray) -> np.ndarray:
    """The Adam kernel's CTAs over leaves of ``sizes`` elements whose w,
    g, m1 and m2 start at the byte addresses ``bases`` (leaves, 4): rows
    (leaf, start, count, vec). A leaf whose four bases lie the same 0, 4,
    8 or 12 bytes past a 16-byte boundary takes its elements before the
    next boundary (0 to 3) as one CTA of single elements (vec 0), then
    CTAs of ADAM_CHUNK elements from there in 16-byte vectors (vec 1),
    the last one ending in a partial vector where the size leaves one;
    any other leaf takes CTAs of ADAM_CHUNK single elements."""
    sizes = np.asarray(sizes, np.int64)
    off = np.asarray(bases, np.int64) % 16
    vec = (off == off[:, :1]).all(1)
    head = np.where(vec, np.minimum((16 - off[:, 0]) % 16 // 4, sizes), 0)
    body = sizes - head
    per = -(-body // ADAM_CHUNK)
    leaf = np.repeat(np.arange(len(sizes), dtype=np.int64), per)
    k = np.arange(len(leaf), dtype=np.int64) - np.repeat(np.cumsum(per) - per,
                                                        per)
    start = np.repeat(head, per) + k * ADAM_CHUNK
    count = np.minimum(ADAM_CHUNK, np.repeat(body, per) - k * ADAM_CHUNK)
    heads = np.flatnonzero(head)
    return np.concatenate([
        np.stack([leaf, start, count, np.repeat(vec, per)], 1),
        np.stack([heads, np.zeros_like(heads), head[heads],
                  np.zeros_like(heads)], 1)]).astype(np.int64)


def adam_table(ws: Sequence[torch.Tensor], gs: Sequence[torch.Tensor],
               m1s: Sequence[torch.Tensor], m2s: Sequence[torch.Tensor]
               ) -> Tuple[torch.Tensor, int]:
    """The Adam kernel's int64 table on the device: the w, g, m1 and m2
    pointers of every leaf, then each CTA's chunk start and its word
    ``leaf << 32 | count << 1 | vec`` (:func:`adam_plan`). Returns
    ``(table, n_blocks)``."""
    lists = (ws, gs, m1s, m2s)
    ptrs = np.array([[t.data_ptr() for t in ts] for ts in lists], np.int64)
    plan = adam_plan([w.numel() for w in ws], ptrs.T)
    host = np.concatenate([ptrs.reshape(-1), plan[:, 1],
                           plan[:, 0] << 32 | plan[:, 2] << 1 | plan[:, 3]])
    # pinned, so the copy is queued on the stream without a host sync
    return (torch.from_numpy(host).pin_memory().to(ws[0].device,
                                                   non_blocking=True),
            len(plan))


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


def _check_skip(name: str, skip: Optional[torch.Tensor],
                dev: torch.device) -> None:
    """Raise unless ``skip`` is None or one int32 on ``dev``."""
    if skip is not None and (skip.dtype != torch.int32
                             or skip.numel() != 1 or skip.device != dev):
        raise ValueError(f"{name}: the skip flag must be one int32 on "
                         f"{dev} (got {skip.dtype}, {skip.numel()} "
                         f"elements on {skip.device})")


def fused_sgd_apply(ws: Sequence[torch.Tensor], gs: Sequence[torch.Tensor],
                    ms: Sequence[torch.Tensor], lr: float, momentum: float,
                    *, wd: float, clip: float, nag: bool,
                    skip: Optional[torch.Tensor] = None) -> None:
    """One SGD / NAG step over a tag group's leaves, IN PLACE: ``ws``
    and ``ms`` are overwritten, unless the device flag ``skip`` is set.
    CUDA tensors go to the kernel (one launch, which reads the flag on
    the card); CPU tensors are updated with :func:`sgd_apply_plain`.
    Raises on what the kernel does not take."""
    dev = _check_leaves("sgd_apply", ws, gs, ms)
    _check_skip("sgd_apply", skip, dev)
    with torch.no_grad():
        if dev.type == "cpu":
            nws, nms = sgd_apply_plain(ws, gs, ms, lr, momentum, wd, clip,
                                       nag, skip)
            for w, m, nw, nm in zip(ws, ms, nws, nms):
                w.copy_(nw)
                m.copy_(nm)
            return
        table, n_blocks = _table(ws, gs, ms)
        with torch.cuda.device(dev):
            SGD_APPLY.launch(table.data_ptr(), len(ws), n_blocks, CHUNK,
                             _f32(lr), _f32(momentum), _f32(wd), _f32(clip),
                             int(nag),
                             None if skip is None else skip.data_ptr(),
                             stream_handle(dev))


def adam_apply_plain(ws: Sequence[torch.Tensor], gs: Sequence[torch.Tensor],
                     m1s: Sequence[torch.Tensor],
                     m2s: Sequence[torch.Tensor], lr_t: float, d1: float,
                     d2: float, wd: float, clip: float,
                     skip: Optional[torch.Tensor] = None
                     ) -> Tuple[List[torch.Tensor], List[torch.Tensor],
                                List[torch.Tensor]]:
    """Plain PyTorch Adam step, leaf by leaf, the definition of what the
    kernel computes (the JAX package's ``Optimizer._apply`` Adam leaf):
    returns ``(new_ws, new_m1s, new_m2s)`` and changes nothing it was
    given. Scalars enter as float32; every operation is its own
    correctly rounded f32 op, as in the kernel. Where ``skip`` is set
    the leaves and moments come back as they were."""
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
        for o, old, v in zip(out, (w, m1, m2),
                             (w - lr_t * n1 / (torch.sqrt(n2) + 1e-8), n1,
                              n2)):
            o.append(_kept(skip, old, v))
    return out


def fused_adam_apply(ws: Sequence[torch.Tensor], gs: Sequence[torch.Tensor],
                     m1s: Sequence[torch.Tensor],
                     m2s: Sequence[torch.Tensor], lr_t: float, *,
                     d1: float, d2: float, wd: float, clip: float,
                     skip: Optional[torch.Tensor] = None) -> None:
    """One Adam step over a tag group's leaves, IN PLACE: ``ws``,
    ``m1s`` and ``m2s`` are overwritten, unless the flag ``skip`` is
    set. ``lr_t`` carries the bias correction (``optim.adam_lr_t``).
    CUDA tensors go to the kernel (one launch, none where the flag, read
    on the host, is set); CPU tensors are updated with
    :func:`adam_apply_plain`. Raises on what the kernel does not take."""
    dev = _check_leaves("adam_apply", ws, gs, m1s, m2s)
    _check_skip("adam_apply", skip, dev)
    with torch.no_grad():
        if dev.type == "cpu":
            new = adam_apply_plain(ws, gs, m1s, m2s, lr_t, d1, d2, wd, clip,
                                   skip)
            for dst, src in zip((ws, m1s, m2s), new):
                for t, v in zip(dst, src):
                    t.copy_(v)
            return
        if skip is not None and int(skip):
            return
        table, n_blocks = adam_table(ws, gs, m1s, m2s)
        with torch.cuda.device(dev):
            ADAM_APPLY.launch(table.data_ptr(), len(ws), n_blocks,
                              _f32(lr_t), _f32(d1), _f32(d2), _f32(wd),
                              _f32(clip), stream_handle(dev))
