"""int8 inference: static-scale activation quantization, the int8 x int8
-> int32 product and its fused dequant + bias + relu epilogue.

The port of ``cxxnet_tpu/ops/fused_quant.py``. Weights arrive quantized
by the PTQ pass (``quant/ptq.py``): ``wmat`` int8, ``wmat_scale`` f32 per
output channel, ``act_scale`` an f32 scalar. Activations are quantized
against the static ``act_scale`` (:func:`quantize_act`), the product runs
int8 x int8 with an int32 accumulator, and the epilogue turns it back
into f32 with ``factor = wmat_scale * act_scale / 127``, then adds the
bias and applies the graph-folded relu. Inference only: quantized
weights never train.

The kernel is ``csrc/q_mm.cu`` (:func:`q_mm`); its plain version,
:func:`q_mm_plain`, takes the product in float64, which is exact
(|acc| <= 127^2 * K < 2^53), so one definition serves the CPU and the
card, where PyTorch has no integer matrix product. Both round the
epilogue twice (``float(acc) * factor``, then ``+ bias``) and are
bit-equal on the card. The JAX package's compiled epilogue is one FMA,
so against it an output may differ by one f32 rounding.

Layouts: the weight is handed to the product as ``wt`` (G*N, K), K
contiguous, laid out once when a round is loaded
(:func:`fullc_weight_for_kernel`, :func:`conv_weight_for_kernel`); the
quantized rows as (M, G*K), group g reading columns [g*K, (g+1)*K).
A convolution (:func:`int8_conv`, NHWC) quantizes, builds the int8
im2col (columns in (kh, kw, cin) order, the order of the weight's K) and
runs one product for all its groups. Zero padding quantizes to code 0,
so im2col and quantization commute. The quantize and im2col passes are
PyTorch ops, as the JAX package computes them outside its kernel.

Unlike the TPU kernel, whose int8 tiling took K and N in multiples of
128 and rows in multiples of 32, the Hopper kernel takes every shape.
Its tiles and its split of K are chosen here (:func:`q_mm_plan`); its
fast variant wants rows of a multiple of 16 bytes, so the conv pads K to
a multiple of 16 with zero columns in the im2col and in its laid-out
weight (:func:`padded_k`), which leaves every exact sum as it is. The
round's stored weight stays unpadded. A CUDA tensor goes to the kernel
or raises; the plain version runs on the CPU and under ``fused_kernels
= 0``.
"""

from __future__ import annotations

import collections
import ctypes
import threading
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .fused import Kernel, register, sm_count, split_scratch, stream_handle

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
Q_MM = register(Kernel(
    "q_mm", "q_mm.cu", replaces="cxxnet_tpu/ops/fused_quant.py:68",
    argtypes=[_P] * 5 + [_I] * 4 + [_L, _L] + [_I] * 5 + [_P] * 3))

#: the kernel's row tiles (BM, BK bytes of K a step), csrc/q_mm.cu's T16
#: to T128: the smallest BM that holds M is taken
Q_MM_TILES = ((16, 128), (32, 128), (64, 64), (128, 64))
#: its column tile
Q_MM_BN = 64
#: the fewest K steps a split of K takes
Q_MM_MIN_STEPS = 2
#: CTAs per SM that a split of K aims at
Q_MM_CTAS_PER_SM = 2
#: the most splits of K: the last CTA of a tile reads the others'
#: partials
Q_MM_MAX_SPLITS = 8
#: variant of each launch since :func:`reset_q_mm_variants`, by name:
#: "pipelined" (16-byte copy ring) or "odd" (4-byte gathers), the row
#: tile and the split, e.g. "pipelined bm32 x5"
Q_MM_VARIANTS: collections.Counter = collections.Counter()
_lock = threading.Lock()


class QmmPlan(NamedTuple):
    """One launch's tiling: row tile ``bm``, K step ``bk``, ``splits``
    CTAs over K per output tile taking ``kps`` steps each (the last
    fewer), ``tiles`` output tiles."""
    bm: int
    bk: int
    splits: int
    kps: int
    tiles: int


def q_mm_plan(m: int, k: int, n: int, groups: int = 1,
              sms: int = 132) -> QmmPlan:
    """The tiling of an (M, K) x (K, N) product per group on a card of
    ``sms`` SMs: the smallest row tile of :data:`Q_MM_TILES` that holds M
    (the largest past 128 rows); where the output tiles do not fill the
    SMs, K split so that at least :data:`Q_MM_CTAS_PER_SM` CTAs run per
    SM where K has the steps, each split :data:`Q_MM_MIN_STEPS` steps
    long or more, at most :data:`Q_MM_MAX_SPLITS` splits, the last one
    shorter where the steps do not divide."""
    bm, bk = next((t for t in Q_MM_TILES if m <= t[0]), Q_MM_TILES[-1])
    tiles = -(-max(m, 1) // bm) * -(-n // Q_MM_BN) * groups
    steps = -(-k // bk)
    kps = steps
    if tiles < sms:
        want = -(-Q_MM_CTAS_PER_SM * sms // tiles)
        kps = max(Q_MM_MIN_STEPS, steps // want,
                  -(-steps // Q_MM_MAX_SPLITS))
    return QmmPlan(bm, bk, -(-steps // kps), kps, tiles)


def reset_q_mm_variants() -> None:
    with _lock:
        Q_MM_VARIANTS.clear()


def padded_k(k: int) -> int:
    """K rounded up to a multiple of 16: the conv's operand rows are
    then multiples of 16 bytes."""
    return -(-k // 16) * 16


def quantize_act(x: torch.Tensor, act_scale: torch.Tensor) -> torch.Tensor:
    """Static-scale activation quantization, f32 -> int8: ``round(clip(x
    / act_scale, -1, 1) * 127)``, half to even; values beyond the
    calibrated range saturate. ``act_scale`` is a 0-dim float32 tensor
    on ``x``'s device (a Python float would let the card multiply by its
    reciprocal, which can move a code at a .5 boundary)."""
    q = torch.clamp(x.float() / act_scale, -1.0, 1.0) * 127.0
    return torch.round(q).to(torch.int8)


def dequant_factor(w_scale: torch.Tensor,
                   act_scale: torch.Tensor) -> torch.Tensor:
    """Per-output-channel f32 factor turning the int32 accumulator back
    into real units: ``w_scale * (act_scale / 127)``, the 127 a 0-dim
    tensor on the device so that the division stays a division there."""
    d = torch.full((), 127.0, dtype=torch.float32, device=act_scale.device)
    return w_scale.float() * (act_scale.float() / d)


def fullc_weight_for_kernel(wq: torch.Tensor) -> torch.Tensor:
    """A fullc/seqfc int8 ``wmat`` (K, N) as the product reads it: (N, K)."""
    return wq.t().contiguous()


def conv_weight_for_kernel(wq: torch.Tensor) -> torch.Tensor:
    """An int8 conv ``wmat`` OIHW (cout, cin/G, kh, kw) as the product
    reads it: (cout, padded_k(kh*kw*cin/G)), K in (kh, kw, cin) order,
    then zero columns. A copy: the round keeps ``wq`` as it is."""
    w = wq.permute(0, 2, 3, 1).reshape(wq.shape[0], -1)
    k = w.shape[1]
    out = wq.new_zeros((wq.shape[0], padded_k(k)))
    out[:, :k] = w
    return out


def _check(xq, wt, factor, bias, act, groups) -> Tuple[int, int, int]:
    if act not in ("none", "relu"):
        raise ValueError(f"q_mm: act must be none or relu, got {act!r}")
    if xq.dtype != torch.int8 or wt.dtype != torch.int8:
        raise TypeError(f"q_mm: operands must be int8 (got {xq.dtype}, "
                        f"{wt.dtype})")
    if xq.dim() != 2 or wt.dim() != 2 or groups < 1:
        raise ValueError(f"q_mm: need xq (M, G*K), wt (G*N, K), G >= 1; "
                         f"got {tuple(xq.shape)}, {tuple(wt.shape)}, "
                         f"G {groups}")
    if wt.shape[1] == 0:
        raise ValueError("q_mm: K is 0")
    k = wt.shape[1]
    if xq.shape[1] != groups * k or wt.shape[0] % groups:
        raise ValueError(f"q_mm: xq {tuple(xq.shape)} and wt "
                         f"{tuple(wt.shape)} do not match {groups} groups")
    n_all = wt.shape[0]
    for name, v in (("factor", factor), ("bias", bias)):
        if v is not None and tuple(v.shape) != (n_all,):
            raise ValueError(f"q_mm: {name} shape {tuple(v.shape)} != "
                             f"({n_all},)")
    return xq.shape[0], k, n_all // groups


def q_mm_plain(xq: torch.Tensor, wt: torch.Tensor, factor: torch.Tensor,
               bias: Optional[torch.Tensor], act: str = "none",
               groups: int = 1) -> torch.Tensor:
    """Plain PyTorch version, the definition of what the kernel computes:
    per group g, ``acc = xq[:, gK:(g+1)K] @ wt[gN:(g+1)N].T`` taken
    exactly in float64 and held as int32, then ``float32(acc) * factor``,
    ``+ bias`` (each rounded), relu when ``act == "relu"``. Returns (M,
    G*N) float32."""
    m, k, n = _check(xq, wt, factor, bias, act, groups)
    x64, w64 = xq.double(), wt.double()
    acc = torch.cat([x64[:, g * k:(g + 1) * k] @ w64[g * n:(g + 1) * n].t()
                     for g in range(groups)], dim=1).to(torch.int32)
    y = acc.float() * factor.float()
    if bias is not None:
        y = y + bias.float()
    if act == "relu":
        y = torch.relu(y)
    return y


def q_mm(xq: torch.Tensor, wt: torch.Tensor, factor: torch.Tensor,
         bias: Optional[torch.Tensor], act: str = "none",
         groups: int = 1) -> torch.Tensor:
    """The product with its fused epilogue: on CUDA tensors the kernel
    (one launch, tiled by :func:`q_mm_plan`; every operand contiguous on
    one device, factor and bias float32), on CPU tensors
    :func:`q_mm_plain`. Raises on what the kernel does not take; never
    falls back."""
    m, k, n = _check(xq, wt, factor, bias, act, groups)
    if xq.device.type == "cpu":
        return q_mm_plain(xq, wt, factor, bias, act, groups)
    if xq.device.type != "cuda":
        raise ValueError(f"q_mm: no kernel for device {xq.device}")
    for name, v in (("xq", xq), ("wt", wt), ("factor", factor),
                    ("bias", bias)):
        if v is None:
            continue
        if v.device != xq.device or not v.is_contiguous():
            raise ValueError(f"q_mm: {name} must be contiguous on "
                             f"{xq.device} (got {v.device})")
        if name in ("factor", "bias") and v.dtype != torch.float32:
            raise TypeError(f"q_mm: {name} must be float32, got {v.dtype}")
    dev = xq.device
    plan = q_mm_plan(m, k, n, groups, sm_count(dev))
    # the copy ring wants rows of a multiple of 16 bytes (the conv pads K)
    aligned = (k % 16 == 0 and xq.data_ptr() % 16 == 0
               and wt.data_ptr() % 16 == 0)
    y = torch.empty((m, groups * n), dtype=torch.float32, device=dev)
    ws = cnt = None
    if plan.splits > 1:
        ws, cnt = split_scratch(dev, "q_mm", 4 * plan.tiles * plan.splits
                                * plan.bm * Q_MM_BN, plan.tiles)
    with torch.cuda.device(dev):
        Q_MM.launch(xq.data_ptr(), wt.data_ptr(), factor.data_ptr(),
                    None if bias is None else bias.data_ptr(), y.data_ptr(),
                    m, k, n, groups, groups * k, k, int(act == "relu"),
                    plan.bm, plan.splits, plan.kps, int(aligned),
                    None if ws is None else ws.data_ptr(),
                    None if cnt is None else cnt.data_ptr(),
                    stream_handle(dev))
    with _lock:
        Q_MM_VARIANTS[f"{'pipelined' if aligned else 'odd'} bm{plan.bm} "
                      f"x{plan.splits}"] += 1
    return y


def int8_matmul(x: torch.Tensor, wt: torch.Tensor, w_scale: torch.Tensor,
                act_scale: torch.Tensor,
                bias: Optional[torch.Tensor] = None, act: str = "none", *,
                fused: bool = True) -> torch.Tensor:
    """Quantized linear: f32 ``x`` (M, K) against the int8 weight ``wt``
    (N, K) (:func:`fullc_weight_for_kernel` of the round's (K, N)) with
    per-output-channel ``w_scale`` (N,); output (M, N) float32 after the
    fused epilogue. ``fused`` selects :func:`q_mm` (the kernel on the
    card); False the plain version on any device."""
    xq = quantize_act(x, act_scale)
    factor = dequant_factor(w_scale, act_scale)
    fb = None if bias is None else bias.float()
    return (q_mm if fused else q_mm_plain)(xq, wt, factor, fb, act)


def im2col_int8(xq: torch.Tensor, kh: int, kw: int, stride: int,
                padding: Tuple[int, int], groups: int,
                kp: Optional[int] = None) -> torch.Tensor:
    """int8 NHWC (B, H, W, C) -> (B*OH*OW, G*kp) patch rows: group g's
    K = kh*kw*C/G columns in (kh, kw, cin) order at [g*kp, g*kp + K),
    then zeros up to kp (default K, no zeros). Zero padding, ``unfold``
    views, then one copy into the rows (and a fill of the zero
    columns)."""
    b, _, _, c = xq.shape
    py, px = padding
    if py or px:
        xq = F.pad(xq, (0, 0, px, px, py, py))
    p = xq.unfold(1, kh, stride).unfold(2, kw, stride)  # B,OH,OW,C,kh,kw
    oh, ow = p.shape[1], p.shape[2]
    cg = c // groups
    p = p.reshape(b, oh, ow, groups, cg, kh, kw).permute(0, 1, 2, 3, 5, 6, 4)
    k = kh * kw * cg
    kp = k if kp is None else kp
    if kp == k:
        return p.reshape(b * oh * ow, -1)
    if kp < k:
        raise ValueError(f"im2col_int8: row width {kp} < K {k}")
    out = xq.new_empty((b * oh * ow, groups, kp))
    out[..., k:].zero_()
    out[..., :k].view(b, oh, ow, groups, kh, kw, cg).copy_(p)
    return out.view(b * oh * ow, groups * kp)


def int8_conv(x: torch.Tensor, wt: torch.Tensor, w_scale: torch.Tensor,
              act_scale: torch.Tensor, bias: Optional[torch.Tensor] = None,
              act: str = "none", *, kernel: Tuple[int, int],
              stride: int = 1, padding: Tuple[int, int] = (0, 0),
              groups: int = 1, fused: bool = True) -> torch.Tensor:
    """Quantized convolution: f32 NHWC ``x`` against the int8 weight
    ``wt`` (cout, kp) (:func:`conv_weight_for_kernel` of the round's
    OIHW: K = kh*kw*cin/G columns, then zeros up to kp >= K) with
    per-output-channel ``w_scale``; output NHWC float32 after the fused
    epilogue, one product for all groups over rows padded to kp."""
    kh, kw = kernel
    b, h, w, c = x.shape
    k, kp = kh * kw * (c // groups), wt.shape[1]
    if kp < k:
        raise ValueError(f"int8_conv: weight rows of {kp} < K {k}")
    xq = quantize_act(x, act_scale)
    cols = im2col_int8(xq, kh, kw, stride, padding, groups, kp)
    factor = dequant_factor(w_scale, act_scale)
    fb = None if bias is None else bias.float()
    y = (q_mm if fused else q_mm_plain)(cols, wt, factor, fb, act, groups)
    oh = (h + 2 * padding[0] - kh) // stride + 1
    ow = (w + 2 * padding[1] - kw) // stride + 1
    return y.reshape(b, oh, ow, wt.shape[0])
