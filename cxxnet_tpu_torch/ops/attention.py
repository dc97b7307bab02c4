"""Multi-head attention: the plain reference, chunked (online softmax)
attention, rotary embeddings, and flash attention with hand-written CUDA
kernels for its forward and both halves of its backward.

The port of ``cxxnet_tpu/ops/attention.py``. Every function takes
``(batch, seq, heads, head_dim)`` tensors, the JAX package's layout.

* :func:`attention_reference`, :func:`chunked_attention` and the LM
  plane's :func:`paged_attention` (with :func:`rope_at`) are plain
  torch, as they are plain jnp in the JAX package.
* :func:`flash_attention` is a ``torch.autograd.Function``. Its forward
  returns the output and keeps the per-row logsumexp ``lse``; its
  backward rebuilds the softmax from ``lse`` and ``delta = rowsum(dO *
  O)`` and computes dQ in one kernel and dK, dV in another, as the TPU
  kernels do (``_flash_fwd_kernel``, ``_flash_bwd_dq_kernel``,
  ``_flash_bwd_dkv_kernel``). Each kernel sits beside its plain version
  (:func:`flash_fwd_plain`, :func:`flash_bwd_dq_plain`,
  :func:`flash_bwd_dkv_plain`): the same function in torch ops, in f32.
  A CUDA tensor goes to the kernel (or the wrapper raises); a CPU tensor
  to the plain version; ``fused=False`` takes the plain versions on any
  device (``fused_kernels = 0``).

The kernels (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``) read and write
(B, S, H, D) through its strides: the transposes to (B * H, S, D) around
the TPU kernels are not made. All three run bf16 and f16 on the tensor
cores (``csrc/flash_tc.cuh``) and f32 on the CUDA cores. A score matrix
that feeds a second product (P in P V and P^T dO, dS in dS K and dS^T Q)
enters it as a hi and a lo part in the input type, so the product sees
it at about f32 accuracy, as the plain versions do; the backward rounds
both parts to nearest (dS cancels over a row, and dV sums many small P).
dQ and dK/dV stay two kernels, as on the TPU: no atomics, and a rerun
gives the same bits. Their tiles are the card's; the config's
``attn_block`` only picks the dispatch in the ``mha`` layer. Any S works
(the TPU kernel needed S divisible by its blocks), query and key counts
may differ, and every even head width up to 128.

Masking: ``causal`` masks strictly-future keys; a row with no key left
gives zeros (guarded divide).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .fused import DTYPE_CODES, Kernel, register, stream_handle

_NEG = -1e30

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

FLASH_FWD = register(Kernel(
    "flash_fwd", "flash_fwd.cu",
    replaces="cxxnet_tpu/ops/attention.py:255",
    argtypes=[_P] * 5 + [_I] * 5 + [_F, _I, _I, _P]))
FLASH_BWD_DQ = register(Kernel(
    "flash_bwd_dq", "flash_bwd.cu",
    replaces="cxxnet_tpu/ops/attention.py:381",
    argtypes=[_P] * 7 + [_I] * 5 + [_F, _I, _I, _P]))
FLASH_BWD_DKV = register(Kernel(
    "flash_bwd_dkv", "flash_bwd.cu",
    replaces="cxxnet_tpu/ops/attention.py:424",
    argtypes=[_P] * 8 + [_I] * 5 + [_F, _I, _I, _P]))


def _scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return (q.shape[-1] ** -0.5) if scale is None else scale


def rope(x: torch.Tensor, theta: float = 10000.0,
         offset: int = 0) -> torch.Tensor:
    """Rotary position embedding on (B, S, H, D), D even: feature pairs
    (i, i + D/2) rotated by position-dependent angles. The angles and the
    rotation are float32; a bf16 ``x`` is promoted to f32 for the rotation
    and cast back at the end, as in the JAX package."""
    pos = torch.arange(x.shape[1], dtype=torch.float32, device=x.device) \
        + float(offset)
    return _rotate(x, theta, pos[None, :])


def rope_at(x: torch.Tensor, theta: float, pos: torch.Tensor) -> torch.Tensor:
    """Rotary embedding at explicit per-token positions: ``x`` (B, S, H,
    D), ``pos`` integer (B, S) absolute positions. The same ``pos * inv``
    products and cos/sin combine as :func:`rope`, so a token rotated
    here at position p equals the row a full forward rotated at p, bit
    for bit: what the paged KV-cache's decode parity rests on."""
    return _rotate(x, theta, pos.to(torch.float32))


def _rotate(x: torch.Tensor, theta: float, pos: torch.Tensor
            ) -> torch.Tensor:
    """The rotation of :func:`rope` at f32 positions ``pos`` (B or 1, S)."""
    D = x.shape[-1]
    if D % 2:
        raise ValueError(f"rope needs an even head_dim, got {D}")
    inv = theta ** (-torch.arange(0, D // 2, dtype=torch.float32,
                                  device=x.device) / (D // 2))
    ang = pos[:, :, None] * inv                        # (B, S, D/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., : D // 2], x[..., D // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _causal_mask(sq: int, sk: int, device) -> torch.Tensor:
    """(sq, sk) keep-mask: query i sees key j when i >= j."""
    return (torch.arange(sq, device=device)[:, None]
            >= torch.arange(sk, device=device)[None, :])


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Plain softmax attention, logits and softmax in f32. q, k, v:
    (B, S, H, D) -> (B, S, H, D) in q's dtype."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * _scale(q, scale)
    if causal:
        s = torch.where(_causal_mask(s.shape[2], s.shape[3], s.device), s,
                        torch.full_like(s, _NEG))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = False, scale: Optional[float] = None,
                      block_k: int = 128) -> torch.Tensor:
    """Online-softmax attention over key/value blocks of ``block_k``
    (the JAX package's scan, a Python loop here; differentiated by
    autograd). (B, S, H, D) -> (B, S, H, D) in q's dtype."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    sc = _scale(q, scale)
    block_k = min(block_k, Sk)
    qf = q.float()
    acc = q.new_zeros((B, H, Sq, D), dtype=torch.float32)
    m = torch.full((B, H, Sq), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    q_pos = torch.arange(Sq, device=q.device)
    for j in range(0, Sk, block_k):
        kb, vb = k[:, j:j + block_k].float(), v[:, j:j + block_k].float()
        k_pos = torch.arange(j, j + kb.shape[1], device=q.device)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kb) * sc
        mask = (q_pos[:, None] >= k_pos[None, :]) if causal else None
        if mask is not None:
            s = torch.where(mask, s, torch.full_like(s, _NEG))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        if mask is not None:
            p = torch.where(mask, p, torch.zeros_like(p))
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, tables: torch.Tensor,
                    q_pos: torch.Tensor, lengths: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Attention over a paged KV-cache, gather-style (the JAX package's
    ``paged_attention``, which is plain jnp there as it is plain torch
    here): each sequence's keys and values live in fixed-size token
    blocks of a shared pool, addressed by its block table.

    q (B, Q, H, D): the query tokens (Q 1 at a decode step, the chunk at
    prefill); k_pool, v_pool (N, bs, H, D); tables (B, T) integer block
    ids, logical token i of row b at ``(tables[b, i // bs], i % bs)``;
    q_pos (B, Q) absolute positions of the queries; lengths (B,) valid
    tokens a row (0: a dead row). Keys past a query's position or past
    the row's length take -1e30 before an f32 softmax, so a dead row
    comes out uniform, never NaN. Each row depends only on its own q,
    table and the pool. Returns (B, Q, H, D) in q's dtype."""
    N, bs, H, D = k_pool.shape
    B, T = tables.shape
    kg = k_pool[tables].reshape(B, T * bs, H, D)
    vg = v_pool[tables].reshape(B, T * bs, H, D)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kg.float()) \
        * _scale(q, scale)
    # the gathered flat index is the logical position (ordered tables)
    k_pos = torch.arange(T * bs, device=q.device)
    mask = (k_pos <= q_pos[:, None, :, None]) \
        & (k_pos < lengths[:, None, None, None])
    s = torch.where(mask, s, torch.full_like(s, _NEG))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vg.float()).to(q.dtype)


# -- flash attention: plain versions ------------------------------------------

def _heads_first(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) -> (B, H, S, D) float32."""
    return x.float().permute(0, 2, 1, 3)


def _probs(q, k, lse, causal: bool, scale: float) -> torch.Tensor:
    """P = exp(scale * Q K^T - lse), masked entries 0: (B, H, Sq, Sk)."""
    s = torch.matmul(_heads_first(q), _heads_first(k).transpose(-1, -2)) \
        * scale
    p = torch.exp(s - lse[..., None])
    if causal:
        p = torch.where(_causal_mask(s.shape[2], s.shape[3], s.device), p,
                        torch.zeros_like(p))
    return p


def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, scale: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the forward kernel computes, in f32 torch ops: the output
    (B, Sq, H, D) in q's dtype and ``lse`` (B, H, Sq) f32."""
    s = torch.matmul(_heads_first(q), _heads_first(k).transpose(-1, -2)) \
        * scale
    mask = _causal_mask(s.shape[2], s.shape[3], s.device) if causal \
        else None
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, _NEG))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    if mask is not None:
        p = torch.where(mask, p, torch.zeros_like(p))
    l = torch.clamp(p.sum(dim=-1), min=1e-30)
    out = torch.matmul(p, _heads_first(v)) / l[..., None]
    return (out.permute(0, 2, 1, 3).to(q.dtype).contiguous(),
            (m + torch.log(l)).contiguous())


def flash_delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(dO * O)`` in f32, (B, H, Sq): the backward's
    per-row term, a plain reduction as in the JAX package."""
    return (dout.float() * out.float()).sum(dim=-1).permute(0, 2, 1) \
        .contiguous()


def flash_bwd_dq_plain(q, k, v, dout, lse, delta, causal: bool,
                       scale: float) -> torch.Tensor:
    """What the dQ kernel computes: dQ = scale * (P o (dO V^T - delta))
    K, in q's dtype."""
    p = _probs(q, k, lse, causal, scale)
    dp = torch.matmul(_heads_first(dout), _heads_first(v).transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.matmul(ds, _heads_first(k))
    return dq.permute(0, 2, 1, 3).to(q.dtype).contiguous()


def flash_bwd_dkv_plain(q, k, v, dout, lse, delta, causal: bool,
                        scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the dK/dV kernel computes: dK = scale * (P o (dO V^T -
    delta))^T Q and dV = P^T dO, in k's and v's dtypes."""
    p = _probs(q, k, lse, causal, scale)
    dof = _heads_first(dout)
    dp = torch.matmul(dof, _heads_first(v).transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * scale
    dk = torch.matmul(ds.transpose(-1, -2), _heads_first(q))
    dv = torch.matmul(p.transpose(-1, -2), dof)
    return (dk.permute(0, 2, 1, 3).to(k.dtype).contiguous(),
            dv.permute(0, 2, 1, 3).to(v.dtype).contiguous())


# -- flash attention: kernel wrappers -----------------------------------------

def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           *others: torch.Tensor) -> Tuple[int, int, int, int, int]:
    """(B, Sq, Sk, H, D) of the operands; raises on what the kernels do
    not take: 4-D (B, S, H, D) tensors of one float dtype, contiguous, on
    one device, k and v alike, D even and at most 128."""
    for t in (q, k, v) + others:
        if t.dim() != 4:
            raise ValueError("flash attention: operands are (B, S, H, D), "
                             f"got {tuple(t.shape)}")
        if t.dtype != q.dtype or t.device != q.device:
            raise TypeError("flash attention: operands differ in dtype or "
                            f"device ({t.dtype} on {t.device}, {q.dtype} on "
                            f"{q.device})")
        if not t.is_contiguous():
            raise ValueError("flash attention: operands must be contiguous")
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"flash attention: dtype {q.dtype} not supported")
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    if k.shape != (B, Sk, H, D) or v.shape != k.shape:
        raise ValueError(f"flash attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not match")
    if D % 2 or D > 128 or Sq == 0 or Sk == 0:
        raise ValueError(f"flash attention: head width {D} (must be even and "
                         "at most 128) or an empty sequence")
    return B, Sq, Sk, H, D


def _check_rows(name: str, t: torch.Tensor, B: int, H: int, Sq: int) -> None:
    if t.dtype != torch.float32 or tuple(t.shape) != (B, H, Sq) \
            or not t.is_contiguous():
        raise ValueError(f"flash attention: {name} must be a contiguous f32 "
                         f"(B, H, Sq) = {(B, H, Sq)} tensor, got {t.dtype} "
                         f"{tuple(t.shape)}")


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, scale: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel on CUDA tensors (one launch), its plain version
    on CPU tensors: ``(out, lse)``."""
    B, Sq, Sk, H, D = _check(q, k, v)
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd: no kernel for device {q.device}")
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        FLASH_FWD.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), lse.data_ptr(), B, Sq, Sk, H, D,
                         float(scale), int(causal), DTYPE_CODES[q.dtype],
                         stream_handle(q.device))
    return out, lse


def flash_bwd_dq(q, k, v, dout, lse, delta, causal: bool,
                 scale: float) -> torch.Tensor:
    """The dQ kernel on CUDA tensors (one launch), its plain version on
    CPU tensors."""
    B, Sq, Sk, H, D = _check(q, k, v, dout)
    _check_rows("lse", lse, B, H, Sq)
    _check_rows("delta", delta, B, H, Sq)
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, dout, lse, delta, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd_dq: no kernel for device {q.device}")
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        FLASH_BWD_DQ.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                            dq.data_ptr(), B, Sq, Sk, H, D, float(scale),
                            int(causal), DTYPE_CODES[q.dtype],
                            stream_handle(q.device))
    return dq


def flash_bwd_dkv(q, k, v, dout, lse, delta, causal: bool,
                  scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dK/dV kernel on CUDA tensors (one launch), its plain version
    on CPU tensors: ``(dk, dv)``."""
    B, Sq, Sk, H, D = _check(q, k, v, dout)
    _check_rows("lse", lse, B, H, Sq)
    _check_rows("delta", delta, B, H, Sq)
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, dout, lse, delta, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd_dkv: no kernel for device {q.device}")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        FLASH_BWD_DKV.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             dout.data_ptr(), lse.data_ptr(),
                             delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                             B, Sq, Sk, H, D, float(scale), int(causal),
                             DTYPE_CODES[q.dtype], stream_handle(q.device))
    return dk, dv


class FlashAttention(torch.autograd.Function):
    """Flash attention with its fused backward: the kernels (``fused``)
    or their plain versions, forward and backward alike."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float, fused: bool):
        fwd = flash_fwd if fused else flash_fwd_plain
        out, lse = fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale, ctx.fused = causal, scale, fused
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        delta = flash_delta(out, dout)
        args = (q, k, v, dout, lse, delta, ctx.causal, ctx.scale)
        if ctx.fused:
            dq, (dk, dv) = flash_bwd_dq(*args), flash_bwd_dkv(*args)
        else:
            dq, (dk, dv) = flash_bwd_dq_plain(*args), \
                flash_bwd_dkv_plain(*args)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, scale: Optional[float] = None,
                    fused: bool = True) -> torch.Tensor:
    """Flash attention (B, S, H, D) -> (B, S, H, D) in q's dtype,
    differentiable once (the backward is kernels, not traced ops; use
    :func:`chunked_attention` for higher order). ``fused`` selects the
    kernels (a CUDA tensor launches them or raises; a CPU tensor takes
    their plain versions); ``fused=False`` the plain versions anywhere."""
    return FlashAttention.apply(q, k, v, bool(causal), _scale(q, scale),
                                bool(fused))
