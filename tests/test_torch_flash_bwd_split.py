"""The arithmetic of the tensor-core flash backward kernels
(``cxxnet_tpu_torch/csrc/flash_bwd.cu``), emulated in torch on the CPU.

The kernels take S = Q K^T and dP = dO V^T on the tensor cores (exact
products of bf16 or f16 operands, f32 sums), P = exp2(S * scale *
log2(e) - lse * log2(e)) and dS = P (dP - delta) in f32, and feed P and
dS into the next products as hi + lo pairs in the input type:

* dS split to nearest, both parts; f16's lo part is 2^11 times the
  remainder, scaled back after its product;
* P split to nearest, both parts; f16 splits P * 2^14 (P <= 1), scaled
  back after the product.

The emulation here repeats those steps (f32 matmuls of values that are
exact in the input type: exact products, f32 sums) and is held, before
the outputs' rounding, within 1e-5 of max|plain| of the plain versions
(``flash_bwd_dq_plain``, ``flash_bwd_dkv_plain``) at (1, 1024, 2, 16),
causal and not, bf16 and f16. dS's cancelling row sums and dV's sums of
small P are what the split has to get right: the forward's truncating
split (of P, in bf16) is shown to err more than the rounded one, on dS
for dQ and dK and on P for dV. Rounded to the input type, the
emulation is also held against the JAX package's Pallas backward (the
vjp of ``flash_attention`` in interpret mode, TPU blocks of 32) on the
same inputs at (2, 128, 2, 16): within one ulp of the value (f32 sums in
another order, then one rounding each side) plus 2e-5 of max|JAX|, the
chip check's bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cxxnet_tpu.ops import attention as jatt
from cxxnet_tpu_torch.ops import attention as att

SHAPE = (1, 1024, 2, 16)
LOG2E = 1.442695040888963407
DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}


def _inputs(shape, dtype, seed=0):
    """q, k, v, dO from a seeded numpy draw, rounded once to ``dtype``."""
    rs = np.random.RandomState(seed)
    return [torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(dtype)
            for _ in range(4)]


def _f32(x):
    return x.float().permute(0, 2, 1, 3)            # (B, H, S, D)


def _back(x):
    return x.permute(0, 2, 1, 3).contiguous()       # (B, S, H, D)


def _trunc_bf16(x):
    """x cut to its top 16 bits (split2<__nv_bfloat16>'s byte permute)."""
    return (x.view(torch.int32) & -65536).view(torch.float32)


def split_ds(x, dtype):
    """split2_rn<T, lo_shift<T>()>: hi = x in the input type, lo = the
    remainder, both rounded to nearest; f16's lo carried as 2^11 times
    the remainder."""
    hi = x.to(dtype).float()
    if dtype == torch.float16:
        return hi, ((x - hi) * 2048).to(dtype).float() / 2048
    return hi, (x - hi).to(dtype).float()




def split_p(p, dtype):
    """split2_rn<T, 0> of P on its way into dV: both parts rounded to
    nearest; f16 splits P * 2^14 (P <= 1), scaled back after the
    product."""
    lift = 16384.0 if dtype == torch.float16 else 1.0
    ps = p * lift
    hi = ps.to(dtype).float()
    return hi / lift, (ps - hi).to(dtype).float() / lift


def split_truncating(x, dtype):
    """The forward's split of P in bf16 (split2): both parts cut."""
    hi = _trunc_bf16(x)
    return hi, _trunc_bf16(x - hi)


def emulate(q, k, v, g, lse, delta, causal, scale, dsplit=split_ds,
            psplit=split_p):
    """dQ, dK, dV (f32, before the outputs' rounding) as the kernels
    compute them."""
    dt = q.dtype
    qf, kf, vf, gf = (_f32(t) for t in (q, k, v, g))
    scale_log2 = np.float32(scale * LOG2E)
    s = torch.matmul(qf, kf.transpose(-1, -2))
    nl = -lse * np.float32(LOG2E)
    # one FFMA: s * scale_log2 + nl rounded once
    t = (s.double() * float(scale_log2) + nl.double()[..., None]).float()
    p = torch.exp2(t)
    if causal:
        sq, sk = s.shape[-2:]
        keep = torch.arange(sq)[:, None] >= torch.arange(sk)[None, :]
        p = torch.where(keep, p, torch.zeros_like(p))
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    ds = p * (dp - delta[..., None])
    dh, dl = dsplit(ds, dt)
    dq = (torch.matmul(dh, kf) + torch.matmul(dl, kf)) * np.float32(scale)
    dk = (torch.matmul(dh.transpose(-1, -2), qf)
          + torch.matmul(dl.transpose(-1, -2), qf)) * np.float32(scale)
    ph, pl = psplit(p, dt)
    dv = torch.matmul(ph.transpose(-1, -2), gf) \
        + torch.matmul(pl.transpose(-1, -2), gf)
    return _back(dq), _back(dk), _back(dv)


def _case(dtype, causal, shape=SHAPE, seed=0):
    """Inputs, the plain forward's lse and delta (as the chip check
    feeds the kernels) and the plain versions' f32 gradients."""
    q, k, v, g = _inputs(shape, dtype, seed)
    scale = shape[-1] ** -0.5
    out, lse = att.flash_fwd_plain(q, k, v, causal, scale)
    delta = att.flash_delta(out, g)
    f = [t.float() for t in (q, k, v, g)]
    want = [att.flash_bwd_dq_plain(*f, lse, delta, causal, scale),
            *att.flash_bwd_dkv_plain(*f, lse, delta, causal, scale)]
    return (q, k, v, g, lse, delta, causal, scale), want


def _rel_err(got, want):
    """max |got - want| over max |want|, per gradient."""
    return [float((a - b).abs().max() / b.abs().max())
            for a, b in zip(got, want)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_emulated_kernels_match_plain_before_rounding(dtype, causal):
    args, want = _case(DTYPES[dtype], causal)
    errs = _rel_err(emulate(*args), want)
    assert max(errs) <= 1e-5, errs


@pytest.mark.parametrize("causal", [True, False])
def test_truncating_splits_err_more_than_the_rounded(causal):
    """dS cancels over a row and dV sums many small P: cutting both
    parts biases dQ and dK (through dS) and dV (through P)."""
    args, want = _case(torch.bfloat16, causal)
    rounded = _rel_err(emulate(*args), want)
    cut_ds = _rel_err(emulate(*args, dsplit=split_truncating), want)
    assert cut_ds[0] > rounded[0] and cut_ds[1] > rounded[1], \
        (cut_ds, rounded)
    assert cut_ds[2] == rounded[2]          # dV takes P's split only
    cut_p = _rel_err(emulate(*args, psplit=split_truncating), want)
    assert cut_p[2] > rounded[2] and cut_p[:2] == rounded[:2], \
        (cut_p, rounded)


def _jax_vjp(q, k, v, g, causal, block):
    """dQ, dK, dV of the JAX package's Pallas flash attention (interpret
    mode) on the same values."""
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}[q.dtype]
    js = [jnp.asarray(t.float().numpy(), jdt) for t in (q, k, v, g)]
    fn = lambda a, b, c: jatt.flash_attention(a, b, c, causal, None, block,
                                              block, True)
    jaxpr = str(jax.make_jaxpr(jax.vjp(fn, *js[:3])[1])(js[3]))
    assert jaxpr.count("pallas_call") == 2          # dq and dk/dv
    _, vjp = jax.vjp(fn, *js[:3])
    return [np.asarray(x, np.float32) for x in vjp(js[3])]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_emulated_kernels_match_the_jax_pallas_backward(dtype, causal):
    dt = DTYPES[dtype]
    args, _ = _case(dt, causal, shape=(2, 128, 2, 16), seed=3)
    got = [t.to(dt).float().numpy() for t in emulate(*args)]
    want = _jax_vjp(*args[:4], causal, block=32)
    ulp = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}[dt]
    for a, b in zip(got, want):
        err = np.abs(a - b)
        assert (err <= ulp * np.abs(b) + 2e-5 * np.abs(b).max()).all(), \
            err.max()
