"""The port's attention (``cxxnet_tpu_torch/ops/attention.py``) against
the JAX package's ``cxxnet_tpu/ops/attention.py`` on the CPU.

* Flash attention: the port's plain versions of the three kernels
  against the JAX package's Pallas kernels run in interpret mode
  (``pallas_call`` asserted in the jaxpr), on the same numpy inputs at
  B 2, S 64, H 2, D 16 with the TPU blocks at 32, causal and not. The
  forward's output and ``lse``, and dQ, dK, dV from the same upstream
  gradient. float32: relative L2 1e-5 (the same f32 math summed in
  another order). bfloat16: the outputs and gradients are rounded to
  bf16 by both, so each element is held within 2^-7 of the JAX value
  relative (one bf16 ulp; f32 sums in another order may round across
  one) plus 1e-3 absolute for values near 0, ``lse`` (f32) at 1e-5.
* The kernel wrappers on CPU tensors are their plain versions, and
  ``flash_attention``'s backward is the dQ and dK/dV functions.
* ``rope``, ``attention_reference`` and ``chunked_attention`` against
  the JAX functions (float32 relative L2 1e-5; rope in bf16 within
  2^-8 relative, one rounding), gradients of the chunked attention too.
* The ``mha`` layer's ``auto`` dispatch is the JAX package's with the
  card in the TPU's place.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cxxnet_tpu.ops import attention as jatt
from cxxnet_tpu_torch.ops import attention as att

B, S, H, D = 2, 64, 2, 16
BLOCK = 32


def _inputs(seed, dtype, shape=(B, S, H, D), n=4):
    rs = np.random.RandomState(seed)
    arrs = [rs.randn(*shape).astype(np.float32) for _ in range(n)]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = getattr(torch, dtype)
    # round through the dtype once so both packages see the same values
    js = [jnp.asarray(a, jdt) for a in arrs]
    ts = [torch.from_numpy(np.array(j, np.float32)).to(tdt) for j in js]
    return js, ts


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _close(got, want, dtype):
    got = np.asarray(got.float().detach() if torch.is_tensor(got) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "float32":
        assert _rel(got, want) <= 1e-5, _rel(got, want)
    else:
        err = np.abs(got - want)
        assert (err <= 2.0 ** -7 * np.abs(want) + 1e-3).all(), err.max()


def _jax_flash(causal):
    return lambda q, k, v: jatt.flash_attention(
        q, k, v, causal, None, BLOCK, BLOCK, True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_the_jax_pallas_kernels(causal, dtype):
    (q, k, v, g), (tq, tk, tv, tg) = _inputs(1, dtype)
    jaxpr = str(jax.make_jaxpr(jax.vjp(_jax_flash(causal), q, k, v)[1])(g))
    assert jaxpr.count("pallas_call") == 2          # dq and dk/dv
    assert "pallas_call" in str(jax.make_jaxpr(_jax_flash(causal))(q, k, v))
    out, lse = jatt._flash_forward(q, k, v, causal, None, BLOCK, BLOCK,
                                   True, with_lse=True)
    scale = D ** -0.5
    tout, tlse = att.flash_fwd_plain(tq, tk, tv, causal, scale)
    assert tout.dtype == tq.dtype and tlse.dtype == torch.float32
    _close(tout, out, dtype)
    assert _rel(tlse.numpy(), np.asarray(lse).reshape(B, H, S)) <= 1e-5
    dq, dk, dv = jatt._flash_backward(q, k, v, out, lse, g, causal, None,
                                      BLOCK, BLOCK, True)
    # the port's backward from the JAX forward's output and lse
    tout_j = torch.from_numpy(np.asarray(out, np.float32)).to(tq.dtype)
    tlse_j = torch.from_numpy(np.asarray(lse).reshape(B, H, S).copy())
    delta = att.flash_delta(tout_j, tg)
    args = (tq, tk, tv, tg, tlse_j, delta, causal, scale)
    _close(att.flash_bwd_dq_plain(*args), dq, dtype)
    tdk, tdv = att.flash_bwd_dkv_plain(*args)
    _close(tdk, dk, dtype)
    _close(tdv, dv, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_autograd_matches_the_jax_vjp(causal, dtype):
    """The whole autograd function (the kernel wrappers on CPU tensors)
    against ``jax.vjp`` of the JAX package's flash attention."""
    (q, k, v, g), (tq, tk, tv, tg) = _inputs(2, dtype)
    out, vjp = jax.vjp(_jax_flash(causal), q, k, v)
    dq, dk, dv = vjp(g)
    xs = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    tout = att.flash_attention(*xs, causal=causal)
    tout.backward(tg)
    _close(tout, out, dtype)
    for t, want in zip(xs, (dq, dk, dv)):
        _close(t.grad, want, dtype)


def test_kernel_wrappers_on_cpu_tensors_are_the_plain_versions():
    _, (q, k, v, g) = _inputs(3, "float32")
    scale = 0.3
    out, lse = att.flash_fwd(q, k, v, True, scale)
    want = att.flash_fwd_plain(q, k, v, True, scale)
    assert torch.equal(out, want[0]) and torch.equal(lse, want[1])
    delta = att.flash_delta(out, g)
    args = (q, k, v, g, lse, delta, True, scale)
    assert torch.equal(att.flash_bwd_dq(*args), att.flash_bwd_dq_plain(*args))
    for a, b in zip(att.flash_bwd_dkv(*args), att.flash_bwd_dkv_plain(*args)):
        assert torch.equal(a, b)
    for k_ in (att.FLASH_FWD, att.FLASH_BWD_DQ, att.FLASH_BWD_DKV):
        assert k_.launches == 0


@pytest.mark.parametrize("bad", ["odd_d", "wide_d", "dtype", "layout"])
def test_flash_wrappers_refuse_what_the_kernels_do_not_take(bad):
    _, (q, k, v, _) = _inputs(4, "float32")
    if bad == "odd_d":
        q, k, v = (t[..., :15].contiguous() for t in (q, k, v))
    elif bad == "wide_d":
        q, k, v = (torch.cat([t] * 9, -1) for t in (q, k, v))
    elif bad == "dtype":
        v = v.double()
    else:
        q = q.transpose(1, 2)
    with pytest.raises((ValueError, TypeError)):
        att.flash_fwd(q, k, v, True, 0.25)


def test_flash_takes_a_ragged_sequence():
    """S = 50 is not a multiple of any tile: the plain versions (and the
    kernels, on the card) mask the edge; the reference agrees."""
    _, (q, k, v, _) = _inputs(5, "float32", shape=(1, 50, 2, 8))
    out = att.flash_attention(q, k, v, causal=True)
    want = att.attention_reference(q, k, v, causal=True)
    assert _rel(out.numpy(), want.numpy()) <= 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_the_jax_rope(dtype):
    (x,), (tx,) = _inputs(6, dtype, shape=(2, 40, 3, 8), n=1)
    want = np.asarray(jatt.rope(x, 10000.0), np.float32)
    got = att.rope(tx, 10000.0)
    assert got.dtype == tx.dtype
    if dtype == "float32":
        assert _rel(got.numpy(), want) <= 1e-5
    else:
        err = np.abs(got.float().numpy() - want)
        assert (err <= 2.0 ** -8 * np.abs(want) + 1e-6).all(), err.max()


@pytest.mark.parametrize("causal", [True, False])
def test_reference_and_chunked_attention_match_jax(causal):
    (q, k, v, g), (tq, tk, tv, tg) = _inputs(7, "float32",
                                             shape=(2, 70, 2, 8))
    ref = jatt.attention_reference(q, k, v, causal=causal)
    got = att.attention_reference(tq, tk, tv, causal=causal)
    assert _rel(got.numpy(), ref) <= 1e-5
    fn = lambda q_, k_, v_: jatt.chunked_attention(q_, k_, v_, causal=causal,
                                                   block_k=32)
    out, vjp = jax.vjp(fn, q, k, v)
    xs = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    tout = att.chunked_attention(*xs, causal=causal, block_k=32)
    assert _rel(tout.detach().numpy(), out) <= 1e-5
    tout.backward(tg)
    for t, want in zip(xs, vjp(g)):
        assert _rel(t.grad.numpy(), want) <= 1e-5


@pytest.mark.parametrize("S,impl,cuda,want", [
    (64, "auto", False, "ref"), (1024, "auto", False, "chunked"),
    (2048, "auto", True, "flash"), (256, "auto", True, "flash"),
    (1000, "auto", True, "chunked"), (100, "auto", True, "ref"),
    (64, "flash", False, "flash"), (2048, "ref", True, "ref"),
    (64, "chunked", False, "chunked")])
def test_mha_auto_dispatch_is_the_jax_packages(S, impl, cuda, want):
    """JAX: flash on a TPU when attn_block (128) divides S, else the
    reference up to S = 512 and chunked above; the port puts the card in
    the TPU's place (a stand-in object says whether ``q`` is on it)."""
    from cxxnet_tpu_torch.config import parse_config_string
    from cxxnet_tpu_torch.graph import build_graph
    from cxxnet_tpu_torch.layers import create_layer
    cfg = parse_config_string(
        "netconfig = start\nlayer[+1:a] = mha:attn\n  nhead = 2\n"
        f"  attn_impl = {impl}\nnetconfig = end\n")
    layer = create_layer(build_graph(cfg).layers[0], [])
    q = types.SimpleNamespace(shape=(1, S, 2, 8), is_cuda=cuda)
    assert layer.attend_impl(q) == want
