"""The port's kernel modules against the JAX package's Pallas kernels.

Each plain PyTorch version (the definition of what its CUDA kernel
computes) is held against the JAX kernel it replaces, run in interpret
mode on the CPU. Row counts are multiples of 16 so the JAX gate really
takes the Pallas path, which each case asserts from the jaxpr. The CUDA
kernels themselves are held against these plain versions on the card
by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cxxnet_tpu.ops.fused_epilogue import fused_bias_act as jax_bias_act
from cxxnet_tpu.ops.fused_pool import fused_pool as jax_pool
from cxxnet_tpu_torch.ops import KERNELS
from cxxnet_tpu_torch.ops.fused_epilogue import bias_act_plain, fused_bias_act
from cxxnet_tpu_torch.ops.fused_quant import q_mm, q_mm_plain
from cxxnet_tpu_torch.ops.fused_pool import (fused_pool, kernel_geometry,
                                             pool_fwd_plain)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _to_torch(a, tdt):
    return torch.from_numpy(np.array(a, np.float32)).to(tdt)


def _as_np(t):
    return t.float().numpy()


def _assert_close(got, want, dtype, cells):
    """float32: rtol 1e-6, plus atol ``cells * 2**-23`` for the window
    sum's other order over ``cells`` terms of size ~1 (where it cancels,
    the relative error of the sum is unbounded); bfloat16: at most one
    bf16 ulp (rtol 2**-7), from that order rounding across a bf16
    boundary."""
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=cells * 2.0 ** -23)
    else:
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=0)


# (name, x shape, kh, kw): global windows over 7x7 and 4x4 (16 rows
# each), and 2x2/2 tiles over 8x8 (4 images x 4 window rows = 16 rows).
# The JAX gate takes max windows of at most 16 cells (a backward limit),
# so the 7x7 window is held for sum and avg only.
GEOMS = [("global7", (16, 7, 7, 32), 7, 7), ("global4", (16, 4, 4, 32), 4, 4),
         ("tile", (4, 8, 8, 32), 2, 2)]
REDUCERS = [("max", False), ("sum", False), ("avg", True)]
CASES = [(g, r) for g in GEOMS for r in REDUCERS
         if not (r[0] == "max" and g[2] * g[3] > 16)]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("pre_relu", [False, True])
@pytest.mark.parametrize("geom,red_scale", CASES,
                         ids=[f"{g[0]}-{r[0]}" for g, r in CASES])
def test_pool_plain_matches_jax_kernel(geom, red_scale, pre_relu, dtype):
    _, shape, kh, kw = geom
    reducer, scale_avg = red_scale
    jdt, tdt = DTYPES[dtype]
    red = "max" if reducer == "max" else "sum"
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    xj = jnp.asarray(x).astype(jdt)
    call = lambda a: jax_pool(a, kh, kw, kh, (0, 0), (0, 0), red,
                              scale_avg, pre_relu, interpret=True)
    assert "pallas_call" in str(jax.make_jaxpr(call)(xj))
    want = np.asarray(call(xj).astype(jnp.float32))
    got = pool_fwd_plain(_to_torch(xj.astype(jnp.float32), tdt), kh, kw,
                         red, scale_avg, pre_relu)
    assert got.dtype == tdt
    _assert_close(_as_np(got), want, dtype, kh * kw)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("with_bias,act",
                         [(True, "none"), (True, "relu"), (False, "relu")])
def test_bias_act_plain_matches_jax_kernel(with_bias, act, dtype):
    """One rounding on each side (the f32 add of two dtype values is
    exact before it), so the results are equal."""
    jdt, tdt = DTYPES[dtype]
    rs = np.random.RandomState(2)
    x = rs.randn(2, 4, 4, 24).astype(np.float32)        # 32 rows
    b = rs.randn(24).astype(np.float32) if with_bias else None
    xj = jnp.asarray(x).astype(jdt)
    bj = None if b is None else jnp.asarray(b)
    call = lambda a: jax_bias_act(a, bj, act, interpret=True)
    assert "pallas_call" in str(jax.make_jaxpr(call)(xj))
    want = np.asarray(call(xj).astype(jnp.float32))
    got = bias_act_plain(_to_torch(xj.astype(jnp.float32), tdt),
                         None if b is None else torch.from_numpy(b), act)
    assert got.dtype == tdt
    np.testing.assert_array_equal(_as_np(got), want)


def test_wrappers_take_the_plain_version_on_cpu_and_count_nothing():
    for k in KERNELS.values():
        k.launches = 0
    x = torch.randn(3, 7, 7, 16, dtype=torch.bfloat16)
    np.testing.assert_array_equal(
        _as_np(fused_pool(x, 7, 7, "sum", True, False)),
        _as_np(pool_fwd_plain(x, 7, 7, "sum", True, False)))
    y = torch.randn(5, 10)
    b = torch.randn(10)
    np.testing.assert_array_equal(
        fused_bias_act(y, b, "relu").numpy(),
        bias_act_plain(y, b, "relu").numpy())
    xq = torch.randint(-127, 128, (4, 12), dtype=torch.int8)
    wt = torch.randint(-127, 128, (6, 12), dtype=torch.int8)
    assert torch.equal(q_mm(xq, wt, b[:6], None, "relu"),
                       q_mm_plain(xq, wt, b[:6], None, "relu"))
    from cxxnet_tpu_torch.ops import fused_norm as fn
    mean, rstd = y.mean(0), torch.rsqrt(y.var(0) + 1e-5)
    assert torch.equal(fn.bn_sums(y), fn.bn_sums_plain(y))
    assert torch.equal(fn.bn_norm(y, b, b, mean, rstd, "relu"),
                       fn.bn_norm_plain(y, b, b, mean, rstd, "relu"))
    assert torch.equal(fn.bn_bwd_sums(y, y, None, mean, rstd),
                       fn.bn_bwd_sums_plain(y, y, None, mean, rstd))
    assert torch.equal(fn.bn_bwd_dx(y, y, y, b, mean, rstd, b, b),
                       fn.bn_bwd_dx_plain(y, y, y, b, mean, rstd, b, b))
    from cxxnet_tpu_torch.ops import fused_stem as fs
    u8 = torch.randint(0, 256, (2, 5, 7, 3), dtype=torch.uint8)
    assert torch.equal(fs.fused_decode_normalize(u8, b[:3], 0.5,
                                                 torch.bfloat16),
                       fs.decode_normalize_reference(u8, b[:3], 0.5,
                                                     torch.bfloat16))
    assert {k: v.launches for k, v in KERNELS.items()} == \
        {k: 0 for k in ("pool_fwd", "pool_bwd", "epilogue_fwd",
                        "epilogue_bwd", "bn_fwd", "bn_bwd", "sgd_apply",
                        "adam_apply", "flash_fwd", "flash_bwd_dq",
                        "flash_bwd_dkv", "lrn_fwd", "lrn_bwd",
                        "pool_bwd_max", "q_mm", "bn_sums", "bn_norm",
                        "bn_bwd_sums", "bn_bwd_dx", "stem")}


def test_wrappers_raise_on_what_the_kernels_do_not_take():
    x = torch.randn(2, 7, 7, 4)
    with pytest.raises(ValueError):
        fused_pool(x, 3, 3, "sum", False, False)     # neither tiles nor global
    with pytest.raises(ValueError):
        fused_pool(x, 7, 7, "min", False, False)
    with pytest.raises(ValueError):
        fused_bias_act(x, None, "none")              # nothing to do
    with pytest.raises(ValueError):
        fused_bias_act(x, torch.zeros(5), "none")    # bias width


@pytest.mark.parametrize("h,w,kh,kw,stride,pad,extra,want", [
    (7, 7, 7, 7, 1, (0, 0), (0, 0), True),     # Inception-BN global avg
    (8, 8, 2, 2, 2, (0, 0), (0, 0), True),     # tiling 2x2/2
    (112, 112, 3, 3, 2, (0, 0), (1, 1), False),  # ceil-mode overhang
    (28, 28, 3, 3, 1, (1, 1), (0, 0), False),  # padded 3x3/1
    (9, 9, 2, 2, 2, (0, 0), (0, 0), False),    # does not divide
])
def test_kernel_geometry_routes_as_the_jax_gate(h, w, kh, kw, stride, pad,
                                                extra, want):
    assert kernel_geometry(h, w, kh, kw, stride, pad, extra) is want
