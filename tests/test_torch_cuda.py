"""The port's CUDA kernels on the card: each against its plain version,
the wrappers' refusals, and the launch counts.

Every test here needs a CUDA card and skips without one (the CPU test
run counts none of them). On the card, run them without the JAX test
setup:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from cxxnet_tpu_torch.ops.fused import KERNELS
from cxxnet_tpu_torch.ops.fused_epilogue import (bias_act_plain,
                                                 epilogue_bwd_plain,
                                                 fused_bias_act,
                                                 fused_epilogue_bwd)
from cxxnet_tpu_torch.ops.fused import colsum_depth, sm_count
from cxxnet_tpu_torch.ops.fused_norm import (bn_act_plain, bn_bwd,
                                             bn_bwd_dx, bn_bwd_dx_plain,
                                             bn_bwd_plain, bn_bwd_sums,
                                             bn_bwd_sums_plain, bn_fwd,
                                             bn_norm, bn_norm_plain, bn_sums,
                                             bn_sums_plain, colsum_vec_depth,
                                             colsum_vec_plan)
from cxxnet_tpu_torch.ops import attention as att
from cxxnet_tpu_torch.ops.fused_optim import (adam_apply_plain,
                                              fused_adam_apply,
                                              fused_sgd_apply, sgd_apply_plain)
from cxxnet_tpu_torch.ops.fused_lrn import (Lrn, fused_lrn_bwd,
                                            fused_lrn_fwd, lrn_bwd_plain,
                                            lrn_plain)
from cxxnet_tpu_torch.ops import fused_quant as fq
from cxxnet_tpu_torch.ops import fused_stem as fs
from cxxnet_tpu_torch.ops.fused_pool import (Pool, fused_pool,
                                             fused_pool_bwd_lin,
                                             fused_pool_bwd_max,
                                             pool_bwd_lin_plain,
                                             pool_bwd_max_plain,
                                             pool_fwd_plain)

pytestmark = pytest.mark.cuda

DTYPES = [torch.float32, torch.bfloat16, torch.float16]
ULP = {torch.float32: 2.0 ** -20, torch.bfloat16: 2.0 ** -7,
       torch.float16: 2.0 ** -10}


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _randn(shape, dtype, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).to(dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape,kh,kw,red,avg,relu", [
    ((32, 7, 7, 1024), 7, 7, "sum", True, False),   # Inception-BN head
    ((3, 7, 7, 1000), 7, 7, "max", False, True),    # odd batch, C not /8
    ((5, 12, 20, 40), 4, 5, "sum", False, True),    # non-square tiles
    ((1, 2, 2, 1), 2, 2, "max", False, False),
])
def test_pool_kernel_matches_plain(dev, dtype, shape, kh, kw, red, avg, relu):
    """max: equal; sum/avg: within one unit in the last place of the
    dtype (float32 sums in another order may round across one)."""
    x = _randn(shape, dtype, dev)
    got = fused_pool(x, kh, kw, red, avg, relu)
    want = pool_fwd_plain(x, kh, kw, red, avg, relu)
    assert got.dtype == dtype and got.shape == want.shape
    tol = 0.0 if red == "max" else ULP[dtype]
    err = (got.float() - want.float()).abs()
    assert bool((err <= tol * want.float().abs() + 1e-6).all()), err.max()


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape,kh,kw,red,avg,relu", [
    ((1, 7, 7, 1024), 7, 7, "sum", True, False),    # buckets 1, 5, 32
    ((5, 7, 7, 1024), 7, 7, "sum", True, False),
    ((32, 7, 7, 1024), 7, 7, "max", False, False),
    ((100, 8, 8, 32), 2, 2, "max", False, False),   # the digits LeNet
    ((100, 8, 8, 32), 2, 2, "max", False, True),
    ((3, 56, 56, 24), 56, 56, "sum", True, True),   # window rows split 16
])
def test_pool_kernel_at_the_paths_windows_matches_plain(dev, dtype, shape, kh,
                                                        kw, red, avg, relu):
    """The compiled 7x7 and 2x2 windows and a 56x56 one: max equal, sum
    and avg within one ulp of the dtype."""
    x = _randn(shape, dtype, dev, seed=5)
    got = fused_pool(x, kh, kw, red, avg, relu)
    want = pool_fwd_plain(x, kh, kw, red, avg, relu)
    tol = 0.0 if red == "max" else ULP[dtype]
    err = (got.float() - want.float()).abs()
    assert bool((err <= tol * want.float().abs() + 1e-6).all()), err.max()


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("red", ["max", "sum"])
@pytest.mark.parametrize("shape,k", [((4, 7, 7, 64), 7), ((6, 8, 8, 32), 2),
                                     ((2, 9, 9, 12), 3)])
def test_pool_kernel_keeps_a_nan(dev, dtype, red, shape, k):
    """A NaN in a window wins in max and in sum, as in the plain version,
    whether it is a window's first cell or its last; the other windows
    match it (max equal, sum one ulp)."""
    x = _randn(shape, dtype, dev, seed=6)
    x[0, 0, 0, ::2] = float("nan")
    x[1, k - 1, k - 1, 1::3] = float("nan")
    got = fused_pool(x, k, k, red, False, True)
    want = pool_fwd_plain(x, k, k, red, False, True)
    nan = want.isnan()
    assert bool(nan.any()) and bool((~nan).any())
    assert torch.equal(got.isnan(), nan)
    tol = 0.0 if red == "max" else ULP[dtype]
    err = (got.float() - want.float()).abs()[~nan]
    assert bool((err <= tol * want.float().abs()[~nan] + 1e-6).all())


def test_pool_kernel_takes_a_base_past_a_16_byte_boundary(dev):
    """x 2 bytes past a boundary: the one-element loads, one ulp."""
    buf = _randn((2 * 7 * 7 * 1024 + 1,), torch.bfloat16, dev, seed=7)
    x = buf[1:].view(2, 7, 7, 1024)
    assert x.data_ptr() % 16 != 0
    got = fused_pool(x, 7, 7, "sum", True, False)
    want = pool_fwd_plain(x, 7, 7, "sum", True, False)
    err = (got.float() - want.float()).abs()
    assert bool((err <= ULP[torch.bfloat16] * want.float().abs()
                 + 1e-6).all())


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("rows,c,with_bias,act", [
    (32, 1000, True, "none"), (1, 1000, True, "none"),
    (1568, 192, True, "relu"), (7, 3, False, "relu")])
def test_epilogue_kernel_matches_plain(dev, dtype, rows, c, with_bias, act):
    """Equal: both add in float32 and round once."""
    x = _randn((rows, c), dtype, dev)
    b = _randn((c,), torch.float32, dev, seed=1) if with_bias else None
    got = fused_bias_act(x, b, act)
    assert torch.equal(got, bias_act_plain(x, b, act))


def test_each_launch_counts_once(dev):
    for k in KERNELS.values():
        k.launches = 0
    x = _randn((4, 7, 7, 64), torch.bfloat16, dev)
    fused_pool(x, 7, 7, "sum", True, False)
    fused_pool(x, 7, 7, "max", False, False)
    fused_bias_act(x.reshape(-1, 64), None, "relu")
    torch.cuda.synchronize()
    assert {k: v.launches for k, v in KERNELS.items()} == \
        {"pool_fwd": 2, "epilogue_fwd": 1, "pool_bwd": 0, "epilogue_bwd": 0,
         "bn_fwd": 0, "bn_bwd": 0, "sgd_apply": 0, "adam_apply": 0,
         "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
         "lrn_fwd": 0, "lrn_bwd": 0, "pool_bwd_max": 0, "q_mm": 0,
         "bn_sums": 0, "bn_norm": 0, "bn_bwd_sums": 0, "bn_bwd_dx": 0,
         "stem": 0}


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = _randn((2, 8, 8, 16), torch.float32, dev)
    with pytest.raises(ValueError, match="contiguous"):
        fused_pool(x.transpose(1, 2), 2, 2, "max", False, False)
    with pytest.raises(TypeError):
        fused_pool(x.to(torch.float64), 2, 2, "max", False, False)
    with pytest.raises(ValueError):
        fused_pool(x, 3, 3, "sum", False, False)     # neither tiles nor global
    with pytest.raises(ValueError, match="float32"):
        fused_bias_act(x, torch.zeros(16, device=dev, dtype=torch.float16))
    with pytest.raises(ValueError, match="float32"):
        fused_bias_act(x, torch.zeros(16))            # bias on the CPU


def _ulp_ok(got, want, dtype, atol=1e-5):
    """|got - want| within one ulp of ``dtype`` (relative) plus atol: both
    round f32 values whose sums were taken in another order."""
    err = (got.float() - want.float()).abs()
    return bool((err <= ULP[dtype] * want.float().abs() + atol).all())


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("two_pass", [False, True])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("n,c", [(128 * 7 * 7, 1024), (1000, 64), (37, 3),
                                 (333, 200)])
def test_bn_kernels_match_plain(dev, dtype, relu, two_pass, n, c):
    """Forward: statistics rtol 1e-4 (f32 sums in another order); y
    within one ulp plus 1e-4. Backward: dgamma and dbeta rtol 1e-3 plus
    atol 1e-3 (sums that cancel); dx within one ulp plus 1e-3."""
    act = "relu" if relu else "none"
    x = _randn((n, c), dtype, dev) * 1.5 + 0.25
    x = x.to(dtype)
    g = _randn((c,), torch.float32, dev, seed=1) * 0.2 + 1.0
    b = _randn((c,), torch.float32, dev, seed=2) * 0.1
    y, mean, var, rstd = bn_fwd(x, g, b, 1e-5, act, two_pass)
    y0, mean0, var0 = bn_act_plain(x, g, b, 1e-5, act, two_pass)
    torch.testing.assert_close(mean, mean0, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(var, var0, rtol=1e-4, atol=1e-5)
    assert y.dtype == dtype and _ulp_ok(y, y0, dtype, 1e-4)
    dy = _randn((n, c), dtype, dev, seed=3)
    yy = y if relu else None
    dx, dg, db = bn_bwd(x, dy, yy, g, mean, rstd)
    dx0, dg0, db0 = bn_bwd_plain(x, dy, yy, g, mean, rstd)
    torch.testing.assert_close(dg, dg0, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(db, db0, rtol=1e-3, atol=1e-3)
    assert dx.dtype == dtype and _ulp_ok(dx, dx0, dtype, 1e-3)


def _sums_ok(got, terms_a, terms_b, depth):
    """(2, C) f32 column sums against the exact (f64) sums of their f32
    terms: within ``depth`` (the kernel's longest addition chain) times
    2^-24 of the terms' magnitudes."""
    for row, t in zip(got, (terms_a, terms_b)):
        exact = t.double().sum(0)
        bound = depth * 2.0 ** -24 * t.double().abs().sum(0)
        if not bool(((row.double() - exact).abs() <= bound).all()):
            return False
    return True


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("n,c", [(64 * 112 * 112, 64), (64 * 7 * 7, 1024),
                                 (64, 1000), (37, 1), (333, 7), (1000, 1500)])
def test_sync_bn_kernels_match_plain(dev, dtype, relu, n, c):
    """The four data-parallel BN kernels against their plain versions on
    the same inputs: the sums within the summation-order bound of their
    exact value with each kernel's own addition depth (``_sums_ok``);
    y and dx
    within 4 f32 ulp of max|plain| in float32 and one ulp in bf16/f16
    (both compute the same rounded f32 operations)."""
    act = "relu" if relu else "none"
    x = (_randn((n, c), dtype, dev) * 1.5 + 0.25).to(dtype)
    g = _randn((c,), torch.float32, dev, seed=1) * 0.2 + 1.0
    b = _randn((c,), torch.float32, dev, seed=2) * 0.1
    s = bn_sums(x)
    xf = x.float()
    assert s.dtype == torch.float32 and s.shape == (2, c)
    assert _sums_ok(s, xf, xf * xf, colsum_depth(n, c))
    s0 = bn_sums_plain(x)
    mean = s0[0] / n
    rstd = torch.rsqrt(torch.clamp(s0[1] / n - mean * mean, min=0) + 1e-5)
    y = bn_norm(x, g, b, mean, rstd, act)
    y0 = bn_norm_plain(x, g, b, mean, rstd, act)
    tol = 4 * 2.0 ** -23 * y0.float().abs().max().item()
    assert y.dtype == dtype and _ulp_ok(y, y0, dtype, tol)
    dy = _randn((n, c), dtype, dev, seed=3)
    yy = y if relu else None
    bs = bn_bwd_sums(x, dy, yy, mean, rstd)
    d = dy.float() if yy is None else torch.where(
        yy.float() > 0, dy.float(), torch.zeros_like(dy, dtype=torch.float32))
    plan = colsum_vec_plan(n, c, x.element_size(), True, sm_count(dev))
    assert _sums_ok(bs, d, d * ((xf - mean) * rstd),
                    colsum_vec_depth(plan, c))
    bs0 = bn_bwd_sums_plain(x, dy, yy, mean, rstd)
    dx = bn_bwd_dx(x, dy, yy, g, mean, rstd, bs0[0] / n, bs0[1] / n)
    dx0 = bn_bwd_dx_plain(x, dy, yy, g, mean, rstd, bs0[0] / n, bs0[1] / n)
    tol = 4 * 2.0 ** -23 * dx0.float().abs().max().item()
    assert dx.dtype == dtype and _ulp_ok(dx, dx0, dtype, tol)


def _bwd_inputs(n, c, dtype, dev, offset=0):
    """Seeded x, dy, y (n, c) rows, ``offset`` elements past a 16-byte
    boundary, and f32 moments."""
    def rows(seed, scale, shift):
        t = _randn((n * c + offset,), torch.float32, dev, seed) * scale
        return (t + shift).to(dtype)[offset:].view(n, c)
    x, dy, y = rows(11, 1.5, 0.25), rows(12, 1.0, 0.0), rows(13, 1.0, 0.0)
    mean = x.float().mean(0)
    rstd = torch.rsqrt(x.float().var(0, unbiased=False) + 1e-5)
    return x, dy, y, mean, rstd


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("n,c", [(64 * 112 * 112, 64), (64 * 7 * 7, 1024),
                                 (1000, 1500), (333, 7)])
def test_bn_bwd_sums_reruns_bit_equal_and_in_its_emulated_order(dev, dtype,
                                                                n, c):
    """One launch; two runs on the same input agree bit for bit (no
    float atomics), and both equal the emulation of the kernel's order
    of additions (``tests/torch_colsum_order.py``) bit for bit."""
    import torch_colsum_order as order
    from cxxnet_tpu_torch.ops.fused_norm import BN_BWD_SUMS
    x, dy, y, mean, rstd = _bwd_inputs(n, c, dtype, dev)
    before = BN_BWD_SUMS.launches
    a = bn_bwd_sums(x, dy, y, mean, rstd)
    b = bn_bwd_sums(x, dy, y, mean, rstd)
    torch.cuda.synchronize()
    assert BN_BWD_SUMS.launches == before + 2
    assert torch.equal(a, b)
    plan = colsum_vec_plan(n, c, x.element_size(), True, sm_count(dev))
    terms = order.bwd_sums_terms(x.float().cpu().numpy(),
                                 dy.float().cpu().numpy(),
                                 y.float().cpu().numpy(),
                                 mean.cpu().numpy(), rstd.cpu().numpy())
    for row, t in zip(a.cpu().numpy(), terms):
        want, _ = order.colsum_vec_sum(t, plan)
        assert (row.view("u4") == want.view("u4")).all()


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("n,c,offset", [(12345, 64, 1), (12345, 64, 3),
                                        (999, 7, 0), (500, 36, 1),
                                        (4099, 1, 1)])
def test_bn_bwd_sums_narrow_loads_match_plain(dev, dtype, relu, n, c,
                                              offset):
    """Odd C and bases past a 16-byte boundary take the one-element
    loads: within the order-of-summation bound of the exact sums, and
    the plain version's within the same."""
    x, dy, y, mean, rstd = _bwd_inputs(n, c, dtype, dev, offset)
    yy = y if relu else None
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, dy, y))
    plan = colsum_vec_plan(n, c, x.element_size(), aligned, sm_count(dev))
    assert plan.vec == 1 and aligned == (offset == 0)
    got = bn_bwd_sums(x, dy, yy, mean, rstd)
    xf = x.float()
    d = dy.float() if yy is None else torch.where(
        yy.float() > 0, dy.float(), torch.zeros_like(xf))
    assert _sums_ok(got, d, d * ((xf - mean) * rstd),
                    colsum_vec_depth(plan, c))


def test_sync_bn_kernels_launch_once_and_refuse(dev):
    from cxxnet_tpu_torch.ops.fused_norm import BN_NORM, BN_SUMS
    x = _randn((64, 32), torch.bfloat16, dev)
    g = torch.ones(32, device=dev)
    before = (BN_SUMS.launches, BN_NORM.launches)
    s = bn_sums(x)
    bn_norm(x, g, g, s[0], s[1])
    torch.cuda.synchronize()
    assert (BN_SUMS.launches, BN_NORM.launches) == \
        (before[0] + 1, before[1] + 1)
    with pytest.raises(ValueError, match="contiguous"):
        bn_sums(x.t())
    with pytest.raises(ValueError, match="float32"):
        bn_norm(x, g.half(), g, s[0], s[1])
    with pytest.raises(ValueError, match="float32"):
        bn_norm(x, g.cpu(), g, s[0], s[1])
    with pytest.raises(ValueError, match="shape"):
        bn_bwd_dx(x, x, None, g[:8], g, g, g, g)


def test_dp_train_on_two_cards_through_main_run(dev, tmp_path):
    """``dev = gpu:0-1`` through ``main.run``: two ranks over NCCL train
    two rounds of the synthetic MLP and write the rounds, with the round
    lines of the single-card run."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards (NCCL refuses two ranks on one)")
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    lines = {}
    for dev_spec in ("gpu:0", "gpu:0-1"):
        d = tmp_path / dev_spec.replace(":", "_")
        r = subprocess.run(
            [sys.executable, "-m", "cxxnet_tpu_torch.main",
             os.path.join(repo, "examples", "synthetic_mlp.conf"),
             f"dev={dev_spec}", f"model_dir={d}", "num_round=2"],
            cwd=repo, capture_output=True, text=True, timeout=600)
        assert r.returncode == 0, r.stderr[-3000:]
        lines[dev_spec] = [ln.split("]", 1)[1] for ln in
                           r.stdout.splitlines() if ln.startswith("round")]
        assert sorted(os.listdir(d)) == ["0000.model", "0001.model"]
    assert len(lines["gpu:0-1"]) == 2
    assert lines["gpu:0-1"] == lines["gpu:0"]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape,kh,kw,avg", [
    ((128, 7, 7, 1024), 7, 7, True), ((3, 12, 20, 40), 4, 5, False),
    ((5, 2, 2, 17), 2, 2, True)])
def test_pool_backward_kernel_matches_plain(dev, dtype, shape, kh, kw, avg):
    """Equal: one rounding of the same product on both sides."""
    b, h, w, c = shape
    dy = _randn((b, h // kh, w // kw, c), dtype, dev)
    assert torch.equal(fused_pool_bwd_lin(dy, kh, kw, avg),
                       pool_bwd_lin_plain(dy, kh, kw, avg))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape,k,relu", [
    ((128, 27, 27, 256), 3, False),    # the SPP net's spp1
    ((100, 8, 8, 32), 2, True),        # the digits LeNet's pool
    ((6, 7, 7, 40), 7, False),         # a global 7x7 max (49 cells)
    ((3, 4, 6, 5), 2, True)])
def test_max_pool_backward_kernel_is_bit_equal_to_plain(dev, dtype, shape, k,
                                                        relu):
    """Inputs from a few integer values, so that ties abound: the first
    match in row-major order takes dy, exactly as the plain version."""
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randint(-2, 3, shape, generator=g, device=dev).to(dtype)
    y = pool_fwd_plain(x, k, k, "max", False, relu)
    dy = _randn(y.shape, dtype, dev, seed=4)
    got = fused_pool_bwd_max(x, y, dy, k, k, relu)
    assert torch.equal(got, pool_bwd_max_plain(x, y, dy, k, k, relu))
    xr = x.detach().clone().requires_grad_(True)
    (dx,) = torch.autograd.grad(Pool.apply(xr, k, k, "max", False, relu),
                                [xr], dy)
    assert torch.equal(dx, got)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("nsize", [3, 4, 5])
@pytest.mark.parametrize("shape,knorm,beta", [
    ((256, 27, 27, 96), 1.0, 0.75),    # AlexNet's lrn1
    ((256, 13, 13, 256), 1.0, 0.75),   # AlexNet's lrn2
    ((1, 1, 7, 7), 2.0, 0.5), ((1, 1, 3, 1500), 1.0, 0.75),
    ((3, 5, 7, 33), 2.0, 0.75)])
def test_lrn_kernels_match_plain(dev, dtype, nsize, shape, knorm, beta):
    """Within 4 float32 ulp of max|plain| in float32 and one ulp of the
    dtype of the value in bfloat16 and float16 (expf/logf against
    PyTorch's exp/log; the same sums in the same order)."""
    x = _randn(shape, dtype, dev) * 3
    dy = _randn(shape, dtype, dev, seed=1)
    alpha = 1e-4 if shape[0] == 256 else 0.1
    y, y0 = (f(x, nsize, alpha, beta, knorm) for f in (fused_lrn_fwd,
                                                       lrn_plain))
    dx, dx0 = (f(x, dy, nsize, alpha, beta, knorm)
               for f in (fused_lrn_bwd, lrn_bwd_plain))
    for got, want in ((y, y0), (dx, dx0)):
        assert got.dtype == dtype
        err = (got.float() - want.float()).abs()
        if dtype == torch.float32:
            ok = err <= 4 * 2.0 ** -23 * want.abs().max()
        else:
            ok = err <= ULP[dtype] * want.float().abs() + 1e-30
        assert bool(ok.all()), err.max()


def test_lrn_function_launches_each_kernel_once(dev):
    for k in KERNELS.values():
        k.launches = 0
    x = _randn((4, 5, 5, 64), torch.bfloat16, dev).requires_grad_(True)
    y = Lrn.apply(x, 5, 1e-4, 0.75, 1.0)
    y.float().sum().backward()
    torch.cuda.synchronize()
    assert KERNELS["lrn_fwd"].launches == 1
    assert KERNELS["lrn_bwd"].launches == 1


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("rows,c,with_bias,act", [
    (128, 1000, True, "none"), (37, 333, True, "relu"), (9, 7, False, "relu"),
    (1568, 192, True, "relu")])
def test_epilogue_backward_kernel_matches_plain(dev, dtype, rows, c,
                                                with_bias, act):
    """dx equal (a masked copy); dbias rtol 1e-5 (f32 sums in another
    order)."""
    y = _randn((rows, c), dtype, dev)
    dy = _randn((rows, c), dtype, dev, seed=1)
    dx, db = fused_epilogue_bwd(y, dy, act, with_bias)
    dx0, db0 = epilogue_bwd_plain(y, dy, act, with_bias)
    assert torch.equal(dx, dx0)
    if with_bias:
        torch.testing.assert_close(db, db0, rtol=1e-5, atol=1e-5)
    else:
        assert db is None and db0 is None


@pytest.mark.parametrize("nag", [False, True])
@pytest.mark.parametrize("wd,clip", [(0.0, 0.0), (1e-4, 0.0), (1e-4, 0.5)])
def test_sgd_apply_kernel_matches_plain(dev, nag, wd, clip):
    """Within 2 f32 ulp: the same rounded operations in the same order
    (the plain version's tensor ops may be contracted differently)."""
    shapes = [(64, 3, 7, 7), (64,), (8193,), (1000, 1024), (1,)]
    ws = [_randn(s, torch.float32, dev, seed=i) for i, s in enumerate(shapes)]
    gs = [_randn(s, torch.float32, dev, seed=10 + i)
          for i, s in enumerate(shapes)]
    gs[0].view(-1)[::5] = float("nan")
    ms = [_randn(s, torch.float32, dev, seed=20 + i) * 0.1
          for i, s in enumerate(shapes)]
    want_w, want_m = sgd_apply_plain(ws, gs, ms, 0.1, 0.9, wd, clip, nag)
    fused_sgd_apply(ws, gs, ms, 0.1, 0.9, wd=wd, clip=clip, nag=nag)
    for a, b in zip(ws + ms, want_w + want_m):
        torch.testing.assert_close(a, b, rtol=2.4e-7, atol=1e-7)


def _flash_ok(got, want, dtype):
    """float32 within 2e-5 of max|plain| (f32 sums over the keys in
    another order); bfloat16 within one bf16 ulp plus that."""
    err = (got.float() - want.float()).abs()
    rel = ULP[dtype] if dtype != torch.float32 else 0.0
    top = want.float().abs().max()
    return bool((err <= rel * want.float().abs() + 2e-5 * top).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=str)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,D", [(2, 256, 2, 16), (1, 1000, 2, 64),
                                     (1, 77, 3, 128), (2, 130, 1, 6),
                                     (8, 2048, 8, 16)])
def test_flash_kernels_match_plain(dev, dtype, causal, B, S, H, D):
    """Forward, dQ and dK/dV against their plain versions on the same
    inputs, ragged S, a D that is not a multiple of 16 and the
    long-context LM's shape included; lse within 1e-5 of max|lse|."""
    q, k, v, g = (_randn((B, S, H, D), dtype, dev, seed=i) for i in range(4))
    scale = D ** -0.5
    out, lse = att.flash_fwd(q, k, v, causal, scale)
    out0, lse0 = att.flash_fwd_plain(q, k, v, causal, scale)
    assert out.dtype == dtype and _flash_ok(out, out0, dtype)
    assert float((lse - lse0).abs().max()) <= 1e-5 * float(lse0.abs().max())
    delta = att.flash_delta(out0, g)
    args = (q, k, v, g, lse0, delta, causal, scale)
    assert _flash_ok(att.flash_bwd_dq(*args), att.flash_bwd_dq_plain(*args),
                     dtype)
    for a, b in zip(att.flash_bwd_dkv(*args), att.flash_bwd_dkv_plain(*args)):
        assert _flash_ok(a, b, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=str)
@pytest.mark.parametrize("Sq,Sk,D", [(300, 1000, 64), (1000, 300, 16),
                                     (65, 7, 10)])
def test_flash_fwd_kernel_with_other_key_count_matches_plain(dev, dtype, Sq,
                                                             Sk, D):
    """Non-causal attention over more (or fewer) keys than queries."""
    q = _randn((2, Sq, 3, D), dtype, dev, seed=1)
    k, v = (_randn((2, Sk, 3, D), dtype, dev, seed=i) for i in (2, 3))
    out, lse = att.flash_fwd(q, k, v, False, D ** -0.5)
    out0, lse0 = att.flash_fwd_plain(q, k, v, False, D ** -0.5)
    assert out.shape == q.shape and _flash_ok(out, out0, dtype)
    assert float((lse - lse0).abs().max()) <= 1e-5 * float(lse0.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=str)
@pytest.mark.parametrize("Sq,Sk,D", [(300, 1000, 64), (1000, 300, 16),
                                     (65, 7, 10)])
def test_flash_bwd_kernels_with_other_key_count_match_plain(dev, dtype, Sq,
                                                            Sk, D):
    """dQ and dK/dV, non-causal, over more (or fewer) keys than queries;
    D 10 takes the 4-byte copies."""
    q, g = (_randn((2, Sq, 3, D), dtype, dev, seed=i) for i in (1, 4))
    k, v = (_randn((2, Sk, 3, D), dtype, dev, seed=i) for i in (2, 3))
    scale = D ** -0.5
    out0, lse0 = att.flash_fwd_plain(q, k, v, False, scale)
    args = (q, k, v, g, lse0, att.flash_delta(out0, g), False, scale)
    dq = att.flash_bwd_dq(*args)
    assert dq.shape == q.shape
    assert _flash_ok(dq, att.flash_bwd_dq_plain(*args), dtype)
    for a, b in zip(att.flash_bwd_dkv(*args), att.flash_bwd_dkv_plain(*args)):
        assert a.shape == k.shape and _flash_ok(a, b, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=str)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_kernels_rerun_bit_equal(dev, dtype, causal):
    """No atomics: two launches on the same inputs give the same bits."""
    q, k, v, g = (_randn((2, 300, 2, 64), dtype, dev, seed=i)
                  for i in range(4))
    out, lse = att.flash_fwd(q, k, v, causal, 0.125)
    args = (q, k, v, g, lse, att.flash_delta(out, g), causal, 0.125)
    first = [att.flash_bwd_dq(*args), *att.flash_bwd_dkv(*args)]
    second = [att.flash_bwd_dq(*args), *att.flash_bwd_dkv(*args)]
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("dtype,names", [
    (torch.bfloat16, ("flash_bwd_dq_tc", "flash_bwd_dkv_tc")),
    (torch.float16, ("flash_bwd_dq_tc", "flash_bwd_dkv_tc")),
    (torch.float32, ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel"))],
    ids=str)
def test_flash_bwd_runs_the_tensor_core_kernels(dev, dtype, names):
    """bf16 and f16 launch the mma.sync kernels, f32 the CUDA-core ones:
    the device kernels' names in a profile of one backward."""
    from torch.profiler import ProfilerActivity, profile
    q, k, v, g = (_randn((1, 256, 2, 16), dtype, dev, seed=i)
                  for i in range(4))
    out, lse = att.flash_fwd(q, k, v, True, 0.25)
    args = (q, k, v, g, lse, att.flash_delta(out, g), True, 0.25)
    att.flash_bwd_dq(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        att.flash_bwd_dq(*args)
        att.flash_bwd_dkv(*args)
        torch.cuda.synchronize()
    seen = [e.key for e in prof.key_averages()]
    for name in names:
        assert sum(name in s for s in seen) == 1, (name, seen)


def test_flash_attention_launches_each_kernel_once_per_call(dev):
    for k in KERNELS.values():
        k.launches = 0
    q, k, v = (_randn((1, 64, 2, 16), torch.bfloat16, dev, seed=i)
               .requires_grad_(True) for i in range(3))
    att.flash_attention(q, k, v, causal=True).float().sum().backward()
    torch.cuda.synchronize()
    assert [KERNELS[n].launches for n in
            ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")] == [1, 1, 1]
    att.flash_attention(q, k, v, causal=True, fused=False).float().sum() \
        .backward()
    assert KERNELS["flash_fwd"].launches == 1


def test_flash_wrappers_refuse_on_the_card(dev):
    q = _randn((1, 32, 2, 16), torch.float32, dev)
    with pytest.raises(ValueError):
        att.flash_fwd(q[..., :15].contiguous(), q[..., :15].contiguous(),
                      q[..., :15].contiguous(), True, 0.25)
    with pytest.raises(TypeError):
        att.flash_fwd(q.double(), q.double(), q.double(), True, 0.25)
    with pytest.raises(ValueError, match="contiguous"):
        att.flash_fwd(q.transpose(1, 2), q, q, True, 0.25)
    with pytest.raises(TypeError):
        att.flash_fwd(q, q.cpu(), q, True, 0.25)


@pytest.mark.parametrize("wd,clip", [(0.0, 0.0), (1e-4, 0.0), (1e-4, 0.5)])
def test_adam_apply_kernel_is_bit_equal_to_plain(dev, wd, clip):
    """Equal: the same correctly rounded f32 operations in the same order
    on both sides (no FMA contraction, IEEE division and square root)."""
    shapes = [(64, 3, 7, 7), (64,), (8193,), (1000, 1024), (1,)]
    ws = [_randn(s, torch.float32, dev, seed=i) for i, s in enumerate(shapes)]
    gs = [_randn(s, torch.float32, dev, seed=10 + i)
          for i, s in enumerate(shapes)]
    gs[0].view(-1)[::5] = float("nan")
    m1 = [_randn(s, torch.float32, dev, seed=20 + i) * 0.1
          for i, s in enumerate(shapes)]
    m2 = [_randn(s, torch.float32, dev, seed=30 + i).abs() * 0.1
          for i, s in enumerate(shapes)]
    want = adam_apply_plain(ws, gs, m1, m2, 3e-4, 0.1, 0.001, wd, clip)
    fused_adam_apply(ws, gs, m1, m2, 3e-4, d1=0.1, d2=0.001, wd=wd,
                     clip=clip)
    for a, b in zip(ws + m1 + m2, sum(want, [])):
        assert torch.equal(a, b)


def _codes(shape, dev, seed, extreme=False):
    g = torch.Generator(device=dev).manual_seed(seed)
    if extreme:
        return torch.where(torch.rand(shape, generator=g, device=dev) < 0.9,
                           127, -127).to(torch.int8)
    return torch.randint(-127, 128, shape, generator=g, device=dev,
                         dtype=torch.int8)


@pytest.mark.parametrize("act", ["none", "relu"])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("m,k,n,groups,extreme", [
    (1, 1024, 1000, 1, False),      # Inception-BN's fc1, bucket 1
    (32, 9216, 4096, 1, False),     # AlexNet's fc6, bucket 32
    (4000, 147, 64, 1, False),      # conv1 as im2col (K not a multiple of 4)
    (777, 576, 96, 1, False),       # an inception 3x3
    (300, 1200, 128, 2, False),     # AlexNet's grouped conv2
    (7, 13, 5, 1, False),
    (5, 4096, 3, 1, True),          # |acc| past 2^24
    (1, 9216, 4096, 1, False),      # AlexNet's fc6, bucket 1
    (96800, 368, 96, 1, False),     # AlexNet's conv1 as im2col, K padded
    (8, 4112, 512, 1, False),       # K steps the split does not divide
    (49, 1728, 384, 1, False),      # a 7x7 inception conv, bucket 1
    (3, 363, 7, 1, False),          # K 363 unpadded: the 4-byte variant
])
def test_q_mm_kernel_is_bit_equal_to_plain(dev, m, k, n, groups, extreme,
                                           with_bias, act):
    """Equal: an exact int32 sum on both sides (split over K or not),
    then the same two f32 roundings of the epilogue."""
    xq = _codes((m, groups * k), dev, 1, extreme)
    wt = _codes((groups * n, k), dev, 2, extreme)
    f = _randn((groups * n,), torch.float32, dev, seed=3).abs() * 1e-3
    b = _randn((groups * n,), torch.float32, dev, seed=4) \
        if with_bias else None
    got = fq.q_mm(xq, wt, f, b, act, groups)
    want = fq.q_mm_plain(xq, wt, f, b, act, groups)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("shape,cout,k,stride,pad,groups", [
    ((2, 227, 227, 3), 96, 11, 4, 0, 1), ((2, 27, 27, 96), 256, 5, 1, 2, 2),
    ((3, 14, 14, 64), 96, 3, 1, 1, 1), ((1, 7, 9, 16), 8, 3, 2, 1, 2),
    ((2, 224, 224, 3), 64, 7, 2, 3, 1)])
def test_int8_conv_on_the_card_is_bit_equal_to_plain(dev, shape, cout, k,
                                                     stride, pad, groups,
                                                     padded):
    """One launch, equal to the plain product; with the weight's K padded
    to a multiple of 16 (as conv_weight_for_kernel lays it out) the
    launch takes the pipelined variant."""
    x = _randn(shape, torch.float32, dev)
    wt = _codes((cout, k * k * shape[3] // groups), dev, 5)
    if padded:
        kp = fq.padded_k(wt.shape[1])
        wt = torch.cat([wt, wt.new_zeros((cout, kp - wt.shape[1]))], 1)
    ws = _randn((cout,), torch.float32, dev, seed=6).abs() * 1e-2
    a = torch.tensor(2.5, device=dev)
    b = _randn((cout,), torch.float32, dev, seed=7)
    kw = dict(kernel=(k, k), stride=stride, padding=(pad, pad), groups=groups)
    KERNELS["q_mm"].launches = 0
    fq.reset_q_mm_variants()
    got = fq.int8_conv(x, wt, ws, a, b, "relu", fused=True, **kw)
    want = fq.int8_conv(x, wt, ws, a, b, "relu", fused=False, **kw)
    torch.cuda.synchronize()
    assert KERNELS["q_mm"].launches == 1
    assert sum(fq.Q_MM_VARIANTS.values()) == 1
    if padded:
        assert all(v.startswith("pipelined") for v in fq.Q_MM_VARIANTS)
    assert torch.equal(got, want)


def test_q_mm_refuses_what_the_kernel_does_not_take(dev):
    xq = _codes((4, 32), dev, 1)
    wt = _codes((8, 32), dev, 2)
    f = torch.ones(8, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        fq.q_mm(xq, wt.t().contiguous().t(), f, None)
    with pytest.raises(TypeError, match="float32"):
        fq.q_mm(xq, wt, f.half(), None)
    with pytest.raises(ValueError, match="contiguous"):
        fq.q_mm(xq, wt, f.cpu(), None)


@pytest.mark.parametrize("out_dtype", DTYPES, ids=str)
@pytest.mark.parametrize("mean_kind", ["none", "channel", "image"])
@pytest.mark.parametrize("shape", [(128, 224, 224, 3), (5, 17, 13, 3),
                                   (1, 7, 9, 1), (3, 5, 5, 3)])
def test_stem_kernel_is_bit_equal_to_plain(dev, out_dtype, mean_kind, shape):
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randint(0, 256, shape, generator=g, device=dev,
                      dtype=torch.uint8)
    mean = {"none": None,
            "channel": torch.tensor([123.68, 116.78, 103.94][:shape[-1]],
                                    device=dev),
            "image": torch.rand(shape[1:], generator=g, device=dev) * 255
            }[mean_kind]
    before = fs.STEM.launches
    got = fs.fused_decode_normalize(x, mean, 1 / 255.0, out_dtype)
    want = fs.decode_normalize_reference(x, mean, 1 / 255.0, out_dtype)
    torch.cuda.synchronize()
    assert fs.STEM.launches == before + 1
    assert got.dtype == out_dtype and torch.equal(got, want)


@pytest.mark.parametrize("out_dtype", DTYPES, ids=str)
def test_stem_kernel_takes_an_unaligned_batch(dev, out_dtype):
    """A batch that does not start on 16 bytes (rows 1.. of a (B, 5, 7,
    3) batch, 105 bytes a row) takes the kernel's scalar loop."""
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randint(0, 256, (9, 5, 7, 3), generator=g, device=dev,
                      dtype=torch.uint8)[1:]
    assert x.data_ptr() % 16 != 0
    mean = torch.rand((5, 7, 3), generator=g, device=dev) * 255
    assert torch.equal(fs.fused_decode_normalize(x, mean, 0.5, out_dtype),
                       fs.decode_normalize_reference(x, mean, 0.5,
                                                     out_dtype))


def test_stem_wrapper_refuses_what_the_kernel_does_not_take(dev):
    x = torch.zeros((2, 4, 4, 3), dtype=torch.uint8, device=dev)
    with pytest.raises(TypeError, match="uint8"):
        fs.fused_decode_normalize(x.float(), None, 1.0, torch.float32)
    with pytest.raises(TypeError, match="uint8"):
        fs.fused_decode_normalize(x.reshape(2, 48), None, 1.0, torch.float32)
    with pytest.raises(ValueError, match="mean of shape"):
        fs.fused_decode_normalize(x, torch.zeros(4, 4, device=dev), 1.0,
                                  torch.float32)
    with pytest.raises(ValueError, match="float32 on"):
        fs.fused_decode_normalize(x, torch.zeros(3), 1.0, torch.float32)
