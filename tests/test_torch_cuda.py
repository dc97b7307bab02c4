"""The port's CUDA kernels on the card: each against its plain version,
the wrappers' refusals, and the launch counts.

Every test here needs a CUDA card and skips without one (the CPU test
run counts none of them). On the card, run them without the JAX test
setup:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from chip_smoke import POOL_BWD_EDGES, pool_bwd_case
from cxxnet_tpu_torch.ops.fused import KERNELS
from cxxnet_tpu_torch.ops.fused_epilogue import (bias_act_plain,
                                                 epilogue_bwd_plain,
                                                 fused_bias_act,
                                                 fused_epilogue_bwd)
from cxxnet_tpu_torch.ops.fused import sm_count
from cxxnet_tpu_torch.ops.fused_norm import (bn_act_plain, bn_bwd,
                                             bn_bwd_dx, bn_bwd_dx_plain,
                                             bn_bwd_plain, bn_bwd_sums,
                                             bn_bwd_sums_plain, bn_fwd,
                                             bn_fwd_sums, bn_norm,
                                             bn_norm_plain, bn_sums,
                                             bn_dx_plan, bn_sums_plain,
                                             colsum_vec_depth,
                                             colsum_vec_plan)
from cxxnet_tpu_torch.ops import attention as att
from cxxnet_tpu_torch.ops.fused_optim import (adam_apply_plain,
                                              fused_adam_apply,
                                              fused_sgd_apply, sgd_apply_plain)
from cxxnet_tpu_torch.ops.fused_lrn import (Lrn, _align, fused_lrn_bwd,
                                            fused_lrn_fwd, lrn_bwd_plain,
                                            lrn_plain, lrn_plan)
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


def _equal_or_nan(got, want):
    """Equal (torch.equal: +0 and -0 compare equal), with a NaN wherever
    ``want`` has one."""
    nan = torch.isnan(want)
    return torch.equal(torch.isnan(got), nan) and torch.equal(
        got[~nan], want[~nan])


def _offset(x, elems):
    """A copy of ``x`` starting ``elems`` elements past an aligned base."""
    buf = torch.empty(x.numel() + elems, dtype=x.dtype, device=x.device)
    out = buf[elems:].view(x.shape)
    out.copy_(x)
    return out


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("rows,c,with_bias,act,offset", [
    (256 * 55 * 55, 96, True, "relu", 0),      # AlexNet's cv1
    (256, 4096, True, "relu", 0),               # AlexNet's fc6
    (128 * 109 * 109, 96, True, "none", 0),     # the SPP net's cv1
    (333, 5, True, "relu", 0), (1000, 7, True, "none", 0),
    (37, 1001, True, "relu", 0), (50, 1001, False, "relu", 0),
    (1000, 96, True, "relu", 1), (64, 1000, True, "none", 1)])
def test_epilogue_forward_edges_are_bit_equal_to_plain(dev, dtype, rows, c,
                                                       with_bias, act,
                                                       offset):
    """The channel-group walk at the paths' shapes, C that no 16-byte
    vector divides and x one element (2 or 4 bytes) past a 16-byte
    boundary (the one-element loads): equal to the plain version."""
    x = _randn((rows, c), dtype, dev, seed=rows + c)
    if offset:
        x = _offset(x, offset)
        assert x.data_ptr() % 16 != 0
    b = _randn((c,), torch.float32, dev, seed=3) if with_bias else None
    assert torch.equal(fused_bias_act(x, b, act), bias_act_plain(x, b, act))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("with_bias,act", [(True, "none"), (True, "relu"),
                                           (False, "relu")])
def test_epilogue_forward_keeps_nan_and_signed_zeros(dev, dtype, with_bias,
                                                     act):
    """NaN, +0 and -0 inputs and a bias with -0: NaN where the plain
    version has one, equal elsewhere; without the relu the sign of every
    zero too (the same IEEE add on both sides; with it the kernel's relu
    gives +0 for -0, which torch.equal does not tell apart)."""
    rows, c = 999, 40
    x = _randn((rows, c), dtype, dev, seed=11) * 3
    x.view(-1)[::17] = float("nan")
    x.view(-1)[5::23] = 0.0
    x.view(-1)[7::29] = -0.0
    b = _randn((c,), torch.float32, dev, seed=12) if with_bias else None
    if b is not None:
        b[::3] = -0.0
    got = fused_bias_act(x, b, act)
    want = bias_act_plain(x, b, act)
    assert _equal_or_nan(got, want)
    if act == "none":
        zero = want == 0
        assert torch.equal(got[zero].signbit(), want[zero].signbit())


def test_epilogue_forward_in_slices_is_bit_equal_to_plain(dev, monkeypatch):
    """Rows past EPI_FWD_SLICE elements go in slices of whole rows, one
    kernel launch each (EPI_FWD_SLICE cut to 4096 elements here)."""
    from cxxnet_tpu_torch.ops import fused_epilogue as fe
    monkeypatch.setattr(fe, "EPI_FWD_SLICE", 4096)
    for dtype, c, offset in ((torch.bfloat16, 96, 0), (torch.float32, 7, 0),
                             (torch.float16, 96, 1)):
        x = _randn((1000, c), dtype, dev, seed=c)
        if offset:
            x = _offset(x, offset)
        b = _randn((c,), torch.float32, dev, seed=4)
        assert torch.equal(fused_bias_act(x, b, "relu"),
                           bias_act_plain(x, b, "relu"))


def test_epilogue_forward_refuses_a_plan_the_inputs_do_not_allow(dev):
    from cxxnet_tpu_torch.ops.fused import stream_handle
    from cxxnet_tpu_torch.ops.fused_epilogue import (EPILOGUE_FWD,
                                                     epilogue_fwd_plan)
    x = _randn((100, 96), torch.bfloat16, dev)
    y = torch.empty_like(x)
    b = _randn((96,), torch.float32, dev)
    p = epilogue_fwd_plan(100, 96, 2)
    before = EPILOGUE_FWD.launches
    for args in (
            (x.data_ptr() + 2, y.data_ptr(), *p),          # vec 8, misaligned
            (x.data_ptr(), y.data_ptr(), p.vec, p.lanes, p.blocks - 1,
             p.slice_rows),                                # too few CTAs
            (x.data_ptr(), y.data_ptr(), p.vec, 0, p.blocks, p.slice_rows),
            (x.data_ptr(), y.data_ptr(), p.vec, p.lanes, p.blocks, 0),
            (x.data_ptr(), y.data_ptr(), p.vec, p.lanes, p.blocks,
             (1 << 30) // 96 + 1)):                        # a slice past 2^30
        xp, yp, *plan = args
        with pytest.raises(RuntimeError, match="cudaError"):
            EPILOGUE_FWD.launch(xp, b.data_ptr(), yp, 100, 96, *plan, 1, 1,
                                stream_handle(dev))
    with pytest.raises(RuntimeError, match="cudaError"):      # nothing to do
        EPILOGUE_FWD.launch(x.data_ptr(), None, y.data_ptr(), 100, 96, *p, 1,
                            0, stream_handle(dev))
    assert EPILOGUE_FWD.launches == before


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


def _emulated_fwd_sums(x, two_pass, aligned=True):
    """``bn_fwd``'s (2, C) sums of (n, c) rows in the kernels' order,
    emulated on the host (``tests/torch_colsum_order.py``)."""
    import torch_colsum_order as order
    n, c = x.shape
    plan = colsum_vec_plan(n, c, x.element_size(), aligned,
                           sm_count(x.device))
    xf = x.float().cpu().numpy()
    if two_pass:
        s1, _ = order.colsum_vec_sum(xf, plan, 1)
        s2, _ = order.colsum_vec_sum(order.sqdev_terms(xf, s1, n), plan, 1)
        return s1, s2
    return tuple(order.colsum_vec_sum(t, plan)[0]
                 for t in order.moments_terms(xf))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("two_pass", [False, True])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("n,c", [(128 * 7 * 7, 1024), (1000, 64), (37, 3),
                                 (333, 200)])
def test_bn_kernels_match_plain(dev, dtype, relu, two_pass, n, c):
    """Forward: statistics rtol 1e-4 (f32 sums in another order); y
    within one ulp plus 1e-4 of ``bn_act_plain`` and bit-equal to
    ``bn_norm_plain`` with the kernel's own mean and rstd (also from a
    base one element past a 16-byte boundary, the one-element loads);
    the sums bit-equal to the emulated order; reruns bit-equal; one
    wrapper launch a call. Backward: dgamma and dbeta rtol 1e-3 plus atol
    1e-3 (sums that cancel); dx within one ulp plus 1e-3."""
    from cxxnet_tpu_torch.ops.fused_norm import BN_FWD
    act = "relu" if relu else "none"
    x = _randn((n, c), dtype, dev) * 1.5 + 0.25
    x = x.to(dtype)
    g = _randn((c,), torch.float32, dev, seed=1) * 0.2 + 1.0
    b = _randn((c,), torch.float32, dev, seed=2) * 0.1
    before = BN_FWD.launches
    y, mean, var, rstd = bn_fwd(x, g, b, 1e-5, act, two_pass)
    torch.cuda.synchronize()
    assert BN_FWD.launches == before + 1
    y0, mean0, var0 = bn_act_plain(x, g, b, 1e-5, act, two_pass)
    torch.testing.assert_close(mean, mean0, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(var, var0, rtol=1e-4, atol=1e-5)
    assert y.dtype == dtype and _ulp_ok(y, y0, dtype, 1e-4)
    assert torch.equal(y, bn_norm_plain(x, g, b, mean, rstd, act))
    first = bn_fwd_sums(x, g, b, 1e-5, act, two_pass)
    again = bn_fwd_sums(x, g, b, 1e-5, act, two_pass)
    assert all(_same_bits(p, q) for p, q in zip(first, again))
    assert _same_bits(first[0], y)
    for got, want in zip(first[2].cpu().numpy(),
                         _emulated_fwd_sums(x, two_pass)):
        assert (got.view("u4") == want.view("u4")).all()
    xo = torch.cat([x.new_zeros(1), x.view(-1)])[1:].view(n, c)
    assert xo.data_ptr() % 16 != 0
    yo, mo, vo, ro = bn_fwd(xo, g, b, 1e-5, act, two_pass)
    torch.testing.assert_close(mo, mean0, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(vo, var0, rtol=1e-4, atol=1e-5)
    assert torch.equal(yo, bn_norm_plain(xo, g, b, mo, ro, act))
    dy = _randn((n, c), dtype, dev, seed=3)
    yy = y if relu else None
    dx, dg, db = bn_bwd(x, dy, yy, g, mean, rstd)
    dx0, dg0, db0 = bn_bwd_plain(x, dy, yy, g, mean, rstd)
    torch.testing.assert_close(dg, dg0, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(db, db0, rtol=1e-3, atol=1e-3)
    assert dx.dtype == dtype and _ulp_ok(dx, dx0, dtype, 1e-3)


def _graph_nodes(fn):
    """The nodes of one ``fn()`` (after a warm-up call) captured in a
    CUDA graph, read through the CUDA driver's graph calls: per node its
    type (0: a kernel launch) and, for a kernel, its mangled name."""
    import ctypes

    class KernelParams(ctypes.Structure):       # CUDA_KERNEL_NODE_PARAMS_v2
        _fields_ = [("func", ctypes.c_void_p)] + [
            (f, ctypes.c_uint) for f in ("gx", "gy", "gz", "bx", "by", "bz",
                                         "smem")] + [
            (f, ctypes.c_void_p) for f in ("params", "extra", "kern",
                                           "ctx")]
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    graph = ctypes.c_void_p(g.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    assert cu.cuGraphGetNodes(graph, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)) == 0
    out = []
    for node in nodes:
        node = ctypes.c_void_p(node)
        kind, name = ctypes.c_int(-1), ctypes.c_char_p()
        assert cu.cuGraphNodeGetType(node, ctypes.byref(kind)) == 0
        if kind.value == 0:
            kp = KernelParams()
            assert cu.cuGraphKernelNodeGetParams_v2(node,
                                                    ctypes.byref(kp)) == 0
            if kp.func:
                rc = cu.cuFuncGetName(ctypes.byref(name),
                                      ctypes.c_void_p(kp.func))
            else:
                rc = cu.cuKernelGetName(ctypes.byref(name),
                                        ctypes.c_void_p(kp.kern))
            assert rc == 0
        out.append((kind.value, name.value and name.value.decode()))
    return out


@pytest.mark.parametrize("what,kernels", [("one-pass", 2), ("two-pass", 3),
                                           ("bn_sums", 1)])
@pytest.mark.parametrize("n,c", [(1000, 64), (333, 7)])
def test_bn_fwd_and_bn_sums_device_launches(dev, what, kernels, n, c):
    """``bn_fwd`` launches two device kernels a call one-pass (the
    moments, the normalize) and three two-pass (sum x, sum (x - mean)^2,
    the normalize); ``bn_sums`` one (the moments), on the 16-byte and the
    one-element paths, and nothing else (no memset): the kernel nodes of
    one call captured in a CUDA graph."""
    x = (_randn((n, c), torch.bfloat16, dev) * 1.5 + 0.25).to(torch.bfloat16)
    g = torch.ones(c, device=dev)
    call = {"one-pass": lambda: bn_fwd(x, g, g, 1e-5, "relu"),
            "two-pass": lambda: bn_fwd(x, g, g, 1e-5, "relu", True),
            "bn_sums": lambda: bn_sums(x)}[what]
    nodes = _graph_nodes(call)
    assert [k for k, _ in nodes] == [0] * kernels, nodes
    want = {"one-pass": ("MomentsVec", "bn_fwd_norm_vec"),
            "two-pass": ("MomentsVec", "SqDevVec", "bn_fwd_norm_vec"),
            "bn_sums": ("MomentsVec",)}[what]
    assert all(sum(w in name for _, name in nodes) == 1 for w in want), nodes


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("two_pass", [False, True])
@pytest.mark.parametrize("n,c", [(1000, 64), (333, 7)])
def test_bn_fwd_keeps_a_nan_channel(dev, dtype, two_pass, n, c):
    """One NaN in channel 2: its mean and var are NaN, as
    ``bn_act_plain``'s are; every other channel's statistics and y are
    those of the same rows without the NaN, bit for bit."""
    x = (_randn((n, c), dtype, dev) * 1.5 + 0.25).to(dtype)
    g = _randn((c,), torch.float32, dev, seed=1) * 0.2 + 1.0
    b = _randn((c,), torch.float32, dev, seed=2) * 0.1
    xn = x.clone()
    xn[n // 3, 2] = float("nan")
    y, mean, var, rstd = bn_fwd(xn, g, b, 1e-5, "relu", two_pass)
    y1, mean1, var1, _ = bn_fwd(x, g, b, 1e-5, "relu", two_pass)
    _, pmean, pvar = bn_act_plain(xn, g, b, 1e-5, "relu", two_pass)
    assert bool(pmean[2].isnan()) and bool(pvar[2].isnan())
    assert bool(mean[2].isnan()) and bool(var[2].isnan())
    assert bool(rstd[2].isnan())
    keep = torch.arange(c, device=dev) != 2
    assert _same_bits(mean[keep], mean1[keep])
    assert _same_bits(var[keep], var1[keep])
    assert _same_bits(y[:, keep].contiguous(), y1[:, keep].contiguous())


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
    y equal to the plain version's (the same rounded f32 operations in
    the same order), also from a base one element past a 16-byte
    boundary; dx within 4 f32 ulp of max|plain| in float32 and one ulp
    in bf16/f16."""
    act = "relu" if relu else "none"
    x = (_randn((n, c), dtype, dev) * 1.5 + 0.25).to(dtype)
    g = _randn((c,), torch.float32, dev, seed=1) * 0.2 + 1.0
    b = _randn((c,), torch.float32, dev, seed=2) * 0.1
    from cxxnet_tpu_torch.ops.fused_norm import BN_SUMS
    before = BN_SUMS.launches
    s = bn_sums(x)
    torch.cuda.synchronize()
    assert BN_SUMS.launches == before + 1
    xf = x.float()
    assert s.dtype == torch.float32 and s.shape == (2, c)
    plan = colsum_vec_plan(n, c, x.element_size(), True, sm_count(dev))
    assert _sums_ok(s, xf, xf * xf, colsum_vec_depth(plan, c))
    assert _same_bits(s, bn_sums(x))
    assert _same_bits(s, bn_fwd_sums(x, g, b, 1e-5, act)[2])
    s0 = bn_sums_plain(x)
    mean = s0[0] / n
    rstd = torch.rsqrt(torch.clamp(s0[1] / n - mean * mean, min=0) + 1e-5)
    y = bn_norm(x, g, b, mean, rstd, act)
    y0 = bn_norm_plain(x, g, b, mean, rstd, act)
    assert y.dtype == dtype and torch.equal(y, y0)
    # x one element past a 16-byte boundary: the one-element loads
    xo = torch.cat([x.new_zeros(1), x.view(-1)])[1:].view(n, c)
    assert xo.data_ptr() % 16 != 0
    assert torch.equal(bn_norm(xo, g, b, mean, rstd, act), y0)
    dy = _randn((n, c), dtype, dev, seed=3)
    yy = y if relu else None
    bs = bn_bwd_sums(x, dy, yy, mean, rstd)
    d = dy.float() if yy is None else torch.where(
        yy.float() > 0, dy.float(), torch.zeros_like(dy, dtype=torch.float32))
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


def _same_bits(a, b):
    """Bit for bit (NaN payloads and the sign of zero included)."""
    ints = {4: torch.int32, 2: torch.int16}[a.element_size()]
    return a.dtype == b.dtype and torch.equal(a.view(ints), b.view(ints))


#: the backward's cases: bn_stem1 and a wide layer of Inception-BN at 64
#: images, C 1500, ragged rows 1 and 3 elements past a 16-byte boundary,
#: C 1, 3 and 7 (the one-element loads)
BWD_CASES = [(64 * 112 * 112, 64, 0), (64 * 7 * 7, 1024, 0), (1000, 1500, 0),
             (12345, 64, 1), (12345, 64, 3), (4099, 1, 0), (999, 3, 1),
             (333, 7, 3)]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("n,c,offset", BWD_CASES)
def test_bn_bwd_is_bn_bwd_sums_then_bn_bwd_dx_bit_for_bit(dev, dtype, relu,
                                                          n, c, offset):
    """One launch a call; reruns bit-equal; (dgamma, dbeta) bit-equal to
    ``bn_bwd_sums`` on the same rows and to the emulated order of
    ``tests/torch_colsum_order.py``; dx bit-equal to ``bn_bwd_dx`` given
    dbeta / N and dgamma / N (divided in float64 and rounded once, as the
    kernel's __fdiv_rn), whose dx pass reads y where bn_bwd's reads the
    mask bits. y holds NaNs, which mask as !(y > 0) does."""
    import torch_colsum_order as order
    from cxxnet_tpu_torch.ops.fused_norm import BN_BWD, BN_BWD_DX, BN_BWD_SUMS
    x, dy, y, mean, rstd = _bwd_inputs(n, c, dtype, dev, offset)
    y.view(-1)[::29] = float("nan")
    yy = y if relu else None
    g = _randn((c,), torch.float32, dev, seed=1) * 0.2 + 1.0
    counts = lambda: (BN_BWD.launches, BN_BWD_SUMS.launches,
                      BN_BWD_DX.launches)
    before = counts()
    dx, dg, db = bn_bwd(x, dy, yy, g, mean, rstd)
    torch.cuda.synchronize()
    assert counts() == (before[0] + 1, before[1], before[2])
    again = bn_bwd(x, dy, yy, g, mean, rstd)
    assert all(_same_bits(a, b) for a, b in zip(again, (dx, dg, db)))
    sums = bn_bwd_sums(x, dy, yy, mean, rstd)
    assert _same_bits(db, sums[0]) and _same_bits(dg, sums[1])
    aligned = offset == 0
    plan = colsum_vec_plan(n, c, x.element_size(), aligned, sm_count(dev))
    terms = order.bwd_sums_terms(
        x.float().cpu().numpy(), dy.float().cpu().numpy(),
        None if yy is None else yy.float().cpu().numpy(),
        mean.cpu().numpy(), rstd.cpu().numpy())
    for row, t in zip((db, dg), terms):
        want, _ = order.colsum_vec_sum(t, plan)
        assert (row.cpu().numpy().view("u4") == want.view("u4")).all()
    sbn, sxhn = ((s.double() / n).float() for s in (db, dg))
    assert _same_bits(dx, bn_bwd_dx(x, dy, yy, g, mean, rstd, sbn, sxhn))
    dx0 = bn_bwd_dx_plain(x, dy, yy, g, mean, rstd, sbn, sxhn)
    assert _ulp_ok(dx, dx0, dtype, 4 * 2.0 ** -23 * dx0.float().abs().max()
                   .item())


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("n,c,offset", BWD_CASES)
def test_bn_bwd_dx_matches_plain_on_every_path(dev, dtype, relu, n, c,
                                               offset):
    """The 16-byte and the one-element dx pass against the plain version
    within 4 f32 ulp of max|plain| (bf16/f16 one ulp more), with NaNs in
    y; one launch a call."""
    from cxxnet_tpu_torch.ops.fused_norm import BN_BWD_DX
    x, dy, y, mean, rstd = _bwd_inputs(n, c, dtype, dev, offset)
    y.view(-1)[::29] = float("nan")
    yy = y if relu else None
    g = _randn((c,), torch.float32, dev, seed=1) * 0.2 + 1.0
    plan = bn_dx_plan(n, c, x.element_size(), offset == 0, sm_count(dev))
    vw = 16 // x.element_size()
    assert plan.vec == (vw if offset == 0 and c % vw == 0 else 1)
    s0 = bn_bwd_sums_plain(x, dy, yy, mean, rstd)
    before = BN_BWD_DX.launches
    dx = bn_bwd_dx(x, dy, yy, g, mean, rstd, s0[0] / n, s0[1] / n)
    torch.cuda.synchronize()
    assert BN_BWD_DX.launches == before + 1
    dx0 = bn_bwd_dx_plain(x, dy, yy, g, mean, rstd, s0[0] / n, s0[1] / n)
    tol = 4 * 2.0 ** -23 * dx0.float().abs().max().item()
    assert dx.dtype == dtype and _ulp_ok(dx, dx0, dtype, tol)


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
@pytest.mark.parametrize("kind,shape,k,relu", [
    ("ints", (128, 27, 27, 256), 3, False),    # the SPP net's spp1
    ("ints", (100, 8, 8, 32), 2, True),        # the digits LeNet's pool
    ("ints", (6, 7, 7, 40), 7, False),         # a global 7x7 max (49 cells)
    ("ints", (3, 4, 6, 5), 2, True)] + [
    (kind, shape, k, relu) for kind, shape, k in POOL_BWD_EDGES
    for relu in (False, True)])
def test_max_pool_backward_kernel_is_bit_equal_to_plain(dev, dtype, kind,
                                                        shape, k, relu):
    """Inputs from a few integer values, so that ties abound, and phase
    3's edge cases (chip_smoke.POOL_BWD_EDGES): the first match in
    row-major order takes dy, exactly as the plain version."""
    x, y, dy = pool_bwd_case(3, kind, shape, k, dtype, relu, dev)
    before = KERNELS["pool_bwd_max"].launches
    got = fused_pool_bwd_max(x, y, dy, k, k, relu)
    torch.cuda.synchronize()
    assert KERNELS["pool_bwd_max"].launches == before + 1
    assert torch.equal(got, pool_bwd_max_plain(x, y, dy, k, k, relu))
    if kind == "nonpos" and relu:
        assert not got.any()
    if kind != "nan":                  # y is the forward's own
        xr = x.detach().clone().requires_grad_(True)
        (dx,) = torch.autograd.grad(
            Pool.apply(xr, k, k, "max", False, relu), [xr], dy)
        assert torch.equal(dx, got)


def test_max_pool_backward_refuses_a_plan_the_inputs_do_not_allow(dev):
    from cxxnet_tpu_torch.ops.fused import stream_handle
    from cxxnet_tpu_torch.ops.fused_pool import POOL_BWD_MAX
    x = torch.zeros((2, 6, 6, 16), dtype=torch.bfloat16, device=dev)
    y = torch.zeros((2, 2, 2, 16), dtype=torch.bfloat16, device=dev)
    before = POOL_BWD_MAX.launches
    for vec, ry, bx, base in ((8, 3, 64, 2), (8, 3, 512, 0), (8, 4, 64, 0),
                              (3, 3, 64, 0), (16, 3, 64, 0)):
        with pytest.raises(RuntimeError, match="cudaError"):
            POOL_BWD_MAX.launch(x.data_ptr() + base, y.data_ptr(),
                                y.data_ptr(), x.data_ptr(), 2, 6, 6, 16, 3,
                                3, 1, 0, vec, ry, bx, stream_handle(dev))
    assert POOL_BWD_MAX.launches == before


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


def _lrn_pair(x, dy, nsize, alpha, beta, knorm):
    """(kernel, plain) of y and of dx."""
    return ((fused_lrn_fwd(x, nsize, alpha, beta, knorm),
             lrn_plain(x, nsize, alpha, beta, knorm)),
            (fused_lrn_bwd(x, dy, nsize, alpha, beta, knorm),
             lrn_bwd_plain(x, dy, nsize, alpha, beta, knorm)))


def _same_bits(got, want):
    """Equal, with a NaN wherever the other has one."""
    nan = torch.isnan(want)
    return torch.equal(torch.isnan(got), nan) and torch.equal(
        got[~nan], want[~nan])


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", [(256, 27, 27, 96), (256, 13, 13, 256)],
                         ids=["lrn1", "lrn2"])
def test_lrn_kernels_are_bit_equal_to_plain_at_alexnet(dev, dtype, shape):
    """AlexNet's LRN layers (nsize 5, alpha 1e-4, beta 0.75, knorm 1):
    the 16-byte vectors, whole rows in a block."""
    x = _randn(shape, dtype, dev) * 3
    dy = _randn(shape, dtype, dev, seed=1)
    plan = lrn_plan(x.numel() // shape[-1], shape[-1], x.element_size(), 5)
    assert plan.vec * x.element_size() == 16 and plan.chunk == shape[-1]
    for got, want in _lrn_pair(x, dy, 5, 1e-4, 0.75, 1.0):
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_lrn_misaligned_base_takes_one_channel_a_thread(dev, dtype):
    shape = (8, 5, 5, 96)
    n = 8 * 5 * 5 * 96
    x = (_randn((n + 1,), dtype, dev) * 3)[1:].view(shape)   # offset 1
    dy = _randn(shape, dtype, dev, seed=1)
    assert x.is_contiguous() and x.data_ptr() % 16
    assert lrn_plan(n // 96, 96, x.element_size(), 5,
                    _align(x, dy)).vec == 1
    for got, want in _lrn_pair(x, dy, 5, 0.1, 0.75, 1.0):
        assert torch.equal(got, want)


@pytest.mark.parametrize("nsize", [4, 5])
@pytest.mark.parametrize("dtype,c", [(torch.bfloat16, 4104),
                                     (torch.float16, 8192),
                                     (torch.float32, 2052)], ids=str)
def test_lrn_rows_past_a_block_take_chunks_with_their_halo(dev, dtype, c,
                                                           nsize):
    """C whose row needs more than a block's threads: chunks of
    LRN_MAX_TPR vectors, the last one ragged, over a ragged row count."""
    shape = (1, 1, 7, c)
    x = _randn(shape, dtype, dev) * 3
    dy = _randn(shape, dtype, dev, seed=1)
    plan = lrn_plan(7, c, x.element_size(), nsize)
    assert plan.chunk < c
    for got, want in _lrn_pair(x, dy, nsize, 0.1, 0.75, 1.0):
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_lrn_inf_and_nan_give_the_plain_nan_and_zero(dev, dtype):
    x = _randn((2, 3, 3, 96), dtype, dev) * 3
    x[0, 1, 1, 40], x[1, 2, 0, 7] = float("inf"), float("nan")
    dy = _randn(x.shape, dtype, dev, seed=1)
    (y, y0), (dx, dx0) = _lrn_pair(x, dy, 5, 0.1, 0.75, 1.0)
    assert torch.isnan(y0).any() and (y0 == 0).any()
    assert _same_bits(y, y0) and _same_bits(dx, dx0)


def test_lrn_kernel_refuses_a_plan_the_inputs_do_not_allow(dev):
    from cxxnet_tpu_torch.ops.fused import stream_handle
    from cxxnet_tpu_torch.ops.fused_lrn import LRN_FWD
    x = _randn((4, 5, 5, 96), torch.bfloat16, dev)
    y = torch.empty_like(x)
    plan = lrn_plan(100, 96, 2, 5)
    before = LRN_FWD.launches
    with pytest.raises(RuntimeError, match="cudaError"):
        LRN_FWD.launch(x.data_ptr() + 2, y.data_ptr(), 99, 96, 5, 1,
                       0.02, 1.0, -0.75, plan.vec, plan.rows, plan.chunk,
                       plan.stride, stream_handle(dev))
    with pytest.raises(RuntimeError, match="cudaError"):
        LRN_FWD.launch(x.data_ptr(), y.data_ptr(), 100, 96, 5, 1, 0.02, 1.0,
                       -0.75, plan.vec, plan.rows, plan.chunk,
                       plan.stride - 1, stream_handle(dev))
    assert LRN_FWD.launches == before


def _device_launches(fn, calls=20):
    """The names of the device kernels ``calls`` calls of ``fn`` launch
    (profiler; its trace may lose a few events, never add one)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == DeviceType.CUDA]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("rows,c,with_bias,act", [
    (128, 1000, True, "none"), (37, 333, True, "relu"), (9, 7, False, "relu"),
    (1568, 192, True, "relu"), (55 * 55 * 8, 96, True, "relu"),
    (55 * 55 * 8, 96, False, "relu"), (64, 24, False, "none"),
    (256, 4096, True, "relu"), (512, 4096, True, "relu")])
def test_epilogue_backward_kernel_matches_plain(dev, dtype, rows, c,
                                                with_bias, act):
    """dx equal (a masked copy), and dy itself without the relu; one
    device launch a call (none with neither a bias nor a relu); dbias
    reruns bit-equal and within the order-of-summation bound of the
    float64 column sum (``colsum_vec_depth`` of the plan, one sum a
    channel): at 24,200 rows two float32 orders differ by more than
    1e-5 of the value, so the plain version's sum is no yardstick."""
    from cxxnet_tpu_torch.ops.fused_epilogue import epilogue_bwd_plan
    y = _randn((rows, c), dtype, dev)
    dy = _randn((rows, c), dtype, dev, seed=1)
    dx, db = fused_epilogue_bwd(y, dy, act, with_bias)
    dx0, db0 = epilogue_bwd_plain(y, dy, act, with_bias)
    assert torch.equal(dx, dx0)
    if act == "none":
        assert dx is dy
    launched = _device_launches(lambda: fused_epilogue_bwd(y, dy, act,
                                                           with_bias))
    if act == "none" and not with_bias:
        assert launched == []
    else:                       # one kernel, at most once a call
        assert len(set(launched)) == 1 and 0 < len(launched) <= 20, launched
    if with_bias:
        again = fused_epilogue_bwd(y, dy, act, with_bias)[1]
        assert torch.equal(db.view(torch.int32), again.view(torch.int32))
        plan = epilogue_bwd_plan(rows, c, dy.element_size(), True,
                                 sm_count(dev))
        t = dx0.double()
        bound = colsum_vec_depth(plan, c, sums=1) * 2.0 ** -24 \
            * t.abs().sum(0)
        assert bool(((db.double() - t.sum(0)).abs() <= bound).all())
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
    the kernels' names in the CUDA graph of one backward (a profiler
    session there lost its device events after the file's earlier
    ones)."""
    q, k, v, g = (_randn((1, 256, 2, 16), dtype, dev, seed=i)
                  for i in range(4))
    out, lse = att.flash_fwd(q, k, v, True, 0.25)
    args = (q, k, v, g, lse, att.flash_delta(out, g), True, 0.25)
    seen = [name for kind, name in _graph_nodes(
        lambda: (att.flash_bwd_dq(*args), att.flash_bwd_dkv(*args)))
        if kind == 0]
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


@pytest.mark.parametrize("wd,clip", [(0.0, 0.0), (1e-4, 0.0), (1e-4, 0.5),
                                     (0.0, 0.5)])
@pytest.mark.parametrize("case", ["sizes", "offsets", "lm", "inception_bn"])
def test_adam_apply_edges_are_bit_equal_to_plain(dev, case, wd, clip):
    """Phase 3's Adam edges (``chip_smoke.ADAM_EDGES``: leaves of 1, 3,
    7, 1025, 4097, 5000 and 8193 elements; with ADAM_EDGE_OFFSETS their
    streams 4, 8 or 12 bytes past a 16-byte boundary, together or apart)
    and the LM's and Inception-BN's leaf lists, NaN gradients, clip and wd
    on and off: equal to the plain version."""
    from chip_smoke import (ADAM_EDGE_OFFSETS, ADAM_EDGES, FLAGSHIP, LM_CONF,
                            adam_inputs, adam_shapes)
    shapes, offsets = {
        "sizes": (ADAM_EDGES, None), "offsets": (ADAM_EDGES,
                                                 ADAM_EDGE_OFFSETS),
        "lm": (adam_shapes(LM_CONF), None),
        "inception_bn": (adam_shapes(FLAGSHIP), None)}[case]
    gen = torch.Generator(device=dev).manual_seed(0)
    ws, gs, m1, m2 = adam_inputs(gen, shapes, offsets)
    want = adam_apply_plain(ws, gs, m1, m2, 3e-4, 0.1, 0.001, wd, clip)
    fused_adam_apply(ws, gs, m1, m2, 3e-4, d1=0.1, d2=0.001, wd=wd,
                     clip=clip)
    for a, b in zip(ws + m1 + m2, sum(want, [])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("flag", [0, 1])
@pytest.mark.parametrize("kind", ["sgd", "nag", "adam"])
def test_optimizer_applies_take_the_skip_flag(dev, kind, flag):
    """The loss scaler's skip flag (an int32 on the card): set, the
    kernel and the plain version leave every leaf and moment bit for
    bit as it was, the SGD kernel's launch counted (it reads the flag on
    the card) and the Adam wrapper launching nothing (it reads the flag
    on the host); clear, both compute what they compute without it."""
    shapes = [(64, 3, 7, 7), (64,), (8193,), (1,)]
    ws = [_randn(s, torch.float32, dev, seed=i) for i, s in enumerate(shapes)]
    gs = [_randn(s, torch.float32, dev, seed=10 + i)
          for i, s in enumerate(shapes)]
    gs[0].view(-1)[::5] = float("inf")
    ms = [_randn(s, torch.float32, dev, seed=20 + i).abs() * 0.1
          for i, s in enumerate(shapes)]
    m2 = [m.clone() for m in ms]
    skip = torch.tensor(flag, dtype=torch.int32, device=dev)
    before = [t.clone() for t in ws + ms + m2]
    launches = KERNELS[f"{'adam' if kind == 'adam' else 'sgd'}_apply"]
    n0 = launches.launches
    if kind == "adam":
        want = sum(adam_apply_plain(ws, gs, ms, m2, 3e-4, 0.1, 0.001, 1e-4,
                                    0.0, skip), [])
        fused_adam_apply(ws, gs, ms, m2, 3e-4, d1=0.1, d2=0.001, wd=1e-4,
                         clip=0.0, skip=skip)
        got, equal = ws + ms + m2, True
    else:
        want = sum(sgd_apply_plain(ws, gs, ms, 0.1, 0.9, 1e-4, 0.0,
                                   kind == "nag", skip), [])
        fused_sgd_apply(ws, gs, ms, 0.1, 0.9, wd=1e-4, clip=0.0,
                        nag=kind == "nag", skip=skip)
        got, equal = ws + ms, bool(flag)
    assert launches.launches - n0 == (0 if kind == "adam" and flag else 1)
    for i, (a, b) in enumerate(zip(got, want)):
        if flag:
            assert torch.equal(a, before[i]) and torch.equal(b, before[i])
        elif equal:
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
        else:
            torch.testing.assert_close(a, b, rtol=2.4e-7, atol=1e-7,
                                       equal_nan=True)


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


@pytest.mark.parametrize("out_dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape,mean_kind", [
    ((37, 224, 224, 3), "image"),      # rows no thread's walk divides
    ((1, 224, 224, 3), "image"),
    ((9, 31, 17, 1), "channel"),       # C 1, odd cols
    ((6, 20, 20, 4), "channel"),       # C 4
    ((5, 10, 10, 3), "channel"),       # cols 4 mod 8: lanes cross channels
    ((7, 15, 15, 3), "none")])
def test_stem_kernel_edge_cases_are_bit_equal(dev, out_dtype, shape,
                                              mean_kind):
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randint(0, 256, shape, generator=g, device=dev,
                      dtype=torch.uint8)
    mean = {"none": None,
            "channel": torch.tensor([123.68, 116.78, 103.94, 99.5][
                :shape[-1]], device=dev),
            "image": torch.rand(shape[1:], generator=g, device=dev) * 255
            }[mean_kind]
    got = fs.fused_decode_normalize(x, mean, 1 / 58.0, out_dtype)
    want = fs.decode_normalize_reference(x, mean, 1 / 58.0, out_dtype)
    assert got.dtype == out_dtype and torch.equal(got, want)


def test_stem_kernel_refuses_a_plan_the_inputs_do_not_allow(dev):
    from cxxnet_tpu_torch.ops.fused import stream_handle
    x = torch.zeros((4, 8, 8, 3), dtype=torch.uint8, device=dev)
    y = torch.empty(x.shape, dtype=torch.bfloat16, device=dev)
    mean = torch.zeros(3, device=dev)
    before = fs.STEM.launches
    for vec, bx, by, rows, base, mlen in (
            (8, 256, 1, 16, 4, 3), (16, 256, 1, 16, 0, 3),
            (8, 512, 4, 16, 0, 3), (8, 32, 1, 0, 0, 3),
            (8, 32, 1, 16, 0, 5), (3, 32, 1, 16, 0, 3)):
        with pytest.raises(RuntimeError, match="cudaError"):
            fs.STEM.launch(x.data_ptr() + base, mean.data_ptr(), mlen, 1.0,
                           y.data_ptr(), 4, 192, 1, vec, bx, by, rows,
                           stream_handle(dev))
    assert fs.STEM.launches == before


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


def _narrow_224(tmp_path):
    """Inception-BN at 1/8 of its widths on 224x224 inputs (its i_5b is
    128x7x7, as the flagship's is 1024x7x7), bf16, on the card, with a
    round of numpy-drawn weights and calibrated BN statistics, and a
    pred section of 20 synthetic rows (at batch 8 the last is padded)."""
    import os
    import sys
    from chip_smoke import write_round
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.join(repo, "examples", "ImageNet"))
    from gen_inception_bn import generate
    text = generate(scale=0.125, image_size=224, num_class=10,
                    with_data=False) + "\ndev = gpu\nbatch_size = 8\n"
    conf = tmp_path / "narrow.conf"
    conf.write_text(text)
    model = write_round(str(conf), 3, str(tmp_path), torch.device("cuda"))
    return text + ("pred = pred.txt\niter = synthetic\n  num_inst = 20\n"
                   "  num_class = 10\n  input_shape = 3,224,224\n"
                   "  seed_data = 4\niter = end\n"
                   f"model_in = {model}\n")


def _task(text, tmp_path, name, **over):
    """``main.run`` of ``text`` with ``over``, writing ``name``; returns
    the launches of the run."""
    from cxxnet_tpu_torch.config import parse_config_string
    from cxxnet_tpu_torch.main import run
    from cxxnet_tpu_torch.ops import reset_launches
    over = dict(over, name_pred=str(tmp_path / name))
    reset_launches()
    run(parse_config_string(text + "".join(f"{k} = {v}\n"
                                           for k, v in over.items())))
    torch.cuda.synchronize()
    return {k.name: k.launches for k in KERNELS.values()}


def test_extract_at_a_7x7_node_is_nhwc_rows(dev, tmp_path):
    """``task = extract`` at i_5b (bin) and gap (txt) on the card: the
    .meta sidecars, and each gap row the global average pool (its plain
    version's bf16 definition) of the i_5b row read as NHWC, within one
    bf16 ulp (the kernel's f32 sum may round across one)."""
    import numpy as np
    from chip_smoke import _ulps, gap_of
    text = _narrow_224(tmp_path)
    _task(text, tmp_path, "i5b.bin", task="extract",
          extract_node_name="i_5b", output_format="bin")
    launches = _task(text, tmp_path, "gap.txt", task="extract",
                     extract_node_name="gap")
    assert launches["pool_fwd"] > 0 and launches["epilogue_fwd"] > 0
    assert (tmp_path / "i5b.bin.meta").read_text() == "20,128,7,7\n"
    assert (tmp_path / "gap.txt.meta").read_text() == "20,128,1,1\n"
    i5b = np.fromfile(tmp_path / "i5b.bin", "<f4")
    gap = np.loadtxt(tmp_path / "gap.txt")
    _, want = gap_of(i5b, (128, 7, 7))
    assert gap.shape == want.shape == (20, 128)
    assert _ulps(gap, want) <= 1.0


def test_pred_raw_with_the_kernels_matches_fused_kernels_0(dev, tmp_path):
    """``task = pred_raw`` on the card with the kernels and with
    ``fused_kernels = 0``: finite rows summing to 1 (1e-3), atol 2e-2,
    the same top-1 wherever the margin exceeds 0.05; ``task = pred``'s
    ids are the rows' argmax."""
    import numpy as np
    text = _narrow_224(tmp_path)
    launches = _task(text, tmp_path, "raw.txt", task="pred_raw")
    assert launches["pool_fwd"] >= 3 and launches["epilogue_fwd"] >= 3
    plain = _task(text, tmp_path, "plain.txt", task="pred_raw",
                  fused_kernels=0)
    assert not any(plain.values())
    _task(text, tmp_path, "pred.txt", task="pred")
    got = np.loadtxt(tmp_path / "raw.txt")
    want = np.loadtxt(tmp_path / "plain.txt")
    ids = np.loadtxt(tmp_path / "pred.txt").astype(np.int64)
    assert got.shape == want.shape == (20, 10)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got.sum(1), 1.0, atol=1e-3)
    np.testing.assert_allclose(got, want, atol=2e-2)
    srt = np.sort(want, 1)
    sure = srt[:, -1] - srt[:, -2] > 0.05
    np.testing.assert_array_equal(got.argmax(1)[sure], want.argmax(1)[sure])
    assert all(got[i, j] == got[i].max() for i, j in enumerate(ids))


# -- nvJPEG (the JPEG route on the card) ----------------------------------------

def _nvjpeg_fixture():
    import torch_jpeg_fixture
    return torch_jpeg_fixture


@pytest.mark.parametrize("name", ["gray_37x53", "444_37x53", "422_37x53",
                                  "420_37x53", "420_progressive_41x29",
                                  "420_restart_blocks_40x56",
                                  "444_restart_rows_33x47", "cmyk_24x20",
                                  "ycck_27x33"])
@pytest.mark.parametrize("want", [3, 1])
def test_nvjpeg_is_near_libjpeg_on_the_fixture(dev, name, want):
    """nvJPEG against the stored pixels (libjpeg's; the JAX package's cv2
    conversion of libjpeg's CMYK for the CMYK and YCCK files): Y max |d|
    <= 2, RGB 4:4:4 and CMYK <= 3, 4:2:0, 4:2:2 and YCCK mean |d| <= 1.0
    and max <= 32 (the chroma upsampling); the shape and type exact."""
    import numpy as np
    from cxxnet_tpu_torch.io.decode import decode_image
    jfx = _nvjpeg_fixture()
    got = decode_image(jfx.jpeg(name), want, torch.device("cuda", 0))
    ref = jfx.pixels(name, want)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    d = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    bmax, bmean = jfx.bound_of(name, want)
    assert d.max() <= bmax, (d.max(), d.mean())
    if bmean is not None:
        assert d.mean() <= bmean, (d.max(), d.mean())


def test_nvjpeg_refuses_cmyk_and_is_the_same_on_eight_threads(dev):
    """CMYK and YCCK files go through nvJPEG's four planes (no host
    decode: a broken nvJPEG build raises for them too), and every file
    decodes the same on one thread and on eight."""
    import concurrent.futures as futures
    import numpy as np
    from cxxnet_tpu_torch.io import decode as pdec
    from cxxnet_tpu_torch.io.decode import decode_image
    jfx = _nvjpeg_fixture()
    cuda0 = torch.device("cuda", 0)
    calls = []
    real = pdec.NvJpeg.decode
    try:
        pdec.NvJpeg.decode = lambda self, *a: calls.append(1) or real(
            self, *a)
        decode_image(jfx.jpeg("cmyk_24x20"), 3, cuda0)
        decode_image(jfx.jpeg("ycck_27x33"), 1, cuda0)
    finally:
        pdec.NvJpeg.decode = real
    assert len(calls) == 2
    names = list(jfx.SPECS) * 6
    one = [decode_image(jfx.jpeg(n), 3, cuda0) for n in names]
    with futures.ThreadPoolExecutor(8) as ex:
        many = list(ex.map(lambda n: decode_image(jfx.jpeg(n), 3, cuda0),
                           names))
    assert all(np.array_equal(a, b) for a, b in zip(one, many))


# -- the LM plane (serve/lm) on the card --------------------------------------

LM_TINY = """
netconfig=start
layer[+1:e0] = embed:tok_embed
  nhidden = 32
  vocab_size = 16
layer[+1:n1] = layernorm:ln1
layer[+1:a1] = mha:attn1
  nhead = 4
  causal = 1
  rope = 1
layer[e0,a1->r1] = add:res1
layer[+1:n2] = layernorm:ln2
layer[+1:f1] = ffn:ffn1
  nhidden = 64
layer[r1,f1->r2] = add:res2
layer[+1:lg] = seqfc:lm_head
  nhidden = 16
layer[+0] = lmloss
netconfig=end
input_shape = 1,1,64
compute_dtype = bfloat16
"""


@pytest.mark.parametrize("q_len", [1, 16])
def test_paged_attention_on_the_card_matches_its_f32_result(dev, q_len):
    """bf16 on the card against the same function in f32 on the CPU over
    the same bf16-rounded inputs: within one bf16 ulp of max|f32|; dead
    rows (length 0) uniform, finite."""
    import numpy as np
    from cxxnet_tpu_torch.ops.attention import paged_attention
    rs = np.random.RandomState(0)
    N, bs, H, D, B, T = 33, 16, 8, 16, 4, 8
    g = torch.Generator().manual_seed(0)
    kp, vp = (torch.randn((N, bs, H, D), generator=g).to(torch.bfloat16)
              for _ in range(2))
    q = torch.randn((B, q_len, H, D), generator=g).to(torch.bfloat16)
    tables = torch.from_numpy(rs.permutation(np.arange(1, N))[:B * T]
                              .reshape(B, T))
    lengths = torch.tensor([T * bs, 37, 0, q_len])
    q_pos = (lengths.clamp(min=q_len) - q_len)[:, None] \
        + torch.arange(q_len)[None]
    want = paged_attention(q.float(), kp.float(), vp.float(), tables, q_pos,
                           lengths)
    got = paged_attention(*(t.to(dev) for t in (q, kp, vp, tables, q_pos,
                                                 lengths))).float().cpu()
    assert torch.isfinite(got).all()
    tol = 2.0 ** -7 * float(want.abs().max())
    assert float((got - want).abs().max()) <= tol


def test_lm_scheduler_on_the_card_is_bit_equal_to_generate_whole(dev):
    """A narrow rope LM (random weights) on the card: continuous batching
    (3 rows, 5 prompts) bit-equal to the whole-request path, the pools
    on the card, every block freed, no runner built after warm-up."""
    import numpy as np
    from cxxnet_tpu_torch.config import (parse_config_string,
                                         parse_lm_serve_config)
    from cxxnet_tpu_torch.graph import build_graph
    from cxxnet_tpu_torch.model import Network
    from cxxnet_tpu_torch.serve import InferenceEngine
    from cxxnet_tpu_torch.serve.lm import LMEngine, LMScheduler
    cfg = parse_config_string(LM_TINY)
    net = Network(build_graph(cfg), cfg, device=dev)
    params, state = net.init(torch.Generator(device=dev).manual_seed(0))
    params["tok_embed"]["wmat"] *= 50.0
    net.load_weights(params, state)
    lc = parse_lm_serve_config([
        ("kv_block_size", "4"), ("kv_pool_blocks", "64"),
        ("lm_serve_max_seqs", "3"), ("lm_serve_max_context", "64"),
        ("lm_serve_prefill_chunk", "8")])
    lme = LMEngine(InferenceEngine(net, buckets="1", max_batch=1), lc)
    assert {p[w].device.type for p in lme.pools.values() for w in "kv"} \
        == {dev.type}
    rs = np.random.RandomState(1)
    prompts = [rs.randint(1, 16, size=rs.randint(3, 30)) for _ in range(5)]
    want = [lme.generate_whole(p, max_new=12) for p in prompts]
    warm = lme.compile_info()["misses"]
    sched = LMScheduler(lme, lc)
    sched.start()
    try:
        got = [h.result(timeout=120)["tokens"] for h in
               [sched.submit(p, max_new=12) for p in prompts]]
    finally:
        sched.stop(drain=True)
    assert got == want
    assert lme.block_pool.used == 0
    assert lme.compile_info()["misses"] == warm


# -- the serving fleet on one card ----------------------------------------------

def _int8_pool(tmp_path, n=2):
    """The narrow 224 Inception-BN of :func:`_narrow_224` quantized by the
    port's PTQ over N(0, 1) rows, as ``n`` int8 replicas on the card."""
    from chip_smoke import quantize_served
    from cxxnet_tpu_torch import checkpoint as ckpt
    from cxxnet_tpu_torch.serve import ReplicaPool
    text = _narrow_224(tmp_path)
    conf = tmp_path / "narrow.conf"
    qpath, _ = quantize_served(str(conf), str(tmp_path / "0001.model"), 3,
                               str(tmp_path / "int8.model"), batch=8)
    pool = ReplicaPool.build(text, n, blob=ckpt.load_for_inference(qpath),
                             dtype="int8", buckets="1,8", max_batch=8)
    return pool


def _hammer(fns, reps):
    """Each ``fns[i]`` called ``reps`` times on a thread of its own, all
    at once; the results by thread."""
    import threading
    outs = [[] for _ in fns]
    go = threading.Barrier(len(fns))

    def run(i):
        go.wait()
        for _ in range(reps):
            outs[i].append(fns[i]())
    ts = [threading.Thread(target=run, args=(i,)) for i in range(len(fns))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=300)
    return outs


def test_int8_replicas_on_one_card_are_bit_equal_to_serial(dev, tmp_path):
    """Two int8 replicas on the one card dispatch at once from their own
    threads (the device's default stream, as the fleet leaves it): every
    answer bit-equal to the same request run alone, with q_mm splitting
    K (the shared split_scratch workspace in use)."""
    import numpy as np
    from cxxnet_tpu_torch.ops import reset_launches
    pool = _int8_pool(tmp_path)
    try:
        rs = np.random.RandomState(5)
        reqs = [rs.randn(n, 3 * 224 * 224).astype(np.float32)
                for n in (1, 8, 3, 8)]
        engs = [r.engine for r in pool.replicas]
        assert {e.net.device for e in engs} == {torch.device("cuda", 0)}
        want = [engs[0].predict_raw(x) for x in reqs]
        assert all(np.array_equal(engs[1].predict_raw(x), w)
                   for x, w in zip(reqs, want))
        fq.reset_q_mm_variants()
        reset_launches()
        outs = _hammer([lambda e=e: [e.predict_raw(x) for x in reqs]
                        for e in engs], reps=5)
        assert KERNELS["q_mm"].launches == 70 * 2 * 5 * len(reqs)
        assert any(not v.endswith("x1") for v in fq.Q_MM_VARIANTS)
        for per_thread in outs:
            for got in per_thread:
                assert all(np.array_equal(g, w) for g, w in zip(got, want))
    finally:
        pool.close()


def test_int8_lm_decode_on_two_replicas_is_bit_equal_to_serial(dev):
    """LM_TINY with its head quantized by the port's PTQ, one LM plane per
    replica of an int8 pool on the card: decode steps run at once on both
    give the serial steps' tokens and logits bit for bit, the head through
    q_mm (one launch a step) at 3 rows, K 32, N 16."""
    import numpy as np
    from cxxnet_tpu_torch.config import (parse_config_string,
                                         parse_lm_serve_config,
                                         parse_quant_config)
    from cxxnet_tpu_torch.convert import params_to_jax
    from cxxnet_tpu_torch.graph import build_graph
    from cxxnet_tpu_torch.model import Network
    from cxxnet_tpu_torch.ops import reset_launches
    from cxxnet_tpu_torch.quant import quantize_blob
    from cxxnet_tpu_torch.serve import ReplicaPool
    text = LM_TINY + "compute_dtype = float32\ndev = gpu\n"
    cfg = parse_config_string(text)
    net = Network(build_graph(cfg), cfg, device=dev)
    params, state = net.init(torch.Generator(device=dev).manual_seed(0))
    params["tok_embed"]["wmat"] *= 50.0
    params["lm_head"]["wmat"] *= 1e4
    p_np, s_np = params_to_jax(params, state)
    rs = np.random.RandomState(2)
    calib = [rs.randint(0, 16, (4, 1, 1, 64)).astype(np.float32)]
    qblob, _ = quantize_blob(net, {"params": p_np, "state": s_np,
                                   "meta": {"round": 0}}, calib,
                             parse_quant_config([]))
    lc = parse_lm_serve_config([
        ("kv_block_size", "4"), ("kv_pool_blocks", "64"),
        ("lm_serve_max_seqs", "3"), ("lm_serve_max_context", "64"),
        ("lm_serve_prefill_chunk", "8")])
    pool = ReplicaPool.build(text, 2, blob=qblob, dtype="int8", buckets="1",
                             max_batch=1)
    try:
        pool.attach_lm(lc)
        lmes = [r.lm.engine for r in pool.replicas]
        B, T = lc.max_seqs, lmes[0].T
        tables = np.arange(1, 1 + B * T, dtype=np.int32).reshape(B, T) % 63 + 1
        ids = rs.randint(1, 16, (B, 1)).astype(np.int32)
        pos = np.asarray([[5], [17], [40]], np.int32)
        step = lambda e: [t.cpu().numpy() for t in e.step(
            ids, pos, tables, pos[:, 0] + 1, np.zeros((B,), np.int32))]
        want = step(lmes[0])
        reset_launches()
        outs = _hammer([lambda e=e: step(e) for e in lmes], reps=20)
        assert KERNELS["q_mm"].launches == 2 * 20
        for per_thread in outs:
            for tok, last in per_thread:
                assert np.array_equal(tok, want[0])
                assert np.array_equal(last, want[1])
    finally:
        pool.close()


def test_a_swap_between_dispatches_never_mixes_params_and_state(dev):
    """A bf16 conv-BN net on the card swapped between two rounds (other
    weights, other BN statistics) by one thread while another dispatches:
    every answer is one round's, bit for bit."""
    import threading
    import time
    import numpy as np
    from cxxnet_tpu_torch.config import parse_config_string
    from cxxnet_tpu_torch.convert import params_to_jax
    from cxxnet_tpu_torch.graph import build_graph
    from cxxnet_tpu_torch.model import Network, calibrate_bn
    from cxxnet_tpu_torch.serve import InferenceEngine
    text = """
netconfig=start
layer[+1:c1] = conv:cv1
  kernel_size = 3
  nchannel = 16
  pad = 1
layer[+1:b1] = batch_norm:bn1
layer[+1:r1] = relu
layer[+1:p1] = avg_pooling
  kernel_size = 8
  stride = 8
layer[+1:f1] = flatten
layer[+1:o] = fullc:fc1
  nhidden = 10
layer[+0] = softmax
netconfig=end
input_shape = 3,8,8
compute_dtype = bfloat16
dev = gpu
"""
    cfg = parse_config_string(text)
    rounds = []
    for seed in (1, 2):
        net = Network(build_graph(cfg), cfg, device=dev)
        g = torch.Generator(device=dev).manual_seed(seed)
        p, s = net.init(g)
        net.load_weights(p, s)
        x = torch.randn((16, 8, 8, 3), generator=g, device=dev) * seed
        rounds.append(params_to_jax(p, calibrate_bn(net, x)))
    eng = InferenceEngine(net, buckets="8", max_batch=8)
    x = np.random.RandomState(0).randn(8, 3 * 64).astype(np.float32)
    want = []
    for r, (p, s) in enumerate(rounds):
        eng.swap_weights(p, s, r)
        want.append(eng.predict_raw(x))
    assert np.abs(want[0] - want[1]).max() > 1e-3
    stop, bad, n = threading.Event(), [], [0]

    def swapper():
        r = 0
        while not stop.is_set():
            r ^= 1
            eng.swap_weights(*rounds[r], r)
    t = threading.Thread(target=swapper)
    t.start()
    try:
        t_end = time.time() + 3
        while time.time() < t_end:
            got = eng.predict_raw(x)
            n[0] += 1
            if not any(np.array_equal(got, w) for w in want):
                bad.append(got)
    finally:
        stop.set()
        t.join()
    assert n[0] > 50 and not bad
