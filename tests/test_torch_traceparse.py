"""Per-phase attribution of a ``torch.profiler`` bracket
(``telemetry/traceparse.py``) on the CPU, over device-kernel names an
NVIDIA H100 recorded in one profiled Inception-BN step pair (batch 128,
bf16): cuDNN's, cuBLAS's, PyTorch's and the hand kernels', each cut
to the first characters that the rules read.

* ``classify_op`` puts each name into its phase (conv, bn_act, pool,
  matmul, optim, h2d, other);
* ``attribute_profile`` of a ``trace.json`` written from the names sums
  each phase's device time and launches a step, ignores host events and
  lists the unclassified names;
* ``attribution_fragment`` is the JAX package's function's line, char
  for char, on the same phase totals.
"""

import json

import pytest

from cxxnet_tpu.telemetry.traceparse import \
    attribution_fragment as jax_fragment
from cxxnet_tpu_torch.telemetry.traceparse import (PHASE_ORDER,
                                                   attribute_profile,
                                                   attribution_fragment,
                                                   classify_op)

#: (name as recorded, its Chrome-trace category, phase, launches, device
#: us over the two steps)
CARD = [
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
     "kernel", "conv", 24, 896.2),
    ("sm90_xmma_dgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
     "kernel", "conv", 20, 387.4),
    ("sm90_xmma_wgrad_indexed_implicit_gemm_bf16bf16_bf16f32_f32_nhwck",
     "kernel", "conv", 14, 420.1),
    ("_ZN17cutlass__5x_cudnn6KernelINS_4conv6kernel23ImplicitGemmConv",
     "kernel", "conv", 6, 324.9),
    ("void nhwcAddPaddingKernel<__nv_bfloat16, __nv_bfloat16, float, "
     "true, (cudnnKernelDataType_t)0>", "kernel", "conv", 8, 451.0),
    ("void colsum_vec<MomentsVec<__nv_bfloat16, 8, 2> >", "kernel",
     "bn_act", 138, 1434.5),
    ("void bn_fwd_norm_vec<__nv_bfloat16, 8, true, false>", "kernel",
     "bn_act", 138, 1444.5),
    ("void colsum_vec<BwdSumsVec<__nv_bfloat16, 8, true, true> >", "kernel",
     "bn_act", 138, 3081.6),
    ("void bn_dx_vec<__nv_bfloat16, 8, 2>", "kernel", "bn_act", 138, 2010.6),
    ("void epilogue_fwd_kernel<__nv_bfloat16, 8, true, false>", "kernel",
     "bn_act", 2, 4.0),
    ("void colsum_vec<EpiBwdVec<__nv_bfloat16, 8, false> >", "kernel",
     "bn_act", 2, 4.9),
    ("void pool_fwd_kernel<__nv_bfloat16, 8, 7, 7, false>", "kernel",
     "pool", 2, 10.7),
    ("void pool_bwd_kernel<__nv_bfloat16>", "kernel", "pool", 2, 11.8),
    ("void at::native::(anonymous namespace)::max_pool_forward_nhwc<c10::"
     "BFloat16, int>", "kernel", "pool", 10, 2297.2),
    ("nvjet_tst_192x192_64x3_1x2_h_ssched_bz_coopB_NNN", "kernel",
     "matmul", 32, 454.0),
    ("void cublasLt::splitKreduce_kernel<32, 16, int, float, __nv_bfloat16",
     "kernel", "matmul", 44, 148.0),
    ("void cutlass::Kernel2<cutlass_80_tensorop_s16816gemm_bf16_128x128_64x5"
     "_nt_align8>", "kernel", "matmul", 24, 511.0),
    ("sgd_apply_kernel(long const*, int, int, int, float, float, float, "
     "float, int, int const*)", "kernel", "optim", 4, 180.5),
    ("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", "h2d", 6, 1738.4),
    ("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", "other", 2, 27.4),
    ("Memset (Device)", "gpu_memset", "other", 84, 210.8),
    ("void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_"
     "impl_nocast<at::native::direct_copy_kernel_cuda", "kernel", "other",
     440, 16059.0),
]


@pytest.mark.parametrize("name,cat,phase,n,us", CARD,
                         ids=[f"{c[2]}{i}" for i, c in enumerate(CARD)])
def test_card_kernel_names_classify_into_their_phase(name, cat, phase, n,
                                                     us):
    assert classify_op(name) == phase


def _trace(path, steps=2):
    events = [{"ph": "X", "cat": "cpu_op", "name": "aten::convolution",
               "ts": 0, "dur": 1e6, "pid": 1, "tid": 1}]
    for name, cat, _, n, us in CARD:
        events += [{"ph": "X", "cat": cat, "name": name, "ts": i,
                    "dur": us / n, "pid": 0, "tid": 7} for i in range(n)]
    path.mkdir()
    (path / "trace.json").write_text(json.dumps({"traceEvents": events}))


def test_attribute_profile_sums_each_phase(tmp_path):
    _trace(tmp_path / "prof")
    att = attribute_profile(str(tmp_path / "prof"), steps=2)
    total = sum(us for *_, us in CARD) / 1e3
    assert att["total_op_ms"] == pytest.approx(total / 2)
    for phase in PHASE_ORDER[:-2] + ("h2d", "other"):
        rows = [c for c in CARD if c[2] == phase]
        if not rows:
            assert phase not in att["phases"]
            continue
        ms = sum(us for *_, us in rows) / 1e3
        d = att["phases"][phase]
        assert d["ms"] == pytest.approx(ms / 2)
        assert d["pct"] == pytest.approx(100 * ms / total)
        assert d["count"] == sum(n for *_, n, _ in rows)
    assert att["top_other"][0][0].startswith("void at::native::elementwise")
    assert att["measured_bytes_per_step"] is None
    with pytest.raises(FileNotFoundError):
        attribute_profile(str(tmp_path / "none"))


def test_fragment_is_the_jax_line(tmp_path):
    _trace(tmp_path / "prof")
    att = attribute_profile(str(tmp_path / "prof"), steps=2)
    got = attribution_fragment(att)
    assert got == jax_fragment(att)
    assert got.startswith("profile[conv:") and " bn_act:" in got \
        and " pool:" in got and " optim:" in got and got.endswith("%)]")
    assert attribution_fragment({"phases": {}}) == \
        jax_fragment({"phases": {}}) == ""
    with_bytes = dict(att, measured_bytes_per_step=3.5e9)
    assert attribution_fragment(with_bytes) == jax_fragment(with_bytes)
