"""The int8 product's launch plan and padded operands
(``cxxnet_tpu_torch/ops/fused_quant.py``) on the CPU.

``q_mm_plan`` picks the kernel's row tile and its split of K; the conv
pads K to a multiple of 16 with zero columns in the im2col and in the
laid-out weight. The plan must cover K exactly once, fill the card where
K allows, and the padding must leave every product as it was: the padded
path is held bit-equal to the unpadded one, and against the JAX
package's int8 conv at conv1's K (147) and AlexNet's (363).
"""

import jax
import numpy as np
import pytest
import torch

from cxxnet_tpu.ops import fused_quant as J
from cxxnet_tpu.quant import quantize_weight as jax_quantize_weight
from cxxnet_tpu_torch.config import parse_config_string
from cxxnet_tpu_torch.graph import build_graph
from cxxnet_tpu_torch.model import Network
from cxxnet_tpu_torch.ops import fused_quant as P

#: (M, K, N, groups) of the int8 serve paths (Inception-BN and AlexNet at
#: buckets 1, 8 and 32; conv K padded) and odd shapes
SHAPES = [
    (1, 1024, 1000, 1), (8, 1024, 1000, 1), (32, 1024, 1000, 1),
    (401408, 160, 64, 1), (25088, 576, 64, 1), (49, 1728, 384, 1),
    (96800, 368, 96, 1), (23328, 1200, 128, 2), (1, 9216, 4096, 1),
    (32, 9216, 4096, 1), (32, 4096, 4096, 1), (32, 4096, 1000, 1),
    (8, 4112, 512, 1), (7, 13, 5, 1), (5, 4096, 3, 1), (196, 576, 96, 1),
    (49, 1024, 352, 1), (392, 1024, 128, 1), (3, 1, 1, 1),
]


@pytest.mark.parametrize("m,k,n,g", SHAPES)
def test_plan_covers_every_k_step_exactly_once(m, k, n, g):
    plan = P.q_mm_plan(m, k, n, g)
    steps = -(-k // plan.bk)
    spans = [range(s * plan.kps, min(steps, (s + 1) * plan.kps))
             for s in range(plan.splits)]
    assert all(len(r) > 0 for r in spans)
    covered = [i for r in spans for i in r]
    assert covered == list(range(steps))
    assert plan.bk * steps >= k > plan.bk * (steps - 1)


@pytest.mark.parametrize("m,k,n,g", SHAPES)
@pytest.mark.parametrize("sms", [132, 114, 16])
def test_plan_fills_the_sms_where_k_allows(m, k, n, g, sms):
    plan = P.q_mm_plan(m, k, n, g, sms)
    steps = -(-k // plan.bk)
    assert plan.tiles == -(-m // plan.bm) * -(-n // P.Q_MM_BN) * g
    if plan.tiles >= sms:
        assert plan.splits == 1
    elif min(steps // P.Q_MM_MIN_STEPS,
             P.Q_MM_MAX_SPLITS) * plan.tiles >= sms:
        assert plan.tiles * plan.splits >= sms
    assert plan.splits <= P.Q_MM_MAX_SPLITS
    if plan.splits > 1:
        assert plan.kps >= P.Q_MM_MIN_STEPS
        assert plan.tiles * plan.splits <= 2 * (P.Q_MM_CTAS_PER_SM * sms
                                                + plan.tiles)


@pytest.mark.parametrize("m", [1, 5, 16, 17, 32, 33, 49, 64, 65, 128, 4000])
def test_plan_row_tile_follows_m(m):
    bm = P.q_mm_plan(m, 1024, 1000).bm
    if m <= 32:
        assert bm in (16, 32) and bm >= m
    assert bm == min(t[0] for t in P.Q_MM_TILES if t[0] >= min(m, 128))


@pytest.mark.parametrize("shape,k,stride,pad,groups", [
    ((2, 23, 23, 3), 7, 2, 3, 1),        # Inception-BN's conv1: K 147
    ((1, 27, 27, 3), 11, 4, 0, 1),       # AlexNet's conv1: K 363
    ((2, 10, 10, 4), 5, 1, 2, 2),        # grouped: K 50 a group
    ((2, 6, 6, 16), 1, 1, 0, 1),         # K 16: nothing to pad
])
def test_padded_im2col_is_the_im2col_then_zero_columns(shape, k, stride, pad,
                                                       groups):
    rs = np.random.RandomState(5)
    xq = torch.from_numpy(rs.randint(-127, 128, shape).astype(np.int8))
    kk = k * k * shape[3] // groups
    kp = P.padded_k(kk)
    plain = P.im2col_int8(xq, k, k, stride, (pad, pad), groups)
    padded = P.im2col_int8(xq, k, k, stride, (pad, pad), groups, kp)
    assert kp % 16 == 0 and padded.shape == (plain.shape[0], groups * kp)
    assert padded.is_contiguous()
    pg = padded.view(-1, groups, kp)
    assert torch.equal(pg[..., :kk], plain.view(-1, groups, kk))
    assert not pg[..., kk:].any()
    with pytest.raises(ValueError):
        P.im2col_int8(xq, k, k, stride, (pad, pad), groups, kk - 1)


def test_conv_weight_is_padded_in_a_copy():
    rs = np.random.RandomState(6)
    w = torch.from_numpy(rs.randint(-127, 128, (8, 3, 7, 7)).astype(np.int8))
    before = w.clone()
    wt = P.conv_weight_for_kernel(w)
    assert wt.shape == (8, 160) and wt.is_contiguous()
    assert torch.equal(wt[:, :147], w.permute(0, 2, 3, 1).reshape(8, 147))
    assert not wt[:, 147:].any()
    assert torch.equal(w, before)


@pytest.mark.parametrize("act", ["none", "relu"])
@pytest.mark.parametrize("shape,cout,k,stride,pad,groups", [
    ((2, 23, 23, 3), 8, 7, 2, 3, 1),     # K 147
    ((1, 27, 27, 3), 8, 11, 4, 0, 1),    # K 363
    ((2, 12, 12, 4), 6, 3, 2, 1, 2),     # K 18 a group
])
def test_padded_int8_conv_is_bit_equal_to_unpadded_and_matches_jax(
        shape, cout, k, stride, pad, groups, act):
    """The padded path (plain on the CPU) equals the unpadded product bit
    for bit, and is within 2 f32 ulp of max|y| of the JAX package's int8
    conv (its compiled epilogue is one FMA)."""
    rs = np.random.RandomState(sum(shape) + cout + k)
    x = rs.randn(*shape).astype(np.float32)
    wq, ws = jax_quantize_weight(
        rs.randn(k, k, shape[3] // groups, cout).astype(np.float32))
    a = np.float32(np.abs(x).max() * 0.8)
    b = rs.randn(cout).astype(np.float32)
    w_oihw = torch.from_numpy(np.ascontiguousarray(wq.transpose(3, 2, 0, 1)))
    unpadded = w_oihw.permute(0, 2, 3, 1).reshape(cout, -1).contiguous()
    kw = dict(kernel=(k, k), stride=stride, padding=(pad, pad), groups=groups)
    args = (torch.from_numpy(x),)
    tail = (torch.from_numpy(ws), torch.tensor(a), torch.from_numpy(b), act)
    got = P.int8_conv(*args, P.conv_weight_for_kernel(w_oihw), *tail, **kw)
    ref = P.int8_conv(*args, unpadded, *tail, **kw)
    assert torch.equal(got, ref)
    want = np.asarray(jax.jit(lambda *v: J.int8_conv(
        *v, act, strides=(stride, stride), padding=((pad, pad), (pad, pad)),
        groups=groups))(x, wq, ws, a, b))
    tol = 2 * np.spacing(np.float32(np.abs(want).max()))
    assert np.abs(got.numpy() - want).max() <= tol


def test_the_round_keeps_the_unpadded_weight():
    """Only the forward's laid-out copy is padded: the stored int8 wmat
    keeps its OIHW shape and values."""
    cfg = parse_config_string("""
netconfig = start
layer[in->c] = conv:cv
  kernel_size = 7
  nchannel = 8
  stride = 2
  pad = 3
netconfig = end
input_shape = 3,15,15
""")
    net = Network(build_graph(cfg), cfg, device="cpu")
    rs = np.random.RandomState(8)
    wq = torch.from_numpy(rs.randint(-127, 128, (8, 3, 7, 7)).astype(np.int8))
    params = {"cv": {"wmat": wq.clone(), "bias": torch.zeros(8),
                     "wmat_scale": torch.full((8,), 1e-2),
                     "act_scale": torch.tensor(2.0)}}
    net.load_weights(params, {})
    assert torch.equal(net.params["cv"]["wmat"], wq)
    placed = net.weights_for(torch.float32)["cv"]["wmat"]
    assert placed.shape == (8, 160) and not placed[:, 147:].any()
