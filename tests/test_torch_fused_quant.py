"""The port's int8 product (``ops/fused_quant.py``) on the CPU against the
JAX package's ``cxxnet_tpu/ops/fused_quant.py``.

The same seeded numpy inputs go through both. The JAX side is compiled
(``jax.jit``), as the JAX engine runs it; at shapes the Pallas kernel
takes it runs that kernel in interpret mode (``pallas_call`` asserted in
the jaxpr). Tolerance: equal int8 activation codes, and outputs within 2
f32 ulp of max|y|. Compiled XLA contracts ``acc * factor + bias`` into
one FMA and computes ``act_scale / 127`` as ``act_scale * (1/127)``;
the port rounds each operation as the program reads (so its kernel and
plain version are bit-equal on the card), which moves an output by one
rounding of |y|.

The quantized fullc, conv (groups, stride, padding, a folded relu) and
seqfc layers are held against the JAX layers from the same inputs.
"""

import jax
import numpy as np
import pytest
import torch

from cxxnet_tpu.config import parse_config_string as jax_parse
from cxxnet_tpu.graph import build_graph as jax_build_graph
from cxxnet_tpu.layers.base import ApplyCtx as JaxCtx
from cxxnet_tpu.model import Network as JaxNetwork
from cxxnet_tpu.ops import fused_quant as J
from cxxnet_tpu.quant import quantize_params as jax_quantize_params
from cxxnet_tpu.quant import quantize_weight as jax_quantize_weight
from cxxnet_tpu_torch.config import parse_config_string
from cxxnet_tpu_torch.convert import params_from_jax
from cxxnet_tpu_torch.graph import build_graph
from cxxnet_tpu_torch.layers import ApplyCtx
from cxxnet_tpu_torch.layers.base import to_nhwc
from cxxnet_tpu_torch.model import Network
from cxxnet_tpu_torch.ops import fused_quant as P
from cxxnet_tpu_torch.ops.fused import KERNELS


def _close(got, want):
    """Within 2 f32 ulp of max|want| (see the module docstring)."""
    tol = 2 * np.spacing(np.float32(np.abs(want).max()))
    err = np.abs(np.asarray(got) - np.asarray(want)).max()
    assert err <= tol, (err, tol)


def _case(m, k, n, seed, with_bias):
    rs = np.random.RandomState(seed)
    x = (rs.randn(m, k) * 1.5).astype(np.float32)
    wq, ws = jax_quantize_weight(rs.randn(k, n).astype(np.float32))
    a = np.float32(np.abs(x).max() * 0.8)       # some codes saturate
    b = rs.randn(n).astype(np.float32) if with_bias else None
    return x, wq, ws, a, b


def _port_matmul(x, wq, ws, a, b, act, fused=True):
    return P.int8_matmul(
        torch.from_numpy(x), P.fullc_weight_for_kernel(torch.from_numpy(wq)),
        torch.from_numpy(ws), torch.tensor(a),
        None if b is None else torch.from_numpy(b), act, fused=fused).numpy()


@pytest.mark.parametrize("act", ["none", "relu"])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("m,k,n", [(64, 256, 256), (32, 384, 512)])
def test_int8_matmul_matches_the_pallas_kernel(m, k, n, with_bias, act):
    """Shapes the TPU kernel takes: the port's plain product against the
    Pallas kernel run in interpret mode."""
    x, wq, ws, a, b = _case(m, k, n, m + k + n, with_bias)

    def ref(x, wq, ws, a, b):
        return J.int8_matmul(x, wq, ws, a, b, act, fused=True,
                             interpret=True)
    assert "pallas_call" in str(jax.make_jaxpr(ref)(x, wq, ws, a, b))
    want = np.asarray(jax.jit(ref)(x, wq, ws, a, b))
    np.testing.assert_array_equal(
        np.asarray(jax.jit(J.quantize_act)(x, a)),
        P.quantize_act(torch.from_numpy(x), torch.tensor(a)).numpy())
    _close(_port_matmul(x, wq, ws, a, b, act), want)


@pytest.mark.parametrize("act", ["none", "relu"])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("m,k,n", [(1, 1024, 1000), (7, 13, 5), (3, 147, 64)])
def test_int8_matmul_matches_jax_where_the_pallas_kernel_refuses(
        m, k, n, with_bias, act):
    """Inception-BN's fc1 at bucket 1, an odd shape, conv1's K: the JAX
    package's jitted jnp route (its Pallas gate refuses these)."""
    x, wq, ws, a, b = _case(m, k, n, m + k + n, with_bias)
    want = np.asarray(jax.jit(lambda *v: J.int8_matmul(*v, act))(
        x, wq, ws, a, b))
    for fused in (True, False):
        _close(_port_matmul(x, wq, ws, a, b, act, fused), want)


@pytest.mark.parametrize("act", ["none", "relu"])
@pytest.mark.parametrize("shape,cout,k,stride,pad,groups", [
    ((2, 9, 9, 6), 8, 3, 1, 1, 1),       # 3x3, same padding
    ((2, 12, 12, 4), 6, 3, 2, 1, 2),     # stride 2, groups 2
    ((1, 27, 27, 3), 8, 11, 4, 0, 1),    # AlexNet's conv1 geometry
    ((2, 7, 7, 8), 4, 1, 1, 0, 1),       # 1x1
    ((2, 10, 10, 4), 8, 5, 1, 2, 2),     # AlexNet's conv2 geometry
    ((1, 5, 6, 4), 4, 3, 2, 1, 2),       # ragged, grouped
    ((2, 23, 23, 3), 8, 7, 2, 3, 1),     # Inception-BN's conv1: K 147
])
def test_int8_conv_matches_jax(shape, cout, k, stride, pad, groups, act):
    rs = np.random.RandomState(sum(shape) + cout + k)
    x = rs.randn(*shape).astype(np.float32)
    wq, ws = jax_quantize_weight(
        rs.randn(k, k, shape[3] // groups, cout).astype(np.float32))
    a = np.float32(np.abs(x).max() * 0.8)
    b = rs.randn(cout).astype(np.float32)
    want = np.asarray(jax.jit(lambda *v: J.int8_conv(
        *v, act, strides=(stride, stride), padding=((pad, pad), (pad, pad)),
        groups=groups))(x, wq, ws, a, b))
    w_oihw = torch.from_numpy(np.ascontiguousarray(wq.transpose(3, 2, 0, 1)))
    for fused in (True, False):
        got = P.int8_conv(
            torch.from_numpy(x), P.conv_weight_for_kernel(w_oihw),
            torch.from_numpy(ws), torch.tensor(a), torch.from_numpy(b), act,
            kernel=(k, k), stride=stride, padding=(pad, pad), groups=groups,
            fused=fused).numpy()
        assert got.shape == want.shape
        _close(got, want)


def test_quantize_act_and_factor_match_jax():
    """Codes round half to even on both sides; the factor is the eager
    JAX program's (compiled XLA multiplies by 1/127, an ulp apart for
    some scales)."""
    rs = np.random.RandomState(1)
    x = (rs.randn(200_000) * 2).astype(np.float32)
    x[:64] = np.arange(-32, 32, dtype=np.float32) * (2.5 / 127)  # .5 ties
    ws = (np.abs(rs.randn(4096)) / 127).astype(np.float32)
    for a in (np.float32(2.5), np.float32(3.7123), np.float32(0.0417)):
        np.testing.assert_array_equal(
            np.asarray(jax.jit(J.quantize_act)(x, a)),
            P.quantize_act(torch.from_numpy(x), torch.tensor(a)).numpy())
        np.testing.assert_array_equal(
            np.asarray(J.dequant_factor(ws, a)),
            P.dequant_factor(torch.from_numpy(ws), torch.tensor(a)).numpy())


def test_plain_product_is_exact_past_two_to_the_24():
    """K 4096 with every code at +-127: |acc| reaches 66 M, past 2^24,
    where int -> f32 rounds; float64 holds the sum exactly and both
    conversions round to nearest."""
    rs = np.random.RandomState(2)
    xq = np.where(rs.rand(5, 4096) < 0.9, 127, -127).astype(np.int8)
    wq = np.where(rs.rand(4096, 3) < 0.9, 127, -127).astype(np.int8)
    factor = rs.rand(3).astype(np.float32)
    acc = xq.astype(np.int64) @ wq.astype(np.int64)
    assert np.abs(acc).max() > 2 ** 24
    got = P.q_mm_plain(torch.from_numpy(xq), torch.from_numpy(wq.T.copy()),
                       torch.from_numpy(factor), None).numpy()
    np.testing.assert_array_equal(
        got, acc.astype(np.int32).astype(np.float32) * factor)


def test_grouped_product_is_each_group_on_its_columns():
    rs = np.random.RandomState(3)
    xq = rs.randint(-127, 128, (6, 2 * 10)).astype(np.int8)
    wt = rs.randint(-127, 128, (2 * 4, 10)).astype(np.int8)
    f = np.ones(8, np.float32)
    got = P.q_mm_plain(torch.from_numpy(xq), torch.from_numpy(wt),
                       torch.from_numpy(f), None, groups=2).numpy()
    for g in range(2):
        want = xq[:, g * 10:(g + 1) * 10].astype(np.int64) \
            @ wt[g * 4:(g + 1) * 4].T.astype(np.int64)
        np.testing.assert_array_equal(got[:, g * 4:(g + 1) * 4], want)


def test_wrappers_refuse_what_the_kernel_does_not_take():
    xq = torch.zeros((4, 8), dtype=torch.int8)
    wt = torch.zeros((3, 8), dtype=torch.int8)
    f = torch.ones(3)
    with pytest.raises(TypeError):
        P.q_mm(xq.float(), wt, f, None)
    with pytest.raises(ValueError, match="act"):
        P.q_mm(xq, wt, f, None, "gelu")
    with pytest.raises(ValueError, match="groups"):
        P.q_mm(xq, wt, f, None, groups=2)
    with pytest.raises(ValueError, match="factor"):
        P.q_mm(xq, wt, torch.ones(4), None)
    with pytest.raises(ValueError, match="no kernel"):
        P.q_mm(xq.to("meta"), wt.to("meta"), f.to("meta"), None)


def test_q_mm_is_a_registered_kernel():
    k = KERNELS["q_mm"]
    assert k.source == "q_mm.cu"
    assert k.replaces == "cxxnet_tpu/ops/fused_quant.py:68"
    src = open(J.__file__).read().splitlines()
    assert src[67].startswith("def _q_mm_kernel")


# -- the quantized layers -----------------------------------------------------

CONV_NET = """
netconfig = start
layer[in->c1] = conv:cv1
  kernel_size = 3
  nchannel = 8
  ngroup = 2
  stride = 2
  pad = 1
layer[c1->c1] = relu:r1
layer[c1->c2] = conv:cv2
  kernel_size = 1
  nchannel = 6
  no_bias = 1
layer[c2->f] = flatten:fl
layer[f->h] = fullc:fc1
  nhidden = 12
layer[h->h] = relu:r2
layer[h->o] = fullc:fc2
  nhidden = 5
netconfig = end
input_shape = 4,9,9
"""

SEQ_NET = """
netconfig = start
layer[in->e] = embed:emb
  nhidden = 16
  vocab_size = 11
layer[e->o] = seqfc:head
  nhidden = 7
netconfig = end
input_shape = 1,1,6
"""


@pytest.mark.parametrize("text,batch", [(CONV_NET, 3), (SEQ_NET, 2)],
                         ids=["conv-fullc", "seqfc"])
@pytest.mark.parametrize("fused_mode", ["auto", "0"])
def test_quantized_layers_match_the_jax_layers(text, batch, fused_mode):
    """Each quantized layer of the net, in the port and in the JAX
    package, from the same input and the same quantized parameters (act
    scales set below each input's abs-max, so some codes saturate), with
    a folded relu where the graph folds one."""
    jcfg = jax_parse(text)
    jnet = JaxNetwork(jax_build_graph(jcfg), jcfg)
    params, _ = jnet.init(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, params)
    names = [s.name for s in jnet.graph.layers
             if s.type in ("conv", "fullc", "seqfc")]
    qparams, _ = jax_quantize_params(params, {n: 0.5 for n in names})
    cfg = parse_config_string(text + f"fused_kernels = {fused_mode}\n")
    net = Network(build_graph(cfg), cfg, device="cpu")
    net.load_weights(*params_from_jax(qparams, {}))
    placed = net.weights_for(torch.float32)
    rs = np.random.RandomState(7)
    for li, spec in enumerate(net.graph.layers):
        if spec.name not in names:
            continue
        x_np = rs.randn(*to_nhwc(net.node_shapes[spec.nindex_in[0]],
                                 batch)).astype(np.float32)
        for act in ("none", "relu"):
            layer = net.layers[li]
            got = layer.forward(placed[spec.name], {}, [torch.from_numpy(
                x_np)], ApplyCtx(compute_dtype=torch.float32,
                                 fused=net.fused, fuse_act=act))[0]
            jlayer = jnet.layers[li]
            want = jax.jit(lambda p, v: jlayer.apply(
                p, {}, [v], JaxCtx(train=False, fuse_act=act))[0][0])(
                qparams[spec.name], x_np)
            assert tuple(got.shape) == tuple(want.shape), spec.name
            _close(got.numpy(), np.asarray(want))
