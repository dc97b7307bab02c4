"""Every layer of the Inception-BN and of the small net of
``test_torch_train.py`` in bfloat16 training mode, in both packages (a
file of its own, so that it runs beside the step comparisons of
``test_torch_train.py`` on another worker).

From the same inputs (the JAX package's bf16 training forward's node
values) and the same seeded upstream gradient in both packages, with the
port casting its f32 masters inside the graph: output, input gradients
and the masters' f32 gradients within a relative L2 difference of 2e-2
(worst reading 6.4e-3), 5e-2 where XLA adds many bf16 terms in bf16 and
the port sums in f32 (readings 3.2e-2 and 2.8e-2). No chaos enters here,
so this holds each layer's bf16 backward and the casts to the precision
of bf16.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cxxnet_tpu.config import parse_config_string as jax_parse
from cxxnet_tpu.graph import build_graph as jax_build_graph
from cxxnet_tpu.model import Network as JaxNetwork
from cxxnet_tpu_torch.config import parse_config_string
from cxxnet_tpu_torch.convert import params_to_jax

from test_torch_train import NETS, _batches, _rel
from torch_ibn_fixture import BATCH


#: bound on the relative L2 difference of each layer's output, input
#: gradients and master gradients in bfloat16 (worst reading 6.4e-3,
#: fc1's dbias: f32 sums in another order)
BF16_LAYER = 2e-2
#: the bound where XLA adds many bf16 terms in bf16 and the port sums in
#: f32 and rounds once: the small net's conv bias gradient (a sum over
#: 1024 rows; reads 3.2e-2) and its 8x8 global average pool through the
#: pooling kernel's function (64 cells; reads 2.8e-2). Summing 1024
#: seeded bf16 values so, the JAX package is 5.5e-2 from the exact sum
#: and the port 1.5e-3.
BF16_LAYER_WIDE_SUMS = {("cv2", "dbias"): 5e-2, ("gap", "out0"): 5e-2}


@functools.lru_cache(maxsize=None)
def _jax_layers(net, fused):
    """The JAX side of :func:`_bf16_layer_rels`: the net's layers in
    bfloat16 training mode (``fused`` decides which activations fold
    into their batch_norm) from the node values of its bf16 training
    forward, each as (layer index, name, inputs, outputs, upstream
    gradients, master gradients, input gradients)."""
    from cxxnet_tpu.layers.base import ApplyCtx as JaxCtx
    from torch_ibn_fixture import jax_run
    text = NETS[net][0] + f"compute_dtype = bfloat16\nfused_kernels = {fused}\n"
    jcfg = jax_parse(text)
    jnet = JaxNetwork(jax_build_graph(jcfg), jcfg)
    p, s = NETS[net][1]()
    b = _batches(net)[0]
    mask = np.ones((BATCH,), np.float32)
    old = os.environ.get("CXXNET_BN_CLAMP_WARN")
    os.environ["CXXNET_BN_CLAMP_WARN"] = "0"    # no host callback
    try:
        nodes = jax_run(lambda p_, s_, x: jnet.apply(
            p_, s_, x, train=True, capture_nodes=True).nodes,
            p, s, jnp.asarray(b.data))
        rs = np.random.RandomState(5)
        g, out = jnet.graph, []
        for li, (spec, jl) in enumerate(zip(g.layers, jnet.layers)):
            if li in jnet._act_folded:
                continue
            name = jl.name
            ins = [nodes[g.node_names[ni]] for ni in spec.nindex_in]
            jctx = JaxCtx(train=True, compute_dtype=jnp.bfloat16,
                          fuse_act=jnet._fuse_act.get(li))

            def fj(lp, xs, _l=jl, _c=jctx, _s=s.get(name, {})):
                outs, _ = _l.apply(lp, _s, list(xs), _c)
                if _l.is_loss:
                    return [_l.loss(outs, jnp.asarray(b.label), mask)]
                return outs
            lp_j = {k: jnp.asarray(v) for k, v in p.get(name, {}).items()}
            outs, vjp = jax.vjp(fj, lp_j, ins)
            dys = [jnp.ones_like(o) if jl.is_loss else
                   jnp.asarray(rs.randn(*o.shape), o.dtype) for o in outs]
            dlp, dxs = vjp(dys)
            out.append((li, name, ins, outs, dys, dlp, dxs))
    finally:
        if old is None:
            del os.environ["CXXNET_BN_CLAMP_WARN"]
        else:
            os.environ["CXXNET_BN_CLAMP_WARN"] = old
    return jnet._act_folded, out


@functools.lru_cache(maxsize=None)
def _bf16_layer_rels(net, fused):
    """Every layer of ``net`` in bfloat16 training mode, in both
    packages, from the same inputs (the node values of the JAX package's
    bf16 training forward from the net's weights, compiled with excess
    precision off) and the same seeded upstream gradient in the layer's
    output dtype; the loss layer's upstream is its loss.
    The port casts its f32 masters inside the graph
    (``Network._cast_tree``), the JAX layer casts them in its apply.
    Returns {(layer, what): relative L2 difference} for ``what`` in
    ``out``, ``dx<i>`` (gradient of input i) and ``d<leaf>`` (gradient
    of an f32 master, which must be f32)."""
    from cxxnet_tpu_torch.convert import params_from_jax
    from cxxnet_tpu_torch.graph import build_graph
    from cxxnet_tpu_torch.layers import ApplyCtx
    from cxxnet_tpu_torch.model import Network
    text = NETS[net][0] + f"compute_dtype = bfloat16\nfused_kernels = {fused}\n"
    cfg = parse_config_string(text + "dev = cpu\n")
    pnet = Network(build_graph(cfg), cfg)
    folded, layers = _jax_layers(net, fused)
    assert pnet._act_folded == folded
    p, s = NETS[net][1]()
    pp, ps = params_from_jax(p, s)
    b = _batches(net)[0]
    mask = np.ones((BATCH,), np.float32)
    rels = {}
    for li, name, ins, outs, dys, dlp, dxs in layers:
        # the port's layer on the same values
        layer = pnet.layers[li]
        lp = {k: v.clone().requires_grad_(True)
              for k, v in pp.get(name, {}).items()}
        xs = [torch.from_numpy(np.array(x, np.float32)).to(
            getattr(torch, str(x.dtype))).requires_grad_(True)
            for x in ins]
        ctx = ApplyCtx(compute_dtype=torch.bfloat16, fused=pnet.fused,
                       fuse_act=pnet._fuse_act.get(li), train=True,
                       state_sink={})
        touts = layer.forward(pnet._cast_tree({name: lp}, torch.bfloat16)
                              .get(name, {}), ps.get(name, {}), xs, ctx)
        if layer.is_loss:
            touts = [layer.loss(touts, torch.from_numpy(b.label),
                                torch.from_numpy(mask))]
        tdys = [torch.from_numpy(np.array(d, np.float32)).to(o.dtype)
                for d, o in zip(dys, touts)]
        grads = torch.autograd.grad(touts, list(lp.values()) + xs, tdys)
        tlp = dict(zip(lp, grads[:len(lp)]))
        assert all(v.dtype == torch.float32 for v in tlp.values())
        tlp, _ = params_to_jax({name: tlp} if tlp else {}, {})
        f32 = lambda a: np.asarray(a, np.float32)
        for i, (o, to) in enumerate(zip(outs, touts)):
            rels[(name, f"out{i}")] = _rel(f32(to.detach().float()),
                                           f32(o))
        for i, (d, td) in enumerate(zip(dxs, grads[len(lp):])):
            rels[(name, f"dx{i}")] = _rel(f32(td.float()), f32(d))
        for k, d in dlp.items():
            rels[(name, f"d{k}")] = _rel(tlp[name][k], f32(d))
    return rels


@pytest.mark.parametrize("fused", ["auto", "0"])
@pytest.mark.parametrize("net", ["small", "ibn"])
def test_bf16_layers_backward_like_the_jax_layers(net, fused):
    """Each layer of the net in bfloat16, from the same inputs and
    upstream gradient as the JAX package's layer: output, input
    gradients and the f32 masters' gradients within BF16_LAYER (or
    BF16_LAYER_WIDE_SUMS)."""
    rels = _bf16_layer_rels(net, fused)
    kinds = {what[:2] for _, what in rels}
    assert kinds == {"ou", "dx", "dw", "db"}, kinds
    masters = {"small": 9, "ibn": 2 * (69 + 69 + 1) - 69}[net]
    assert sum(what[:2] in ("dw", "db") for _, what in rels) == masters
    bad = {k: r for k, r in rels.items()
           if not r <= BF16_LAYER_WIDE_SUMS.get(k, BF16_LAYER)}
    assert not bad, bad


def test_bias_gradient_sums_in_f32_where_xla_adds_in_bf16():
    """Why BF16_LAYER_WIDE_SUMS: the gradient of a bf16 bias over 1024
    rows, against its exact sum."""
    from torch_ibn_fixture import jax_run
    x = jnp.asarray(np.random.RandomState(0).randn(16, 8, 8, 16),
                    jnp.bfloat16)
    exact = np.asarray(x, np.float64).sum((0, 1, 2))
    want = jax_run(lambda b, x_: jax.vjp(
        lambda bb: x_ + bb.astype(jnp.bfloat16), b)[1](x_)[0],
        jnp.zeros((16,), jnp.float32), x)
    tb = torch.zeros(16, requires_grad=True)
    tx = torch.from_numpy(np.array(x, np.float32)).to(torch.bfloat16)
    (tx + tb.to(torch.bfloat16)).backward(tx)
    assert _rel(np.asarray(want, np.float64), exact) > 2e-2
    assert _rel(tb.grad.double().numpy(), exact) < 5e-3
