"""The port's sequence layers (``cxxnet_tpu_torch/layers/seq.py``) against
the JAX package's (``cxxnet_tpu/layers/seq.py``), layer by layer.

A narrow causal LM of every sequence layer (embed, posembed, layernorm,
mha with rope, add, ffn, seqfc, lmloss; width 32, 2 heads of 16, 32
tokens, vocabulary 16, batch 4) gets the JAX package's init with every
leaf moved by seeded noise (so biases and gamma are not 0 and 1), in
both packages. Each layer runs in training mode from the same inputs
(the node values of the JAX package's training forward, compiled with
excess precision off) and the same seeded upstream gradient in the
layer's output dtype, the loss layer's upstream being its loss. Held:
the outputs, the gradients of the float inputs, and the gradients of
every f32 master, which must come out f32 and in the JAX tree's nested
layout (``attn1/q/wmat``), each as a relative L2 difference:

* float32: 1e-5 (the same math in another summation order; worst
  reading 4.9e-7);
* bfloat16: 2e-2 (both round activations at the same places; sums in
  another order round across a bf16 ulp; worst reading 4.6e-3), and
  5e-2 for the biases' gradients, which XLA adds over the batch's 128
  positions in bf16 where the port sums in f32 (readings up to 2.2e-2,
  ``lm_head/bias``; ``test_torch_train.py``'s ``test_bias_gradient_
  sums_in_f32_where_xla_adds_in_bf16`` shows the same for a conv bias).
  ``tok_embed/wmat``'s
  gradient, which both scatter-add in bf16, reads under 4.6e-3.

mha runs each attention: ``flash`` (JAX: the Pallas kernels in
interpret mode; the port: the kernel wrappers on CPU tensors, i.e. the
plain versions), ``ref`` and ``chunked``; the ffn both activations
(gelu is the tanh form in both).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cxxnet_tpu.config import parse_config_string as jax_parse
from cxxnet_tpu.graph import build_graph as jax_build_graph
from cxxnet_tpu.layers.base import ApplyCtx as JaxCtx
from cxxnet_tpu.model import Network as JaxNetwork
from cxxnet_tpu_torch.config import parse_config_string
from cxxnet_tpu_torch.convert import params_from_jax
from cxxnet_tpu_torch.graph import build_graph
from cxxnet_tpu_torch.layers import ApplyCtx
from cxxnet_tpu_torch.model import Network
from cxxnet_tpu_torch.optim import leaves, unflatten

from torch_ibn_fixture import jax_run

BATCH, SEQ, VOCAB = 4, 32, 16

NET = """
netconfig = start
layer[+1:e0] = embed:tok_embed
  nhidden = 32
  vocab_size = {vocab}
  random_type = gaussian
  init_sigma = 0.02
layer[+1:p0] = posembed:pos
  init_sigma = 0.02
layer[+1:n1] = layernorm:ln1
layer[+1:a1] = mha:attn1
  nhead = 2
  causal = {causal}
  rope = 1
  attn_impl = {impl}
  attn_block = 16
layer[p0,a1->r1] = add:res1
layer[+1:n2] = layernorm:ln2
layer[+1:f1] = ffn:ffn1
  nhidden = 64
  act = {act}
layer[r1,f1->r2] = add:res2
layer[+1:nf] = layernorm:lnf
layer[+1:lg] = seqfc:lm_head
  nhidden = {vocab}
layer[+0] = lmloss
netconfig = end
input_shape = 1,1,{seq}
label_vec[0,{seq}) = label
batch_size = {batch}
compute_dtype = {dtype}
"""

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
BF16_BIAS_SUMS = 5e-2


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _paths(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_paths(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _layer_rels(dtype, impl="flash", act="gelu", causal=1):
    text = NET.format(vocab=VOCAB, seq=SEQ, batch=BATCH, dtype=dtype,
                      impl=impl, act=act, causal=causal)
    jcfg = jax_parse(text)
    jnet = JaxNetwork(jax_build_graph(jcfg), jcfg)
    cfg = parse_config_string(text + "dev = cpu\n")
    pnet = Network(build_graph(cfg), cfg)
    params, state = jnet.init(jax.random.PRNGKey(0))
    rs = np.random.RandomState(3)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + 0.05 * rs.randn(*a.shape).astype(np.float32), params)
    pp, _ = params_from_jax(params, {})
    data = rs.randint(0, VOCAB, (BATCH, 1, 1, SEQ)).astype(np.float32)
    label = rs.randint(0, VOCAB, (BATCH, SEQ)).astype(np.float32)
    mask = np.ones((BATCH,), np.float32)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = getattr(torch, dtype)
    nodes = jax_run(lambda p_, x: jnet.apply(
        p_, {}, x, train=True, capture_nodes=True).nodes,
        params, jnp.asarray(data))
    g, rels = jnet.graph, {}
    for li, (spec, jl) in enumerate(zip(g.layers, jnet.layers)):
        name = jl.name
        ins = [nodes[g.node_names[ni]] for ni in spec.nindex_in]
        jctx = JaxCtx(train=True, compute_dtype=jdt)

        def fj(lp, xs, _l=jl, _c=jctx):
            outs, _ = _l.apply(lp, {}, list(xs), _c)
            if _l.is_loss:
                return [_l.loss(outs, jnp.asarray(label), mask)]
            return outs
        lp_j = jax.tree_util.tree_map(jnp.asarray, params.get(name, {}))
        outs, vjp = jax.vjp(fj, lp_j, ins)
        dys = [jnp.ones_like(o) if jl.is_loss else
               jnp.asarray(rs.randn(*o.shape), o.dtype) for o in outs]
        dlp, dxs = vjp(dys)
        # the port's layer on the same values
        layer = pnet.layers[li]
        flat = [(p, v.clone().requires_grad_(True))
                for p, v in leaves(pp.get(name, {}))]
        lp = unflatten(flat)
        float_in = [spec.type != "embed" for _ in ins]
        xs = [torch.from_numpy(np.array(x, np.float32)).to(
            getattr(torch, str(x.dtype))).requires_grad_(f)
            for x, f in zip(ins, float_in)]
        ctx = ApplyCtx(compute_dtype=tdt, fused=True, train=True,
                       state_sink={})
        touts = layer.forward(lp, {}, xs, ctx)
        if layer.is_loss:
            touts = [layer.loss(touts, torch.from_numpy(label),
                                torch.from_numpy(mask))]
        tdys = [torch.from_numpy(np.array(d, np.float32)).to(o.dtype)
                for d, o in zip(dys, touts)]
        want_x = [x for x, f in zip(xs, float_in) if f]
        grads = torch.autograd.grad(touts, [v for _, v in flat] + want_x,
                                    tdys)
        f32 = lambda a: np.asarray(a, np.float32)
        for i, (o, to) in enumerate(zip(outs, touts)):
            assert to.dtype == getattr(torch, str(o.dtype))
            rels[(name, f"out{i}")] = _rel(f32(to.detach().float()), f32(o))
        jdx = [d for d, f in zip(dxs, float_in) if f]
        for i, (d, td) in enumerate(zip(jdx, grads[len(flat):])):
            rels[(name, f"dx{i}")] = _rel(f32(td.float()), f32(d))
        jd = _paths(dlp)
        assert set(jd) == {p for p, _ in flat}
        for (p, _), gr in zip(flat, grads[:len(flat)]):
            assert gr.dtype == torch.float32, (name, p)
            rels[(name, "d" + "/".join(p))] = _rel(f32(gr), f32(jd[p]))
    return rels


def _check(rels, dtype):
    bound = lambda what: BF16_BIAS_SUMS if dtype == "bfloat16" \
        and what.endswith("bias") else TOL[dtype]
    bad = {k: r for k, r in rels.items() if not r <= bound(k[1])}
    assert not bad, bad


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["flash", "ref", "chunked"])
def test_seq_layers_match_the_jax_layers(impl, dtype):
    rels = _layer_rels(dtype, impl=impl)
    layers = {n for n, _ in rels}
    assert layers == {"tok_embed", "pos", "ln1", "attn1", "res1", "ln2",
                      "ffn1", "res2", "lnf", "lm_head", "lmloss_10"}, layers
    masters = {w for _, w in rels if w.startswith("d") and w[1] != "x"}
    assert {"dq/wmat", "dk/bias", "do/wmat", "dh/bias", "dgamma",
            "dbeta", "dwmat", "dbias"} <= masters, masters
    _check(rels, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_relu_ffn_and_non_causal_attention_match(dtype):
    _check(_layer_rels(dtype, act="relu", causal=0), dtype)
