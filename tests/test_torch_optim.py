"""The port's optimizer against ``cxxnet_tpu.optim``: the same config
pairs give the same per-tag hyperparameters, and the same (lr, momentum)
at every update step from 0 to 50 for the four lr schedules and the
momentum ramp (exact: both are the same Python float arithmetic); and
Adam's apply and steps (see the Adam section below)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cxxnet_tpu.config import parse_config_string as jax_parse
from cxxnet_tpu.ops.fused_optim import fused_adam_apply as jax_adam_apply
from cxxnet_tpu.optim import Optimizer as JaxOptimizer
from cxxnet_tpu.optim import build_hypers as jax_build_hypers
from cxxnet_tpu.optim import tag_for_param as jax_tag_for_param
from cxxnet_tpu_torch.config import parse_config_string
from cxxnet_tpu_torch.ops import KERNELS
from cxxnet_tpu_torch.ops.fused_optim import adam_apply_plain, fused_adam_apply
from cxxnet_tpu_torch.optim import (Optimizer, adam_lr_t, build_hypers,
                                    leaves, tag_for_param)

SCHEDULES = {
    "constant": "eta = 0.1\nmomentum = 0.9\n",
    "expdecay": "eta = 0.1\nlr:schedule = expdecay\nlr:gamma = 0.7\n"
                "lr:step = 5\n",
    "polydecay": "eta = 0.2\nlr:schedule = polydecay\nlr:gamma = 0.3\n"
                 "lr:alpha = 0.75\nlr:step = 4\n",
    "factor": "eta = 0.1\nlr:schedule = factor\nlr:factor = 0.5\n"
              "lr:step = 10\nlr:minimum_lr = 0.004\n",
    "momentum_ramp": "eta = 0.1\nmomentum_schedule = 1\n"
                     "base_momentum = 0.5\nfinal_momentum = 0.95\n"
                     "saturation_epoch = 20\n",
    "start_epoch": "eta = 0.1\nlr:schedule = expdecay\nlr:gamma = 0.5\n"
                   "lr:start_epoch = 8\n",
    "tag_scoped": "eta = 0.1\nwd = 0.0005\nbias:eta = 0.2\nbias:wd = 0\n"
                  "wmat:lr:schedule = factor\nwmat:lr:step = 3\n"
                  "wmat:momentum = 0.8\nclip_gradient = 5\n",
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_hypers_and_schedules_match_the_jax_optimizer(name):
    text = SCHEDULES[name]
    ours = build_hypers(parse_config_string(text))
    ref = jax_build_hypers(jax_parse(text))
    assert sorted(ours) == sorted(ref) == ["bias", "wmat"]
    for tag in ours:
        o, r = dataclasses.asdict(ours[tag]), dataclasses.asdict(ref[tag])
        assert {k: o[k] for k in o} == {k: r[k] for k in o}
        for epoch in range(51):
            assert ours[tag].schedule(epoch) == ref[tag].schedule(epoch), \
                (tag, epoch)


@pytest.mark.parametrize("key", ["wmat", "bias", "gamma", "beta",
                                 "running_exp", "wmat_scale"])
def test_tag_for_param_matches(key):
    assert tag_for_param(key) == jax_tag_for_param(key)


# -- Adam ---------------------------------------------------------------------
#
# The port's plain Adam (``ops/fused_optim.adam_apply_plain``, what the
# card's kernel computes) against the JAX package's Pallas ``_adam_kernel``
# (``fused_adam_apply``, interpret mode, ``pallas_call`` asserted) and the
# port's ``Optimizer`` against the JAX ``Optimizer._apply`` (fused group
# apply or per leaf) over a nested tree, three steps (t = 1..3) with tag-
# scoped wd, clip and NaN gradients. The arithmetic is the same f32
# operations in the same order, so each element is held within 2 f32 ulp
# or 1e-7 (rtol 2.4e-7, atol 1e-7, the SGD tests' bound): step 1 reads
# equal; from step 2 XLA contracts ``m + d * (g - m)`` into one FMA
# rounding, which moves an element of m1 or m2 by an ulp (readings up to
# 1.2e-7 in m1's entries near 1, 3.7e-9 in w), where the port, like the
# card's kernel, rounds each operation. The bias-corrected ``lr_t`` is
# computed in float32 as the JAX step computes it.

def _ulp_close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2.4e-7, atol=1e-7)


@pytest.mark.parametrize("lr,d1,d2", [(1e-3, 0.1, 0.001), (3e-3, 0.1, 0.001),
                                      (0.05, 0.2, 0.01)])
def test_adam_lr_t_is_the_jax_steps_float32_scalar(lr, d1, d2):
    @jax.jit
    def jax_lr_t(t):          # cxxnet_tpu/optim.py's fused-path formula
        tf = t.astype(jnp.float32)
        return lr * jnp.sqrt(1.0 - (1.0 - d2) ** tf) / (1.0 - (1.0 - d1) ** tf)
    for t in range(1, 4):
        want = float(jax_lr_t(jnp.int32(t)))
        got = adam_lr_t(lr, t, d1, d2)
        assert got == float(np.float32(got))            # an f32 value
        assert abs(got - want) <= 1.2e-7 * abs(want), (t, got, want)


def _adam_leaves(seed, nan):
    rs = np.random.RandomState(seed)
    shapes = [(3, 3, 4, 8), (8,), (37,), (5, 7)]
    ws = [rs.randn(*s).astype(np.float32) for s in shapes]
    gs = [[rs.randn(*s).astype(np.float32) * 3 for s in shapes]
          for _ in range(3)]
    if nan:
        for g in gs:
            g[0].reshape(-1)[::7] = np.nan
            g[2][3] = np.nan
    return ws, gs


ADAM_CASES = [(0.0, 0.0, False), (1e-3, 0.0, True), (0.0, 0.5, True),
              (5e-4, 1.0, False)]


@pytest.mark.parametrize("wd,clip,nan", ADAM_CASES,
                         ids=[f"wd{c[0]}-clip{c[1]}-nan{int(c[2])}"
                              for c in ADAM_CASES])
def test_adam_apply_plain_matches_jax_kernel(wd, clip, nan):
    ws, gss = _adam_leaves(9, nan)
    d1, d2 = 0.1, 0.001
    jw = list(ws)
    jm1 = [np.zeros_like(w) for w in ws]
    jm2 = [np.zeros_like(w) for w in ws]
    tw = [torch.from_numpy(w.copy()) for w in ws]
    tm1 = [torch.zeros_like(w) for w in tw]
    tm2 = [torch.zeros_like(w) for w in tw]
    for t, gs in enumerate(gss, start=1):
        lr_t = adam_lr_t(1e-3, t, d1, d2)
        call = lambda w, g, a, b: jax_adam_apply(
            w, g, a, b, lr_t, wd=wd, clip=clip, d1=d1, d2=d2, interpret=True)
        if t == 1:
            assert "pallas_call" in str(jax.make_jaxpr(call)(jw, gs, jm1,
                                                             jm2))
        jw, jm1, jm2 = call(jw, gs, jm1, jm2)
        tg = [torch.from_numpy(g) for g in gs]
        got = adam_apply_plain(tw, tg, tm1, tm2, lr_t, d1, d2, wd, clip)
        for a, b in zip(sum(got, []), list(jw) + list(jm1) + list(jm2)):
            assert bool(torch.isfinite(a).all())
            _ulp_close(a.numpy(), b)
        for k in KERNELS.values():
            k.launches = 0
        fused_adam_apply(tw, tg, tm1, tm2, lr_t, d1=d1, d2=d2, wd=wd,
                         clip=clip)
        for a, b in zip(tw + tm1 + tm2, sum(got, [])):   # in place on CPU
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        assert KERNELS["adam_apply"].launches == 0      # no kernel on CPU


ADAM_CFG = """
eta = 0.003
wd = 0.001
bias:wd = 0
clip_gradient = 2.0
beta1 = 0.2
wmat:beta2 = 0.01
updater = adam
fused_kernels = {fused}
"""


def _nested(arrs):
    """An attention-like tree, three levels deep where mha's is."""
    a, b, c, d = arrs
    return {"attn": {"q": {"wmat": a, "bias": b}}, "ln": {"gamma": c},
            "head": {"wmat": d}}


@pytest.mark.parametrize("jax_fused", ["1", "0"])
@pytest.mark.parametrize("port_fused", ["1", "0"])
def test_adam_optimizer_steps_match_the_jax_optimizer(port_fused, jax_fused):
    """Three Adam steps of the port's ``Optimizer.update`` (group apply
    or per leaf, in place; t on the host) against the JAX
    ``Optimizer._apply`` (Pallas group apply in interpret mode, or per
    leaf) over a nested tree, with tag-scoped wd and beta2."""
    ws, gss = _adam_leaves(10, nan=True)
    jopt = JaxOptimizer("adam", jax_parse(ADAM_CFG.format(fused=jax_fused)))
    opt = Optimizer("adam", parse_config_string(ADAM_CFG.format(
        fused=port_fused)))
    assert opt.hypers["wmat"].beta2_decay == 0.01
    assert opt.hypers["bias"].beta2_decay == 0.001
    assert opt.hypers["bias"].beta1_decay == 0.2
    jp = _nested([jnp.asarray(w) for w in ws])
    jo = jopt.init_state(jp)
    params = _nested([torch.from_numpy(w.copy()) for w in ws])
    state = opt.init_state(params)
    assert set(state) == set(jo) == {"m1", "m2", "t"}
    for step, gs in enumerate(gss):
        sched = jopt.schedules(step)
        assert opt.schedules(step) == sched
        call = lambda p, g, o: jopt._apply(p, g, o, sched)
        jargs = (jp, _nested([jnp.asarray(g) for g in gs]), jo)
        if step == 0:
            assert ("pallas_call" in str(jax.make_jaxpr(call)(*jargs))) \
                == (jax_fused == "1")
        jp, jo = call(*jargs)
        opt.update(params, _nested([torch.from_numpy(g) for g in gs]),
                   state, opt.schedules(step))
        assert int(state["t"]) == int(jo["t"]) == step + 1
        for name, got, want in (("params", params, jp),
                                ("m1", state["m1"], jo["m1"]),
                                ("m2", state["m2"], jo["m2"])):
            want_l = dict(leaves(want))
            for path, v in leaves(got):
                assert v.dtype == torch.float32, (name, path)
                _ulp_close(v.numpy(), want_l[path])
