"""The Adam kernel's CTA table (``adam_apply``: ``csrc/adam_apply.cu``
under ``ops/fused_optim.adam_plan``) on the CPU.

Each CTA takes up to ADAM_CHUNK elements of one leaf: in a vectorised
chunk each of ADAM_THREADS threads one 16-byte vector of w, g, m1 and m2
(a partial vector at a leaf's end element by element), in any other
chunk up to 4 single elements a thread, ADAM_THREADS apart. The walk,
emulated here as the kernel takes it, must update every element of
every leaf exactly once, with 16-byte loads only from 16-byte aligned
addresses in all four streams. The update, emulated in numpy f32 with
each operation rounded through that walk, equals ``adam_apply_plain``
bit for bit and the JAX package's ``fused_adam_apply`` (its Pallas
``_adam_kernel``, interpreted) within 2 f32 ulp or 1e-7, the bound
``tests/test_torch_optim.py`` states (XLA contracts ``m + d * (g - m)``
into an FMA from step 2).
"""

import jax
import numpy as np
import pytest
import torch

from chip_smoke import FLAGSHIP, LM_CONF, adam_shapes
from cxxnet_tpu.ops.fused_optim import fused_adam_apply as jax_adam_apply
from cxxnet_tpu_torch.ops import fused_optim as F
from cxxnet_tpu_torch.optim import adam_lr_t


def _cta_elements(start, count, vec):
    """One CTA's elements, counted from its leaf's first: those of its
    16-byte vector loads, (vectors, 4), thread t's in row t; and those it
    takes one at a time, thread t's elements 4t + k of a partial vector
    or t + k * ADAM_THREADS of a chunk without vectors (k < 4), for every
    thread (the kernel's two paths, row by row)."""
    t = np.arange(F.ADAM_THREADS)
    full = (4 * t + 4 <= count) if vec else np.zeros_like(t, bool)
    vecs = start + 4 * t[full, None] + np.arange(4)
    first, step = (4 * t, 1) if vec else (t, F.ADAM_THREADS)
    one = first[~full, None] + step * np.arange(4)
    return vecs, start + one[one < count]


def _walk(sizes, bases):
    """Every (leaf, vector loads' elements, single elements) of the
    kernel's walk under ``adam_plan(sizes, bases)``, CTA by CTA."""
    for leaf, start, count, vec in F.adam_plan(sizes, bases):
        assert 0 < count <= F.ADAM_CHUNK
        yield (leaf, *_cta_elements(start, count, vec))


def _bases(n, offsets=None):
    """Four distinct 256-aligned byte addresses a leaf (as the caching
    allocator gives), each moved by ``offsets`` bytes."""
    b = (np.arange(4 * n, dtype=np.int64).reshape(n, 4) + 1) << 24
    return b if offsets is None else b + np.asarray(offsets, np.int64)


#: leaf lists: the LM's and Inception-BN's, odd sizes, and leaves whose
#: four streams start 4, 8 or 12 bytes past a 16-byte boundary, together
#: or apart
SIZES = [1, 3, 4, 1023, 1024, 1025, 4097, 8193]
PLAN_CASES = {
    "lm": ([int(np.prod(s)) for s in adam_shapes(LM_CONF)], None),
    "inception_bn": ([int(np.prod(s)) for s in adam_shapes(FLAGSHIP)], None),
    "sizes": (SIZES, None),
    "4 bytes past": (SIZES, [(4, 4, 4, 4)] * len(SIZES)),
    "offsets": ([4097, 8193, 7, 1030, 2, 5000, 3, 1],
                [(4, 4, 4, 4), (8, 8, 8, 8), (12, 12, 12, 12), (4, 0, 0, 0),
                 (12, 12, 12, 12), (0, 8, 4, 12), (8, 8, 8, 8),
                 (12, 12, 12, 12)]),
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_adam_plan_takes_every_element_once(case):
    """Every element of every leaf exactly once; a vector load only where
    all four streams' addresses are 16-byte aligned; a leaf whose four
    bases share their offset loads all but its head (at most 3 elements)
    and its last partial vector as vectors."""
    sizes, offsets = PLAN_CASES[case]
    bases = _bases(len(sizes), offsets)
    seen = [np.zeros(n, np.int64) for n in sizes]
    scalar = np.zeros(len(sizes), np.int64)
    for leaf, vecs, one in _walk(sizes, bases):
        np.add.at(seen[leaf], np.concatenate([vecs.reshape(-1), one]), 1)
        assert ((bases[leaf][:, None] + 4 * vecs[:, 0]) % 16 == 0).all()
        scalar[leaf] += len(one)
    assert all((s == 1).all() for s in seen)
    off = bases % 16
    for i, n in enumerate(sizes):
        if (off[i] == off[i, 0]).all():
            assert scalar[i] <= (16 - off[i, 0]) % 16 // 4 + 3
        else:
            assert scalar[i] == n


def test_adam_plan_fills_the_card_at_the_lm():
    """The LM's wmat group (8 leaves, 212,992 parameters, one launch)
    makes at least one CTA for each of the card's 132 SMs; all 21 leaves
    need one table upload of 4 pointers a leaf and 2 words a CTA."""
    from chip_smoke import lm_shapes
    groups = lm_shapes(LM_CONF)[1]
    wmat = [int(np.prod(s)) for s in groups["wmat"]]
    assert sum(wmat) == 212992
    plan = F.adam_plan(wmat, _bases(len(wmat)))
    assert len(plan) >= 132 and plan[:, 3].all()


def _adam_emulated(w, g, m1, m2, lr_t, d1, d2, wd, clip, sizes, bases):
    """The kernel's update through its walk, in numpy float32 with each
    operation rounded: every thread's elements of every CTA. Returns new
    (w, m1, m2) lists."""
    f = np.float32
    lr_t, d1, d2, wd, clip = (f(v) for v in (lr_t, d1, d2, wd, clip))
    w, m1, m2 = ([a.copy() for a in t] for t in (w, m1, m2))
    for leaf, vecs, one in _walk(sizes, bases):
        i = np.concatenate([vecs.reshape(-1), one])
        gv = g[leaf][i]
        gv = np.where(np.isnan(gv), f(0), gv)
        if clip != 0:
            gv = np.minimum(np.maximum(gv, -clip), clip)
        if wd != 0:
            gv = gv + wd * w[leaf][i]
        a = m1[leaf][i] + d1 * (gv - m1[leaf][i])
        b = m2[leaf][i] + d2 * (gv * gv - m2[leaf][i])
        w[leaf][i] = w[leaf][i] - (lr_t * a) / (np.sqrt(b) + f(1e-8))
        m1[leaf][i], m2[leaf][i] = a, b
        assert a.dtype == b.dtype == w[leaf].dtype == np.float32
    return w, m1, m2


def _leaves(sizes, seed, nan=True):
    rs = np.random.RandomState(seed)
    w = [rs.randn(n).astype(np.float32) for n in sizes]
    g = [(rs.randn(n) * 3).astype(np.float32) for n in sizes]
    m1 = [(rs.randn(n) * 0.1).astype(np.float32) for n in sizes]
    m2 = [np.abs(rs.randn(n) * 0.1).astype(np.float32) for n in sizes]
    if nan:
        for a in g:
            a[::7] = np.nan
    return w, g, m1, m2


@pytest.mark.parametrize("wd,clip", [(0.0, 0.0), (1e-4, 0.0), (1e-4, 0.5),
                                     (0.0, 0.5)])
@pytest.mark.parametrize("case", ["sizes", "offsets"])
def test_adam_update_through_the_walk_is_the_plain_version(case, wd, clip):
    """The emulated kernel equals ``adam_apply_plain`` bit for bit, NaN
    gradients included."""
    sizes, offsets = PLAN_CASES[case]
    w, g, m1, m2 = _leaves(sizes, seed=len(sizes))
    got = _adam_emulated(w, g, m1, m2, 3e-4, 0.1, 0.001, wd, clip, sizes,
                         _bases(len(sizes), offsets))
    t = lambda xs: [torch.from_numpy(x) for x in xs]
    want = F.adam_apply_plain(t(w), t(g), t(m1), t(m2), 3e-4, 0.1, 0.001,
                              wd, clip)
    for a, b in zip(sum(got, []), sum(want, [])):
        np.testing.assert_array_equal(a, b.numpy())


@pytest.mark.parametrize("wd,clip", [(0.0, 0.0), (1e-3, 0.5)])
def test_adam_update_through_the_walk_is_near_the_jax_kernel(wd, clip):
    """Three steps (t = 1..3) of the emulated kernel against the JAX
    package's fused Adam (interpreted, ``pallas_call`` asserted) from the
    same leaves, 4 bytes past a boundary and of odd sizes: within 2 f32
    ulp or 1e-7."""
    sizes = [1, 3, 37, 1025]
    bases = _bases(len(sizes), [(4, 4, 4, 4)] * len(sizes))
    w = _leaves(sizes, seed=5)[0]
    m1 = [np.zeros_like(a) for a in w]
    m2 = [np.zeros_like(a) for a in w]
    jw, jm1, jm2 = list(w), list(m1), list(m2)
    d1, d2 = 0.1, 0.001
    for step in range(1, 4):
        g = _leaves(sizes, seed=10 + step)[1]
        lr_t = adam_lr_t(1e-3, step, d1, d2)
        call = lambda a, b, c, d: jax_adam_apply(
            a, b, c, d, lr_t, wd=wd, clip=clip, d1=d1, d2=d2, interpret=True)
        if step == 1:
            assert "pallas_call" in str(jax.make_jaxpr(call)(jw, g, jm1,
                                                             jm2))
        jw, jm1, jm2 = call(jw, g, jm1, jm2)
        w, m1, m2 = _adam_emulated(w, g, m1, m2, lr_t, d1, d2, wd, clip,
                                   sizes, bases)
        for a, b in zip(w + m1 + m2, list(jw) + list(jm1) + list(jm2)):
            assert np.isfinite(a).all()
            np.testing.assert_allclose(a, np.asarray(b), rtol=2.4e-7,
                                       atol=1e-7)
