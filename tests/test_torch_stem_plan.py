"""The launch plan of the uint8 decode-normalize (``csrc/stem.cu``) on the
CPU, and its arithmetic emulated.

``stem_plan`` gives a thread one vector of columns of the batch viewed
as (B, H*W*C) rows and a walk over rows: a block of bx threads across
the column vectors by by across rows, a grid of column blocks by row
groups. The plan must take every element once, with a vector that
divides cols and the bases' alignment and whose output is at most one
16-byte store, within a block's 1,024 threads and CUDA's 65,535 row
groups.

The kernel's per-thread work is emulated in numpy float32 on the plan's
mapping: the mean values of the thread's column vector read once, at
one remainder of its first column and then one step a lane (0 without a
mean), held across the thread's rows; each element's f32 subtract and
multiply rounded as the card's ``__fsub_rn`` and ``__fmul_rn``, then one
rounding to the output dtype. The emulation must be bit-equal to
``decode_normalize_reference`` and to the JAX package's, for no mean, a
per-channel mean (C 1, 3, 4) and a mean image, at ragged cols and row
counts no thread's rows divide.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cxxnet_tpu.ops.fused_stem import decode_normalize_reference as jax_ref
from cxxnet_tpu_torch.ops import fused_stem as S

OUT = {torch.float32: (4, jnp.float32), torch.bfloat16: (2, jnp.bfloat16),
       torch.float16: (2, jnp.float16)}
DTYPES = list(OUT)

# (n, cols): the imgrec path's row, a ragged row count, odd and even cols
PLAN_CASES = [(128, 150528), (37, 150528), (1, 150528), (5, 663),
              (9, 527), (6, 1600), (5, 300), (1000, 3), (3, 1), (0, 48)]


def _mean_lens(cols):
    return sorted({0, 1, cols} | ({3} if cols % 3 == 0 else set())
                  | ({4} if cols % 4 == 0 else set()))


@functools.lru_cache(maxsize=None)
def _owners(n, cols, p):
    """How many threads of the plan's grid take each element."""
    cv = (np.arange(p.gx)[:, None] * p.bx + np.arange(p.bx)).ravel()
    col0 = cv * p.vec
    col0 = col0[col0 < cols]
    cols_t = (col0[:, None] + np.arange(p.vec)).ravel()
    r = (np.arange(p.gy)[:, None, None] * p.by * p.rows
         + np.arange(p.by)[None, :, None]
         + np.arange(p.rows)[None, None, :] * p.by).ravel()
    r = r[r < n]
    seen = np.zeros(n * cols, np.int64)
    if len(r):
        flat = (r[:, None] * cols + cols_t[None, :]).ravel()
        seen += np.bincount(flat, minlength=n * cols)
    return seen


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("n,cols", PLAN_CASES)
def test_plan_takes_every_element_once(n, cols, dtype):
    osz = OUT[dtype][0]
    for mean_len in _mean_lens(cols):
        for align in (16, 8, 4, 2, 1):
            p = S.stem_plan(n, cols, mean_len, osz, align)
            # one element a thread takes any base of its type
            fits = lambda v: v == 1 or align % (v * osz) == 0
            assert cols % p.vec == 0 and fits(p.vec)
            assert p.vec * osz <= 16 and p.vec & (p.vec - 1) == 0
            assert p.vec == max(v for v in (1, 2, 4, 8) if v * osz <= 16
                                and cols % v == 0 and fits(v))
            assert p.bx % 32 == 0 and p.bx * p.by <= 1024
            assert p.bx * p.by <= max(S.STEM_THREADS, p.bx)
            assert 1 <= p.rows and p.gy <= S.STEM_MAX_GROUPS
            assert p.gx == -(-(cols // p.vec) // p.bx)
            assert (_owners(n, cols, p) == 1).all()


def test_plan_at_the_path_shape():
    """128 x 224*224*3 to bf16: one 16-byte store a thread and row, a
    warp's lanes on neighbouring column vectors, the rows in groups."""
    p = S.stem_plan(128, 224 * 224 * 3, 224 * 224 * 3, 2)
    assert (p.vec, p.bx, p.by, p.rows) == (8, S.STEM_THREADS, 1,
                                           S.STEM_ROWS)
    assert p.gy == -(-128 // S.STEM_ROWS)


def test_plan_raises_the_rows_where_the_groups_would_pass_the_grid():
    p = S.stem_plan(10 ** 7, 3, 3, 2)
    assert p.gy <= S.STEM_MAX_GROUPS and p.rows > S.STEM_ROWS
    assert p.gy * p.by * p.rows >= 10 ** 7


def test_plan_refuses_a_mean_that_does_not_divide_the_row():
    with pytest.raises(ValueError, match="mean length"):
        S.stem_plan(4, 10, 3, 2)
    with pytest.raises(ValueError, match="cols >= 1"):
        S.stem_plan(4, 0, 0, 2)


# -- the kernel, emulated -----------------------------------------------------

def emulate(x, mean, factor, out_dtype, plan):
    """The kernel's output for x (n, cols) uint8 and a flat float32 mean
    (or None), walking the plan's threads; NaN where nothing wrote."""
    n, cols = x.shape
    f = np.float32(S._factor(factor))
    y = np.full((n, cols), np.nan, np.float32)
    V = plan.vec
    cv = (np.arange(plan.gx)[:, None] * plan.bx + np.arange(plan.bx)).ravel()
    col0 = cv * V
    col0 = col0[col0 < cols]
    if mean is None:
        m = np.zeros((len(col0), V), np.float32)
    else:                    # one remainder, then one step a lane
        idx = np.empty((len(col0), V), np.int64)
        mi = col0 % len(mean)
        for k in range(V):
            idx[:, k] = mi
            mi = np.where(mi + 1 == len(mean), 0, mi + 1)
        m = mean[idx]
    for gy in range(plan.gy):
        for ty in range(plan.by):
            for j in range(plan.rows):          # the thread's walk
                r = gy * plan.by * plan.rows + ty + j * plan.by
                if r >= n:
                    continue
                cells = col0[:, None] + np.arange(V)
                v = x[r][cells].astype(np.float32)
                y[r][cells] = (v - m) * f       # two float32 roundings
    return torch.from_numpy(y).to(out_dtype)


def _inputs(shape, mean_kind, seed):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 256, shape).astype(np.uint8)
    mean = {"none": None,
            "channel": np.asarray([123.68, 116.78, 103.94, 99.5][
                :shape[-1]], np.float32),
            "image": (rng.rand(*shape[1:]) * 255).astype(np.float32)
            }[mean_kind]
    return x, mean


# (shape, mean kind, factor): the path's row at a few images, a ragged
# row count, batch 1, C 1 and 4, cols 4 mod 8 and odd
CASES = [((3, 224, 224, 3), "image", 1 / 58.0),
         ((37, 8, 8, 3), "image", 0.017), ((1, 16, 16, 3), "channel", 1.0),
         ((9, 31, 17, 1), "channel", 0.5), ((6, 20, 20, 4), "channel",
                                            1 / 255.0),
         ((5, 10, 10, 3), "channel", 0.017), ((7, 15, 15, 3), "image",
                                              0.017),
         ((16, 9, 9, 3), "none", 1 / 255.0), ((5, 17, 13, 3), "none", 1.0)]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[1]}-"
                         + "x".join(map(str, c[0])))
def test_emulated_kernel_is_bit_equal_to_plain_and_jax(case, dtype):
    shape, kind, factor = case
    x, mean = _inputs(shape, kind, seed=shape[0] + shape[-1])
    want = S.decode_normalize_reference(
        torch.from_numpy(x), None if mean is None else torch.from_numpy(mean),
        factor, dtype)
    jax_want = np.asarray(jax_ref(
        jnp.asarray(x), None if mean is None else jnp.asarray(mean),
        np.float32(factor), OUT[dtype][1]).astype(jnp.float32))
    np.testing.assert_array_equal(want.float().numpy(), jax_want)
    b, cols = shape[0], int(np.prod(shape[1:]))
    flat_mean = None if mean is None else mean.reshape(-1)
    for align in (16, 1):
        plan = S.stem_plan(b, cols, 0 if mean is None else mean.size,
                           OUT[dtype][0], align)
        got = emulate(x.reshape(b, cols), flat_mean, factor, dtype, plan)
        assert torch.equal(got.view(shape), want)
