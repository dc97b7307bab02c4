"""The port's uint8 decode-normalize (``ops/fused_stem.py``) against the
JAX package's (``cxxnet_tpu/ops/fused_stem.py``).

The plain version (what ``csrc/stem.cu`` computes) is held bit-equal to
the Pallas kernel in interpret mode (``pallas_call`` asserted in its
jaxpr) and to the JAX package's jnp reference: both compute in f32 and
cast once, so the tolerance is zero. Shapes the TPU kernel's gates
refuse (a batch of 5, a row of 5*7*3 bytes) are held against the jnp
reference (the card's kernel takes any shape).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cxxnet_tpu.ops.fused_stem import decode_normalize_reference as jax_ref
from cxxnet_tpu.ops.fused_stem import fused_decode_normalize as jax_fused
from cxxnet_tpu_torch.ops.fused_stem import (decode_normalize,
                                             decode_normalize_reference,
                                             fused_decode_normalize)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (jnp.float16, torch.float16)}


def _inputs(shape, mean_kind, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 256, shape).astype(np.uint8)
    mean = {"none": None,
            "channel": np.asarray([123.68, 116.78, 103.94][:shape[-1]],
                                  np.float32),
            "image": (rng.rand(*shape[1:]) * 255).astype(np.float32)
            }[mean_kind]
    return x, mean


def _port(fn, x, mean, factor, dtype):
    y = fn(torch.from_numpy(x), None if mean is None
           else torch.from_numpy(mean), factor, dtype)
    assert y.dtype == dtype and tuple(y.shape) == x.shape
    return y.float().numpy()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("mean_kind", ["none", "channel", "image"])
@pytest.mark.parametrize("factor", [(1.0, 255.0), (0.017, 1.0),
                                    (1.0, 1.0)], ids=["div255", "scale",
                                                      "one"])
def test_plain_is_bit_equal_to_the_pallas_kernel_and_the_reference(
        dtype, mean_kind, factor):
    jdt, tdt = DTYPES[dtype]
    x, mean = _inputs((8, 8, 16, 3), mean_kind)
    scale, div = factor
    f = np.float32(scale / div)      # the trainer's factor: double, then f32
    jmean = None if mean is None else jnp.asarray(mean)

    def call(x, m):
        return jax_fused(x, m, jnp.float32(f), jdt, interpret=True)
    assert "pallas_call" in str(jax.make_jaxpr(call)(jnp.asarray(x), jmean))
    want = np.asarray(call(jnp.asarray(x), jmean), np.float32)
    ref = np.asarray(jax_ref(jnp.asarray(x), jmean, jnp.float32(f), jdt),
                     np.float32)
    np.testing.assert_array_equal(want, ref)
    for fn in (decode_normalize_reference, fused_decode_normalize):
        np.testing.assert_array_equal(_port(fn, x, mean, f, tdt), want)
    got = decode_normalize(torch.from_numpy(x), None if mean is None
                           else torch.from_numpy(mean), f, tdt, fused=True)
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("shape", [(5, 5, 7, 3), (1, 13, 11, 3),
                                   (3, 4, 4, 1)])
@pytest.mark.parametrize("mean_kind", ["none", "channel", "image"])
def test_shapes_the_tpu_gates_refused_match_the_reference(shape, mean_kind):
    x, mean = _inputs(shape, mean_kind, seed=1)
    assert jax_fused(jnp.asarray(x), None, 1.0, jnp.float32) is None
    for dtype in sorted(DTYPES):
        jdt, tdt = DTYPES[dtype]
        want = np.asarray(jax_ref(jnp.asarray(x), None if mean is None
                                  else jnp.asarray(mean),
                                  jnp.float32(1 / 58.0), jdt), np.float32)
        np.testing.assert_array_equal(
            _port(fused_decode_normalize, x, mean, 1 / 58.0, tdt), want)


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    x = torch.zeros((2, 4, 4, 3), dtype=torch.uint8)
    with pytest.raises(TypeError, match="uint8"):
        fused_decode_normalize(x.float(), None, 1.0, torch.float32)
    with pytest.raises(TypeError, match="uint8"):
        fused_decode_normalize(x.reshape(2, 48), None, 1.0, torch.float32)
    with pytest.raises(ValueError, match="mean of shape"):
        fused_decode_normalize(x, torch.zeros(4, 4), 1.0, torch.float32)
    with pytest.raises(TypeError, match="output dtype"):
        fused_decode_normalize(x, None, 1.0, torch.float64)
