"""Shared setup of the convnet parity tests of the PyTorch port: the
JAX package's random draws handed to the port's layers, and AlexNet and
the SPP net of ``examples/ImageNet/{alexnet,kaiming}.conf`` cut to a
narrow size for the CPU.

The port draws from ``torch.Generator``s and the JAX package from
``jax.random``; the two give different numbers from one seed. So a test
that holds a drawing layer (dropout, insanity) against the JAX layer
hands the port the JAX layer's own draws: :class:`JaxDraws` computes,
from the key the JAX layer gets (``fold_in(step key, layer index)``),
the same ``jax.random.bernoulli`` mask or ``jax.random.uniform`` values
the JAX layer draws.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from torch_ibn_fixture import REPO

sys.path.insert(0, os.path.join(REPO, "tools"))
from make_digits import write_idx  # noqa: E402  (sklearn only in export)

_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
        torch.float16: jnp.float16}


class JaxDraws:
    """A draw source for the port's layers that gives the JAX layer's
    draws under ``key`` (the methods of ``layers.base.Draws``)."""

    def __init__(self, key):
        self.key = key

    def keep_mask(self, shape, pkeep):
        return torch.from_numpy(np.array(
            jax.random.bernoulli(self.key, pkeep, tuple(shape))))

    def uniform(self, shape, dtype):
        u = jax.random.uniform(self.key, tuple(shape), _JDT[dtype])
        return torch.from_numpy(np.array(u.astype(jnp.float32))).to(dtype)


def jax_net_draws(step_key):
    """``Network.apply``'s ``draws`` factory giving each layer the JAX
    package's per-layer key ``fold_in(step_key, layer index)``."""
    return lambda li: JaxDraws(jax.random.fold_in(step_key, li))


#: narrow net -> (config, input shape): widths / 8, AlexNet at 99x99 so
#: that its flatten is 2x2xC, the SPP net at 125x125 so that conv5 is
#: 15x15, spp1 tiles and spp4 fits
NARROW = {"alexnet": ("alexnet.conf", "3,99,99"),
          "spp": ("kaiming.conf", "3,125,125")}
CLASSES = 125                          # fc8's 1000 / 8
BATCH = 16                             # rows the JAX LRN gate takes


def narrow_pairs(net, dtype="float32", fused="auto", deterministic=False,
                 extra=()):
    """Config pairs of the narrow ``net`` (global settings and netconfig,
    no iterator sections), readable by both packages: every ``nchannel``
    and ``nhidden`` divided by 8, the input shape cut, batch 16 on the
    CPU. ``deterministic`` sets every dropout threshold to 0 and every
    insanity layer's lb = ub = 7.5: the deterministic cases of the same
    code."""
    from cxxnet_tpu_torch.config import parse_config_file, split_sections
    conf, image = NARROW[net]
    glob, _ = split_sections(parse_config_file(
        os.path.join(REPO, "examples", "ImageNet", conf)))
    out = []
    for k, v in glob:
        if k in ("nchannel", "nhidden"):
            v = str(int(v) // 8)
        elif k == "input_shape":
            v = image
        elif k == "threshold" and deterministic:
            v = "0"
        elif k in ("dev", "batch_size", "compute_dtype"):
            continue
        out.append((k, v))
        if deterministic and k.startswith("layer[") and \
                v.startswith("insanity:"):
            out += [("lb", "7.5"), ("ub", "7.5")]
    return out + [("dev", "cpu"), ("batch_size", str(BATCH)),
                  ("compute_dtype", dtype), ("fused_kernels", fused),
                  *extra]


def synthetic_section(kind, name, n, seed, net):
    """An ``iter = synthetic`` section of ``n`` rows of ``net``'s input."""
    return [(kind, name), ("iter", "synthetic"), ("num_inst", str(n)),
            ("num_class", str(CLASSES)), ("input_shape", NARROW[net][1]),
            ("seed_data", str(seed)), ("iter", "end")]


def write_digits(dirname, n_train=250, n_test=60, size=8, seed=0, gz=True):
    """Seeded idx files with the digits configs' names: (paths by role)."""
    rs = np.random.RandomState(seed)
    ext = ".gz" if gz else ""
    paths = {}
    for split, n in (("train", n_train), ("t10k", n_test)):
        img = os.path.join(dirname, f"{split}-images-idx3-ubyte{ext}")
        lab = os.path.join(dirname, f"{split}-labels-idx1-ubyte{ext}")
        write_idx(img, rs.randint(0, 256, size=(n, size, size)))
        write_idx(lab, rs.randint(0, 10, size=(n,)))
        paths[split] = (img, lab)
    return paths
