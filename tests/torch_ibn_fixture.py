"""Shared setup of the PyTorch-port parity tests: a narrow Inception-BN
(every layer type and pooling geometry of the flagship, at 1/8 of its
widths on 64x64 inputs, so the global average pool is a 2x2 window),
weights drawn by the JAX package and carried into the port.

The JAX package's random init leaves every batch_norm running statistic
at 0, which makes an eval forward scale by ``rsqrt(eps)`` at each layer;
:func:`jax_weights` therefore sets them to the batch moments of a
seeded calibration batch with one ``train=True`` apply at
``bn_momentum = 0``. That apply runs with ``fused_kernels = 0``: the
interpreted BN kernel at 69 layers would cost minutes for nothing here.

Drawing and calibrating them takes about 90 s, and each test worker
process needs them, so :func:`jax_weights` keeps them in an npz under the
temporary directory, keyed by everything they are computed from (the
net's config, this computation's source, the JAX package's sources and
the jax and numpy versions), written once under a file lock and read
back bit for bit by the other workers.
"""

import functools
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "examples", "ImageNet"))

from gen_inception_bn import generate  # noqa: E402

IBN_TEXT = generate(scale=0.125, image_size=64, num_class=10,
                    with_data=False)
IMAGE = (64, 64, 3)          # NHWC per row
BATCH = 16                   # rows the JAX kernel gates accept (bf16: 16)


def images(seed: int, n: int = BATCH) -> np.ndarray:
    """Seeded NHWC float32 input batch."""
    return np.random.RandomState(seed).randn(n, *IMAGE).astype(np.float32)


def jax_net(extra: str):
    """The JAX package's Network over the narrow net + ``extra`` lines."""
    from cxxnet_tpu.config import parse_config_string
    from cxxnet_tpu.graph import build_graph
    from cxxnet_tpu.model import Network
    cfg = parse_config_string(IBN_TEXT + extra)
    return Network(build_graph(cfg), cfg)


def _draw_jax_weights():
    """(params, state) numpy trees in the JAX layout: JAX init from key 0,
    BN running stats = batch moments of ``images(100)``."""
    import jax
    net = jax_net("compute_dtype = float32\nfused_kernels = 0\n"
                  "bn_momentum = 0\n")
    params, state = net.init(jax.random.PRNGKey(0))
    old = os.environ.get("CXXNET_BN_CLAMP_WARN")
    os.environ["CXXNET_BN_CLAMP_WARN"] = "0"   # no host callback in trace
    try:
        state = jax.jit(lambda p, s, x: net.apply(p, s, x, train=True).state
                        )(params, state, images(100))
    finally:
        if old is None:
            del os.environ["CXXNET_BN_CLAMP_WARN"]
        else:
            os.environ["CXXNET_BN_CLAMP_WARN"] = old
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return to_np(params), to_np(state)


def _weights_cache_path() -> str:
    """The npz of :func:`jax_weights` under the temporary directory,
    named by a digest of everything the weights are computed from."""
    import hashlib
    import inspect
    import tempfile
    import jax
    h = hashlib.sha256()
    for part in (IBN_TEXT, inspect.getsource(_draw_jax_weights),
                 inspect.getsource(images), jax.__version__,
                 np.__version__):
        h.update(part.encode("utf-8") + b"\0")
    for root, _, files in sorted(os.walk(os.path.join(REPO, "cxxnet_tpu"))):
        for name in sorted(f for f in files if f.endswith(".py")):
            with open(os.path.join(root, name), "rb") as f:
                h.update(name.encode("utf-8") + b"\0" + f.read())
    return os.path.join(tempfile.gettempdir(),
                        f"cxxnet_torch_ibn_weights_{h.hexdigest()[:20]}.npz")


def _flat(prefix: str, tree, out: dict) -> None:
    for k, v in tree.items():
        if isinstance(v, dict):
            _flat(f"{prefix}{k}/", v, out)
        else:
            out[prefix + k] = v


def _unflat(flat) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v
    return tree


@functools.lru_cache(maxsize=None)
def jax_weights():
    """:func:`_draw_jax_weights`, drawn once by the first worker process
    that needs them (the others wait on the lock, then read its npz)."""
    import fcntl
    path = _weights_cache_path()
    with open(path + ".lock", "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(path):
                with np.load(path, allow_pickle=False) as z:
                    flat = {k: z[k] for k in z.files}
                return (_unflat({k[2:]: v for k, v in flat.items()
                                 if k.startswith("p/")}),
                        _unflat({k[2:]: v for k, v in flat.items()
                                 if k.startswith("s/")}))
            params, state = _draw_jax_weights()
            flat: dict = {}
            _flat("p/", params, flat)
            _flat("s/", state, flat)
            tmp = f"{path}.{os.getpid()}.tmp"
            with open(tmp, "wb") as f:
                np.savez(f, **flat)
            os.replace(tmp, path)
            return params, state
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def jax_run(fn, *args):
    """``fn(*args)`` compiled by XLA with excess precision off, so the
    reference rounds to bfloat16 after each operation as its program
    says. By default XLA's CPU compiler drops a convert pair between
    fused operations and keeps, for example, a bf16 conv's output in
    float32 into the batch_norm after it; the port rounds there as the
    program does."""
    import jax
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def port_net(extra: str = "", weights=None):
    """The port's Network over the narrow net + ``extra`` lines, on the
    CPU (the generated config says ``dev = tpu``, which the port reads
    as the card), with ``weights`` (default :func:`jax_weights`) carried
    across by ``params_from_jax``."""
    from cxxnet_tpu_torch.config import parse_config_string
    from cxxnet_tpu_torch.convert import params_from_jax
    from cxxnet_tpu_torch.graph import build_graph
    from cxxnet_tpu_torch.model import Network
    cfg = parse_config_string(IBN_TEXT + extra + "\ndev = cpu\n")
    net = Network(build_graph(cfg), cfg)
    net.load_weights(*params_from_jax(*(weights or jax_weights())))
    return net
