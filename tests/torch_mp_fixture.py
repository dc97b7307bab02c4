"""Shared setup of the port's tests of the rest of training (the fp16
loss scaler, ``update_period``, ``train_chain``): the small net of
``test_torch_train.py`` (every training layer kind) with the JAX
package's weights, driven through both packages' ``Trainer.update``.

The JAX trainer's train steps are compiled with excess precision off
(``torch_ibn_fixture.jax_run``'s options), so the reference rounds to
float16 after each operation as its program says.
"""

import functools

import jax
import numpy as np

from cxxnet_tpu.config import parse_config_string as jax_parse
from cxxnet_tpu.io.data import DataBatch as JaxBatch
from cxxnet_tpu.trainer import Trainer as JaxTrainer
from cxxnet_tpu_torch.config import parse_config_string
from cxxnet_tpu_torch.convert import opt_to_jax, params_to_jax
from cxxnet_tpu_torch.io import create_iterator
from cxxnet_tpu_torch.io.data import DataBatch
from cxxnet_tpu_torch.trainer import Trainer

from test_torch_train import (BATCH, HYPER, SMALL_TEXT, _jax_place, _np_tree,
                              _section, _small_weights)

ADAM = "updater = adam\neta = 0.001\n"


def text(dtype: str, fused: str = "0", extra: str = "") -> str:
    """The small net's config: SGD (eta 0.1, momentum 0.9, wd 1e-4) at
    batch 16 on the CPU, plus ``extra`` lines (which win)."""
    return SMALL_TEXT + HYPER.format(dtype=dtype, fused=fused) + extra


@functools.lru_cache(maxsize=None)
def batches(n: int = 5, seed: int = 3):
    """``n`` seeded synthetic batches of the small net's input."""
    pairs = [("batch_size", str(BATCH))] + _section(BATCH * n, seed,
                                                    "3,16,16")
    return tuple(create_iterator(pairs))


def planted(b: DataBatch) -> DataBatch:
    """``b`` with every input value 1e8, past float16's largest (65504):
    the float16 forward overflows, every gradient is inf or NaN."""
    return DataBatch(data=np.full_like(b.data, 1e8), label=b.label)


def jax_batch(b: DataBatch) -> JaxBatch:
    return JaxBatch(data=b.data, label=b.label,
                    num_batch_padd=b.num_batch_padd)


def _no_excess(get):
    """``Trainer._get_train_step`` whose steps compile with excess
    precision off."""
    cache = {}

    def wrapped(do_update, batch):
        fn = get(do_update, batch)
        if fn not in cache:
            box = {}

            def call(*args):
                if "c" not in box:
                    box["c"] = fn.lower(*args).compile(compiler_options={
                        "xla_allow_excess_precision": False})
                return box["c"](*args)
            cache[fn] = call
        return cache[fn]
    return wrapped


def jax_trainer(cfg_text: str, weights=_small_weights) -> JaxTrainer:
    """The JAX package's trainer over ``cfg_text`` from ``weights()``
    (the small net's by default), its optimizer state fresh."""
    tr = JaxTrainer(jax_parse(cfg_text))
    tr.init_model()
    _jax_place(tr, *weights())
    tr._init_accum(tr.params)
    tr._get_train_step = _no_excess(tr._get_train_step)
    return tr


def port_trainer(cfg_text: str, weights=_small_weights) -> Trainer:
    """The port's trainer over ``cfg_text`` from the same weights."""
    tr = Trainer(parse_config_string(cfg_text))
    tr.init_model(weights())
    return tr


def scaler(tr):
    """(scale, good) of either package's trainer, None without one."""
    mp = tr.opt_state.get("_mp")
    return None if mp is None else (float(mp["scale"]), int(mp["good"]))


def port_trees(tr):
    """The port trainer's (params, optimizer state, layer state), JAX
    layout."""
    p, s = params_to_jax(tr.params, tr.net.state)
    return p, opt_to_jax(tr.opt_state), s


def jax_trees(tr):
    return (_np_tree(tr.params),
            jax.tree_util.tree_map(np.asarray, tr.opt_state),
            _np_tree(tr.net_state))


def flat(tree, prefix=()):
    """{path: leaf} of a nested tree (dictionaries, tuples of trees)."""
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, tuple)):
            out.update(flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def assert_same_bits(a, b, what=""):
    """Every leaf of two nested trees bit-equal."""
    fa, fb = flat(a), flat(b)
    assert set(fa) == set(fb), (what, sorted(set(fa) ^ set(fb)))
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=f"{what} {k}")
