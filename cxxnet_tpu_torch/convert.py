"""Carry weights between the JAX package's layout and the port's.

The JAX package keeps parameters as ``params[layer][leaf]`` numpy/JAX
arrays with conv weights HWIO ``(kh, kw, cin/group, cout)``; the port
keeps the same tree with conv weights OIHW ``(cout, cin/group, kh, kw)``,
PyTorch's layout. Everything else is the same in both: fullc ``wmat``
``(in, out)``, biases and batch-norm ``wmat``/``bias``/``running_exp``/
``running_var`` ``(C,)``. A conv weight is the one 4-D ``wmat`` leaf.
A PTQ-derived round (quant/ptq.py) keeps the same layouts: ``wmat`` int8
of the float shape, ``wmat_scale`` (N,) and ``act_scale`` () float32.

Trees nest to any depth (an attention layer's ``params[layer][q][wmat]``
is 3-D ``(E, H, D)``, not a conv weight). The optimizer state, SGD's
``{"mom": tree}`` or Adam's ``{"m1": tree, "m2": tree, "t": step}``, has
the params' layout, and its conv moments are transposed the same way
(:func:`opt_from_jax`, :func:`opt_to_jax`); a float16 round adds the
loss scaler, ``"_mp": {"scale", "good"}``, as in the JAX package.

Weights move between the packages this way or through a checkpoint
(checkpoint.py reads and writes the JAX layout), never through seeds:
the two packages draw different numbers from the same seed.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

_HWIO_TO_OIHW = (3, 2, 0, 1)
_OIHW_TO_HWIO = (2, 3, 1, 0)


def _map(tree: Any, fn, leaf: str = "") -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn, k) for k, v in tree.items()}
    return fn(leaf, tree)


def params_from_jax(params_np: Dict, state_np: Dict
                    ) -> Tuple[Dict, Dict]:
    """JAX-layout trees (numpy arrays) -> port trees of float32 CPU
    tensors, conv ``wmat`` transposed HWIO -> OIHW. int8 leaves (the
    ``wmat`` of a PTQ-derived round) stay int8, a conv's transposed too;
    other integer leaves (insanity's ``step``) become int32."""
    def conv(leaf, a):
        a = np.asarray(a)
        if a.dtype.kind in "iu":
            a = np.array(a, dtype=np.int8 if a.dtype == np.int8
                         else np.int32)
        else:
            a = np.array(a, dtype=np.float32)     # a writable copy
        if leaf == "wmat" and a.ndim == 4:
            a = np.ascontiguousarray(a.transpose(_HWIO_TO_OIHW))
        return torch.from_numpy(a)
    return _map(params_np, conv), _map(state_np, conv)


def params_to_jax(params: Dict, state: Dict) -> Tuple[Dict, Dict]:
    """Port trees (tensors on any device) -> JAX-layout trees of float32
    numpy arrays (int8 leaves int8, other integer leaves int32; copies:
    later in-place updates of the tensors do not reach them), conv
    ``wmat`` transposed OIHW -> HWIO."""
    def conv(leaf, t):
        if t.is_floating_point():
            a = t.detach().float().cpu().numpy()
            dt = np.float32
        else:
            a = t.detach().cpu().numpy()
            dt = np.int8 if a.dtype == np.int8 else np.int32
        if leaf == "wmat" and a.ndim == 4:
            a = a.transpose(_OIHW_TO_HWIO)
        return np.array(a, dtype=dt, order="C")
    return _map(params, conv), _map(state, conv)


def opt_from_jax(opt_np: Dict) -> Dict:
    """JAX-layout optimizer state -> port layout: SGD's ``{"mom": tree}``
    or Adam's ``{"m1": tree, "m2": tree, "t": step}``, the trees as
    float32 CPU tensors (conv moments OIHW), ``t`` an int32 scalar; a
    float16 round's loss scaler ``_mp`` as ``{"scale": float32, "good":
    int32}`` scalars."""
    out = {}
    for k, v in opt_np.items():
        if k == "t":
            out[k] = torch.as_tensor(np.asarray(v, np.int32))
        elif k == "_mp":
            out[k] = {"scale": torch.as_tensor(
                np.asarray(v["scale"], np.float32).reshape(())),
                "good": torch.as_tensor(
                    np.asarray(v["good"], np.int32).reshape(()))}
        else:
            out[k] = params_from_jax(v, {})[0]
    return out


def opt_to_jax(opt: Dict) -> Dict:
    """Port optimizer state (tensors on any device) -> JAX layout
    (float32 numpy trees, conv moments HWIO; ``t`` int32; the loss
    scaler's ``scale`` float32 and ``good`` int32, which the checkpoint
    writes as ``opt/_mp/scale`` and ``opt/_mp/good``)."""
    out = {}
    for k, v in opt.items():
        if k == "t":
            out[k] = np.asarray(v.cpu().numpy(), np.int32)
        elif k == "_mp":
            out[k] = {"scale": np.asarray(v["scale"].cpu().numpy(),
                                          np.float32),
                      "good": np.asarray(v["good"].cpu().numpy(), np.int32)}
        else:
            out[k] = params_to_jax(v, {})[0]
    return out
