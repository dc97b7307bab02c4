"""Reader and writer of the JAX package's ``%04d.model`` checkpoints.

The port's own copy of the format of ``cxxnet_tpu/checkpoint.py``: one
npz archive of flattened arrays, ``params/<layer>/<leaf>`` and
``state/<layer>/<leaf>`` (deeper where a layer's tree nests, as
``params/attn1/q/wmat``), plus the optimizer state in training rounds
(``has_opt``: ``opt/mom/...`` for SGD, ``opt/m1/...``, ``opt/m2/...``
and the int32 ``opt/t`` for Adam; an inference load never decompresses
them), and a
``__meta__`` JSON blob with the structure signature, the round, epoch
and step counters and a per-array sha256 digest map. Loads verify the
digests and raise :class:`CheckpointCorrupt` on a mismatch or a torn
archive.

Arrays are in the JAX package's layout (conv weights HWIO), so a round
written by ``python -m cxxnet_tpu.main ... task=train`` serves in the
port, and a round written here (by ``task = train`` too) loads, and
resumes, in the JAX package;
``convert.params_from_jax`` / ``params_to_jax`` change layouts. A
PTQ-derived round (``quant/``) holds int8 ``wmat`` leaves and carries
``__quant_meta__`` in its meta JSON (:func:`quant_meta`).
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import zipfile
from typing import Any, Dict, Optional

import numpy as np


class CheckpointCorrupt(IOError):
    """The archive is torn, truncated, or fails digest verification."""


def _flatten(prefix: str, tree: Any, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(f"{prefix}/{k}", v, out)
    else:
        arr = np.asarray(tree)
        # checkpoints hold fp32 masters (npz has no bfloat16)
        if arr.dtype.kind == "f" and arr.dtype != np.float32:
            arr = arr.astype(np.float32)
        out[prefix] = arr


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def _digest(arr: np.ndarray) -> str:
    """sha256 over dtype + shape + raw bytes (the JAX package's rule)."""
    h = hashlib.sha256()
    arr = np.ascontiguousarray(arr)
    h.update(f"{arr.dtype.str}:{arr.shape}:".encode("ascii"))
    h.update(arr.tobytes())
    return h.hexdigest()


def _sig_to_json(sig: tuple) -> str:
    return json.dumps(sig, default=list, sort_keys=True)


def save_model(path: str, *, structure_sig: tuple, round_counter: int,
               epoch_counter: int, params: Any, net_state: Any,
               opt_state: Any = None, step_count: int = 0,
               lr_scale: float = 1.0,
               extra_meta: Optional[Dict[str, Any]] = None) -> None:
    """Write a round. ``params``, ``net_state`` and ``opt_state`` (a
    training round's optimizer state; None for an inference round)
    are trees of arrays in the JAX package's layout (float leaves as
    float32, integer leaves, a quantized round's int8 ``wmat``, as they
    are). ``extra_meta`` adds keys to the meta JSON (a derived round's
    ``__quant_meta__``); a key that clashes with the reserved fields
    raises. The file appears atomically (temp file, fsync, rename)."""
    arrays: Dict[str, np.ndarray] = {}
    _flatten("params", params, arrays)
    _flatten("state", net_state, arrays)
    if opt_state is not None:
        _flatten("opt", opt_state, arrays)
    meta = {
        "format_version": 2,
        "structure_sig": _sig_to_json(structure_sig),
        "round": int(round_counter),
        "epoch": int(epoch_counter),
        "step_count": int(step_count),
        "lr_scale": float(lr_scale),
        "has_opt": opt_state is not None,
        "digests": {k: _digest(v) for k, v in arrays.items()},
    }
    if extra_meta:
        clash = set(extra_meta) & set(meta)
        if clash:
            raise ValueError(
                f"extra_meta keys clash with checkpoint meta: {clash}")
        meta.update(extra_meta)
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load_for_inference(path: str, verify: bool = True) -> Dict[str, Any]:
    """Params + layer state of a round, as numpy trees in the JAX
    package's layout: ``{"meta", "params", "state"}``. The ``opt/``
    members are never read. Raises :class:`CheckpointCorrupt` on a torn
    archive or, with ``verify``, a digest mismatch."""
    return _load(path, verify, with_opt=False)


def load_model(path: str, verify: bool = True) -> Dict[str, Any]:
    """A whole round: :func:`load_for_inference`'s ``{"meta", "params",
    "state"}`` plus ``"opt"``, the optimizer state tree of a training
    round (None when the round has none)."""
    return _load(path, verify, with_opt=True)


def _load(path: str, verify: bool, with_opt: bool) -> Dict[str, Any]:
    try:
        with np.load(path, allow_pickle=False) as z:
            arrays = {k: z[k] for k in z.files
                      if with_opt or not k.startswith("opt/")}
        if "__meta__" not in arrays:
            raise CheckpointCorrupt(f"{path}: archive has no meta blob")
        meta = json.loads(bytes(arrays.pop("__meta__")).decode("utf-8"))
    except (zipfile.BadZipFile, ValueError, KeyError, EOFError,
            json.JSONDecodeError) as e:
        raise CheckpointCorrupt(f"{path}: torn checkpoint archive "
                                f"({type(e).__name__}: {e})") from e
    if verify:
        digests = meta.get("digests")
        if digests is not None:
            for k, v in arrays.items():
                want = digests.get(k)
                if want is None:
                    raise CheckpointCorrupt(
                        f"{path}: array {k!r} missing from digest map")
                if _digest(v) != want:
                    raise CheckpointCorrupt(
                        f"{path}: digest mismatch for {k!r}")
    groups: Dict[str, Dict[str, np.ndarray]] = {"params": {}, "state": {}}
    for k, v in arrays.items():
        head, _, rest = k.partition("/")
        groups.setdefault(head, {})[rest] = v
    out = {"meta": meta,
           "params": _unflatten(groups["params"]),
           "state": _unflatten(groups["state"])}
    if with_opt:
        out["opt"] = _unflatten(groups["opt"]) if "opt" in groups else None
    return out


def check_structure(meta: Dict[str, Any], structure_sig: tuple) -> None:
    """Raise when the round's layer types / connections differ from the
    net config's."""
    if meta["structure_sig"] != _sig_to_json(structure_sig):
        raise ValueError(
            "model file structure does not match current net config "
            "(layer types / connections differ)")


def blob_digest(meta: Dict[str, Any]) -> str:
    """Short (12-hex) content identity of a round: sha256 over its sorted
    digest map ('' for archives without digests)."""
    digests = meta.get("digests")
    if not digests:
        return ""
    h = hashlib.sha256()
    for k in sorted(digests):
        h.update(f"{k}={digests[k]};".encode("ascii"))
    return h.hexdigest()[:12]


def quant_meta(meta: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """The ``__quant_meta__`` block of a PTQ-derived int8 round (source
    round and digest, calibration, per-layer drift), or None for an
    ordinary round."""
    qm = meta.get("__quant_meta__")
    return qm if isinstance(qm, dict) else None


def is_quantized(meta: Dict[str, Any]) -> bool:
    """Whether this round is a PTQ-derived int8 round."""
    return quant_meta(meta) is not None


def verify_model(path: str) -> Dict[str, Any]:
    """Read every member of a round and check its digests; returns the
    meta dict, raises :class:`CheckpointCorrupt` otherwise."""
    return _load(path, verify=True, with_opt=True)["meta"]


def model_path(model_dir: str, round_counter: int) -> str:
    return os.path.join(model_dir, "%04d.model" % round_counter)

