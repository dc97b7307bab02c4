"""Reader and writer of the JAX package's ``%04d.model`` checkpoints.

The port's own copy of the format of ``cxxnet_tpu/checkpoint.py``: one
npz archive of flattened arrays, ``params/<layer>/<leaf>`` and
``state/<layer>/<leaf>`` (deeper where a layer's tree nests, as
``params/attn1/q/wmat``), plus the optimizer state in training rounds
(``has_opt``: ``opt/mom/...`` for SGD, ``opt/m1/...``, ``opt/m2/...``
and the int32 ``opt/t`` for Adam, and under float16 the loss scaler's
``opt/_mp/scale`` (float32) and ``opt/_mp/good`` (int32); an inference
load never decompresses them), and a
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

The resume scan (:func:`find_latest_valid`, what ``continue = 1``
reads) takes the newest round of a ``model_dir`` that verifies, skipping
a torn or digest-failing one, and sweeps the temp files a writer killed
before its rename left behind. :func:`copy_model_from` is finetune's
copy by layer name.

Telemetry, as in the JAX package: a save is the ``ckpt.save`` span and a
``ckpt_save`` ledger event, a read the ``ckpt.load`` span and a
``ckpt_load`` event, both timed into ``cxxnet_ckpt_io_seconds{op}``;
skipped rounds and swept temp files count as ``ckpt.skipped_invalid``
and ``ckpt.tmp_swept``. Rounds are read and written through the stream
layer (``io/stream.py``): a ``model_dir`` may be a local directory or a
``scheme://`` URL, whose reads and writes retry under the ``io_retry_*``
policy. The failpoint ``ckpt.write`` fires before a write; the stream
layer's ``io.open``, ``io.read`` and ``io.write`` fire inside it, and
while one of them is armed a local read takes the remote path (one
retried read of the whole archive), as in the JAX package.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import re
import time
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .io import stream
from .resilience import counters, failpoints
from .telemetry.disttrace import DISTTRACE
from .telemetry.ledger import LEDGER
from .telemetry.registry import REGISTRY
from .telemetry.trace import TRACER

_H_CKPT = REGISTRY.histogram(
    "cxxnet_ckpt_io_seconds",
    "Checkpoint archive IO duration by operation",
    labels=("op",))


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
    raises. The file appears atomically (``stream.write_bytes_atomic``)."""
    # a distributed-trace root (the plain span when that is off): the
    # ckpt_save event below carries the save's trace id
    with DISTTRACE.span("ckpt.save", cat="ckpt",
                        args={"round": round_counter}):
        t0 = time.perf_counter()
        ok = False
        try:
            _save_model(path, structure_sig=structure_sig,
                        round_counter=round_counter,
                        epoch_counter=epoch_counter, params=params,
                        net_state=net_state, opt_state=opt_state,
                        step_count=step_count, lr_scale=lr_scale,
                        extra_meta=extra_meta)
            ok = True
        finally:
            t1 = time.perf_counter()
            _H_CKPT.labels("save").observe(t1 - t0)
            LEDGER.event("ckpt_save", round=round_counter, path=path,
                         seconds=round(t1 - t0, 4), ok=ok)


def _save_model(path: str, *, structure_sig: tuple, round_counter: int,
                epoch_counter: int, params: Any, net_state: Any,
                opt_state: Any, step_count: int, lr_scale: float,
                extra_meta: Optional[Dict[str, Any]]) -> None:
    failpoints.check("ckpt.write", IOError)
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
    # local: temp file, fsync, rename; remote: one whole-object write
    stream.write_bytes_atomic(path, buf.getvalue())


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
    t0 = time.perf_counter()
    ok = False
    try:
        out = _load_inner(path, verify, with_opt)
        ok = True
        return out
    finally:
        t1 = time.perf_counter()
        _H_CKPT.labels("load").observe(t1 - t0)
        TRACER.add_complete("ckpt.load", t0, t1, cat="ckpt",
                            args={"path": os.path.basename(path)})
        LEDGER.event("ckpt_load", path=path, seconds=round(t1 - t0, 4),
                     ok=ok)


def _load_inner(path: str, verify: bool, with_opt: bool) -> Dict[str, Any]:
    try:
        if stream.is_remote(path) or failpoints.armed_prefix("io."):
            # one retried read of the whole object, then unpack
            src = io.BytesIO(stream.read_bytes(path))
        else:
            src = path               # local: np.load streams the members
        with np.load(src, allow_pickle=False) as z:
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



# -- the resume scan ----------------------------------------------------------

#: ``%04d`` pads and does not truncate: round 10000 writes
#: ``10000.model``, so the scan takes 4 digits or more
_MODEL_RE = re.compile(r"^(\d{4,})\.model$")
#: a shard-set round directory of the JAX package's ``shard_ckpt = 1``
_ROUND_DIR_RE = re.compile(r"^r(\d{4,})$")
#: the temp files a round's writer leaves when it dies before its rename:
#: ``<round>.tmp.<pid>.<seq>`` (``stream.write_bytes_atomic``), and the
#: ``<round>.<pid>.tmp`` of earlier rounds of the port
_TMP_RE = re.compile(r"^\d{4,}\.model\.(?:(\d+)\.tmp|tmp\.(\d+)(?:\.\d+)?)$")
#: a temp file younger than this may be a live writer's in another
#: process (a serve or a second run sharing ``model_dir``) and is kept
TMP_SWEEP_MIN_AGE_S = 600.0
#: what a scan says of the shard-set rounds it skips
SHARD_SET = ("ROADMAP Queue A 11 (sharded checkpoints): the PyTorch port "
             "does not read shard-set rounds yet")


def _scan_rounds(model_dir: str) -> List[Tuple[int, str]]:
    """Every ``%04d.model`` round of ``model_dir`` as (round, path),
    newest first. Shard-set directories (``r%04d``) are skipped, named
    in one line a scan."""
    if not stream.isdir(model_dir):
        return []
    out, shard_sets = [], []
    for fn in stream.listdir(model_dir):
        m = _MODEL_RE.match(fn)
        if m:
            out.append((int(m.group(1)), os.path.join(model_dir, fn)))
        elif _ROUND_DIR_RE.match(fn) and \
                stream.isdir(os.path.join(model_dir, fn)):
            shard_sets.append(fn)
    if shard_sets:
        print(f"checkpoint scan: skipping {len(shard_sets)} shard-set "
              f"round(s) in {model_dir} ({', '.join(sorted(shard_sets))}): "
              f"{SHARD_SET}", flush=True)
    out.sort(reverse=True)
    return out


def find_latest(model_dir: str) -> Optional[Tuple[int, str]]:
    """The newest ``%04d.model`` of ``model_dir`` as (round, path),
    unverified; None when there is none."""
    rounds = _scan_rounds(model_dir)
    return rounds[0] if rounds else None


def _sweep_orphans(model_dir: str, verbose: bool) -> None:
    """Delete the temp files of :func:`save_model` that a writer killed
    between its write and its rename left in ``model_dir``: never this
    process's own, and never one younger than TMP_SWEEP_MIN_AGE_S."""
    for fn in stream.listdir(model_dir):
        m = _TMP_RE.match(fn)
        if m is None or int(m.group(1) or m.group(2)) == os.getpid():
            continue
        path = os.path.join(model_dir, fn)
        try:
            if time.time() - stream.getmtime(path) < TMP_SWEEP_MIN_AGE_S:
                continue
            stream.remove(path)
            counters.inc("ckpt.tmp_swept")
            if verbose:
                print(f"checkpoint scan: swept orphan {fn}")
        except OSError:
            pass                  # a racing writer owns it; leave it


def find_latest_valid(model_dir: str, sweep_tmp: bool = True,
                      verbose: bool = False, want_blob: bool = False):
    """The scan of ``continue = 1``: the newest round of ``model_dir``
    that reads whole and verifies its digests, falling back round by
    round past torn or corrupt ones (each named with ``verbose``).
    ``sweep_tmp`` first deletes stale temp files (:func:`_sweep_orphans`).
    Returns (round, path), or with ``want_blob`` (round, path, blob),
    the blob being :func:`load_model`'s of the verified round, so a
    resume reads the archive once; None when no round verifies."""
    if sweep_tmp and stream.isdir(model_dir):
        _sweep_orphans(model_dir, verbose)
    for r, path in _scan_rounds(model_dir):
        try:
            blob = load_model(path)
        except (CheckpointCorrupt, OSError) as e:
            counters.inc("ckpt.skipped_invalid")
            if verbose:
                print(f"checkpoint scan: skipping invalid {path}: {e}")
            continue
        return (r, path, blob) if want_blob else (r, path)
    return None


# -- finetune ------------------------------------------------------------------

def _tree_matches(dst: Any, src: Any) -> bool:
    """Whether ``src`` holds every key of ``dst``, nested, with leaves of
    the same shapes."""
    if isinstance(dst, dict):
        return (isinstance(src, dict) and set(src) >= set(dst)
                and all(_tree_matches(v, src[k]) for k, v in dst.items()))
    return not isinstance(src, dict) and np.shape(src) == np.shape(dst)


def _tree_copy(dst: Any, src: Any) -> Any:
    """``src``'s leaves in ``dst``'s structure (``dst``'s keys only)."""
    if isinstance(dst, dict):
        return {k: _tree_copy(v, src[k]) for k, v in dst.items()}
    return np.asarray(src)


def copy_model_from(dst_params: Dict[str, Any], src_params: Dict[str, Any],
                    verbose: bool = True) -> Dict[str, Any]:
    """Finetune's copy by layer name, in the JAX layout: a layer of
    ``dst_params`` whose name is in ``src_params`` with every nested
    leaf of the same shape takes the source's arrays; every other layer
    keeps its own (its fresh initialisation). Layers go in name order,
    as the JAX package's params pytree holds them, so both print the
    same lines."""
    out = {}
    for lname, lp in sorted(dst_params.items()):
        if lname in src_params:
            if _tree_matches(lp, src_params[lname]):
                out[lname] = _tree_copy(lp, src_params[lname])
                if verbose:
                    print(f"CopyModelFrom: copied layer {lname!r}")
                continue
            if verbose:
                print(f"CopyModelFrom: shape mismatch, skip layer {lname!r}")
        out[lname] = lp
    return out
