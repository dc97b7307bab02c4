"""The wire format of the input data service (the port of
``cxxnet_tpu/data_service/wire.py``; its frames are byte-equal to the
JAX package's, so a client of either package reads a reader of the
other). The LM plane's prefill -> decode KV handoff
(``serve/lm/handoff.py``) speaks the same frames.

A connection carries many requests. A request is one newline-terminated
JSON line (``{"op": "fetch", "epoch": e, "shard": s, "batch": b}``; also
``stats`` and ``meta``); the answer is one frame::

    uint32 magic 0xDA7AFEED | uint32 header_len | header_json | payloads

The header's ``arrays`` list describes every payload in order
(``{"name", "dtype", "shape"}``); payloads are raw C-order bytes
concatenated after the header, so a uint8 batch crosses at one byte a
pixel. ``status`` is ``ok`` (a batch follows), ``eos`` (the addressed
shard has fewer batches this epoch) or ``error`` (the ``error`` field
says why; the client takes it as a dead reader and fails over). A
batch's deferred normalization rides along: its scalars in the
header's ``norm``, a mean image as the ``norm_mean`` payload, and its
``extra_data`` arrays as the ``extra_0``, ``extra_1``, ... payloads.
Stdlib and numpy only.
"""

from __future__ import annotations

import json
import socket
import struct
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..io.data import DataBatch

__all__ = ["MAGIC", "MAX_FRAME_BYTES", "WireError", "batch_from",
           "pack_batch", "pack_eos", "pack_error", "pack_frame",
           "read_request", "recv_frame", "send_request"]

MAGIC = 0xDA7AFEED
_HDR = struct.Struct("<II")

#: sanity bound on one frame (header + payloads): a corrupt or foreign
#: peer must not make the reader allocate gigabytes from 4 wild bytes
MAX_FRAME_BYTES = 1 << 30

#: request lines are small JSON objects; a longer one is a protocol
#: violation
MAX_REQUEST_BYTES = 1 << 16


class WireError(OSError):
    """Malformed frame or protocol violation (an OSError, so one retry
    policy covers sockets and framing)."""


def pack_frame(header: Dict[str, Any],
               arrays: List[Tuple[str, np.ndarray]] = ()) -> bytes:
    """Serialize a frame; ``arrays`` entries are appended to (a copy of)
    the header's ``arrays`` descriptor list in order."""
    hdr = dict(header)
    descs = []
    payloads = []
    for name, arr in arrays:
        a = np.ascontiguousarray(arr)
        descs.append({"name": name, "dtype": a.dtype.str,
                      "shape": list(a.shape)})
        payloads.append(a.tobytes())
    hdr["arrays"] = descs
    hj = json.dumps(hdr, sort_keys=True).encode("utf-8")
    return b"".join([_HDR.pack(MAGIC, len(hj)), hj] + payloads)


def pack_batch(db: DataBatch, **meta: Any) -> bytes:
    """A batch as an ``ok`` frame (``meta`` goes into the header: the
    batch address)."""
    header: Dict[str, Any] = {"status": "ok",
                              "num_batch_padd": int(db.num_batch_padd)}
    header.update(meta)
    arrays: List[Tuple[str, np.ndarray]] = [
        ("data", db.data), ("label", db.label)]
    if db.inst_index is not None:
        arrays.append(("inst_index", np.asarray(db.inst_index)))
    for i, extra in enumerate(db.extra_data):
        arrays.append((f"extra_{i}", np.asarray(extra)))
    if db.norm is not None:
        norm = dict(db.norm)
        mean = norm.get("mean")
        if mean is not None:
            arrays.append(("norm_mean", np.asarray(mean)))
            norm["mean"] = "__payload__"
        header["norm"] = norm
    return pack_frame(header, arrays)


def pack_eos(**meta: Any) -> bytes:
    return pack_frame(dict(meta, status="eos"))


def pack_error(message: str, **meta: Any) -> bytes:
    return pack_frame(dict(meta, status="error", error=str(message)))


def batch_from(header: Dict[str, Any],
               arrays: Dict[str, np.ndarray]) -> DataBatch:
    """The batch an ``ok`` frame carries. A malformed frame raises
    :class:`WireError`, which the client's failover takes like a dead
    reader. The ``extra_<i>`` payloads are ``extra_data`` in order."""
    if "data" not in arrays or "label" not in arrays:
        raise WireError("frame lacks data/label payloads")
    try:
        extra = []
        while f"extra_{len(extra)}" in arrays:
            extra.append(arrays[f"extra_{len(extra)}"])
        norm = header.get("norm")
        if norm is not None:
            norm = dict(norm)
            if norm.get("mean") == "__payload__":
                if "norm_mean" not in arrays:
                    raise WireError("frame norm references a missing "
                                    "norm_mean payload")
                norm["mean"] = arrays["norm_mean"]
        return DataBatch(
            data=arrays["data"], label=arrays["label"],
            num_batch_padd=int(header.get("num_batch_padd", 0)),
            inst_index=arrays.get("inst_index"), extra_data=extra,
            norm=norm)
    except (KeyError, TypeError, ValueError) as e:
        raise WireError(f"malformed batch frame: {e}")


def send_request(sock: socket.socket, req: Dict[str, Any]) -> None:
    sock.sendall(json.dumps(req).encode("utf-8") + b"\n")


def read_request(rfile) -> Optional[Dict[str, Any]]:
    """One request line from a file-like socket reader; None when the
    connection closed cleanly."""
    line = rfile.readline(MAX_REQUEST_BYTES + 1)
    if not line:
        return None
    if len(line) > MAX_REQUEST_BYTES:
        raise WireError("oversized request line")
    try:
        req = json.loads(line.decode("utf-8"))
    except ValueError as e:
        raise WireError(f"unparseable request line: {e}")
    if not isinstance(req, dict):
        raise WireError("request is not a JSON object")
    return req


def _recv_exact(sock: socket.socket, n: int,
                deadline: Optional[float] = None) -> bytearray:
    """Read exactly ``n`` bytes or raise (a short read mid-frame is a
    torn frame, never a valid end); the buffer is writable, and so are
    the arrays :func:`recv_frame` views over it. ``deadline`` (a ``time.monotonic``
    instant) bounds the whole read: the per-call socket timeout alone
    restarts on every trickled chunk."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        if deadline is not None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise socket.timeout(
                    f"frame read deadline exceeded ({got}/{n} bytes)")
            sock.settimeout(remaining)
        k = sock.recv_into(view[got:], n - got)
        if k == 0:
            raise WireError(
                f"connection closed mid-frame ({got}/{n} bytes)")
        got += k
    return buf


def recv_frame(sock: socket.socket,
               deadline: Optional[float] = None
               ) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
    """Read one frame -> (header, {name: array})."""
    magic, hlen = _HDR.unpack(_recv_exact(sock, _HDR.size, deadline))
    if magic != MAGIC:
        raise WireError(f"bad frame magic 0x{magic:08x}")
    if hlen > MAX_FRAME_BYTES:
        raise WireError(f"frame header length {hlen} exceeds bound")
    try:
        header = json.loads(
            _recv_exact(sock, hlen, deadline).decode("utf-8"))
    except ValueError as e:
        raise WireError(f"unparseable frame header: {e}")
    arrays: Dict[str, np.ndarray] = {}
    total = 0
    for desc in header.get("arrays", ()):
        try:
            dtype = np.dtype(desc["dtype"])
            shape = tuple(int(d) for d in desc["shape"])
            name = desc["name"]
        except (KeyError, TypeError, ValueError) as e:
            raise WireError(f"malformed array descriptor {desc!r}: {e}")
        if any(d < 0 for d in shape):
            raise WireError(f"negative dimension in {desc!r}")
        nbytes = int(dtype.itemsize * int(np.prod(shape, dtype=np.int64)))
        total += nbytes
        if total > MAX_FRAME_BYTES:
            raise WireError("frame payloads exceed size bound")
        raw = _recv_exact(sock, nbytes, deadline)
        arrays[name] = np.frombuffer(raw, dtype).reshape(shape)
    return header, arrays
