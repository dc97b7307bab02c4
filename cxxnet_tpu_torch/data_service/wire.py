"""Length-prefixed frames of the data-service wire protocol (the port of
the frame half of ``cxxnet_tpu/data_service/wire.py``; the frames are
byte-equal to the JAX package's). The LM plane's prefill -> decode KV
handoff (``serve/lm/handoff.py``) speaks them; the data service itself
waits for ROADMAP Queue A 2. A frame is::

    uint32 magic 0xDA7AFEED | uint32 header_len | header_json | payloads

The header's ``arrays`` list describes every payload in order
(``{"name", "dtype", "shape"}``); payloads are raw C-order bytes
concatenated after the header. Stdlib and numpy only.
"""

from __future__ import annotations

import json
import socket
import struct
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["MAGIC", "MAX_FRAME_BYTES", "WireError", "pack_frame",
           "recv_frame"]

MAGIC = 0xDA7AFEED
_HDR = struct.Struct("<II")

#: sanity bound on one frame (header + payloads): a corrupt or foreign
#: peer must not make the reader allocate gigabytes from 4 wild bytes
MAX_FRAME_BYTES = 1 << 30


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


def _recv_exact(sock: socket.socket, n: int,
                deadline: Optional[float] = None) -> bytes:
    """Read exactly ``n`` bytes or raise (a short read mid-frame is a
    torn frame, never a valid end). ``deadline`` (a ``time.monotonic``
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
    return bytes(buf)


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
