"""Token streaming wire format: ndjson events inside HTTP/1.1 chunks
(the port of ``cxxnet_tpu/serve/lm/stream.py``, byte for byte).

A ``/generate`` response is ``Transfer-Encoding: chunked`` where each
chunk carries exactly one newline-terminated JSON event, flushed as the
token is produced — so a client observes time-to-first-token and
inter-token latency directly, and the loadgen's percentile accounting
needs no protocol beyond "read chunks, split lines".

Events (one object per line):

* ``{"event": "token", "index": i, "token": t}`` — the i-th generated
  token (0-based; index 0's arrival IS the TTFT mark)
* ``{"event": "done", "reason": "eos"|"length"|"cancelled", "tokens":
  [...], "version": "r0007", "seq": 12}`` — terminal; full token list
  so non-streaming clients can ignore the increments
* ``{"event": "error", "error": "...", "reason": "deadline"|...}`` —
  terminal failure after streaming began (the HTTP status is already
  200 by then; this is the only way to signal it)

The chunk framing helpers live here rather than in server.py so a test
can round-trip frames without a socket.
"""

from __future__ import annotations

import json
from typing import Dict, Iterator, List, Tuple

__all__ = ["encode_event", "decode_event", "chunk", "LAST_CHUNK",
           "iter_chunks", "split_events"]

#: terminating zero-length chunk per RFC 7230 §4.1
LAST_CHUNK = b"0\r\n\r\n"


def encode_event(event: Dict) -> bytes:
    """One ndjson line (the chunk payload) for a stream event."""
    return (json.dumps(event, separators=(",", ":")) + "\n").encode()


def decode_event(line: bytes) -> Dict:
    return json.loads(line.decode())


def chunk(payload: bytes) -> bytes:
    """Wrap a payload in HTTP/1.1 chunked framing (hex size line,
    CRLF, data, CRLF)."""
    return b"%X\r\n%s\r\n" % (len(payload), payload)


def iter_chunks(data: bytes) -> Iterator[bytes]:
    """Parse a chunked-encoded byte string back into payloads,
    stopping at (and validating) the terminal zero chunk. Raises
    ValueError on malformed framing — the framing test's oracle."""
    off = 0
    while True:
        eol = data.find(b"\r\n", off)
        if eol < 0:
            raise ValueError("chunked stream truncated in size line")
        size = int(data[off:eol], 16)
        off = eol + 2
        if size == 0:
            if data[off:off + 2] != b"\r\n":
                raise ValueError("missing final CRLF after last chunk")
            return
        payload = data[off:off + size]
        if len(payload) != size:
            raise ValueError("chunked stream truncated in payload")
        if data[off + size:off + size + 2] != b"\r\n":
            raise ValueError("missing CRLF after chunk payload")
        yield payload
        off += size + 2


def split_events(data: bytes) -> List[Dict]:
    """Decode a full chunked response body into its event list."""
    return [decode_event(p) for p in iter_chunks(data) if p.strip()]
