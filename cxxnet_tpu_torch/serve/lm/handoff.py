"""Prefill -> decode KV handoff over the data-service wire frames (the
port of ``cxxnet_tpu/serve/lm/handoff.py``).

One TCP connection per handed-off sequence, framed exactly like the
data-service shards (``data_service/wire.py``: magic + length-prefixed
header JSON + raw little-endian arrays; a bfloat16 cache travels as
2-byte void, ``serve/lm/engine.py``'s ``kv_to_numpy``):

  client (prefill engine)                 server (decode engine)
  ------------------------                -----------------------
  frame {type: prefill_handoff,    -->    recv_frame
         prompt_len, first_token,         scheduler.admit_handoff(...)
         max_new, deadline_ms}
         arrays: <layer>/k, <layer>/v
                                   <--    frame {type: event, data: {...}}
                                          ... one per stream event ...
                                   <--    terminal done/error event
  relay each event into the local StreamHandle; close.

The KV arrays ship at the FULL fixed table shape ``(T, block_size,
heads, head_dim)`` per layer — padding rows are scratch content the
receiving attention mask never reads — so the decode side's install
cell has one static shape and handoffs never recompile anything.

Every scheduler runs a listener (ephemeral port by default) whatever its
role, so a prefill/decode split mid-run is a pair of ``set_role`` calls,
not a restart.
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Dict, Tuple

import numpy as np

from ...data_service.wire import WireError, pack_frame, recv_frame
from ..batcher import Backpressure, DeadlineExceeded
from .blocks import PoolExhausted

__all__ = ["HandoffListener", "ship_prefill"]

#: relay read cap when the request carries no deadline of its own
_RELAY_TIMEOUT_S = 60.0


def _flatten_kv(kv: Dict[str, Dict[str, np.ndarray]]):
    arrays = []
    for name in sorted(kv):
        arrays.append((f"{name}/k", np.ascontiguousarray(kv[name]["k"])))
        arrays.append((f"{name}/v", np.ascontiguousarray(kv[name]["v"])))
    return arrays


def _unflatten_kv(arrays: Dict[str, np.ndarray]
                  ) -> Dict[str, Dict[str, np.ndarray]]:
    kv: Dict[str, Dict[str, np.ndarray]] = {}
    for key, arr in arrays.items():
        name, _, which = key.rpartition("/")
        if which not in ("k", "v") or not name:
            raise WireError(f"bad kv array name {key!r}")
        kv.setdefault(name, {})[which] = arr
    for name, ent in kv.items():
        if set(ent) != {"k", "v"}:
            raise WireError(f"kv layer {name!r} missing k or v")
    return kv


def ship_prefill(peer: Tuple[str, int], prompt_len: int, first_token: int,
                 max_new: int, deadline_ms: float,
                 kv: Dict[str, Dict[str, np.ndarray]], handle) -> None:
    """Send one prefilled sequence to ``peer`` and relay the decode
    engine's event stream into ``handle`` until the terminal event.
    Never raises — wire failures become an error event on the handle
    (the local blocks are already freed by the caller)."""
    header = {"type": "prefill_handoff", "prompt_len": int(prompt_len),
              "first_token": int(first_token), "max_new": int(max_new),
              "deadline_ms": float(deadline_ms)}
    deadline = time.monotonic() + (deadline_ms / 1e3 if deadline_ms
                                   else _RELAY_TIMEOUT_S)
    try:
        with socket.create_connection(peer, timeout=5.0) as sock:
            sock.sendall(pack_frame(header, _flatten_kv(kv)))
            while True:
                hdr, _ = recv_frame(sock, deadline=deadline)
                ev = hdr.get("data", {})
                if handle.cancelled and ev.get("event") == "token":
                    # client went away mid-relay: surface locally; the
                    # remote side finishes on its own budget
                    continue
                handle.push(ev)
                if ev.get("event") in ("done", "error"):
                    return
    except (WireError, OSError) as exc:
        handle.push({"event": "error", "reason": "handoff",
                     "error": f"prefill handoff to {peer[0]}:{peer[1]} "
                              f"failed: {exc}"})


class HandoffListener:
    """Per-scheduler TCP listener admitting handed-off sequences into the
    local scheduler and streaming their events back."""

    def __init__(self, scheduler, port: int = 0, host: str = "127.0.0.1"):
        self.scheduler = scheduler
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(8)
        self.addr: Tuple[str, int] = self._sock.getsockname()[:2]
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._accept_loop, name="lm-handoff-listener",
            daemon=True)
        self._conns: list = []

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        try:
            # close() alone does not wake a thread blocked in accept();
            # shutdown() does
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        for t in self._conns:
            t.join(timeout=5.0)
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return                      # socket closed: shutdown
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True, name="lm-handoff-conn")
            # prune finished handlers: a long-lived listener must not
            # hold one dead thread object per handoff it ever served
            self._conns = [c for c in self._conns if c.is_alive()]
            self._conns.append(t)
            t.start()

    def _serve_conn(self, conn: socket.socket) -> None:
        handle = None
        try:
            with conn:
                hdr, arrays = recv_frame(
                    conn, deadline=time.monotonic() + _RELAY_TIMEOUT_S)
                if hdr.get("type") != "prefill_handoff":
                    raise WireError(
                        f"unexpected handoff frame type {hdr.get('type')!r}")
                try:
                    handle = self.scheduler.admit_handoff(
                        hdr["prompt_len"], hdr["first_token"],
                        hdr["max_new"], hdr.get("deadline_ms", 0.0),
                        _unflatten_kv(arrays))
                except (Backpressure, PoolExhausted) as exc:
                    self._send_event(conn, {
                        "event": "error", "reason": "pressure",
                        "error": str(exc)})
                    return
                except (ValueError, DeadlineExceeded) as exc:
                    self._send_event(conn, {
                        "event": "error", "reason": "rejected",
                        "error": str(exc)})
                    return
                # relay budget follows the request's own deadline (the
                # scheduler evicts first and terminates the stream);
                # the flat cap only backstops deadline-less requests
                relay_s = _RELAY_TIMEOUT_S
                dl_ms = float(hdr.get("deadline_ms") or 0.0)
                if dl_ms:
                    relay_s = dl_ms / 1e3 + 5.0
                for ev in handle.events(timeout=relay_s):
                    self._send_event(conn, ev)
        except (WireError, OSError, TimeoutError):
            # peer gone or stream wedged: nothing to tell the peer, but
            # the local sequence must not keep a decode row + KV blocks
            # generating into a dead connection
            if handle is not None:
                handle.cancel()

    @staticmethod
    def _send_event(conn: socket.socket, ev: Dict) -> None:
        conn.sendall(pack_frame({"type": "event", "data": ev}))
