"""The reader process of the input data service (the port of
``cxxnet_tpu/data_service/reader.py``): it owns shards of the packed
records and serves decoded batches.

One reader is one ``task = data_reader`` process. It derives the shards
it owns from the same assignment every member of the fleet computes
(``assign.assign_shards`` over the configured endpoint list), runs the
ordinary decode, augment and batch pipeline a shard
(``pipeline.LocalShardSource``) and serves its frames (``wire``) over a
threading TCP server. Frames go into a bounded LRU cache keyed by
``(epoch, shard, batch)``, so a second trainer (or a data-parallel peer)
is served from the cache, and a readahead thread decodes the next
batches of a stream while the current one is on the wire.

Ownership routes the readahead; it is no wall: a reader serves any
shard addressed to it, which is what lets clients fail over to the
survivors when a reader dies.

The ``data.serve`` failpoint fires a request and answers an ``error``
frame, as a failing reader does. Telemetry, under the JAX package's
names: ``cxxnet_dataservice_served_total``,
``cxxnet_dataservice_cache_hits_total``,
``cxxnet_dataservice_decode_seconds`` and
``cxxnet_dataservice_cache_entries`` (label ``reader``), the
``dataservice_start`` / ``dataservice_stop`` ledger events and, with
``data_service_status_dir``, an atomically written
``reader_<i>.json`` status file.

JPEG records decode on the device the reader's ``dev`` names (nvJPEG on
a card, libjpeg with ``dev = cpu``); a reader that cannot decode a
record answers an error frame, which the client's failover ladder takes.
"""

from __future__ import annotations

import collections
import json
import os
import queue
import signal
import socketserver
import threading
import time
import weakref
from typing import Dict, Optional, Tuple

from ..config import ConfigPairs, DataServiceConfig
from ..io import stream
from ..resilience import failpoints
from ..telemetry.disttrace import DISTTRACE, set_trace_identity
from ..telemetry.ledger import LEDGER
from ..telemetry.registry import REGISTRY
from ..telemetry.trace import TRACER
from . import assign, wire
from .pipeline import LocalShardSource

Address = Tuple[int, int, int]

#: the cache's mark of an exhausted stream position
_EOS = b"__eos__"


class DataReaderServer:
    """Serve decoded batch frames for one reader of the fleet."""

    def __init__(self, pairs: ConfigPairs, svc: DataServiceConfig,
                 *, index: Optional[int] = None, silent: bool = True):
        eps = svc.endpoint_list
        if not eps:
            raise ValueError(
                "data_reader requires data_service = host:port[,...]")
        idx = svc.reader if index is None else index
        if idx < 0:
            if len(eps) != 1:
                raise ValueError(
                    "data_service_reader must name this reader's index "
                    f"into the {len(eps)}-endpoint data_service list")
            idx = 0
        if not 0 <= idx < len(eps):
            raise ValueError(
                f"data_service_reader={idx} outside the "
                f"{len(eps)}-endpoint data_service list")
        self.svc = svc
        self.index = idx
        self.endpoint = eps[idx]
        self.endpoints = eps
        self.n_shards = svc.n_shards
        self.owned = assign.assign_shards(
            [1] * self.n_shards, eps)[self.endpoint]
        self.silent = silent
        self.source = LocalShardSource(pairs, self.n_shards, svc.seed)
        # three tiers of locks, so a cold decode never stalls a cache
        # hit: _cache_lock guards dict operations only, one lock a shard
        # serializes that shard's pipeline cursor, _stats_lock the plain
        # counters the handler threads bump
        self._cache_lock = threading.Lock()
        self._shard_locks = [threading.Lock()
                             for _ in range(self.n_shards)]
        self._stats_lock = threading.Lock()
        self._cache: "collections.OrderedDict[Address, bytes]" = \
            collections.OrderedDict()
        self._cap = max(1, svc.cache_batches)
        self._stop = threading.Event()
        self._server: Optional[socketserver.ThreadingTCPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._ra_thread: Optional[threading.Thread] = None
        self._ra_queue: "queue.Queue[Optional[Address]]" = queue.Queue(
            maxsize=256)
        self.port: Optional[int] = None
        self.served = 0
        self.cache_hits = 0
        self.errors = 0
        lab = (str(idx),)
        self._c_served = REGISTRY.counter(
            "cxxnet_dataservice_served_total",
            "Batch frames served by this reader", labels=("reader",)
        ).labels(*lab)
        self._c_hits = REGISTRY.counter(
            "cxxnet_dataservice_cache_hits_total",
            "Served frames answered from the prefetch cache",
            labels=("reader",)).labels(*lab)
        self._h_decode = REGISTRY.histogram(
            "cxxnet_dataservice_decode_seconds",
            "Pipeline decode latency per cached batch",
            labels=("reader",)).labels(*lab)
        g = REGISTRY.gauge(
            "cxxnet_dataservice_cache_entries",
            "Frames resident in the reader prefetch cache",
            labels=("reader",)).labels(*lab)
        ref = weakref.ref(self)

        def _entries() -> int:
            s = ref()
            return len(s._cache) if s is not None else 0
        g.set_function(_entries)

    # -- cache and decode -----------------------------------------------------
    def _cache_get(self, addr: Address) -> Optional[bytes]:
        with self._cache_lock:
            frame = self._cache.get(addr)
            if frame is not None:
                self._cache.move_to_end(addr)
            return frame

    def _cache_put(self, addr: Address, frame: bytes) -> None:
        with self._cache_lock:
            self._cache[addr] = frame
            self._cache.move_to_end(addr)
            while len(self._cache) > self._cap:
                self._cache.popitem(last=False)

    def _decode(self, addr: Address) -> bytes:
        """Decode (or find again) the addressed frame into the cache,
        under the shard's lock: two connections must not race one
        cursor, but one shard's decode must not block another's."""
        epoch, shard, b = addr
        with self._shard_locks[shard]:
            frame = self._cache_get(addr)
            if frame is not None:
                return frame
            t0 = time.perf_counter()
            # recorded only under a client's propagated fetch context:
            # the readahead thread's decodes open no root trace
            with DISTTRACE.child_span("dataservice.decode",
                                      cat="dataservice",
                                      args={"epoch": epoch,
                                            "shard": shard, "batch": b}):
                batch = self.source.get(epoch, shard, b)
            self._h_decode.observe(time.perf_counter() - t0)
            if batch is None:
                frame = _EOS
            else:
                frame = wire.pack_batch(batch, epoch=epoch, shard=shard,
                                        batch=b)
            self._cache_put(addr, frame)
            return frame

    def _readahead_hint(self, addr: Address) -> None:
        epoch, shard, b = addr
        for ahead in range(1, max(0, self.svc.readahead) + 1):
            try:
                self._ra_queue.put_nowait((epoch, shard, b + ahead))
            except queue.Full:
                return

    def _readahead_loop(self) -> None:
        while not self._stop.is_set():
            try:
                addr = self._ra_queue.get(timeout=0.1)
            except queue.Empty:
                continue
            if addr is None:
                return
            if self._cache_get(addr) is None:
                try:
                    self._decode(addr)
                except Exception:
                    # a decode fault surfaces on the serving path, where
                    # a client is there to hear of it
                    pass

    # -- requests -------------------------------------------------------------
    def _count_error(self) -> None:
        with self._stats_lock:
            self.errors += 1

    def _serve_fetch(self, addr: Address) -> Tuple[bytes, bool]:
        """The frame of ``addr`` and whether the cache held it."""
        hit = self._cache_get(addr)
        frame = hit if hit is not None else self._decode(addr)
        self._readahead_hint(addr)
        with self._stats_lock:
            self.served += 1
            if hit is not None:
                self.cache_hits += 1
        self._c_served.inc()
        if hit is not None:
            self._c_hits.inc()
        return frame, hit is not None

    def _respond(self, req: Dict) -> bytes:
        op = req.get("op")
        if op == "fetch":
            try:
                addr = (int(req["epoch"]), int(req["shard"]),
                        int(req["batch"]))
            except (KeyError, TypeError, ValueError):
                self._count_error()
                return wire.pack_error(f"malformed fetch request: {req}")
            if not 0 <= addr[1] < self.n_shards:
                self._count_error()
                return wire.pack_error(
                    f"shard {addr[1]} outside [0, {self.n_shards})")
            if failpoints.fire("data.serve"):
                self._count_error()
                return wire.pack_error(
                    "injected fault at failpoint 'data.serve'",
                    epoch=addr[0], shard=addr[1], batch=addr[2])
            # a request carrying a sampled ``tp`` parents this reader's
            # serve and decode spans under the trainer's fetch span
            ctx = (DISTTRACE.extract(req.get("tp"))
                   if DISTTRACE.enabled else None)
            if ctx is None:
                frame, _hit = self._serve_fetch(addr)
            else:
                with DISTTRACE.span("dataservice.serve",
                                    cat="dataservice", parent=ctx,
                                    args={"epoch": addr[0],
                                          "shard": addr[1],
                                          "batch": addr[2],
                                          "reader": self.index}) as sp:
                    frame, hit = self._serve_fetch(addr)
                    sp_args = getattr(sp, "args", None)
                    if sp_args is not None:
                        sp_args["cache_hit"] = hit
            if frame is _EOS:
                return wire.pack_eos(epoch=addr[0], shard=addr[1],
                                     batch=addr[2])
            return frame
        if op == "clock":
            # the clock probe (client.probe_clock): our wall clock,
            # between the client's send and receive times
            return wire.pack_frame(dict(
                status="ok", wall=time.time(), reader=self.index))
        if op == "stats":
            with self._stats_lock:
                return wire.pack_frame(dict(
                    status="ok", reader=self.index, served=self.served,
                    cache_hits=self.cache_hits, errors=self.errors,
                    cache_entries=len(self._cache)))
        if op == "meta":
            return wire.pack_frame(dict(
                status="ok", reader=self.index, endpoint=self.endpoint,
                n_shards=self.n_shards, owned=list(self.owned),
                endpoints=list(self.endpoints)))
        self._count_error()
        return wire.pack_error(f"unknown op {op!r}")

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> None:
        host, port = self.svc.split_endpoint(self.endpoint)
        outer = self

        class _Handler(socketserver.StreamRequestHandler):
            def handle(self) -> None:
                while not outer._stop.is_set():
                    try:
                        req = wire.read_request(self.rfile)
                    except (wire.WireError, OSError):
                        return
                    if req is None:
                        return
                    try:
                        frame = outer._respond(req)
                    except Exception as e:      # the server lives on
                        outer._count_error()
                        frame = wire.pack_error(
                            f"{type(e).__name__}: {e}")
                    try:
                        self.wfile.write(frame)
                    except OSError:
                        return

        class _Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = _Server((host, port), _Handler)
        self.port = self._server.server_address[1]
        if TRACER.enabled:
            # names this process's track in the assembled trace and keys
            # the clients' clock probes (by the configured endpoint)
            set_trace_identity(role="data_reader", reader=self.index,
                               service_endpoint=self.endpoint)
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name=f"ds-reader-{self.index}")
        self._thread.start()
        self._ra_thread = threading.Thread(
            target=self._readahead_loop, daemon=True,
            name=f"ds-readahead-{self.index}")
        self._ra_thread.start()
        LEDGER.event("dataservice_start", reader=self.index,
                     endpoint=self.endpoint, port=self.port,
                     n_shards=self.n_shards, owned=list(self.owned),
                     cache_batches=self._cap)
        self._publish_status()
        if not self.silent:
            print(f"data_reader {self.index}: serving shards "
                  f"{self.owned} of {self.n_shards} on "
                  f"{host}:{self.port} (cache {self._cap} batches)",
                  flush=True)

    def _publish_status(self) -> None:
        """The ``reader_<i>.json`` of ``data_service_status_dir``, written
        atomically: who owns what, and the counts so far."""
        d = self.svc.status_dir
        if not d:
            return
        stream.makedirs(d)
        payload = json.dumps({
            "reader": self.index, "endpoint": self.endpoint,
            "port": self.port,
            "n_shards": self.n_shards, "owned": list(self.owned),
            "served": self.served, "cache_hits": self.cache_hits,
            "pid": os.getpid(),
        }, sort_keys=True).encode("utf-8")
        stream.write_bytes_atomic(
            os.path.join(d, f"reader_{self.index}.json"), payload)

    def stop(self) -> None:
        if self._stop.is_set():
            return
        self._stop.set()
        try:
            self._ra_queue.put_nowait(None)
        except queue.Full:
            pass
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        if self._ra_thread is not None:
            self._ra_thread.join(timeout=5.0)
        self.source.close()
        self._publish_status()
        LEDGER.event("dataservice_stop", reader=self.index,
                     served=self.served, cache_hits=self.cache_hits,
                     errors=self.errors)
        if not self.silent:
            print(f"data_reader {self.index}: stopped after serving "
                  f"{self.served} frames ({self.cache_hits} cache hits)",
                  flush=True)

    def serve_until_interrupt(self) -> None:
        """Block until SIGTERM or SIGINT (the handlers only set an
        event; the main thread stops the server)."""
        ev = threading.Event()

        def _handler(signum, frame):
            ev.set()
        prev_term = signal.signal(signal.SIGTERM, _handler)
        prev_int = signal.signal(signal.SIGINT, _handler)
        try:
            while not ev.wait(0.2):
                pass
        finally:
            signal.signal(signal.SIGTERM, prev_term)
            signal.signal(signal.SIGINT, prev_int)
            self.stop()
