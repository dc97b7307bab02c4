"""The trainer's side of the input data service (the port of
``cxxnet_tpu/data_service/client.py``): a ``data = train`` source.

:class:`ServiceIterator` speaks the batch-address protocol: an epoch
walks the seeded permutation of the shards round-robin
(``assign.epoch_permutation``: consecutive batches come from different
shards, and no epoch repeats another's order) and fetches each
``(epoch, shard, batch)`` from the reader fleet. To the round loop it is
a ``DataIter`` like any other.

The ladder, outermost first:

1. **retry**: each attempt at an endpoint runs under the ``io_retry_*``
   backoff, with the ``data.fetch`` failpoint inside the attempt;
2. **failover**: a dead owner hands its fetch to the surviving
   endpoints in config order, and the client re-derives the shard map
   with the movement-minimal ``assign.rebalance`` (every other client
   derives the same) and writes a ``dataservice_rebalance`` event;
3. **degrade**: when no reader answers, the iterator reads on from the
   local pipeline (``pipeline.LocalShardSource``: the same stream, so
   training goes on bit for bit), with one warning, the
   ``cxxnet_dataservice_degrades_total`` counter and a
   ``dataservice_degrade`` event; with ``data_service_local_fallback =
   0`` it raises :class:`NoReaderAvailable` instead.

:meth:`ServiceIterator.set_epoch` aligns the epoch with the round
counter, so ``continue = 1`` replays the epoch the uninterrupted run
would have read: the position lives in the client, never in a reader.
"""

from __future__ import annotations

import collections
import socket
import time
from typing import Dict, List, Optional, Tuple

from ..config import ConfigPairs, DataServiceConfig, parse_retry_policy
from ..io.data import DataBatch, DataIter
from ..io.proc import ThreadBufferIterator
from ..resilience import failpoints, retry_call
from ..resilience.failpoints import InjectedFault
from ..telemetry.disttrace import DISTTRACE, estimate_offset
from ..telemetry.ledger import LEDGER
from ..telemetry.registry import REGISTRY
from . import assign, pipeline, wire
from .pipeline import LocalShardSource

#: a clock probe runs on the train loop's thread: a partitioned reader
#: must not stall it for the whole fetch timeout
_CLOCK_PROBE_TIMEOUT_S = 0.25


class NoReaderAvailable(OSError):
    """Every configured reader endpoint failed for one fetch."""


class DataServiceClient:
    """Fetches batch frames from the reader fleet with retry, failover
    and client-side rebalance. One thread uses it (the one that draws
    the train batches)."""

    def __init__(self, svc: DataServiceConfig, pairs: ConfigPairs = ()):
        self.svc = svc
        self.endpoints = svc.endpoint_list
        if not self.endpoints:
            raise ValueError("DataServiceClient needs data_service "
                             "endpoints")
        self.n_shards = svc.n_shards
        self.retry = parse_retry_policy(list(pairs))
        self.assignment = assign.assign_shards(
            [1] * self.n_shards, self.endpoints)
        self._owners = assign.owner_map(self.assignment)
        self._dead: List[str] = []
        self._socks: Dict[str, socket.socket] = {}
        self.failovers = 0
        self._c_failover = REGISTRY.counter(
            "cxxnet_dataservice_failovers_total",
            "Fetches that left their shard's owner for a surviving "
            "reader")

    @property
    def live(self) -> List[str]:
        return [e for e in self.endpoints if e not in self._dead]

    # -- transport ------------------------------------------------------------
    def _conn(self, endpoint: str) -> socket.socket:
        sock = self._socks.get(endpoint)
        if sock is not None:
            return sock
        host, port = self.svc.split_endpoint(endpoint)
        sock = socket.create_connection(
            (host, port), timeout=self.svc.timeout_ms / 1e3)
        self._socks[endpoint] = sock
        return sock

    def _drop_conn(self, endpoint: str) -> None:
        sock = self._socks.pop(endpoint, None)
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def _request(self, endpoint: str, req: Dict) -> Tuple[Dict, Dict]:
        """One request and its answer on (a cached connection to) one
        endpoint; a failure closes the connection and raises."""
        failpoints.check("data.fetch", exc=InjectedFault)
        try:
            sock = self._conn(endpoint)
            wire.send_request(sock, req)
            return wire.recv_frame(sock)
        except OSError:
            self._drop_conn(endpoint)
            raise

    def _request_retrying(self, endpoint: str, req: Dict
                          ) -> Tuple[Dict, Dict]:
        pol = self.retry
        return retry_call(
            lambda: self._request(endpoint, req),
            what=f"data.fetch {endpoint}",
            attempts=pol.attempts, base_delay_s=pol.base_delay_s,
            max_delay_s=pol.max_delay_s, jitter=pol.jitter,
            retry_on=(OSError, InjectedFault))

    # -- membership -----------------------------------------------------------
    def _mark_dead(self, endpoint: str) -> None:
        if endpoint in self._dead:
            return
        self._dead.append(endpoint)
        live = self.live
        if not live:
            return
        new = assign.rebalance(self.assignment, [1] * self.n_shards,
                               live)
        moved = sorted(assign.moved_shards(self.assignment, new))
        self.assignment = new
        self._owners = assign.owner_map(new)
        LEDGER.event("dataservice_rebalance", dead=endpoint,
                     live=live, moved=moved)

    # -- the fetch ------------------------------------------------------------
    def fetch(self, epoch: int, shard: int, batch: int
              ) -> Tuple[Dict, Optional[DataBatch]]:
        """(header, batch) of one address; the batch is None at the end
        of the shard. Raises :class:`NoReaderAvailable` when every
        endpoint is down (what degrades the iterator).

        Under distributed tracing the fetch is the ``dataservice.fetch``
        span, whose context rides the request's ``tp`` field, so the
        reader's serve and decode spans parent under it; an unsampled
        trace adds no wire bytes."""
        if not DISTTRACE.enabled:
            return self._fetch(epoch, shard, batch, None)
        with DISTTRACE.span("dataservice.fetch", cat="dataservice",
                            args={"epoch": int(epoch),
                                  "shard": int(shard),
                                  "batch": int(batch)}):
            return self._fetch(epoch, shard, batch,
                               DISTTRACE.current_traceparent())

    def _fetch(self, epoch: int, shard: int, batch: int,
               tp: Optional[str]) -> Tuple[Dict, Optional[DataBatch]]:
        req = {"op": "fetch", "epoch": int(epoch), "shard": int(shard),
               "batch": int(batch)}
        if tp:
            req["tp"] = tp
        owner = self._owners.get(shard, self.endpoints[0])
        last_exc: Optional[BaseException] = None
        for i, ep in enumerate(assign.failover_order(self.live, owner)):
            try:
                header, arrays = self._request_retrying(ep, req)
                status = header.get("status")
                if status == "error":
                    # an answering reader whose pipeline fails counts
                    # against the endpoint like a dead one
                    raise OSError(
                        f"{ep}: remote error: {header.get('error')}")
                # a malformed ok frame is an endpoint failure too
                batch = None if status == "eos" else \
                    wire.batch_from(header, arrays)
            except (OSError, InjectedFault) as e:
                last_exc = e
                self._mark_dead(ep)
                continue
            if i > 0:
                self.failovers += 1
                self._c_failover.inc()
            return header, batch
        raise NoReaderAvailable(
            f"no data_service reader answered for (epoch={epoch}, "
            f"shard={shard}, batch={batch}); last error: {last_exc}")

    def stats(self, endpoint: str) -> Dict:
        """A reader's ``served``, ``cache_hits``, ``errors`` and
        ``cache_entries``."""
        header, _ = self._request_retrying(endpoint, {"op": "stats"})
        return header

    def probe_clock(self, endpoint: str) -> Optional[Tuple[float, float]]:
        """One clock-offset probe of a reader (the ``clock`` op): the
        NTP-style midpoint estimate of its wall clock against ours,
        recorded into the trace dump's ``otherData.clock_offsets`` for
        tools/trace_assemble.py. On a socket of its own, capped at
        ``_CLOCK_PROBE_TIMEOUT_S`` (it runs on the train loop's thread
        at an epoch's start), with no ``data.fetch`` failpoint check;
        a reader that does not answer gives None."""
        cap = min(_CLOCK_PROBE_TIMEOUT_S, self.svc.timeout_ms / 1e3)
        host, port = self.svc.split_endpoint(endpoint)
        deadline = time.monotonic() + cap
        try:
            with socket.create_connection((host, port),
                                          timeout=cap) as sock:
                t0 = time.time()
                wire.send_request(sock, {"op": "clock"})
                header, _ = wire.recv_frame(sock, deadline=deadline)
                t1 = time.time()
        except OSError:
            return None
        wall = header.get("wall")
        if not isinstance(wall, (int, float)):
            return None
        offset, rtt = estimate_offset(t0, float(wall), t1)
        DISTTRACE.clock_offset(endpoint, offset, rtt)
        return offset, rtt

    def close(self) -> None:
        for ep in list(self._socks):
            self._drop_conn(ep)


class ServiceIterator(DataIter):
    """The train-data source over the service, or, with ``data_service
    = local``, the same global-shuffle orchestration in this process
    (the control stream and the degrade target)."""

    def __init__(self, pairs: ConfigPairs, svc: DataServiceConfig):
        self.pairs = list(pairs)
        self.svc = svc
        self.n_shards = svc.n_shards
        # checked now, even with readers: the degrade path builds local
        # pipelines mid-run, too late to learn the section cannot shard
        pipeline.check_shardable(self.pairs, self.n_shards)
        self.client: Optional[DataServiceClient] = None
        if not svc.local_only:
            self.client = DataServiceClient(svc, self.pairs)
        self._local: Optional[LocalShardSource] = None
        if self.client is None:
            self._local = LocalShardSource(self.pairs, self.n_shards,
                                           svc.seed)
        self.epoch = -1
        self._next_epoch = 0
        self._live: "collections.deque[int]" = collections.deque()
        self._counters: Dict[int, int] = {}
        self.degraded = False
        self._h_fetch = REGISTRY.histogram(
            "cxxnet_dataservice_fetch_latency_seconds",
            "Client-observed batch fetch latency (service path)")
        self._c_batches = REGISTRY.counter(
            "cxxnet_dataservice_batches_total",
            "Batches delivered to the trainer by source",
            labels=("source",))
        self._c_degrade = REGISTRY.counter(
            "cxxnet_dataservice_degrades_total",
            "Service clients that fell back to the local pipeline")
        super().__init__([])

    def set_epoch(self, epoch: int) -> None:
        """The epoch of the next :meth:`before_first` (``main.run`` gives
        the first round, so a resumed run replays the right epoch)."""
        self._next_epoch = int(epoch)

    def before_first(self) -> None:
        self.epoch = self._next_epoch
        self._next_epoch = self.epoch + 1
        order = assign.epoch_permutation(self.svc.seed, self.epoch,
                                         self.n_shards)
        self._live = collections.deque(order)
        self._counters = {s: 0 for s in order}
        # the readers' clock offsets, probed once an epoch for the trace
        # assembly (free with tracing off, best-effort with a reader down)
        if DISTTRACE.enabled and self.client is not None:
            for ep in self.client.live:
                self.client.probe_clock(ep)

    # -- the ladder -----------------------------------------------------------
    def _degrade(self, why: str) -> None:
        if self.client is not None:
            self.client.close()
            self.client = None
        if not self.svc.local_fallback:
            raise NoReaderAvailable(
                f"data_service readers unavailable and "
                f"data_service_local_fallback=0: {why}")
        self.degraded = True
        self._c_degrade.inc()
        LEDGER.event("dataservice_degrade", reason=why)
        # once: the client is gone, and every later batch is local
        print(f"WARNING: data_service degraded to the local input "
              f"pipeline ({why}); decode is per-process again until "
              "restart", flush=True)
        if self._local is None:
            self._local = LocalShardSource(self.pairs, self.n_shards,
                                           self.svc.seed)

    def _get(self, epoch: int, shard: int, b: int
             ) -> Optional[DataBatch]:
        if self.client is not None:
            t0 = time.perf_counter()
            try:
                _header, batch = self.client.fetch(epoch, shard, b)
            except NoReaderAvailable as e:
                self._degrade(str(e))
            else:
                self._h_fetch.observe(time.perf_counter() - t0)
                if batch is not None:
                    self._c_batches.labels("service").inc()
                return batch
        if self._local is None:
            self._local = LocalShardSource(self.pairs, self.n_shards,
                                           self.svc.seed)
        batch = self._local.get(epoch, shard, b)
        if batch is not None:
            self._c_batches.labels("local").inc()
        return batch

    def next(self) -> Optional[DataBatch]:
        while self._live:
            shard = self._live[0]
            batch = self._get(self.epoch, shard, self._counters[shard])
            if batch is None:
                self._live.popleft()
                continue
            self._counters[shard] += 1
            self._live.rotate(-1)
            return batch
        return None

    def close(self) -> None:
        if self.client is not None:
            self.client.close()
        if self._local is not None:
            self._local.close()


class PrefetchedServiceIterator(ThreadBufferIterator):
    """Client-side prefetch over the service stream: a producer thread
    keeps ``data_service_prefetch`` batches on the wire ahead of the
    trainer, as the threadbuffer hides a local decode. ``set_epoch``
    reaches the wrapped :class:`ServiceIterator`; :meth:`close` (the
    threadbuffer's) joins the producer and closes it."""

    def __init__(self, service_it: ServiceIterator, depth: int):
        self.service = service_it
        super().__init__([("buffer_size", str(max(1, int(depth))))],
                         base=service_it)

    def set_epoch(self, epoch: int) -> None:
        self.service.set_epoch(epoch)


def build_service_iterator(pairs: ConfigPairs,
                           svc: DataServiceConfig) -> DataIter:
    """The train section's iterator over the service: wrapped in the
    client's prefetch thread (``data_service_prefetch``) with readers;
    bare with ``data_service = local``, the control stream."""
    if not svc.enabled:
        raise ValueError("data_service is not configured")
    clash = sorted({k for k, _v in pairs
                    if k in ("dist_num_worker", "dist_worker_rank")})
    if clash:
        # the service owns the shard dimension, and every client reads
        # the whole global stream
        raise ValueError(
            f"data_service and {'/'.join(clash)} cannot compose: the "
            "service owns data sharding (each client consumes the full "
            "globally-shuffled stream; remove the dist_* keys)")
    it = ServiceIterator(pairs, svc)
    it.init()
    if svc.prefetch > 0 and not svc.local_only:
        return PrefetchedServiceIterator(it, svc.prefetch)
    return it
