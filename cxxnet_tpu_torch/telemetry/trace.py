"""Span tracing over monotonic clocks, exported as Chrome-trace JSON (the
port of ``cxxnet_tpu/telemetry/trace.py``).

Spans of the two pipelines the port runs: the train step (data wait ->
stage -> dispatch -> device block -> eval -> checkpoint) and the serve
request (queue wait -> batch assembly -> infer -> respond), recorded
into a bounded ring and written as Chrome trace-event JSON
(``{"traceEvents": [...]}``) that Perfetto or chrome://tracing opens.

* disabled is free: a span point costs one attribute read when tracing
  is off (``span`` returns a shared no-op context manager);
* bounded: the ring keeps the newest ``capacity`` events and counts
  what it dropped (``cxxnet_trace_dropped_total``);
* one timeline: every timestamp is ``time.perf_counter()``, so a span
  recorded from explicit begin/end values on another thread (a
  request's queue wait) lands beside the context-manager spans.

Events carry the recording thread's id: nested spans on one thread
render as a flame stack, threads as parallel tracks (Chrome "X"
complete events). The distributed layer (:mod:`.disttrace`) hooks in
through one event sink and ``extra_other``, the keys it merges into the
dump's ``otherData`` (clock anchors, clock offsets, process identity),
which ``tools/trace_assemble.py`` reads.
"""

from __future__ import annotations

import copy
import json
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from .registry import REGISTRY


class _NullSpan:
    """Shared no-op context manager: the disabled tracer's span."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


#: shared no-op context manager, for hot paths that gate on
#: ``TRACER.enabled`` themselves
NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "name", "cat", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: Optional[Dict[str, Any]]):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._tracer.add_complete(self.name, self._t0,
                                  time.perf_counter(),
                                  cat=self.cat, args=self.args)
        return False


class Tracer:
    """Bounded ring of Chrome trace events; one process-global instance
    at :data:`TRACER`. ``enable()`` turns recording on (the
    ``telemetry_trace = <path>`` knob, through the session); every
    ``span`` / ``add_complete`` / ``instant`` before that is a no-op."""

    def __init__(self, capacity: int = 65536):
        self._lock = threading.Lock()
        self._buf: deque = deque(maxlen=capacity)
        self._enabled = False
        self._t0 = time.perf_counter()
        self.dropped = 0
        self._thread_names: Dict[int, str] = {}
        # the distributed layer's sink: sees each event before the ring
        # and may stamp it or consume it (returns True); None when off
        self._sink: Optional[Callable[[Dict[str, Any]], bool]] = None
        # keys merged into the dump's otherData (disttrace owns them)
        self.extra_other: Dict[str, Any] = {}
        self._c_dropped = REGISTRY.counter(
            "cxxnet_trace_dropped_total",
            "Trace events dropped on span-ring overflow")

    # -- lifecycle -------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self, capacity: Optional[int] = None) -> None:
        with self._lock:
            if capacity is not None and capacity != self._buf.maxlen:
                self._buf = deque(self._buf, maxlen=int(capacity))
            self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self._thread_names.clear()
            self.dropped = 0
            self._t0 = time.perf_counter()
            self.extra_other = {}

    def to_ts_us(self, perf_s: float) -> float:
        """A ``time.perf_counter()`` value on the events' timescale
        (microseconds since the ring's epoch)."""
        return (perf_s - self._t0) * 1e6

    # -- recording -------------------------------------------------------
    def span(self, name: str, cat: str = "",
             args: Optional[Dict[str, Any]] = None):
        """``with TRACER.span("serve.infer", args={...}):`` records one
        complete ("X") event on exit. Free when disabled."""
        if not self._enabled:
            return NULL_SPAN
        return _Span(self, name, cat, args)

    def add_complete(self, name: str, t0: float, t1: float,
                     cat: str = "",
                     args: Optional[Dict[str, Any]] = None,
                     tid: Optional[int] = None) -> None:
        """A span from explicit ``time.perf_counter()`` begin and end
        values: a duration measured across threads (queue wait) or
        before the tracer is asked."""
        if not self._enabled:
            return
        ev = {
            "name": name,
            "ph": "X",
            "ts": self.to_ts_us(t0),                # microseconds
            "dur": max(t1 - t0, 0.0) * 1e6,
            "pid": os.getpid(),
            "tid": tid if tid is not None else threading.get_ident(),
        }
        if cat:
            ev["cat"] = cat
        if args:
            ev["args"] = args
        self._push(ev)

    def instant(self, name: str, cat: str = "",
                args: Optional[Dict[str, Any]] = None) -> None:
        """A zero-duration marker (Chrome "i" event): rollbacks, profile
        start and stop."""
        if not self._enabled:
            return
        ev = {
            "name": name,
            "ph": "i",
            "s": "t",                                # thread-scoped
            "ts": (time.perf_counter() - self._t0) * 1e6,
            "pid": os.getpid(),
            "tid": threading.get_ident(),
        }
        if cat:
            ev["cat"] = cat
        if args:
            ev["args"] = args
        self._push(ev)

    def _push(self, ev: Dict[str, Any]) -> None:
        sink = self._sink
        if sink is not None and sink(ev):
            return
        self._push_raw(ev)

    def set_sink(self, sink: Optional[Callable[[Dict[str, Any]], bool]]
                 ) -> None:
        """Install (or clear) the distributed-trace sink of ``_push``."""
        self._sink = sink

    def push_event(self, ev: Dict[str, Any]) -> None:
        """Append one built event past the sink (the distributed layer's
        own, already stamped events)."""
        if not self._enabled:
            return
        self._push_raw(ev)

    def _push_raw(self, ev: Dict[str, Any]) -> None:
        t = threading.current_thread()
        overflow = False
        with self._lock:
            if t.ident is not None and t.ident not in self._thread_names:
                self._thread_names[t.ident] = t.name
            if len(self._buf) == self._buf.maxlen:
                self.dropped += 1
                overflow = True
            self._buf.append(ev)
        if overflow:
            self._c_dropped.inc()

    # -- reading / export ------------------------------------------------
    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._buf)

    def dump(self, path: str) -> int:
        """Write the ring as Chrome trace-event JSON, with thread-name
        metadata events so tracks carry names; returns the event
        count."""
        with self._lock:
            events = list(self._buf)
            names = dict(self._thread_names)
            dropped = self.dropped
            # deep: threads closing root spans go on adding anchors
            extra = copy.deepcopy(self.extra_other)
        meta = [{"name": "thread_name", "ph": "M", "pid": os.getpid(),
                 "tid": tid, "args": {"name": name}}
                for tid, name in sorted(names.items())]
        other = {"dropped_events": dropped,
                 "producer": "cxxnet_tpu_torch.telemetry",
                 "pid": os.getpid()}
        other.update(extra)
        doc = {
            "traceEvents": meta + events,
            "displayTimeUnit": "ms",
            "otherData": other,
        }
        d = os.path.dirname(os.path.abspath(path))
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            json.dump(doc, f)
        return len(events)


# the process-global tracer every instrumentation point consults
TRACER = Tracer()
