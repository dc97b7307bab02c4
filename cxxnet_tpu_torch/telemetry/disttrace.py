"""Distributed tracing: cross-process span propagation + fleet assembly
(the port of ``cxxnet_tpu/telemetry/disttrace.py``; the same wire form,
span names, counters and dump keys, so ``tools/trace_assemble.py``
merges dumps of either package).

``telemetry/trace.py`` records spans into a per-process ring; every one
of them dies at its process boundary, so "why was this step/request
slow" cannot be answered when the cause lives in another process (a
cold reader decode, a draining replica, a checkpoint barrier). This
module adds the Dapper/W3C layer on top:

* **TraceContext** — a W3C-traceparent-style context (128-bit trace id,
  64-bit span id, sampled flag) serialized as
  ``00-<32 hex>-<16 hex>-<01|00>`` and carried (a) in the data-service
  wire header (``tp`` field of request and response frames), (b) in
  serve HTTP ``traceparent`` headers from tools/loadgen.py through
  router -> queue -> infer -> respond, and (c) stamped into ledger
  events so the incident timeline joins traces.
* **DistTracer** (:data:`DISTTRACE`) — contextvar-propagated current
  span. New spans parent under the thread's current context by default;
  a context received over the wire parents a local subtree under a
  remote span. Span events land in the ordinary :data:`TRACER` ring
  (Chrome ``X`` events whose ``args`` carry
  ``trace_id``/``span_id``/``parent_span_id``), so one dump per host
  holds local AND distributed spans and ``tools/trace_assemble.py``
  merges N of them into one perfetto-loadable fleet trace with flow
  links and a critical-path report.
* **legacy-span stamping** — while a distributed span is current, every
  event the plain ``TRACER`` records on that thread (``train.h2d_stage``,
  ``serve.respond``, ...) is stamped with the current trace id and
  parented under the current span via the tracer's sink hook — existing
  instrumentation points join the tree without being rewritten.
* **clock alignment** — per-host span timestamps are
  ``perf_counter``-based and mean nothing across hosts. The tracer's
  export gains a wall-clock **anchor** record
  (``perf_counter``<->``time.time`` pairs, re-sampled opportunistically
  every ``anchor_s`` seconds at root-span boundaries — no background
  thread) plus **wire-handshake clock-offset probes**
  (:func:`estimate_offset`, fed by the data-service ``clock`` op), both
  carried in the dump's ``otherData`` for the assembler to correct with.
* **tail-exemplar capture** — with ``telemetry_trace_tail_pct = k``,
  only the slowest k% of root spans (train steps / serve requests,
  judged against a rolling window of same-name root durations) keep
  their full span tree; the rest are dropped at root close
  (``cxxnet_trace_tail_dropped_total``) and the run falls back to the
  existing cheap counters — always-on tracing stays within the
  "disabled = one attr check" overhead contract, and the ring holds
  exemplars instead of noise.

Overhead contract: with tracing disabled every entry point here is one
attribute check (``span`` falls through to the base tracer's shared
no-op span; ``current``/``current_traceparent`` return None), and an
unsampled trace adds ZERO wire bytes — the ``tp``/``traceparent``
carriers are only attached for sampled contexts (pinned by
tests/test_torch_disttrace.py).
"""

from __future__ import annotations

import contextvars
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from .registry import REGISTRY
from .trace import NULL_SPAN, TRACER

#: traceparent version prefix (only version 00 exists; an unknown
#: version is treated as "no context", per the W3C processing rules)
_TP_VERSION = "00"

#: bound on anchors/offsets carried in one dump — these are tiny
#: records, but a month-long run must not grow them without bound
_MAX_ANCHORS = 64

# the thread/task-local current span context; None = no active span
_CURRENT: "contextvars.ContextVar[Optional[TraceContext]]" = \
    contextvars.ContextVar("cxxnet_disttrace_current", default=None)


def _hex_ok(s: str, n: int) -> bool:
    if len(s) != n or s == "0" * n:
        return False
    try:
        int(s, 16)
        return True
    except ValueError:
        return False


def new_trace_id() -> str:
    """128 random bits as 32 hex chars (os.urandom — never time-based,
    so two processes starting the same microsecond cannot collide)."""
    return os.urandom(16).hex()


def new_span_id() -> str:
    return os.urandom(8).hex()


class _TailBuf:
    """Tail-exemplar buffer shared by every context of one root trace.
    The root closes it exactly once (keep -> ring, drop -> counter);
    children finishing AFTER that close — a batcher worker completing a
    request whose HTTP handler already timed out, i.e. precisely the
    slowest requests — follow the root's recorded fate instead of
    appending to a dead list and silently vanishing."""

    __slots__ = ("items", "kept", "lock")

    def __init__(self):
        self.items: List[Dict[str, Any]] = []
        self.kept: Optional[bool] = None    # None = still open
        self.lock = threading.Lock()

    def append_or_fate(self, ev: Dict[str, Any]) -> Optional[bool]:
        """Buffer ``ev`` while open (returns None); once closed, return
        the root's keep/drop decision for the caller to apply."""
        with self.lock:
            if self.kept is None:
                self.items.append(ev)
                return None
            return self.kept

    def close(self, kept: bool) -> List[Dict[str, Any]]:
        with self.lock:
            self.kept = kept
            items, self.items = self.items, []
            return items


class TraceContext:
    """One propagatable span identity. Immutable by convention; the
    private ``_buf`` rides along for tail-exemplar buffering and never
    crosses a process boundary."""

    __slots__ = ("trace_id", "span_id", "sampled", "_buf")

    def __init__(self, trace_id: str, span_id: str, sampled: bool = True,
                 buf: Optional[_TailBuf] = None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = sampled
        self._buf = buf

    def traceparent(self) -> str:
        """``00-<trace_id>-<span_id>-<flags>`` — the wire form."""
        return "%s-%s-%s-%s" % (_TP_VERSION, self.trace_id, self.span_id,
                                "01" if self.sampled else "00")

    def child(self, span_id: str) -> "TraceContext":
        """A new context one level down the tree, inheriting the trace
        id, sampled flag, and (process-local) tail buffer."""
        return TraceContext(self.trace_id, span_id, self.sampled,
                            buf=self._buf)

    def __repr__(self) -> str:  # debugging/test failure readability
        return "TraceContext(%s)" % self.traceparent()


def parse_traceparent(tp: Optional[str]) -> Optional["TraceContext"]:
    """Decode a traceparent string; None on anything malformed (an
    unparseable header means "no context", never an error — tracing
    must not reject traffic)."""
    if not tp or not isinstance(tp, str):
        return None
    parts = tp.strip().lower().split("-")
    if len(parts) != 4 or parts[0] != _TP_VERSION:
        return None
    _ver, trace_id, span_id, flags = parts
    if not (_hex_ok(trace_id, 32) and _hex_ok(span_id, 16)):
        return None
    if len(flags) != 2:
        return None
    try:
        sampled = bool(int(flags, 16) & 0x01)
    except ValueError:
        return None
    return TraceContext(trace_id, span_id, sampled)


def estimate_offset(t0: float, server_wall: float, t1: float
                    ) -> Tuple[float, float]:
    """Classic NTP-style midpoint estimate from one request/response
    handshake: the server read its clock somewhere between our send
    (``t0``) and receive (``t1``), so

        offset = server_wall - (t0 + t1) / 2,   rtt = t1 - t0

    with the true offset within ``rtt / 2`` of the estimate (the
    property tests/test_torch_disttrace.py pins under injected skew).
    ``server_wall + (-offset)`` maps server wall-clock onto ours."""
    rtt = max(0.0, t1 - t0)
    return server_wall - (t0 + t1) / 2.0, rtt


class _DistSpan:
    """Context manager for one distributed span: sets the current
    context on enter, records a Chrome ``X`` event (ring or tail
    buffer) on exit."""

    __slots__ = ("_tracer", "name", "cat", "args", "ctx", "parent_id",
                 "_root", "_t0", "_token")

    def __init__(self, tracer: "DistTracer", name: str, cat: str,
                 args: Optional[Dict[str, Any]], ctx: TraceContext,
                 parent_id: str, root: bool):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self.ctx = ctx
        self.parent_id = parent_id
        self._root = root

    def __enter__(self):
        self._t0 = time.perf_counter()
        self._token = _CURRENT.set(self.ctx)
        return self

    def __exit__(self, *exc):
        _CURRENT.reset(self._token)
        self._tracer._finish(self, time.perf_counter())
        return False


class _PassthroughSpan:
    """Current-context carrier for UNSAMPLED traces: descendants must
    inherit the unsampled flag (otherwise a child with no explicit
    parent would start a fresh sampled root mid-request), but nothing
    records."""

    __slots__ = ("ctx", "_token")

    def __init__(self, ctx: TraceContext):
        self.ctx = ctx

    def __enter__(self):
        self._token = _CURRENT.set(self.ctx)
        return self

    def __exit__(self, *exc):
        _CURRENT.reset(self._token)
        return False


class DistTracer:
    """Process-global distributed tracer (:data:`DISTTRACE`). Enabled
    together with the base tracer by ``telemetry_trace=path``
    (TelemetrySession); every entry point is one attribute check when
    disabled."""

    def __init__(self):
        self._enabled = False
        self.sample = 1.0
        self.tail_pct = 0.0
        self.tail_window = 128
        self.anchor_s = 30.0
        self._lock = threading.Lock()
        # per-root-name rolling duration windows for the tail threshold
        self._durations: Dict[str, deque] = {}
        self._last_anchor = 0.0
        self._c_tail_dropped = None
        self._c_spans = None

    # -- lifecycle -------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self, sample: float = 1.0, tail_pct: float = 0.0,
               tail_window: int = 128, anchor_s: float = 30.0) -> None:
        self.sample = min(1.0, max(0.0, float(sample)))
        self.tail_pct = min(99.9, max(0.0, float(tail_pct)))
        self.tail_window = max(2, int(tail_window))
        self.anchor_s = max(0.001, float(anchor_s))
        self._c_tail_dropped = REGISTRY.counter(
            "cxxnet_trace_tail_dropped_total",
            "Span events dropped by tail-exemplar retention (root was "
            "not among the slowest telemetry_trace_tail_pct%)")
        self._c_spans = REGISTRY.counter(
            "cxxnet_trace_spans_total",
            "Distributed spans recorded (kept) by this process")
        self._enabled = True
        TRACER.set_sink(self._absorb)
        self.anchor(force=True)

    def disable(self) -> None:
        self._enabled = False
        TRACER.set_sink(None)
        with self._lock:
            self._durations.clear()
            self._last_anchor = 0.0

    # -- context access --------------------------------------------------
    def current(self) -> Optional[TraceContext]:
        if not self._enabled:
            return None
        return _CURRENT.get()

    def current_traceparent(self) -> Optional[str]:
        """The wire form of the current context — None when disabled OR
        when the current trace is unsampled, so carriers (wire ``tp``
        field, HTTP header) add ZERO bytes for unsampled traffic."""
        if not self._enabled:
            return None
        ctx = _CURRENT.get()
        if ctx is None or not ctx.sampled:
            return None
        return ctx.traceparent()

    def current_trace_id(self) -> Optional[str]:
        """Sampled current trace id (ledger stamping)."""
        if not self._enabled:
            return None
        ctx = _CURRENT.get()
        if ctx is None or not ctx.sampled:
            return None
        return ctx.trace_id

    def extract(self, tp: Optional[str]) -> Optional[TraceContext]:
        """Parse an incoming carrier value; one attr check when off."""
        if not self._enabled:
            return None
        return parse_traceparent(tp)

    # -- span creation ---------------------------------------------------
    def span(self, name: str, cat: str = "",
             args: Optional[Dict[str, Any]] = None,
             parent: Optional[TraceContext] = None):
        """``with DISTTRACE.span("dataservice.fetch", ...):`` — a new
        span under ``parent`` (explicit context, e.g. extracted from the
        wire) or the thread's current span; with neither, a new ROOT
        trace (sampling decided here, tail-exemplar buffering armed
        here). Falls through to the base tracer's span when distributed
        tracing is off, so call sites keep working under plain
        ``TRACER.enable()``."""
        if not self._enabled:
            return TRACER.span(name, cat, args)
        root = False
        if parent is None:
            parent = _CURRENT.get()
        if parent is None:
            root = True
            trace_id = new_trace_id()
            if not self._sampled(trace_id):
                return _PassthroughSpan(
                    TraceContext(trace_id, new_span_id(), sampled=False))
            buf: Optional[_TailBuf] = \
                _TailBuf() if self.tail_pct > 0.0 else None
            ctx = TraceContext(trace_id, new_span_id(), True, buf=buf)
            parent_id = ""
        else:
            if not parent.sampled:
                return _PassthroughSpan(parent)
            ctx = parent.child(new_span_id())
            parent_id = parent.span_id
        return _DistSpan(self, name, cat, args, ctx, parent_id, root)

    def child_span(self, name: str, cat: str = "",
                   args: Optional[Dict[str, Any]] = None):
        """A span recorded ONLY under an active sampled context — for
        call sites reachable both inside a traced operation and from
        background opportunism (e.g. the reader's decode runs under a
        client's fetch AND from the readahead thread; the latter must
        not open a fresh root trace per prefetched batch)."""
        if not self._enabled:
            return NULL_SPAN
        ctx = _CURRENT.get()
        if ctx is None or not ctx.sampled:
            return NULL_SPAN
        return self.span(name, cat=cat, args=args)

    def record(self, name: str, t0: float, t1: float,
               parent: TraceContext, cat: str = "",
               args: Optional[Dict[str, Any]] = None) -> Optional[str]:
        """Record a completed child span from explicit
        ``perf_counter`` begin/end values under an explicit parent
        context — for durations measured across threads (the batcher's
        per-request queue-wait/infer attribution, whose parent lives on
        the HTTP handler thread). Returns the new span id."""
        if not self._enabled or parent is None or not parent.sampled:
            return None
        sid = new_span_id()
        ev = self._event(name, cat, t0, t1, args, parent.trace_id, sid,
                         parent.span_id)
        buf = parent._buf
        if buf is None:
            TRACER.push_event(ev)
            self._c_spans.inc()
        else:
            self._buffer_or_settle(buf, ev)
        return sid

    def _buffer_or_settle(self, buf: _TailBuf, ev: Dict[str, Any]
                          ) -> None:
        """Buffer a child event, or — when the root already closed the
        buffer (cross-thread child outliving its request) — apply the
        root's keep/drop fate directly."""
        fate = buf.append_or_fate(ev)
        if fate is None:
            return
        if fate:
            TRACER.push_event(ev)
            self._c_spans.inc()
        else:
            self._c_tail_dropped.inc()

    # -- internals -------------------------------------------------------
    def _sampled(self, trace_id: str) -> bool:
        if self.sample >= 1.0:
            return True
        if self.sample <= 0.0:
            return False
        # deterministic in the trace id, so every process that derives
        # the decision from a propagated context agrees
        return int(trace_id[:13], 16) / float(16 ** 13) < self.sample

    def _event(self, name: str, cat: str, t0: float, t1: float,
               args: Optional[Dict[str, Any]], trace_id: str,
               span_id: str, parent_id: str) -> Dict[str, Any]:
        a = dict(args) if args else {}
        a["trace_id"] = trace_id
        a["span_id"] = span_id
        if parent_id:
            a["parent_span_id"] = parent_id
        ev = {
            "name": name,
            "ph": "X",
            "ts": TRACER.to_ts_us(t0),
            "dur": max(t1 - t0, 0.0) * 1e6,
            "pid": os.getpid(),
            "tid": threading.get_ident(),
            "args": a,
        }
        if cat:
            ev["cat"] = cat
        return ev

    def _finish(self, span: _DistSpan, t1: float) -> None:
        ctx = span.ctx
        ev = self._event(span.name, span.cat, span._t0, t1, span.args,
                         ctx.trace_id, ctx.span_id, span.parent_id)
        buf = ctx._buf
        if buf is None:
            TRACER.push_event(ev)
            self._c_spans.inc()
            if span._root:
                self.anchor()
            return
        if not span._root:
            self._buffer_or_settle(buf, ev)
            return
        # root of a tail-exemplar tree: keep the whole buffered subtree
        # only when this root ranks in the slowest tail_pct% of recent
        # same-name roots; everything else degrades to the cheap
        # counters that are always on
        kept = self._tail_keep(span.name, ev["dur"])
        children = buf.close(kept)
        if kept:
            TRACER.push_event(ev)
            for child in children:
                TRACER.push_event(child)
            self._c_spans.inc(1 + len(children))
        else:
            self._c_tail_dropped.inc(1 + len(children))
        self.anchor()

    def _tail_keep(self, name: str, dur_us: float) -> bool:
        with self._lock:
            win = self._durations.get(name)
            if win is None:
                win = deque(maxlen=self.tail_window)
                self._durations[name] = win
            history = sorted(win)
            win.append(dur_us)
        # warm-up: with too little history every root is an exemplar
        if len(history) < 8:
            return True
        k = max(1, int(round(len(history) * self.tail_pct / 100.0)))
        return dur_us >= history[-k]

    def _absorb(self, ev: Dict[str, Any]) -> bool:
        """Base-tracer sink: stamp legacy TRACER events recorded while
        a distributed span is current with the trace id and the current
        span as parent (they become leaves of the tree), and divert
        them into the tail buffer when one is armed. Events with no
        current context pass through untouched."""
        ctx = _CURRENT.get()
        if ctx is None:
            return False
        if not ctx.sampled:
            return True      # an unsampled trace keeps the ring quiet
        args = ev.get("args")
        if args is None:
            args = ev["args"] = {}
        args.setdefault("trace_id", ctx.trace_id)
        args.setdefault("parent_span_id", ctx.span_id)
        buf = ctx._buf
        if buf is None:
            return False
        fate = buf.append_or_fate(ev)
        if fate is None:
            return True
        if fate:
            return False         # root kept: let the ring record it
        self._c_tail_dropped.inc()
        return True

    # -- clock alignment -------------------------------------------------
    def anchor(self, force: bool = False) -> None:
        """Record a ``perf_counter``<->``time.time`` pair into the
        dump's ``otherData.clock_anchors``. Opportunistic (called at
        root-span boundaries + enable/close) so no flusher thread is
        needed; re-sampling bounds perf_counter-vs-wall drift over long
        runs."""
        if not self._enabled:
            return
        now = time.perf_counter()
        with self._lock:
            if not force and now - self._last_anchor < self.anchor_s:
                return
            self._last_anchor = now
        rec = {"ts_us": round(TRACER.to_ts_us(now), 3),
               "wall": time.time()}
        with TRACER._lock:
            anchors = TRACER.extra_other.setdefault("clock_anchors", [])
            anchors.append(rec)
            del anchors[:-_MAX_ANCHORS]

    def clock_offset(self, peer: str, offset_s: float, rtt_s: float
                     ) -> None:
        """Record one wire-handshake probe result: ``peer``'s wall
        clock reads ``offset_s`` ahead of ours (uncertainty
        ``rtt_s/2``). Keyed by peer endpoint; the assembler matches it
        against the peer dump's ``service_endpoint`` identity."""
        if not self._enabled:
            return
        with TRACER._lock:
            offs = TRACER.extra_other.setdefault("clock_offsets", {})
            offs[str(peer)] = {"offset_s": round(float(offset_s), 6),
                               "rtt_s": round(float(rtt_s), 6),
                               "wall": round(time.time(), 3)}


def set_trace_identity(**fields: Any) -> None:
    """Stamp process identity (role, service endpoint, host index) into
    the trace dump's ``otherData`` so the assembler can name process
    tracks and match clock-offset probes to the peer that was probed."""
    with TRACER._lock:
        TRACER.extra_other.update({k: v for k, v in fields.items()
                                   if v is not None})


# the process-global distributed tracer
DISTTRACE = DistTracer()
