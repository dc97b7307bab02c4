"""Run ledger: an append-only, schema-versioned JSONL event stream a run
(the port's copy of ``cxxnet_tpu/telemetry/ledger.py``).

The registry answers "what are the numbers now"; the ledger answers
"what happened to this run": when it started and with which config,
which rounds completed, when a checkpoint landed, when the sentinel
tripped and what it rolled back to, when the serve breaker opened, a
replica drained or a canary was promoted. One line an event:

    {"schema": 1, "ts": <unix>, "run_id": "...", "host": 0,
     "event": "<type>", ...event fields}

* append-only, atomic lines: every write is one ``open(path, "a")``
  and one ``write()`` of one line under the O_APPEND atomicity bound
  (oversized string fields are halved until it fits);
* open-world reads: :func:`read_ledger` passes unknown event types and
  fields through and skips malformed lines (a torn tail write);
* never kills the run: a write error is a counted drop
  (``cxxnet_ledger_drops_total``).

:data:`LEDGER` is disabled by default (``event()`` is one call that
returns) and enabled by the session from ``telemetry_ledger = <path>``.
:func:`set_run_info` exports the run identity as
``cxxnet_run_info{run_id,config_hash} 1``, so scraped series join the
ledger.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Any, Dict, Iterator, List, Tuple

from .disttrace import DISTTRACE
from .registry import REGISTRY

LEDGER_SCHEMA = 1

# one O_APPEND write() of at most this many bytes is atomic on every
# POSIX filesystem that matters (PIPE_BUF floor is 512; Linux gives
# 4096); stack dumps get truncated to fit
_MAX_LINE_BYTES = 3584

def _sanitize(v: Any) -> Any:
    """NaN/Inf floats -> None before serialization: Python's json
    would happily emit bare ``NaN`` tokens (a diverged run's loss is
    exactly when the ledger gets read), which strict JSON consumers —
    jq, JSON.parse, Go — reject. Same rule as aggregate.export_snapshot."""
    if isinstance(v, float):
        return v if math.isfinite(v) else None
    if isinstance(v, dict):
        return {k: _sanitize(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_sanitize(x) for x in v]
    return v


class RunLedger:
    """One run's append-only event stream. Thread-safe; every event()
    is open-write-close so concurrent processes interleave whole
    lines, never bytes."""

    def __init__(self, path: str, run_id: str, host: int = 0):
        self.path = path
        self.run_id = run_id
        self.host = int(host)
        self.events_written = 0
        self._lock = threading.Lock()
        self._c_drops = REGISTRY.counter(
            "cxxnet_ledger_drops_total",
            "Ledger events dropped on write errors")
        d = os.path.dirname(os.path.abspath(path))
        if d:
            os.makedirs(d, exist_ok=True)

    def event(self, etype: str, **fields: Any) -> None:
        # envelope wins over caller fields: provenance (who wrote the
        # line, when, for which run) must never be clobberable by an
        # event payload that happens to use the same key
        rec: Dict[str, Any] = dict(fields)
        # an event written while a sampled distributed span is current
        # carries its trace id (the incident timeline joins the traces)
        if "trace_id" not in rec:
            tid = DISTTRACE.current_trace_id()
            if tid:
                rec["trace_id"] = tid
        rec.update({
            "schema": LEDGER_SCHEMA,
            "ts": round(time.time(), 3),
            "run_id": self.run_id,
            "host": self.host,
            "event": str(etype),
        })
        rec = _sanitize(rec)
        try:
            line = json.dumps(rec, sort_keys=True, default=str,
                              allow_nan=False)
        except Exception:
            self._c_drops.inc()
            return
        # keep the envelope, shrink the big field(s): atomicity beats
        # completeness for a crash-forensics stream. Iterative halving
        # (re-serializing each time) because JSON escaping of newline-
        # heavy payloads like stack dumps inflates the cut text — a
        # single byte-count cut would tear the JSON mid-string.
        tries = 0
        while len(line.encode("utf-8")) + 1 > _MAX_LINE_BYTES \
                and tries < 24:
            tries += 1
            k = max((k for k in rec
                     if k not in ("schema", "ts", "run_id", "host",
                                  "event") and isinstance(rec[k], str)),
                    key=lambda k: len(rec[k]), default=None)
            if k is None or len(rec[k]) <= 64:
                # no big string left to shrink: drop extras wholesale
                rec = {k2: rec[k2] for k2 in
                       ("schema", "ts", "run_id", "host", "event")}
                rec["truncated"] = True
                line = json.dumps(rec, sort_keys=True, default=str)
                break
            rec[k] = rec[k][:max(64, len(rec[k]) // 2)] + "..."
            line = json.dumps(rec, sort_keys=True, default=str)
        with self._lock:
            try:
                with open(self.path, "a", encoding="utf-8") as f:
                    f.write(line + "\n")
                self.events_written += 1
            except OSError:
                self._c_drops.inc()


class _DisabledLedger:
    """No-op stand-in so call sites never need a None check; ``event``
    is one method call that returns immediately."""
    enabled = False
    path = ""
    run_id = ""
    host = 0

    def event(self, etype: str, **fields: Any) -> None:
        pass


class _LedgerProxy:
    """The module global: forwards to the enabled RunLedger (or the
    no-op). Enable/disable swap the target; held references through the
    proxy always see the current state."""

    def __init__(self):
        self._target: Any = _DisabledLedger()

    @property
    def enabled(self) -> bool:
        return isinstance(self._target, RunLedger)

    @property
    def path(self) -> str:
        return self._target.path

    @property
    def run_id(self) -> str:
        return getattr(self._target, "run_id", "") or RUN_INFO.get(
            "run_id", "")

    @property
    def host(self) -> int:
        return self._target.host

    @property
    def events_written(self) -> int:
        return getattr(self._target, "events_written", 0)

    def enable(self, path: str, run_id: str, host: int = 0) -> "RunLedger":
        self._target = RunLedger(path, run_id, host=host)
        return self._target

    def disable(self) -> None:
        self._target = _DisabledLedger()

    def event(self, etype: str, **fields: Any) -> None:
        self._target.event(etype, **fields)


LEDGER = _LedgerProxy()


# -- run identity -------------------------------------------------------------

RUN_INFO: Dict[str, str] = {}


def new_run_id() -> str:
    """Unique-enough run id: time + pid + 4 random hex. Readable in a
    filename, grep-able in logs."""
    import secrets
    return "r%s-%05d-%s" % (time.strftime("%Y%m%d%H%M%S"),
                            os.getpid() % 100000, secrets.token_hex(2))


def config_hash(cfg_pairs) -> str:
    """Order-sensitive sha256 over the (name, value) config pairs —
    order matters in this config dialect (layer params attach to the
    preceding layer line), so two configs that differ only in order ARE
    different configs. 12 hex chars: enough to join, short enough for a
    label value."""
    import hashlib
    h = hashlib.sha256()
    for name, val in cfg_pairs:
        h.update(("%s\x00%s\x01" % (name, val)).encode("utf-8"))
    return h.hexdigest()[:12]


def set_run_info(run_id: str, cfg_hash: str = "") -> None:
    """Record run identity and export it as the standard info-metric
    pattern: ``cxxnet_run_info{run_id="...",config_hash="..."} 1`` —
    a constant-1 gauge whose labels make every scraped series from this
    process joinable with the ledger (and with scrapes of the OTHER
    processes/tasks of the same run)."""
    RUN_INFO["run_id"] = run_id
    RUN_INFO["config_hash"] = cfg_hash
    REGISTRY.gauge("cxxnet_run_info",
                   "Run identity (constant 1; labels join scrapes to "
                   "the run ledger)",
                   labels=("run_id", "config_hash")
                   ).labels(run_id, cfg_hash).set(1)


def run_info() -> Dict[str, str]:
    """The /statz "run" section payload."""
    return dict(RUN_INFO)


# -- config snapshot (incident replay) ---------------------------------------

# inline budget for the run_start config snapshot: the atomic-line
# bound minus generous headroom for the envelope and the other
# run_start fields (mesh, dist, cache paths). Oversized configs split
# into config_chunk events of at most this payload each.
_SNAPSHOT_INLINE_BYTES = 2600


def plan_config_snapshot(pairs) -> Tuple[Dict[str, Any],
                                         List[Dict[str, Any]]]:
    """Split the resolved config snapshot for ledger recording.

    Returns ``(run_start_fields, chunk_events)``: when the snapshot
    fits one atomic line it rides ``run_start`` directly as
    ``config=[[k, v], ...]`` (order preserved — this config dialect is
    order-sensitive) and the chunk list is empty; otherwise
    ``run_start`` carries ``config_chunks=N`` and each returned chunk
    dict (``seq``/``total``/``pairs``) is emitted as its own
    ``config_chunk`` event; a reader reassembles them in ``seq``
    order and can check :func:`config_hash` against the one
    ``run_start`` recorded."""
    pairs = [[str(k), str(v)] for k, v in pairs]
    payload = json.dumps(pairs)
    if len(payload.encode("utf-8")) <= _SNAPSHOT_INLINE_BYTES:
        return {"config": pairs}, []
    chunks: List[List[List[str]]] = []
    cur: List[List[str]] = []
    cur_bytes = 0
    for kv in pairs:
        b = len(json.dumps(kv).encode("utf-8")) + 2
        if cur and cur_bytes + b > _SNAPSHOT_INLINE_BYTES:
            chunks.append(cur)
            cur, cur_bytes = [], 0
        cur.append(kv)
        cur_bytes += b
    if cur:
        chunks.append(cur)
    total = len(chunks)
    return ({"config_chunks": total},
            [{"seq": i, "total": total, "pairs": c}
             for i, c in enumerate(chunks)])


# -- reading ------------------------------------------------------------------

def iter_ledger(path: str, warn: bool = True) -> Iterator[Dict[str, Any]]:
    """Yield parsed events; malformed lines (torn tail writes, stray
    garbage) are SKIPPED, unknown event types and extra fields pass
    through — open-world reads by contract.

    The file is read as bytes and each line decoded on its own: a
    writer killed mid-write can tear the last line anywhere, inside a
    multi-byte UTF-8 sequence too. Every skip is counted
    (``cxxnet_ledger_read_drops_total``) and summarized with one
    warning per call (``warn=False`` silences it, not the counter)."""
    drops = 0
    with open(path, "rb") as f:
        for raw in f:
            raw = raw.strip()
            if not raw:
                continue
            try:
                # json.loads decodes the bytes itself; UnicodeDecodeError
                # is a ValueError subclass, so one except covers torn
                # UTF-8 and torn JSON alike
                rec = json.loads(raw)
            except ValueError:
                drops += 1
                continue
            if not isinstance(rec, dict) or "event" not in rec:
                drops += 1
                continue
            yield rec
    if drops:
        REGISTRY.counter(
            "cxxnet_ledger_read_drops_total",
            "Malformed ledger lines skipped on read (torn tail writes)"
        ).inc(drops)
        if warn:
            import sys
            print(f"WARNING: ledger {path}: skipped {drops} malformed "
                  "line(s) (torn tail write?)", file=sys.stderr,
                  flush=True)


def read_ledger(path: str, warn: bool = True) -> List[Dict[str, Any]]:
    return list(iter_ledger(path, warn=warn))
