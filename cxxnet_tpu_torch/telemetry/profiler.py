"""``torch.profiler`` brackets: ``telemetry_profile_steps = a-b`` and
``profile_dir`` (the port of ``cxxnet_tpu/telemetry/profiler.py`` and of
the JAX package's ``profile_dir`` bracket around the train loop).

:class:`StepProfiler` brackets exactly the global steps ``a..b``
(inclusive): it starts a ``torch.profiler`` session, CPU and CUDA
activities, before the dispatch of step ``a``, and once step ``b`` is
queued it waits for a CUDA event recorded after it, so step ``b``'s
kernels land in the trace, and stops. ``profile_dir`` traces the whole
train loop the same way (:class:`ProfileBracket`). Either one writes
into its directory:

* ``trace.json``: the Chrome trace (open it in Perfetto,
  https://ui.perfetto.dev, or chrome://tracing);
* ``summary.json``: :meth:`ProfileBracket.summarize`, the per-kernel
  totals: each device kernel's (and copy's) name, launch count and
  device time, read from ``trace.json``.

A session on a card that fails to start, or that records no device
event, raises :class:`ProfilerError`: nothing falls back to a run
without the trace it was asked for. On the CPU (``dev = cpu``) only CPU
activity is recorded.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Optional, Tuple

import torch

from .steptime import _sync_event
from .trace import TRACER

_RANGE_RE = re.compile(r"^\s*(\d+)\s*-\s*(\d+)\s*$")


class ProfilerError(RuntimeError):
    """A profiler session that did not start or recorded no device
    events."""


def parse_step_range(spec: str) -> Tuple[int, int]:
    """``"a-b"`` -> (a, b) with 0 <= a <= b; a bare ``"n"`` means one
    step (n, n)."""
    spec = spec.strip()
    m = _RANGE_RE.match(spec)
    if m:
        a, b = int(m.group(1)), int(m.group(2))
    elif spec.isdigit():
        a = b = int(spec)
    else:
        raise ValueError(
            f"telemetry_profile_steps must be 'a-b' or 'n', got {spec!r}")
    if a > b:
        raise ValueError(
            f"telemetry_profile_steps: start {a} > stop {b}")
    return a, b


#: the Chrome-trace categories of work on the card (kernels, copies,
#: fills), as torch.profiler writes them
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class ProfileBracket:
    """One ``torch.profiler`` session into ``dump_dir``: :meth:`start`,
    then :meth:`stop` (waiting first for ``ready``, a CUDA tensor or
    event of the last traced step). ``cuda`` says whether the traced
    work runs on a card, and so whether device events are required."""

    def __init__(self, dump_dir: str, cuda: bool):
        self.dump_dir = dump_dir
        self.cuda = bool(cuda)
        self.active = False
        self.done = False
        self._prof = None
        self._summary: Optional[Dict[str, Any]] = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            if ProfilerActivity.CUDA not in \
                    torch.profiler.supported_activities():
                raise ProfilerError(
                    "torch.profiler cannot trace CUDA activity in this "
                    "build; the trace would hold no kernel")
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(self.dump_dir, exist_ok=True)
        prof = profile(activities=acts, record_shapes=False)
        try:
            prof.__enter__()
        except Exception as e:
            raise ProfilerError(
                f"torch.profiler did not start: {type(e).__name__}: "
                f"{e}") from e
        self._prof = prof
        self.active = True

    def stop(self, ready: Any = None) -> None:
        if ready is not None:
            _sync_event(ready).synchronize()
        if self.cuda:
            torch.cuda.synchronize()
        prof, self._prof = self._prof, None
        self.active = False
        self.done = True
        prof.__exit__(None, None, None)
        path = os.path.join(self.dump_dir, "trace.json")
        prof.export_chrome_trace(path)
        # the totals from the written trace's device events: reading them
        # back is cheaper than the profiler's Python event tree
        with open(path, encoding="utf-8") as f:
            events = json.load(f).get("traceEvents", [])
        kernels: Dict[str, Dict[str, float]] = {}
        for ev in events:
            if ev.get("ph") != "X" or ev.get("cat") not in _DEVICE_CATS:
                continue
            k = kernels.setdefault(ev["name"], {"count": 0, "device_us": 0.0})
            k["count"] += 1
            k["device_us"] += float(ev.get("dur", 0.0))
        if self.cuda and not kernels:
            raise ProfilerError(
                f"torch.profiler recorded no device event into "
                f"{self.dump_dir}: the trace cannot show the kernels")
        self._summary = {
            "device_events": sum(k["count"] for k in kernels.values()),
            "device_us": round(sum(k["device_us"]
                                   for k in kernels.values()), 3),
            "kernels": {name: {"count": k["count"],
                               "device_us": round(k["device_us"], 3)}
                        for name, k in sorted(kernels.items())},
        }
        with open(os.path.join(self.dump_dir, "summary.json"), "w",
                  encoding="utf-8") as f:
            json.dump(self._summary, f, indent=1, sort_keys=True)

    def summarize(self) -> Optional[Dict[str, Any]]:
        """The per-kernel totals of the closed session (``summary.json``'s
        content): ``{"device_events", "device_us", "kernels": {name:
        {"count", "device_us"}}}``; None while it is open."""
        return self._summary


class StepProfiler:
    """Driven by the train loop: ``maybe_start(step)`` before the
    dispatch of global step ``step``, ``maybe_stop(step_after, ready)``
    after it (the count already advanced). Outside the bracket both
    calls are integer compares. ``close()`` finishes a bracket the run
    ended inside."""

    def __init__(self, spec: str, dump_dir: str, cuda: bool = False):
        self.start_step, self.stop_step = parse_step_range(spec)
        self.dump_dir = dump_dir
        self._bracket = ProfileBracket(dump_dir, cuda)

    @property
    def active(self) -> bool:
        return self._bracket.active

    @property
    def done(self) -> bool:
        return self._bracket.done

    def maybe_start(self, step: int) -> None:
        if self.done or self.active or step < self.start_step:
            return
        self._bracket.start()
        TRACER.instant("profiler.start_trace", cat="profile",
                       args={"step": step, "dir": self.dump_dir})

    def maybe_stop(self, next_step: int, ready: Any = None) -> None:
        """``next_step`` is the step count after the last dispatch; the
        bracket closes once it passes ``stop_step``."""
        if not self.active or next_step <= self.stop_step:
            return
        self._stop(ready)

    def _stop(self, ready: Any = None) -> None:
        self._bracket.stop(ready)
        TRACER.instant("profiler.stop_trace", cat="profile",
                       args={"dir": self.dump_dir})

    def close(self, ready: Any = None) -> None:
        if self.active:
            self._stop(ready)

    def summarize(self) -> Optional[Dict[str, Any]]:
        """The bracket's per-kernel totals once it closed, else None."""
        return self._bracket.summarize()


