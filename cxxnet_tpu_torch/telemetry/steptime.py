"""Training step-time breakdown: data wait vs dispatch vs device time
(the port of ``cxxnet_tpu/telemetry/steptime.py``).

Is the step input-bound or compute-bound? Wall clock alone cannot say,
because CUDA launches are asynchronous: ``Trainer.update`` returns once
the step is queued on the stream, so host timing sees only data wait
plus dispatch while the card runs behind. Waiting for the card after
every step would serialize the very overlap the queue exists for, so
the probe waits only every ``sync_interval`` steps: it records a
``torch.cuda.Event`` on the current stream after the step (so the event
completes when everything queued so far has run) and waits for it,
charging the wait to the device. That is at most one host sync per
``sync_interval`` steps and none per step. On the CPU the step has run
by the time ``update`` returns: the sync point waits for nothing.

Per-step components:

* **data_wait**: host time blocked pulling the next batch from the
  input pipeline. Large means input-bound.
* **dispatch**: host time inside the update call (staging, launching).
  Large means launch-bound (the captured step of ROADMAP Queue A 13).
* **device_block**: how far the card lags the host at a sync point,
  the device time the host did not hide. Large means compute-bound.

Rolling EMAs smooth scheduler noise; :meth:`verdict` compares the data
wait and device block EMAs and says ``input-bound``, ``compute-bound``
or ``balanced``, which the round line carries and the registry exports
as gauges.
"""

from __future__ import annotations

import time
from typing import Any, Optional

import torch

from .registry import REGISTRY, MetricRegistry
from .trace import TRACER


class StepTimeProbe:
    """Feed with per-step host timings; it syncs sparsely and keeps the
    breakdown EMAs. Not thread-safe — it belongs to the (single) train
    loop thread."""

    def __init__(self, sync_interval: int = 8, ema_alpha: float = 0.3,
                 registry: Optional[MetricRegistry] = None,
                 tracer=None):
        self.sync_interval = max(1, int(sync_interval))
        self.ema_alpha = float(ema_alpha)
        self.steps = 0
        self.syncs = 0
        # per-step EMAs (seconds); None until the first sync window closes
        self.data_wait_ema: Optional[float] = None
        self.dispatch_ema: Optional[float] = None
        self.device_block_ema: Optional[float] = None
        self.step_wall_ema: Optional[float] = None
        self._win_data_wait = 0.0
        self._win_dispatch = 0.0
        self._win_steps = 0
        self._win_t0: Optional[float] = None
        self._pending_data_wait = 0.0
        self._tracer = tracer or TRACER
        reg = registry or REGISTRY
        g = lambda n, h: reg.gauge(n, h)
        self._g_data = g("cxxnet_steptime_data_wait_seconds",
                         "EMA of per-step host time blocked on input")
        self._g_disp = g("cxxnet_steptime_dispatch_seconds",
                         "EMA of per-step host time dispatching the step")
        self._g_dev = g("cxxnet_steptime_device_block_seconds",
                        "EMA of per-step device time the host waited out "
                        "at sync points")
        self._g_wall = g("cxxnet_steptime_step_wall_seconds",
                         "EMA of per-step wall time")
        # per-step wall-time distribution, not only the EMA
        self._h_step = reg.histogram(
            "cxxnet_steptime_step_seconds",
            "Per-step wall time (window-averaged at each sync point)")
        self._c_sync = reg.counter(
            "cxxnet_steptime_syncs_total",
            "Blocking host-device syncs taken by the step-time probe")
        self._c_steps = reg.counter(
            "cxxnet_steptime_steps_total",
            "Train steps observed by the step-time probe")

    # -- feeding ---------------------------------------------------------
    def note_data_wait(self, seconds: float) -> None:
        """Bank the input-fetch time for the NEXT record_step call (the
        loop pulls the batch before it dispatches)."""
        self._pending_data_wait += max(0.0, seconds)

    def record_step(self, dispatch_s: float, ready: Any = None,
                    steps: int = 1) -> None:
        """One dispatched update (or a ``steps``-long chain). ``ready``
        is the step's loss tensor (or anything with ``synchronize()``,
        such as a ``torch.cuda.Event``), waited for only at sync points,
        never per step: a CUDA tensor gets an event recorded on the
        current stream there; a CPU tensor's wait is empty."""
        now = time.perf_counter()
        if self._win_t0 is None:
            self._win_t0 = now - dispatch_s - self._pending_data_wait
        self.steps += steps
        self._c_steps.inc(steps)
        self._win_steps += steps
        self._win_data_wait += self._pending_data_wait
        self._win_dispatch += max(0.0, dispatch_s)
        self._pending_data_wait = 0.0
        if self._win_steps < self.sync_interval:
            return
        # sync point: block on the step's output and charge the wait to
        # the device
        block = 0.0
        event = _sync_event(ready)
        if event is not None:
            t0 = time.perf_counter()
            event.synchronize()
            block = time.perf_counter() - t0
            self.syncs += 1
            self._c_sync.inc()
            self._tracer.add_complete("train.device_block", t0,
                                      t0 + block,
                                      cat="train",
                                      args={"steps": self._win_steps})
        self._close_window(block)

    def _close_window(self, block_s: float) -> None:
        n = self._win_steps
        if n <= 0:
            return
        wall = max(time.perf_counter() - (self._win_t0 or 0.0), 0.0)
        # one histogram observation a step at the window's average, so
        # step counts stay comparable across sync intervals
        per_step = wall / n
        for _ in range(n):
            self._h_step.observe(per_step)
        a = self.ema_alpha
        mix = lambda old, new: new if old is None else old + a * (new - old)
        self.data_wait_ema = mix(self.data_wait_ema,
                                 self._win_data_wait / n)
        self.dispatch_ema = mix(self.dispatch_ema, self._win_dispatch / n)
        self.device_block_ema = mix(self.device_block_ema, block_s / n)
        self.step_wall_ema = mix(self.step_wall_ema, wall / n)
        self._g_data.set(self.data_wait_ema)
        self._g_disp.set(self.dispatch_ema)
        self._g_dev.set(self.device_block_ema)
        self._g_wall.set(self.step_wall_ema)
        self._win_data_wait = 0.0
        self._win_dispatch = 0.0
        self._win_steps = 0
        self._win_t0 = None

    # -- reading ---------------------------------------------------------
    def verdict(self) -> str:
        """``input-bound`` / ``compute-bound`` / ``balanced`` — or
        ``warming-up`` before the first sync window closes. The 1.2x
        hysteresis band keeps the label stable when the two sides are
        within scheduler noise of each other."""
        dw, dev = self.data_wait_ema, self.device_block_ema
        if dw is None or dev is None:
            return "warming-up"
        # a verdict needs a material signal: the winning side must be at
        # least 5% of the step wall, or the step is dominated by neither
        # (e.g. dispatch/compile overhead) and the honest label is
        # "balanced"
        floor = 0.05 * (self.step_wall_ema or 0.0)
        if dw > dev * 1.2 and dw > floor:
            return "input-bound"
        if dev > dw * 1.2 and dev > floor:
            return "compute-bound"
        return "balanced"

    def report_fragment(self) -> str:
        """Round-log fragment, same ``\\tkey:value`` dialect as the
        metric line: per-step ms for each component plus the verdict."""
        if self.data_wait_ema is None:
            return ""
        ms = lambda v: (v or 0.0) * 1e3
        return ("\tdata_ms:%.2f\tdispatch_ms:%.2f\tdevice_ms:%.2f"
                "\tbound:%s" % (ms(self.data_wait_ema),
                                ms(self.dispatch_ema),
                                ms(self.device_block_ema),
                                self.verdict()))


class _HostDone:
    """The wait of a step that ran on the host: nothing to wait for."""
    __slots__ = ()

    def synchronize(self) -> None:
        pass


def _sync_event(ready: Any):
    """What a sync point waits on for ``ready``: the object itself when
    it has ``synchronize()`` (a ``torch.cuda.Event``), an event recorded
    now on the current stream of a CUDA tensor's device, a no-op for a
    CPU tensor (its step ran before ``update`` returned), None for
    None."""
    if ready is None:
        return None
    if hasattr(ready, "synchronize"):
        return ready
    if isinstance(ready, torch.Tensor) and ready.is_cuda:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(ready.device))
        return event
    return _HostDone()
