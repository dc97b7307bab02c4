"""The port's step-time probe (``cxxnet_tpu_torch/telemetry/steptime.py``)
against the JAX package's, on the CPU.

Both probes read ``time.perf_counter``; here both modules read one fake
clock that the test advances, so the same injected timings (data wait,
dispatch, the device's lag at a sync) reach both. The JAX probe blocks
on the step's output through ``block_until_ready``, the port's on an
event's ``synchronize``; each fake advances the clock by the device lag.

* The same timings give equal EMAs, gauges, fragments and verdicts,
  input-bound, compute-bound and balanced.
* A fake event counts the port probe's syncs: one at the close of each
  window of ``sync_interval`` steps, none per step, at most
  ⌈steps / interval⌉; chains count their steps.
"""

import math

import pytest

from cxxnet_tpu.telemetry import registry as jax_registry
from cxxnet_tpu.telemetry import steptime as jax_steptime
from cxxnet_tpu.telemetry.trace import Tracer as JaxTracer
from cxxnet_tpu_torch.telemetry import registry, steptime
from cxxnet_tpu_torch.telemetry.trace import Tracer


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def perf_counter(self) -> float:
        return self.t


class JaxReady:
    """The JAX probe's device value: blocking advances the clock."""

    def __init__(self, clock, lag):
        self.clock, self.lag = clock, lag

    def block_until_ready(self):
        self.clock.t += self.lag


class FakeEvent:
    """The port probe's ``torch.cuda.Event`` stand-in: counts syncs."""

    def __init__(self, clock, lag, log):
        self.clock, self.lag, self.log = clock, lag, log

    def synchronize(self):
        self.log.append(self.clock.t)
        self.clock.t += self.lag


@pytest.fixture()
def clock(monkeypatch):
    c = FakeClock()
    monkeypatch.setattr(jax_steptime.time, "perf_counter", c.perf_counter)
    monkeypatch.setattr(steptime.time, "perf_counter", c.perf_counter)
    return c


def _drive(probe, clock, timings, ready, interval):
    """Feed ``timings`` [(data_wait, dispatch, device_lag, steps)]: the
    clock moves through each phase as the train loop would."""
    for wait, disp, lag, steps in timings:
        clock.t += wait
        probe.note_data_wait(wait)
        clock.t += disp
        probe.record_step(disp, ready=ready(lag), steps=steps)


def _probes(interval):
    mine = steptime.StepTimeProbe(sync_interval=interval,
                                  registry=registry.MetricRegistry(),
                                  tracer=Tracer())
    ref = jax_steptime.StepTimeProbe(sync_interval=interval,
                                     registry=jax_registry.MetricRegistry(),
                                     tracer=JaxTracer())
    return mine, ref


CASES = {
    "input-bound": [(0.030, 0.002, 0.001, 1)] * 24,
    "compute-bound": [(0.001, 0.002, 0.040, 1)] * 24,
    "balanced": [(0.010, 0.002, 0.010, 1)] * 24,
    "drifting": [(0.001 * (i % 7), 0.003 + 0.001 * (i % 3),
                  0.002 * (i % 5), 1) for i in range(40)],
    "chains": [(0.004, 0.010, 0.030, 4)] * 10,
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("interval", [1, 3, 8])
def test_equal_timings_give_equal_emas_and_verdicts(clock, case, interval):
    mine, ref = _probes(interval)
    log = []
    start = clock.t
    _drive(ref, clock, CASES[case], lambda lag: JaxReady(clock, lag),
           interval)
    clock.t = start
    _drive(mine, clock, CASES[case], lambda lag: FakeEvent(clock, lag, log),
           interval)
    for attr in ("data_wait_ema", "dispatch_ema", "device_block_ema",
                 "step_wall_ema"):
        assert getattr(mine, attr) == getattr(ref, attr), attr
    assert (mine.steps, mine.syncs) == (ref.steps, ref.syncs)
    assert mine.verdict() == ref.verdict()
    assert mine.report_fragment() == ref.report_fragment()
    if interval == 1 and case in ("input-bound", "compute-bound",
                                  "balanced"):
        # one sync a step charges each step's whole lag to the device
        assert mine.verdict() == case
    assert mine._g_dev.value == ref._g_dev.value


@pytest.mark.parametrize("steps,interval,chain", [
    (1, 8, 1), (7, 8, 1), (8, 8, 1), (9, 8, 1), (24, 8, 1), (25, 8, 1),
    (10, 1, 1), (10, 3, 1), (12, 4, 4), (13, 8, 4)])
def test_at_most_one_sync_per_interval(clock, steps, interval, chain):
    """The port probe waits on its event only where a window of
    ``interval`` steps closes: ⌊steps / interval⌋ syncs for single
    steps, never more than ⌈steps / interval⌉, none in between."""
    probe, _ = _probes(interval)
    log, calls = [], []

    def ready(lag):
        calls.append(1)
        return FakeEvent(clock, lag, log)
    n_calls = math.ceil(steps / chain)
    _drive(probe, clock, [(0.001, 0.001, 0.002, chain)] * n_calls, ready,
           interval)
    total = n_calls * chain
    assert probe.steps == total
    assert len(log) == probe.syncs <= math.ceil(total / interval)
    if chain == 1:
        assert len(log) == total // interval
    assert len(calls) == n_calls     # one ready handle a dispatch


def test_no_ready_handle_no_sync(clock):
    probe, ref = _probes(2)
    for p in (probe, ref):
        _drive(p, clock, [(0.001, 0.001, 0.0, 1)] * 6, lambda lag: None, 2)
    assert probe.syncs == ref.syncs == 0
    assert probe.device_block_ema == ref.device_block_ema == 0.0
    assert probe.verdict() == ref.verdict()
