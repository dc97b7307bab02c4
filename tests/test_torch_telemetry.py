"""The port's telemetry plane (``cxxnet_tpu_torch/telemetry``) against the
JAX package's (``cxxnet_tpu/telemetry``), on the CPU.

* The registry and the Prometheus exposition: the same sequence of
  counter, gauge and histogram operations applied to a fresh registry of
  each package renders byte-equal text (format 0.0.4: HELP/TYPE lines,
  label escaping, cumulative ``le`` buckets, NaN and infinities), and
  ``log_buckets`` gives the same ladders.
* The run ledger of one narrow training run in each package
  (``torch_telemetry_fixture``: a LeNet, two rounds on ``iter =
  synthetic``, an injected NaN step rolled back by the default sentinel):
  the same events in the same order, each with the same fields, but for
  the JAX package's XLA ``compile`` events and the distributed-trace
  ``trace_id`` it stamps (distributed tracing waits for ROADMAP Queue A
  12).
* The trace of the same runs: the same span names, each with the same
  enclosing spans on its thread.
* The session's pieces: the ``telemetry_port`` scrape server answers
  while it runs, a taken port raises, the JSONL log rotates, the config
  parse refuses unknown and queued ``telemetry_*`` keys.
"""

import dataclasses
import json
import math
import os
import socket
import urllib.request

import pytest

from cxxnet_tpu.telemetry import exporter as jax_exporter
from cxxnet_tpu.telemetry import registry as jax_registry
from cxxnet_tpu_torch.config import ConfigError, parse_telemetry_config
from cxxnet_tpu_torch.telemetry import exporter, registry

from torch_telemetry_fixture import paired_runs

#: ledger events only the JAX package writes: its XLA compile records
JAX_ONLY_EVENTS = {"compile", "compile_cache"}


def _ops(reg, seed: int) -> None:
    """A fixed sequence of metric operations, varied by ``seed``."""
    import random
    rs = random.Random(seed)
    c = reg.counter("cxxnet_t_requests_total", "Requests by outcome",
                    labels=("engine", "result"))
    g = reg.gauge("cxxnet_t_depth", "Queue depth", labels=("engine",))
    h = reg.histogram("cxxnet_t_latency_seconds", "Latency",
                      labels=("engine",))
    hb = reg.histogram("cxxnet_t_size", "", buckets=(1, 2.5, 10, 100))
    u = reg.counter("cxxnet_t_plain_total", "An unlabelled counter")
    weird = reg.gauge("cxxnet_t_weird", 'Help with "quotes" \\ too',
                      labels=("name",))
    for i in range(40):
        eng = str(rs.randrange(3))
        c.labels(eng, rs.choice(("ok", "failed", "rejected"))).inc(
            rs.choice((1, 1, 2, 0.5)))
        g.labels(engine=eng).set(rs.uniform(-5, 5))
        g.labels(eng).inc(rs.randrange(4))
        g.labels(eng).dec(0.25)
        h.labels(eng).observe(10 ** rs.uniform(-5, 2))
        hb.observe(rs.choice((0.5, 1, 2.5, 3, 10, 100, 1e4)))
        u.inc()
    weird.labels('a "quoted"\nname\\').set(float("nan"))
    weird.labels("inf").set(math.inf)
    weird.labels("-inf").set(-math.inf)
    weird.labels("big").set(1e16)
    weird.labels("int").set(42.0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prometheus_text_is_byte_equal(seed):
    mine, ref = registry.MetricRegistry(), jax_registry.MetricRegistry()
    _ops(mine, seed)
    _ops(ref, seed)
    got = exporter.render_prometheus(mine)
    want = jax_exporter.render_prometheus(ref)
    assert got == want
    # NaN compares unequal to itself: compare the JSON of the snapshots
    assert json.dumps(mine.snapshot(), sort_keys=True) \
        == json.dumps(ref.snapshot(), sort_keys=True)
    mine.reset()
    ref.reset()
    assert exporter.render_prometheus(mine) \
        == jax_exporter.render_prometheus(ref)


@pytest.mark.parametrize("lo,hi,per", [(1e-4, 60.0, 3), (1e-3, 10.0, 5),
                                       (0.5, 512.0, 1)])
def test_log_buckets_match(lo, hi, per):
    assert registry.log_buckets(lo, hi, per) \
        == jax_registry.log_buckets(lo, hi, per)
    assert registry.DEFAULT_LATENCY_BUCKETS \
        == jax_registry.DEFAULT_LATENCY_BUCKETS


def test_registry_refuses_what_the_jax_registry_refuses():
    for reg, err in ((registry.MetricRegistry(), registry.MetricError),
                     (jax_registry.MetricRegistry(),
                      jax_registry.MetricError)):
        reg.counter("x_total", labels=("a",))
        for bad in (lambda: reg.gauge("x_total"),
                    lambda: reg.counter("x_total", labels=("b",)),
                    lambda: reg.counter("bad name"),
                    lambda: reg.counter("x_total", labels=("a",))
                    .labels("1", "2"),
                    lambda: reg.counter("x_total", labels=("a",))
                    .labels("1").inc(-1)):
            with pytest.raises(err):
                bad()


def _events(run):
    return [r for r in run["ledger"] if r["event"] not in JAX_ONLY_EVENTS]


def test_ledger_schema_and_event_order_match():
    runs = paired_runs()
    got, want = _events(runs["port"]), _events(runs["jax"])
    assert [r["event"] for r in got] == [r["event"] for r in want]
    for a, b in zip(got, want):
        assert set(a) == set(b), a["event"]
        assert a["schema"] == b["schema"] == 1
    names = [r["event"] for r in got]
    # the injected NaN step: tripped and rolled back in round 2, to round 1
    assert names.count("sentinel_trip") == names.count("rollback") == 1
    trip = next(r for r in got if r["event"] == "rollback")
    assert (trip["round"], trip["to_round"]) == (2, 1)
    assert names[0] == "run_start" and names[-1] == "run_end"
    assert got[-1]["status"] == want[-1]["status"] == "ok"
    assert len({r["run_id"] for r in got}) == 1


def _nesting(doc):
    """{span name: the set of names of the innermost span enclosing it on
    its thread ("" at the top)}."""
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    out = {}
    for e in spans:
        lo, hi = e["ts"], e["ts"] + e["dur"]
        parents = [p for p in spans if p is not e and p["tid"] == e["tid"]
                   and p["ts"] <= lo and hi <= p["ts"] + p["dur"]
                   and p["dur"] >= e["dur"]]
        inner = min(parents, key=lambda p: p["dur"], default=None)
        out.setdefault(e["name"], set()).add(inner["name"] if inner
                                             else "")
    return out


def test_trace_spans_and_nesting_match():
    runs = paired_runs()
    got, want = (_nesting(runs[k]["trace"]) for k in ("port", "jax"))
    assert set(got) == set(want)
    assert got == want
    assert {"train.step", "train.step_dispatch", "train.data_wait",
            "train.h2d_stage", "train.device_block", "train.eval",
            "ckpt.save"} <= set(got)


def test_round_line_carries_the_probe_verdict():
    """No telemetry key: the default step-time probe's fragment ends the
    round line of the round that closed its first window (8 steps)."""
    for name, run in paired_runs().items():
        lines = [ln for ln in run["stdout"].splitlines()
                 if ln.startswith("round") and "sec]" in ln]
        assert len(lines) == 2, (name, run["stdout"])
        assert "bound:" not in lines[0]
        assert "\tdata_ms:" in lines[1] and "\tbound:" in lines[1], name


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_scrape_server_answers_and_a_taken_port_raises(tmp_path):
    from cxxnet_tpu_torch.telemetry import TelemetrySession
    from cxxnet_tpu_torch.telemetry.ledger import LEDGER
    port = _free_port()
    tc = parse_telemetry_config([("telemetry_port", str(port)),
                                 ("telemetry_log", str(tmp_path / "l.jsonl")),
                                 ("telemetry_log_max_kb", "1")])
    session = TelemetrySession(tc, silent=True)
    try:
        registry.REGISTRY.counter("cxxnet_t_session_total").inc()
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=10) as r:
            body = r.read().decode()
            assert r.headers["Content-Type"] \
                == exporter.PROMETHEUS_CONTENT_TYPE
        assert "cxxnet_t_session_total 1" in body
        assert "cxxnet_run_info{run_id=" in body
        with pytest.raises(OSError):
            TelemetrySession(tc, silent=True)
        for _ in range(3):
            session.logger.write_now()
    finally:
        session.close()
    assert not LEDGER.enabled
    lines = (tmp_path / "l.jsonl").read_text().splitlines()
    assert lines and "metrics" in json.loads(lines[-1])
    # the 1 KiB cap: the first snapshots moved to l.jsonl.1
    assert os.path.exists(str(tmp_path / "l.jsonl.1"))


@pytest.mark.parametrize("pairs,msg", [
    ([("telemetry_trce", "x")], "unknown telemetry setting"),
    ([("telemetry_fleet_dir", "/f")], None),
    ([("telemetry_hang_s", "30")], None),
    ([("telemetry_trace_sample", "0.5")], None),
    ([("telemetry_sync_interval", "0")], "must be >= 1"),
    ([("telemetry_profile_steps", "5-2")], "start 5 > stop 2"),
])
def test_telemetry_keys_are_parsed_as_in_the_jax_package(pairs, msg):
    """Errors as the JAX package's; the fleet, hang-watchdog and
    distributed-trace keys parse to the JAX fields (``msg`` None)."""
    from cxxnet_tpu.config import parse_telemetry_config as jax_parse
    if msg is None:
        assert dataclasses.asdict(parse_telemetry_config(pairs)) == \
            dataclasses.asdict(jax_parse(pairs))
    else:
        with pytest.raises(ConfigError, match=msg):
            parse_telemetry_config(pairs)
        with pytest.raises(ValueError):
            jax_parse(pairs)
    ok = [("telemetry_profile_steps", "3-4"), ("telemetry_sync_interval",
                                               "4")]
    tc = parse_telemetry_config(ok)
    ref = jax_parse(ok)
    assert (tc.profile_steps, tc.profile_dir, tc.sync_interval,
            tc.steptime) == (ref.profile_steps, ref.profile_dir,
                             ref.sync_interval, ref.steptime)


def test_profile_brackets_write_the_trace_and_summary(tmp_path):
    """``telemetry_profile_steps = 1-2`` and ``profile_dir`` on the CPU:
    each writes ``trace.json`` (Chrome trace) and ``summary.json`` into
    its directory, holding the step's ops; the two together are refused
    (torch.profiler runs one session at a time)."""
    from torch_telemetry_fixture import LENET
    from cxxnet_tpu_torch import main as port_main
    conf = tmp_path / "lenet.conf"
    conf.write_text(LENET.replace("continue = 1\n", "")
                    .replace("num_round = 3\n", "num_round = 1\n"))
    base = [str(conf), f"model_dir={tmp_path}/m", "silent=1"]
    port_main.main(base + ["telemetry_profile_steps=1-2",
                           f"telemetry_profile_dir={tmp_path}/steps"])
    port_main.main(base + [f"profile_dir={tmp_path}/loop"])
    for d in ("steps", "loop"):
        with open(tmp_path / d / "trace.json") as f:
            names = {e.get("name") for e in json.load(f)["traceEvents"]}
        assert any(n and "conv" in n for n in names), d
        with open(tmp_path / d / "summary.json") as f:
            summary = json.load(f)
        # the CPU records no device kernel
        assert summary["device_events"] == 0 and summary["kernels"] == {}
    with pytest.raises(ConfigError, match="one session at a time"):
        port_main.main(base + ["telemetry_profile_steps=1-2",
                               f"profile_dir={tmp_path}/both"])


def test_a_card_profile_without_cuda_activity_raises(monkeypatch):
    """A bracket on a card must trace its kernels: without CUDA activity
    in the build it refuses to start (nothing falls back)."""
    import torch
    from cxxnet_tpu_torch.telemetry.profiler import (ProfileBracket,
                                                     ProfilerError)
    monkeypatch.setattr(torch.profiler, "supported_activities",
                        lambda: {torch.profiler.ProfilerActivity.CPU})
    with pytest.raises(ProfilerError, match="CUDA activity"):
        ProfileBracket("/nonexistent/never", cuda=True).start()
