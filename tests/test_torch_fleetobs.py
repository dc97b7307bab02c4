"""Fleet observability of the port (``telemetry/aggregate.py``,
``telemetry/anomaly.py``, the session's fleet pieces) against the JAX
package's, on the CPU.

* the same registry contents give the same ``export_snapshot`` document
  (schema 1, but its ``ts``) and the same merged ``render_fleet`` text;
* each package's ``FleetAggregator`` reads the other's snapshot files;
* the straggler rule and the recompile-storm detector give the JAX
  verdicts on the same inputs (ledger events included);
* a stalled progress counter gives one ``hang_dump`` with the threads'
  stacks and one ``cxxnet_hangs_total`` tick, a new stall another;
* the port's compiles (``note_compile``) count into
  ``cxxnet_compiles_total`` and ``compile`` events once installed;
* a ``TelemetrySession`` with ``telemetry_fleet_dir`` on host 0 merges a
  slow host's snapshot and names it in the round fragment, as the JAX
  session does.
"""

import json

import pytest

from cxxnet_tpu.telemetry import aggregate as jagg
from cxxnet_tpu.telemetry import anomaly as jan
from cxxnet_tpu.telemetry.registry import MetricRegistry as JaxRegistry
from cxxnet_tpu_torch.telemetry import aggregate as pagg
from cxxnet_tpu_torch.telemetry import anomaly as pan
from cxxnet_tpu_torch.telemetry.ledger import LEDGER, read_ledger
from cxxnet_tpu_torch.telemetry.registry import MetricRegistry

EDGES = (0.001, 0.01, 0.1, 1.0)


def _fill(reg, host: int) -> None:
    """The same contents in either package's registry."""
    c = reg.counter("cxxnet_t_requests_total", "Requests",
                    labels=("result",))
    c.labels("ok").inc(3 + host)
    c.labels("failed").inc(host)
    reg.gauge("cxxnet_t_queue_depth", "Queue depth").set(2.5 * (host + 1))
    reg.gauge("cxxnet_t_nan", "Not a number").set(float("nan"))
    h = reg.histogram("cxxnet_steptime_step_seconds", "Step time",
                      buckets=EDGES)
    for v in (0.002, 0.02, 0.02, 0.5 * (host + 1), 5.0):
        h.observe(v)
    lh = reg.histogram("cxxnet_t_lat_seconds", "Latency",
                       labels=("engine",), buckets=EDGES)
    lh.labels("e1").observe(0.003 * (host + 1))


def _pair(host: int):
    p, j = MetricRegistry(), JaxRegistry()
    _fill(p, host)
    _fill(j, host)
    return p, j


def _no_ts(snap):
    return {k: v for k, v in snap.items() if k != "ts"}


@pytest.mark.parametrize("host", [0, 1, 3])
def test_export_snapshot_equals_the_jax_document(host):
    p, j = _pair(host)
    got = pagg.export_snapshot(p, host=host, run_id="r1")
    want = jagg.export_snapshot(j, host=host, run_id="r1")
    assert json.dumps(_no_ts(got), sort_keys=True) == \
        json.dumps(_no_ts(want), sort_keys=True)


def test_render_fleet_text_equals_the_jax_text():
    pairs = [_pair(h) for h in range(3)]
    got = pagg.render_fleet(pagg.merge_snapshots(
        [pagg.export_snapshot(p, host=h) for h, (p, _) in enumerate(pairs)]))
    want = jagg.render_fleet(jagg.merge_snapshots(
        [jagg.export_snapshot(j, host=h) for h, (_, j) in enumerate(pairs)]))
    assert got == want
    assert 'host="fleet"' in got
    assert 'cxxnet_t_requests_total{host="fleet",result="ok"} 12' in got


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_aggregator_reads_the_other_packages_snapshot(tmp_path, writer):
    p1, j1 = _pair(1)
    if writer == "jax":
        jagg.write_snapshot(str(tmp_path), 1, j1, run_id="run")
    else:
        pagg.write_snapshot(str(tmp_path), 1, p1, run_id="run")
    p0, j0 = _pair(0)
    got = pagg.FleetAggregator(str(tmp_path), host=0, registry=p0,
                               run_id="run")
    want = jagg.FleetAggregator(str(tmp_path), host=0, registry=j0,
                                run_id="run")
    assert got.view().hosts == want.view().hosts == [0, 1]
    assert got.render() == want.render()
    # another run's file is not read
    other = pagg.FleetAggregator(str(tmp_path), host=0, registry=p0,
                                 run_id="other")
    assert other.view().hosts == [0]
    assert pagg.quantile(list(EDGES), [1, 2, 0, 1, 1], 0.5) == \
        jagg.quantile(list(EDGES), [1, 2, 0, 1, 1], 0.5)


def _per_host(meds):
    """A step histogram a host at each median (10 observations)."""
    out = {}
    for h, m in meds.items():
        reg = MetricRegistry()
        hist = reg.histogram("s", buckets=EDGES)
        for _ in range(10):
            hist.observe(m)
        edges, counts, s, n = reg.get("s").samples()[0][1].raw()
        out[h] = {"buckets": list(edges), "counts": counts, "sum": s,
                  "count": n}
    return out


@pytest.mark.parametrize("meds", [
    {0: 0.02, 1: 0.02, 2: 0.5}, {0: 0.02, 1: 0.03}, {0: 0.02},
    {0: 0.005, 1: 0.5, 2: 0.5, 3: 0.005}])
def test_straggler_verdicts_equal_the_jax_rule(meds, tmp_path):
    ph = _per_host(meds)
    got = pan.StragglerDetector(registry=MetricRegistry()).verdicts_from(ph)
    want = jan.StragglerDetector(registry=JaxRegistry()).verdicts_from(ph)
    assert got == want
    assert pan.StragglerDetector.fragment(got) == \
        jan.StragglerDetector.fragment(want)


def test_storm_detector_fires_as_the_jax_one(tmp_path):
    led = tmp_path / "l.jsonl"
    LEDGER.enable(str(led), "r")
    try:
        p = pan.RecompileStormDetector(window_s=10, threshold=3, grace=2,
                                       registry=MetricRegistry())
        j = jan.RecompileStormDetector(window_s=10, threshold=3, grace=2,
                                       registry=JaxRegistry())
        feed = [(0, 1), (1, 2), (2, 3), (3, 7), (4, 8), (20, 8), (21, 9),
                (22, 13), (40, 13)]
        assert [p.observe(n, now=t) for t, n in feed] == \
            [j.observe(n, now=t) for t, n in feed]
        assert p.storms == j.storms == 2
    finally:
        LEDGER.disable()
    ev = [e for e in read_ledger(str(led)) if e["event"] == "recompile_storm"]
    assert len(ev) == 2


def test_a_stalled_counter_gives_one_hang_dump(tmp_path):
    led = tmp_path / "l.jsonl"
    reg = MetricRegistry()
    steps = {"n": 0}
    wd = pan.HangWatchdog(2.0, progress_fn=lambda: steps["n"], registry=reg)
    LEDGER.enable(str(led), "r")
    try:
        wd._tick(now=0.0)             # baseline: not armed
        wd._tick(now=5.0)             # no step yet: startup, no dump
        steps["n"] = 1
        wd._tick(now=6.0)             # armed
        for t in (6.5, 7.0, 8.5, 9.0, 12.0):
            wd._tick(now=t)           # one stall, one dump
        steps["n"] = 2
        wd._tick(now=13.0)
        wd._tick(now=16.0)            # a new stall, a second dump
    finally:
        LEDGER.disable()
    dumps = [e for e in read_ledger(str(led)) if e["event"] == "hang_dump"]
    assert [d["stalled_for_s"] for d in dumps] == [2.5, 3.0]
    assert all("thread" in d["stacks"].lower() for d in dumps)
    assert wd.dumps == 2
    assert reg.get("cxxnet_hangs_total").value == 2


def test_compiles_count_once_installed(tmp_path):
    from cxxnet_tpu_torch.telemetry.registry import REGISTRY
    led = tmp_path / "l.jsonl"
    LEDGER.enable(str(led), "r")
    try:
        pan.install_compile_counter()
        before = REGISTRY.get("cxxnet_compiles_total").value
        pan.note_compile(1.5, "bn_fwd.cu")
        pan.note_compile(0.01, "lm:step/8/64")
        assert REGISTRY.get("cxxnet_compiles_total").value == before + 2
    finally:
        LEDGER.disable()
    ev = [e for e in read_ledger(str(led)) if e["event"] == "compile"]
    assert [(e["seconds"], e["what"]) for e in ev] == \
        [(1.5, "bn_fwd.cu"), (0.01, "lm:step/8/64")]


def test_session_names_a_slow_host_as_the_jax_session(tmp_path):
    """Host 0's session merges host 1's pushed snapshot (50x its median
    step: the process-global histogram holds whatever ran before) and
    names it in the round fragment, in both packages."""
    from cxxnet_tpu.config import parse_telemetry_config as jax_tc
    from cxxnet_tpu.telemetry import TelemetrySession as JaxSession
    from cxxnet_tpu.telemetry.registry import REGISTRY as JREG
    from cxxnet_tpu_torch.config import parse_telemetry_config
    from cxxnet_tpu_torch.telemetry import TelemetrySession
    from cxxnet_tpu_torch.telemetry.registry import REGISTRY as PREG
    frags = {}
    for name, sess, parse, reg, agg, wreg in (
            ("port", TelemetrySession, parse_telemetry_config, PREG, pagg,
             MetricRegistry),
            ("jax", JaxSession, jax_tc, JREG, jagg, JaxRegistry)):
        d = tmp_path / name
        pairs = [("telemetry_fleet_dir", str(d)),
                 ("telemetry_run_id", "fleet-run"),
                 ("telemetry_straggler_min_steps", "4"),
                 ("telemetry_push_interval", "3600")]
        s = sess(parse(pairs), silent=True)
        try:
            fam = reg.histogram("cxxnet_steptime_step_seconds")
            for _ in range(20):
                fam.observe(0.02)
            edges, counts, _, _ = fam.samples()[0][1].raw()
            med = agg.quantile(list(edges), counts, 0.5)
            slow = wreg()
            h = slow.histogram("cxxnet_steptime_step_seconds",
                               buckets=edges)
            for _ in range(8):
                h.observe(50 * med)
            agg.write_snapshot(str(d), 1, slow, run_id="fleet-run")
            frags[name] = s.round_tick(0)
        finally:
            s.close()
    for frag in frags.values():
        assert "\tfleet_p50_ms:h0=" in frag and "\tstraggler:h1(" in frag
