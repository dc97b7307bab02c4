"""The loss sentinel and the ``device.step`` failpoint of the port against
the JAX package's, on the CPU (``torch_telemetry_fixture``: one narrow
LeNet run of each package from the same round 0, on the same synthetic
data, with ``failpoints = device.step=every:5`` and no ``sentinel``
key).

* With no ``sentinel`` key both packages trip on the same round and roll
  back to the same checkpoint (the default is on, as in the JAX
  package's ``main.py``), with the same LR backoff, and count the trip
  and the rollback.
* Their parameters after the run agree within 1e-5 (f32, relative L2 of
  every leaf).
* The failpoint modes and the sentinel's rules match the JAX package's:
  ``once`` / ``every:N[@P]`` / ``prob:p[@K]`` fire on the same checks
  from the same seed, and the sentinel flags the same losses.
* ``sentinel = 0`` turns it off: the same poisoned step trains on.
"""

import numpy as np
import pytest

from cxxnet_tpu.resilience import failpoints as jax_fp
from cxxnet_tpu.resilience.sentinel import TrainingSentinel as JaxSentinel
from cxxnet_tpu_torch.resilience import failpoints as port_fp
from cxxnet_tpu_torch.resilience.sentinel import (SentinelAbort,
                                                  TrainingSentinel)

from torch_telemetry_fixture import FAULT, paired_runs

#: relative L2 of each parameter leaf after the run, port vs JAX (f32)
PARAM_TOL = 1e-5


def _rollbacks(run):
    return [r for r in run["ledger"] if r["event"] in ("sentinel_trip",
                                                       "rollback")]


def test_both_trip_on_the_same_round_and_roll_back_to_the_same_round():
    runs = paired_runs()
    got, want = _rollbacks(runs["port"]), _rollbacks(runs["jax"])
    assert [(r["event"], r["round"], r.get("to_round"), r["step"])
            for r in got] == [(r["event"], r["round"], r.get("to_round"),
                               r["step"]) for r in want]
    assert [r["event"] for r in got] == ["sentinel_trip", "rollback"]
    trip, back = got
    assert back["to_round"] == 1 and back["path"].endswith("0001.model")
    assert back["lr_scale"] == want[1]["lr_scale"] == 0.5
    assert trip["reason"].startswith("non-finite loss nan")
    assert trip["reason"] == want[0]["reason"]
    for run in runs.values():
        assert "sentinel: non-finite loss nan" in run["stdout"]
        assert "rolled back to round 1" in run["stdout"]


def test_parameters_after_the_run_agree():
    runs = paired_runs()
    got, want = runs["port"]["final"], runs["jax"]["final"]
    assert got["meta"]["round"] == want["meta"]["round"] == 2
    assert got["meta"]["lr_scale"] == want["meta"]["lr_scale"] == 0.5
    worst = 0.0
    for layer, leaves in want["params"].items():
        for leaf, w in leaves.items():
            g = got["params"][layer][leaf]
            assert np.isfinite(g).all()
            rel = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
            worst = max(worst, rel)
    assert worst < PARAM_TOL, worst


def test_the_run_counts_the_trip_and_the_rollback():
    from cxxnet_tpu_torch.resilience import counters
    paired_runs()
    assert counters.get("sentinel.anomalies") >= 1
    assert counters.get("sentinel.rollbacks") >= 1


@pytest.mark.parametrize("spec", [
    "s=once", "s=every:3", "s=every:4@1", "s=prob:0.3", "s=0.25",
    "s=prob:0.5@7", "s=off"])
def test_failpoint_modes_fire_on_the_same_checks(spec, monkeypatch):
    monkeypatch.setenv("CXXNET_FAILPOINT_SEED", "11")
    fired, active = [], []
    for fp in (port_fp.Failpoints(), jax_fp.Failpoints()):
        fp.configure(spec)
        active.append(fp.active())
        fired.append([fp.fire("s") for _ in range(40)])
    assert active[0] == active[1]
    assert fired[0] == fired[1]


def test_failpoint_specs_refused_alike():
    for bad in ("s", "s=every:0", "s=prob:2", "s=sometimes", "=once"):
        with pytest.raises(port_fp.FailpointSpecError):
            port_fp.Failpoints().configure(bad)
        with pytest.raises(jax_fp.FailpointSpecError):
            jax_fp.Failpoints().configure(bad)


def test_sentinel_flags_the_same_losses():
    rs = np.random.RandomState(0)
    losses = list(rs.uniform(1, 2, 30)) + [50.0, float("inf"), 1.5,
                                           float("nan"), 1.4]
    mine = TrainingSentinel(spike_factor=10, window=8, min_history=4,
                            max_rollbacks=2)
    ref = JaxSentinel(spike_factor=10, window=8, min_history=4,
                      max_rollbacks=2)
    assert [mine.observe(v) for v in losses] \
        == [ref.observe(v) for v in losses]
    mine.record_rollback(1, "x")
    mine.record_rollback(1, "y")
    with pytest.raises(SentinelAbort, match="max_rollbacks=2"):
        mine.record_rollback(1, "z")


def test_sentinel_off_trains_on_the_poisoned_step(tmp_path):
    """``sentinel = 0``: the NaN step is not rolled back, and its NaN
    masters are written."""
    import shutil
    from cxxnet_tpu_torch import checkpoint as ckpt
    from cxxnet_tpu_torch import main as port_main
    runs = paired_runs()
    root = tmp_path / "off"
    shutil.copytree(runs["port"]["dir"] + "/models", str(root / "models"),
                    ignore=shutil.ignore_patterns("000[12].model"))
    conf = runs["port"]["dir"] + "/lenet.conf"
    port_fp.clear()
    try:
        port_main.main([conf, f"model_dir={root}/models", f"failpoints={FAULT}",
                        "sentinel=0", "silent=1"])
    finally:
        port_fp.clear()
    final = ckpt.load_model(ckpt.model_path(str(root / "models"), 2))
    assert not all(np.isfinite(w).all() for lv in final["params"].values()
                   for w in lv.values())
    assert final["meta"]["lr_scale"] == 1.0


# -- the other failpoint sites of the port ------------------------------------

@pytest.fixture()
def armed():
    """Arm one port failpoint site for a test; disarmed after."""
    def arm(spec):
        port_fp.configure(spec)
    yield arm
    port_fp.clear()


def _tiny_round(path):
    from cxxnet_tpu_torch import checkpoint as ckpt
    ckpt.save_model(path, structure_sig=("x",), round_counter=0,
                    epoch_counter=0, params={"l": {"w": np.ones(3,
                                                                np.float32)}},
                    net_state={})


@pytest.mark.parametrize("site", ["ckpt.write", "io.write"])
def test_a_checkpoint_write_fault_leaves_no_round(tmp_path, armed, site):
    """``ckpt.write`` fails before anything is written, ``io.write``
    between the temp file and its rename (its orphan is what the resume
    scan sweeps): either way no round appears, as in the JAX package."""
    import os
    path = str(tmp_path / "0000.model")
    armed(f"{site}=once")
    with pytest.raises(IOError, match=site):
        _tiny_round(path)
    assert not os.path.exists(path)
    orphans = [f for f in os.listdir(tmp_path) if ".tmp." in f]
    assert len(orphans) == (1 if site == "io.write" else 0)
    _tiny_round(path)                     # disarmed: the write goes through
    assert os.path.exists(path)


@pytest.mark.parametrize("site", ["io.open", "io.read"])
def test_a_checkpoint_read_fault_raises_and_the_scan_skips(tmp_path, armed,
                                                            site):
    from cxxnet_tpu_torch import checkpoint as ckpt
    from cxxnet_tpu_torch.resilience import counters
    from cxxnet_tpu_torch.io import stream
    from cxxnet_tpu_torch.config import RetryPolicy
    _tiny_round(str(tmp_path / "0000.model"))
    # the stream layer retries a read while an io.* site is armed, as in
    # the JAX package: a fault that fires once costs one retry
    stream.set_retry_policy(RetryPolicy(base_delay_s=0.0, max_delay_s=0.0))
    try:
        retries = counters.get("io.retries")
        armed(f"{site}=once")
        assert ckpt.load_model(str(tmp_path / "0000.model"))["meta"][
            "round"] == 0
        assert counters.get("io.retries") == retries + 1
        # a fault that fires on every attempt raises, and the scan skips
        armed(f"{site}=every:1")
        with pytest.raises(IOError, match=site):
            ckpt.load_model(str(tmp_path / "0000.model"))
        before = counters.get("ckpt.skipped_invalid")
        assert ckpt.find_latest_valid(str(tmp_path)) is None
        assert counters.get("ckpt.skipped_invalid") == before + 1
    finally:
        stream.set_retry_policy(RetryPolicy())


def test_record_decode_faults_skip_the_same_records(tmp_path, monkeypatch):
    """``record.decode = every:3`` skips records 3, 6, ... in both
    packages' readers, each skip counted as ``recordio.skipped``."""
    from cxxnet_tpu.io.recordio import RecordReader as JaxReader
    from cxxnet_tpu.resilience import counters as jax_counters
    from cxxnet_tpu_torch.io.recordio import RecordReader, RecordWriter
    from cxxnet_tpu_torch.resilience import counters
    path = str(tmp_path / "r.rec")
    with RecordWriter(path) as w:
        for i in range(10):
            w.write(bytes([i]) * (i + 1))
    got = []
    for reader, fp, cnt in ((RecordReader, port_fp, counters),
                            (JaxReader, jax_fp, jax_counters)):
        before = cnt.get("recordio.skipped")
        fp.configure("record.decode=every:3")
        try:
            got.append([p[0] for p in reader(path)])
        finally:
            fp.clear()
        assert cnt.get("recordio.skipped") == before + 3
    assert got[0] == got[1] == [0, 1, 3, 4, 6, 7, 9]


def test_a_serve_infer_fault_fails_the_dispatch(armed):
    """``serve.infer`` fails the engine's dispatch (what trips the serve
    breaker): the request fails, the next one is answered."""
    from torch_fleet_fixture import port_pool, rows
    pool = port_pool(1)
    try:
        armed("serve.infer=once")
        with pytest.raises(RuntimeError, match="serve.infer"):
            pool.submit(rows(2)).result(timeout=30)
        assert pool.submit(rows(2)).result(timeout=30).shape == (2,)
        snap = pool.replicas[0].engine.stats.snapshot()
        assert snap["requests"]["failed"] == 1
    finally:
        pool.close()
