"""Incident replay of the port (``cxxnet_tpu_torch/replay/``, ``python
-m cxxnet_tpu_torch.replay``) against the JAX package's, on the CPU.

The run: ``torch_telemetry_fixture``'s narrow LeNet with ``health = 1``
trains rounds 1 and 2 from round 0 through the port's ``main`` with
``failpoints = device.step=every:5``; the sentinel trips at step 7 and
rolls back to round 1, both events with the provenance.

* the port's ``reconstruct`` gives the JAX ``reconstruct``'s plan on that
  port-written ledger, for each incident, but for a rollback's trip step
  and losses, which the port takes from the paired ``sentinel_trip``
  (the JAX executor is not run);
* ``--last --failpoints on`` replays the trip ``bit_exact`` with the
  recorded provenance (exit 0) and writes ``replay_start`` and
  ``replay_verdict``; ``--failpoints off`` replays the clean window
  (exit 0); ``--list`` lists both incidents;
* a ``--config`` whose ``eta`` differs exits 3 with
  ``unreproducible:config-drift``; an unknown flag or a bad override
  exits 4.
"""

import contextlib
import dataclasses
import functools
import io
import os
import tempfile

import pytest

from cxxnet_tpu_torch.replay import reconstruct
from cxxnet_tpu_torch.replay.__main__ import main as replay_main
from cxxnet_tpu_torch.telemetry.ledger import read_ledger

from torch_telemetry_fixture import FAULT, LENET, write_round0


@functools.lru_cache(maxsize=None)
def tripped_run():
    """(ledger path, config path) of the port run with health = 1."""
    from cxxnet_tpu_torch import main as port_main
    from cxxnet_tpu_torch.resilience import failpoints
    root = tempfile.mkdtemp(prefix="cxxnet_replay_")
    write_round0(os.path.join(root, "models"))
    conf = os.path.join(root, "lenet.conf")
    with open(conf, "w") as f:
        f.write(LENET + f"model_dir = {root}/models\nhealth = 1\n"
                f"telemetry_ledger = {root}/ledger.jsonl\n"
                f'failpoints = "{FAULT}"\n')
    failpoints.clear()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            port_main.main([conf])
    finally:
        failpoints.clear()
    return os.path.join(root, "ledger.jsonl"), conf


def _cli(*args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = replay_main(list(args))
    return rc, out.getvalue()


def test_the_run_records_a_trip_with_provenance():
    ledger, _ = tripped_run()
    ev = [e for e in read_ledger(ledger)
          if e["event"] in ("sentinel_trip", "rollback")]
    assert [e["event"] for e in ev] == ["sentinel_trip", "rollback"]
    assert ev[0]["provenance"] == ev[1]["provenance"] == \
        "layer=cv1 kind=param leaf=bias"
    # the trip's step; the rollback's is the restored count (round 1's)
    assert ev[0]["step"] == 7 and ev[1]["step"] == 4
    assert ev[1]["to_round"] == 1


@pytest.mark.parametrize("incident", [0, 1, None])
def test_reconstruct_gives_the_jax_plan(incident):
    """The JAX plan, but for a rollback's trip step and losses: the port
    takes them from the paired ``sentinel_trip``, where the JAX package
    takes the rollback's own ``step`` (the restored count) and no
    losses."""
    from cxxnet_tpu.replay import reconstruct as jax_reconstruct
    ledger, _ = tripped_run()
    got = dataclasses.asdict(reconstruct(ledger, incident=incident))
    want = dataclasses.asdict(jax_reconstruct(ledger, incident=incident))
    if incident != 0:                    # the rollback (the last)
        trip = dataclasses.asdict(jax_reconstruct(ledger, incident=0))
        assert (want["target_step"], want["trip_losses"]) == (4, None)
        want.update(target_step=trip["target_step"],
                    trip_losses=trip["trip_losses"])
    assert got == want
    assert got["start_round"] == 1 and got["rounds"] == [2]
    assert got["target_step"] == 7 and len(got["trip_losses"]) >= 1


def test_replay_with_the_fault_is_bit_exact():
    ledger, _ = tripped_run()
    out_ledger = ledger + ".replay.jsonl"
    if os.path.exists(out_ledger):
        os.remove(out_ledger)
    rc, out = _cli(ledger, "--last", "--failpoints", "on")
    assert rc == 0, out
    assert "verdict: bit_exact" in out
    assert "replayed='layer=cv1 kind=param leaf=bias' OK" in out
    assert "device.step=every:5@4" in out      # step 5 poisoned again
    ev = [e for e in read_ledger(out_ledger)
          if e["event"].startswith("replay_")]
    assert [e["event"] for e in ev] == ["replay_start", "replay_verdict"]
    assert ev[1]["verdict"] == "bit_exact" and ev[1]["nan_step"] == 5


def test_replay_without_the_fault_and_the_list():
    ledger, _ = tripped_run()
    rc, out = _cli(ledger, "--incident", "0", "--failpoints", "off",
                   "--out-ledger", "")
    assert rc == 0, out
    assert "clean counterfactual" in out
    rc, out = _cli(ledger, "--list")
    assert rc == 0
    assert out.splitlines()[0].startswith("[0] sentinel_trip round=2 step=7")
    assert out.splitlines()[1].startswith("[1] rollback round=2 step=4")


def test_config_drift_exits_3(tmp_path):
    ledger, conf = tripped_run()
    with open(conf) as f:
        text = f.read()
    drifted = tmp_path / "drift.conf"
    drifted.write_text(text.replace("eta = 0.1", "eta = 0.2"))
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc, _ = _cli(ledger, "--last", "--config", str(drifted))
    assert rc == 3
    assert "unreproducible:config-drift" in err.getvalue()
    assert "eta = 0.1" in err.getvalue() and "eta = 0.2" in err.getvalue()


def test_bad_flags_exit_4():
    ledger, _ = tripped_run()
    with contextlib.redirect_stderr(io.StringIO()):
        assert _cli(ledger, "--last", "noequals")[0] == 4
        with pytest.raises(SystemExit) as e:
            _cli(ledger, "--incidnet", "0")
    assert e.value.code == 4


def test_a_missing_checkpoint_is_unreproducible(tmp_path):
    """The trip (incident 0) against an empty checkpoint store: no round
    to start from (a rollback would try its recorded path first)."""
    ledger, _ = tripped_run()
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc, _ = _cli(ledger, "--incident", "0", "--model-dir", str(tmp_path))
    assert rc == 3
    assert "unreproducible:no-valid-checkpoint" in err.getvalue()
