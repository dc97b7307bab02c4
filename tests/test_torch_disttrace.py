"""Distributed tracing of the port (``telemetry/disttrace.py``) against
the JAX package's, on the CPU.

* ``parse_traceparent`` / ``TraceContext.traceparent`` round trips and
  the malformed carriers equal to the JAX functions; ``estimate_offset``
  equal to the JAX function on the same handshakes;
* the port's tail-exemplar buffer keeps and drops root trees as the JAX
  tracer does, and a dump carries the clock anchors and offsets;
* a port reader process and a port trainer (both ``dev = cpu``, both
  with ``telemetry_trace``) give dumps that the unchanged
  ``tools/trace_assemble.py`` merges: every ``dataservice.fetch`` of the
  trainer links to a ``dataservice.serve`` of the reader, and the
  reader's clock offset is corrected from the trainer's probe.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time

import pytest

from cxxnet_tpu.telemetry import disttrace as jdt
from cxxnet_tpu_torch.main import run
from cxxnet_tpu_torch.config import parse_config_string
from cxxnet_tpu_torch.telemetry import disttrace as pdt
from cxxnet_tpu_torch.telemetry.trace import TRACER

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CARRIERS = [
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-00",
    "00-4BF92F3577B34DA6A3CE929D0E0E4736-00F067AA0BA902B7-03",
    " 00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01 ",
    "01-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
    "00-00000000000000000000000000000000-00f067aa0ba902b7-01",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-0000000000000000-01",
    "00-4bf92f3577b34da6a3ce929d0e0e473-00f067aa0ba902b7-01",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-1",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-zz",
    "00-xyz92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7",
    "", None, 17,
]


@pytest.mark.parametrize("tp", CARRIERS, ids=[f"c{i}" for i in
                                               range(len(CARRIERS))])
def test_traceparent_parse_and_format_equal_the_jax_functions(tp):
    got, want = pdt.parse_traceparent(tp), jdt.parse_traceparent(tp)
    assert (got is None) == (want is None)
    if want is not None:
        assert (got.trace_id, got.span_id, got.sampled) == \
            (want.trace_id, want.span_id, want.sampled)
        assert got.traceparent() == want.traceparent()
        child = got.child("0123456789abcdef")
        assert child.traceparent() == \
            want.child("0123456789abcdef").traceparent()


@pytest.mark.parametrize("t0,wall,t1", [
    (100.0, 100.5, 101.0), (5.0, 3.0, 5.2), (7.0, 7.0, 6.0),
    (1e9, 1e9 + 12.25, 1e9 + 0.01)])
def test_estimate_offset_equals_the_jax_function(t0, wall, t1):
    assert pdt.estimate_offset(t0, wall, t1) == \
        jdt.estimate_offset(t0, wall, t1)


def test_tail_buffer_and_dump_keys(tmp_path):
    """With ``tail_pct`` the slowest roots keep their trees: the same
    keep/drop sequence as the JAX tracer on the same durations, and the
    dump's ``otherData`` has the clock anchors, offsets and identity."""
    tr = pdt.DistTracer()
    jt = jdt.DistTracer()
    TRACER.clear()
    TRACER.enable()
    try:
        tr.enable(tail_pct=25.0, tail_window=16)
        jt.enable(tail_pct=25.0, tail_window=16)
        durs = [5, 1, 2, 9, 3, 3, 4, 8, 1, 7, 2, 12, 6, 1, 11, 2, 30]
        keeps = [(tr._tail_keep("train.step", d), jt._tail_keep(
            "train.step", d)) for d in durs]
        assert [a for a, _ in keeps] == [b for _, b in keeps]
        with tr.span("train.step") as root:
            with tr.span("dataservice.fetch"):
                TRACER.add_complete("train.h2d_stage", 0.0, 0.001)
        ev = {e["name"]: e for e in TRACER.events()}
        tid = root.ctx.trace_id
        assert ev["dataservice.fetch"]["args"]["parent_span_id"] == \
            root.ctx.span_id
        assert ev["train.h2d_stage"]["args"]["trace_id"] == tid
        tr.clock_offset("127.0.0.1:9", 0.25, 0.002)
        pdt.set_trace_identity(role="train", host=3)
        path = tmp_path / "t.json"
        TRACER.dump(str(path))
        other = json.loads(path.read_text())["otherData"]
        assert other["clock_anchors"] and other["role"] == "train"
        assert other["clock_offsets"]["127.0.0.1:9"]["offset_s"] == 0.25
    finally:
        tr.disable()
        jt.disable()
        TRACER.disable()
        TRACER.clear()


NET = """
data = train
iter = synthetic
  num_inst = 96
  num_class = 4
  input_shape = 1,1,8
  seed_data = 3
iter = end
netconfig = start
layer[+1:h1] = fullc:fc1
  nhidden = 8
layer[+1] = relu
layer[+1] = fullc:fc2
  nhidden = 4
layer[+0] = softmax
netconfig = end
input_shape = 1,1,8
batch_size = 16
dev = cpu
num_round = 1
save_model = 0
print_step = 0
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_trainer_and_reader_dumps_assemble_with_flow_links(tmp_path):
    ep = f"127.0.0.1:{_free_port()}"
    conf = tmp_path / "n.conf"
    conf.write_text(NET + f"data_service = {ep}\ndata_service_shards = 1\n"
                    "data_service_timeout_ms = 30000\n")
    status = tmp_path / "status"
    reader_trace = tmp_path / "reader.json"
    trainer_trace = tmp_path / "trainer.json"
    proc = subprocess.Popen(
        [sys.executable, "-m", "cxxnet_tpu_torch.main", str(conf),
         "task=data_reader", "data_service_reader=0",
         f"data_service_status_dir={status}",
         f"telemetry_trace={reader_trace}"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        deadline = time.monotonic() + 120
        while not (status / "reader_0.json").exists():
            assert proc.poll() is None and time.monotonic() < deadline
            time.sleep(0.05)
        run(parse_config_string(conf.read_text()) + [
            ("telemetry_trace", str(trainer_trace)),
            ("telemetry_trace_sample", "1")])
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, out
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "trace_assemble.py"),
         str(trainer_trace), str(reader_trace), "-o",
         str(tmp_path / "fleet.json"), "--report", str(tmp_path / "cp.json")],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, timeout=120)
    assert r.returncode == 0, r.stdout
    report = json.loads((tmp_path / "cp.json").read_text())
    load = lambda p: [e for e in json.loads(p.read_text())["traceEvents"]
                      if e.get("ph") == "X"]
    fetch = [e for e in load(trainer_trace)
             if e["name"] == "dataservice.fetch"]
    serve = {e["args"]["parent_span_id"]: e for e in load(reader_trace)
             if e["name"] == "dataservice.serve"}
    assert len(fetch) == 96 // 16 + 1         # the batches and the end
    assert all(e["args"]["span_id"] in serve for e in fetch)
    assert report["flow_links"] >= len(fetch)
    roles = {p["role"] for p in report["processes"]}
    assert roles == {"train", "data_reader"}
    reader = next(p for p in report["processes"]
                  if p["role"] == "data_reader")
    assert reader["aligned"]
    other = json.loads(trainer_trace.read_text())["otherData"]
    assert ep in other["clock_offsets"]
