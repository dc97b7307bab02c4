"""The port's input data service against the JAX package's, on the CPU.

* The ``assign`` functions return the JAX functions' values over seeded
  inputs; ``pack_batch`` frames are byte-equal, uint8 batches with their
  ``norm`` (a per-channel mean and a mean image) included.
* Across the packages: a port client reading a JAX ``DataReaderServer``
  and a JAX client reading a port reader each get the batches of the
  ``data_service = local`` control, bit for bit (uint8 imgrec batches
  with ``norm``).
* The ladder: a second client is served from the reader's cache; an
  error frame fails over to the survivor; a reader lost mid-epoch
  leaves the stream bit-exact; no reader degrades once, with one
  warning; ``data_service_local_fallback = 0`` raises.
* ``set_epoch``: a resumed stream is the uninterrupted run's epoch;
  ``continue = 1`` over the service trains the rounds of an
  uninterrupted run bit for bit.
* ``parse_data_service_config`` raises the JAX messages; the status file
  and the ``cxxnet_dataservice_*`` series of ``GET /metrics`` are the
  JAX reader's.
* ``task = data_reader`` through ``python -m cxxnet_tpu_torch.main``
  serves until SIGTERM.
* The narrow LeNet of ``torch_telemetry_fixture`` trained for 2 rounds
  over two port readers is within 1e-5 (relative L2 of each leaf) of the
  JAX trainer over two JAX readers from the same round 0, and bit-equal
  to the port's own ``data_service = local`` run; ``test_io = 1``
  prints the JAX package's round line.

Readers bind ``127.0.0.1`` on a free port; every socket wait has a
deadline, and states are polled, never slept for.
"""

import contextlib
import io
import json
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from cxxnet_tpu import main as jax_main
from cxxnet_tpu.config import ConfigError as JaxConfigError
from cxxnet_tpu.config import \
    parse_data_service_config as jax_parse_svc
from cxxnet_tpu.data_service import assign as jax_assign
from cxxnet_tpu.data_service import wire as jax_wire
from cxxnet_tpu.data_service.client import \
    build_service_iterator as jax_build
from cxxnet_tpu.data_service.reader import DataReaderServer as JaxReader
from cxxnet_tpu.io.data import DataBatch as JaxBatch
from cxxnet_tpu.resilience import failpoints as jax_fp
from cxxnet_tpu.telemetry.exporter import render_prometheus as jax_render
from cxxnet_tpu.telemetry.registry import REGISTRY as JAX_REGISTRY
from cxxnet_tpu_torch import checkpoint as ckpt
from cxxnet_tpu_torch import main as port_main
from cxxnet_tpu_torch.config import (ConfigError, parse_config_string,
                                     parse_data_service_config,
                                     split_sections)
from cxxnet_tpu_torch.data_service import assign, wire
from cxxnet_tpu_torch.data_service.client import (DataServiceClient,
                                                  NoReaderAvailable,
                                                  build_service_iterator)
from cxxnet_tpu_torch.data_service.reader import DataReaderServer
from cxxnet_tpu_torch.io import recordio as prec
from cxxnet_tpu_torch.io.data import DataBatch
from cxxnet_tpu_torch.resilience import failpoints as port_fp
from cxxnet_tpu_torch.telemetry.exporter import render_prometheus
from cxxnet_tpu_torch.telemetry.registry import REGISTRY

from torch_imgrec_fixture import image, png_bytes, write_records
from torch_telemetry_fixture import LENET, write_round0

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SECTION = parse_config_string("""
iter = synthetic
num_inst = 96
batch_size = 16
num_class = 5
input_shape = 1,1,8
io_retry_attempts = 2
io_retry_base_ms = 5
io_retry_max_ms = 20
""")

#: relative L2 of each parameter leaf, port against JAX (f32)
PARAM_TOL = 1e-5
#: seconds any wait on a reader may take
DEADLINE_S = 60.0


@pytest.fixture(autouse=True)
def _clean_failpoints():
    port_fp.clear()
    jax_fp.clear()
    yield
    port_fp.clear()
    jax_fp.clear()


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _pairs(endpoints, shards, kv):
    pairs = [("data_service", endpoints),
             ("data_service_shards", str(shards))]
    kv = dict(kv)
    kv.setdefault("data_service_prefetch", 0)
    return pairs + [(k, str(v)) for k, v in kv.items()]


def _svc(endpoints, shards=3, **kv):
    return parse_data_service_config(_pairs(endpoints, shards, kv))


def _jsvc(endpoints, shards=3, **kv):
    return jax_parse_svc(_pairs(endpoints, shards, kv))


@contextlib.contextmanager
def _fleet(n, section=SECTION, shards=3, jax=False, **kv):
    """``n`` readers of one package in this process; their endpoints."""
    endpoints = ",".join(f"127.0.0.1:{_free_port()}" for _ in range(n))
    cls, svc = (JaxReader, _jsvc) if jax else (DataReaderServer, _svc)
    readers = []
    try:
        for i in range(n):
            r = cls(section, svc(endpoints, shards,
                                 data_service_reader=i, **kv))
            r.start()
            readers.append(r)
        yield endpoints, readers
    finally:
        for r in readers:
            r.stop()


def _stream(it, epoch=None):
    if epoch is not None:
        it.set_epoch(epoch)
    it.before_first()
    out = []
    while True:
        b = it.next()
        if b is None:
            return out
        out.append(b)


def _same(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a.data.dtype == b.data.dtype
        np.testing.assert_array_equal(a.data, b.data)
        np.testing.assert_array_equal(a.label, b.label)
        np.testing.assert_array_equal(a.inst_index, b.inst_index)
        assert a.num_batch_padd == b.num_batch_padd
        assert (a.norm is None) == (b.norm is None)
        if a.norm is not None:
            assert sorted(a.norm) == sorted(b.norm)
            for k in a.norm:
                np.testing.assert_array_equal(np.asarray(a.norm[k]),
                                              np.asarray(b.norm[k]))


def _local(section=SECTION, shards=3):
    return _stream(build_service_iterator(section, _svc("local", shards)))


# -- assignment and frames ------------------------------------------------------

def test_the_assign_functions_are_the_jax_functions():
    rs = np.random.RandomState(0)
    for _ in range(20):
        n_readers = int(rs.randint(1, 6))
        readers = [f"h{i}:{9000 + i}" for i in range(n_readers)]
        sizes = rs.randint(0, 50, int(rs.randint(1, 13))).tolist()
        a = assign.assign_shards(sizes, readers)
        assert a == jax_assign.assign_shards(sizes, readers)
        assert assign.owner_map(a) == jax_assign.owner_map(a)
        live = readers[:max(1, n_readers - 1)]
        grown = readers + ["new:1"]
        for members in (live, grown):
            b = assign.rebalance(a, sizes, members)
            assert b == jax_assign.rebalance(a, sizes, members)
            assert assign.moved_shards(a, b) == \
                jax_assign.moved_shards(a, b)
        owner = readers[int(rs.randint(n_readers))]
        assert assign.failover_order(readers, owner) == \
            jax_assign.failover_order(readers, owner)
        seed, epoch = (int(v) for v in rs.randint(0, 1000, 2))
        assert assign.epoch_permutation(seed, epoch, len(sizes)) == \
            jax_assign.epoch_permutation(seed, epoch, len(sizes))
        assert assign.stream_seed(seed, epoch, 3) == \
            jax_assign.stream_seed(seed, epoch, 3)
    with pytest.raises(ValueError, match="duplicate reader"):
        assign.assign_shards([1], ["a:1", "a:1"])


@pytest.mark.parametrize("norm", ["none", "scalars", "channel_mean",
                                  "mean_image"])
def test_pack_batch_frames_are_byte_equal(norm):
    rs = np.random.RandomState(3)
    data = rs.randint(0, 256, (4, 5, 6, 3)).astype(np.uint8)
    label = rs.randint(0, 9, (4, 2)).astype(np.float32)
    inst = np.arange(10, 14, dtype=np.int64)
    nm = {"none": None,
          "scalars": {"mean": None, "divideby": 255.0, "scale": 1.0},
          "channel_mean": {"mean": np.float32([1.5, 2.5, 3.5]),
                           "divideby": 1.0, "scale": 0.5},
          "mean_image": {"mean": rs.rand(5, 6, 3).astype(np.float32),
                         "divideby": 2.0, "scale": 1.0}}[norm]
    meta = {"epoch": 1, "shard": 2, "batch": 3}
    got = wire.pack_batch(DataBatch(data=data, label=label,
                                    num_batch_padd=1, inst_index=inst,
                                    norm=nm), **meta)
    want = jax_wire.pack_batch(JaxBatch(data=data, label=label,
                                        num_batch_padd=1, inst_index=inst,
                                        norm=nm), **meta)
    assert got == want
    assert wire.pack_eos(**meta) == jax_wire.pack_eos(**meta)
    assert wire.pack_error("x", **meta) == jax_wire.pack_error("x", **meta)
    a, b = socket.socketpair()
    try:
        a.sendall(got)
        back = wire.batch_from(*wire.recv_frame(b, time.monotonic() + 10))
    finally:
        a.close()
        b.close()
    _same([back], [DataBatch(data=data, label=label, num_batch_padd=1,
                             inst_index=inst, norm=nm)])
    assert back.data.flags.writeable


# -- across the packages --------------------------------------------------------

@pytest.fixture(scope="module")
def imgrec_section(tmp_path_factory):
    """A uint8 imgrec section (30 PNG records, crop and mirror, a
    per-channel mean: batches carry ``norm``) split into 2 shards."""
    d = tmp_path_factory.mktemp("dsrec")
    rs = np.random.RandomState(6)
    path = str(d / "t.rec")
    write_records(path, [png_bytes(image(rs, 20, 22)) for _ in range(30)],
                  prec.RecordWriter, prec.ImageRecord,
                  ids=list(range(30)))
    return parse_config_string(f"""
iter = imgrec
image_rec = {path}
input_shape = 3,16,16
batch_size = 4
rand_crop = 1
rand_mirror = 1
shuffle = 1
device_normalize = 1
mean_value = 120,110,100
divideby = 64
silent = 1
dev = cpu
""")


@pytest.mark.parametrize("client,reader", [("port", "jax"),
                                           ("jax", "port")])
def test_a_client_reads_the_other_package_reader(imgrec_section, client,
                                                 reader):
    want = _local(imgrec_section, shards=2)
    assert want[0].data.dtype == np.uint8 and want[0].norm is not None
    with _fleet(1, imgrec_section, shards=2,
                jax=reader == "jax") as (eps, readers):
        if client == "port":
            it = build_service_iterator(imgrec_section, _svc(eps, 2))
        else:
            it = jax_build(imgrec_section, _jsvc(eps, 2))
        got = _stream(it)
        it.close()
        assert not it.degraded and readers[0].served == len(got) + 2
    _same(got, want)


def test_a_second_client_is_served_from_the_cache():
    want = _local()
    with _fleet(1, data_service_readahead=0) as (eps, (reader,)):
        first = build_service_iterator(SECTION, _svc(eps))
        _same(_stream(first), want)
        hits, served = reader.cache_hits, reader.served
        second = build_service_iterator(SECTION, _svc(eps))
        _same(_stream(second), want)
        assert reader.served - served == len(want) + 3
        assert reader.cache_hits - hits == reader.served - served
        for it in (first, second):
            it.close()


def test_an_error_frame_fails_over_to_the_survivor():
    with _fleet(2) as (eps, readers):
        client = DataServiceClient(_svc(eps), SECTION)
        owner = assign.owner_map(client.assignment)[0]
        port_fp.configure("data.serve=once")
        _header, batch = client.fetch(0, 0, 0)
        assert batch is not None and client.failovers == 1
        assert owner not in client.live and len(client.live) == 1
        assert sorted(assign.owner_map(client.assignment)) == [0, 1, 2]
        port_fp.configure("data.fetch=once")
        client.fetch(0, 1, 0)                  # retried, not failed over
        assert port_fp.fired("data.fetch") == 1 and client.failovers == 1
        client.close()


def test_a_reader_lost_mid_epoch_leaves_the_stream_bit_exact():
    want = _local()
    with _fleet(2) as (eps, readers):
        it = build_service_iterator(SECTION, _svc(eps))
        it.before_first()
        got = [it.next() for _ in range(5)]
        readers[1].stop()
        while True:
            b = it.next()
            if b is None:
                break
            got.append(b)
        assert not it.degraded
        it.close()
    _same(got, want)


def test_no_reader_degrades_once_with_one_warning(capsys):
    from cxxnet_tpu_torch.resilience import counters  # noqa: F401
    fam = REGISTRY.counter(
        "cxxnet_dataservice_degrades_total",
        "Service clients that fell back to the local pipeline")
    before = fam.labels().value
    dead = f"127.0.0.1:{_free_port()},127.0.0.1:{_free_port()}"
    it = build_service_iterator(SECTION, _svc(dead))
    got = _stream(it)
    _same(got, _local())
    _same(_stream(it, epoch=0), got)
    assert it.degraded and it.client is None
    out = capsys.readouterr().out.splitlines()
    assert len([ln for ln in out if "degraded to the local input "
                "pipeline" in ln]) == 1
    assert fam.labels().value == before + 1


@pytest.mark.parametrize("prefetch", [0, 2])
def test_no_fallback_raises(prefetch):
    dead = f"127.0.0.1:{_free_port()}"
    it = build_service_iterator(SECTION, _svc(
        dead, data_service_local_fallback=0,
        data_service_prefetch=prefetch))
    with pytest.raises(NoReaderAvailable, match="local_fallback=0"):
        _stream(it)
    it.close()


def test_set_epoch_resumes_the_uninterrupted_stream():
    it = build_service_iterator(SECTION, _svc("local"))
    epochs = [_stream(it) for _ in range(3)]
    resumed = build_service_iterator(SECTION, _svc("local"))
    _same(_stream(resumed, epoch=1), epochs[1])
    _same(_stream(resumed), epochs[2])
    with pytest.raises(AssertionError):
        _same(epochs[0], epochs[1])


# -- configuration, status and metrics -----------------------------------------

@pytest.mark.parametrize("pairs", [
    [("data_service", "a:1"), ("data_service_shard", "2")],
    [("data_service", "nohost")],
    [("data_service", "a:1"), ("data_service_shards", "-1")],
    [("data_service", "a:1"), ("data_service_cache", "0")],
    [("data_service", "a:1"), ("data_service_readahead", "-1")],
    [("data_service", "a:1"), ("data_service_prefetch", "-2")],
    [("data_service", "a:1"), ("data_service_timeout_ms", "0")],
    [("data_service", "a:1"), ("data_service_local_fallback", "2")],
    [("data_service", "a:1"), ("data_service_reader", "-2")],
    [("data_service", "local")],
    [("data_service", "a:1"), ("data_service_seed", "x")],
], ids=lambda p: p[-1][0] + "=" + p[-1][1])
def test_data_service_errors_are_the_jax_errors(pairs):
    with pytest.raises(JaxConfigError) as want:
        jax_parse_svc(pairs)
    with pytest.raises(ConfigError) as got:
        parse_data_service_config(pairs)
    assert str(got.value) == str(want.value)


def _families(text):
    return sorted(ln for ln in text.splitlines()
                  if ln.startswith(("# HELP cxxnet_dataservice_",
                                    "# TYPE cxxnet_dataservice_")))


def test_the_status_file_and_metrics_are_the_jax_readers(tmp_path):
    status = {}
    for name, jax in (("port", False), ("jax", True)):
        d = str(tmp_path / name)
        # no readahead: the cache hits of one pass do not hang on timing
        with _fleet(1, data_service_status_dir=d, data_service_readahead=0,
                    jax=jax) as (eps, (r,)):
            build = jax_build if jax else build_service_iterator
            svc = (_jsvc if jax else _svc)(eps)
            it = build(SECTION, svc)
            n = len(_stream(it))
            it.close()
        with open(os.path.join(d, "reader_0.json")) as f:
            status[name] = json.load(f)
        assert os.listdir(d) == ["reader_0.json"]
        assert status[name]["served"] == n + 3
    for s in status.values():
        s.pop("port")
        s.pop("endpoint")
    assert status["port"] == status["jax"]
    assert _families(render_prometheus(REGISTRY)) == \
        _families(jax_render(JAX_REGISTRY))
    assert len(_families(render_prometheus(REGISTRY))) == 2 * 8


def test_task_data_reader_serves_until_sigterm(tmp_path):
    conf = tmp_path / "lenet.conf"
    conf.write_text(LENET)
    ep = f"127.0.0.1:{_free_port()}"
    sdir = tmp_path / "status"
    proc = subprocess.Popen(
        [sys.executable, "-m", "cxxnet_tpu_torch.main", str(conf),
         "task=data_reader", f"data_service={ep}",
         "data_service_shards=2", f"data_service_status_dir={sdir}"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        deadline = time.monotonic() + DEADLINE_S
        while not (sdir / "reader_0.json").exists():
            assert proc.poll() is None and time.monotonic() < deadline
            time.sleep(0.05)
        glob, sections = split_sections(parse_config_string(LENET))
        section = glob + sections[0][2]
        it = build_service_iterator(section, _svc(ep, 2))
        got = _stream(it, epoch=1)
        it.close()
        _same(got, _stream(build_service_iterator(section,
                                                  _svc("local", 2)),
                           epoch=1))
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=DEADLINE_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, out
    assert "data_reader 0: serving shards [0, 1] of 2" in out
    assert f"stopped after serving {len(got) + 2} frames" in out
    assert json.loads((sdir / "reader_0.json").read_text())["served"] == \
        len(got) + 2


def test_task_data_reader_raises_the_jax_messages(tmp_path):
    conf = tmp_path / "lenet.conf"
    conf.write_text(LENET)
    for extra, msg in (([], "requires data_service = host:port"),
                       (["data_service=local", "data_service_shards=1"],
                        "requires data_service = host:port")):
        with pytest.raises(ValueError, match=re.escape(msg)):
            port_main.main([str(conf), "task=data_reader", *extra])
    bare = tmp_path / "bare.conf"
    bare.write_text("dev = cpu\n")
    with pytest.raises(ValueError, match="needs a data = train section"):
        port_main.main([str(bare), "task=data_reader",
                        "data_service=127.0.0.1:1"])


# -- training over the service -------------------------------------------------

def _rel(a, b):
    return float(np.linalg.norm((a - b).ravel())
                 / max(np.linalg.norm(b.ravel()), 1e-12))


def _train(main, root, extra):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main([os.path.join(root, "lenet.conf"), f"model_dir={root}/models",
              "print_step=0", *extra])
    return out.getvalue()


@pytest.fixture(scope="module")
def lenet_runs(tmp_path_factory):
    """Rounds 1 and 2 of the LeNet from one round 0: over two port
    readers, over two JAX readers (the JAX trainer), over
    ``data_service = local`` in one run and in two (``continue = 1``)."""
    from cxxnet_tpu.telemetry.ledger import LEDGER as JAX_LEDGER
    base = tmp_path_factory.mktemp("lenet_ds")
    write_round0(str(base / "round0"))
    glob, sections = split_sections(parse_config_string(LENET))
    section = glob + sections[0][2]
    svc = ["data_service_shards=2", "data_service_seed=7"]
    runs = {}
    for name in ("port", "jax", "local", "local2"):
        root = str(base / name)
        shutil.copytree(str(base / "round0"), os.path.join(root, "models"))
        with open(os.path.join(root, "lenet.conf"), "w") as f:
            f.write(LENET)
        if name == "local2":
            out = _train(port_main.main, root, [
                "data_service=local", *svc, "num_round=2"])
            out += _train(port_main.main, root, [
                "data_service=local", *svc])
        elif name == "local":
            out = _train(port_main.main, root, ["data_service=local", *svc])
        else:
            jax = name == "jax"
            with _fleet(2, section, shards=2, jax=jax,
                        data_service_seed=7) as (eps, readers):
                out = _train(jax_main.main if jax else port_main.main, root,
                             [f"data_service={eps}", *svc])
                served = [r.served for r in readers]
            assert all(served), served
            if jax:
                JAX_LEDGER.disable()
        runs[name] = {"out": out,
                      "final": ckpt.load_model(ckpt.model_path(
                          os.path.join(root, "models"), 2))}
    return runs


def test_lenet_over_port_readers_is_the_local_run_bit_for_bit(lenet_runs):
    got = lenet_runs["port"]["final"]
    for ref in ("local", "local2"):
        want = lenet_runs[ref]["final"]
        for layer, leaves in want["params"].items():
            for leaf, w in leaves.items():
                np.testing.assert_array_equal(got["params"][layer][leaf], w)
        for layer, leaves in want["opt"]["mom"].items():
            for leaf, m in leaves.items():
                np.testing.assert_array_equal(
                    got["opt"]["mom"][layer][leaf], m)
    assert "continuing from round 1" in lenet_runs["local2"]["out"]


def test_lenet_over_port_readers_matches_jax_over_jax_readers(lenet_runs):
    got, want = lenet_runs["port"]["final"], lenet_runs["jax"]["final"]
    assert got["meta"]["round"] == want["meta"]["round"] == 2
    rels = [_rel(got["params"][layer][leaf], w)
            for layer, leaves in want["params"].items()
            for leaf, w in leaves.items()]
    assert max(rels) < PARAM_TOL, rels
    lines = [[ln.split("\t")[1] for ln in run["out"].splitlines()
              if ln.startswith("round")]
             for run in (lenet_runs["port"], lenet_runs["jax"])]
    assert lines[0] == lines[1] and len(lines[0]) == 2


def test_test_io_prints_the_jax_round_line(tmp_path):
    with open(tmp_path / "lenet.conf", "w") as f:
        f.write(LENET)
    outs = []
    for main in (port_main.main, jax_main.main):
        outs.append(_train(main, str(tmp_path), [
            "continue=0", "num_round=2", "test_io=1", "test_skipread=1",
            "data_service=local", "data_service_shards=2"]))
    pat = re.compile(r"^round +(\d+): test_io (\d+) images in [0-9.]+ sec "
                     r"= [0-9.]+ images/sec$", re.M)
    got, want = (pat.findall(o) for o in outs)
    assert got == want == [("0", "64"), ("1", "64")]
    assert not os.path.exists(tmp_path / "models" / "0001.model")
