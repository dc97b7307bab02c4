"""The port's stream layer (``io/stream.py``), its retry ladder and the
``io.*`` failpoints against the JAX package's, on the CPU.

* Round trips through fsspec's ``memory://`` file system: a record file,
  a ``%04d.model`` round found by ``find_latest``, a gzipped mnist idx
  file, a config file and a ``pred`` output, each read by both packages
  (the memory file system is one store per process).
* ``write_bytes_atomic``: no temp file is left, a killed rename leaves
  this process's own temp file (which ``is_own_tmp`` names, as the JAX
  function does), a remote path is written whole.
* ``retry_call`` sleeps the JAX function's delays under the same
  injected ``sleep`` and ``rng`` and raises the same last error.
* Each ``io.*`` failpoint site: armed ``once`` or ``every:1`` in both
  packages, the same operation raises or succeeds in both, with the
  same ``io.retries`` count and the same number of fires.
"""

import gzip
import itertools
import os
import struct

import numpy as np
import pytest

from cxxnet_tpu import checkpoint as jax_ckpt
from cxxnet_tpu.config import parse_config_file as jax_parse_file
from cxxnet_tpu.io import recordio as jax_rio
from cxxnet_tpu.io import stream as jax_stream
from cxxnet_tpu.io.data import create_iterator as jax_create_iterator
from cxxnet_tpu.resilience import counters as jax_counters
from cxxnet_tpu.resilience import failpoints as jax_fp
from cxxnet_tpu.resilience.retry import retry_call as jax_retry_call
from cxxnet_tpu_torch import checkpoint as ckpt
from cxxnet_tpu_torch import main as port_main
from cxxnet_tpu_torch.config import (RetryPolicy, parse_config_file,
                                     parse_config_string,
                                     parse_retry_policy)
from cxxnet_tpu_torch.io import create_iterator, recordio as rio, stream
from cxxnet_tpu_torch.resilience import counters
from cxxnet_tpu_torch.resilience import failpoints as port_fp
from cxxnet_tpu_torch.resilience.retry import retry_call

_SEQ = itertools.count()


@pytest.fixture()
def mem():
    """A fresh ``memory://`` directory; removed after the test."""
    import fsspec
    root = f"memory://stream{os.getpid()}_{next(_SEQ)}"
    yield root
    fs = fsspec.filesystem("memory")
    if fs.exists(root):
        fs.rm(root, recursive=True)


@pytest.fixture(autouse=True)
def _clean():
    yield
    port_fp.clear()
    jax_fp.clear()
    stream.set_retry_policy(RetryPolicy())
    jax_stream.set_retry_policy(jax_stream.RetryPolicy())


def _fast():
    """No sleeping between retries, in both packages."""
    stream.set_retry_policy(RetryPolicy(base_delay_s=0.0, max_delay_s=0.0))
    jax_stream.set_retry_policy(jax_stream.RetryPolicy(
        base_delay_s=0.0, max_delay_s=0.0))


# -- round trips on memory:// -------------------------------------------------

def test_record_files_round_trip_on_a_remote_store(mem):
    rs = np.random.RandomState(0)
    payloads = [rs.bytes(rs.randint(1, 300)) for _ in range(40)]
    path = f"{mem}/train.rec"
    with rio.RecordWriter(path) as w:
        for p in payloads:
            w.write(p)
        w.write_index(path)
    assert stream.exists(path + ".idx")
    for part in range(3):
        want = list(jax_rio.RecordReader(path, part, 3))
        reader = rio.RecordReader(path, part, 3)
        assert list(reader) == want
        reader.close()
    assert rio.shard_record_counts(path, 3) == \
        jax_rio.shard_record_counts(path, 3)
    assert sum(rio.shard_record_counts(path, 3)) == len(payloads)
    assert stream.getsize(path) == jax_stream.getsize(path)


def test_a_round_on_a_remote_store_is_found_and_loads(mem):
    d = f"{mem}/models"
    stream.makedirs(d)
    params = {"fc": {"wmat": np.arange(6, dtype=np.float32).reshape(2, 3)}}
    for r in (3, 7):
        ckpt.save_model(ckpt.model_path(d, r), structure_sig=("x",),
                        round_counter=r, epoch_counter=r,
                        params=params, net_state={})
    assert sorted(stream.listdir(d)) == ["0003.model", "0007.model"]
    assert ckpt.find_latest(d) == jax_ckpt.find_latest(d) == \
        (7, f"{d}/0007.model")
    assert ckpt.find_latest_valid(d)[0] == 7
    got, want = ckpt.load_model(f"{d}/0007.model"), \
        jax_ckpt.load_model(f"{d}/0007.model")
    assert got["meta"]["round"] == want["meta"]["round"] == 7
    np.testing.assert_array_equal(got["params"]["fc"]["wmat"],
                                  want["params"]["fc"]["wmat"])


def _idx(arr: np.ndarray, magic: int) -> bytes:
    return (struct.pack(">i", magic) + b"".join(
        struct.pack(">i", d) for d in arr.shape) + arr.tobytes())


def test_a_gzipped_mnist_pair_on_a_remote_store(mem):
    rs = np.random.RandomState(1)
    img = rs.randint(0, 256, (37, 6, 6)).astype(np.uint8)
    lab = rs.randint(0, 10, 37).astype(np.uint8)
    stream.write_bytes_atomic(f"{mem}/img.gz",
                              gzip.compress(_idx(img, 2051)))
    stream.write_bytes_atomic(f"{mem}/lab.gz", gzip.compress(_idx(lab,
                                                                  2049)))
    cfg = [("iter", "mnist"), ("path_img", f"{mem}/img.gz"),
           ("path_label", f"{mem}/lab.gz"), ("batch_size", "8"),
           ("shuffle", "1"), ("silent", "1"), ("iter", "end")]
    got = list(create_iterator(cfg))
    want = list(jax_create_iterator(cfg))
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.data, b.data)
        np.testing.assert_array_equal(a.label, b.label)
        np.testing.assert_array_equal(a.inst_index, b.inst_index)


CONF = """
data = train
iter = synthetic
  num_inst = 64
  num_class = 3
  input_shape = 1,1,8
iter = end
netconfig = start
layer[+1:fc1] = fullc:fc1
  nhidden = 3
layer[+0] = softmax
netconfig = end
input_shape = 1,1,8
batch_size = 16
dev = cpu
silent = 1
"""


def test_a_config_file_and_a_pred_output_on_a_remote_store(mem, tmp_path):
    conf = f"{mem}/net.conf"
    stream.write_bytes_atomic(conf, CONF.encode())
    assert parse_config_file(conf) == jax_parse_file(conf) == \
        parse_config_string(CONF)
    models = str(tmp_path / "models")
    port_main.main([conf, f"model_dir={models}", "num_round=1"])
    outs = {}
    for where in (f"{mem}/pred.txt", str(tmp_path / "pred.txt")):
        port_main.main([conf, "task=pred_raw", "continue=1",
                        f"model_dir={models}", f"name_pred={where}"])
        outs[where] = stream.read_bytes(where)
    local, remote = outs[str(tmp_path / "pred.txt")], outs[f"{mem}/pred.txt"]
    assert remote == local and len(local.splitlines()) == 64


# -- write_bytes_atomic -------------------------------------------------------

def test_write_bytes_atomic_leaves_only_its_own_temp_file(tmp_path, mem):
    path = str(tmp_path / "a.bin")
    stream.write_bytes_atomic(path, b"one")
    assert os.listdir(tmp_path) == ["a.bin"]
    port_fp.configure("io.write=once")
    with pytest.raises(IOError, match="io.write"):
        stream.write_bytes_atomic(path, b"two")
    orphan, = [f for f in os.listdir(tmp_path) if f != "a.bin"]
    assert orphan.startswith(f"a.bin.tmp.{os.getpid()}.")
    assert stream.is_own_tmp(orphan) and jax_stream.is_own_tmp(orphan)
    assert not stream.is_own_tmp(f"a.bin.tmp.{os.getpid() + 1}.0")
    assert open(path, "rb").read() == b"one"
    stream.write_bytes_atomic(f"{mem}/b.bin", b"whole")
    assert jax_stream.read_bytes(f"{mem}/b.bin") == b"whole"


# -- retry_call ----------------------------------------------------------------

@pytest.mark.parametrize("attempts,jitter,fails", [
    (4, 1.0, 3), (4, 0.0, 2), (3, 0.5, 5), (6, 1.0, 6)])
def test_retry_delays_are_the_jax_delays(attempts, jitter, fails):
    runs = []
    for fn in (retry_call, jax_retry_call):
        draws = iter(np.random.RandomState(attempts).rand(16).tolist())
        slept, calls = [], []

        def flaky():
            calls.append(1)
            if len(calls) <= fails:
                raise OSError(f"transient {len(calls)}")
            return "ok"
        try:
            out = fn(flaky, attempts=attempts, base_delay_s=0.05,
                     max_delay_s=0.15, jitter=jitter, sleep=slept.append,
                     rng=lambda: next(draws))
        except OSError as e:
            out = str(e)
        runs.append((out, slept, len(calls)))
    assert runs[0] == runs[1]
    assert runs[0][2] == min(attempts, fails + 1)


def test_the_retry_keys_parse_as_the_jax_keys():
    from cxxnet_tpu.config import ConfigError as JaxConfigError
    from cxxnet_tpu.config import parse_retry_policy as jax_parse
    from cxxnet_tpu_torch.config import ConfigError
    cfg = [("io_retry_attempts", "6"), ("io_retry_base_ms", "10"),
           ("io_retry_max_ms", "80"), ("io_retry_jitter", "0.25")]
    assert parse_retry_policy(cfg).__dict__ == jax_parse(cfg).__dict__
    for bad in ([("io_retry_attemps", "3")], [("io_retry_attempts", "0")],
                [("io_retry_jitter", "2")], [("io_retry_base_ms", "x")]):
        with pytest.raises(JaxConfigError) as want:
            jax_parse(bad)
        with pytest.raises(ConfigError) as got:
            parse_retry_policy(bad)
        assert str(got.value) == str(want.value)


# -- the io.* failpoint sites --------------------------------------------------

def _ops(pkg_stream, pkg_ckpt, pkg_rio, root):
    """Each stream operation of the sites, for one package."""
    return {
        "sopen read": lambda: pkg_stream.sopen(f"{root}/f.bin").read(),
        "read_bytes": lambda: pkg_stream.read_bytes(f"{root}/f.bin"),
        "write": lambda: pkg_stream.write_bytes_atomic(
            f"{root}/w.bin", b"w"),
        "ckpt load": lambda: pkg_ckpt.load_model(f"{root}/0000.model"),
        "records": lambda: list(pkg_rio.RecordReader(f"{root}/r.rec")),
    }


@pytest.mark.parametrize("where", ["local", "remote"])
@pytest.mark.parametrize("mode", ["once", "every:1"])
@pytest.mark.parametrize("site", ["io.open", "io.read", "io.write"])
def test_each_io_site_fires_and_retries_as_in_jax(tmp_path, mem, site,
                                                  mode, where):
    _fast()
    root = str(tmp_path) if where == "local" else mem
    stream.write_bytes_atomic(f"{root}/f.bin", b"payload")
    ckpt.save_model(f"{root}/0000.model", structure_sig=("x",),
                    round_counter=0, epoch_counter=0,
                    params={"l": {"w": np.ones(3, np.float32)}},
                    net_state={})
    with rio.RecordWriter(f"{root}/r.rec") as w:
        w.write(b"abc")
    port_ops = _ops(stream, ckpt, rio, root)
    jax_ops = _ops(jax_stream, jax_ckpt, jax_rio, root)
    for name in port_ops:
        seen = []
        for ops, fp, cnt in ((port_ops, port_fp, counters),
                             (jax_ops, jax_fp, jax_counters)):
            fp.configure(f"{site}={mode}")
            before = cnt.get("io.retries")
            try:
                ops[name]()
                outcome = "ok"
            except OSError as e:
                outcome = type(e).__name__ + (": " + site
                                              if site in str(e) else "")
            seen.append((outcome, cnt.get("io.retries") - before,
                         fp.fired(site)))
            fp.clear()
        assert seen[0] == seen[1], (name, seen)
