"""Sharded reading and the wrapper iterators of the port against the JAX
package's, on the CPU.

* ``dist_slice`` is the JAX function over a grid of sizes and workers.
* Each shardable source (``mnist``, ``csv``, ``synthetic`` with
  ``data_gen_seed``, ``synthetic_lm`` and ``imgrec``) split over three
  workers: each rank's batches are bit-equal to the JAX iterator's, and
  the union of the ranks' real rows is the whole dataset, each row once.
  ``imgrec`` also takes its rank from ``CXXNET_NUM_WORKER`` /
  ``CXXNET_WORKER_RANK``, and refuses, as the JAX iterator does, a
  ``round_batch`` split whose ranks would emit different batch counts.
* The ``throttle``, ``membuffer`` and ``test_skipread`` chains give the
  JAX chains' batches over two epochs.
"""

import struct

import numpy as np
import pytest

from cxxnet_tpu.io.data import close_chain as jax_close_chain
from cxxnet_tpu.io.data import create_iterator as jax_create_iterator
from cxxnet_tpu.io.data import dist_slice as jax_dist_slice
from cxxnet_tpu_torch.io import close_chain, create_iterator
from cxxnet_tpu_torch.io import recordio as prec
from cxxnet_tpu_torch.io.data import dist_shardable_sources, dist_slice

from torch_imgrec_fixture import image, png_bytes, write_records

WORKERS = 3


def test_dist_slice_is_the_jax_function():
    for n in (0, 1, 2, 7, 96, 101):
        for nw in (1, 2, 3, 8):
            got = [dist_slice(n, nw, r) for r in range(nw)]
            assert got == [jax_dist_slice(n, nw, r) for r in range(nw)]
            assert sum(s.stop - s.start for s in got) == n
    for bad in (-1, 3):
        with pytest.raises(ValueError) as want:
            jax_dist_slice(5, 3, bad)
        with pytest.raises(ValueError) as got:
            dist_slice(5, 3, bad)
        assert str(got.value) == str(want.value)
    assert dist_shardable_sources() == ["csv", "imgbin", "imgbinold",
                                        "imgbinx", "imginst", "imgrec",
                                        "mnist", "synthetic",
                                        "synthetic_lm"]


def _idx(arr, magic):
    return (struct.pack(">i", magic) + b"".join(
        struct.pack(">i", d) for d in arr.shape) + arr.tobytes())


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("shard")
    rs = np.random.RandomState(2)
    (d / "img").write_bytes(_idx(rs.randint(0, 256, (50, 5, 5))
                                 .astype(np.uint8), 2051))
    (d / "lab").write_bytes(_idx(rs.randint(0, 10, 50).astype(np.uint8),
                                 2049))
    rows = np.hstack([rs.randint(0, 4, (47, 1)), rs.randn(47, 6)])
    np.savetxt(d / "x.csv", rows, delimiter=",", fmt="%.6f")
    path = str(d / "t.rec")
    write_records(path, [png_bytes(image(rs, 20, 24)) for _ in range(41)],
                  prec.RecordWriter, prec.ImageRecord,
                  ids=list(range(500, 541)))
    return d


SOURCES = {
    "mnist": lambda d: [("iter", "mnist"), ("path_img", str(d / "img")),
                        ("path_label", str(d / "lab")), ("shuffle", "1"),
                        ("input_flat", "0")],
    "csv": lambda d: [("iter", "csv"), ("filename", str(d / "x.csv")),
                      ("input_shape", "1,1,6"), ("shuffle", "1")],
    "synthetic": lambda d: [("iter", "synthetic"), ("num_inst", "61"),
                            ("input_shape", "2,3,3"),
                            ("data_gen_seed", "11")],
    "synthetic_lm": lambda d: [("iter", "synthetic_lm"), ("num_inst", "44"),
                               ("seq_len", "6"), ("data_gen_seed", "4")],
    "imgrec": lambda d: [("iter", "imgrec"), ("image_rec", str(d / "t.rec")),
                         ("input_shape", "3,16,16"), ("rand_crop", "1"),
                         ("rand_mirror", "1"), ("shuffle", "1")],
}
SIZES = {"mnist": 50, "csv": 47, "synthetic": 61, "synthetic_lm": 44,
         "imgrec": 41}


def _batches(make, cfg):
    it = make(cfg)
    try:
        return list(it)
    finally:
        (close_chain if make is create_iterator else jax_close_chain)(it)


@pytest.mark.parametrize("source", sorted(SOURCES))
def test_the_ranks_of_a_sharded_source_are_the_jax_ranks(files, source):
    seen = []
    for rank in range(WORKERS):
        cfg = SOURCES[source](files) + [
            ("batch_size", "8"), ("seed_data", "5"), ("silent", "1"),
            ("dist_num_worker", str(WORKERS)),
            ("dist_worker_rank", str(rank)), ("iter", "end")]
        got = _batches(create_iterator, cfg)
        want = _batches(jax_create_iterator, cfg)
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            assert a.data.dtype == b.data.dtype
            np.testing.assert_array_equal(a.data, b.data)
            np.testing.assert_array_equal(a.label, b.label)
            np.testing.assert_array_equal(a.inst_index, b.inst_index)
            assert a.num_batch_padd == b.num_batch_padd
            seen += a.inst_index[:a.batch_size - a.num_batch_padd].tolist()
    base = 500 if source == "imgrec" else 0
    assert sorted(seen) == list(range(base, base + SIZES[source]))


def test_imgrec_takes_its_rank_from_the_environment(files, monkeypatch):
    cfg = SOURCES["imgrec"](files) + [("batch_size", "8"), ("silent", "1"),
                                      ("iter", "end")]
    keyed = _batches(create_iterator, cfg[:-1] + [
        ("dist_num_worker", "2"), ("dist_worker_rank", "1"),
        ("iter", "end")])
    monkeypatch.setenv("CXXNET_NUM_WORKER", "2")
    monkeypatch.setenv("PS_RANK", "1")
    got = _batches(create_iterator, cfg)
    want = _batches(jax_create_iterator, cfg)
    for a, b, c in zip(got, want, keyed):
        np.testing.assert_array_equal(a.data, b.data)
        np.testing.assert_array_equal(a.data, c.data)
        np.testing.assert_array_equal(a.inst_index, c.inst_index)


def test_imgrec_refuses_uneven_round_batch_shards_as_jax_does(files):
    cfg = SOURCES["imgrec"](files) + [
        ("batch_size", "3"), ("round_batch", "1"), ("silent", "1"),
        ("dist_num_worker", "6"), ("dist_worker_rank", "0"),
        ("iter", "end")]
    with pytest.raises(ValueError) as want:
        jax_create_iterator(cfg)
    with pytest.raises(ValueError) as got:
        create_iterator(cfg)
    assert str(got.value) == str(want.value)
    assert "per-rank batch counts" in str(got.value)


@pytest.mark.parametrize("chain", [
    [("iter", "throttle"), ("throttle_ms", "1")],
    [("iter", "membuffer"), ("max_nbatch", "3")],
    [("iter", "threadbuffer"), ("iter", "membuffer"), ("max_buffer", "2")],
    [("test_skipread", "1")],
], ids=["throttle", "membuffer", "threadbuffer+membuffer", "skipread"])
def test_the_wrapper_chains_are_the_jax_chains(chain):
    cfg = [("iter", "synthetic"), ("num_inst", "45"), ("batch_size", "8"),
           ("input_shape", "1,1,5"), ("seed_data", "2")] + chain + [
        ("iter", "end")]
    port, ref = create_iterator(cfg), jax_create_iterator(cfg)
    try:
        for epoch in range(2):
            got, want = list(port), list(ref)
            assert len(got) == len(want) > 0
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a.data, b.data)
                np.testing.assert_array_equal(a.inst_index, b.inst_index)
                assert a.num_batch_padd == b.num_batch_padd
    finally:
        close_chain(port)
        jax_close_chain(ref)
