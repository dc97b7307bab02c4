"""BinaryPage packs and the ``imgbin`` iterators of the port against the
JAX package's, on the CPU.

* A pack written by each package is byte-equal to the other's (two pages
  of seeded objects), and each package reads the other's objects.
* The ``imgbin`` iterator over one pack and its list, and ``imgbinx``
  over a set of packs (``image_conf_prefix`` / ``image_conf_ids``, two
  workers), give batches bit-equal to the JAX iterators' (PNG images of
  32x36, cropped to 24x28, shuffled and mirrored).
* The refusals of a pack set without a placeholder or with too many
  workers are the JAX package's.
"""

import numpy as np
import pytest

from cxxnet_tpu.io import binpage as jax_bp
from cxxnet_tpu.io.data import close_chain as jax_close_chain
from cxxnet_tpu.io.data import create_iterator as jax_create_iterator
from cxxnet_tpu_torch.io import binpage as bp
from cxxnet_tpu_torch.io import close_chain, create_iterator

from torch_imgrec_fixture import image, png_bytes


def test_packs_written_by_either_package_are_byte_equal(tmp_path):
    rs = np.random.RandomState(4)
    # two objects of 40 MiB cannot share a page
    objs = [rs.bytes(n) for n in (40 << 20, 1000, 40 << 20, 7)]
    paths = {}
    for name, mod in (("port", bp), ("jax", jax_bp)):
        paths[name] = str(tmp_path / f"{name}.bin")
        with mod.BinaryPageWriter(paths[name]) as w:
            for o in objs:
                w.push(o)
    raw = {k: open(p, "rb").read() for k, p in paths.items()}
    assert raw["port"] == raw["jax"]
    assert len(raw["port"]) == 2 * bp.PAGE_BYTES
    assert bp.num_pages(paths["jax"]) == 2
    assert [bp.page_object_count(paths["jax"], p) for p in (0, 1)] == \
        [jax_bp.page_object_count(paths["port"], p) for p in (0, 1)] == [2, 2]
    for part, nsplit in ((0, 1), (0, 2), (1, 2)):
        got = list(bp.iter_binpage(paths["jax"], part, nsplit))
        assert got == list(jax_bp.iter_binpage(paths["port"], part, nsplit))
    assert [o for _, o in bp.iter_binpage(paths["jax"])] == objs
    with pytest.raises(ValueError, match="exceeds the 64MiB page"):
        bp.BinaryPageWriter(str(tmp_path / "x.bin")).push(
            b"\0" * bp.PAGE_BYTES)


def _pack(d, name, imgs, first_id):
    with bp.BinaryPageWriter(str(d / f"{name}.bin")) as w:
        for im in imgs:
            w.push(png_bytes(im))
    (d / f"{name}.lst").write_text("".join(
        f"{first_id + i}\t{i % 4}\timg{i}.png\n" for i in range(len(imgs))))


@pytest.fixture(scope="module")
def packs(tmp_path_factory):
    d = tmp_path_factory.mktemp("binpage")
    rng = np.random.RandomState(5)
    imgs = [image(rng, 32, 36) for _ in range(30)]
    _pack(d, "one", imgs, 100)
    _pack(d, "part0", imgs[:13], 0)
    _pack(d, "part1", imgs[13:], 13)
    return d


COMMON = [("input_shape", "3,24,28"), ("batch_size", "8"), ("silent", "1"),
          ("rand_crop", "1"), ("rand_mirror", "1"), ("shuffle", "1"),
          ("seed_data", "3")]


def _same(cfg, epochs=2):
    port, ref = create_iterator(cfg), jax_create_iterator(cfg)
    try:
        n = 0
        for _ in range(epochs):
            got, want = list(port), list(ref)
            assert len(got) == len(want) > 0
            for a, b in zip(got, want):
                assert a.data.dtype == b.data.dtype
                np.testing.assert_array_equal(a.data, b.data)
                np.testing.assert_array_equal(a.label, b.label)
                np.testing.assert_array_equal(a.inst_index, b.inst_index)
                assert a.num_batch_padd == b.num_batch_padd
                n += a.batch_size - a.num_batch_padd
        return n
    finally:
        close_chain(port)
        jax_close_chain(ref)


@pytest.mark.parametrize("alias", ["imgbin", "imgbinold"])
def test_the_imgbin_iterator_gives_the_jax_batches(packs, alias):
    cfg = [("iter", alias), ("image_bin", str(packs / "one.bin")),
           ("image_list", str(packs / "one.lst"))] + COMMON
    assert _same(cfg + [("iter", "end")]) == 60


@pytest.mark.parametrize("rank", [0, 1])
def test_the_imgbinx_pack_set_gives_the_jax_batches(packs, rank):
    cfg = [("iter", "imgbinx"),
           ("image_conf_prefix", str(packs / "part%d")),
           ("image_conf_ids", "0-1"), ("dist_num_worker", "2"),
           ("dist_worker_rank", str(rank))] + COMMON
    assert _same(cfg + [("iter", "end")]) == 2 * (13 if rank == 0 else 17)


@pytest.mark.parametrize("prefix,ids,workers", [
    ("part", "0-1", 1), ("part%d", "0-1", 3), ("part%d", "x", 1)])
def test_a_bad_pack_set_raises_the_jax_error(packs, prefix, ids, workers):
    cfg = [("iter", "imgbinx"), ("image_conf_prefix", str(packs / prefix)),
           ("image_conf_ids", ids), ("dist_num_worker", str(workers)),
           ("dist_worker_rank", str(workers - 1))] + COMMON + [
        ("iter", "end")]
    with pytest.raises(ValueError) as want:
        jax_create_iterator(cfg)
    with pytest.raises(ValueError) as got:
        create_iterator(cfg)
    assert str(got.value) == str(want.value)
