"""The port's image-record pipeline against the JAX package's: record
files, the PNG and JPEG decoders, the augmenter and mean image, the
imgrec iterator and the threadbuffer chain.

Small files (a few dozen images of 20-40 px) written from seeds; every
iterator chain opened is closed.
"""

import os
import threading
import time

import numpy as np
import pytest

from cxxnet_tpu.io import recordio as jrec
from cxxnet_tpu.io.data import close_chain as jax_close_chain
from cxxnet_tpu.io.data import create_iterator as jax_create_iterator
from cxxnet_tpu_torch.io import close_chain, create_iterator
from cxxnet_tpu_torch.io import recordio as prec
from cxxnet_tpu_torch.io.augment import AugmentParams, ImageAugmenter
from cxxnet_tpu_torch.io.data import DataIter
from cxxnet_tpu_torch.io.decode import decode_image
from cxxnet_tpu_torch.io.proc import ThreadBufferIterator

from torch_imgrec_fixture import (binaryproto, image, pil_bytes, png_any,
                                  png_bytes, write_records)

OTHER_FORMATS = "PNG and JPEG files only"


def _images(seed, n, h=32, w=36, c=3):
    rng = np.random.RandomState(seed)
    return [image(rng, h, w, c) for _ in range(n)]


@pytest.fixture(scope="module")
def png_rec(tmp_path_factory):
    """26 RGB PNG records of 32x36 (every row filter), their images, and
    an image list relabelling them with two labels each."""
    d = tmp_path_factory.mktemp("imgrec")
    imgs = _images(0, 26)
    path = str(d / "train.rec")
    write_records(path, [png_bytes(im) for im in imgs], prec.RecordWriter,
                  prec.ImageRecord, ids=[100 + i for i in range(26)])
    lst = d / "train.lst"
    lst.write_text("".join(f"{100 + i}\t{i % 3}\t{(i * 7) % 5}\timg{i}.png\n"
                           for i in range(26)))
    return {"path": path, "imgs": imgs, "lst": str(lst), "dir": str(d)}


# -- record files -----------------------------------------------------------

@pytest.mark.parametrize("writer", ["port", "jax"])
def test_records_written_by_either_package_are_read_by_the_other(
        tmp_path, writer):
    rng = np.random.RandomState(3)
    payloads = [rng.bytes(int(n)) for n in rng.randint(0, 300, 40)]
    path = str(tmp_path / "x.rec")
    w_mod, r_mod = (prec, jrec) if writer == "port" else (jrec, prec)
    with w_mod.RecordWriter(path) as w:
        for p in payloads:
            w.write(p)
        w.write_index(path)
    for nsplit in (1, 3):
        got = []
        for part in range(nsplit):
            a = r_mod.RecordReader(path, part, nsplit)
            b = w_mod.RecordReader(path, part, nsplit)
            pa, pb = list(a), list(b)
            a.close()
            b.close()
            assert pa == pb
            got += pa
        assert got == payloads
        assert prec.shard_record_counts(path, nsplit) == \
            jrec.shard_record_counts(path, nsplit)
    os.remove(path + ".idx")           # the scan, without the index
    assert prec.shard_record_counts(path, 4) == \
        jrec.shard_record_counts(path, 4)
    rec = prec.ImageRecord(inst_id=2**40 + 5, labels=np.array([1.5, -2]),
                           data=b"abc", flag=0)
    j = jrec.ImageRecord.unpack(rec.pack())
    assert (j.inst_id, j.labels.tolist(), j.data) == (2**40 + 5, [1.5, -2],
                                                      b"abc")
    back = prec.ImageRecord.unpack(j.pack())
    assert back.pack() == rec.pack()


def test_reader_skips_a_damaged_record_as_the_jax_reader_does(tmp_path):
    path = str(tmp_path / "x.rec")
    payloads = [bytes([i]) * (20 + i) for i in range(12)]
    with prec.RecordWriter(path) as w:
        for p in payloads:
            w.write(p)
        offs = list(w.offsets)
    raw = bytearray(open(path, "rb").read())
    raw[offs[4]:offs[4] + 4] = b"\0\0\0\0"         # record 4's magic
    raw = raw[:-5]                                  # a torn last record
    open(path, "wb").write(bytes(raw))
    a, b = prec.RecordReader(path), jrec.RecordReader(path)
    got, want = list(a), list(b)
    assert got == want == payloads[:4] + payloads[5:11]
    assert a.skipped == b.skipped == 1
    a.close()
    b.close()
    a = prec.RecordReader(path, max_skip=0)
    with pytest.raises(IOError, match="max_skip"):
        list(a)
    a.close()


def test_image_list_is_read_as_the_jax_package_reads_it(png_rec):
    got = prec.read_image_list(png_rec["lst"])
    want = jrec.read_image_list(png_rec["lst"])
    assert [(i, l.tolist(), p) for i, l, p in got] == \
        [(i, l.tolist(), p) for i, l, p in want]


# -- decoders ---------------------------------------------------------------

def _pil_decode(data, want):
    import io
    from PIL import Image
    a = np.asarray(Image.open(io.BytesIO(data)).convert(
        "L" if want == 1 else "RGB"))
    return a[:, :, None] if want == 1 else a


@pytest.mark.parametrize("want", [3, 1])
@pytest.mark.parametrize("ctype", [0, 2, 3, 4, 6])
def test_png_decoder_matches_pil_for_every_colour_type_and_filter(
        ctype, want):
    rng = np.random.RandomState(ctype)
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    img = rng.randint(0, 256, (23, 19, ch)).astype(np.uint8)
    plte = None
    if ctype == 3:       # a palette shorter than the indices reach
        img = rng.randint(0, 200, (23, 19, 1)).astype(np.uint8)
        plte = rng.randint(0, 256, 180 * 3).astype(np.uint8).tobytes()
    for ftypes in (None, [4] * 23, [3] * 23, [1, 2] * 12):
        data = png_bytes(img, ctype=ctype, plte=plte, ftypes=ftypes)
        got = decode_image(data, want)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, _pil_decode(data, want))


@pytest.mark.parametrize("mode", ["RGB", "L", "RGBA", "LA", "P"])
def test_png_written_by_pil_decodes_as_pil_reads_it(mode):
    from PIL import Image
    import io
    img = _images(5, 1, 40, 30)[0]
    pim = Image.fromarray(img)
    pim = pim.quantize(200) if mode == "P" else pim.convert(mode)
    buf = io.BytesIO()
    pim.save(buf, "PNG")
    data = buf.getvalue()
    for want in (3, 1):
        np.testing.assert_array_equal(decode_image(data, want),
                                      _pil_decode(data, want))


@pytest.mark.parametrize("want", [3, 1])
@pytest.mark.parametrize("src_channels", [3, 1])
def test_jpeg_route_is_bit_equal_to_the_jax_native_decoder(
        want, src_channels):
    from cxxnet_tpu.io import native
    assert native.available()
    for i, img in enumerate(_images(7, 4, 29, 41, src_channels)):
        data = pil_bytes(img, "JPEG", quality=70 + 7 * i)
        got = decode_image(data, want)
        ref = native.try_decode(data, want)
        assert got.shape == (29, 41, want)
        np.testing.assert_array_equal(got, ref)


def test_formats_the_port_does_not_decode_name_roadmap_a2():
    """16-bit and interlaced PNGs decode as the JAX package decodes them
    (they were refused before the native decoder), and so do CMYK and
    YCCK JPEGs (refused before this port's four-component route); other
    formats raise, saying the port decodes PNG and JPEG files only (the
    JAX package hands them to cv2); a damaged PNG raises."""
    import torch_jpeg_fixture as jfx
    from cxxnet_tpu.io.iter_imgrec import decode_image as jax_decode
    for name in ("cmyk_24x20", "ycck_27x33"):
        for want in (3, 1):
            np.testing.assert_array_equal(
                decode_image(jfx.jpeg(name), want),
                jax_decode(jfx.jpeg(name), want))
    img = _images(1, 1, 8, 8)[0]
    deep = png_any(img.astype(np.uint16) * 257 + 3, 2, 16)
    laced = png_any(img, 2, 8, interlace=1)
    for data in (deep, laced):
        for want in (3, 1):
            got = decode_image(data, want)
            np.testing.assert_array_equal(got, img if want == 3 else
                                          _pil_decode(png_bytes(img), 1))
        np.testing.assert_array_equal(decode_image(data, 3),
                                      jax_decode(data, 3))
    with pytest.raises(NotImplementedError, match=OTHER_FORMATS):
        decode_image(b"GIF89a" + bytes(40), 3)
    bad = bytearray(png_bytes(img))
    bad[40] ^= 0xFF                                 # inside IHDR/IDAT
    with pytest.raises(ValueError, match="CRC"):
        decode_image(bytes(bad), 3)


# -- augmenter --------------------------------------------------------------

def test_affine_and_upscale_name_roadmap_a2():
    """The affine warp and the upscale, refused before ``warp.cc``, now
    give the JAX package's (cv2) pixels within 2e-3; the uint8 path still
    hands them to the float path."""
    from cxxnet_tpu.io.augment import AugmentParams as JaxParams
    from cxxnet_tpu.io.augment import ImageAugmenter as JaxAugmenter
    img = _images(2, 1, 24, 24)[0]
    for keys, shape in (({"max_rotate_angle": "10"}, (3, 16, 16)),
                        ({}, (3, 30, 30))):
        p, jp = AugmentParams(), JaxParams()
        for k, v in keys.items():
            p.set_param(k, v)
            jp.set_param(k, v)
        aug, ref = ImageAugmenter(p, shape), JaxAugmenter(jp, shape)
        got = aug.process(img, np.random.RandomState(0))
        want = ref.process(img, np.random.RandomState(0))
        assert got.shape == shape[1:] + (3,)
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
        assert aug.process_u8(img, np.random.RandomState(0)) is None


def test_every_augment_key_is_parsed():
    from cxxnet_tpu.io.augment import AugmentParams as JaxParams
    vals = {"rand_crop": "1", "rand_mirror": "1", "mirror": "1",
            "crop_y_start": "2", "crop_x_start": "3",
            "max_rotate_angle": "5", "max_aspect_ratio": "0.1",
            "max_shear_ratio": "0.2", "min_crop_size": "10",
            "max_crop_size": "20", "min_random_scale": "0.9",
            "max_random_scale": "1.1", "min_img_size": "8",
            "max_img_size": "300", "rotate": "90", "rotate_list": "0,90",
            "fill_value": "7", "max_random_contrast": "0.3",
            "max_random_illumination": "20", "image_mean": "m.bin",
            "mean_value": "1,2,3", "divideby": "255",
            "device_normalize": "0", "scale": "0.5"}
    got, want = AugmentParams(), JaxParams()
    for k, v in vals.items():
        assert got.set_param(k, v) and want.set_param(k, v)
    for k in vars(want):
        a, b = getattr(got, k), getattr(want, k)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b, k
    assert got.needs_affine and not got.set_param("batch_size", "4")


# -- the iterator against the JAX iterator ------------------------------------

def _section(path, extra, chain=("imgrec",)):
    pairs = [("iter", chain[0]), ("image_rec", path),
             ("input_shape", "3,24,28"), ("batch_size", "8"),
             ("silent", "1")] + list(extra)
    return pairs + [("iter", k) for k in chain[1:]] + [("iter", "end")]


def _assert_same_batches(cfg, epochs=2):
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
                assert (a.norm is None) == (b.norm is None)
                if a.norm is not None:
                    assert set(a.norm) == set(b.norm)
                    for k in a.norm:
                        np.testing.assert_array_equal(a.norm[k], b.norm[k])
                n += 1
        return got
    finally:
        close_chain(port)
        jax_close_chain(ref)


@pytest.mark.parametrize("case", [
    "crop_mirror_shuffle_mean", "float_path", "explicit_u8_round_batch",
    "threadbuffer", "photometric", "center_crop_mean_value"])
def test_batches_are_bit_equal_to_the_jax_iterator(png_rec, tmp_path, case):
    mean = str(tmp_path / "mean.bin")
    extra = {
        "crop_mirror_shuffle_mean": [
            ("rand_crop", "1"), ("rand_mirror", "1"), ("shuffle", "1"),
            ("image_mean", mean), ("seed_data", "3")],
        "float_path": [
            ("rand_crop", "1"), ("rand_mirror", "1"), ("image_mean", mean),
            ("device_normalize", "0"), ("divideby", "255"), ("scale", "2")],
        "explicit_u8_round_batch": [
            ("device_normalize", "1"), ("round_batch", "1"),
            ("image_list", png_rec["lst"]), ("label_width", "2"),
            ("mirror", "1"), ("crop_y_start", "4"), ("crop_x_start", "1"),
            ("mean_value", "120,110,100"), ("divideby", "58")],
        "threadbuffer": [
            ("rand_crop", "1"), ("shuffle", "1"), ("image_mean", mean),
            ("buffer_size", "3"), ("decode_threads", "3")],
        "photometric": [
            ("rand_crop", "1"), ("max_random_contrast", "0.2"),
            ("max_random_illumination", "15"), ("mean_value", "100,100,90")],
        "center_crop_mean_value": [
            ("mean_value", "123.68,116.78,103.94"), ("scale", "0.017")],
    }[case]
    chain = ("imgrec", "threadbuffer") if case == "threadbuffer" \
        else ("imgrec",)
    cfg = _section(png_rec["path"], extra, chain)
    last = _assert_same_batches(cfg)
    want_u8 = case not in ("float_path", "photometric")
    assert (last[0].data.dtype == np.uint8) == want_u8
    if case == "explicit_u8_round_batch":
        assert last[-1].num_batch_padd == 6        # 26 rows in 8s
        assert last[0].label.shape == (8, 2)


def test_the_mean_file_is_shared_with_the_jax_package(png_rec, tmp_path):
    pm, jm = str(tmp_path / "port_mean"), str(tmp_path / "jax_mean")
    extra = [("rand_crop", "1"), ("rand_mirror", "1")]
    for mean, make in ((pm, create_iterator), (jm, jax_create_iterator)):
        it = make(_section(png_rec["path"], extra + [("image_mean", mean)]))
        (close_chain if make is create_iterator else jax_close_chain)(it)
    got, want = np.load(pm + ".npy"), np.load(jm + ".npy")
    assert got.dtype == np.float32 and got.shape == (24, 28, 3)
    np.testing.assert_array_equal(got, want)
    # each package reads the other's file as its own
    cfg = _section(png_rec["path"], extra + [("image_mean", jm)])
    port = create_iterator(cfg)
    np.testing.assert_array_equal(next(iter(port)).norm["mean"], want)
    close_chain(port)


def test_jpeg_and_gray_records_are_bit_equal_to_the_jax_iterator(tmp_path):
    imgs = _images(11, 13, 30, 30)
    path = str(tmp_path / "j.rec")
    write_records(path, [pil_bytes(im, "JPEG", quality=85) for im in imgs],
                  jrec.RecordWriter, jrec.ImageRecord)
    for shape in ("3,24,28", "1,20,20"):
        cfg = _section(path, [("rand_crop", "1"), ("rand_mirror", "1"),
                              ("input_shape", shape), ("shuffle", "1"),
                              ("dev", "cpu")])
        got = _assert_same_batches(cfg, epochs=1)
        assert got[0].data.shape[-1] == int(shape[0])


def test_device_normalize_auto_resolves_as_the_jax_iterator(
        png_rec, tmp_path, capsys):
    cfg = _section(png_rec["path"], [("silent", "0")])
    it = create_iterator(cfg)
    close_chain(it)
    assert "device_normalize auto-resolved to 1" in capsys.readouterr().out
    # images smaller than the crop resolve to the host path, whose
    # upscale (warp.cc) gives the JAX package's cv2 batches within 2e-3
    small = str(tmp_path / "small.rec")
    write_records(small, [png_bytes(im) for im in _images(4, 3, 16, 16)],
                  prec.RecordWriter, prec.ImageRecord)
    ref = jax_create_iterator(_section(small, []))
    assert ref.aug.device_normalize == 0
    it = create_iterator(_section(small, []))
    assert it.aug.device_normalize == 0
    try:
        got, want = it.next(), ref.next()
        assert got.data.shape == want.data.shape == (8, 24, 28, 3)
        np.testing.assert_allclose(got.data, want.data, rtol=0, atol=2e-3)
    finally:
        close_chain(it)
        jax_close_chain(ref)


@pytest.mark.parametrize("pairs", [
    [("image_bin", "x.bin")], [("image_conf_prefix", "p%d")],
    [("dist_num_worker", "2")]],
    ids=["image_bin", "conf_prefix", "dist"])
def test_imgrec_features_outside_the_slice_name_roadmap_a2(png_rec, pairs):
    """The three cases that this list refused before ROADMAP Queue A 2
    brought them: a pack without its list and a pack set without ids
    raise the JAX package's errors; a sharded record file gives the JAX
    iterator's batches (``test_torch_binpage.py`` and
    ``test_torch_io_shard.py`` hold the packs and the shards)."""
    cfg = _section(png_rec["path"], pairs)
    if pairs[0][0] == "dist_num_worker":
        _assert_same_batches(cfg)
        return
    if pairs[0][0] == "image_conf_prefix":
        cfg = [kv for kv in cfg if kv[0] != "image_rec"]
    with pytest.raises(ValueError) as want:
        jax_create_iterator(cfg)
    with pytest.raises(ValueError) as got:
        create_iterator(cfg)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("case", ["affine", "binaryproto"])
def test_imgrec_features_ported_in_the_slice_match_the_jax_iterator(
        png_rec, tmp_path, case):
    """The two cases that the list above refused before this slice: the
    affine keys (within 2e-3 of the JAX package's cv2) and a
    ``.binaryproto`` mean image (bit-equal)."""
    if case == "affine":
        extra = [("max_rotate_angle", "10"), ("max_shear_ratio", "0.1"),
                 ("rand_mirror", "1"), ("shuffle", "1")]
    else:
        mean = str(tmp_path / "m.binaryproto")
        arr = np.random.RandomState(9).uniform(0, 255, (3, 32, 36))
        with open(mean, "wb") as f:
            f.write(binaryproto(arr.astype(np.float32)))
        extra = [("image_mean", mean), ("rand_crop", "1"),
                 ("device_normalize", "0")]
    cfg = _section(png_rec["path"], extra)
    port, ref = create_iterator(cfg), jax_create_iterator(cfg)
    try:
        got, want = list(port), list(ref)
        assert len(got) == len(want) == 4
        for a, b in zip(got, want):
            assert a.data.dtype == b.data.dtype == np.float32
            if case == "affine":
                np.testing.assert_allclose(a.data, b.data, rtol=0,
                                           atol=2e-3)
            else:
                np.testing.assert_array_equal(a.data, b.data)
            np.testing.assert_array_equal(a.inst_index, b.inst_index)
    finally:
        close_chain(port)
        jax_close_chain(ref)


def test_remote_record_paths_name_roadmap_a2(png_rec):
    """Remote record paths are read through the stream layer now (ROADMAP
    Queue A 2 brought them): the file copied to fsspec's ``memory://``
    gives the batches of the file on disk."""
    import fsspec
    from cxxnet_tpu_torch.io import stream
    url = f"memory://imgrec{os.getpid()}/train.rec"
    with open(png_rec["path"], "rb") as f:
        stream.write_bytes_atomic(url, f.read())
    try:
        got = create_iterator(_section(url, []))
        want = create_iterator(_section(png_rec["path"], []))
        try:
            a, b = list(got), list(want)
        finally:
            close_chain(got)
            close_chain(want)
    finally:
        fsspec.filesystem("memory").rm(url)
    assert len(a) == len(b) == 4
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.data, y.data)
        np.testing.assert_array_equal(x.inst_index, y.inst_index)


# -- threadbuffer -------------------------------------------------------------

class _Counting(DataIter):
    def __init__(self, n, fail_at=None):
        self.n, self.fail_at, self.closed = n, fail_at, False
        super().__init__([])

    def before_first(self):
        self.i = 0

    def next(self):
        if self.i == self.fail_at:
            raise RuntimeError("decode failed")
        if self.i >= self.n:
            return None
        self.i += 1
        return self.i

    def close(self):
        self.closed = True


def test_threadbuffer_prefetches_relays_errors_and_closes():
    base = _Counting(5)
    tb = ThreadBufferIterator([("buffer_size", "2")], base=base)
    assert list(tb) == [1, 2, 3, 4, 5]
    assert list(tb) == [1, 2, 3, 4, 5]            # before_first restarts
    assert tb.next() is None                       # past the end: no hang
    tb.close()
    assert base.closed and not tb._thread.is_alive()
    bad = ThreadBufferIterator([], base=_Counting(9, fail_at=3))
    bad.before_first()
    assert [bad.next() for _ in range(3)] == [1, 2, 3]
    with pytest.raises(RuntimeError, match="decode failed"):
        bad.next()
    bad.close()
    # a producer blocked on a full queue is stopped and joined
    full = ThreadBufferIterator([("buffer_size", "1")], base=_Counting(10**6))
    full.before_first()
    time.sleep(0.05)
    t0 = time.perf_counter()
    full.close()
    assert time.perf_counter() - t0 < 2 and not full._thread.is_alive()
    assert all(not t.name.startswith("io-threadbuffer") or not t.is_alive()
               for t in threading.enumerate())
