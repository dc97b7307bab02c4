"""The port's image decoders against the JAX package's and their plain
versions, on the CPU.

* PNG: ``native/png.cc`` bit-equal to the numpy route
  (``decode_png_plain``) on every 8-bit non-interlaced file, and to the
  JAX package's ``decode_image`` (OpenCV here) for every colour type x
  bit depth x interlace for three channels and for one from a grey
  file; one channel from a colour file is PIL's luma of the RGB (ROADMAP
  queue C); a 16-bit sample keeps its high byte, as OpenCV reads it.
  Odd widths, every row filter in every pass. A ``png.cc`` that does not
  build raises; the numpy loops are never reached.
* JPEG: ``tests/torch_jpeg_fixture.py``'s files (grey, 4:4:4, 4:2:2,
  4:2:0 at odd sizes, progressive, restart intervals, CMYK, YCCK): the
  port's libjpeg route and the JAX package's decoder reproduce the
  stored pixels bit for bit (the CMYK and YCCK ones are the JAX
  package's cv2 fallback's, which the test shows answers for them: its
  native decoder returns None); the card route's four-plane half over
  libjpeg's planes gives the same pixels.
  ``chip_smoke.py``'s numpy JPEG writer: libjpeg decodes its files
  identically through both packages; at least 38 dB PSNR on images with
  mild texture in the luma, and within 0.25 dB of libjpeg's own encoder
  (PIL, the same quality and 4:2:0) on those and on chip_smoke's
  images, whose independent noise per channel the 4:2:0 chroma cannot
  keep (both encoders read about 30.4 dB there).
* The route: ``dev = cpu`` is libjpeg; a CUDA ``dev`` is nvJPEG, and a
  failure to build it raises without reaching libjpeg.
"""

import io

import numpy as np
import pytest
import torch

from cxxnet_tpu.io.iter_imgrec import decode_image as jax_decode_image
from cxxnet_tpu_torch.io import close_chain, create_iterator
from cxxnet_tpu_torch.io import decode as pdec
from cxxnet_tpu_torch.io import recordio as prec
from cxxnet_tpu_torch.io.decode import (decode_image, decode_png_plain,
                                        jpeg_device)

import chip_smoke
import torch_jpeg_fixture as jfx
from torch_imgrec_fixture import image, png_any, png_bytes, write_records

#: colour type -> (channels, bit depths)
PNG_KINDS = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)),
             4: (2, (8, 16)), 6: (4, (8, 16))}
PNG_CASES = [(t, d, il) for t, (_, ds) in PNG_KINDS.items() for d in ds
             for il in (0, 1)]


def _png_case(ctype, depth, interlace, h=23, w=19, seed=0):
    rng = np.random.RandomState(seed * 100 + ctype * 10 + depth + interlace)
    ch = PNG_KINDS[ctype][0]
    samples = rng.randint(0, 1 << depth, (h, w, ch)).astype(np.uint16)
    plte = None
    if ctype == 3:
        plte = rng.randint(0, 256, 3 * (1 << depth)).astype(
            np.uint8).tobytes()
    return samples, plte, png_any(samples, ctype, depth, interlace, plte)


def _luma(rgb):
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(
        np.uint8)


# -- PNG ----------------------------------------------------------------------

@pytest.mark.parametrize("ctype,depth,interlace", PNG_CASES,
                         ids=[f"t{t}-d{d}-i{il}" for t, d, il in PNG_CASES])
def test_png_matches_the_jax_decoder_for_every_kind(ctype, depth,
                                                    interlace):
    for h, w in ((23, 19), (1, 1), (9, 2), (3, 33)):
        samples, plte, data = _png_case(ctype, depth, interlace, h, w)
        got3, got1 = decode_image(data, 3), decode_image(data, 1)
        want3 = jax_decode_image(data, 3)
        assert got3.dtype == np.uint8 and got3.shape == (h, w, 3)
        np.testing.assert_array_equal(got3, want3)
        if ctype in (0, 4):          # grey: the grey samples themselves
            np.testing.assert_array_equal(got1, jax_decode_image(data, 1))
            np.testing.assert_array_equal(got1[..., 0], got3[..., 0])
        else:                        # colour: PIL's luma (queue C)
            np.testing.assert_array_equal(got1[..., 0], _luma(got3))
        if depth == 16:              # the high byte, as OpenCV reads it
            hi = (samples >> 8).astype(np.uint8)
            want = hi[..., :3] if hi.shape[2] >= 3 else \
                np.repeat(hi[..., :1], 3, 2)
            np.testing.assert_array_equal(got3, want)


@pytest.mark.parametrize("ctype", [0, 2, 3, 4, 6])
def test_png_native_is_bit_equal_to_the_numpy_route(ctype):
    rng = np.random.RandomState(40 + ctype)
    ch = PNG_KINDS[ctype][0]
    for h, w in ((17, 31), (5, 1), (40, 13)):
        img = rng.randint(0, 256, (h, w, ch)).astype(np.uint8)
        plte = None
        if ctype == 3:       # a palette shorter than the indices reach
            img = rng.randint(0, 200, (h, w, 1)).astype(np.uint8)
            plte = rng.randint(0, 256, 150 * 3).astype(np.uint8).tobytes()
        for ftypes in (None, [4] * h, [3] * h, [1, 2] * h):
            data = png_bytes(img, ctype=ctype, plte=plte,
                             ftypes=ftypes and ftypes[:h])
            for want in (3, 1):
                np.testing.assert_array_equal(
                    decode_image(data, want), decode_png_plain(data, want))


def test_png_that_png_cc_cannot_take_raises(monkeypatch):
    img = image(np.random.RandomState(1), 8, 8)
    bad = bytearray(png_bytes(img))
    bad[40] ^= 0xFF                                 # inside IHDR/IDAT
    with pytest.raises(ValueError, match="CRC"):
        decode_image(bytes(bad), 3)
    with pytest.raises(ValueError, match="not a valid header"):
        decode_image(png_bytes(img, depth=4), 3)    # RGB at 4 bits
    import struct
    import zlib
    short = png_bytes(img)
    i = short.index(b"IDAT") - 4
    n = struct.unpack(">I", short[i:i + 4])[0]
    body = zlib.compress(zlib.decompress(short[i + 8:i + 8 + n])[:-5])
    short = (short[:i] + struct.pack(">I", len(body)) + b"IDAT" + body
             + struct.pack(">I", zlib.crc32(b"IDAT" + body))
             + short[i + 12 + n:])
    with pytest.raises(ValueError, match="truncated"):
        decode_image(short, 3)
    # png.cc that does not build raises; the numpy loops are not reached
    monkeypatch.setattr(pdec, "_png_lib", None)
    from cxxnet_tpu_torch.ops import _build

    def no_build(*a, **k):
        raise RuntimeError("building png.cc with g++ failed")
    monkeypatch.setattr(_build, "load_host", no_build)
    monkeypatch.setattr(pdec, "_unfilter", lambda *a: pytest.fail(
        "the numpy route was reached"))
    with pytest.raises(RuntimeError, match="png.cc"):
        decode_image(png_bytes(img), 3)


# -- JPEG ---------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(jfx.SPECS))
def test_jpeg_fixture_is_reproduced_by_both_libjpeg_routes(name):
    from cxxnet_tpu.io import native
    data = jfx.jpeg(name)
    four = name.startswith(("cmyk", "ycck"))
    if four:
        # the JAX package's libjpeg call refuses the file: cv2 answers
        assert native.try_decode(data, 3) is None
    for want in (3, 1):
        if four:
            np.testing.assert_array_equal(pdec.decode_jpeg_planar4(data, want),
                                          jfx.pixels(name, want))
        want_px = jfx.pixels(name, want)
        np.testing.assert_array_equal(decode_image(data, want), want_px)
        np.testing.assert_array_equal(decode_image(data, want, "cpu"),
                                      want_px)
        np.testing.assert_array_equal(jax_decode_image(data, want), want_px)


@pytest.mark.parametrize("name", sorted(
    n for n, spec in jfx.SPECS.items() if spec[0] == "RGB"))
def test_the_card_routes_colour_code_is_bit_equal_to_libjpeg(name):
    """``native/jpeg_color.h`` (libjpeg's fancy upsampling and YCbCr ->
    RGB, which nvjpeg.cc runs over nvJPEG's planes) over libjpeg's own
    planes gives libjpeg's RGB bit for bit: 4:4:4, 4:2:2, 4:2:0, odd
    sizes, progressive, restart intervals."""
    y, cb, cr = pdec.jpeg_planes(jfx.jpeg(name))
    np.testing.assert_array_equal(pdec.planes_to_rgb(y, cb, cr),
                                  jfx.pixels(name, 3))
    np.testing.assert_array_equal(y[..., None], jfx.pixels(name, 1))


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / mse)


def _pil_jpeg(img, quality):
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=quality, subsampling=2)
    return buf.getvalue()


@pytest.mark.parametrize("restart", [0, 3])
def test_chip_smoke_jpeg_writer_decodes_in_libjpeg(restart):
    rng = np.random.RandomState(5 + restart)
    # mild texture in the luma only (libjpeg's own encoder reads about
    # 40 dB here; 37 at twice the noise)
    for h, w in ((48, 48), (37, 53), (64, 80), (9, 17)):
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        base = 128 + 0.6 * (yy - h / 2)[..., None] * rng.uniform(-1, 1, 3) \
            + 0.6 * (xx - w / 2)[..., None] * rng.uniform(-1, 1, 3)
        img = np.clip(np.rint(base + rng.randn(h, w, 1) * 3), 0,
                      255).astype(np.uint8)
        data = chip_smoke.jpeg_encode(img, 90, restart)
        got = decode_image(data, 3)
        np.testing.assert_array_equal(got, jax_decode_image(data, 3))
        np.testing.assert_array_equal(decode_image(data, 1),
                                      jax_decode_image(data, 1))
        assert _psnr(got, img) >= 38.0, (h, w, _psnr(got, img))
        ref = decode_image(_pil_jpeg(img, 90), 3)
        assert _psnr(got, img) >= _psnr(ref, img) - 0.25
    # chip_smoke's own images against libjpeg's own encoder
    for img in chip_smoke.seeded_images(rng, 2, 64):
        data = chip_smoke.jpeg_encode(img, 90, restart)
        got = decode_image(data, 3)
        np.testing.assert_array_equal(got, jax_decode_image(data, 3))
        ref = decode_image(_pil_jpeg(img, 90), 3)
        assert _psnr(got, img) >= _psnr(ref, img) - 0.25
    if restart:
        assert b"\xff\xdd" in data and b"\xff\xd0" in data


# -- the route ----------------------------------------------------------------

def test_jpeg_route_follows_dev(monkeypatch):
    assert jpeg_device("cpu") is None
    assert jpeg_device("CPU") is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    assert jpeg_device("gpu:0") == torch.device("cuda", 0)
    assert jpeg_device("cuda:2") == torch.device("cuda", 2)
    assert jpeg_device("tpu") == torch.device("cuda", 1)
    assert jpeg_device("gpu:0-1") == torch.device("cuda", 1)   # dp rank
    assert jpeg_device("") == torch.device("cuda", 1)


def test_a_cuda_dev_decodes_through_nvjpeg_and_never_libjpeg(
        monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(pdec, "_nv_lib", None)
    monkeypatch.setattr(pdec, "_nv_decoders", {})
    from cxxnet_tpu_torch.ops import _build
    monkeypatch.setattr(_build, "cuda_home", lambda: "/no/cuda")

    def no_build(source, **kw):
        assert source == "nvjpeg.cc"
        assert kw["libs"] == ("nvjpeg", "cudart")
        raise RuntimeError("building nvjpeg.cc with g++ failed: nvjpeg.h")
    monkeypatch.setattr(_build, "load_host", no_build)
    monkeypatch.setattr(pdec, "decode_jpeg", lambda *a: pytest.fail(
        "libjpeg was reached"))
    data = jfx.jpeg("420_37x53")
    with pytest.raises(RuntimeError, match="nvJPEG.*nvjpeg.h"):
        decode_image(data, 3, torch.device("cuda", 0))
    path = str(tmp_path / "j.rec")
    write_records(path, [data] * 3, prec.RecordWriter, prec.ImageRecord)
    it = create_iterator([
        ("iter", "imgrec"), ("image_rec", path), ("input_shape", "3,32,32"),
        ("batch_size", "2"), ("dev", "gpu:0"), ("silent", "1"),
        ("device_normalize", "0"), ("iter", "end")])
    try:
        assert it._jpeg_device == torch.device("cuda", 0)
        with pytest.raises(RuntimeError, match="nvJPEG"):
            it.next()
    finally:
        close_chain(it)


def test_without_a_card_a_jpeg_on_the_card_route_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(pdec, "decode_jpeg", lambda *a: pytest.fail(
        "libjpeg was reached"))
    assert jpeg_device("gpu") == torch.device("cuda")
    with pytest.raises(RuntimeError, match="set dev = cpu"):
        decode_image(jfx.jpeg("444_37x53"), 3, jpeg_device(""))
