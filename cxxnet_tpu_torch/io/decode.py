"""Image decoding for the port's record pipeline: PNG in numpy over
``zlib``, JPEG through libjpeg.

:func:`decode_image` gives what the JAX package's ``decode_image``
(``cxxnet_tpu/io/iter_imgrec.py``) gives: HWC uint8, RGB for
``want_channels = 3``, luma for 1.

* **PNG** (no library beyond ``zlib``): bit depth 8, not interlaced,
  colour types 0 (gray), 2 (RGB), 3 (palette), 4 (gray + alpha) and 6
  (RGBA), all five row filters; the chunks' CRCs are checked. The
  pixels equal PIL's ``convert("RGB")`` / ``convert("L")``: alpha is
  dropped, gray replicated, palette entries looked up, and luma is
  ``(19595 R + 38470 G + 7471 B + 2^15) >> 16``. Other bit depths and
  interlaced files raise, naming ROADMAP Queue A 2.
* **JPEG**: the port's copy of the JAX package's native decoder
  (``native/decode.cc``), built with ``g++ -ljpeg`` at first use, with
  the same output colour spaces, so on the same libjpeg the pixels are
  bit-equal. Where libjpeg (``jpeglib.h``, ``libjpeg.so``) is missing
  the build fails and a JPEG raises, naming what is missing and ROADMAP
  Queue A 2.
* Anything else raises.
"""

from __future__ import annotations

import ctypes
import struct
import threading
import zlib

import numpy as np

from .data import A2

PNG_SIG = b"\x89PNG\r\n\x1a\n"
JPEG_SOI = b"\xff\xd8"

#: channels of each PNG colour type
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _luma(rgb: np.ndarray) -> np.ndarray:
    """PIL's ITU-R 601-2 luma of (..., 3) uint8, in its fixed point."""
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16) \
        .astype(np.uint8)


def _avg_row(x, prev, bpp: int) -> bytearray:
    """Reconstruct one row of filter 3 (Average), byte by byte."""
    out = bytearray(x)
    for i in range(bpp):
        out[i] = (x[i] + (prev[i] >> 1)) & 255
    for i in range(bpp, len(out)):
        out[i] = (x[i] + ((out[i - bpp] + prev[i]) >> 1)) & 255
    return out


def _paeth_row(x, prev, bpp: int) -> bytearray:
    """Reconstruct one row of filter 4 (Paeth), byte by byte."""
    out = bytearray(x)
    for i in range(bpp):                  # a = c = 0: the predictor is b
        out[i] = (x[i] + prev[i]) & 255
    for i in range(bpp, len(out)):
        a, b, c = out[i - bpp], prev[i], prev[i - bpp]
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        if pa <= pb and pa <= pc:
            pred = a
        elif pb <= pc:
            pred = b
        else:
            pred = c
        out[i] = (x[i] + pred) & 255
    return out


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters of ``h`` rows of ``stride`` bytes. None
    and Sub rows depend on their own row only and go in one vectorized
    pass; Up rows add the row above; Average and Paeth rows run a loop
    over their bytes."""
    buf = np.frombuffer(raw, np.uint8)
    if buf.size < h * (stride + 1):
        raise ValueError("PNG: image data is truncated")
    rows = buf[:h * (stride + 1)].reshape(h, stride + 1)
    ftype, data = rows[:, 0], rows[:, 1:]
    if ftype.max(initial=0) > 4:
        raise ValueError(f"PNG: unknown row filter {int(ftype.max())}")
    out = data.copy()
    sub = ftype == 1
    if sub.any():
        out[sub] = np.cumsum(data[sub].reshape(-1, stride // bpp, bpp),
                             axis=1, dtype=np.uint8).reshape(-1, stride)
    zero = np.zeros(stride, np.uint8)
    for r in np.flatnonzero(ftype >= 2):
        prev = out[r - 1] if r else zero
        f = ftype[r]
        if f == 2:
            np.add(data[r], prev, out=out[r])
        elif f == 3:
            out[r] = np.frombuffer(_avg_row(data[r].tobytes(),
                                            prev.tobytes(), bpp), np.uint8)
        else:
            out[r] = np.frombuffer(_paeth_row(data[r].tobytes(),
                                              prev.tobytes(), bpp), np.uint8)
    return out


def decode_png(data: bytes, want_channels: int = 3) -> np.ndarray:
    """PNG bytes -> (h, w, want_channels) uint8 (see the module
    docstring for what is read)."""
    if not data.startswith(PNG_SIG):
        raise ValueError("not a PNG")
    pos, ihdr, plte, idat = len(PNG_SIG), None, None, []
    while pos + 8 <= len(data):
        ln, kind = struct.unpack_from(">I4s", data, pos)
        body = data[pos + 8:pos + 8 + ln]
        crc = data[pos + 8 + ln:pos + 12 + ln]
        if len(body) < ln or len(crc) < 4:
            raise ValueError(f"PNG: chunk {kind!r} is truncated")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"PNG: bad CRC in chunk {kind!r}")
        pos += 12 + ln
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ihdr is None or not idat:
        raise ValueError("PNG: no IHDR or no IDAT chunk")
    w, h, depth, ctype, _, _, interlace = ihdr
    if ctype not in _PNG_CHANNELS:
        raise ValueError(f"PNG: bad colour type {ctype}")
    if depth != 8 or interlace:
        raise NotImplementedError(
            f"PNG with bit depth {depth}{', interlaced' if interlace else ''}"
            f": the port reads 8-bit non-interlaced PNGs only ({A2})")
    ch = _PNG_CHANNELS[ctype]
    img = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch, ch) \
        .reshape(h, w, ch)
    if ctype == 3:
        if plte is None:
            raise ValueError("PNG: palette image without PLTE")
        pal = np.zeros((256, 3), np.uint8)
        n = min(len(plte) // 3, 256)
        pal[:n] = np.frombuffer(plte[:3 * n], np.uint8).reshape(n, 3)
        img = pal[img[:, :, 0]]
    elif ctype in (0, 4):
        img = img[:, :, :1]
    else:
        img = img[:, :, :3]
    gray = img.shape[2] == 1
    if want_channels == 1:
        return img if gray else _luma(img)[:, :, None]
    return np.repeat(img, 3, axis=2) if gray else np.ascontiguousarray(img)


_jpeg_lock = threading.Lock()
_jpeg_lib = None


def _jpeg():
    """The libjpeg decoder library, built and loaded at first use."""
    global _jpeg_lib
    with _jpeg_lock:
        if _jpeg_lib is None:
            from ..ops import _build
            try:
                lib = _build.load_host("decode.cc", libs=("jpeg",))
            except (RuntimeError, OSError) as e:
                raise RuntimeError(
                    "JPEG decoding needs libjpeg (its header jpeglib.h and "
                    "libjpeg.so) to build the port's decoder, and this "
                    f"machine's build failed ({A2}; nvJPEG is the route on "
                    f"the card that is queued there):\n{e}") from e
            lib.cxn_jpeg_dims.restype = ctypes.c_int
            lib.cxn_jpeg_dims.argtypes = [
                ctypes.c_char_p, ctypes.c_long, ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
            lib.cxn_jpeg_decode.restype = ctypes.c_int
            lib.cxn_jpeg_decode.argtypes = [
                ctypes.c_char_p, ctypes.c_long, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
            _jpeg_lib = lib
        return _jpeg_lib


def decode_jpeg(data: bytes, want_channels: int = 3) -> np.ndarray:
    """JPEG bytes -> (h, w, want_channels) uint8 through libjpeg
    (``want_channels`` 3 or 1)."""
    lib = _jpeg()
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if lib.cxn_jpeg_dims(data, len(data), ctypes.byref(h), ctypes.byref(w),
                         ctypes.byref(c)) != 0:
        raise ValueError("JPEG: cannot read the header")
    out = np.empty((h.value, w.value, want_channels), np.uint8)
    rc = lib.cxn_jpeg_decode(data, len(data), want_channels,
                             out.ctypes.data_as(ctypes.c_void_p),
                             h.value, w.value)
    if rc != 0:
        raise ValueError(f"JPEG: decode failed ({rc})")
    return out


def decode_image(data: bytes, want_channels: int = 3) -> np.ndarray:
    """Encoded image bytes -> HWC uint8: RGB for ``want_channels = 3``,
    luma for 1. PNG and JPEG; anything else raises."""
    if want_channels not in (1, 3):
        raise ValueError(f"want_channels must be 1 or 3, got {want_channels}")
    if data.startswith(PNG_SIG):
        return decode_png(data, want_channels)
    if data.startswith(JPEG_SOI):
        return decode_jpeg(data, want_channels)
    raise NotImplementedError(
        f"image format with magic {data[:8]!r}: the port decodes PNG and "
        f"JPEG only ({A2})")
