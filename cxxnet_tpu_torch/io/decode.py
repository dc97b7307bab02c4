"""Image decoding for the port's image pipeline: PNG through native
code over ``zlib``, JPEG through libjpeg on the CPU and nvJPEG on the
card.

:func:`decode_image` gives what the JAX package's ``decode_image``
(``cxxnet_tpu/io/iter_imgrec.py``) gives: HWC uint8, RGB for
``want_channels = 3``, luma for 1.

* **PNG**: the chunks are read here (CRCs checked) and ``zlib``
  inflates the image data; ``native/png.cc``, built with ``g++`` at
  first use, undoes the five row filters, de-interlaces Adam7, reads
  bit depths 1, 2, 4, 8 and 16 of colour types 0 (gray), 2 (RGB), 3
  (palette), 4 (gray + alpha) and 6 (RGBA), looks palette entries up
  and drops alpha, with the GIL released. The pixels are OpenCV's
  (which the JAX package decodes PNG with): a 16-bit sample keeps its
  high byte, sub-8-bit gray is scaled to 0..255. One channel from a
  colour PNG is PIL's luma, ``(19595 R + 38470 G + 7471 B + 2^15) >>
  16`` (OpenCV's differs by 1 in about half the pixels: ROADMAP queue
  C). If ``png.cc`` does not build or load, a PNG raises. The numpy
  loops below (:func:`decode_png_plain`, 8-bit non-interlaced only)
  are its plain version, which the tests use and the pipeline never
  does.
* **JPEG** takes the route of the device the caller names:
  - ``device`` None or the CPU: the port's copy of the JAX package's
    native decoder (``native/decode.cc``), built with ``g++ -ljpeg`` at
    first use, with the same output colour spaces, so on the same
    libjpeg the pixels are bit-equal. Where libjpeg (``jpeglib.h``,
    ``libjpeg.so``) is missing the build fails and a JPEG raises;
  - a CUDA device: nvJPEG on that device (``native/nvjpeg.cc``, built
    against the CUDA toolkit's ``nvjpeg.h``, ``-lnvjpeg -lcudart``),
    one decoder (state, non-blocking stream, buffers) per decoding
    thread, the pixels copied back to host memory. One channel is the
    Y plane (libjpeg's ``JCS_GRAYSCALE``); three channels of a 4:4:4,
    4:2:2 or 4:2:0 file are nvJPEG's YCbCr planes finished on the host
    by ``native/jpeg_color.h``, libjpeg's own fancy chroma upsampling
    and colour conversion (bit-equal to libjpeg over libjpeg's planes:
    :func:`jpeg_planes`, :func:`planes_to_rgb`), so the card's pixels
    differ from libjpeg's only by the IDCT's rounding.

  A four-component file (CMYK, or YCCK by its Adobe marker) comes out as
  the JAX package gives it: its native decoder asks libjpeg for RGB,
  which libjpeg refuses for four components, so cv2 answers, decoding to
  libjpeg's CMYK and converting by OpenCV's subtractive formula. libjpeg
  here decodes to CMYK and ``jpeg_color.h`` applies that formula; on the
  card nvJPEG gives the four planes as stored (``NVJPEG_OUTPUT_UNCHANGED``)
  and ``jpeg_color.h`` upsamples them, converts YCCK, and applies it
  (:func:`decode_jpeg_planar4` is that half over libjpeg's planes).

  Neither route falls back to the other: a failure to build, load or
  decode raises, with nvJPEG's status on the card.
* Anything else raises (the JAX package hands other formats to cv2, which
  the card's machine does not have).
"""

from __future__ import annotations

import ctypes
import os
import struct
import threading
import zlib
from typing import Dict, Optional

import numpy as np
import torch

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


#: bit depths each PNG colour type allows
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8),
               4: (8, 16), 6: (8, 16)}


def _png_chunks(data: bytes):
    """The IHDR fields, the PLTE bytes (or None) and the inflated image
    data of a PNG, its chunks' CRCs checked."""
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
    if depth not in _PNG_DEPTHS[ctype] or interlace > 1:
        raise ValueError(f"PNG: bit depth {depth} with colour type {ctype}"
                         f", interlace {interlace}: not a valid header")
    if ctype == 3 and plte is None:
        raise ValueError("PNG: palette image without PLTE")
    return ihdr, plte, zlib.decompress(b"".join(idat))


def _to_channels(img: np.ndarray, ctype: int, plte, want_channels: int
                 ) -> np.ndarray:
    """Samples (h, w, ch) uint8 -> (h, w, want_channels): palette
    lookup, alpha dropped, gray replicated or luma taken."""
    if ctype == 3:
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


def decode_png_plain(data: bytes, want_channels: int = 3) -> np.ndarray:
    """The plain version of :func:`decode_png` in numpy, for 8-bit
    non-interlaced PNGs (other files raise): the tests hold
    ``png.cc`` against it."""
    (w, h, depth, ctype, _, _, interlace), plte, raw = _png_chunks(data)
    if depth != 8 or interlace:
        raise NotImplementedError(
            f"PNG with bit depth {depth}{', interlaced' if interlace else ''}"
            ": the plain version reads 8-bit non-interlaced PNGs only")
    ch = _PNG_CHANNELS[ctype]
    img = _unfilter(raw, h, w * ch, ch).reshape(h, w, ch)
    return _to_channels(img, ctype, plte, want_channels)


_png_lock = threading.Lock()
_png_lib = None


def _png():
    """The PNG reconstruction library, built and loaded at first use."""
    global _png_lib
    with _png_lock:
        if _png_lib is None:
            from ..ops import _build
            lib = _build.load_host("png.cc")
            lib.cxn_png_decode.restype = ctypes.c_int
            lib.cxn_png_decode.argtypes = [
                ctypes.c_char_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_char_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            _png_lib = lib
        return _png_lib


_PNG_ERRORS = {-1: "a header the decoder does not take",
               -2: "image data is truncated", -3: "unknown row filter",
               -4: "palette image without PLTE"}


def decode_png(data: bytes, want_channels: int = 3) -> np.ndarray:
    """PNG bytes -> (h, w, want_channels) uint8 through ``png.cc`` (see
    the module docstring for what is read)."""
    (w, h, depth, ctype, _, _, interlace), plte, raw = _png_chunks(data)
    lib = _png()
    out = np.empty((h, w, want_channels), np.uint8)
    plte = plte or b""
    rc = lib.cxn_png_decode(raw, len(raw), w, h, depth, ctype, interlace,
                            plte, len(plte), want_channels,
                            out.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise ValueError(f"PNG: {_PNG_ERRORS.get(rc, rc)}")
    return out


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
                    "JPEG decoding on the CPU (dev = cpu) needs libjpeg (its "
                    "header jpeglib.h and libjpeg.so) to build the port's "
                    "decoder, and this machine's build failed; on the card "
                    f"JPEG goes through nvJPEG:\n{e}") from e
            lib.cxn_jpeg_dims.restype = ctypes.c_int
            lib.cxn_jpeg_dims.argtypes = [
                ctypes.c_char_p, ctypes.c_long, ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
            lib.cxn_jpeg_decode.restype = ctypes.c_int
            lib.cxn_jpeg_decode.argtypes = [
                ctypes.c_char_p, ctypes.c_long, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
            lib.cxn_jpeg_planes.restype = ctypes.c_int
            lib.cxn_jpeg_planes.argtypes = [
                ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
            lib.cxn_jpeg_decode4_planar.restype = ctypes.c_int
            lib.cxn_jpeg_decode4_planar.argtypes = \
                lib.cxn_jpeg_decode.argtypes
            lib.cxn_jpeg_planes_to_rgb.restype = None
            lib.cxn_jpeg_planes_to_rgb.argtypes = [ctypes.c_void_p] * 3 + [
                ctypes.c_int] * 6 + [ctypes.c_void_p]
            _jpeg_lib = lib
        return _jpeg_lib


def decode_jpeg(data: bytes, want_channels: int = 3) -> np.ndarray:
    """JPEG bytes -> (h, w, want_channels) uint8 through libjpeg
    (``want_channels`` 3 or 1); a CMYK or YCCK file through libjpeg's
    CMYK and OpenCV's conversion."""
    return _libjpeg_decode("cxn_jpeg_decode", data, want_channels)


def decode_jpeg_planar4(data: bytes, want_channels: int = 3) -> np.ndarray:
    """A CMYK or YCCK JPEG decoded the way the card finishes nvJPEG's
    planes: libjpeg's four raw planes through ``jpeg_color.h``
    (upsampling, YCCK -> CMYK, OpenCV's conversion). The tests hold it
    bit-equal to :func:`decode_jpeg`."""
    return _libjpeg_decode("cxn_jpeg_decode4_planar", data, want_channels)


def _libjpeg_decode(fn: str, data: bytes, want_channels: int) -> np.ndarray:
    lib = _jpeg()
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if lib.cxn_jpeg_dims(data, len(data), ctypes.byref(h), ctypes.byref(w),
                         ctypes.byref(c)) != 0:
        raise ValueError("JPEG: cannot read the header")
    out = np.empty((h.value, w.value, want_channels), np.uint8)
    rc = getattr(lib, fn)(data, len(data), want_channels,
                          out.ctypes.data_as(ctypes.c_void_p),
                          h.value, w.value)
    if rc != 0:
        raise ValueError(f"JPEG: decode failed ({rc}, {c.value} "
                         "components)")
    return out


def jpeg_planes(data: bytes):
    """The Y, Cb and Cr planes of a YCbCr JPEG as libjpeg stores them
    (raw data output): Y (h, w) and the subsampled Cb, Cr."""
    lib = _jpeg()
    dims = (ctypes.c_int * 4)()
    if lib.cxn_jpeg_planes(data, len(data), None, None, None, dims) != 0:
        raise ValueError("JPEG: not a three-component file libjpeg reads")
    h, w, ch, cw = dims
    y = np.empty((h, w), np.uint8)
    cb, cr = np.empty((ch, cw), np.uint8), np.empty((ch, cw), np.uint8)
    if lib.cxn_jpeg_planes(data, len(data), y.ctypes.data, cb.ctypes.data,
                           cr.ctypes.data, dims) != 0:
        raise ValueError("JPEG: decode failed")
    return y, cb, cr


def planes_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray
                  ) -> np.ndarray:
    """(h, w, 3) RGB from YCbCr planes through ``native/jpeg_color.h``
    (libjpeg's fancy upsampling and colour conversion: the code nvJPEG's
    planes go through on the card)."""
    h, w = y.shape
    ch, cw = cb.shape
    hf, vf = (2 if cw < w else 1), (2 if ch < h else 1)
    out = np.empty((h, w, 3), np.uint8)
    _jpeg().cxn_jpeg_planes_to_rgb(
        np.ascontiguousarray(y).ctypes.data,
        np.ascontiguousarray(cb).ctypes.data,
        np.ascontiguousarray(cr).ctypes.data, h, w, ch, cw, hf, vf,
        out.ctypes.data)
    return out


#: nvjpegStatus_t names (nvjpeg.h)
NVJPEG_STATUS = {1: "NVJPEG_STATUS_NOT_INITIALIZED",
                 2: "NVJPEG_STATUS_INVALID_PARAMETER",
                 3: "NVJPEG_STATUS_BAD_JPEG",
                 4: "NVJPEG_STATUS_JPEG_NOT_SUPPORTED",
                 5: "NVJPEG_STATUS_ALLOCATOR_FAILURE",
                 6: "NVJPEG_STATUS_EXECUTION_FAILED",
                 7: "NVJPEG_STATUS_ARCH_MISMATCH",
                 8: "NVJPEG_STATUS_INTERNAL_ERROR",
                 9: "NVJPEG_STATUS_IMPLEMENTATION_NOT_SUPPORTED",
                 10: "NVJPEG_STATUS_INCOMPLETE_BITSTREAM"}
_NV_CUDA_ERROR, _NV_COMPONENTS, _NV_SHAPE = 1000, 1001, 1002

_nv_lock = threading.Lock()
_nv_lib = None
#: device index -> the NvJpeg of that device
_nv_decoders: Dict[int, "NvJpeg"] = {}
_nv_decoders_lock = threading.Lock()


def _nvjpeg_lib():
    """The nvJPEG decoder library, built against the CUDA toolkit and
    loaded at first use."""
    global _nv_lib
    with _nv_lock:
        if _nv_lib is None:
            from ..ops import _build
            home = _build.cuda_home()
            lib64 = os.path.join(home, "lib64")
            try:
                lib = _build.load_host(
                    "nvjpeg.cc", libs=("nvjpeg", "cudart"),
                    include_dirs=(os.path.join(home, "include"),),
                    lib_dirs=(lib64,), rpath=(lib64,))
            except (RuntimeError, OSError) as e:
                raise RuntimeError(
                    "JPEG decoding on the card needs nvJPEG (nvjpeg.h and "
                    f"libnvjpeg under the CUDA toolkit, {home}) to build the "
                    f"port's decoder, and the build failed:\n{e}") from e
            vp = ctypes.c_void_p
            ip = ctypes.POINTER(ctypes.c_int)
            for name, args in (
                    ("cxn_nvjpeg_handle", [ctypes.c_int,
                                           ctypes.POINTER(vp)]),
                    ("cxn_nvjpeg_create", [ctypes.c_int, vp,
                                           ctypes.POINTER(vp)]),
                    ("cxn_nvjpeg_destroy", [vp]),
                    ("cxn_nvjpeg_info", [vp, ctypes.c_char_p, ctypes.c_long,
                                         ip, ip, ip]),
                    ("cxn_nvjpeg_decode", [vp, ctypes.c_char_p,
                                           ctypes.c_long, ctypes.c_int, vp,
                                           ctypes.c_int, ctypes.c_int])):
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int
                fn.argtypes = args
            lib.cxn_nvjpeg_cuda_error.restype = ctypes.c_char_p
            lib.cxn_nvjpeg_cuda_error.argtypes = [ctypes.c_int]
            _nv_lib = lib
        return _nv_lib


class NvJpeg:
    """nvJPEG on one card: a shared handle, and one decoder (state,
    non-blocking stream, device and pinned buffers) for each thread that
    decodes. Decoders of threads that have ended are freed when a new
    thread first decodes."""

    def __init__(self, device: int):
        self.device = device
        self.lib = _nvjpeg_lib()
        handle = ctypes.c_void_p()
        self._check(self.lib.cxn_nvjpeg_handle(device, ctypes.byref(handle)),
                    "creating the handle")
        self.handle = handle
        self._lock = threading.Lock()
        self._ctx: Dict[int, ctypes.c_void_p] = {}

    def _check(self, rc: int, what: str) -> None:
        if rc == 0:
            return
        if rc == _NV_COMPONENTS:
            raise ValueError(
                "JPEG: nvJPEG's route decodes files of 1, 3 or 4 components "
                "whose planes are full size or halved (2x1, 2x2), not this "
                "one")
        if rc == _NV_SHAPE:
            raise ValueError("JPEG: nvJPEG's dims differ from the header's")
        if rc >= _NV_CUDA_ERROR:
            msg = self.lib.cxn_nvjpeg_cuda_error(rc).decode()
            raise RuntimeError(f"nvJPEG on cuda:{self.device}, {what}: CUDA "
                               f"error {rc - _NV_CUDA_ERROR} ({msg})")
        raise RuntimeError(f"nvJPEG on cuda:{self.device}, {what}: "
                           f"{NVJPEG_STATUS.get(rc, rc)}")

    def _mine(self) -> ctypes.c_void_p:
        """The calling thread's decoder, created at its first call."""
        me = threading.get_ident()
        with self._lock:
            ctx = self._ctx.get(me)
            if ctx is not None:
                return ctx
            alive = {t.ident for t in threading.enumerate()}
            for ident in [i for i in self._ctx if i not in alive]:
                self.lib.cxn_nvjpeg_destroy(self._ctx.pop(ident))
            ctx = ctypes.c_void_p()
            self._check(self.lib.cxn_nvjpeg_create(
                self.device, self.handle, ctypes.byref(ctx)),
                "creating a decoder")
            self._ctx[me] = ctx
            return ctx

    def decode(self, data: bytes, want_channels: int = 3) -> np.ndarray:
        """JPEG bytes -> (h, w, want_channels) uint8 in host memory."""
        ctx = self._mine()
        h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        self._check(self.lib.cxn_nvjpeg_info(
            ctx, data, len(data), ctypes.byref(h), ctypes.byref(w),
            ctypes.byref(c)), "reading the header")
        out = np.empty((h.value, w.value, want_channels), np.uint8)
        self._check(self.lib.cxn_nvjpeg_decode(
            ctx, data, len(data), want_channels,
            out.ctypes.data_as(ctypes.c_void_p), h.value, w.value),
            "decoding")
        return out


def nvjpeg(device: torch.device) -> NvJpeg:
    """The :class:`NvJpeg` of a CUDA device (one a process)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"JPEG decoding on {device} goes through nvJPEG, but no CUDA "
            "device is visible; set dev = cpu for the libjpeg route")
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    with _nv_decoders_lock:
        dec = _nv_decoders.get(index)
        if dec is None:
            dec = _nv_decoders[index] = NvJpeg(index)
        return dec


def jpeg_device(dev: str) -> Optional[torch.device]:
    """The JPEG route of an iterator's ``dev`` value: None (libjpeg) for
    ``cpu``, else the card it names; a list of cards (dp) names the
    rank's own, the current device. Resolved without raising: with no
    CUDA device visible, a JPEG raises when it is decoded."""
    spec = (dev or "").strip().lower()
    if spec.split(":", 1)[0] == "cpu":
        return None
    if not torch.cuda.is_available():
        return torch.device("cuda")
    from ..device import parse_device_spec
    ids = parse_device_spec(spec)
    if ids is not None and len(ids) == 1:
        return torch.device("cuda", ids[0])
    return torch.device("cuda", torch.cuda.current_device())


def decode_image(data: bytes, want_channels: int = 3,
                 device: Optional[torch.device] = None) -> np.ndarray:
    """Encoded image bytes -> HWC uint8: RGB for ``want_channels = 3``,
    luma for 1. PNG through ``png.cc``; JPEG through libjpeg when
    ``device`` is None or the CPU, through nvJPEG on a CUDA ``device``;
    anything else raises."""
    if want_channels not in (1, 3):
        raise ValueError(f"want_channels must be 1 or 3, got {want_channels}")
    if data.startswith(PNG_SIG):
        return decode_png(data, want_channels)
    if data.startswith(JPEG_SOI):
        if device is not None and torch.device(device).type == "cuda":
            return nvjpeg(torch.device(device)).decode(data, want_channels)
        return decode_jpeg(data, want_channels)
    raise NotImplementedError(
        f"image format with magic {data[:8]!r}: the port decodes PNG and "
        "JPEG files only (the JAX package hands other formats to cv2)")
