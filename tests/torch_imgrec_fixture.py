"""Shared setup of the port's image-record tests: seeded structured
images, minimal PNG writers over ``zlib`` that use every row filter
(any colour type, bit depth and interlace), record files of them, and
Caffe ``.binaryproto`` means.

No jax import: the port's tests and the JAX package's iterator both
read what these helpers write.
"""

import io
import struct
import zlib

import numpy as np


def image(rng: np.random.RandomState, h: int, w: int, c: int = 3
          ) -> np.ndarray:
    """A (h, w, c) uint8 image with structure: a gradient per channel, a
    bright rectangle and some noise."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.empty((h, w, c), np.float32)
    for k in range(c):
        a, b = rng.uniform(-2, 2, 2)
        out[:, :, k] = 128 + a * (yy - h / 2) + b * (xx - w / 2)
    y0, x0 = rng.randint(0, h // 2), rng.randint(0, w // 2)
    out[y0:y0 + h // 3, x0:x0 + w // 3] += rng.uniform(30, 90, c)
    out += rng.randn(h, w, c) * 6
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _filter_rows(rows: np.ndarray, bpp: int, ftypes) -> bytes:
    """PNG-filter each row of ``rows`` ((h, stride) uint8) with its type
    of ``ftypes`` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    out, prev = [], np.zeros(rows.shape[1], np.int32)
    zeros = np.zeros(bpp, np.int32)
    for r, f in zip(rows.astype(np.int32), ftypes):
        a = np.concatenate([zeros, r[:-bpp]])
        c = np.concatenate([zeros, prev[:-bpp]])
        b = prev
        if f == 0:
            x = r
        elif f == 1:
            x = r - a
        elif f == 2:
            x = r - b
        elif f == 3:
            x = r - ((a + b) >> 1)
        else:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            x = r - np.where((pa <= pb) & (pa <= pc), a,
                             np.where(pb <= pc, b, c))
        out.append(bytes([int(f)]) + (x & 255).astype(np.uint8).tobytes())
        prev = r
    return b"".join(out)


def png_bytes(img: np.ndarray, ctype: int = None, plte: bytes = None,
              ftypes=None, depth: int = 8, interlace: int = 0) -> bytes:
    """PNG of ``img`` ((h, w, ch) uint8: ch 1 gray, 2 gray+alpha, 3 RGB,
    4 RGBA, or palette indices with ``ctype = 3`` and ``plte``); rows
    filtered by ``ftypes`` (default: row r by r % 5). ``depth`` and
    ``interlace`` only label the header (:func:`png_any` writes other
    depths and Adam7)."""
    h, w, ch = img.shape
    if ctype is None:
        ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    ftypes = [r % 5 for r in range(h)] if ftypes is None else ftypes
    body = _filter_rows(img.reshape(h, w * ch), ch, ftypes)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if plte is not None:
        out += _chunk(b"PLTE", plte)
    return out + _chunk(b"IDAT", zlib.compress(body)) + _chunk(b"IEND", b"")


#: Adam7's passes: (x0, y0, dx, dy)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _pack_rows(s: np.ndarray, depth: int) -> np.ndarray:
    """Samples (h, w, ch) -> rows of bytes at ``depth`` bits a sample
    (16: big-endian; below 8: packed from the high bit, the row padded
    to a byte)."""
    h, w, ch = s.shape
    if depth == 16:
        return s.astype(">u2").reshape(h, w * ch).view(np.uint8)
    if depth == 8:
        return s.astype(np.uint8).reshape(h, w * ch)
    per = 8 // depth
    flat = s.reshape(h, w * ch).astype(np.uint8)
    flat = np.concatenate([flat, np.zeros((h, -flat.shape[1] % per),
                                          np.uint8)], 1).reshape(h, -1, per)
    shifts = (8 - depth * (np.arange(per) + 1)).astype(np.uint8)
    return (flat << shifts).sum(2).astype(np.uint8)


def png_any(samples: np.ndarray, ctype: int, depth: int,
            interlace: int = 0, plte: bytes = None, ftypes=None) -> bytes:
    """A PNG of any colour type, bit depth and interlace: ``samples``
    (h, w, ch) integers below 2^depth (palette indices for ``ctype =
    3``); each row of each pass filtered by ``ftypes(r)`` (default r %
    5, so every pass of every size uses every filter it has rows for)."""
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    ft = ftypes or (lambda r: r % 5)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    body = b""
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            body += _filter_rows(_pack_rows(sub, depth), bpp,
                                 [ft(r) for r in range(sub.shape[0])])
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if plte is not None:
        out += _chunk(b"PLTE", plte)
    return out + _chunk(b"IDAT", zlib.compress(body)) + _chunk(b"IEND", b"")


def pil_bytes(img: np.ndarray, fmt: str, **kw) -> bytes:
    """``img`` encoded by PIL (``fmt`` "PNG" or "JPEG")."""
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(img[:, :, 0] if img.shape[2] == 1 else img).save(
        buf, fmt, **kw)
    return buf.getvalue()


def write_records(path: str, encoded, writer_cls, record_cls,
                  labels=None, ids=None) -> None:
    """One record per encoded image, with the given record classes (the
    port's or the JAX package's): instance id ``ids[i]`` (default i),
    label ``labels[i]`` (default i % 10), and the offset index."""
    with writer_cls(path) as w:
        for i, data in enumerate(encoded):
            lab = [float(i % 10)] if labels is None else labels[i]
            w.write(record_cls(inst_id=i if ids is None else ids[i],
                               labels=np.asarray(lab, np.float32),
                               data=data).pack())
        w.write_index(path)


def _varint(v):
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


def _field(num, wt, payload):
    key = _varint(num << 3 | wt)
    if wt == 0:
        return key + _varint(payload)
    if wt == 2:
        return key + _varint(len(payload)) + payload
    return key + payload


def binaryproto(arr, legacy=True, packed=True, packed_dims=True,
                lead_one=True):
    """A BlobProto of ``arr`` (C, H, W) float32 in the given spellings."""
    shape = ((1,) if lead_one else ()) + arr.shape
    out = b""
    if legacy:
        dims = (1,) * (4 - len(arr.shape)) + arr.shape
        for f, d in zip((1, 2, 3, 4), dims):
            out += _field(f, 0, d)
    else:
        if packed_dims:
            body = _field(1, 2, b"".join(_varint(d) for d in shape))
        else:
            body = b"".join(_field(1, 0, d) for d in shape)
        out += _field(7, 2, body)
    flat = arr.astype("<f4").ravel()
    if packed:
        out += _field(5, 2, flat.tobytes())
    else:
        out += b"".join(_field(5, 5, struct.pack("<f", v)) for v in flat)
    return out
