"""Shared setup of the port's image-record tests: seeded structured
images, a minimal PNG writer over ``zlib`` that uses every row filter,
and record files of them.

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
    ``interlace`` only label the header (to make files the decoder must
    refuse)."""
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
