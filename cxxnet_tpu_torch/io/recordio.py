"""Record files of images (the port of ``cxxnet_tpu/io/recordio.py``).

The JAX package's wire format, byte for byte, so a file written by
either package is read by the other:

    uint32 magic 0xCED7ABEF | uint32 payload_len | payload | pad to 8 bytes

and the image payload

    uint32 flag | uint64 id | uint32 nlabel | float32 * nlabel | bytes image

:class:`RecordReader` reads the byte range ``[part * size / nsplit,
(part + 1) * size / nsplit)`` resynced to the next 8-aligned magic, and
skips a record whose frame is damaged (up to ``max_skip``, then
raises; each skip counts as ``recordio.skipped``, which the serve
``/healthz`` reports as ``skipped_records``); a truncated last record
ends the range. Files are read and written through the stream layer
(:mod:`.stream`: local paths or ``scheme://`` URLs, with its ``io.*``
failpoints); the failpoint ``record.decode`` declares a record corrupt.
"""

from __future__ import annotations

import dataclasses
import io
import struct
from typing import BinaryIO, Iterator, List, Optional, Tuple

import numpy as np

from ..resilience import counters, failpoints
from .stream import getsize, sopen

MAGIC = 0xCED7ABEF
_HDR = struct.Struct("<II")
_IMG_HDR = struct.Struct("<IQI")


def _pad8(n: int) -> int:
    return (8 - n % 8) % 8


class RecordWriter:
    def __init__(self, path: str):
        self.path = path
        self._f: BinaryIO = sopen(path, "wb")
        self.offsets: List[int] = []     # record start offsets, in order
        self._pos = 0

    def write(self, payload: bytes) -> None:
        self.offsets.append(self._pos)
        self._f.write(_HDR.pack(MAGIC, len(payload)))
        self._f.write(payload)
        self._f.write(b"\x00" * _pad8(len(payload)))
        self._pos += _HDR.size + len(payload) + _pad8(len(payload))

    def write_index(self, path: Optional[str] = None) -> str:
        """Write the record-offset index (default ``<rec>.idx``, one
        decimal offset per line), which :func:`shard_record_counts`
        reads instead of scanning the file."""
        path = path or self.path
        idx_path = path if path.endswith(".idx") else path + ".idx"
        with sopen(idx_path, "wb") as f:
            f.write("\n".join(str(o) for o in self.offsets).encode()
                    + b"\n")
        return idx_path

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class RecordReader:
    """Sequential reader over the byte range of shard ``part`` of
    ``nsplit`` of a record file (see the module docstring)."""

    def __init__(self, path: str, part: int = 0, nsplit: int = 1,
                 max_skip: int = 100):
        self.path = path
        size = getsize(path)
        self._f = sopen(path, "rb")
        self.begin = size * part // nsplit
        self.end = size * (part + 1) // nsplit
        self.max_skip = int(max_skip)
        self.skipped = 0
        self._resync(self.begin)

    def _resync(self, pos: int) -> None:
        """Seek to the first 8-aligned record magic at or after ``pos``
        (records start 8-aligned), or to ``end`` when there is none in
        the range."""
        pos = pos + (-pos) % 8
        want = struct.pack("<I", MAGIC)
        chunk_size = 1 << 16
        while pos < self.end:
            self._f.seek(pos)
            chunk = self._f.read(chunk_size)
            off = 0
            while True:
                idx = chunk.find(want, off)
                if idx < 0:
                    break
                if (pos + idx) % 8 == 0:
                    self._f.seek(pos + idx)
                    return
                off = idx + 1
            if len(chunk) < chunk_size:
                break
            pos += len(chunk) - 7     # a magic may straddle the chunks
        self._f.seek(self.end)

    def _skip_corrupt(self, at: int, why: str, resync: bool = True) -> None:
        self.skipped += 1
        counters.inc("recordio.skipped")
        if self.skipped > self.max_skip:
            raise IOError(
                f"{self.path}: {self.skipped} corrupt records exceed "
                f"max_skip={self.max_skip} (last at byte {at}: {why}); "
                "repack the file")
        if resync:
            self._resync(at + 8)

    def __iter__(self) -> Iterator[bytes]:
        while True:
            at = self._f.tell()
            if at >= self.end:
                return
            hdr = self._f.read(_HDR.size)
            if len(hdr) < _HDR.size:
                return
            magic, ln = _HDR.unpack(hdr)
            if magic != MAGIC:
                self._skip_corrupt(at, "bad record magic")
                continue
            payload = self._f.read(ln)
            if len(payload) < ln:
                # a torn tail ends the range; a damaged length field with
                # records after it is one corrupt record
                self._resync(at + 8)
                if self._f.tell() >= self.end:
                    return
                self._skip_corrupt(at, "bad record length", resync=False)
                continue
            self._f.read(_pad8(ln))
            if failpoints.fire("record.decode"):
                # an injected decode fault: the frame is whole, the
                # position already at the next record
                self._skip_corrupt(at, "injected decode fault",
                                   resync=False)
                continue
            yield payload

    def reset(self) -> None:
        self._resync(self.begin)
        self.skipped = 0

    def close(self) -> None:
        self._f.close()


def shard_record_counts(path: str, nsplit: int) -> List[int]:
    """Records per shard of the ``(part, nsplit)`` byte ranges of
    :class:`RecordReader`: a record belongs to the shard whose range
    holds its start. From the ``<rec>.idx`` index when it provably
    describes this file, else from one scan of the headers."""
    size = getsize(path)
    bounds = [size * k // nsplit for k in range(1, nsplit + 1)]
    counts = [0] * nsplit
    offsets = None
    try:
        with sopen(path + ".idx", "rb") as f:
            offsets = [int(line) for line in f.read().split() if line]
    except (OSError, ValueError):
        pass
    if offsets and offsets == sorted(offsets) \
            and all(0 <= o < size for o in offsets):
        try:
            with sopen(path, "rb") as f:
                f.seek(offsets[0])
                magic0, _ = _HDR.unpack(f.read(_HDR.size))
                f.seek(offsets[-1])
                magic1, ln = _HDR.unpack(f.read(_HDR.size))
            last_end = offsets[-1] + _HDR.size + ln + _pad8(ln)
            if (magic0 == MAGIC and magic1 == MAGIC and offsets[0] == 0
                    and last_end == size):
                part = 0
                for o in offsets:
                    while o >= bounds[part]:
                        part += 1
                    counts[part] += 1
                return counts
        except (OSError, struct.error):
            pass
    with sopen(path, "rb") as f:
        pos, part = 0, 0
        while pos + _HDR.size <= size:
            f.seek(pos)
            magic, ln = _HDR.unpack(f.read(_HDR.size))
            if magic != MAGIC:
                raise IOError(f"{path}: bad record magic at {pos}")
            while pos >= bounds[part]:
                part += 1
            counts[part] += 1
            pos += _HDR.size + ln + _pad8(ln)
    return counts


@dataclasses.dataclass
class ImageRecord:
    """One packed image instance."""
    inst_id: int
    labels: np.ndarray           # (nlabel,) float32
    data: bytes                  # encoded (jpeg/png) or raw payload
    flag: int = 0

    def pack(self) -> bytes:
        lab = np.asarray(self.labels, np.float32).ravel()
        return (_IMG_HDR.pack(self.flag, self.inst_id, lab.size)
                + lab.tobytes() + self.data)

    @classmethod
    def unpack(cls, payload: bytes) -> "ImageRecord":
        flag, inst_id, nlab = _IMG_HDR.unpack_from(payload, 0)
        off = _IMG_HDR.size
        labels = np.frombuffer(payload, np.float32, nlab, off).copy()
        return cls(inst_id=inst_id, labels=labels,
                   data=payload[off + 4 * nlab:], flag=flag)


def read_image_list(path: str) -> List[Tuple[int, np.ndarray, str]]:
    """Parse a ``.lst`` image list: whitespace-separated ``index
    label[ label2 ...] relative_path`` lines."""
    out = []
    with io.TextIOWrapper(sopen(path, "rb")) as f:
        for line in f:
            parts = line.strip().split()
            if len(parts) < 3:
                continue
            idx = int(float(parts[0]))
            labels = np.asarray([float(x) for x in parts[1:-1]], np.float32)
            out.append((idx, labels, parts[-1]))
    return out
