"""The BinaryPage pack, the legacy image-pack format (the port's copy of
``cxxnet_tpu/io/binpage.py``; a pack written by either package is
byte-equal to the other's).

Fixed 64 MiB pages of int32: word 0 holds the object count N, words
1..N+1 the cumulative end offsets (word 1 is 0), and the objects' bytes
grow backward from the end of the page: object k occupies
``[PAGE_BYTES - end[k+1], PAGE_BYTES - end[k])``. The ``imgbin``
iterators read packs directly, the k-th object's label from the k-th
line of the companion ``.lst`` file.
"""

from __future__ import annotations

import struct
from typing import Iterator, List, Tuple

import numpy as np

from .stream import getsize, sopen

PAGE_INTS = 64 << 18
PAGE_BYTES = PAGE_INTS * 4


class BinaryPageWriter:
    """Pack byte objects into 64 MiB pages."""

    def __init__(self, path: str):
        self._f = sopen(path, "wb")
        self._clear()

    def _clear(self) -> None:
        self._objs: List[bytes] = []
        self._data_bytes = 0

    def _free_bytes(self) -> int:
        return (PAGE_INTS - (len(self._objs) + 2)) * 4 - self._data_bytes

    def push(self, data: bytes) -> None:
        if len(data) + 4 > self._free_bytes():
            self.flush_page()
            if len(data) + 4 > self._free_bytes():
                raise ValueError(
                    f"object of {len(data)} bytes exceeds the 64MiB page")
        self._objs.append(data)
        self._data_bytes += len(data)

    def flush_page(self) -> None:
        if not self._objs:
            return
        page = bytearray(PAGE_BYTES)
        n = len(self._objs)
        struct.pack_into("<i", page, 0, n)
        end = 0
        for k, obj in enumerate(self._objs):
            end += len(obj)
            struct.pack_into("<i", page, 4 * (k + 2), end)
            page[PAGE_BYTES - end:PAGE_BYTES - end + len(obj)] = obj
        self._f.write(bytes(page))
        self._clear()

    def close(self) -> None:
        self.flush_page()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def page_object_count(path: str, page_idx: int) -> int:
    """The object count of one page, read from its header alone."""
    with sopen(path, "rb") as f:
        f.seek(page_idx * PAGE_BYTES)
        return struct.unpack("<i", f.read(4))[0]


def num_pages(path: str) -> int:
    size = getsize(path)
    if size % PAGE_BYTES:
        raise ValueError(f"{path}: size {size} is not a whole number of "
                         f"64MiB BinaryPages")
    return size // PAGE_BYTES


def iter_binpage(path: str, part: int = 0, nsplit: int = 1) \
        -> Iterator[Tuple[int, bytes]]:
    """(global object index, object bytes) of the pages ``part``,
    ``part + nsplit``, ... (a worker's share, page by page)."""
    n_pages = num_pages(path)
    counts = [page_object_count(path, p) for p in range(n_pages)]
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    with sopen(path, "rb") as f:
        for p in range(part, n_pages, nsplit):
            f.seek(p * PAGE_BYTES)
            page = f.read(PAGE_BYTES)
            hdr = np.frombuffer(page, "<i4", counts[p] + 2)
            prev = 0
            for k in range(counts[p]):
                end = int(hdr[k + 2])
                size = end - prev
                yield (int(starts[p] + k),
                       page[PAGE_BYTES - end:PAGE_BYTES - end + size])
                prev = end
