"""The image-file iterator ``img`` and the side-feature join ``attachtxt``
(the port of ``cxxnet_tpu/io/iter_img.py``).

It reads an image list (``image_list`` / ``path_imglist``: ``index<TAB>
label...<TAB>relative/path`` per line) and loads each file from
``image_root`` / ``path_imgdir``, with ``shuffle`` (``RandomState
(seed_data)``, once an epoch), labels of ``label_width``, the mean image
(computed on first use from every file with ``RandomState(0)`` and
written as a ``.npy`` file, or read from a ``.npy`` or ``.binaryproto``)
and every augmentation of :mod:`.augment`. A batch's files are decoded
on a pool of ``decode_threads`` threads (:mod:`.decode`: PNG through
``png.cc``, JPEG through nvJPEG on the card ``dev`` names or through
libjpeg with ``dev = cpu``), then augmented in order from the
iterator's one rng, as the JAX iterator draws them: its batches are the
JAX package's, bit for bit without the affine warp and within 2e-3 with
it. The epoch's last batch repeats its last image, marked as padding.
Batches are normalized float32 (no ``device_normalize`` path, as in the
JAX package). The list and the files are read through the stream layer
(local paths or ``scheme://`` URLs).

``attachtxt`` wraps a chain whose batches carry ``inst_index`` and adds
one ``extra_data`` array, ``(batch, 1, 1, dim)`` float32, of the rows of
its ``filename`` (``dim``, then ``id f1 .. fdim`` rows, whitespace
separated, read through the stream layer) joined on the instance id; an
id the file lacks gets zeros.
"""

from __future__ import annotations

import concurrent.futures as futures
import dataclasses
import os
from typing import Optional

import numpy as np

from .augment import (AugmentParams, ImageAugmenter, MeanStore,
                      mean_cache_path, pack_label)
from . import stream
from .data import DataBatch, DataIter, register_iter
from .decode import decode_image, jpeg_device
from .recordio import read_image_list


@register_iter("img")
class ImageIterator(DataIter):
    """Per-file image loader driven by an image list file."""

    def set_param(self, name, val):
        if name in ("image_list", "path_imglist"):
            self.list_path = val
        elif name in ("image_root", "path_imgdir"):
            self.root = val
        elif name == "batch_size":
            self.batch_size = int(val)
        elif name == "input_shape":
            self.input_shape = tuple(int(x) for x in val.split(","))
        elif name == "shuffle":
            self.shuffle = int(val)
        elif name == "seed_data":
            self.seed = int(val)
        elif name == "label_width":
            self.label_width = int(val)
        elif name == "decode_threads":
            self.nthread = int(val)
        elif name == "silent":
            self.silent = int(val)
        elif name == "dev":
            self.dev = val
        else:
            self.aug.set_param(name, val)

    def __init__(self, cfg):
        self.list_path = ""
        self.root = ""
        self.batch_size = 128
        self.input_shape = None
        self.shuffle = 0
        self.seed = 0
        self.label_width = 1
        self.nthread = min(8, os.cpu_count() or 4)
        self.silent = 0
        self.dev = ""
        self.aug = AugmentParams()
        self._pool = None
        super().__init__(cfg)

    def init(self):
        if not self.list_path:
            raise ValueError("img: image_list must be set")
        if self.input_shape is None:
            raise ValueError("img: input_shape must be set")
        if self.nthread < 1:
            raise ValueError(f"decode_threads must be >= 1, got "
                             f"{self.nthread}")
        c, y, x = self.input_shape
        self._jpeg_device = jpeg_device(self.dev)
        self.augmenter = ImageAugmenter(self.aug, (c, y, x))
        self.mean = MeanStore(mean_cache_path(self.aug), (y, x, c))
        self.items = list(read_image_list(self.list_path))
        if not self.silent:
            print(f"ImageIterator: image_list={self.list_path} "
                  f"({len(self.items)} images)", flush=True)
        self._order = np.arange(len(self.items))
        self._rng = np.random.RandomState(self.seed)
        self._pool = futures.ThreadPoolExecutor(self.nthread)
        if self.aug.mean_img and not self.mean.ready:
            rng = np.random.RandomState(0)
            self.mean.compute(self.augmenter.process(img, rng) for img in
                              self._load_all(range(len(self.items))))
        self.before_first()

    def _load(self, i: int) -> np.ndarray:
        fname = self.items[i][2]
        path = os.path.join(self.root, fname) if self.root else fname
        return decode_image(stream.read_bytes(path), self.input_shape[0],
                            self._jpeg_device)

    def _load_all(self, idx):
        """The decoded images of ``idx``, in order, decoded on the pool a
        batch at a time."""
        idx = list(idx)
        for s in range(0, len(idx), self.batch_size):
            yield from self._pool.map(self._load,
                                      idx[s:s + self.batch_size])

    def before_first(self):
        if self.shuffle:
            self._rng.shuffle(self._order)
        self._pos = 0

    def next(self) -> Optional[DataBatch]:
        n = len(self.items)
        if self._pos >= n:
            return None
        bs = self.batch_size
        idx = self._order[self._pos:self._pos + bs]
        self._pos += bs
        padd = 0
        if len(idx) < bs:
            padd = bs - len(idx)
            idx = np.concatenate([idx, np.repeat(idx[-1:], padd)])
        imgs, labels, ids = [], [], []
        for i, img in zip(idx, self._load_all(int(i) for i in idx)):
            img = self.augmenter.process(img, self._rng)
            imgs.append(self.mean.apply(img, self.aug))
            labels.append(pack_label(self.items[int(i)][1],
                                     self.label_width))
            ids.append(self.items[int(i)][0])
        return DataBatch(data=np.stack(imgs), label=np.stack(labels),
                         num_batch_padd=padd,
                         inst_index=np.asarray(ids, np.int64))

    def close(self):
        """Shut the decode pool down."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)


@register_iter("attachtxt")
class AttachTxtIterator(DataIter):
    """Joins per-instance side features into ``batch.extra_data`` by id
    (appended after the arrays the batch already carries). A base batch
    without ``inst_index`` raises. The batch is a new object: the base's
    is not changed (the JAX iterator appends to the base batch's list, so
    under a wrapper that serves one batch object again, ``membuffer`` or
    ``test_skipread``, its list grows an array an epoch)."""

    def set_param(self, name, val):
        if name == "filename":
            self.filename = val

    def __init__(self, cfg, base: DataIter):
        self.filename = ""
        self.base = base
        super().__init__(cfg)

    def init(self):
        if not self.filename:
            raise ValueError("attachtxt: filename must be set")
        toks = stream.read_bytes(self.filename).decode().split()
        self.dim = int(toks[0])
        self.table = {}
        pos = 1
        while pos < len(toks):
            inst_id = int(toks[pos])
            feat = np.asarray([float(t) for t in
                               toks[pos + 1:pos + 1 + self.dim]], np.float32)
            if feat.shape[0] != self.dim:
                raise ValueError(
                    "attachtxt: data do not match dimension specified")
            self.table[inst_id] = feat
            pos += 1 + self.dim

    def before_first(self):
        self.base.before_first()

    def next(self) -> Optional[DataBatch]:
        b = self.base.next()
        if b is None:
            return None
        if b.inst_index is None:
            raise ValueError("attachtxt: base iterator yields no inst_index")
        extra = np.zeros((b.batch_size, 1, 1, self.dim), np.float32)
        for row, inst_id in enumerate(np.asarray(b.inst_index)):
            feat = self.table.get(int(inst_id))
            if feat is not None:
                extra[row, 0, 0, :] = feat
        return dataclasses.replace(b, extra_data=list(b.extra_data) + [extra])
