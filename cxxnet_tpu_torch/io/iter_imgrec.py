"""The image record iterator (the port of ``cxxnet_tpu/io/iter_imgrec.py``).

Registered as ``imgrec`` and, as in the JAX package, ``imgbin``,
``imgbinx``, ``imginst`` and ``imgbinold``. It reads a record file
(``image_rec``), decodes each record on a pool of ``decode_threads``
threads (:mod:`.decode`), augments it (:mod:`.augment`) and batches the
results; labels come from the records or, by instance id, from an
``image_list``. With ``shuffle`` the records are shuffled four batches
at a time by ``RandomState(seed_data)``; ``round_batch`` fills the
epoch's last batch from the start of the file, marked as padding.

Its batches are bit-equal to the JAX iterator's over the same file:
each item draws its augmentation from ``Generator(PCG64(hash(counter)))``
of a per-item counter, so the thread schedule changes nothing; the mean
image is computed on first use with ``RandomState(0)`` and written as a
``.npy`` file.

``device_normalize`` (``-1`` = auto) decides where the mean, ``divideby``
and ``scale`` are applied. Auto resolves to 1 when the augmentations keep
pixels exact (crop and mirror only) and the first records of the file
are encoded images at least as large as the crop; then batches are
uint8 and ``DataBatch.norm`` carries the normalization for the trainer
to apply on the card (the uint8 input fold). Otherwise the batches are
normalized float32, as the JAX package's host path makes them.

Not ported, each raising naming ROADMAP Queue A 2: ``image_bin`` /
``image_conf_prefix`` packs, distributed shards (``dist_num_worker``,
``dist_worker_rank`` and their environment variables), remote paths.
"""

from __future__ import annotations

import concurrent.futures as futures
import os
from typing import List, Optional

import numpy as np

from ..config import ConfigError
from .augment import (AugmentParams, ImageAugmenter, MeanStore,
                      mean_cache_path, pack_label)
from .data import A2, DataBatch, DataIter, register_iter
from .decode import decode_image
from .recordio import ImageRecord, RecordReader, read_image_list


def hash_seed(counter: int) -> int:
    """splitmix64 mix of a counter: the seed of one item's rng."""
    z = (counter + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return z ^ (z >> 31)


@register_iter("imgrec", "imgbin", "imgbinx", "imginst", "imgbinold")
class ImageRecordIterator(DataIter):
    """Batched, augmented image-record reader (see the module docstring)."""

    def set_param(self, name, val):
        if name in ("image_rec", "path_imgrec"):
            self.rec_path = val
        elif name in ("image_list", "path_imglist"):
            self.list_path = val
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
        elif name == "round_batch":
            self.round_batch = int(val)
        elif name == "decode_threads":
            self.nthread = int(val)
        elif name == "silent":
            self.silent = int(val)
        else:
            self.aug.set_param(name, val)

    def __init__(self, cfg):
        self.rec_path = ""
        self.list_path = ""
        self.batch_size = 128
        self.input_shape = None
        self.shuffle = 0
        self.seed = 0
        self.label_width = 1
        self.round_batch = 0
        self.nthread = min(8, os.cpu_count() or 4)
        self.silent = 0
        self.aug = AugmentParams()
        self._pool = None
        super().__init__(cfg)
        for env, one in (("CXXNET_NUM_WORKER", "1"),
                         ("CXXNET_WORKER_RANK", "0"), ("PS_RANK", "0")):
            if os.environ.get(env, one).strip() != one:
                raise ConfigError(f"{env} = {os.environ[env]}: sharded "
                                  f"reading is not in the PyTorch port yet "
                                  f"({A2})")

    # -- setup -------------------------------------------------------------
    def init(self):
        if not self.rec_path:
            raise ValueError("imgrec: image_rec must be set")
        if self.input_shape is None:
            raise ValueError("imgrec: input_shape must be set")
        if self.nthread < 1:
            raise ValueError(f"decode_threads must be >= 1, got "
                             f"{self.nthread}")
        c, y, x = self.input_shape
        self.augmenter = ImageAugmenter(self.aug, (c, y, x))
        self.mean = MeanStore(mean_cache_path(self.aug), (y, x, c))
        self._label_map = None
        if self.list_path:
            self._label_map = {idx: lab for idx, lab, _
                               in read_image_list(self.list_path)}
        if self.aug.device_normalize == -1:
            # uint8 batches where that is exact: crop and mirror only,
            # encoded records, images at least the crop (the probe reads
            # the first 8 records of the file)
            exact = (not self.aug.needs_affine
                     and self.aug.max_random_contrast == 0
                     and self.aug.max_random_illumination == 0)
            if exact:
                for rec in self._peek_records(8):
                    if rec.flag != 0:
                        exact = False
                        break
                    img = self._decode(rec)
                    if img.shape[0] < y or img.shape[1] < x:
                        exact = False
                        break
            self.aug.device_normalize = int(exact)
            if not self.silent:
                print(f"imgrec: device_normalize auto-resolved to "
                      f"{self.aug.device_normalize} "
                      f"({'uint8 device path' if exact else 'host float path'})",
                      flush=True)
        self._pool = futures.ThreadPoolExecutor(self.nthread)
        self._rng = np.random.RandomState(self.seed)
        # the per-item augmentation counter, hashed into each item's seed
        self._item_counter = self.seed << 32
        if self.aug.mean_img and not self.mean.ready:
            self._compute_mean()
        self.before_first()

    def _peek_records(self, n: int) -> List[ImageRecord]:
        """The first ``n`` records of the file (fewer for a short one)."""
        return self._head(n, ImageRecord.unpack)

    def _head(self, n: int, fn=lambda p: p) -> list:
        reader = RecordReader(self.rec_path)
        out = []
        try:
            for payload in reader:
                out.append(fn(payload))
                if len(out) >= n:
                    break
        finally:
            reader.close()
        return out

    def _compute_mean(self):
        if not self.silent:
            print(f"computing mean image from {self.rec_path} ...",
                  flush=True)
        rng = np.random.RandomState(0)

        def gen():
            reader = RecordReader(self.rec_path)
            try:
                for payload in reader:
                    rec = ImageRecord.unpack(payload)
                    yield self.augmenter.process(self._decode(rec), rng)
            finally:
                reader.close()
        self.mean.compute(gen())

    def _decode(self, rec: ImageRecord) -> np.ndarray:
        c, y, x = self.input_shape
        if rec.flag == 1:    # a raw float32 tensor record
            return np.frombuffer(rec.data, np.float32).reshape(y, x, c)
        return decode_image(rec.data, c)

    # -- iteration ---------------------------------------------------------
    def before_first(self):
        self._close_reader()
        self._reader = RecordReader(self.rec_path)
        self._iter = iter(self._reader)
        self._buf: List = []
        self._done = False

    def _close_reader(self):
        reader = getattr(self, "_reader", None)
        if reader is not None:
            reader.close()
            self._reader = None

    def _process_one(self, payload: bytes, item_counter: int):
        rec = ImageRecord.unpack(payload)
        rng = np.random.Generator(np.random.PCG64(hash_seed(item_counter)))
        if self.aug.device_normalize:
            # the mean, divideby and scale are the trainer's, on the card
            decoded = self._decode(rec)
            img = self.augmenter.process_u8(decoded, rng)
            if img is None:
                img = self.augmenter.process(decoded, rng)
                img = np.clip(np.rint(img), 0.0, 255.0).astype(np.uint8)
        else:
            img = self.augmenter.process(self._decode(rec), rng)
            img = self.mean.apply(img, self.aug)
        if self._label_map is not None and rec.inst_id in self._label_map:
            lab = self._label_map[rec.inst_id]
        else:
            lab = rec.labels
        return img, pack_label(lab, self.label_width), rec.inst_id

    def _decode_raw(self, raw):
        """Decode packed payloads on the pool, each with the seed of its
        place in the stream."""
        seeds = range(self._item_counter, self._item_counter + len(raw))
        self._item_counter += len(raw)
        return list(self._pool.map(self._process_one, raw, seeds))

    def _fill(self, n: int) -> None:
        raw = []
        for payload in self._iter:
            raw.append(payload)
            if len(raw) >= n:
                break
        if len(raw) < n:
            self._done = True
        if self.shuffle:
            self._rng.shuffle(raw)
        self._buf.extend(self._decode_raw(raw))

    def next(self) -> Optional[DataBatch]:
        bs = self.batch_size
        if not self._done and len(self._buf) < bs:
            self._fill(bs * 4)          # a few batches ahead, for shuffle
        if not self._buf:
            return None
        take = self._buf[:bs]
        self._buf = self._buf[bs:]
        padd = 0
        if len(take) < bs:
            padd = bs - len(take)
            if self.round_batch:
                take = take + self._decode_raw(self._head(padd))
            if len(take) < bs:          # a file shorter than the shortfall
                take = take + [take[-1]] * (bs - len(take))
        data = np.stack([t[0] for t in take])
        label = np.stack([t[1] for t in take])
        index = np.asarray([t[2] for t in take], np.int64)
        norm = None
        if self.aug.device_normalize:
            # the host path's precedence and order (MeanStore.apply):
            # mean_value over the mean image, then divideby, then scale
            mean = (self.aug.mean_value if self.aug.mean_value is not None
                    else (self.mean.mean if self.mean.ready else None))
            norm = {"mean": mean, "divideby": self.aug.divideby,
                    "scale": self.aug.scale}
        return DataBatch(data=data, label=label, num_batch_padd=padd,
                         inst_index=index, norm=norm)

    def close(self):
        """Shut the decode pool down and close the record file."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
        self._close_reader()
