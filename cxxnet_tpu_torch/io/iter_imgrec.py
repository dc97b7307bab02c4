"""The image record iterator (the port of ``cxxnet_tpu/io/iter_imgrec.py``).

Registered as ``imgrec`` and, as in the JAX package, ``imgbin``,
``imgbinx``, ``imginst`` and ``imgbinold``. It reads a record file
(``image_rec``), a BinaryPage pack (``image_bin``, its labels by line
from ``image_list``) or a set of packs (``image_conf_prefix`` with
``image_conf_ids``: each id of the range ``lb-ub`` formats the prefix
into ``<name>.bin`` / ``<name>.lst``), decodes each record on a pool of ``decode_threads``
threads (:mod:`.decode`), augments it (:mod:`.augment`) and batches the
results; labels come from the records or, by instance id, from an
``image_list``. JPEG records decode through nvJPEG on the card that
``dev`` names (the rank's own under dp) and through libjpeg with ``dev =
cpu``; PNG records through ``png.cc`` either way. With ``shuffle`` the records are shuffled four batches
at a time by ``RandomState(seed_data)``; ``round_batch`` fills the
epoch's last batch from the start of the file, marked as padding.

Its batches are bit-equal to the JAX iterator's over the same file:
each item draws its augmentation from ``Generator(PCG64(hash(counter)))``
of a per-item counter, so the thread schedule changes nothing; the mean
image is computed on first use with ``RandomState(0)`` and written as a
``.npy`` file.

``device_normalize`` (``-1`` = auto) decides where the mean, ``divideby``
and ``scale`` are applied. Auto resolves to 1 when the augmentations keep
pixels exact (crop and mirror only, no affine warp) and the first records
of the file are encoded images at least as large as the crop; then batches are
uint8 and ``DataBatch.norm`` carries the normalization for the trainer
to apply on the card (the uint8 input fold). Otherwise the batches are
normalized float32, as the JAX package's host path makes them.

Sharded reading, as in the JAX package: ``dist_num_worker`` /
``dist_worker_rank`` (defaults from ``CXXNET_NUM_WORKER`` and
``CXXNET_WORKER_RANK`` or ``PS_RANK``) give worker ``rank`` the records
that start in the byte range ``[rank * size / n, (rank + 1) * size /
n)`` of a record file, the pages ``rank, rank + n, ...`` of a pack, or
its contiguous share of a pack set's files; the rank enters the shuffle
seed (``seed_data + 7 * rank``) and the augmentation counter. With
``round_batch`` every rank must emit the same number of batches, and
``init`` raises where the shards' record counts cannot give that. Files
are read through the stream layer (local paths or ``scheme://`` URLs).
"""

from __future__ import annotations

import concurrent.futures as futures
import os
import re
from typing import List, Optional

import numpy as np

from .augment import (AugmentParams, ImageAugmenter, MeanStore,
                      mean_cache_path, pack_label)
from .data import DataBatch, DataIter, register_iter
from .decode import decode_image, jpeg_device
from .recordio import (ImageRecord, RecordReader, read_image_list,
                       shard_record_counts)


def hash_seed(counter: int) -> int:
    """splitmix64 mix of a counter: the seed of one item's rng."""
    z = (counter + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return z ^ (z >> 31)


def expand_conf_files(prefix: str, ids: str, rank: int, nworker: int):
    """This worker's (bin, lst) file pairs of ``image_conf_prefix`` /
    ``image_conf_ids``: the ids are an inclusive range ``lb-ub``, each
    formats the printf-style prefix, and the workers take contiguous
    chunks of ceil(n / nworker) files."""
    m = re.match(r"^(-?\d+)-(-?\d+)$", ids.strip())
    if not m:
        raise ValueError(
            f"image_conf_ids only supports a range like 1-100, got {ids!r}")
    lb, ub = int(m.group(1)), int(m.group(2))
    n = ub + 1 - lb
    if n <= 0:
        raise ValueError(f"image_conf_ids: empty range {ids!r}")
    try:
        all_names = [prefix % i for i in range(lb, ub + 1)]
    except (TypeError, ValueError) as e:
        raise ValueError(
            f"image_conf_prefix must contain a printf-style integer "
            f"placeholder (e.g. 'part%03d'), got {prefix!r}: {e}") from e
    if n > 1 and len(set(all_names)) != len(all_names):
        raise ValueError(
            f"image_conf_prefix {prefix!r} does not vary with "
            "image_conf_ids — missing a %d placeholder?")
    if nworker > 1:
        step = (n + nworker - 1) // nworker
        begin = min(rank * step, n)
        end = min((rank + 1) * step, n)
        if begin >= end:
            raise ValueError(
                "image_conf: too many workers — the id list cannot be "
                "divided between them")
        all_names = all_names[begin:end]
    return [(name + ".bin", name + ".lst") for name in all_names]


@register_iter("imgrec", "imgbin", "imgbinx", "imginst", "imgbinold")
class ImageRecordIterator(DataIter):
    """Batched, augmented image-record reader (see the module docstring)."""

    supports_dist_shard = True

    def set_param(self, name, val):
        if name in ("image_rec", "path_imgrec"):
            self.rec_path = val
        elif name in ("image_bin", "path_imgbin"):
            self.bin_path = val
        elif name in ("image_list", "path_imglist"):
            self.list_path = val
        elif name == "image_conf_prefix":
            self.conf_prefix = val
        elif name == "image_conf_ids":
            self.conf_ids = val
        elif name == "dist_num_worker":
            self.nworker = int(val)
        elif name == "dist_worker_rank":
            self.rank = int(val)
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
        elif name == "dev":
            self.dev = val
        else:
            self.aug.set_param(name, val)

    def __init__(self, cfg):
        self.dev = ""
        self.rec_path = ""
        self.bin_path = ""
        self.list_path = ""
        self.conf_prefix = ""
        self.conf_ids = ""
        self.batch_size = 128
        self.input_shape = None
        self.shuffle = 0
        self.seed = 0
        self.label_width = 1
        self.round_batch = 0
        self.nworker = int(os.environ.get("CXXNET_NUM_WORKER", "1"))
        self.rank = int(os.environ.get("CXXNET_WORKER_RANK",
                                       os.environ.get("PS_RANK", "0")))
        self.nthread = min(8, os.cpu_count() or 4)
        self.silent = 0
        self.aug = AugmentParams()
        self._pool = None
        self._reader = None
        super().__init__(cfg)

    # -- setup -------------------------------------------------------------
    def init(self):
        if self.conf_prefix:
            if self.rec_path or self.bin_path or self.list_path:
                raise ValueError(
                    "set either image_conf_prefix or image_bin/image_list, "
                    "not both")
            self._conf_pairs = expand_conf_files(
                self.conf_prefix, self.conf_ids, self.rank, self.nworker)
            if self.round_batch and self.nworker > 1:
                self._check_conf_batch_counts()
        elif not self.rec_path and not self.bin_path:
            raise ValueError("imgrec: image_rec (or image_bin) must be set")
        elif self.round_batch and self.nworker > 1:
            self._check_shard_batch_counts()
        if self.bin_path and not self.list_path:
            raise ValueError("imgbin: image_list must accompany image_bin "
                             "(labels live in the list)")
        if self.input_shape is None:
            raise ValueError("imgrec: input_shape must be set")
        if self.nthread < 1:
            raise ValueError(f"decode_threads must be >= 1, got "
                             f"{self.nthread}")
        c, y, x = self.input_shape
        self._jpeg_device = jpeg_device(self.dev)
        self.augmenter = ImageAugmenter(self.aug, (c, y, x))
        self.mean = MeanStore(mean_cache_path(self.aug), (y, x, c))
        self._label_map = None
        self._list_entries = None
        if self.list_path:
            self._list_entries = read_image_list(self.list_path)
            self._label_map = {idx: lab for idx, lab, _
                               in self._list_entries}
        if self.aug.device_normalize == -1:
            # uint8 batches where that is exact: crop and mirror only,
            # encoded records, images at least the crop (the probe reads
            # the first 8 records of the shard)
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
        self._rng = np.random.RandomState(self.seed + 7 * self.rank)
        # the per-item augmentation counter, hashed into each item's seed
        self._item_counter = (self.seed << 32) ^ (self.rank << 56)
        if self.aug.mean_img and not self.mean.ready:
            self._compute_mean()
        self.before_first()

    def _check_conf_batch_counts(self) -> None:
        """Under round_batch every rank must emit the same number of
        batches; whole-file shards of a pack set may not allow that."""
        counts = []
        for rank in range(self.nworker):
            pairs = expand_conf_files(self.conf_prefix, self.conf_ids,
                                      rank, self.nworker)
            n = sum(len(read_image_list(lst)) for _, lst in pairs)
            counts.append(-(-n // self.batch_size))
        if len(set(counts)) != 1:
            raise ValueError(
                "image_conf_prefix + round_batch: per-rank batch counts "
                f"{counts} are unequal — whole-file sharding cannot give "
                "every worker the same epoch length with these pack sizes; "
                "re-pack into equal-size parts (tools/im2bin.py) or use a "
                "single recordio file (byte-range sharded)")

    def _check_shard_batch_counts(self) -> None:
        """Under round_batch every rank must emit the same number of
        batches: counted from the record headers (or the ``.idx``) or
        the pages' headers, never the payloads."""
        if self.bin_path:
            from .binpage import num_pages, page_object_count
            per_page = [page_object_count(self.bin_path, p)
                        for p in range(num_pages(self.bin_path))]
            recs = [sum(per_page[r::self.nworker])
                    for r in range(self.nworker)]
        else:
            recs = shard_record_counts(self.rec_path, self.nworker)
        counts = [-(-n // self.batch_size) for n in recs]
        if len(set(counts)) != 1:
            raise ValueError(
                f"round_batch with {self.nworker} workers: per-rank batch "
                f"counts {counts} (record counts {recs}) are unequal — "
                "every rank must emit the same epoch length or distributed "
                "training deadlocks; re-pack with tools/im2rec.py "
                "(uniform record sizes shard evenly) or adjust batch_size")

    def _open_reader(self):
        """An iterable of this worker's packed record payloads: its byte
        range of the record file, its pages of a pack (the k-th object
        with the k-th list line's id and labels), or its files of a pack
        set. Closed by :meth:`_close`."""
        if not self.conf_prefix and not self.bin_path:
            return RecordReader(self.rec_path, self.rank, self.nworker)
        from .binpage import iter_binpage
        if self.conf_prefix:
            def gen():
                for bin_path, lst_path in self._conf_pairs:
                    entries = read_image_list(lst_path)
                    for obj_idx, data in iter_binpage(bin_path, 0, 1):
                        inst_id, labels, _ = entries[obj_idx]
                        yield ImageRecord(inst_id=inst_id, labels=labels,
                                          data=data).pack()
            return gen()
        entries = self._list_entries

        def gen_one():
            for obj_idx, data in iter_binpage(self.bin_path, self.rank,
                                              self.nworker):
                inst_id, labels, _ = entries[obj_idx]
                yield ImageRecord(inst_id=inst_id, labels=labels,
                                  data=data).pack()
        return gen_one()

    @staticmethod
    def _close(reader) -> None:
        close = getattr(reader, "close", None)
        if close is not None:
            close()

    def _peek_records(self, n: int) -> List[ImageRecord]:
        """The first ``n`` records of the shard (fewer for a short one)."""
        return self._head(n, ImageRecord.unpack)

    def _head(self, n: int, fn=lambda p: p) -> list:
        reader = self._open_reader()
        out = []
        try:
            for payload in reader:
                out.append(fn(payload))
                if len(out) >= n:
                    break
        finally:
            self._close(reader)
        return out

    def _compute_mean(self):
        if not self.silent:
            print(f"computing mean image from "
                  f"{self.rec_path or self.bin_path or self.conf_prefix} "
                  "...", flush=True)
        rng = np.random.RandomState(0)

        def gen():
            reader = self._open_reader()
            try:
                for payload in reader:
                    rec = ImageRecord.unpack(payload)
                    yield self.augmenter.process(self._decode(rec), rng)
            finally:
                self._close(reader)
        self.mean.compute(gen())

    def _decode(self, rec: ImageRecord) -> np.ndarray:
        c, y, x = self.input_shape
        if rec.flag == 1:    # a raw float32 tensor record
            return np.frombuffer(rec.data, np.float32).reshape(y, x, c)
        return decode_image(rec.data, c, self._jpeg_device)

    # -- iteration ---------------------------------------------------------
    def before_first(self):
        self._close_reader()
        self._reader = self._open_reader()
        self._iter = iter(self._reader)
        self._buf: List = []
        self._done = False

    def _close_reader(self):
        if self._reader is not None:
            self._close(self._reader)
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
