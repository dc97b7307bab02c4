"""Image augmentation of one decoded image, and the mean image (the port
of ``cxxnet_tpu/io/augment.py``).

:class:`AugmentParams` reads every augmentation key of the JAX package.
The port runs the crop (random, center or fixed start), the mirror
(random or fixed), random contrast and illumination, the mean (a
``mean_value`` per channel or a mean image) with ``divideby`` and
``scale``, in the JAX package's order and with its draws: the same rng
gives the same pixels. The uint8 path (:meth:`ImageAugmenter.process_u8`)
crops and mirrors without leaving uint8, for ``device_normalize``.

Not ported (they need cv2, or a protobuf reader), each raising naming
ROADMAP Queue A 2: the affine path (rotation, shear, aspect ratio,
random scale, crop-size jitter, image-size bounds), the upscale of an
image smaller than the crop, and ``.binaryproto`` (Caffe) means. The
mean image is a ``.npy`` file that both packages read and write.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple, Union

import numpy as np

from .data import A2, check_local

RngLike = Union[np.random.Generator, np.random.RandomState]


class AugmentParams:
    """Parsed augmentation settings; names match the config keys."""

    def __init__(self) -> None:
        self.rand_crop = 0
        self.rand_mirror = 0
        self.mirror = 0
        self.crop_y_start = -1
        self.crop_x_start = -1
        self.max_rotate_angle = 0.0
        self.max_aspect_ratio = 0.0
        self.max_shear_ratio = 0.0
        self.min_crop_size = -1
        self.max_crop_size = -1
        self.min_random_scale = 1.0
        self.max_random_scale = 1.0
        self.min_img_size = 0.0
        self.max_img_size = 1e10
        self.rotate = -1
        self.rotate_list: Sequence[int] = ()
        self.fill_value = 255
        self.max_random_contrast = 0.0
        self.max_random_illumination = 0.0
        self.mean_value: Optional[np.ndarray] = None    # (3,) RGB
        self.mean_img: str = ""
        self.divideby = 1.0
        # -1 = auto: imgrec resolves it to 1 when the augmentations keep
        # uint8 pixels exact and the records hold encoded images
        self.device_normalize = -1
        self.scale = 1.0

    def set_param(self, name: str, val: str) -> bool:
        if name in ("rand_crop", "rand_mirror", "mirror", "crop_y_start",
                    "crop_x_start", "min_crop_size", "max_crop_size",
                    "rotate", "fill_value", "device_normalize"):
            setattr(self, name, int(val))
        elif name in ("max_rotate_angle", "max_aspect_ratio",
                      "max_shear_ratio", "min_random_scale",
                      "max_random_scale", "min_img_size", "max_img_size",
                      "max_random_contrast", "max_random_illumination",
                      "divideby", "scale"):
            setattr(self, name, float(val))
        elif name == "rotate_list":
            self.rotate_list = [int(x) for x in val.split(",") if x]
        elif name == "image_mean":
            self.mean_img = val
        elif name == "mean_value":
            self.mean_value = np.asarray(
                [float(x) for x in val.split(",")], np.float32)
        else:
            return False
        return True

    @property
    def needs_affine(self) -> bool:
        return (self.max_rotate_angle > 0 or self.max_shear_ratio > 0
                or self.rotate > 0 or len(self.rotate_list) > 0
                or self.max_aspect_ratio > 0
                or self.min_crop_size > 0
                or self.min_random_scale != 1.0
                or self.max_random_scale != 1.0
                or self.min_img_size > 0
                or self.max_img_size < 1e10)


def mean_cache_path(p: AugmentParams) -> str:
    """Path of the cached mean image (``.npy`` appended when absent;
    ``.binaryproto`` paths pass through)."""
    path = p.mean_img
    if path and not path.endswith((".npy", ".binaryproto")):
        path = path + ".npy"
    return path


def pack_label(labels, width: int) -> np.ndarray:
    """Zero-pad or truncate a label vector to ``label_width`` entries."""
    out = np.zeros((width,), np.float32)
    w = min(width, len(labels))
    out[:w] = labels[:w]
    return out


def _ri(rng, *args):
    """randint of either numpy rng API, ``[lo, hi)``."""
    f = getattr(rng, "integers", None)
    return f(*args) if f is not None else rng.randint(*args)


class ImageAugmenter:
    """Crop, mirror and photometric augmentation of one HWC image."""

    def __init__(self, p: AugmentParams, out_shape: Tuple[int, int, int]):
        self.p = p
        self.out_c, self.out_y, self.out_x = out_shape

    def _affine(self, img: np.ndarray, rng: RngLike) -> np.ndarray:
        raise NotImplementedError(
            "affine augmentation (max_rotate_angle, rotate, rotate_list, "
            "max_shear_ratio, max_aspect_ratio, min/max_crop_size, "
            "min/max_random_scale, min/max_img_size) needs cv2, which the "
            f"PyTorch port does not use ({A2})")

    def _crop(self, img: np.ndarray, rng: RngLike) -> np.ndarray:
        """Random, fixed-start or center crop to (out_y, out_x)."""
        h, w = img.shape[:2]
        oy, ox = self.out_y, self.out_x
        if h == oy and w == ox:
            return img
        if h < oy or w < ox:
            raise NotImplementedError(
                f"image {h}x{w} smaller than the crop {oy}x{ox}: the "
                "upscale needs cv2, which the PyTorch port does not use "
                f"({A2})")
        p = self.p
        if p.rand_crop:
            y0 = _ri(rng, 0, h - oy + 1)
            x0 = _ri(rng, 0, w - ox + 1)
        elif p.crop_y_start >= 0 or p.crop_x_start >= 0:
            y0 = max(p.crop_y_start, 0)
            x0 = max(p.crop_x_start, 0)
        else:
            y0, x0 = (h - oy) // 2, (w - ox) // 2
        return img[y0:y0 + oy, x0:x0 + ox]

    def process_u8(self, img: np.ndarray, rng: RngLike):
        """Crop and mirror a uint8 image without leaving uint8, with the
        draws of :meth:`process`; None when the image needs the float
        path (photometric or affine augmentation, non-uint8 input, an
        image smaller than the crop)."""
        if (self.p.needs_affine or self.p.max_random_contrast > 0
                or self.p.max_random_illumination > 0
                or img.dtype != np.uint8):
            return None
        if img.ndim == 2:
            img = img[:, :, None]
        if img.shape[0] < self.out_y or img.shape[1] < self.out_x:
            return None
        cropped = self._crop(img, rng)
        if (self.p.rand_mirror and _ri(rng, 2)) or self.p.mirror:
            cropped = cropped[:, ::-1]
        if img.nbytes > 2 * cropped.nbytes:
            # a view would keep the whole decoded image alive
            return np.ascontiguousarray(cropped)
        return cropped

    def process(self, img: np.ndarray, rng: RngLike) -> np.ndarray:
        """HWC uint8 or float in, (out_y, out_x, C) float32 out, before
        the mean."""
        img = np.asarray(img, np.float32)
        if img.ndim == 2:
            img = img[:, :, None]
        if self.p.needs_affine:
            img = self._affine(img, rng)
        img = self._crop(img, rng)
        if (self.p.rand_mirror and _ri(rng, 2)) or self.p.mirror:
            img = img[:, ::-1]
        p = self.p
        if p.max_random_contrast > 0 or p.max_random_illumination > 0:
            c = 1.0 + rng.uniform(-p.max_random_contrast,
                                  p.max_random_contrast)
            b = rng.uniform(-p.max_random_illumination,
                            p.max_random_illumination)
            img = img * c + b
        return np.ascontiguousarray(img, np.float32)


class MeanStore:
    """The mean image: loaded from its ``.npy`` file when it exists, else
    computed on first use (:meth:`compute`) and written there."""

    def __init__(self, path: str, shape_hwc: Tuple[int, int, int]):
        self.path = path
        self.shape = shape_hwc
        self.mean: Optional[np.ndarray] = None
        if path.endswith(".binaryproto"):
            raise NotImplementedError(
                f"image_mean = {path}: .binaryproto means need the Caffe "
                "import of the JAX package (tools/import_caffe.py --mean "
                f"writes a .npy the port reads) ({A2})")
        if path and os.path.exists(check_local(path)):
            self.mean = np.load(path)

    @property
    def ready(self) -> bool:
        return self.mean is not None

    def compute(self, images) -> None:
        """The mean of ``images``, (out_y, out_x, c) float arrays,
        summed in float64; written to the path when there is one."""
        acc = np.zeros(self.shape, np.float64)
        n = 0
        for im in images:
            acc += im
            n += 1
        self.mean = (acc / max(n, 1)).astype(np.float32)
        if self.path:
            with open(self.path, "wb") as f:
                np.save(f, self.mean)

    def apply(self, img: np.ndarray, p: AugmentParams) -> np.ndarray:
        if p.mean_value is not None:
            img = img - p.mean_value
        elif self.mean is not None:
            img = img - self.mean
        if p.divideby != 1.0:
            img = img * (1.0 / p.divideby)
        if p.scale != 1.0:
            img = img * p.scale
        return img
