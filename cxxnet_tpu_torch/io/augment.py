"""Image augmentation of one decoded image, and the mean image (the port
of ``cxxnet_tpu/io/augment.py``).

:class:`AugmentParams` reads every augmentation key of the JAX package,
and :class:`ImageAugmenter` runs them in its order and with its draws:
the affine warp (rotation by ``max_rotate_angle``, ``rotate`` or
``rotate_list``, shear, aspect ratio, crop-size jitter or random scale,
bounded by ``min/max_img_size``, ``fill_value`` past the edge), the crop
(random, center or fixed start; an image smaller than the crop is first
upscaled), the mirror (random or fixed), random contrast and
illumination; :class:`MeanStore` applies the mean (a ``mean_value`` per
channel or a mean image) with ``divideby`` and ``scale``. The same rng
gives the JAX package's pixels: bit-equal without the warp and the
upscale, and within 2e-3 of its cv2 with them. The uint8 path
(:meth:`ImageAugmenter.process_u8`) crops and mirrors without leaving
uint8, for ``device_normalize``.

The warp and the upscale are ``native/warp.cc`` (built with ``g++`` at
first use, run with the GIL released): the bilinear ``warpAffine`` and
``resize`` that the JAX package asks cv2 for. Their plain versions,
:func:`warp_affine_plain` and :func:`resize_linear_plain`, do the same
float operations in numpy; the tests hold the two together.

The mean image is a ``.npy`` file that both packages read and write, or
a Caffe ``.binaryproto`` (BGR, CHW), which is read by the port's own
protobuf wire reader, flipped to RGB and center-cropped to the input.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Iterator, Optional, Sequence, Tuple, Union

import numpy as np

from . import stream

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


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    out = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def _iter_fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """(field number, wire type, value) of each field of one protobuf
    message's bytes (the port's copy of the JAX package's minimal wire
    reader)."""
    pos, n = 0, len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wt = key >> 3, key & 7
        if wt == 0:
            val, pos = _read_varint(buf, pos)
        elif wt == 1:
            val, pos = buf[pos:pos + 8], pos + 8
        elif wt == 2:
            ln, pos = _read_varint(buf, pos)
            val, pos = buf[pos:pos + ln], pos + ln
        elif wt == 5:
            val, pos = buf[pos:pos + 4], pos + 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wt}")
        yield field, wt, val


def load_binaryproto_mean(data: bytes, rgb_flip: bool = True) -> np.ndarray:
    """A Caffe ``mean.binaryproto`` (a serialized BlobProto) -> (H, W, C)
    float32 mean image. BlobProto fields: legacy dims num = 1,
    channels = 2, height = 3, width = 4; ``data`` (repeated float, field
    5, packed or not); ``shape`` (field 7, BlobShape{repeated int64 dim =
    1}). Caffe blobs are NCHW in BGR order; ``rgb_flip`` reverses the
    channels to the pipeline's RGB."""
    legacy = {1: 0, 2: 0, 3: 0, 4: 0}
    shape: list = []
    chunks: list = []
    for field, wt, val in _iter_fields(data):
        if wt == 0 and field in legacy:
            legacy[field] = val
        elif field == 5 and wt in (2, 5):       # packed, or one float
            chunks.append(np.frombuffer(val, "<f4"))
        elif field == 7 and wt == 2:            # BlobShape
            for f2, wt2, v2 in _iter_fields(val):
                if f2 != 1:
                    continue
                if wt2 == 0:
                    shape.append(v2)
                elif wt2 == 2:                  # packed dims
                    p = 0
                    while p < len(v2):
                        d, p = _read_varint(v2, p)
                        shape.append(d)
    arr = (np.concatenate(chunks) if chunks
           else np.zeros((0,), np.float32))
    if not shape:
        shape = [d for d in (legacy[1], legacy[2], legacy[3], legacy[4])
                 if d]
    if not shape or int(np.prod(shape)) != arr.size:
        raise ValueError(
            f"binaryproto: shape {shape} does not match {arr.size} floats")
    arr = arr.reshape(shape)
    while arr.ndim > 3 and arr.shape[0] == 1:   # (1, C, H, W) -> (C, H, W)
        arr = arr[0]
    if arr.ndim != 3:
        raise ValueError(f"binaryproto: expected a CHW mean, got "
                         f"{arr.shape}")
    arr = np.transpose(arr, (1, 2, 0))
    if rgb_flip and arr.shape[-1] == 3:
        arr = arr[:, :, ::-1]
    return np.ascontiguousarray(arr, np.float32)


def center_crop_mean(mean: np.ndarray,
                     shape_hwc: Tuple[int, int, int]) -> np.ndarray:
    """A mean computed at the resize size (say 256x256), center-cropped
    to the input (say 224x224), as Caffe's deploy does."""
    h, w, c = shape_hwc
    mh, mw = mean.shape[:2]
    if (mh, mw) == (h, w):
        return mean
    if mh < h or mw < w or mean.shape[2] != c:
        raise ValueError(
            f"mean image {mean.shape} incompatible with input "
            f"({h}, {w}, {c}); it must be at least the crop size")
    y0, x0 = (mh - h) // 2, (mw - w) // 2
    return np.ascontiguousarray(mean[y0:y0 + h, x0:x0 + w])


# -- the warp and the resize ----------------------------------------------------

def invert_affine(m: np.ndarray) -> np.ndarray:
    """The inverse of a forward 2x3 matrix, in float64, as OpenCV's
    ``invertAffineTransform`` computes it (a singular one inverts to
    zeros)."""
    m = np.asarray(m, np.float64)
    d = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    d = 1.0 / d if d != 0.0 else 0.0
    a11, a22, a12, a21 = m[1, 1] * d, m[0, 0] * d, -m[0, 1] * d, -m[1, 0] * d
    return np.array([[a11, a12, -a11 * m[0, 2] - a12 * m[1, 2]],
                     [a21, a22, -a21 * m[0, 2] - a22 * m[1, 2]]])


def warp_affine_plain(img: np.ndarray, m: np.ndarray, out_hw, fill: float
                      ) -> np.ndarray:
    """The plain version of ``warp.cc``'s affine warp: (h, w, c) float32
    -> (oh, ow, c), each output pixel the bilinear sample at the inverse
    map of its coordinates, taken in float32 (``fill`` past the
    edge)."""
    f32 = np.float32
    h, w, c = img.shape
    oh, ow = out_hw
    mf = invert_affine(m).astype(f32)
    ys = np.arange(oh, dtype=f32)[:, None]
    xs = np.arange(ow, dtype=f32)[None, :]
    sx = mf[0, 0] * xs + (mf[0, 1] * ys + mf[0, 2])
    sy = mf[1, 0] * xs + (mf[1, 1] * ys + mf[1, 2])
    x0f, y0f = np.floor(sx), np.floor(sy)
    ax, ay = (sx - x0f)[..., None], (sy - y0f)[..., None]
    x0 = np.clip(x0f, -2, w + 1).astype(np.int64)
    y0 = np.clip(y0f, -2, h + 1).astype(np.int64)
    src = np.asarray(img, f32)
    fill = f32(fill)

    def tap(yi, xi):
        ok = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        v = src[np.clip(yi, 0, h - 1), np.clip(xi, 0, w - 1)]
        return np.where(ok[..., None], v, fill)
    one = f32(1)
    bx1, by1 = one - ax, one - ay
    out = (by1 * (bx1 * tap(y0, x0) + ax * tap(y0, x0 + 1))
           + ay * (bx1 * tap(y0 + 1, x0) + ax * tap(y0 + 1, x0 + 1)))
    return out.astype(f32)


def _linear_taps(n_in: int, n_out: int):
    scale = 1.0 / (n_out / n_in)
    f = ((np.arange(n_out) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    a = f - s.astype(np.float32)
    a = np.where(s < 0, np.float32(0), a)
    s = np.maximum(s, 0)
    hi = s >= n_in - 1
    a = np.where(hi, np.float32(0), a).astype(np.float32)
    s = np.where(hi, n_in - 1, s)
    return s, np.minimum(s + 1, n_in - 1), a


def resize_linear_plain(img: np.ndarray, out_hw) -> np.ndarray:
    """The plain version of ``warp.cc``'s resize: (h, w, c) float32 ->
    (oh, ow, c), half-pixel centres, the edge clamped, a horizontal
    then a vertical pass in float32."""
    h, w, _ = img.shape
    oh, ow = out_hw
    x0, x1, ax = _linear_taps(w, ow)
    y0, y1, ay = _linear_taps(h, oh)
    src = np.asarray(img, np.float32)
    a1 = ax[None, :, None]
    a0 = np.float32(1) - a1

    def hpass(rows):
        return rows[:, x0] * a0 + rows[:, x1] * a1
    r0, r1 = hpass(src[y0]), hpass(src[y1])
    b1 = ay[:, None, None]
    return (r0 * (np.float32(1) - b1) + r1 * b1).astype(np.float32)


_warp_lock = threading.Lock()
_warp_lib = None


def _warp():
    """The warp library, built and loaded at first use."""
    global _warp_lib
    with _warp_lock:
        if _warp_lib is None:
            from ..ops import _build
            lib = _build.load_host("warp.cc")
            fp = ctypes.c_void_p
            ci = ctypes.c_int
            lib.cxn_warp_affine.restype = ci
            lib.cxn_warp_affine.argtypes = [fp, ci, ci, ci, fp, ci, ci, fp,
                                            ctypes.c_float]
            lib.cxn_resize_linear.restype = ci
            lib.cxn_resize_linear.argtypes = [fp, ci, ci, ci, fp, ci, ci]
            _warp_lib = lib
        return _warp_lib


def _f32_hwc(img: np.ndarray) -> np.ndarray:
    img = np.ascontiguousarray(img, np.float32)
    if img.ndim != 3:
        raise ValueError(f"expected an (h, w, c) image, got {img.shape}")
    return img


def warp_affine(img: np.ndarray, m: np.ndarray, out_hw, fill: float
                ) -> np.ndarray:
    """(h, w, c) float32 warped by the forward 2x3 matrix ``m`` into
    (oh, ow, c) through ``warp.cc`` (see :func:`warp_affine_plain`)."""
    img = _f32_hwc(img)
    h, w, c = img.shape
    oh, ow = int(out_hw[0]), int(out_hw[1])
    out = np.empty((oh, ow, c), np.float32)
    mm = np.ascontiguousarray(m, np.float64).reshape(6)
    rc = _warp().cxn_warp_affine(img.ctypes.data, h, w, c, out.ctypes.data,
                                 oh, ow, mm.ctypes.data, float(fill))
    if rc != 0:
        raise ValueError(f"warp_affine: bad shape {img.shape} -> {out_hw}")
    return out


def resize_linear(img: np.ndarray, out_hw) -> np.ndarray:
    """(h, w, c) float32 resized to (oh, ow, c) through ``warp.cc`` (see
    :func:`resize_linear_plain`)."""
    img = _f32_hwc(img)
    h, w, c = img.shape
    oh, ow = int(out_hw[0]), int(out_hw[1])
    out = np.empty((oh, ow, c), np.float32)
    rc = _warp().cxn_resize_linear(img.ctypes.data, h, w, c,
                                   out.ctypes.data, oh, ow)
    if rc != 0:
        raise ValueError(f"resize_linear: bad shape {img.shape} -> {out_hw}")
    return out


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

    def affine_matrix(self, h: int, w: int, rng: RngLike) -> np.ndarray:
        """The forward 2x3 float32 matrix of the warp of an (h, w) image,
        from the JAX package's draws in its order: the angle, the aspect
        ratio, the shear, then the crop size or the random scale."""
        p = self.p
        if p.rotate_list:
            angle = float(p.rotate_list[_ri(rng, len(p.rotate_list))])
        elif p.rotate >= 0:
            angle = float(p.rotate)
        else:
            angle = rng.uniform(-p.max_rotate_angle, p.max_rotate_angle)
        a = angle * np.pi / 180.0
        ratio = 1.0 + rng.uniform(-p.max_aspect_ratio, p.max_aspect_ratio) \
            if p.max_aspect_ratio > 0 else 1.0
        shear = rng.uniform(-p.max_shear_ratio, p.max_shear_ratio) \
            if p.max_shear_ratio > 0 else 0.0
        if p.min_crop_size > 0 and p.max_crop_size + 1 > p.min_crop_size:
            crop = _ri(rng, p.min_crop_size, p.max_crop_size + 1)
            scale = float(self.out_y) / crop
        else:
            scale = rng.uniform(p.min_random_scale, p.max_random_scale)
        # the size bound acts on the content scale: the warp renders
        # straight into the output crop
        hscale = np.clip(scale * h, p.min_img_size, p.max_img_size) / h
        wscale = np.clip(scale * w, p.min_img_size, p.max_img_size) / w
        hs, ws = hscale * ratio, wscale / max(ratio, 1e-8)
        cos_a, sin_a = np.cos(a), np.sin(a)
        m = np.array([[cos_a * ws, (sin_a + shear) * hs, 0.0],
                      [-sin_a * ws, (cos_a + shear) * hs, 0.0]], np.float32)
        m[0, 2] = self.out_x / 2.0 - (m[0, 0] * w / 2.0 + m[0, 1] * h / 2.0)
        m[1, 2] = self.out_y / 2.0 - (m[1, 0] * w / 2.0 + m[1, 1] * h / 2.0)
        return m

    def _affine(self, img: np.ndarray, rng: RngLike) -> np.ndarray:
        """The warp into (out_y, out_x) by :meth:`affine_matrix`."""
        m = self.affine_matrix(img.shape[0], img.shape[1], rng)
        return warp_affine(img, m, (self.out_y, self.out_x),
                           self.p.fill_value)

    def _crop(self, img: np.ndarray, rng: RngLike) -> np.ndarray:
        """Random, fixed-start or center crop to (out_y, out_x)."""
        h, w = img.shape[:2]
        oy, ox = self.out_y, self.out_x
        if h == oy and w == ox:
            return img
        if h < oy or w < ox:     # upscale to cover the crop
            s = max(oy / h, ox / w)
            img = resize_linear(img, (max(oy, int(h * s + 0.5)),
                                      max(ox, int(w * s + 0.5))))
            h, w = img.shape[:2]
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
    """The mean image: loaded from its ``.npy`` (or Caffe
    ``.binaryproto``) file when it exists, else computed on first use
    (:meth:`compute`) and written there."""

    def __init__(self, path: str, shape_hwc: Tuple[int, int, int]):
        self.path = path
        self.shape = shape_hwc
        self.mean: Optional[np.ndarray] = None
        if path and stream.exists(path):
            if path.endswith(".binaryproto"):
                with stream.sopen(path, "rb") as f:
                    mean = load_binaryproto_mean(f.read())
                self.mean = center_crop_mean(mean, shape_hwc)
            else:
                with stream.sopen(path, "rb") as f:
                    self.mean = np.load(f)

    @property
    def ready(self) -> bool:
        return self.mean is not None

    def compute(self, images) -> None:
        """The mean of ``images``, (out_y, out_x, c) float arrays,
        summed in float64; written to the path when there is one. A
        ``.binaryproto`` mean is imported, never computed: a missing one
        raises."""
        if self.path.endswith(".binaryproto"):
            raise ValueError(
                f"mean file {self.path!r} not found; .binaryproto means "
                "are imported, never computed: point image_mean at an "
                "existing one or at a .npy path")
        acc = np.zeros(self.shape, np.float64)
        n = 0
        for im in images:
            acc += im
            n += 1
        self.mean = (acc / max(n, 1)).astype(np.float32)
        if self.path:
            with stream.sopen(self.path, "wb") as f:
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
