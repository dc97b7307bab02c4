"""The port's augmenter against the JAX package's, on the CPU.

* The affine warp and the upscale (``native/warp.cc``) against the JAX
  package's ``ImageAugmenter.process``, which asks cv2 for them, from
  the same seed: rotation (``max_rotate_angle``, ``rotate``,
  ``rotate_list``), shear, aspect, crop-size jitter, random scale,
  ``min/max_img_size``, ``fill_value``, with crop, mirror and the
  photometric draws after them, C = 1 and 3, images smaller than the
  crop: within 2e-3 absolute on 0..255 values. cv2 5.0.0's float warp
  takes the source coordinates in float32, so neither it nor an exact
  double-precision bilinear is the other's (they differ by up to 2.5e-3
  at these sizes); ``warp.cc`` takes them as cv2 does and reads within
  1.8e-3. The draws are the JAX package's: ``affine_matrix`` equals the
  JAX package's matrix bit for bit, and the rng is left where the JAX
  one is.
* ``warp.cc`` against its plain versions (``warp_affine_plain``,
  ``resize_linear_plain``): bit-equal (the same float32 operations in
  the same order), at odd sizes, far outside the image and singular.
* ``.binaryproto`` means: legacy dims and ``shape``, packed and unpacked
  floats and dims, a leading 1 dropped, bit-equal to the JAX package's
  parser; ``MeanStore`` reads one as the JAX package's does
  (BGR -> RGB, center-cropped), and refuses to compute one.
"""

import numpy as np
import pytest

from cxxnet_tpu.io import augment as jaug
from cxxnet_tpu_torch.io import augment as paug

from torch_imgrec_fixture import binaryproto, image

#: affine and upscale cases: (name, keys, out shape (y, x), image sizes)
AFFINE = [
    ("bowl", {"max_rotate_angle": "180", "max_aspect_ratio": "0.5",
              "max_shear_ratio": "0.3", "min_crop_size": "32",
              "max_crop_size": "48", "rand_crop": "1", "rand_mirror": "1"},
     (40, 40), ((48, 48), (37, 53))),
    ("rotate_list_fill", {"rotate_list": "0,90,180,270", "fill_value": "7",
                          "mirror": "1"}, (24, 28), ((30, 30), (21, 35))),
    ("rotate_scale_bounds", {"rotate": "30", "min_random_scale": "0.7",
                             "max_random_scale": "1.3",
                             "min_img_size": "30", "max_img_size": "60"},
     (32, 32), ((48, 40), (25, 60))),
    ("shear_photometric", {"max_shear_ratio": "0.2",
                           "max_random_contrast": "0.2",
                           "max_random_illumination": "10",
                           "fill_value": "0"}, (32, 32), ((40, 40),)),
    ("aspect_only", {"max_aspect_ratio": "0.3", "rand_crop": "1"},
     (20, 20), ((33, 27),)),
    ("upscale", {"rand_crop": "1", "rand_mirror": "1"}, (40, 40),
     ((20, 30), (12, 12), (41, 17))),
    ("upscale_center", {}, (36, 30), ((18, 25),)),
]


def _pair(keys, shape):
    jp, pp = jaug.AugmentParams(), paug.AugmentParams()
    for k, v in keys.items():
        assert jp.set_param(k, v) and pp.set_param(k, v)
    return jaug.ImageAugmenter(jp, shape), paug.ImageAugmenter(pp, shape)


@pytest.mark.parametrize("c", [3, 1])
@pytest.mark.parametrize("name,keys,out,sizes", AFFINE,
                         ids=[a[0] for a in AFFINE])
def test_augment_matches_the_jax_cv2_path(name, keys, out, sizes, c):
    ja, pa = _pair(keys, (c,) + out)
    rng = np.random.RandomState(len(name) * 10 + c)
    for h, w in sizes:
        img = image(rng, h, w, c)
        for seed in range(6):
            jr = np.random.Generator(np.random.PCG64(seed))
            pr = np.random.Generator(np.random.PCG64(seed))
            want = ja.process(img, jr)
            got = pa.process(img, pr)
            assert got.dtype == np.float32 and got.shape == out + (c,)
            # cv2.resize gives (h, w) for one channel: the JAX package's
            # upscaled C = 1 image is 2-D
            np.testing.assert_allclose(got, want.reshape(got.shape),
                                       rtol=0, atol=2e-3)
            assert jr.integers(1 << 30) == pr.integers(1 << 30)
        if pa.p.needs_affine:
            jr, pr = np.random.RandomState(seed), np.random.RandomState(seed)
            assert pa.process_u8(img, pr) is None
            m = pa.affine_matrix(h, w, pr)
            assert m.dtype == np.float32
            # the matrix the JAX package's _affine hands cv2 from the
            # same draws
            jm = _jax_matrix(ja, h, w, jr)
            np.testing.assert_array_equal(m, jm)


def _jax_matrix(ja, h, w, rng):
    """The matrix the JAX package's ``_affine`` hands cv2, captured."""
    import cv2
    seen = {}
    real = cv2.warpAffine

    def spy(img, m, *a, **k):
        seen["m"] = np.array(m)
        return real(img, m, *a, **k)
    cv2.warpAffine = spy
    try:
        ja._affine(np.zeros((h, w, 1), np.float32), rng)
    finally:
        cv2.warpAffine = real
    return seen["m"]


def test_warp_cc_is_bit_equal_to_its_plain_versions():
    rng = np.random.RandomState(7)
    for c in (1, 3, 4):
        for h, w in ((1, 1), (5, 9), (37, 53)):
            img = rng.uniform(0, 255, (h, w, c)).astype(np.float32)
            for out in ((1, 1), (11, 7), (40, 40)):
                for m in (
                        np.float32([[0.8, 0.3, 2.5], [-0.3, 1.1, -4.0]]),
                        np.float32([[1, 0, 0], [0, 1, 0]]),
                        np.float32([[1e-3, 0, 1e6], [0, 1e-3, -1e6]]),
                        np.float32([[1, 2, 0], [2, 4, 0]])):    # singular
                    np.testing.assert_array_equal(
                        paug.warp_affine(img, m, out, 9.0),
                        paug.warp_affine_plain(img, m, out, 9.0))
                np.testing.assert_array_equal(
                    paug.resize_linear(img, out),
                    paug.resize_linear_plain(img, out))


def test_resize_and_inverse_match_cv2():
    import cv2
    rng = np.random.RandomState(8)
    for c in (1, 3):
        for (h, w), (oh, ow) in (((5, 9), (23, 17)), ((30, 20), (31, 45)),
                                 ((8, 8), (8, 8))):
            img = rng.uniform(0, 255, (h, w, c)).astype(np.float32)
            want = cv2.resize(img, (ow, oh), interpolation=cv2.INTER_LINEAR)
            got = paug.resize_linear(img, (oh, ow))
            # cv2 sums its two passes in another order: a few float32
            # ulps of 255 (readings up to 1.8e-4)
            np.testing.assert_allclose(got, want.reshape(got.shape), rtol=0,
                                       atol=1e-3)
    for m in (np.float32([[0.8, 0.3, 2.5], [-0.3, 1.1, -4.0]]),
              np.float32([[1, 2, 0], [2, 4, 0]])):
        np.testing.assert_allclose(paug.invert_affine(m),
                                   cv2.invertAffineTransform(m), rtol=1e-6,
                                   atol=1e-6)


# -- .binaryproto means -------------------------------------------------------

@pytest.mark.parametrize("spelling", [
    dict(legacy=True, packed=True), dict(legacy=True, packed=False),
    dict(legacy=False, packed=True, packed_dims=True),
    dict(legacy=False, packed=False, packed_dims=False),
    dict(legacy=False, packed=True, packed_dims=True, lead_one=False)],
    ids=["legacy-packed", "legacy-unpacked", "shape-packed",
         "shape-unpacked", "shape-chw"])
def test_binaryproto_mean_is_bit_equal_to_the_jax_parser(spelling):
    rng = np.random.RandomState(3)
    for c in (3, 1):
        arr = rng.uniform(0, 255, (c, 7, 9)).astype(np.float32)
        data = binaryproto(arr, **spelling)
        got = paug.load_binaryproto_mean(data)
        want = jaug.load_binaryproto_mean(data)
        assert got.dtype == np.float32 and got.shape == (7, 9, c)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            paug.load_binaryproto_mean(data, rgb_flip=False),
            jaug.load_binaryproto_mean(data, rgb_flip=False))
    with pytest.raises(ValueError, match="does not match"):
        paug.load_binaryproto_mean(binaryproto(arr)[:-8])


def test_mean_store_reads_a_binaryproto_as_the_jax_package(tmp_path):
    arr = np.random.RandomState(4).uniform(0, 255, (3, 30, 34)).astype(
        np.float32)
    path = str(tmp_path / "mean.binaryproto")
    with open(path, "wb") as f:
        f.write(binaryproto(arr, legacy=False))
    for shape in ((30, 34, 3), (24, 28, 3)):
        got = paug.MeanStore(path, shape)
        want = jaug.MeanStore(path, shape)
        assert got.ready
        np.testing.assert_array_equal(got.mean, want.mean)
    with pytest.raises(ValueError, match="at least the crop"):
        paug.MeanStore(path, (32, 40, 3))
    missing = paug.MeanStore(str(tmp_path / "none.binaryproto"), (4, 4, 3))
    assert not missing.ready
    with pytest.raises(ValueError, match="imported, never computed"):
        missing.compute([np.zeros((4, 4, 3), np.float32)])
