"""``iter = img`` and ``examples/kaggle_bowl/bowl.conf`` through the port,
against the JAX package, on the CPU.

* The ``img`` iterator against ``cxxnet_tpu.io.iter_img.ImageIterator``
  over PNG and JPEG files of an image list (``image_list`` /
  ``path_imglist``, ``image_root`` / ``path_imgdir``), two labels each,
  shuffled over two epochs, the mean image computed on first use, crop
  and mirror, the padded last batch: bit-equal without the affine warp,
  within 2e-3 with ``bowl.conf``'s affine keys; one decode thread and
  four give the same batches.
* ``bowl.conf``'s own train and eval sections over JPEG records that
  ``chip_smoke.jpeg_encode`` writes here (48x48 RGB, 121 classes; only
  ``image_rec`` and ``image_mean`` rewritten, ``dev = cpu``, batch 8):
  the port's batches within 2e-3 of the JAX iterator's (the affine
  warp), the eval batches bit-equal; then two float32 SGD steps of the
  port's trainer against the JAX trainer from the same weights (the JAX
  package's init, carried across by ``convert.py``) on the same host
  batches, the dropout threshold at 0 (the deterministic case of the
  same code, as ``test_torch_convnets.py`` runs the convnets): loss,
  every parameter and momentum within the convnet bounds of those tests
  (atol 1e-5).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cxxnet_tpu.io.data import close_chain as jax_close_chain
from cxxnet_tpu.io.data import create_iterator as jax_create_iterator
from cxxnet_tpu.trainer import Trainer as JaxTrainer
from cxxnet_tpu_torch.config import parse_config_file, split_sections
from cxxnet_tpu_torch.convert import opt_to_jax, params_to_jax
from cxxnet_tpu_torch.io import close_chain, create_iterator
from cxxnet_tpu_torch.io import recordio as prec
from cxxnet_tpu_torch.optim import leaves
from cxxnet_tpu_torch.trainer import Trainer

import chip_smoke
from torch_ibn_fixture import REPO
from torch_imgrec_fixture import image, pil_bytes, png_bytes, write_records

BOWL = os.path.join(REPO, "examples", "kaggle_bowl", "bowl.conf")
BOWL_AFFINE = [("max_rotate_angle", "180"), ("max_aspect_ratio", "0.5"),
               ("max_shear_ratio", "0.3"), ("min_crop_size", "32"),
               ("max_crop_size", "48"), ("rand_mirror", "1"),
               ("rand_crop", "1")]


@pytest.fixture(scope="module")
def img_dir(tmp_path_factory):
    """19 images of 30x34 in a directory, PNG and JPEG in turn, and an
    image list with two labels each."""
    d = tmp_path_factory.mktemp("img")
    rng = np.random.RandomState(12)
    lines = []
    for i in range(19):
        im = image(rng, 30, 34)
        name = f"sub/im{i}." + ("png" if i % 2 else "jpg")
        os.makedirs(d / "sub", exist_ok=True)
        data = png_bytes(im) if i % 2 else pil_bytes(im, "JPEG", quality=88)
        (d / name).write_bytes(data)
        lines.append(f"{50 + i}\t{i % 4}\t{(3 * i) % 7}\t{name}\n")
    (d / "list.lst").write_text("".join(lines))
    return str(d)


def _img_section(d, extra, names=("image_list", "image_root")):
    return ([("iter", "img"), (names[0], os.path.join(d, "list.lst")),
             (names[1], d), ("input_shape", "3,24,28"), ("batch_size", "8"),
             ("label_width", "2"), ("silent", "1"), ("dev", "cpu")]
            + list(extra) + [("iter", "end")])


def _batches(make, close, cfg, epochs=2):
    it = make(cfg)
    try:
        return [b for _ in range(epochs) for b in it]
    finally:
        close(it)


@pytest.mark.parametrize("case", ["shuffle_mean_crop", "aliases_mirror",
                                  "affine", "threads"])
def test_img_batches_match_the_jax_iterator(img_dir, tmp_path, case):
    mean = str(tmp_path / "mean.bin")
    names = ("image_list", "image_root")
    extra = {"shuffle_mean_crop": [("shuffle", "1"), ("seed_data", "4"),
                                   ("image_mean", mean), ("rand_crop", "1"),
                                   ("rand_mirror", "1")],
             "aliases_mirror": [("mirror", "1"), ("divideby", "255"),
                                ("mean_value", "120,110,100")],
             "affine": BOWL_AFFINE + [("shuffle", "1"), ("image_mean", mean)],
             "threads": [("shuffle", "1"), ("rand_crop", "1"),
                         ("decode_threads", "1")]}[case]
    if case == "aliases_mirror":
        names = ("path_imglist", "path_imgdir")
    cfg = _img_section(img_dir, extra, names)
    got = _batches(create_iterator, close_chain, cfg)
    want = _batches(jax_create_iterator, jax_close_chain, cfg)
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        assert a.data.dtype == b.data.dtype == np.float32
        assert a.data.shape == (8, 24, 28, 3)
        if case == "affine":
            np.testing.assert_allclose(a.data, b.data, rtol=0, atol=2e-3)
        else:
            np.testing.assert_array_equal(a.data, b.data)
        np.testing.assert_array_equal(a.label, b.label)
        np.testing.assert_array_equal(a.inst_index, b.inst_index)
        assert a.num_batch_padd == b.num_batch_padd
    assert got[2].num_batch_padd == 5 and got[0].label.shape == (8, 2)
    if case == "shuffle_mean_crop":
        np.testing.assert_array_equal(np.load(mean + ".npy").shape,
                                      (24, 28, 3))
    if case == "threads":
        four = _batches(create_iterator, close_chain, _img_section(
            img_dir, extra[:-1] + [("decode_threads", "4")]))
        for a, b in zip(four, got):
            np.testing.assert_array_equal(a.data, b.data)


# -- bowl.conf ------------------------------------------------------------------

def _bowl_records(d):
    """Train and val JPEG records of 48x48 RGB images with 121 classes."""
    rng = np.random.RandomState(21)
    paths = {}
    for name, n in (("train", 24), ("val", 8)):
        imgs = chip_smoke.seeded_images(rng, n, 48)
        paths[name] = os.path.join(d, f"bowl_{name}.rec")
        write_records(paths[name], [chip_smoke.jpeg_encode(im, 90, 2)
                                    for im in imgs], prec.RecordWriter,
                      prec.ImageRecord,
                      labels=[[float(v)] for v in rng.randint(0, 121, n)])
    return paths


def _bowl_cfg(d):
    """bowl.conf as written, image_rec and image_mean rewritten, dev =
    cpu, batch 8, the dropout threshold 0."""
    paths = _bowl_records(d)
    out, section = [], None
    for k, v in parse_config_file(BOWL):
        if k in ("data", "eval"):
            section = "train" if k == "data" else "val"
        if k == "image_rec":
            v = paths[section]
        elif k == "image_mean":
            v = os.path.join(d, "bowl_mean.bin")
        elif k == "threshold":
            v = "0"
        elif k in ("dev", "batch_size"):
            continue
        out.append((k, v))
    return out + [("dev", "cpu"), ("batch_size", "8"), ("silent", "1")]


def _np_tree(t):
    return jax.tree_util.tree_map(lambda a: np.array(a), t)


def _flat(tree):
    return {"/".join(p): np.asarray(v) for p, v in leaves(tree)}


def _bowl_setup(d):
    cfg = _bowl_cfg(d)
    glob, sections = split_sections(cfg)
    data = [p for kind, _, p in sections if kind == "data"][0]
    evals = [p for kind, _, p in sections if kind == "eval"][0]
    return cfg, glob, data, evals


def test_bowl_conf_trains_like_the_jax_trainer(tmp_path):
    cfg, glob, data, evals = _bowl_setup(str(tmp_path))
    assert ("max_rotate_angle", "180") in data and ("dev", "cpu") in glob
    # the iterators: the affine train section within 2e-3, eval bit-equal
    port = create_iterator(glob + data)
    ref = jax_create_iterator(glob + data)
    try:
        assert port.base.aug.device_normalize == 0
        batches = [port.next(), port.next()]
        for b in batches:
            np.testing.assert_allclose(b.data, ref.next().data, rtol=0,
                                       atol=2e-3)
    finally:
        close_chain(port)
        jax_close_chain(ref)
    ev = _batches(create_iterator, close_chain, glob + evals, 1)
    jev = _batches(jax_create_iterator, jax_close_chain, glob + evals, 1)
    for a, b in zip(ev, jev):
        np.testing.assert_array_equal(a.data, b.data)
    # two float32 steps from the JAX package's weights, the same batches
    jtr = JaxTrainer(glob + [("fused_kernels", "0")])
    jtr.init_model()
    p0, s0 = _np_tree(jtr.params), _np_tree(jtr.net_state)
    jtr.params, jtr.net_state, jtr.opt_state = jtr._place(
        p0, s0, jtr.optimizer.init_state(p0))

    def jargs(b, epoch):
        sched = {tag: (jnp.float32(lr), jnp.float32(m)) for tag, (lr, m)
                 in jtr.optimizer.schedules(epoch).items()}
        mask = np.ones((b.batch_size,), np.float32)
        return (jtr.params, jtr.opt_state, jtr.net_state, {},
                jnp.asarray(b.data), jnp.asarray(b.label),
                jnp.asarray(mask), (), jax.random.PRNGKey(0), sched)
    step = jtr._make_train_step(True).lower(*jargs(batches[0], 0)).compile(
        compiler_options={"xla_allow_excess_precision": False})
    want_losses = []
    for i, b in enumerate(batches):
        (jtr.params, jtr.opt_state, jtr.net_state, _, loss, _,
         _) = step(*jargs(b, i))
        want_losses.append(float(loss))
    tr = Trainer(glob)
    tr.init_model((p0, s0))
    losses = []
    for b in batches:
        tr.update(b)
        losses.append(tr.last_loss)
    assert np.all(np.isfinite(losses))
    np.testing.assert_allclose(losses, want_losses, atol=1e-5)
    gp, gs = params_to_jax(tr.params, tr.net.state)
    for got, want, what in ((gp, _np_tree(jtr.params), "params"),
                            (opt_to_jax(tr.opt_state),
                             _np_tree(jtr.opt_state), "opt")):
        got, want = _flat(got), _flat(want)
        assert set(got) == set(want), what
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=1e-5,
                                       err_msg=f"{what} {k}")
