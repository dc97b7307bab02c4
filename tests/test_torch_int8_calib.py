"""The port's int8 forward against the JAX package's on rounds the JAX
package quantized, calibrated on the distribution that is served and on
another one; on the CPU.

The narrow Inception-BN of ``torch_ibn_fixture``, its round drawn by
``chip_smoke.write_round`` (numpy weights, batch-norm statistics from
N(0, 1) rows), is quantized by the JAX package's PTQ twice: over N(0, 1)
rows, the distribution served below and by ``chip_smoke.py``'s int8
phase since it calibrates on what it serves, and over the ``synthetic``
iterator's cluster rows (centres of N(0, 2^2)), the calibration that
phase used to take. On each round:

* the port's int8 engine against the JAX int8 engine on the served
  rows: rel L2 of the softmax rows within ``PORT_VS_JAX`` (readings
  5e-8 and 6e-8) and the same top-1 where the margin exceeds 0.05;
* int8 against float32: the same reading in both packages (rel 1e-5 of
  each other).

Why the narrow net suffices: it has every layer type and int8 layer of
the flagship (69 convs and fc1) and the flagship's round recipe, and a
full-width forward is a card job. It cannot gate int8 against float32,
though: at 1/8 of the widths and 10 classes this random BN net reads
rel L2 0.30 calibrated on the served rows and 0.40 on the clusters, too
close for a bound. At full width the two readings are 0.109 and 10.9
(ROADMAP queue C), and ``chip_smoke.py`` gates there (``INT8_VS_FP``).
"""

import jax
import numpy as np
import pytest

from cxxnet_tpu import checkpoint as jax_ckpt
from cxxnet_tpu import quant as jax_quant
from cxxnet_tpu.config import parse_config_string as jax_parse
from cxxnet_tpu.config import parse_quant_config
from cxxnet_tpu.serve.engine import InferenceEngine as JaxEngine
from cxxnet_tpu.serve.engine import restore_inference_blob
from cxxnet_tpu.trainer import Trainer
from cxxnet_tpu_torch.config import parse_config_string
from cxxnet_tpu_torch.graph import build_graph
from cxxnet_tpu_torch.serve import InferenceEngine

import chip_smoke
from torch_ibn_fixture import IBN_TEXT, images, jax_net

F32 = "compute_dtype = float32\ndev = cpu\n"
WIDTH = 3 * 64 * 64
#: the port's int8 engine against the JAX package's on one round
PORT_VS_JAX = 1e-3


def cluster_batch():
    """A batch of the ``synthetic`` iterator's rows (10 centres of
    N(0, 2^2) plus N(0, 0.5^2) noise), as NHWC."""
    rs = np.random.RandomState(4)
    centres = rs.randn(10, WIDTH).astype(np.float32) * 2.0
    x = centres[rs.randint(0, 10, 16)] \
        + 0.5 * rs.randn(16, WIDTH).astype(np.float32)
    return x.reshape(16, 3, 64, 64).transpose(0, 2, 3, 1).copy()


def jax_trainer():
    from cxxnet_tpu.parallel import make_mesh_context
    return Trainer(jax_parse(IBN_TEXT + F32),
                   mesh_ctx=make_mesh_context(devices=jax.devices()[:1]))


@pytest.fixture(scope="module")
def rounds(tmp_path_factory):
    """The source round (``chip_smoke.write_round``'s recipe at the
    narrow width) and its two JAX-quantized derivations."""
    td = tmp_path_factory.mktemp("calib")
    conf = td / "ibn.conf"
    conf.write_text(IBN_TEXT + F32)
    src = chip_smoke.write_round(str(conf), 0, str(td), "cpu")
    sig = build_graph(parse_config_string(IBN_TEXT)).structure_signature()
    blob = jax_ckpt.load_for_inference(src)
    qc = parse_quant_config([("quant_calib_batches", "1")])
    net = jax_net(F32)
    out = {"src": src}
    for tag, batch in (("served", images(11)), ("clusters",
                                                cluster_batch())):
        qblob, qm = jax_quant.quantize_blob(net, blob, [batch], qc)
        path = str(td / f"0001.{tag}.model")
        jax_quant.write_quantized_round(path, sig, qblob, qm)
        out[tag] = path
    return out


def port_engine(path, dtype):
    return InferenceEngine.from_checkpoint(IBN_TEXT + F32, path, dtype=dtype,
                                           buckets="16", max_batch=16)


def jax_engine(path):
    tr = jax_trainer()
    restore_inference_blob(tr, jax_ckpt.load_for_inference(path))
    return JaxEngine(tr, buckets="16", max_batch=16, dtype="int8")


def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("tag", ["served", "clusters"])
def test_port_int8_forward_matches_the_jax_package(rounds, tag):
    x = chip_smoke.served_rows(7, 16, WIDTH)
    # the float32 engines of the two packages agree to 1e-5
    # (test_torch_serve.py): one reference for both
    want = port_engine(rounds["src"], None).predict_raw(x)
    got = port_engine(rounds[tag], "int8").predict_raw(x)
    ref = jax_engine(rounds[tag]).predict_raw(x)
    assert rel_l2(got, ref) <= PORT_VS_JAX
    srt = np.sort(ref, 1)
    sure = srt[:, -1] - srt[:, -2] > 0.05
    assert sure.sum() >= 4
    assert (got.argmax(1)[sure] == ref.argmax(1)[sure]).all()
    assert rel_l2(got, want) == pytest.approx(rel_l2(ref, want), rel=1e-5)
