"""The port's batch tasks and resumed training against the JAX package's
task driver (``cxxnet_tpu.main.LearnTask``), on the CPU in float32.

Two nets: the narrow Inception-BN of ``torch_ibn_fixture`` (its JAX-drawn
weights, BN statistics calibrated) and ``examples/synthetic_mlp.conf``
(weights drawn by numpy). Each round is written by one package's
checkpoint writer, the JAX package's or the port's (``writer``), with
an SGD momentum drawn by numpy, and read by both task drivers. The JAX
side runs ``fused_kernels = 0``; the port runs its default, whose kernel
wrappers compute their plain versions on the CPU.

* ``pred``: the class ids equal wherever the JAX top-2 margin exceeds
  1e-4. ``pred_raw`` and ``extract`` (txt and bin, at the top node and
  at an inner node, Inception-BN's 128x2x2 ``i_5b`` among them, so the
  NHWC element order of a row is held): the same rows and columns,
  values within rtol 1e-5 / atol 1e-6; the ``.meta`` sidecars byte-equal.
* ``get_weight`` (txt and bin; a conv ``wmat``, which the port keeps
  OIHW and writes HWIO, a fullc ``wmat``, a bias, and the alias keys):
  the files and their ``.meta`` byte-equal.
* ``continue = 1``: both packages resume at the same round, skipping a
  torn newer one, and one more round later write a round whose
  parameters agree: synthetic_mlp within rtol 1e-5 (atol 1e-7);
  Inception-BN, one step a round, by the step tolerances of
  ``test_torch_train`` (its batch-norm gradients at init are chaotic:
  the packages' float32 steps from one state differ by up to 0.15 of
  the update per leaf), the loss within rtol 1e-4.
* ``model_in`` with ``task = train`` starts at the round after it;
  ``finetune`` copies by layer name with the JAX package's lines.
* The resume scan, the orphan sweep, ``task = serve`` with
  ``continue = 1``, two data-parallel ranks resolving the round, the
  error paths, and ``examples/kaggle_bowl/pred.conf``'s own ``pred``
  section over seeded PNG records.

``continue = 1``, ``model_in``, ``finetune`` and the resume scan are in
``test_torch_tasks_resume.py`` (a file of their own, so that they run
beside the batch tasks on another worker).
"""

import functools
import os
import re
import shutil

import numpy as np
import pytest
import torch

from cxxnet_tpu import checkpoint as jax_ckpt
from cxxnet_tpu import main as jax_main
from cxxnet_tpu.config import parse_config_string as jax_parse
from cxxnet_tpu.graph import build_graph as jax_build_graph
from cxxnet_tpu_torch import checkpoint as ckpt
from cxxnet_tpu_torch import main as port_main
from cxxnet_tpu_torch.config import parse_config_string
from cxxnet_tpu_torch.convert import params_to_jax
from cxxnet_tpu_torch.graph import build_graph
from cxxnet_tpu_torch.model import Network

from torch_ibn_fixture import IBN_TEXT, REPO, jax_weights

WRITERS = ["jax", "port"]
NETS = ["ibn", "mlp"]
ROUND = 3                 # the round each test writes

IBN_GLOBALS = """
batch_size = 16
dev = cpu
compute_dtype = float32
fused_kernels = 0
eta = 0.1
momentum = 0.9
wd = 0.0001
metric = error
print_step = 0
"""

SYNTH = """{kind} = {name}
iter = synthetic
  num_inst = {n}
  num_class = {classes}
  input_shape = {shape}
  seed_data = {seed}
iter = end
"""


def _text(net: str, model_dir, num_round: int = 2) -> str:
    """The net's config: its data section (Inception-BN: one batch of
    16), a pred section whose last batch is padded, and ``model_dir``."""
    if net == "ibn":
        body = (SYNTH.format(kind="data", name="train", n=16, classes=10,
                             shape="3,64,64", seed=11)
                + SYNTH.format(kind="pred", name="section.txt", n=20,
                               classes=10, shape="3,64,64", seed=5)
                + IBN_TEXT + IBN_GLOBALS)
    else:
        with open(os.path.join(REPO, "examples", "synthetic_mlp.conf")) as f:
            body = f.read() + SYNTH.format(
                kind="pred", name="section.txt", n=100, classes=5,
                shape="1,1,16", seed=4)
    return body + f"\nmodel_dir = {model_dir}\nnum_round = {num_round}\n"


def _drop(text: str, kinds=("data", "eval", "pred")) -> str:
    """``text`` without its iterator sections of ``kinds``."""
    return re.sub(r"(?ms)^(%s) = [^\n]*\n.*?^iter = end\n" % "|".join(kinds),
                  "", text)


def _conf(text: str, over) -> str:
    return text + "".join(f"{k} = {v}\n" for k, v in over.items())


def _jax(text: str, **over):
    task = jax_main.LearnTask(jax_parse(_conf(text, over)))
    task.run()
    return task


def _port(text: str, **over):
    return port_main.run(parse_config_string(_conf(text, over)))


@functools.lru_cache(maxsize=None)
def _weights(net: str):
    """(params, state, opt) numpy trees in the JAX layout: Inception-BN's
    JAX-drawn weights, synthetic_mlp's drawn by numpy; an SGD momentum
    of small numpy draws."""
    rs = np.random.RandomState(3)
    if net == "ibn":
        params, state = jax_weights()
    else:
        cfg = parse_config_string(_text("mlp", "unused"))
        shapes = params_to_jax(*Network(build_graph(cfg), cfg).init(
            torch.Generator()))[0]
        params = {l: {k: (rs.randn(*v.shape) * 0.3).astype(np.float32)
                      for k, v in d.items()} for l, d in shapes.items()}
        state = {}
    mom = {l: {k: (rs.randn(*v.shape) * 1e-3).astype(np.float32)
               for k, v in d.items()} for l, d in params.items()}
    return params, state, {"mom": mom}


def _write_round(net: str, writer: str, model_dir, r: int = ROUND) -> str:
    """Round ``r`` (epoch and step count 4r) by ``writer``'s writer."""
    os.makedirs(model_dir, exist_ok=True)
    params, state, opt = _weights(net)
    text = _text(net, model_dir)
    if writer == "jax":
        mod, sig = jax_ckpt, jax_build_graph(jax_parse(text))
    else:
        mod, sig = ckpt, build_graph(parse_config_string(text))
    path = os.path.join(str(model_dir), "%04d.model" % r)
    mod.save_model(path, structure_sig=sig.structure_signature(),
                   round_counter=r, epoch_counter=4 * r, params=params,
                   net_state=state, opt_state=opt, step_count=4 * r)
    return path


@pytest.fixture(params=[(n, w) for n in NETS for w in WRITERS],
                ids=lambda p: f"{p[0]}-{p[1]}")
def case(request, tmp_path):
    """(net, the round's path, its config text)."""
    net, writer = request.param
    path = _write_round(net, writer, tmp_path / "models")
    return net, path, _text(net, tmp_path / "models")


def _rows(path: str, txt: bool, ncol: int = None) -> np.ndarray:
    if txt:
        with open(path) as f:
            return np.array([[float(v) for v in ln.split()]
                             for ln in f.read().splitlines()], np.float64)
    return np.fromfile(path, "<f4").reshape(-1, ncol)


def _bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


# -- pred, pred_raw, extract, get_weight -----------------------------------------

def test_pred_ids_match_the_jax_package(case, tmp_path):
    net, path, text = case
    out = {}
    for who, fn in (("jax", _jax), ("port", _port)):
        for task in ("pred", "pred_raw"):
            out[who, task] = str(tmp_path / f"{who}.{task}.txt")
            fn(text, task=task, model_in=path, name_pred=out[who, task])
    raw = _rows(out["jax", "pred_raw"], True)
    got = _rows(out["port", "pred"], True)[:, 0]
    want = _rows(out["jax", "pred"], True)[:, 0]
    assert got.shape == want.shape == (raw.shape[0],)
    np.testing.assert_array_equal(want, raw.argmax(1))
    srt = np.sort(raw, 1)
    sure = srt[:, -1] - srt[:, -2] > 1e-4
    assert sure.sum() >= 0.9 * len(sure)
    np.testing.assert_array_equal(got[sure], want[sure])


def test_pred_raw_matches_the_jax_package(case, tmp_path):
    net, path, text = case
    files = {who: str(tmp_path / f"{who}.txt") for who in WRITERS}
    _jax(text, task="pred_raw", model_in=path, name_pred=files["jax"])
    _port(text, task="pred_raw", model_in=path, name_pred=files["port"])
    got, want = _rows(files["port"], True), _rows(files["jax"], True)
    assert got.shape == want.shape == ({"ibn": 20, "mlp": 100}[net],
                                       {"ibn": 10, "mlp": 5}[net])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


#: extract nodes: the top, and an inner node (Inception-BN's with y, x > 1)
NODES = {"ibn": ("top", "i_5b", "gap"), "mlp": ("top", "h1")}


@pytest.mark.parametrize("fmt", ["txt", "bin"])
@pytest.mark.parametrize("node", [0, 1])
def test_extract_matches_the_jax_package(case, tmp_path, fmt, node):
    net, path, text = case
    node = NODES[net][node]
    files = {who: str(tmp_path / f"{who}.out") for who in WRITERS}
    for who, fn in (("jax", _jax), ("port", _port)):
        fn(text, task="extract", model_in=path, name_pred=files[who],
           extract_node_name=node, output_format=fmt)
    meta = _bytes(files["port"] + ".meta")
    assert meta == _bytes(files["jax"] + ".meta")
    nrow, c, y, x = (int(v) for v in meta.decode().split(","))
    got = _rows(files["port"], fmt == "txt", c * y * x)
    want = _rows(files["jax"], fmt == "txt", c * y * x)
    assert got.shape == want.shape == (nrow, c * y * x)
    # an inner node of Inception-BN: the two packages' convs sum in other
    # orders through up to 69 layers, so atol is 1e-5 of the node's
    # largest value (the top node's softmax and synthetic_mlp's nodes
    # hold 1e-6)
    atol = 1e-6 if net == "mlp" or node == "top" \
        else 1e-5 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)


def test_extract_rows_are_in_nhwc_order(tmp_path):
    """At i_5b (128x2x2) the port's row is the JAX package's NHWC
    flattening: its mean over each channel's 4 cells is the gap row."""
    path = _write_round("ibn", "port", tmp_path / "models")
    text = _text("ibn", tmp_path / "models")
    rows = {}
    for node in ("i_5b", "gap"):
        out = str(tmp_path / f"{node}.bin")
        _port(text, task="extract", model_in=path, name_pred=out,
              extract_node_name=node, output_format="bin")
        rows[node] = _rows(out, False, 128 * (4 if node == "i_5b" else 1))
    np.testing.assert_allclose(
        rows["i_5b"].reshape(-1, 2, 2, 128).mean((1, 2)), rows["gap"],
        rtol=1e-5, atol=1e-6)


#: get_weight cases: (net, config keys); the aliases included
WEIGHTS = [
    ("ibn", {"extract_layer_name": "cv_stem1"}),
    ("ibn", {"extract_layer_name": "cv_3a_3x3", "weight_name": "wmat"}),
    ("ibn", {"weight_layer": "fc1", "weight_tag": "wmat"}),
    ("ibn", {"extract_layer_name": "fc1", "weight_name": "bias"}),
    ("ibn", {"extract_layer_name": "bn_stem1", "weight_name": "wmat"}),
    ("mlp", {"extract_layer_name": "fc1"}),
    ("mlp", {"weight_layer": "fc2", "weight_tag": "bias"}),
]


@pytest.mark.parametrize("writer", WRITERS)
@pytest.mark.parametrize("fmt", ["txt", "bin"])
@pytest.mark.parametrize("net,keys", WEIGHTS,
                         ids=[f"{n}-{'-'.join(k.values())}"
                              for n, k in WEIGHTS])
def test_get_weight_files_are_byte_equal(tmp_path, writer, fmt, net, keys):
    path = _write_round(net, writer, tmp_path / "models")
    text = _text(net, tmp_path / "models")
    files = {}
    for who, fn in (("jax", _jax), ("port", _port)):
        files[who] = str(tmp_path / f"{who}.w")
        fn(text, task="get_weight", model_in=path, output_format=fmt,
           weight_filename=files[who], **keys)
    assert _bytes(files["port"]) == _bytes(files["jax"])
    assert _bytes(files["port"] + ".meta") == \
        _bytes(files["jax"] + ".meta")
    assert len(_bytes(files["port"])) > 0


def test_get_weight_writes_name_pred_without_weight_filename(tmp_path):
    path = _write_round("mlp", "port", tmp_path / "models")
    out = str(tmp_path / "w.txt")
    _port(_text("mlp", tmp_path / "models"), task="get_weight",
          model_in=path, extract_layer_name="fc2", name_pred=out)
    assert _bytes(out + ".meta") == b"32 5\n"
    np.testing.assert_allclose(_rows(out, True),
                               _weights("mlp")[0]["fc2"]["wmat"], rtol=1e-5)


def test_set_weight_takes_the_jax_layout_and_keeps_the_momenta(tmp_path):
    """``set_weight`` / ``set_weights`` take arrays in the JAX layout (a
    conv's HWIO), as ``get_weight`` gives them; the momenta stay, and a
    shape that differs raises the JAX package's message before anything
    changes."""
    from cxxnet_tpu_torch.convert import opt_to_jax
    from cxxnet_tpu_torch.trainer import Trainer
    path = _write_round("ibn", "port", tmp_path / "models")
    tr = Trainer(parse_config_string(_text("ibn", tmp_path / "models")))
    tr.load_model(path)
    rs = np.random.RandomState(8)
    conv = rs.randn(*tr.get_weight("cv_stem1", "wmat").shape)
    bias = rs.randn(10).astype(np.float32)
    assert conv.shape == (7, 7, 3, 8)                  # HWIO
    with pytest.raises(ValueError, match=re.escape(
            "set_weight fc1.bias: shape (9,) != (10,)")):
        tr.set_weights({("cv_stem1", "wmat"): conv, ("fc1", "bias"): bias[:9]})
    np.testing.assert_array_equal(tr.get_weight("cv_stem1", "wmat"),
                                  _weights("ibn")[0]["cv_stem1"]["wmat"])
    tr.set_weights({("cv_stem1", "wmat"): conv, ("fc1", "bias"): bias})
    tr.set_weight(bias * 2, "fc1", "bias")
    np.testing.assert_array_equal(tr.get_weight("cv_stem1", "wmat"),
                                  conv.astype(np.float32))
    np.testing.assert_array_equal(
        tr.params["cv_stem1"]["wmat"].detach().numpy(),
        conv.astype(np.float32).transpose(3, 2, 0, 1))   # OIHW
    np.testing.assert_array_equal(tr.get_weight("fc1", "bias"), bias * 2)
    assert tr.params["fc1"]["bias"].requires_grad
    mom = opt_to_jax(tr.opt_state)["mom"]
    np.testing.assert_array_equal(mom["cv_stem1"]["wmat"],
                                  _weights("ibn")[2]["mom"]["cv_stem1"]["wmat"])


def test_pred_section_names_the_output_and_data_is_the_fallback(
        tmp_path, monkeypatch):
    """``pred = <file>`` names the output (relative to the working
    directory); with no pred section the data section is read."""
    path = _write_round("mlp", "port", tmp_path / "models")
    monkeypatch.chdir(tmp_path)
    text = _text("mlp", tmp_path / "models")
    _port(text, task="pred", model_in=path)
    assert len(_rows(str(tmp_path / "section.txt"), True)) == 100
    _port(_drop(text, ("pred",)), task="pred", model_in=path)
    assert len(_rows(str(tmp_path / "pred.txt"), True)) == 512


# -- error paths --------------------------------------------------------------------

ERRORS = {
    "output_format Bin": ({"task": "extract", "output_format": "Bin"},
                          "output_format must be 'txt' or 'bin', got 'Bin'"),
    "get_weight Bin": ({"task": "get_weight", "extract_layer_name": "fc1",
                        "output_format": "Bin"},
                       "output_format must be 'txt' or 'bin', got 'Bin'"),
    "get_weight no layer": ({"task": "get_weight"},
                            "get_weight requires extract_layer_name="),
    "unknown node": ({"task": "extract", "extract_node_name": "nope"},
                     "'nope'"),
    "unknown weight": ({"task": "get_weight", "extract_layer_name": "fc1",
                        "weight_name": "nope"}, "'nope'"),
    "no pred section": ({"task": "pred_raw", "strip": 1},
                        "no pred/data section in config"),
}


@pytest.mark.parametrize("what", sorted(ERRORS))
def test_errors_raise_with_the_jax_package_message(tmp_path, what):
    over, msg = dict(ERRORS[what][0]), ERRORS[what][1]
    path = _write_round("mlp", "port", tmp_path / "models")
    text = _text("mlp", tmp_path / "models")
    if over.pop("strip", 0):
        text = _drop(text)
    text = _conf(text, {"model_in": path,
                        "name_pred": tmp_path / "out.txt", **over})
    with pytest.raises((KeyError, ValueError), match=re.escape(msg)):
        jax_main.LearnTask(jax_parse(text)).run()
    with pytest.raises((KeyError, ValueError), match=re.escape(msg)):
        port_main.run(parse_config_string(text))


def test_a_remote_output_path_names_its_roadmap_item(tmp_path):
    """Remote output paths are written through the stream layer now
    (ROADMAP Queue A 2 brought them): ``pred`` to fsspec's ``memory://``
    writes the bytes it writes to a local file."""
    import fsspec
    from cxxnet_tpu_torch.io import stream
    path = _write_round("mlp", "port", tmp_path / "models")
    url = f"memory://tasks{os.getpid()}/pred.txt"
    outs = []
    for where in (url, str(tmp_path / "pred.txt")):
        _port(_text("mlp", tmp_path / "models"), task="pred",
              model_in=path, name_pred=where)
        outs.append(stream.read_bytes(where))
    fsspec.filesystem("memory").rm(url)
    assert outs[0] == outs[1] and outs[0]


@pytest.mark.parametrize("task", ["pred", "pred_raw", "extract",
                                  "extract_feature", "get_weight"])
def test_batch_tasks_run_through_the_cli(tmp_path, task):
    """``python -m cxxnet_tpu_torch.main <conf> task=...`` (its
    ``main``) runs each batch task from ``continue = 1``."""
    _write_round("mlp", "port", tmp_path / "models")
    conf = tmp_path / "mlp.conf"
    conf.write_text(_text("mlp", tmp_path / "models"))
    out = str(tmp_path / "out.txt")
    assert port_main.main([str(conf), f"task={task}", "continue=1",
                           f"name_pred={out}", "extract_layer_name=fc1",
                           "silent=1"]) == 0
    assert os.path.getsize(out) > 0


# -- the Kaggle bowl prediction ------------------------------------------------------

def test_kaggle_pred_conf_matches_the_jax_package(tmp_path, monkeypatch):
    """``examples/kaggle_bowl/pred.conf`` as it is (``pred = test.txt``,
    ``task = pred_raw``, ``iter = imgrec`` with ``image_mean``,
    ``threadbuffer``, ``model_in = ./models/0099.model``), run from a
    directory holding seeded 40x40 PNG records and one round of random
    weights: the port's test.txt against the JAX package's. The JAX
    run writes the mean image; the port reads the same file."""
    from cxxnet_tpu_torch.io import recordio
    from torch_imgrec_fixture import image, png_bytes, write_records
    conf = os.path.join(REPO, "examples", "kaggle_bowl", "pred.conf")
    rng = np.random.RandomState(12)
    cfg = parse_config_string(open(conf).read() + "dev = cpu\n")
    net = Network(build_graph(cfg), [kv for kv in cfg if kv[0] != "pred"])
    shapes = params_to_jax(*net.init(torch.Generator()))[0]
    # fan-in scaled draws; cv1 also by 1/64, the spread of the raw
    # pixels less their mean (the config divides by nothing), so the
    # logits are of order one as a trained net's are
    params = {l: {k: (rng.randn(*v.shape) * (
        0.1 if k == "bias" else np.sqrt(1.0 / np.prod(v.shape[:-1]))
        / (64.0 if l == "cv1" else 1.0))).astype(np.float32)
        for k, v in d.items()} for l, d in shapes.items()}
    dirs = {who: tmp_path / who for who in WRITERS}
    for d in dirs.values():
        (d / "data").mkdir(parents=True)
        (d / "models").mkdir()
    write_records(str(dirs["jax"] / "data" / "bowl_test.rec"),
                  [png_bytes(image(rng, 40, 40)) for _ in range(70)],
                  recordio.RecordWriter, recordio.ImageRecord)
    shutil.copy(dirs["jax"] / "data" / "bowl_test.rec",
                dirs["port"] / "data" / "bowl_test.rec")
    ckpt.save_model(str(dirs["jax"] / "models" / "0099.model"),
                    structure_sig=net.graph.structure_signature(),
                    round_counter=99, epoch_counter=0, params=params,
                    net_state={})
    shutil.copy(dirs["jax"] / "models" / "0099.model",
                dirs["port"] / "models" / "0099.model")
    monkeypatch.chdir(dirs["jax"])
    assert jax_main.main([conf, "dev=cpu"]) == 0
    mean = [f for f in os.listdir(dirs["jax"] / "models")
            if f.startswith("bowl_mean")]
    assert mean == ["bowl_mean.bin.npy"]
    shutil.copy(dirs["jax"] / "models" / mean[0],
                dirs["port"] / "models" / mean[0])
    monkeypatch.chdir(dirs["port"])
    assert port_main.main([conf, "dev=cpu"]) == 0
    got = _rows(str(dirs["port"] / "test.txt"), True)
    want = _rows(str(dirs["jax"] / "test.txt"), True)
    assert got.shape == want.shape == (70, 121)
    np.testing.assert_allclose(got.sum(1), 1.0, atol=1e-4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
