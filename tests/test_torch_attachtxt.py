"""``attachtxt`` and ``extra_data`` inputs of the port against the JAX
package, on the CPU.

* The iterator: over a synthetic source (96 rows, batches of 16) and a
  side file that lacks a third of the ids and lists some
  the source never yields, every batch's ``extra_data`` equals the JAX
  ``AttachTxtIterator``'s bit for bit (zeros for a missing id), the
  other fields too, under ``threadbuffer`` and ``membuffer``; over a
  ``membuffer`` the port's second epoch carries one side array (the JAX
  iterator's two: a reference quirk); a file whose rows do not have
  ``dim`` values and a base that yields no ``inst_index`` raise the JAX
  messages.
* A net with ``extra_data_num = 1`` (the side features concatenated
  after a hidden layer) trains 4 SGD steps in both trainers from the
  same weights: each step's loss within 1e-5 relative, every leaf within
  1e-5 relative L2 of the JAX trainer's, float32. A ``train_chain = 2``
  run of the port takes the same steps.
* The task driver: a round the port trained, read by ``task = pred``,
  ``pred_raw`` and ``extract`` (at the concat node, which holds the side
  features) in both packages, gives the same files (within 1e-5).
* The data-service wire: a port client reading a JAX reader that serves
  an ``attachtxt`` chain, and a JAX client reading a port reader, get
  the ``extra_data`` of the local stream bit for bit.
* ``task = serve`` refuses a graph with ``extra_data`` with the JAX
  package's message.
"""

import contextlib
import functools
import os
import socket

import jax
import numpy as np
import pytest

from cxxnet_tpu import main as jax_main
from cxxnet_tpu.config import parse_config_string as jax_parse
from cxxnet_tpu.config import \
    parse_data_service_config as jax_parse_svc
from cxxnet_tpu.data_service.client import \
    build_service_iterator as jax_build
from cxxnet_tpu.data_service.reader import DataReaderServer as JaxReader
from cxxnet_tpu.io.data import DataIter as JaxDataIter
from cxxnet_tpu.io.data import DataBatch as JaxBatch
from cxxnet_tpu.io.data import create_iterator as jax_create_iterator
from cxxnet_tpu.io.iter_img import AttachTxtIterator as JaxAttach
from cxxnet_tpu.trainer import Trainer as JaxTrainer
from cxxnet_tpu_torch import main as port_main
from cxxnet_tpu_torch.config import (parse_config_string,
                                     parse_data_service_config,
                                     split_sections)
from cxxnet_tpu_torch.convert import params_to_jax
from cxxnet_tpu_torch.data_service.client import build_service_iterator
from cxxnet_tpu_torch.data_service.reader import DataReaderServer
from cxxnet_tpu_torch.io import AttachTxtIterator, create_iterator
from cxxnet_tpu_torch.io.data import DataBatch, DataIter
from cxxnet_tpu_torch.optim import leaves
from cxxnet_tpu_torch.trainer import Trainer

DIM = 4
NET = """
extra_data_num = 1
extra_data_shape[0] = 1,1,{dim}
data = train
iter = synthetic
  num_inst = 96
  num_class = 3
  input_shape = 1,1,6
  seed_data = 5
iter = attachtxt
  filename = {side}
iter = end
netconfig = start
layer[in->h] = fullc:fc1
  nhidden = 8
layer[+0] = relu
layer[h,in_1->cat] = concat:cat
layer[cat->o] = fullc:fc2
  nhidden = 3
layer[+0] = softmax
netconfig = end
input_shape = 1,1,6
batch_size = 16
eta = 0.1
momentum = 0.9
wd = 0.0001
dev = cpu
silent = 1
metric = error
"""


def _side(path) -> str:
    """A side file: ids 0..95 but every third missing, plus ids 200..209
    the source never yields, rows of DIM seeded values."""
    rs = np.random.RandomState(9)
    ids = [i for i in range(96) if i % 3] + list(range(200, 210))
    lines = [str(DIM)] + [" ".join([str(i)] + [repr(float(v)) for v in
                                               rs.randn(DIM)]) for i in ids]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.fixture()
def conf(tmp_path):
    text = NET.format(dim=DIM, side=_side(tmp_path / "side.txt"))
    path = tmp_path / "net.conf"
    path.write_text(text)
    return str(path), text


def _section(text, wrappers=()):
    glob, sections = split_sections(parse_config_string(text))
    pairs = [p for p in glob if p[0] == "batch_size"] + sections[0][2]
    for w in wrappers:
        pairs += [("iter", w)]
    return pairs


def _same(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.data, b.data)
        np.testing.assert_array_equal(a.label, b.label)
        np.testing.assert_array_equal(a.inst_index, b.inst_index)
        assert a.num_batch_padd == b.num_batch_padd
        assert len(a.extra_data) == len(b.extra_data) == 1
        assert a.extra_data[0].dtype == np.float32
        np.testing.assert_array_equal(a.extra_data[0], b.extra_data[0])


@pytest.mark.parametrize("wrappers", [(), ("threadbuffer",),
                                      ("membuffer",)])
def test_attachtxt_batches_are_the_jax_iterators(conf, wrappers):
    _, text = conf
    pairs = _section(text, wrappers)
    got = list(create_iterator(pairs))
    want = list(jax_create_iterator(pairs))
    _same(got, want)
    assert got[-1].num_batch_padd == 0 and len(got) == 6
    ex = got[0].extra_data[0]
    assert ex.shape == (16, 1, 1, DIM)
    # ids 0 and 3 are missing from the file: zero rows
    assert not ex[0].any() and not ex[3].any() and ex[1].any()


def test_attachtxt_over_a_buffer_appends_once_an_epoch(conf):
    """attachtxt over membuffer (which serves its batch objects again):
    the port's second epoch carries one side array, as its first; the
    JAX iterator appends to the buffered batch, so its second epoch
    carries two (ROADMAP queue C, a reference quirk)."""
    _, text = conf
    pairs = _section(text)
    at = pairs.index(("iter", "attachtxt"))
    pairs = pairs[:at] + [("iter", "membuffer")] + pairs[at:]
    it, jit = create_iterator(pairs), jax_create_iterator(pairs)
    first = list(it)
    second = list(it)
    _same(second, first)
    list(jit)
    assert len(list(jit)[0].extra_data) == 2


class _NoIds(DataIter):
    def __init__(self):
        super().__init__([])

    def before_first(self):
        self.done = False

    def next(self):
        if self.done:
            return None
        self.done = True
        return DataBatch(data=np.zeros((2, 1, 1, 3), np.float32),
                         label=np.zeros((2, 1), np.float32))


class _JaxNoIds(JaxDataIter):
    def __init__(self):
        super().__init__([])

    def before_first(self):
        self.done = False

    def next(self):
        if self.done:
            return None
        self.done = True
        return JaxBatch(data=np.zeros((2, 1, 1, 3), np.float32),
                        label=np.zeros((2, 1), np.float32))


def test_attachtxt_refusals_are_the_jax_messages(tmp_path):
    side = _side(tmp_path / "side.txt")
    msgs = []
    for cls, base in ((AttachTxtIterator, _NoIds()),
                      (JaxAttach, _JaxNoIds())):
        it = cls([("filename", side)], base)
        it.init()
        it.before_first()
        with pytest.raises(ValueError) as e:
            it.next()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == \
        "attachtxt: base iterator yields no inst_index"
    bad = tmp_path / "bad.txt"
    bad.write_text("3\n0 1 2 3\n1 4 5\n")
    for cls, base in ((AttachTxtIterator, _NoIds()),
                      (JaxAttach, _JaxNoIds())):
        with pytest.raises(ValueError, match="do not match dimension"):
            cls([("filename", str(bad))], base).init()


# -- training ------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _weights():
    text = NET.format(dim=DIM, side="unused")
    glob, _ = split_sections(parse_config_string(text))
    tr = Trainer(glob)
    tr.init_model()
    return params_to_jax(tr.params, tr.net.state)


def _np(t):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), t)


def test_extra_data_net_trains_like_the_jax_trainer(conf):
    _, text = conf
    glob, _ = split_sections(parse_config_string(text))
    batches = list(create_iterator(_section(text)))[:4]
    jtr = JaxTrainer(jax_parse(text))
    params, state = _weights()
    jtr.params, jtr.net_state, jtr.opt_state = jtr._place(
        params, state, jtr.optimizer.init_state(params))
    tr = Trainer(glob)
    tr.init_model((params, state))
    chain = Trainer(glob + [("train_chain", "2")])
    chain.init_model((params, state))
    for i, b in enumerate(batches):
        jtr.update(JaxBatch(data=b.data, label=b.label,
                            inst_index=b.inst_index,
                            extra_data=list(b.extra_data)))
        tr.update(b)
        want_loss = float(jtr.last_loss)
        assert abs(tr.last_loss - want_loss) <= 1e-5 * abs(want_loss), i
        got, want = dict(leaves(params_to_jax(tr.params, {})[0])), \
            dict(leaves(_np(jtr.params)))
        for p, w in want.items():
            rel = np.linalg.norm(got[p] - w) / np.linalg.norm(w)
            assert rel <= 1e-5, (i, p, rel)
    for k in (0, 2):
        chain.update_chain_batches(batches[k:k + 2])
    for p, v in leaves(params_to_jax(chain.params, {})[0]):
        np.testing.assert_array_equal(
            v, dict(leaves(params_to_jax(tr.params, {})[0]))[p])


# -- the task driver -----------------------------------------------------------

@pytest.mark.parametrize("task", ["pred", "pred_raw", "extract"])
def test_batch_task_files_are_the_jax_drivers(conf, tmp_path, task):
    path, _ = conf
    models = tmp_path / "m"
    port_main.main([path, f"model_dir={models}", "num_round=1"])
    rnd = str(models / "0000.model")
    out = {}
    for name, main in (("port", port_main.main), ("jax", jax_main.main)):
        dest = str(tmp_path / f"{name}.txt")
        args = [path, f"task={task}", f"model_in={rnd}",
                f"name_pred={dest}"]
        if task == "extract":
            args.append("extract_node_name=cat")
        main(args)
        out[name] = np.loadtxt(dest, ndmin=2)
    assert out["port"].shape == out["jax"].shape
    assert out["port"].shape[0] == 96
    if task == "extract":
        assert out["port"].shape[1] == 8 + DIM
    np.testing.assert_allclose(out["port"], out["jax"], rtol=1e-5,
                               atol=1e-6)


def test_serve_refuses_extra_data_graphs_with_the_jax_message(conf,
                                                               tmp_path):
    path, _ = conf
    models = tmp_path / "m"
    port_main.main([path, f"model_dir={models}", "num_round=1"])
    rnd = str(models / "0000.model")
    msgs = []
    for main in (port_main.main, jax_main.main):
        with pytest.raises(ValueError) as e:
            main([path, "task=serve", f"model_in={rnd}", "serve_port=0"])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == ("serve: graphs with extra_data are not "
                                  "servable (single-input requests)")


# -- the data-service wire -----------------------------------------------------

def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _svc_pairs(endpoint, **kv):
    return [("data_service", endpoint), ("data_service_shards", "2"),
            ("data_service_prefetch", "0")] + [(k, str(v))
                                                for k, v in kv.items()]


@contextlib.contextmanager
def _reader(section, jax_reader):
    ep = f"127.0.0.1:{_free_port()}"
    cls, parse = ((JaxReader, jax_parse_svc) if jax_reader
                  else (DataReaderServer, parse_data_service_config))
    r = cls(section, parse(_svc_pairs(ep, data_service_reader=0)))
    r.start()
    try:
        yield ep
    finally:
        r.stop()


def _stream(it):
    it.before_first()
    out = []
    while True:
        b = it.next()
        if b is None:
            return out
        out.append(b)


@pytest.mark.parametrize("client,reader", [("port", "jax"),
                                           ("jax", "port")])
def test_extra_data_crosses_the_wire_both_ways(conf, client, reader):
    _, text = conf
    section = _section(text)
    want = _stream(build_service_iterator(
        section, parse_data_service_config(_svc_pairs("local"))))
    with _reader(section, reader == "jax") as ep:
        if client == "port":
            it = build_service_iterator(
                section, parse_data_service_config(_svc_pairs(ep)))
        else:
            it = jax_build(section, jax_parse_svc(_svc_pairs(ep)))
        got = _stream(it)
        it.close()
        assert not it.degraded
    _same(got, want)
