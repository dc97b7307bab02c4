"""The port's causal-LM training path against the JAX package's.

The net is ``examples/LM/tiny_lm.conf`` (embed 32 -> 64, two pre-norm
blocks of causal mha with 4 heads of 16 and a gelu ffn of 256, the seqfc
LM head, lmloss; 64 tokens) with ``attn_impl = flash``, ``attn_block =
32``, ``remat = 1``, Adam (eta 0.003) and ``fused_kernels = 1``, at batch
8 in float32. The JAX package's weights and the same ``synthetic_lm``
batches go through the port's ``Trainer`` on the CPU (the flash and Adam
wrappers take their plain versions) and through the JAX train step (the
Pallas flash and Adam kernels in interpret mode, ``pallas_call``
asserted in the step's jaxpr) for three free-running steps. Held per
step: the loss (rtol 1e-5; readings 0 to 6.9e-8), and every parameter,
m1 and m2 leaf by the relative L2 difference of its change from the
weights before the run, at most 1e-4 (readings up to 1.8e-5: f32 sums
in another order through Adam's per-element normalization), ``t``
equal. One leaf is held otherwise: each ``attn*/k/bias`` has a gradient
that is zero analytically (a shift of every key's logit for one query
cancels in the softmax), so what both packages compute for it is
rounding noise, which Adam can turn into steps as large as any: lr at
t = 1 (lr * sign(g)), at most lr times the Cauchy-Schwarz bound of
|m1_hat| / sqrt(m2_hat) later (1.007 at t = 4). That leaf is held by its
distance from the weights before the run, at most the sum of those
bounds times 1 + 1e-3 in both packages (readings here 6e-8 after three
steps: the f32 noise sits below Adam's 1e-8 epsilon).

Also: ``synthetic_lm`` is bit-equal to the JAX iterator for both
``lm_task`` values; ``seq_error`` equals the JAX metric; a round the
port writes with ``python -m cxxnet_tpu_torch.main`` carries Adam's
``m1``, ``m2`` and ``t`` in the JAX layout, the JAX package resumes it
with ``continue = 1``, and the next step from it agrees in both packages.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cxxnet_tpu import checkpoint as jax_ckpt
from cxxnet_tpu import main as jax_main
from cxxnet_tpu.io.data import create_iterator as jax_create_iterator
from cxxnet_tpu.metrics import MetricSet as JaxMetricSet
from cxxnet_tpu.trainer import Trainer as JaxTrainer
from cxxnet_tpu_torch import checkpoint as ckpt
from cxxnet_tpu_torch import main as port_main
from cxxnet_tpu_torch.config import (ConfigError, parse_config_file,
                                     parse_config_string, split_sections)
from cxxnet_tpu_torch.convert import (opt_to_jax, params_from_jax,
                                      params_to_jax)
from cxxnet_tpu_torch.io import create_iterator
from cxxnet_tpu_torch.metrics import MetricSet
from cxxnet_tpu_torch.optim import leaves
from cxxnet_tpu_torch.trainer import Trainer

from torch_ibn_fixture import REPO

TINY = os.path.join(REPO, "examples", "LM", "tiny_lm.conf")
BATCH, STEPS, SEQ = 8, 3, 64
OVERRIDES = [("batch_size", str(BATCH)), ("dev", "cpu:0"),
             ("attn_impl", "flash"), ("attn_block", "32"), ("remat", "1"),
             ("fused_kernels", "1"), ("compute_dtype", "float32"),
             ("silent", "1")]


def _cfg():
    glob, _ = split_sections(parse_config_file(TINY))
    return glob + OVERRIDES


def _lm_section(n, seed, task="add0"):
    return [("iter", "synthetic_lm"), ("num_inst", str(n)),
            ("vocab_size", "32"), ("seq_len", str(SEQ)),
            ("seed_data", str(seed)), ("lm_task", task)]


@functools.lru_cache(maxsize=None)
def _batches():
    pairs = [("batch_size", str(BATCH))] + _lm_section(BATCH * STEPS, 11)
    return list(create_iterator(pairs))


@pytest.mark.parametrize("task", ["add0", "copy"])
def test_synthetic_lm_is_bit_equal_to_the_jax_iterator(task):
    pairs = [("batch_size", "6")] + _lm_section(20, 5, task)
    ours, ref = list(create_iterator(pairs)), list(jax_create_iterator(pairs))
    assert len(ours) == len(ref) == 4
    for a, b in zip(ours, ref):
        assert a.num_batch_padd == b.num_batch_padd
        np.testing.assert_array_equal(a.data, b.data)
        np.testing.assert_array_equal(a.label, b.label)
        np.testing.assert_array_equal(a.inst_index, b.inst_index)
    assert ours[0].data.shape == (6, 1, 1, SEQ)
    assert ours[-1].num_batch_padd == 4


def test_seq_error_equals_the_jax_metric():
    rs = np.random.RandomState(4)
    logp = np.log(rs.dirichlet(np.ones(7), size=(10, 5))).astype(np.float32)
    pred = logp.reshape(10, 5 * 7)
    label = rs.randint(0, 7, (10, 5)).astype(np.float32)
    label[:, 0] = logp[:, 0].argmax(-1)            # some hits
    got, want = MetricSet(), JaxMetricSet()
    for m in (got, want):
        m.add("seq_error")
        for lo in (0, 6):
            m.add_eval({None: pred[lo:lo + 6]}, {None: label[lo:lo + 6]},
                       {"label": (0, 5)})
    assert got.get("train") == want.get("train")
    assert 0.0 < got.get("train")[0][1] < 1.0


def _np_tree(t):
    return jax.tree_util.tree_map(lambda a: np.array(a), t)


def _jax_args(tr, batch, epoch):
    sched = {tag: (jnp.float32(lr), jnp.float32(m))
             for tag, (lr, m) in tr.optimizer.schedules(epoch).items()}
    mask = np.ones((batch.batch_size,), np.float32)
    return (tr.params, tr.opt_state, tr.net_state, {},
            jnp.asarray(batch.data), jnp.asarray(batch.label),
            jnp.asarray(mask), (), jax.random.PRNGKey(0), sched)


@functools.lru_cache(maxsize=None)
def _jax_run():
    """The JAX trainer's init weights, and its losses and (params, opt)
    after each of STEPS steps."""
    tr = JaxTrainer(_cfg())
    tr.init_model()
    assert tr.net.remat
    init = (_np_tree(tr.params), _np_tree(tr.net_state))
    args = _jax_args(tr, _batches()[0], 0)
    jitted = tr._make_train_step(True)
    jaxpr = str(jax.make_jaxpr(jitted)(*args))
    # per block: the flash forward (twice, under remat) and its dq and
    # dk/dv kernels; one Adam apply per tag group
    assert jaxpr.count("pallas_call") >= 2 * 4 + 2, jaxpr.count("pallas_call")
    step = jitted.lower(*args).compile()
    losses, snaps = [], []
    for i, b in enumerate(_batches()):
        (tr.params, tr.opt_state, tr.net_state, _, loss, _,
         _) = step(*_jax_args(tr, b, i))
        losses.append(float(loss))
        snaps.append((_np_tree(tr.params), _np_tree(tr.opt_state)))
    return init, losses, snaps


def _paths(tree):
    return dict(leaves(tree))


def _adam_step_bound(lr, t, d1, d2):
    """The most Adam step t moves an element: lr times the
    Cauchy-Schwarz bound of |m1_hat| / sqrt(m2_hat) over the moments'
    weights of each gradient (1 at t = 1)."""
    i = np.arange(1, t + 1)
    a = d1 * (1 - d1) ** (t - i) / (1 - (1 - d1) ** t)
    b = d2 * (1 - d2) ** (t - i) / (1 - (1 - d2) ** t)
    return lr * float(np.sqrt(np.sum(a * a / b)))


def _is_k_bias(path):
    return len(path) == 3 and path[1:] == ("k", "bias")


def test_tiny_lm_trains_like_the_jax_trainer():
    init, want_losses, snaps = _jax_run()
    tr = Trainer(_cfg())
    tr.init_model(init)
    assert tr.net.remat and tr.optimizer.type == "adam"
    w0 = _paths(init[0])
    lr = tr.optimizer.hypers["bias"].base_lr
    k_bias = [p for p in w0 if _is_k_bias(p)]
    assert len(k_bias) == 2
    for i, b in enumerate(_batches()):
        tr.update(b)
        assert abs(tr.last_loss - want_losses[i]) <= 1e-5 * abs(
            want_losses[i]), (i, tr.last_loss, want_losses[i])
        got_p, _ = params_to_jax(tr.params, {})
        got_o = opt_to_jax(tr.opt_state)
        want_p, want_o = snaps[i]
        assert int(got_o["t"]) == int(want_o["t"]) == i + 1
        # the k bias: at most one Adam step's bound per step, both packages
        drift = sum(_adam_step_bound(lr, t, 0.1, 0.001)
                    for t in range(1, i + 2))
        for p in k_bias:
            for tree in (got_p, want_p):
                d = np.abs(_paths(tree)[p] - w0[p]).max()
                assert d <= drift * (1 + 1e-3), (p, d, drift)
        for name, got, want, base in (
                ("params", got_p, want_p, w0),
                ("m1", got_o["m1"], want_o["m1"], None),
                ("m2", got_o["m2"], want_o["m2"], None)):
            g, w = _paths(got), _paths(want)
            assert set(g) == set(w) == set(w0)
            for p in w:
                if _is_k_bias(p):
                    continue
                b0 = 0.0 if base is None else base[p]
                rel = np.linalg.norm((g[p] - b0) - (w[p] - b0)) / max(
                    np.linalg.norm(w[p] - b0), 1e-30)
                assert rel <= 1e-4, (i, name, p, rel)


def test_port_adam_round_resumes_in_the_jax_package(tmp_path, capsys):
    """The port's task driver trains one round and writes 0000.model with
    Adam's state; the JAX task driver resumes it with continue = 1, and
    the JAX trainer's next step from it agrees with the port's."""
    conf = tmp_path / "lm.conf"
    conf.write_text(open(TINY).read().replace("num_inst = 2048",
                                              "num_inst = 16")
                    .replace("num_inst = 512", "num_inst = 8"))
    model_dir = tmp_path / "models"
    common = ["num_round=1", f"model_dir={model_dir}", "print_step=0",
              f"batch_size={BATCH}", "attn_impl=flash", "attn_block=32",
              "remat=1"]
    port_main.main([str(conf), "dev=cpu:0", *common])
    out = capsys.readouterr().out
    assert "round        0:" in out and "train-seq_error:" in out
    path = str(model_dir / "0000.model")
    blob = jax_ckpt.load_model(path)
    assert blob["meta"]["has_opt"] and blob["meta"]["epoch"] == 2
    assert set(blob["opt"]) == {"m1", "m2", "t"}
    assert blob["opt"]["t"].dtype == np.int32 and int(blob["opt"]["t"]) == 2
    assert set(_paths(blob["opt"]["m1"])) == set(_paths(blob["params"]))
    assert blob["params"]["attn1"]["q"]["wmat"].shape == (64, 4, 16)
    # the JAX task driver resumes the round
    jax_main.main([str(conf), "continue=1", "num_round=2", "dev=cpu:0",
                   *common[1:]])
    out = capsys.readouterr().out
    assert "continuing from round 0" in out and "round        1:" in out
    assert os.path.exists(model_dir / "0001.model")
    # the next step from the port's round, in both packages
    batch = _batches()[0]
    jtr = JaxTrainer(_cfg())
    jtr.init_model()
    jtr.load_model(path)
    jargs = _jax_args(jtr, batch, jtr.epoch_counter)
    (jtr.params, jtr.opt_state, _, _, want_loss, _,
     _) = jtr._make_train_step(True)(*jargs)
    tr = Trainer(_cfg())
    tr.load_blob(ckpt.load_model(path))
    assert tr.epoch_counter == 2 and int(tr.opt_state["t"]) == 2
    tr.update(batch)
    assert abs(tr.last_loss - float(want_loss)) <= 1e-5 * abs(
        float(want_loss))
    got, want = _paths(params_to_jax(tr.params, {})[0]), _paths(
        _np_tree(jtr.params))
    before = _paths(blob["params"])
    for p in want:
        if _is_k_bias(p):
            continue
        rel = np.linalg.norm(got[p] - want[p]) / max(
            np.linalg.norm(want[p] - before[p]), 1e-30)
        assert rel <= 1e-4, (p, rel)


def test_lm_keys_outside_the_slice_name_their_roadmap_item():
    """moe waits for the experts item; sequence parallelism (the ring and
    gather-kv attention) for model parallelism."""
    from cxxnet_tpu_torch.graph import build_graph
    from cxxnet_tpu_torch.model import Network
    moe = parse_config_string(
        "netconfig = start\nlayer[+1:e] = embed:em\n  nhidden = 8\n"
        "  vocab_size = 4\nlayer[+1:m] = moe:mx\nnetconfig = end\n"
        "input_shape = 1,1,8\n")
    with pytest.raises(NotImplementedError, match="Queue A 8, experts"):
        Network(build_graph(moe), moe, device="cpu")
    with pytest.raises(ConfigError, match="Queue A 9"):
        Trainer(_cfg() + [("seq_parallel", "2")])


def test_nested_parameter_trees_walk_an_mha_tree():
    """mha's tree is three levels deep: the leaf walk, the weight loader
    and the trainer's gradient tree keep its layout, and tags come from
    the last key (``attn1/k/bias`` is in the bias group)."""
    from cxxnet_tpu_torch.optim import unflatten
    tr = Trainer(_cfg())
    tr.init_model()
    flat = leaves(tr.params)
    paths = [p for p, _ in flat]
    assert ("attn1", "k", "bias") in paths and ("ffn1", "h", "wmat") in paths
    assert tr.params["attn1"]["q"]["wmat"].shape == (64, 4, 16)
    assert tr.params["attn1"]["o"]["wmat"].shape == (4, 16, 64)
    assert leaves(unflatten(flat)) == flat
    groups = tr.optimizer._groups(tr.params)
    assert ("attn1", "k", "bias") in groups["bias"]
    assert ("attn1", "q", "wmat") in groups["wmat"]
    _, _, _, grads = tr.gradients(_batches()[0])
    assert [p for p, _ in leaves(grads)] == paths
    bad = params_to_jax(tr.params, {})[0]
    bad["attn1"]["q"]["wmat"] = bad["attn1"]["q"]["wmat"][:, :2]
    with pytest.raises(ValueError, match="attn1/q/wmat"):
        tr.net.load_weights(*params_from_jax(bad, {}))
