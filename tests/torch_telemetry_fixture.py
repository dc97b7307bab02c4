"""Shared run of the telemetry tests (``test_torch_telemetry.py``,
``test_torch_sentinel.py``): one narrow training run of each package on
the same round and the same data, with the run ledger and the trace on.

The net is a LeNet at narrow width (conv 3x3 over 12x12, max pool,
fullc, relu, fullc, softmax) on ``iter = synthetic`` (4 batches of 16 a
round). Round 0 is written once by the port's writer from numpy weights
and copied into each package's ``model_dir``; each package then trains
rounds 1 and 2 with ``continue = 1`` and ``failpoints =
device.step=every:5``: the fifth step (round 2's first) poisons the
masters and the loss with NaN. Neither run sets ``sentinel`` or
``telemetry_steptime``, so both the loss sentinel and the step-time
probe run at their defaults: the sentinel reads the loss at step 7
(``sentinel_interval = 8`` ticks, one tick a step plus one forced tick a
round) and rolls back to round 1. Each run is made once a process.
"""

import contextlib
import functools
import io
import json
import os
import shutil
import tempfile

import numpy as np
import torch

LENET = """
data = train
iter = synthetic
  num_inst = 64
  num_class = 4
  input_shape = 1,12,12
  seed_data = 3
iter = end
eval = test
iter = synthetic
  num_inst = 32
  num_class = 4
  input_shape = 1,12,12
  seed_data = 9
iter = end
netconfig = start
layer[0->1] = conv:cv1
  kernel_size = 3
  pad = 1
  stride = 1
  nchannel = 4
  random_type = xavier
layer[1->2] = max_pooling:mp1
  kernel_size = 2
  stride = 2
layer[2->3] = flatten:fl
layer[3->4] = fullc:fc1
  nhidden = 16
  random_type = xavier
layer[4->5] = relu
layer[5->6] = fullc:fc2
  nhidden = 4
  random_type = xavier
layer[6->6] = softmax
netconfig = end
input_shape = 1,12,12
batch_size = 16
dev = cpu
eta = 0.1
momentum = 0.9
metric = error
num_round = 3
continue = 1
"""

#: the injected fault: the fifth step of the run (round 2's first)
FAULT = "device.step=every:5"


def write_round0(model_dir: str) -> None:
    """Round 0 of the LeNet from numpy weights (seed 0), by the port's
    writer (the JAX package's format), with an SGD momentum of zeros."""
    from cxxnet_tpu_torch import checkpoint as ckpt
    from cxxnet_tpu_torch.config import parse_config_string
    from cxxnet_tpu_torch.convert import params_to_jax
    from cxxnet_tpu_torch.graph import build_graph
    from cxxnet_tpu_torch.model import Network
    cfg = parse_config_string(LENET)
    net = Network(build_graph(cfg), cfg)
    shapes, state = params_to_jax(*net.init(torch.Generator()))
    rs = np.random.RandomState(0)
    params = {layer: {leaf: (rs.standard_normal(a.shape) * 0.3
                             ).astype(np.float32) if leaf == "wmat"
                      else np.zeros(a.shape, np.float32)
                      for leaf, a in leaves.items()}
              for layer, leaves in shapes.items()}
    mom = {layer: {leaf: np.zeros_like(a) for leaf, a in leaves.items()}
           for layer, leaves in params.items()}
    os.makedirs(model_dir, exist_ok=True)
    ckpt.save_model(ckpt.model_path(model_dir, 0),
                    structure_sig=net.graph.structure_signature(),
                    round_counter=0, epoch_counter=0, params=params,
                    net_state=state, opt_state={"mom": mom})


def _args(root: str, extra=()):
    conf = os.path.join(root, "lenet.conf")
    with open(conf, "w") as f:
        f.write(LENET)
    return [conf, f"model_dir={root}/models",
            f"telemetry_ledger={root}/ledger.jsonl",
            f"telemetry_trace={root}/trace.json",
            f"failpoints={FAULT}", *extra]


def _run(main, root: str):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(_args(root))
    return out.getvalue()


@functools.lru_cache(maxsize=None)
def paired_runs():
    """``{"jax": ..., "port": ...}``, each ``{"dir", "stdout", "ledger",
    "trace", "final"}``: the run's directory, its console, its ledger
    records, its trace document and the params of its last round (JAX
    layout, numpy)."""
    from cxxnet_tpu import main as jax_main
    from cxxnet_tpu.resilience import failpoints as jax_fp
    from cxxnet_tpu.telemetry.disttrace import DISTTRACE
    from cxxnet_tpu.telemetry.ledger import LEDGER as JAX_LEDGER
    from cxxnet_tpu.telemetry.trace import TRACER as JAX_TRACER
    from cxxnet_tpu_torch import checkpoint as ckpt
    from cxxnet_tpu_torch import main as port_main
    from cxxnet_tpu_torch.resilience import failpoints as port_fp
    base = tempfile.mkdtemp(prefix="cxxnet_tel_")
    src = os.path.join(base, "round0")
    write_round0(src)
    out = {}
    for name, main, fp in (("jax", jax_main.main, jax_fp),
                           ("port", port_main.main, port_fp)):
        root = os.path.join(base, name)
        shutil.copytree(src, os.path.join(root, "models"))
        fp.clear()
        try:
            stdout = _run(main, root)
        finally:
            fp.clear()
            if name == "jax":
                # the JAX session leaves its process-global tracers and
                # ledger on; later tests in this process must not write
                # into this run's files
                JAX_LEDGER.disable()
                JAX_TRACER.disable()
                JAX_TRACER.clear()
                DISTTRACE.disable()
        with open(os.path.join(root, "ledger.jsonl")) as f:
            ledger = [json.loads(line) for line in f]
        with open(os.path.join(root, "trace.json")) as f:
            trace = json.load(f)
        final = ckpt.load_model(ckpt.model_path(os.path.join(root,
                                                             "models"), 2))
        out[name] = {"dir": root, "stdout": stdout, "ledger": ledger,
                     "trace": trace, "final": final}
    return out
