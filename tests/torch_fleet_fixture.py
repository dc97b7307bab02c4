"""Shared setup of the fleet tests (``test_torch_fleet.py``,
``test_torch_reload.py``): the small fullc net of
``tests/test_serve_fleet.py``, seeded request rows, rounds written by
the port's checkpoint writer with weights drawn by numpy (distinct seeds
give distinct weights, so a reload shows in the answers), their int8
derivation by the port's PTQ, and pools of either package. No jax import
at module level: the port-only tests never start it.
"""

import numpy as np
import torch

from cxxnet_tpu_torch import checkpoint as ckpt
from cxxnet_tpu_torch.config import parse_config_string
from cxxnet_tpu_torch.convert import params_to_jax
from cxxnet_tpu_torch.graph import build_graph
from cxxnet_tpu_torch.model import Network
from cxxnet_tpu_torch.serve import ReplicaPool

NET_CFG = """
netconfig=start
layer[+1:h1] = fullc:fc1
  nhidden = 24
  random_type = xavier
layer[+1:a1] = relu
layer[a1->out] = fullc:fc2
  nhidden = 5
  random_type = xavier
layer[+0] = softmax
netconfig=end
input_shape = 1,1,16
batch_size = 32
"""
PORT_CFG = NET_CFG + "dev = cpu\n"
#: the fleet's bucket ladder in every test
KW = dict(buckets="2,4,8", max_batch=8, max_latency_ms=5)


def rows(n, seed=0):
    return np.random.RandomState(seed).randn(n, 16).astype(np.float32)


def port_net() -> Network:
    cfg = parse_config_string(PORT_CFG)
    return Network(build_graph(cfg), cfg)


def weights(seed: int):
    """JAX-layout (params, state) numpy trees of the net, from ``seed``."""
    net = port_net()
    shapes, _ = params_to_jax(*net.init(torch.Generator()))
    rs = np.random.RandomState(seed)
    params = {layer: {leaf: (rs.standard_normal(a.shape)
                             / np.sqrt(a.shape[0])).astype(np.float32)
                      for leaf, a in leaves.items()}
              for layer, leaves in shapes.items()}
    return params, {}


def save_round(model_dir, r: int, seed: int = 0, cfg: str = NET_CFG) -> str:
    """Round ``r`` of the net of ``cfg`` (the same widths) into
    ``model_dir``."""
    params, state = weights(seed)
    sig = build_graph(parse_config_string(cfg)).structure_signature()
    path = ckpt.model_path(str(model_dir), r)
    ckpt.save_model(path, structure_sig=sig, round_counter=r,
                    epoch_counter=0, params=params, net_state=state)
    return path


def save_int8_round(model_dir, r: int, seed: int = 0) -> str:
    """Round ``r`` quantized by the port's PTQ, calibrated over rows
    drawn as the tests serve them, written under the round's own name."""
    from cxxnet_tpu_torch.config import parse_quant_config
    from cxxnet_tpu_torch.quant import quantize_blob, write_quantized_round
    params, state = weights(seed)
    net = port_net()
    blob = {"params": params, "state": state,
            "meta": {"round": r, "epoch": 0}}
    calib = [rows(8, seed=100 + i).reshape(8, 1, 1, 16) for i in range(2)]
    qblob, qm = quantize_blob(net, blob, calib,
                              parse_quant_config([("quant_calib_batches",
                                                   "2")]))
    path = ckpt.model_path(str(model_dir), r)
    write_quantized_round(path, net.graph.structure_signature(), qblob, qm)
    return path


def port_pool(n=2, **kw):
    return ReplicaPool.build(PORT_CFG, n, **{**KW, **kw})


def jax_pool(n=2, **kw):
    import jax
    from cxxnet_tpu.serve import ReplicaPool as JaxPool
    return JaxPool.build(NET_CFG, n, devices=jax.devices()[:n],
                         **{**KW, **kw})
