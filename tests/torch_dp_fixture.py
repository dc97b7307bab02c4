"""Rank functions of the PyTorch port's data-parallel tests.

``cxxnet_tpu_torch.parallel.launch`` spawns one process per rank and
hands each the function by pickle, so the functions live in a module the
ranks import by name. This one imports torch and the port only (no jax):
each rank starts in a second or two. Inputs and results are numpy.
"""

import numpy as np
import torch


def _np(t):
    return t.detach().float().numpy()


def sync_bn_rank(dp, cases):
    """Each case ``(x, gamma, beta, dy, eps, act, dtype, fused)`` (x, dy
    the global batch, NHWC or flat): this rank's rows through
    ``sync_bn_act`` and backward with upstream ``dy``. Returns per case
    ``(y rows, mean, var, dx rows, dgamma, dbeta)``, the gradients of
    gamma and beta the rank's own."""
    from cxxnet_tpu_torch.ops.fused_norm import sync_bn_act
    out = []
    for x, gamma, beta, dy, eps, act, dtype, fused in cases:
        rows = dp.rows(x.shape[0])
        dt = getattr(torch, dtype)
        xt = torch.from_numpy(x[rows]).to(dt).requires_grad_(True)
        g = torch.from_numpy(gamma).requires_grad_(True)
        b = torch.from_numpy(beta).requires_grad_(True)
        y, mean, var = sync_bn_act(xt, g, b, eps, act, dp, fused)
        dx, dg, db = torch.autograd.grad(
            y, [xt, g, b], torch.from_numpy(dy[rows]).to(dt))
        out.append((_np(y), _np(mean), _np(var), _np(dx), _np(dg), _np(db)))
    return out


def raising_rank(dp):
    """Rank 1 raises at once; rank 0 waits for it in an all-reduce."""
    if dp.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    dp.all_reduce(torch.zeros(4))
    return "rank 0 was not stopped"


def train_step_rank(dp, cfg, weights, batches):
    """One ``Trainer`` per rank over ``cfg`` (config text or pairs) from
    the JAX-layout ``weights``, one update per batch (global
    ``DataBatch`` objects). Returns the losses and, after the last step,
    the (params, momenta, layer state) trees in the JAX layout."""
    from cxxnet_tpu_torch.config import parse_config_string
    from cxxnet_tpu_torch.convert import opt_to_jax, params_to_jax
    from cxxnet_tpu_torch.trainer import Trainer
    tr = Trainer(parse_config_string(cfg) if isinstance(cfg, str)
                 else list(cfg), dp=dp)
    tr.init_model(weights)
    losses = []
    for b in batches:
        tr.update(b)
        losses.append(tr.last_loss)
    p, s = params_to_jax(tr.params, tr.net.state)
    return losses, (p, opt_to_jax(tr.opt_state), s)
