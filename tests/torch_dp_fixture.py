"""Rank functions of the PyTorch port's data-parallel tests.

``cxxnet_tpu_torch.parallel.launch`` spawns one process per rank and
hands each the function by pickle, so the functions live in a module the
ranks import by name. This one imports torch and the port only (no jax):
each rank starts in a second or two. Inputs and results are numpy.
"""

import atexit
import fcntl
import os
import time

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


def _wait_for(path, what):
    deadline = time.monotonic() + 30
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {what} within 30 s")
        time.sleep(0.01)


def _hold_until_unlocked(lock_path, flag_path):
    """At rank 1's exit: say that it has raised, then wait until rank 0's
    process has ended (its lock is released when it exits)."""
    open(flag_path, "w").close()
    with open(lock_path, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)


def second_failure_exits_first_rank(dp, tmp):
    """Rank 1 raises first. Rank 0 raises after it, and its process ends
    before rank 1's: rank 1 stays alive at exit until rank 0's has ended.
    So the launcher sees rank 0's exit first, though rank 1 failed
    first. ``tmp`` is a directory both ranks share."""
    lock, held = os.path.join(tmp, "lock"), os.path.join(tmp, "held")
    raised = os.path.join(tmp, "rank1_raised")
    if dp.rank == 0:
        # a bare descriptor, never closed: the lock goes with the process
        fcntl.flock(os.open(lock, os.O_WRONLY | os.O_CREAT), fcntl.LOCK_EX)
        open(held, "w").close()
        _wait_for(raised, "failure of rank 1")
        raise ValueError("rank 0 fails second")
    _wait_for(held, "lock of rank 0")
    atexit.register(_hold_until_unlocked, lock, raised)
    raise ValueError("rank 1 fails first")


def train_step_rank(dp, cfg, weights, batches, chain=0):
    """One ``Trainer`` per rank over ``cfg`` (config text or pairs) from
    the JAX-layout ``weights``, one update per batch (global
    ``DataBatch`` objects), or with ``chain`` the batches in chains of
    that many (``update_chain_batches``). Returns the losses and, after
    the last step, the (params, optimizer state, layer state) trees in
    the JAX layout."""
    from cxxnet_tpu_torch.config import parse_config_string
    from cxxnet_tpu_torch.convert import opt_to_jax, params_to_jax
    from cxxnet_tpu_torch.trainer import Trainer
    tr = Trainer(parse_config_string(cfg) if isinstance(cfg, str)
                 else list(cfg), dp=dp)
    tr.init_model(weights)
    losses = []
    for i in range(0, len(batches), chain or 1):
        if chain:
            losses += tr.update_chain_batches(batches[i:i + chain]).tolist()
            continue
        tr.update(batches[i])
        losses.append(tr.last_loss)
    p, s = params_to_jax(tr.params, tr.net.state)
    return losses, (p, opt_to_jax(tr.opt_state), s)


def agree_latest_rank(dp, dirs):
    """The round ``continue = 1`` resumes, with this rank scanning
    ``dirs[dp.rank]``; the ranks check that they agree."""
    from cxxnet_tpu_torch.main import _agree_latest
    return _agree_latest(dirs[dp.rank], True, dp)[0]
