"""Task driver CLI of the PyTorch port: ``task = train`` and ``serve``.

    python -m cxxnet_tpu_torch.main <conf> [task=train] [key=value ...]
    python -m cxxnet_tpu_torch.main <conf> task=serve model_in=<round>.model \\
        [serve_port=8080 serve_max_batch=32 serve_buckets=1,8,32 ...]

The config file plus ``key=value`` overrides, as in
``python -m cxxnet_tpu.main``, on the device the config's ``dev`` names
(the card unless ``dev = cpu``).

``task = train`` (the default) trains from fresh weights for rounds
``start_counter`` .. ``num_round - 1`` (capped by ``max_round``) over the
``data = ...`` section, printing the JAX package's progress lines every
``print_step`` batches and its round line ``round N:[T sec]`` with the
train metrics and one fragment per ``eval = <name>`` section; every
``save_period`` rounds (``save_model = 1``) and at the end it writes
``<model_dir>/%04d.model`` with the optimizer state, a round the JAX
package loads and resumes.

With several cards in ``dev`` (``gpu:0-1``, ``gpu:0,2``) ``task = train``
runs data-parallel: one process per card (NCCL), the global
``batch_size`` split evenly, batch norm over the global batch, one
gradient all-reduce a step; rank 0 alone prints and writes rounds, and a
rank that fails fails the run (:mod:`cxxnet_tpu_torch.parallel`).

``task = serve``: iterator sections are never opened; the round named by
``model_in`` (a ``%04d.model`` written by either package) is served over
HTTP until SIGINT/SIGTERM. ``serve_dtype = int8`` serves a round
quantized by ``python -m cxxnet_tpu_torch.quant`` (or the JAX package's
``tools/quantize.py``) as version ``rNNNN-int8``; an fp engine serves a
quantized round dequantized.

The iterator sections read ``synthetic``, ``synthetic_lm``, ``mnist``
and ``imgrec`` record files (PNG everywhere, JPEG where libjpeg is
installed), optionally wrapped by ``iter = threadbuffer``, as the
ImageNet configs of ``examples/ImageNet/`` have them; an imgrec section
that resolves ``device_normalize`` to 1 feeds uint8 batches that the
train step normalizes on the card (the input fold). The chains' threads
are stopped when the task ends.

The other tasks (finetune, pred, pred_raw, extract, get_weight) wait for
later slices (ROADMAP Queue A 2 and A 3).
"""

from __future__ import annotations

import argparse
import os
import sys
import threading
import time
from typing import Any, Callable, List, Optional, Sequence

import torch

from . import checkpoint as ckpt
from .config import (ConfigError, ConfigPairs, parse_cli_overrides,
                     parse_config_file, parse_serve_config, split_sections)
from .convert import params_from_jax
from .graph import build_graph, global_param
from .device import resolve_devices
from .model import Network
from .io import close_chain, create_iterator
from .parallel import DpContext, launch
from .serve import InferenceEngine, ServeServer
from .serve.engine import negotiate_blob, version_name
from .trainer import Trainer


def task_serve(cfg: ConfigPairs,
               ready: Optional[Callable[[ServeServer], None]] = None) -> None:
    """Build the network, load ``model_in``, and serve until interrupted
    (or until ``stop()`` on the server that ``ready`` is handed once it
    listens). The single-engine path of the JAX package's serve task."""
    gp = lambda n, d: global_param(cfg, n, d)
    sc = parse_serve_config(cfg)
    silent = bool(int(gp("silent", "0")))
    if int(gp("continue", "0")):
        raise ConfigError(
            "continue = 1: the PyTorch port serves the round named by "
            "model_in; the resume scan comes with resumed training "
            "(ROADMAP Queue A 3, still queued: continue = 1 and finetune)")
    # float32 policies compute in full float32 (no TF32 in cuDNN convs
    # or cuBLAS matmuls), as the JAX package's float32 does on the CPU;
    # bfloat16 / float16 policies are unaffected
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    graph = build_graph(cfg)
    net = Network(graph, cfg)
    model_in = gp("model_in", "NULL")
    blob = None
    if model_in != "NULL":
        blob = ckpt.load_for_inference(model_in)
        ckpt.check_structure(blob["meta"], graph.structure_signature())
        # dtype negotiation: serve_dtype = int8 demands a PTQ-derived
        # round; an fp engine dequantizes a quantized one on load
        placed = negotiate_blob(blob, sc.dtype or None)
        net.load_weights(*params_from_jax(placed["params"],
                                          placed["state"]))
        if not silent:
            print(f"serving model {model_in}", flush=True)
    else:
        if not silent:
            print("serve: no model_in given — serving a RANDOMLY "
                  "INITIALIZED model (smoke mode)", flush=True)
        net.load_weights(*net.init(torch.Generator().manual_seed(0)))
    engine = InferenceEngine(net, buckets=sc.buckets or None,
                             max_batch=sc.max_batch,
                             cache_size=sc.cache_size,
                             dtype=sc.dtype or None)
    if blob is not None:
        engine.weights_digest = ckpt.blob_digest(blob["meta"])
        engine.weights_version = version_name(blob["meta"]["round"]) \
            + ("-int8" if engine.serve_int8 else "")
    srv = ServeServer(
        engine, port=sc.port, host=sc.host,
        max_latency_ms=sc.max_latency_ms, max_queue_rows=sc.queue_rows,
        default_timeout_ms=sc.timeout_ms or None,
        log_interval_s=sc.log_interval_s,
        breaker_threshold=sc.breaker_threshold,
        breaker_reset_s=sc.breaker_reset_s,
        degraded_queue_frac=sc.degraded_queue_frac, silent=silent,
        handle_signals=threading.current_thread() is threading.main_thread())
    srv.start()
    if ready is not None:
        ready(srv)
    srv.serve_until_interrupt()


def _train_rounds(tr: Trainer, gp, itr_train, evals) -> int:
    """The JAX package's round loop (main.py:1023-1167, its single-device
    and dp parts; under dp every rank runs it, rank 0 alone prints);
    returns the last round run."""
    start = time.time()
    start_counter = int(gp("start_counter", "0"))
    num_round = int(gp("num_round", "10"))
    max_round = int(gp("max_round", "0"))
    print_step = int(gp("print_step", "100"))
    save_period = int(gp("save_period", "1"))
    save_model = int(gp("save_model", "1"))
    model_dir = gp("model_dir", "./models")
    silent = int(gp("silent", "0")) or (tr.dp is not None
                                        and not tr.dp.is_main)
    end_round = num_round
    if max_round > 0:
        end_round = min(end_round, start_counter + max_round)
    for r in range(start_counter, end_round):
        tr.start_round(r)
        batch_count = n_images = 0
        round_start = time.time()
        for batch in itr_train:
            tr.update(batch)
            n_images += batch.batch_size - batch.num_batch_padd
            batch_count += 1
            if print_step and batch_count % print_step == 0 and not silent:
                ips = n_images / max(time.time() - round_start, 1e-9)
                print(f"round {r:8d}:[{batch_count:8d}] "
                      f"{int(time.time() - start)} sec elapsed, "
                      f"loss={tr.last_loss:.6f}, {ips:.1f} images/sec",
                      flush=True)
        line = f"round {r:8d}:[{int(time.time() - start)} sec]"
        if tr.eval_train:
            line += tr.train_metric_report("train")
        for name, itr in evals:
            line += tr.evaluate(itr, name)
        if not silent:
            print(line, flush=True)
        if save_model and save_period and (r + 1) % save_period == 0:
            tr.save_model(ckpt.model_path(model_dir, r))
    return end_round - 1


def task_train(cfg: ConfigPairs, sections,
               ready: Optional[Callable[[Trainer], None]] = None,
               dp: Optional[DpContext] = None) -> Trainer:
    """Train from fresh weights over the ``data`` section, evaluating on
    each ``eval`` section after every round; ``ready`` is handed the
    initialized trainer before the first step. Under ``dp`` this is one
    rank's part of a data-parallel run. Returns the trainer."""
    gp = lambda n, d: global_param(cfg, n, d)
    # float32 policies compute in full float32 (no TF32 in cuDNN convs
    # or cuBLAS matmuls), as the JAX package's float32 does on the CPU
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    tr = Trainer(cfg, dp=dp)
    data = [pairs for kind, _, pairs in sections if kind == "data"]
    if not data:
        raise ConfigError("no training data section (data = ...) in config")
    chains = [create_iterator(cfg + data[0])]
    try:
        evals = []
        for kind, name, pairs in sections:
            if kind == "eval":
                chains.append(create_iterator(cfg + pairs))
                evals.append((name, chains[-1]))
        model_dir = gp("model_dir", "./models")
        save_model = int(gp("save_model", "1"))
        if save_model:
            os.makedirs(model_dir, exist_ok=True)
        tr.init_model()
        if ready is not None:
            ready(tr)
        last = _train_rounds(tr, gp, chains[0], evals)
        final = ckpt.model_path(model_dir, last)
        if save_model and last >= 0 and not os.path.exists(final):
            tr.save_model(final)
    finally:
        for it in chains:
            close_chain(it)
    return tr


def _train_worker(dp: DpContext, cfg: ConfigPairs, sections,
                  ready: Optional[Callable[[Trainer], None]]) -> None:
    """One rank of a data-parallel ``task = train`` (spawned by
    :func:`task_train_dp`)."""
    task_train(cfg, sections, ready, dp=dp)


def task_train_dp(cfg: ConfigPairs, sections, devices: Sequence[Any],
                  ready: Optional[Callable[[Trainer], None]] = None,
                  backend: Optional[str] = None) -> None:
    """Data-parallel ``task = train``: one rank per entry of ``devices``
    (``parallel.launch``), each running :func:`task_train` on its rows of
    every global batch. On the card the kernels are built here first, so
    every rank loads the same libraries. ``ready`` (a module-level
    function, as it crosses to the ranks by pickle) is handed each
    rank's trainer before its first step. Raises with the traceback of a
    rank that fails."""
    if any(torch.device(d).type == "cuda" for d in devices):
        from .ops import KERNELS, _build
        _build.build(sorted({k.source for k in KERNELS.values()}))
    launch(_train_worker, (cfg, sections, ready), devices=devices,
           backend=backend)


def run(cfg: ConfigPairs, ready: Optional[Callable] = None,
        devices: Optional[Sequence[Any]] = None,
        backend: Optional[str] = None):
    """Dispatch on ``task`` over the global settings. ``ready`` is handed
    the listening server (serve) or the initialized trainer (train);
    single-device train returns its :class:`Trainer`. ``devices`` and
    ``backend`` override, for training, the ranks that ``dev`` names and
    the collective backend (``parallel.launch``): tests run two CPU
    ranks over gloo with ``dev = cpu`` and ``devices=("cpu", "cpu")``,
    and two ranks can share one card with ``backend="gloo"``."""
    global_cfg, sections = split_sections(cfg)
    task = global_param(global_cfg, "task", "train")
    if task == "train":
        if devices is None:
            devices = resolve_devices(global_param(global_cfg, "dev", ""))
        if len(devices) > 1:
            task_train_dp(global_cfg, sections, devices, ready, backend)
            return None
        return task_train(global_cfg, sections, ready)
    if task != "serve":
        raise ConfigError(
            f"task = {task}: the PyTorch port runs task = train and serve "
            "only so far (pred / pred_raw / extract / get_weight: ROADMAP "
            "Queue A 2; finetune: Queue A 3, still queued: continue = 1 "
            "and finetune)")
    task_serve(global_cfg, ready)
    return None


def main(argv: Optional[List[str]] = None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    ap = argparse.ArgumentParser(
        prog="cxxnet_tpu_torch",
        description="cxxnet task driver, PyTorch/CUDA port "
                    "(task=train|serve)")
    ap.add_argument("config", help="config file (key=value dialect)")
    ap.add_argument("overrides", nargs="*", help="key=value overrides")
    args = ap.parse_args(argv)
    run(parse_config_file(args.config) + parse_cli_overrides(args.overrides))
    return 0


if __name__ == "__main__":
    sys.exit(main())
