"""Task driver CLI of the PyTorch port: ``task = train``, ``finetune``,
``pred``, ``pred_raw``, ``extract`` (``extract_feature``),
``get_weight``, ``serve`` and ``data_reader``.

    python -m cxxnet_tpu_torch.main <conf> [task=train] [key=value ...]
    python -m cxxnet_tpu_torch.main <conf> task=pred_raw model_in=<round>.model
    python -m cxxnet_tpu_torch.main <conf> task=serve model_in=<round>.model \\
        [serve_port=8080 serve_max_batch=32 serve_buckets=1,8,32 ...]

The config file plus ``key=value`` overrides, as in
``python -m cxxnet_tpu.main``, on the device the config's ``dev`` names
(the card unless ``dev = cpu``).

``task = train`` (the default) trains for rounds ``start_counter`` ..
``num_round - 1`` (capped by ``max_round``) over the
``data = ...`` section, printing the JAX package's progress lines every
``print_step`` batches and its round line ``round N:[T sec]`` with the
train metrics and one fragment per ``eval = <name>`` section; every
``save_period`` rounds (``save_model = 1``) and at the end it writes
``<model_dir>/%04d.model`` with the optimizer state, a round the JAX
package loads and resumes. ``train_chain = k`` queues k batches at a
time as one chain (``Trainer.update_chain_batches``); ``update_period``
and ``compute_dtype = float16`` (the loss scaler) are the trainer's. The weights come from the first of: with
``continue = 1``, the newest round of ``model_dir`` that verifies (torn
rounds skipped; params, optimizer state and counters restored, training
goes on at the round after it); the round named by ``model_in``
(training goes on at the round after it); fresh weights drawn from
``seed``. ``task = finetune`` trains the same way, but takes from
``model_in`` only the layers whose name and shapes match the net, which
keeps its fresh draw elsewhere, and starts at ``start_counter``.

With several cards in ``dev`` (``gpu:0-1``, ``gpu:0,2``) ``task = train``
runs data-parallel: one process per card (NCCL), the global
``batch_size`` split evenly, batch norm over the global batch, one
gradient all-reduce a step; rank 0 alone prints and writes rounds, and a
rank that fails fails the run (:mod:`cxxnet_tpu_torch.parallel`).

``task = serve``: iterator sections are never opened; the newest valid
round of ``model_dir`` with ``continue = 1``, else the round named by
``model_in`` (a ``%04d.model`` written by either package), is served
over HTTP until SIGINT/SIGTERM. ``serve_dtype = int8`` serves a round
quantized by ``python -m cxxnet_tpu_torch.quant`` (or the JAX package's
``tools/quantize.py``) as version ``rNNNN-int8``; an fp engine serves a
quantized round dequantized. ``serve_replicas = N`` (or ``serve_reload_s``
or ``serve_ab``) serves a replica fleet (``serve/fleet.py``): the replicas
share the cards of ``dev`` round-robin, or take one card each; with
``serve_reload_s > 0`` new rounds in ``model_dir`` roll into it without
dropping a request, and ``serve_ab = 1`` reloads only the first
``serve_ab_replicas`` (``serve/reload.py``). ``deploy_enable = 1`` (two
replicas or more, no ``serve_reload_s``) puts the deployment controller
in the watcher's place: each new round is gated offline, canaried on
``deploy_canary_replicas``, and promoted or rolled back on the window's
evidence (``deploy/``). ``cascade_enable = 1`` with ``cascade_model =
<quantized round>`` serves the two-tier cascade: ``cascade_replicas``
int8 replicas answer first, and the rows under ``cascade_threshold``
escalate to the ``serve_replicas`` flagship replicas of the round
(``serve/cascade.py``).

Telemetry and fault tolerance (``telemetry/``, ``resilience/``), the
JAX package's plane: ``telemetry_trace`` (with distributed tracing:
``telemetry_trace_sample``, ``telemetry_trace_tail_pct``, the W3C
``traceparent`` over the serve HTTP and the data-service wire, dumps
that ``tools/trace_assemble.py`` merges), ``telemetry_port`` (``GET
/metrics``), ``telemetry_log``, ``telemetry_ledger``,
``telemetry_fleet_dir`` (the host's snapshot pushed there; host 0's
``/metrics`` serves the merged fleet and its round line names
stragglers), ``telemetry_hang_s`` (the hang watchdog's ``hang_dump``),
the recompile-storm detector, ``telemetry_profile_steps`` (the round
log prints the bracket's per-phase attribution line) and
``profile_dir`` (``torch.profiler``), the step-time probe
(``telemetry_steptime = 1`` and ``telemetry_sync_interval``, on by
default: each round line gains ``data_ms``, ``dispatch_ms``,
``device_ms`` and ``bound``), model health (``health = 1`` and the
``health_*`` keys: per-layer statistics on the device, read once a
``health_interval``, ``grad_norm`` and ``dead_max`` in the round line,
the ``cxxnet_health_*`` gauges, the NaN provenance of a sentinel trip),
the loss sentinel (``sentinel = 1``, on by default: a NaN/Inf loss or a
spike rolls back to the newest valid round with the LR scaled by
``lr_backoff``, and past ``max_rollbacks`` the run aborts) and
``failpoints``. The ledger's incidents replay with ``python -m
cxxnet_tpu_torch.replay``. ``task = serve`` builds the same session for
``telemetry_port``, ``telemetry_ledger``, ``telemetry_trace`` and
``telemetry_log``; the server itself answers ``GET /metrics``.

The iterator sections read ``synthetic``, ``synthetic_lm``, ``mnist``,
``csv``, ``imgrec`` record files and BinaryPage packs (PNG everywhere,
JPEG through nvJPEG on the card and libjpeg where it is installed) and
image files (``img``), optionally wrapped by ``threadbuffer``,
``throttle`` and ``membuffer``, as the ImageNet configs of
``examples/ImageNet/`` have them; an imgrec section that resolves
``device_normalize`` to 1 feeds uint8 batches that the train step
normalizes on the card (the input fold). Every data, model and output
path may be a ``scheme://`` URL (``io/stream.py``, retried under the
``io_retry_*`` keys). The chains' threads are stopped when the task
ends. ``test_io = 1`` runs the train section's input and skips the
update, printing ``round N: test_io <n> images in <s> sec = <r>
images/sec`` a round.

The input data service (``data_service/``): ``task = data_reader``
serves the ``data = train`` section's batches for shards of the records
over TCP until SIGINT/SIGTERM (``data_service = host:port[,...]`` names
the fleet, ``data_service_reader`` this reader's place in it); a ``task =
train`` or ``finetune`` run with ``data_service`` set reads its train
section from the fleet (``data_service = local``: the same stream in
this process), failing over between readers and degrading once to the
local pipeline when none answers. Evaluation and the batch tasks read
their sections locally.

The batch tasks run on one device over the ``pred = <file>`` section
(the ``data`` section when there is none) with the weights of
``continue = 1`` or ``model_in`` as above, through the eval forward, and
write ``name_pred`` (default: the pred section's file name, else
``pred.txt``): ``pred`` one class id a line, ``pred_raw`` one row of the
top node a line, ``extract`` the rows of ``extract_node_name`` (default
``top``) with a ``.meta`` sidecar ``nrow,c,y,x``, and ``get_weight`` the
weight ``weight_name`` (default ``wmat``) of ``extract_layer_name``,
in the JAX package's layout, as rows of its first axis, to
``weight_filename`` (default ``name_pred``) with a ``.meta`` of its
shape. ``output_format = txt`` (the default) writes ``%g`` values
separated by spaces; ``bin`` raw little-endian float32 (extract and
get_weight). The files are the JAX package's, byte for byte where the
values are.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import io
import os
import sys
import threading
import time
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch

from . import checkpoint as ckpt
from .config import (ConfigError, ConfigPairs, parse_cli_overrides,
                     parse_config_file, parse_data_service_config,
                     parse_quant_config, parse_retry_policy,
                     parse_serve_config, parse_telemetry_config,
                     split_sections)
from .data_service import DataReaderServer, build_service_iterator
from .deploy import DeployController, parse_deploy_config
from .graph import build_graph, global_param
from .device import resolve_devices
from .io import close_chain, create_iterator, stream
from .io.data import DataBatch
from .parallel import DpContext, launch
from .resilience import SentinelAbort, TrainingSentinel, counters, failpoints
from .serve import CascadeRouter, ReloadWatcher, ReplicaPool, ServeServer
from .serve.fleet import build_engines
from .telemetry import ProfileBracket, TelemetrySession
from .telemetry.disttrace import DISTTRACE, set_trace_identity
from .telemetry.modelhealth import HealthProbe, diagnose_nonfinite
from .telemetry.traceparse import attribute_profile, attribution_fragment
from .telemetry.ledger import (LEDGER, config_hash, new_run_id,
                               plan_config_snapshot)
from .telemetry.trace import NULL_SPAN, TRACER
from .trainer import Trainer


def task_serve(cfg: ConfigPairs,
               ready: Optional[Callable[[ServeServer], None]] = None) -> None:
    """Build the network, load the round, and serve until interrupted (or
    until ``stop()`` on the server that ``ready`` is handed once it
    listens). One engine by default; any fleet knob (``serve_replicas >
    1``, ``serve_reload_s``, ``serve_ab``) builds a replica pool, with the
    hot-reload watcher on ``model_dir`` when ``serve_reload_s > 0``, or
    the deployment controller with ``deploy_enable = 1``;
    ``cascade_enable = 1`` builds the two-tier cascade over the round
    (the flagship tier) and ``cascade_model`` (the int8 tier): the JAX
    package's serve task, with its refusals of what does not compose."""
    gp = lambda n, d: global_param(cfg, n, d)
    sc = parse_serve_config(cfg)
    dc = parse_deploy_config(cfg)
    qc = parse_quant_config(cfg)
    if qc.cascade_enable:
        if dc.enable or sc.reload_s > 0:
            raise ConfigError(
                "cascade_enable = 1 does not compose with "
                "deploy_enable/serve_reload_s yet: the cascade "
                "tiers pin their versions, a reload would swap "
                "them out from under the router")
        if not qc.cascade_model:
            raise ConfigError(
                "cascade_enable = 1 needs cascade_model = <path to "
                "a quantized round> (tools/quantize.py derives one)")
    if dc.enable:
        # the controller owns canary reloads end to end: a plain reload
        # watcher racing it would ship ungated rounds
        if sc.replicas < 2:
            raise ConfigError(
                "deploy_enable = 1 needs a replica fleet "
                f"(serve_replicas >= 2, got {sc.replicas}): one "
                "canary plus at least one incumbent")
        if sc.reload_s > 0:
            raise ConfigError(
                "deploy_enable = 1 replaces serve_reload_s: the "
                "deployment controller decides what reloads (set "
                "serve_reload_s = 0 and use deploy_poll_s)")
        if dc.canary_replicas >= sc.replicas:
            raise ConfigError(
                f"deploy_canary_replicas ({dc.canary_replicas}) "
                f"must be < serve_replicas ({sc.replicas}): the "
                "parity gate compares against a live incumbent")
    silent = bool(int(gp("silent", "0")))
    # float32 policies compute in full float32 (no TF32 in cuDNN convs
    # or cuBLAS matmuls), as the JAX package's float32 does on the CPU;
    # bfloat16 / float16 policies are unaffected
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    graph = build_graph(cfg)
    model_in = gp("model_in", "NULL")
    model_dir = gp("model_dir", "./models")
    # the newest valid round with continue = 1 (its blob read once, by
    # the scan), else model_in, else random weights; the blob is read
    # once for a whole fleet
    model_path = blob = None
    if int(gp("continue", "0")):
        latest = _agree_latest(model_dir, silent, want_blob=True)
        if latest is not None:
            _, model_path, blob = latest
    if blob is None and model_in != "NULL":
        model_path, blob = model_in, ckpt.load_for_inference(model_in)
    if blob is not None:
        ckpt.check_structure(blob["meta"], graph.structure_signature())
        if not silent:
            print(f"serving model {model_path}", flush=True)
    elif not silent:
        print("serve: no model_in/continue given — serving a RANDOMLY "
              "INITIALIZED model (smoke mode)", flush=True)
    digest = ckpt.blob_digest(blob["meta"]) if blob is not None else ""
    cells = dict(buckets=sc.buckets or None, max_batch=sc.max_batch,
                 cache_size=sc.cache_size, silent=silent)
    knobs = dict(max_latency_ms=sc.max_latency_ms,
                 max_queue_rows=sc.queue_rows,
                 default_timeout_ms=sc.timeout_ms or None,
                 breaker_threshold=sc.breaker_threshold,
                 breaker_reset_s=sc.breaker_reset_s,
                 degraded_queue_frac=sc.degraded_queue_frac,
                 slo_ms=sc.slo_ms, slo_target=sc.slo_target,
                 slo_window_s=sc.slo_window_s,
                 slo_burn_degraded=sc.slo_burn_degraded)
    served = dict(port=sc.port, host=sc.host,
                  log_interval_s=sc.log_interval_s, silent=silent,
                  handle_signals=threading.current_thread()
                  is threading.main_thread())
    if qc.cascade_enable:
        # the flagship tier serves the round loaded above in serve_dtype,
        # the fast tier the quantized round of cascade_model in int8; the
        # router is a pool, so the server is unchanged
        if blob is None:
            raise ConfigError(
                "cascade_enable = 1 needs a flagship model "
                "(model_in or continue = 1)")
        fast_blob = ckpt.load_for_inference(qc.cascade_model)
        ckpt.check_structure(fast_blob["meta"], graph.structure_signature())
        pool = CascadeRouter.build_two_tier(
            cfg, flagship_blob=blob, flagship_digest=digest,
            fast_blob=fast_blob,
            fast_digest=ckpt.blob_digest(fast_blob["meta"]),
            qc=qc, n_flagship=sc.replicas, n_fast=qc.cascade_replicas,
            flagship_dtype=sc.dtype or None,
            admission_control=bool(sc.admission), **cells, **knobs)
        srv = ServeServer(pool=pool, **served)
    elif sc.fleet:
        # dtype negotiation happens once for every engine: serve_dtype =
        # int8 demands a PTQ-derived round, an fp engine dequantizes one
        pool = ReplicaPool.build(
            cfg, sc.replicas, blob=blob, digest=digest,
            dtype=sc.dtype or None, admission_control=bool(sc.admission),
            **cells, **knobs)
        if dc.enable:
            # the controller polls the round directory, gates each new
            # round offline, canaries it, and promotes or rolls back
            watcher = DeployController(pool, model_dir, dc,
                                       drain_timeout_s=sc.drain_timeout_s,
                                       verbose=not silent)
        elif sc.reload_s > 0:
            # hot reload watches the directory a trainer (this process
            # or another) keeps writing rounds into
            watcher = ReloadWatcher(
                pool, model_dir, interval_s=sc.reload_s,
                ab_replicas=sc.ab_replicas if sc.ab else 0,
                drain_timeout_s=sc.drain_timeout_s, verbose=not silent)
        else:
            watcher = None
        srv = ServeServer(pool=pool, reload_watcher=watcher, **served)
    else:
        engine, = build_engines(cfg, 1, blob=blob, digest=digest,
                                dtype=sc.dtype or None, **cells)
        srv = ServeServer(engine, **served, **knobs)
    srv.start()
    if ready is not None:
        ready(srv)
    srv.serve_until_interrupt()


def _serve_with_session(cfg: ConfigPairs, snapshot: Optional[ConfigPairs],
                        ready: Optional[Callable[[ServeServer], None]]):
    """``task = serve`` inside its telemetry session (``telemetry_port``,
    ``telemetry_ledger``, ``telemetry_trace``, ``telemetry_log``), with
    the ``run_start`` and ``run_end`` events around it."""
    gp = lambda n, d: global_param(cfg, n, d)
    tc = parse_telemetry_config(cfg)
    platform = resolve_devices(gp("dev", ""))[0].type
    pairs = snapshot if snapshot is not None else cfg
    session = TelemetrySession(tc, silent=bool(int(gp("silent", "0"))),
                               cfg_hash=config_hash(pairs),
                               host=max(tc.host, 0))
    _run_start(session, pairs, "serve", platform, 1, 0)
    status = "ok"
    try:
        task_serve(cfg, ready)
    except BaseException as e:
        status = f"error:{type(e).__name__}"
        raise
    finally:
        session.close(status=status)


def task_data_reader(cfg: ConfigPairs, sections,
                     snapshot: Optional[ConfigPairs] = None) -> None:
    """``task = data_reader``: serve the ``data = train`` section's
    batches for this reader's shards (``data_service_reader`` into the
    ``data_service`` endpoint list) until SIGINT/SIGTERM, inside a
    telemetry session (``telemetry_port``'s ``GET /metrics`` holds the
    ``cxxnet_dataservice_*`` series; ``telemetry_ledger`` the
    ``dataservice_start`` and ``dataservice_stop`` events)."""
    gp = lambda n, d: global_param(cfg, n, d)
    pairs = next((p for kind, _name, p in sections if kind == "data"),
                 None)
    if pairs is None:
        raise ValueError(
            "task=data_reader needs a data = train section (the "
            "pipeline it serves)")
    svc = parse_data_service_config(cfg)
    if not svc.enabled or svc.local_only:
        raise ValueError(
            "task=data_reader requires data_service = "
            "host:port[,host:port] naming the reader fleet")
    failpoints.install(gp("failpoints", ""), env=True)
    silent = bool(int(gp("silent", "0")))
    tc = parse_telemetry_config(cfg)
    platform = resolve_devices(gp("dev", ""))[0].type
    snap = snapshot if snapshot is not None else cfg
    session = TelemetrySession(tc, silent=silent,
                               cfg_hash=config_hash(snap),
                               host=max(tc.host, 0))
    _run_start(session, snap, "data_reader", platform, 1, 0)
    status = "ok"
    try:
        srv = DataReaderServer(cfg + pairs, svc, silent=silent)
        srv.start()
        srv.serve_until_interrupt()
    except BaseException as e:
        status = f"error:{type(e).__name__}"
        raise
    finally:
        session.close(status=status)


def _agree_latest(model_dir: str, silent: bool,
                  dp: Optional[DpContext] = None, want_blob: bool = False):
    """The round ``continue = 1`` resumes: ``find_latest_valid`` of
    ``model_dir`` (torn rounds skipped, named unless ``silent``). Under
    dp every rank scans, and the ranks all-gather the round they found
    and raise if they differ (``model_dir`` must be one directory that
    every rank sees)."""
    latest = ckpt.find_latest_valid(model_dir, verbose=not silent,
                                    want_blob=want_blob)
    if dp is not None and dp.world > 1:
        dev = dp.device if dp.backend == "nccl" else torch.device("cpu")
        mine = torch.zeros(dp.world, dtype=torch.int64, device=dev)
        mine[dp.rank] = -1 if latest is None else latest[0]
        rounds = sorted({int(r) for r in dp.all_reduce(mine).tolist()})
        if len(rounds) != 1:
            raise RuntimeError(
                "continue=1: ranks resolved different latest checkpoint "
                f"rounds {rounds}; model_dir must be on a shared "
                "filesystem visible to every rank")
    return latest


def _init_model(tr: Trainer, cfg: ConfigPairs) -> int:
    """Place the trainer's weights as the JAX package's
    ``LearnTask._init_model`` does and return the first round to run:
    the newest valid round of ``model_dir`` with ``continue = 1`` (the
    round after it), else ``model_in`` (finetune: copied by layer name
    into fresh weights, ``start_counter``; any other task: the round
    after it), else fresh weights (``start_counter``)."""
    gp = lambda n, d: global_param(cfg, n, d)
    start_counter = int(gp("start_counter", "0"))
    silent = bool(int(gp("silent", "0"))) or (tr.dp is not None
                                              and not tr.dp.is_main)
    if int(gp("continue", "0")):
        latest = _agree_latest(gp("model_dir", "./models"), silent, tr.dp,
                               want_blob=True)
        if latest is not None:
            r, path, blob = latest
            tr.load_blob(blob)
            if not silent:
                print(f"continuing from round {r} ({path})", flush=True)
            return r + 1
    model_in = gp("model_in", "NULL")
    if model_in == "NULL":
        tr.init_model()
        return start_counter
    if gp("task", "train") == "finetune":
        tr.init_model()
        tr.copy_model_from(model_in)
        return start_counter
    tr.load_model(model_in)
    return tr.round_counter + 1


class _Sentinel:
    """The JAX package's loss sentinel and model-health probe in the
    round loop (``cxxnet_tpu/main.py`` ``_sentinel_step`` and
    ``_health_sync``). The sentinel is on by default (``sentinel = 0``
    turns it off). Every ``sentinel_interval`` steps (and, forced,
    before each periodic checkpoint write) it reads the loss; a NaN/Inf
    loss or grad norm, or a spike over ``sentinel_spike_factor`` times
    the rolling median, restores the newest valid round of
    ``model_dir``, scales the LR by ``lr_backoff``, keeps the round's
    label, counts ``sentinel.anomalies`` / ``sentinel.rollbacks`` and
    writes ``sentinel_trip`` (with the step and the losses replay needs)
    and ``rollback`` to the ledger, both with the provenance of
    :func:`~cxxnet_tpu_torch.telemetry.modelhealth.diagnose_nonfinite`
    under ``health = 1``; past ``max_rollbacks``, or with no valid round,
    it raises :class:`SentinelAbort`. With ``health = 1`` the
    :class:`HealthProbe` reads the step's health tree every
    ``health_interval`` ticks (default: the sentinel's), its one host
    sync an interval, feeds the sentinel its grad norm, and on a
    float16 overflow onset runs the provenance walk."""

    def __init__(self, gp, model_dir: str, silent: bool,
                 tr: Optional[Trainer] = None):
        self.model_dir = model_dir
        self.silent = silent
        self.interval = max(1, int(gp("sentinel_interval", "8")))
        self.lr_backoff = float(gp("lr_backoff", "0.5"))
        self.tick = 0
        self.health: Optional[HealthProbe] = None
        if tr is not None and tr.health_on:
            self.health = HealthProbe(tr.health_cfg,
                                      fp16=tr.optimizer.fp16,
                                      silent=silent)
            self.health_every = tr.health_cfg.interval or self.interval
        self.sentinel: Optional[TrainingSentinel] = None
        if int(gp("sentinel", "1")):
            if not 0.0 < self.lr_backoff <= 1.0:
                raise ValueError(
                    f"lr_backoff must be in (0, 1], got {self.lr_backoff}")
            self.sentinel = TrainingSentinel(
                spike_factor=float(gp("sentinel_spike_factor", "10")),
                window=int(gp("sentinel_window", "50")),
                min_history=int(gp("sentinel_min_history", "8")),
                max_rollbacks=int(gp("max_rollbacks", "3")))

    def _health_sync(self, tr: Trainer, r: int) -> None:
        """The probe's one host sync an interval; on a float16 overflow
        onset the provenance walk names the overflowing layer."""
        hp = self.health
        info = hp.ingest(tr.last_health_handle, round_no=r,
                         step=tr.step_count)
        if info is not None and info.get("overflow_onset"):
            try:
                prov = diagnose_nonfinite(tr)
            except Exception as e:   # diagnosis never blocks training
                prov = f"diagnosis-failed:{type(e).__name__}"
            hp.note_overflow_advice(r, tr.step_count, prov)

    def step(self, tr: Trainer, r: int, losses=None,
             force: bool = False) -> None:
        """Feed the probe and the sentinel after a dispatched update
        (``losses``: a chain's loss vector); ``force`` bypasses the
        sentinel's interval."""
        sentinel, hp = self.sentinel, self.health
        if sentinel is None and hp is None:
            return
        self.tick += 1
        if hp is not None and self.tick % self.health_every == 0:
            self._health_sync(tr, r)
        if sentinel is None:
            return
        if not force and self.tick % self.interval:
            return
        if losses is None:
            vals = [tr.last_loss]
        else:
            vals = [float(v) for v in losses.float().cpu().reshape(-1)]
        gn = hp.last_grad_norm if hp is not None else None
        reason = None
        for v in vals:
            reason = sentinel.observe(v, grad_norm=gn)
            if reason:
                break
        if reason is None:
            return
        counters.inc("sentinel.anomalies")
        # the provenance walk runs before the rollback wipes the
        # poisoned state
        prov = None
        if tr.health_on:
            try:
                prov = diagnose_nonfinite(tr)
            except Exception as e:   # diagnosis never blocks recovery
                prov = f"diagnosis-failed:{type(e).__name__}"
            if prov:
                sentinel.annotate_last(prov)
                reason = f"{reason} [{prov}]"
        LEDGER.event("sentinel_trip", round=r, reason=reason,
                     provenance=prov, step=tr.step_count, losses=vals)
        latest = ckpt.find_latest_valid(self.model_dir, sweep_tmp=False,
                                        want_blob=True)
        if latest is None:
            raise SentinelAbort(
                f"training anomaly with no valid checkpoint to roll back "
                f"to: {reason}\n{sentinel.report()}")
        sentinel.record_rollback(latest[0], reason)   # aborts past budget
        r0, path, blob = latest
        # load_blob takes the round's LR scale: back off from the lower
        # of the two, so rollbacks onto one round compound
        scale_before = tr.optimizer.lr_scale
        tr.rollback(path, blob=blob)
        tr.start_round(r)       # rounds keep their %04d labels
        tr.optimizer.lr_scale = min(scale_before, tr.optimizer.lr_scale) \
            * self.lr_backoff
        sentinel.reset_window()
        if hp is not None:
            # the last reading is the poisoned step's
            hp.reset_after_rollback()
        counters.inc("sentinel.rollbacks")
        # step: the restored count (the trip's is in sentinel_trip)
        LEDGER.event("rollback", round=r, to_round=r0, path=path,
                     reason=reason, provenance=prov, step=tr.step_count,
                     lr_scale=float(tr.optimizer.lr_scale))
        TRACER.instant("sentinel.rollback", cat="train",
                       args={"round": r, "to_round": r0})
        if not self.silent:
            print(f"sentinel: {reason}; rolled back to round {r0} "
                  f"checkpoint ({path}), lr_scale="
                  f"{tr.optimizer.lr_scale:g}", flush=True)


def _save_round(tr: Trainer, path: str, r: int, guard: bool,
                silent: bool) -> None:
    """The periodic checkpoint write of the JAX package's round loop:
    with the sentinel on (``guard``), non-finite masters are not written
    (``ckpt.skipped_poisoned``); a failed write is counted
    (``ckpt.write_failures``) and training goes on."""
    if guard and not tr.params_finite():
        counters.inc("ckpt.skipped_poisoned")
        if not silent:
            print(f"WARNING: skipping checkpoint for round {r}: params "
                  "are non-finite (sentinel will roll back)", flush=True)
        return
    try:
        tr.save_model(path)
    except Exception as e:
        counters.inc("ckpt.write_failures")
        if not silent:
            print(f"WARNING: checkpoint write failed for round {r}: "
                  f"{type(e).__name__}: {e}; training continues (next "
                  "save period retries)", flush=True)


def _timed_batches(it, probe):
    """The train iterator with each fetch and its staging onto the device
    (``Trainer.stage_batch``, the next item of ``it``) timed as the
    step's data wait: banked into the step-time probe and traced as
    ``train.data_wait``."""
    it = iter(it)
    while True:
        t0 = time.perf_counter()
        try:
            batch = next(it)
        except StopIteration:
            return
        t1 = time.perf_counter()
        if probe is not None:
            probe.note_data_wait(t1 - t0)
        TRACER.add_complete("train.data_wait", t0, t1, cat="train")
        yield batch


def _staged(tr: Trainer, it):
    """Each batch of ``it`` staged onto the device as it is drawn (the
    JAX package's ``prefetch_device``, one batch deep)."""
    for b in it:
        yield tr.stage_batch(b)


def _train_rounds(tr: Trainer, gp, itr_train, evals, start_counter: int,
                  session: TelemetrySession) -> int:
    """The JAX package's round loop (main.py:1004-1167, its single-device
    and dp parts; under dp every rank runs it, rank 0 alone prints) from
    round ``start_counter``; returns the last round of the run. With
    ``train_chain = k > 1`` the batches are copied to the host as they
    come and every k of them go to ``update_chain_batches`` as one
    chain; a round's tail shorter than k goes through ``update``, and
    the progress line counts dispatched work only.

The telemetry ``session``'s pieces run in it: the step-time probe
    (its fragment ends the round line), the ``telemetry_profile_steps``
    bracket and its attribution line, the ``train.step`` root span and
    the ``train.data_wait`` spans, the ``round_end`` event and the fleet
    fragment of :meth:`TelemetrySession.round_tick`; and the loss
    sentinel with the model-health probe (:class:`_Sentinel`).
    A data-service iterator is set to the epoch of ``start_counter``.
    With ``test_io = 1`` the batches are drawn and counted, nothing is
    updated, evaluated or written, and each round prints its input
    rate."""
    start = time.time()
    num_round = int(gp("num_round", "10"))
    max_round = int(gp("max_round", "0"))
    print_step = int(gp("print_step", "100"))
    save_period = int(gp("save_period", "1"))
    save_model = int(gp("save_model", "1"))
    model_dir = gp("model_dir", "./models")
    chain = int(gp("train_chain", "0"))
    chain = chain if chain > 1 else 0
    silent = int(gp("silent", "0")) or (tr.dp is not None
                                        and not tr.dp.is_main)
    end_round = num_round
    if max_round > 0:
        end_round = min(end_round, start_counter + max_round)
    test_io = int(gp("test_io", "0"))
    if hasattr(itr_train, "set_epoch"):
        # data-service epochs are addressed, not counted: continue = 1
        # replays the epoch the uninterrupted run would have read
        itr_train.set_epoch(start_counter)
    if test_io:
        for r in range(start_counter, end_round):
            round_start = time.time()
            n_images = 0
            for batch in itr_train:
                n_images += batch.batch_size - batch.num_batch_padd
            dt = max(time.time() - round_start, 1e-9)
            if not silent:
                print(f"round {r:8d}: test_io {n_images} images in "
                      f"{dt:.2f} sec = {n_images / dt:.1f} images/sec",
                      flush=True)
        return end_round - 1
    guard = _Sentinel(gp, model_dir, bool(silent), tr)
    probe = session.make_probe() if session.cfg.steptime else None
    profiler = session.profiler
    summarized = False

    def step_span(r: int, steps: int = 1):
        # the step's root span of distributed tracing: the stage and
        # dispatch spans and the probe's device block nest under it
        if not TRACER.enabled:
            return NULL_SPAN
        return DISTTRACE.span("train.step", cat="train",
                              args={"round": r, "steps": steps})

    def one(r: int, batch) -> None:
        if profiler is not None:
            profiler.maybe_start(tr.step_count)
        t_d = time.perf_counter()
        with step_span(r):
            tr.update(batch)
            if probe is not None:
                probe.record_step(time.perf_counter() - t_d,
                                  ready=tr.last_loss_tensor)
        if profiler is not None:
            profiler.maybe_stop(tr.step_count, ready=tr.last_loss_tensor)
        guard.step(tr, r)

    for r in range(start_counter, end_round):
        tr.start_round(r)
        batch_count = n_images = 0
        round_start = time.time()
        pending, pending_rows = [], 0
        batches = _timed_batches(
            itr_train if chain else _staged(tr, itr_train), probe)
        for batch in batches:
            host = getattr(batch, "host", batch)
            real_rows = host.batch_size - host.num_batch_padd
            if chain:
                # host copies: iterators may hand out views into buffers
                # they refill on the next batch
                pending.append(DataBatch(
                    data=np.array(batch.data), label=np.array(batch.label),
                    num_batch_padd=batch.num_batch_padd,
                    inst_index=None if batch.inst_index is None
                    else np.array(batch.inst_index),
                    extra_data=[np.array(e) for e in batch.extra_data],
                    norm=batch.norm))
                pending_rows += real_rows
                if len(pending) < chain:
                    continue
                if profiler is not None:
                    profiler.maybe_start(tr.step_count)
                t_d = time.perf_counter()
                with step_span(r, steps=len(pending)):
                    losses = tr.update_chain_batches(pending)
                    if probe is not None:
                        probe.record_step(time.perf_counter() - t_d,
                                          ready=losses, steps=len(pending))
                if profiler is not None:
                    profiler.maybe_stop(tr.step_count, ready=losses)
                batch_count += len(pending)
                n_images += pending_rows
                pending, pending_rows = [], 0
                guard.step(tr, r, losses=losses)
            else:
                one(r, batch)
                n_images += real_rows
                batch_count += 1
            if print_step and not silent and batch_count // print_step \
                    != (batch_count - (chain or 1)) // print_step:
                ips = n_images / max(time.time() - round_start, 1e-9)
                print(f"round {r:8d}:[{batch_count:8d}] "
                      f"{int(time.time() - start)} sec elapsed, "
                      f"loss={tr.last_loss:.6f}, {ips:.1f} images/sec",
                      flush=True)
        for b in pending:             # the round's tail, shorter than k
            one(r, b)
            n_images += b.batch_size - b.num_batch_padd
            batch_count += 1
        if profiler is not None and profiler.done and not summarized:
            # the telemetry_profile_steps bracket closed this round: the
            # measured per-phase attribution of its trace
            summarized = True
            if not silent:
                frag = attribution_fragment(attribute_profile(
                    profiler.dump_dir,
                    profiler.stop_step - profiler.start_step + 1))
                if frag:
                    print(f"round {r:8d}: {frag} (dump: "
                          f"{profiler.dump_dir})", flush=True)
        line = f"round {r:8d}:[{int(time.time() - start)} sec]"
        if tr.eval_train:
            line += tr.train_metric_report("train")
        for name, itr in evals:
            line += tr.evaluate(itr, name)
        if probe is not None:
            line += probe.report_fragment()
        if guard.health is not None:
            line += guard.health.report_fragment()
            guard.health.round_event(r)
        dt_round = max(time.time() - round_start, 1e-9)
        line += session.round_tick(
            r, images=n_images, batches=batch_count,
            seconds=round(dt_round, 3),
            images_per_sec=round(n_images / dt_round, 2),
            loss=tr.last_loss if batch_count else None,
            step_count=tr.step_count)
        if not silent:
            print(line, flush=True)
        if save_model and save_period and (r + 1) % save_period == 0:
            # a NaN that landed between sentinel ticks rolls back before
            # the round is written
            guard.step(tr, r, force=True)
            _save_round(tr, ckpt.model_path(model_dir, r), r,
                        guard.sentinel is not None, bool(silent))
    return end_round - 1


def _run_start(session: TelemetrySession, pairs: ConfigPairs, task: str,
               platform: str, world: int, rank: int) -> None:
    """The ledger's ``run_start`` event (the JAX package's fields: the
    identity, the layout of the process group, the armed failpoints and
    the whole config, split into ``config_chunk`` events past one
    line)."""
    snap_fields, snap_chunks = plan_config_snapshot(pairs)
    svc = parse_data_service_config(pairs)
    if session.cfg.trace_path:
        # names this process's track in tools/trace_assemble.py
        set_trace_identity(role=task)
    LEDGER.event(
        "run_start", task=task, config_hash=session.cfg_hash,
        process_count=world, process_index=rank, devices=world,
        platform=platform,
        mesh={"data": world, "seq": 1, "pipe": 1, "model": 1},
        dist=None, compile_cache=None,
        failpoints=failpoints.active(),
        failpoint_seed=int(os.environ.get(
            failpoints.SEED_ENV_VAR, "0") or "0"),
        nan_layer=os.environ.get("CXXNET_NAN_LAYER", ""),
        data_service_seed=svc.seed,
        data_service_shards=svc.n_shards if svc.enabled else 0,
        **snap_fields)
    for ch in snap_chunks:
        LEDGER.event("config_chunk", **ch)


def _train_session(cfg: ConfigPairs, tr: Trainer,
                   snapshot: Optional[ConfigPairs]) -> TelemetrySession:
    """The telemetry session of one training process, and its
    ``run_start`` event. Under dp the ranks other than 0 keep the probe
    and the ledger (``host`` is the rank) but bind no port and write no
    trace, log or profile."""
    gp = lambda n, d: global_param(cfg, n, d)
    tc = parse_telemetry_config(cfg)
    dp = tr.dp
    if dp is not None and not dp.is_main:
        tc = dataclasses.replace(tc, port=0, trace_path="", log_path="",
                                 profile_steps="")
    host = tc.host if tc.host >= 0 else (dp.rank if dp is not None else 0)
    pairs = snapshot if snapshot is not None else cfg
    silent = bool(int(gp("silent", "0"))) or (dp is not None
                                              and not dp.is_main)
    session = TelemetrySession(tc, silent=silent,
                               cfg_hash=config_hash(pairs), host=host,
                               cuda=tr.device.type == "cuda")
    _run_start(session, pairs, gp("task", "train"), tr.device.type,
               dp.world if dp is not None else 1,
               dp.rank if dp is not None else 0)
    if session.watchdog is not None:
        # the trainer's own step count advances with the probe off too
        session.watchdog.progress_fn = lambda: tr.step_count
    return session


def task_train(cfg: ConfigPairs, sections,
               ready: Optional[Callable[[Trainer], None]] = None,
               dp: Optional[DpContext] = None,
               snapshot: Optional[ConfigPairs] = None) -> Trainer:
    """``task = train`` or ``finetune`` over the ``data`` section from
    the weights :func:`_init_model` places, evaluating on each ``eval``
    section after every round; ``ready`` is handed the initialized
    trainer before the first step. Under ``dp`` this is one rank's part
    of a data-parallel run. ``snapshot`` is the whole config as given
    (the ledger's ``run_start`` records it). The telemetry session lives
    as long as the run, and ``profile_dir`` traces the whole round loop.
    Returns the trainer."""
    gp = lambda n, d: global_param(cfg, n, d)
    # float32 policies compute in full float32 (no TF32 in cuDNN convs
    # or cuBLAS matmuls), as the JAX package's float32 does on the CPU;
    # cuDNN's deterministic algorithms and no benchmark, so that a run
    # repeats bit for bit and its incidents replay (replay/executor.py)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    # failpoints = "site=mode,..." plus the CXXNET_FAILPOINTS env
    failpoints.install(gp("failpoints", ""), env=True)
    tr = Trainer(cfg, dp=dp)
    data = [pairs for kind, _, pairs in sections if kind == "data"]
    if not data:
        raise ConfigError("no training data section (data = ...) in config")
    profile_dir = gp("profile_dir", "")
    if profile_dir and parse_telemetry_config(cfg).profile_steps:
        raise ConfigError(
            "profile_dir and telemetry_profile_steps: torch.profiler runs "
            "one session at a time; set one of them")
    session = _train_session(cfg, tr, snapshot)
    status = "ok"
    svc = parse_data_service_config(cfg)
    if svc.enabled:
        chains = [build_service_iterator(cfg + data[0], svc)]
    else:
        chains = [create_iterator(cfg + data[0])]
    try:
        evals = []
        for kind, name, pairs in sections:
            if kind == "eval":
                chains.append(create_iterator(cfg + pairs))
                evals.append((name, chains[-1]))
        model_dir = gp("model_dir", "./models")
        save_model = int(gp("save_model", "1")) and not int(
            gp("test_io", "0"))
        if save_model:
            stream.makedirs(model_dir)
        start_counter = _init_model(tr, cfg)
        if ready is not None:
            ready(tr)
        bracket = None
        if profile_dir and (dp is None or dp.is_main):
            bracket = ProfileBracket(profile_dir,
                                     cuda=tr.device.type == "cuda")
            bracket.start()
        try:
            last = _train_rounds(tr, gp, chains[0], evals, start_counter,
                                 session)
        finally:
            if bracket is not None:
                bracket.stop(ready=tr.last_loss_tensor)
                if not session.silent:
                    print(f"profiler trace written to {profile_dir}",
                          flush=True)
        final = ckpt.model_path(model_dir, last)
        if save_model and last >= 0 and not stream.exists(final):
            tr.save_model(final)
    except BaseException as e:
        status = f"error:{type(e).__name__}"
        raise
    finally:
        for it in chains:
            close_chain(it)
        session.close(ready=tr.last_loss_tensor, status=status)
    return tr


def _train_worker(dp: DpContext, cfg: ConfigPairs, sections,
                  ready: Optional[Callable[[Trainer], None]],
                  snapshot: Optional[ConfigPairs]) -> None:
    """One rank of a data-parallel ``task = train`` (spawned by
    :func:`task_train_dp`)."""
    stream.set_retry_policy(parse_retry_policy(cfg))
    task_train(cfg, sections, ready, dp=dp, snapshot=snapshot)


def task_train_dp(cfg: ConfigPairs, sections, devices: Sequence[Any],
                  ready: Optional[Callable[[Trainer], None]] = None,
                  backend: Optional[str] = None,
                  snapshot: Optional[ConfigPairs] = None) -> None:
    """Data-parallel ``task = train``: one rank per entry of ``devices``
    (``parallel.launch``), each running :func:`task_train` on its rows of
    every global batch. On the card the kernels are built here first, so
    every rank loads the same libraries. ``ready`` (a module-level
    function, as it crosses to the ranks by pickle) is handed each
    rank's trainer before its first step. The ranks share one run id
    (``telemetry_run_id``, drawn here unless given). Raises with the
    traceback of a rank that fails."""
    if any(torch.device(d).type == "cuda" for d in devices):
        from .ops import KERNELS, _build
        _build.build(sorted({k.source for k in KERNELS.values()}))
    tc = parse_telemetry_config(cfg)
    run_id = tc.run_id or os.environ.get("CXXNET_RUN_ID") or new_run_id()
    cfg = list(cfg) + [("telemetry_run_id", run_id)]
    launch(_train_worker, (cfg, sections, ready, snapshot),
           devices=devices, backend=backend)


# -- the batch tasks ------------------------------------------------------------

def _open_out(path: str, mode: str = "w"):
    """An output file of the batch tasks (``mode`` "w" text, "wb"
    binary), local or a ``scheme://`` URL through the stream layer."""
    if stream.is_remote(path):
        raw = stream.sopen(path, "wb")
        return raw if mode == "wb" else io.TextIOWrapper(
            raw, encoding="utf-8")
    return open(path, mode)


def _fmt_row(row) -> str:
    """One output line: the values as ``%g``, separated by spaces."""
    return " ".join(f"{float(v):g}" for v in row) + "\n"


def _output_txt(cfg: ConfigPairs) -> bool:
    """``output_format = txt`` (the default) or ``bin`` (raw
    little-endian float32); anything else raises, a typo such as
    ``Bin`` included."""
    fmt = global_param(cfg, "output_format", "txt")
    if fmt not in ("txt", "bin"):
        raise ValueError(
            f"output_format must be 'txt' or 'bin', got {fmt!r}")
    return fmt != "bin"


def _name_pred(cfg: ConfigPairs, sections) -> str:
    """``name_pred``, by default the ``pred = <file>`` section's file
    name, else ``pred.txt``."""
    pred_name = next((name for kind, name, _ in sections
                      if kind == "pred" and name), "")
    return global_param(cfg, "name_pred", pred_name or "pred.txt")


def _batch_trainer(cfg: ConfigPairs) -> Trainer:
    """A trainer on one device with the weights of :func:`_init_model`."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    tr = Trainer(cfg)
    _init_model(tr, cfg)
    return tr


def _pred_iter(cfg: ConfigPairs, sections):
    """The iterator of the first ``pred`` section, else of the ``data``
    section (the caller closes its chain)."""
    for want in ("pred", "data"):
        pairs = next((p for kind, _, p in sections if kind == want), None)
        if pairs is not None:
            return create_iterator(cfg + pairs)
    raise ValueError("no pred/data section in config")


def task_predict(cfg: ConfigPairs, sections, raw: bool = False) -> Trainer:
    """``task = pred``: one class id a line (``raw``, ``task =
    pred_raw``: one row of the top node a line) to ``name_pred``."""
    tr = _batch_trainer(cfg)
    out = _name_pred(cfg, sections)
    it = _pred_iter(cfg, sections)
    try:
        with _open_out(out) as f:
            for batch in it:
                if raw:
                    f.writelines(_fmt_row(r) for r in tr.predict_raw(batch))
                else:
                    f.writelines(f"{float(v):g}\n"
                                 for v in tr.predict(batch))
    finally:
        close_chain(it)
    if not tr.silent:
        print(f"finished {'raw ' if raw else ''}prediction, write into "
              f"{out}", flush=True)
    return tr


def task_extract(cfg: ConfigPairs, sections) -> Trainer:
    """``task = extract``: the rows of ``extract_node_name`` to
    ``name_pred`` (``output_format``), and ``<name_pred>.meta`` with
    ``nrow,c,y,x``."""
    tr = _batch_trainer(cfg)
    node = global_param(cfg, "extract_node_name", "top")
    out = _name_pred(cfg, sections)
    it = _pred_iter(cfg, sections)
    nrow = 0
    try:
        txt = _output_txt(cfg)
        with _open_out(out, "w" if txt else "wb") as f:
            for batch in it:
                feats = tr.extract_feature(batch, node)
                nrow += feats.shape[0]
                if txt:
                    f.writelines(_fmt_row(r) for r in feats)
                else:
                    f.write(np.ascontiguousarray(feats, "<f4").tobytes())
    finally:
        close_chain(it)
    c, y, x = tr.node_shape(node)
    with _open_out(out + ".meta") as f:
        f.write(f"{nrow},{c},{y},{x}\n")
    if not tr.silent:
        print(f"finished feature extraction, write into {out}", flush=True)
    return tr


def task_get_weight(cfg: ConfigPairs, sections) -> Trainer:
    """``task = get_weight``: the weight ``weight_name`` (alias
    ``weight_tag``, default ``wmat``) of ``extract_layer_name`` (alias
    ``weight_layer``) in the JAX layout, as rows of its first axis, to
    ``weight_filename`` (default ``name_pred``), and a ``.meta`` with
    its shape."""
    tr = _batch_trainer(cfg)
    gp = lambda n, d: global_param(cfg, n, d)
    layer = gp("extract_layer_name", "") or gp("weight_layer", "")
    tag = gp("weight_name", "") or gp("weight_tag", "wmat")
    out = gp("weight_filename", "") or _name_pred(cfg, sections)
    if not layer:
        raise ValueError("get_weight requires extract_layer_name=<layer>")
    w = tr.get_weight(layer, tag)
    w2 = w.reshape(w.shape[0], -1)
    if _output_txt(cfg):
        with _open_out(out) as f:
            f.writelines(_fmt_row(r) for r in w2)
    else:
        with _open_out(out, "wb") as f:
            f.write(np.ascontiguousarray(w2, "<f4").tobytes())
    with _open_out(out + ".meta") as f:
        f.write(" ".join(str(d) for d in w.shape) + "\n")
    if not tr.silent:
        print(f"finished getting weight, write into {out}", flush=True)
    return tr


BATCH_TASKS = {
    "pred": task_predict,
    "pred_raw": functools.partial(task_predict, raw=True),
    "extract": task_extract,
    "extract_feature": task_extract,
    "get_weight": task_get_weight,
}


def run(cfg: ConfigPairs, ready: Optional[Callable] = None,
        devices: Optional[Sequence[Any]] = None,
        backend: Optional[str] = None):
    """Dispatch on ``task`` over the global settings. ``ready`` is handed
    the listening server (serve) or the initialized trainer (train,
    finetune); single-device training and the batch tasks return their
    :class:`Trainer`. ``devices`` and ``backend`` override, for
    training, the ranks that ``dev`` names and the collective backend
    (``parallel.launch``): tests run two CPU ranks over gloo with ``dev
    = cpu`` and ``devices=("cpu", "cpu")``, and two ranks can share one
    card with ``backend="gloo"``."""
    global_cfg, sections = split_sections(cfg)
    task = global_param(global_cfg, "task", "train")
    # every stream operation retries under the io_retry_* policy, and an
    # unknown data_service* key raises whatever the task
    stream.set_retry_policy(parse_retry_policy(global_cfg))
    parse_data_service_config(global_cfg)
    if task in ("train", "finetune"):
        if devices is None:
            devices = resolve_devices(global_param(global_cfg, "dev", ""))
        if len(devices) > 1:
            task_train_dp(global_cfg, sections, devices, ready, backend,
                          snapshot=cfg)
            return None
        return task_train(global_cfg, sections, ready, snapshot=cfg)
    if task in BATCH_TASKS:
        return BATCH_TASKS[task](global_cfg, sections)
    if task == "serve":
        failpoints.install(global_param(global_cfg, "failpoints", ""),
                           env=True)
        _serve_with_session(global_cfg, cfg, ready)
        return None
    if task == "data_reader":
        task_data_reader(global_cfg, sections, cfg)
        return None
    raise ConfigError(f"unknown task {task!r}")


def main(argv: Optional[List[str]] = None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    ap = argparse.ArgumentParser(
        prog="cxxnet_tpu_torch",
        description="cxxnet task driver, PyTorch/CUDA port (task=train|"
                    "finetune|pred|pred_raw|extract|extract_feature|"
                    "get_weight|serve|data_reader)")
    ap.add_argument("config", help="config file (key=value dialect)")
    ap.add_argument("overrides", nargs="*", help="key=value overrides")
    args = ap.parse_args(argv)
    run(parse_config_file(args.config) + parse_cli_overrides(args.overrides))
    return 0


if __name__ == "__main__":
    sys.exit(main())
