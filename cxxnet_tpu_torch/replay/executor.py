"""Incident re-execution: run a ReplayPlan's window in THIS process (the
port of ``cxxnet_tpu/replay/executor.py``).

Time-travel debugging's second half: build a trainer from the RECORDED
config on one device (the recorded ``dev``, or an override), restore
the plan's checkpoint, feed the window's rounds through the
deterministic local data path, and compare what happens against what
the ledger recorded:

* each completed window round's final loss vs its ``round_end.loss``
  — bitwise (losses round-trip JSON exactly);
* the per-round batch count vs ``round_end.batches`` — a mismatch
  means the data addressing diverged, which is worse than a numeric
  drift and verdicts as unreproducible;
* with the recorded failpoints re-armed (step-compensated): the
  non-finite loss must land by the recorded trip step and the one-shot
  NaN-provenance walk must produce the IDENTICAL ``layer=/kind=``
  string; the trip's recorded loss vector is checked positionally
  (finite slots bitwise, null slots non-finite).

The incident round's own ``round_end`` is never compared for sentinel
incidents — the original emitted it AFTER rolling back and continuing,
so its loss describes the post-recovery trajectory, not the window.

Verdict semantics (the ``replay_verdict`` ledger event):
``bit_exact`` — every comparison matched; ``diverged_at_step`` — a
loss/provenance mismatch, ``step`` names the first; ``unreproducible:
<reason>`` — the window could not be faithfully re-executed at all.

On a card the replay runs with ``torch.backends.cudnn.deterministic``
on and ``benchmark`` off, as ``task = train`` trains (``main.py``):
cuDNN's other algorithms may sum in another order from run to run.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Dict, List, Optional, Tuple

from ..resilience import failpoints
from ..telemetry.ledger import LEDGER, RunLedger, new_run_id
from .reconstruct import ReplayPlan, compensate_failpoints

# global-config keys/namespaces the replay process must NOT inherit
# from the recorded run: fleet observability endpoints and ledgers
# (replay writes its own), elastic membership, the deploy controller,
# serving, multi-host bring-up, and the original failpoint arming
# (re-armed explicitly, compensated). Parallel-layout keys are dropped
# too — replay runs at LOCAL width; checkpoints store gathered full
# arrays, so load+placement reshards losslessly.
_DROP_PREFIXES = ("telemetry_", "elastic_", "deploy_", "serve_",
                  "dist_init", "preempt_")
_DROP_KEYS = {"failpoints", "model_parallel", "seq_parallel",
              "pipeline_parallel", "fsdp_axis", "num_proc",
              "keep_last_n", "save_async"}


@dataclasses.dataclass
class ReplayResult:
    verdict: str                      # bit_exact | diverged_at_step |
    #                                   unreproducible:<reason>
    detail: str = ""
    step: Optional[int] = None        # first divergent / faulting step
    steps_executed: int = 0
    rounds_executed: int = 0
    per_step: List[Tuple[int, float]] = dataclasses.field(
        default_factory=list)         # (absolute step, loss)
    compared_rounds: Dict[int, Tuple[Optional[float], float, bool]] = \
        dataclasses.field(default_factory=dict)
    nan_step: Optional[int] = None
    provenance_recorded: Optional[str] = None
    provenance_replayed: Optional[str] = None
    failpoints_armed: Dict[str, str] = dataclasses.field(
        default_factory=dict)
    notes: List[str] = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return self.verdict == "bit_exact"

    def report(self, plan: Optional[ReplayPlan] = None) -> str:
        """The CLI's verdict block — terse, grep-able, self-contained."""
        lines = []
        if plan is not None:
            inc = plan.incident
            lines.append(
                "replay: incident %d (%s) of %s" % (
                    plan.incident_index, inc.get("event", "?"),
                    plan.ledger_path))
            lines.append(
                "  window: rounds %s from checkpoint round %d "
                "(step %d, %s)" % (
                    f"{plan.rounds[0]}..{plan.rounds[-1]}"
                    if plan.rounds else "-",
                    plan.start_round, plan.start_step, plan.ckpt_path))
        lines.append("  verdict: %s%s" % (
            self.verdict, f" — {self.detail}" if self.detail else ""))
        lines.append("  steps replayed: %d (%d round(s))"
                     % (self.steps_executed, self.rounds_executed))
        for r in sorted(self.compared_rounds):
            rec, rep, ok = self.compared_rounds[r]
            lines.append("  round %d loss: recorded=%r replayed=%r %s"
                         % (r, rec, rep, "OK" if ok else "MISMATCH"))
        if self.nan_step is not None:
            lines.append("  non-finite loss at step %d" % self.nan_step)
        if self.provenance_recorded or self.provenance_replayed:
            match = (self.provenance_recorded
                     == self.provenance_replayed)
            lines.append("  provenance: recorded=%r replayed=%r %s"
                         % (self.provenance_recorded,
                            self.provenance_replayed,
                            "OK" if match else "MISMATCH"))
        if self.failpoints_armed:
            lines.append("  failpoints re-armed: %s" % ",".join(
                f"{k}={v}" for k, v in
                sorted(self.failpoints_armed.items())))
        for n in self.notes:
            lines.append("  note: %s" % n)
        return "\n".join(lines)


def _replay_global_cfg(plan: ReplayPlan,
                       overrides=()) -> List[Tuple[str, str]]:
    """The recorded global config, scrubbed for one-process replay:
    fleet/elastic/deploy/serve machinery off, parallel layout local,
    health forced on (provenance must be diagnosable), data service
    rewritten to the deterministic ``local`` stream (the degrade path
    is the digest-equal control by construction)."""
    from ..config import split_sections
    gcfg, _sections = split_sections(plan.config_pairs)
    out = [(k, v) for k, v in gcfg
           if k not in _DROP_KEYS
           and not any(k.startswith(p) for p in _DROP_PREFIXES)
           and not k.startswith("data_service")]
    svc_on = any(k == "data_service" for k, _ in gcfg)
    if svc_on:
        shards = plan.data_service_shards or 1
        out += [("data_service", "local"),
                ("data_service_shards", str(shards)),
                ("data_service_seed", str(plan.data_service_seed))]
    out.append(("health", "1"))
    out.extend((str(k), str(v)) for k, v in overrides)
    return out


def _build_iterator(plan: ReplayPlan, gcfg) -> Any:
    from ..config import parse_data_service_config
    from ..io.data import create_iterator
    from ..config import split_sections
    _g, sections = split_sections(plan.config_pairs)
    data_pairs = next((p for kind, _n, p in sections if kind == "data"),
                      None)
    if data_pairs is None:
        raise ValueError("recorded config has no data section")
    svc = parse_data_service_config(gcfg)
    if svc.enabled:
        from ..data_service.client import build_service_iterator
        return build_service_iterator(gcfg + data_pairs, svc,
                                      silent=True)
    return create_iterator(gcfg + data_pairs)


def _losses_equal(recorded: Optional[float], replayed: float) -> bool:
    """Bitwise equality through the ledger's JSON round-trip: floats
    serialize via repr and parse back exactly; a recorded None means
    the original value was non-finite (sanitized)."""
    if recorded is None:
        return not math.isfinite(replayed)
    return recorded == replayed


def execute(plan: ReplayPlan,
            failpoints_on: bool = False,
            max_steps: int = 0,
            out_ledger: str = "",
            overrides=(),
            silent: bool = False) -> ReplayResult:
    """Re-execute a plan's window and compare against the record.

    ``failpoints_on`` re-arms the recorded fault schedule (only
    ``device.step`` — the one site whose firing alters the training
    stream — is re-armed, step-compensated; IO-cadence sites are
    value-neutral and stay off). ``max_steps`` caps the window
    (``--steps K``); ``out_ledger`` appends ``replay_start`` /
    ``replay_verdict`` events there. ``overrides`` are extra global
    key=value pairs (e.g. ``dev=cpu``) applied last."""
    import torch

    from ..io.data import close_chain
    from ..trainer import Trainer

    res = ReplayResult(verdict="bit_exact",
                       provenance_recorded=plan.provenance,
                       notes=list(plan.notes))
    led = RunLedger(out_ledger, run_id=f"replay-{new_run_id()}") \
        if out_ledger else None
    gcfg = _replay_global_cfg(plan, overrides=overrides)
    if led is not None:
        led.event("replay_start", source_ledger=plan.ledger_path,
                  source_run_id=plan.run_id,
                  incident=plan.incident_index,
                  incident_event=plan.incident.get("event"),
                  start_round=plan.start_round,
                  start_step=plan.start_step,
                  rounds=[plan.rounds[0], plan.rounds[-1]]
                  if plan.rounds else [],
                  failpoints_on=bool(failpoints_on),
                  config_hash=plan.config_hash)

    inc_event = plan.incident.get("event")
    sentinel_incident = inc_event in ("sentinel_trip", "rollback")

    armed: Dict[str, str] = {}
    env_saved = {k: os.environ.get(k) for k in
                 (failpoints.SEED_ENV_VAR, "CXXNET_NAN_LAYER")}
    spec, _notes = compensate_failpoints(plan.failpoints,
                                         plan.start_step)
    itr = None
    # trainer internals (ckpt_load, compile) write through the global
    # ledger proxy — point it at the replay ledger (or nowhere) for the
    # duration so an in-process replay never appends to the ORIGINAL
    # run's ledger it is reading from
    from ..telemetry.ledger import _DisabledLedger
    led_saved = LEDGER._target
    LEDGER._target = led if led is not None else _DisabledLedger()
    flags_saved = (torch.backends.cudnn.deterministic,
                   torch.backends.cudnn.benchmark,
                   torch.backends.cudnn.allow_tf32,
                   torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        tr = Trainer(gcfg)
        tr.init_model()
        tr.load_model(plan.ckpt_path)
        if tr.step_count != plan.start_step:
            # pre-step_count meta: the draws key on the step count
            tr.step_count = plan.start_step
        res.notes.append("replay width: 1 device, platform %s"
                         % tr.device.type)
        # a leftover armed spec from the ORIGINAL in-process run must
        # not fire during a clean-counterfactual replay
        failpoints.clear("device.step")
        if failpoints_on:
            os.environ[failpoints.SEED_ENV_VAR] = \
                str(plan.failpoint_seed)
            if plan.nan_layer:
                os.environ["CXXNET_NAN_LAYER"] = plan.nan_layer
            else:
                os.environ.pop("CXXNET_NAN_LAYER", None)
            if "device.step" in spec:
                failpoints.set("device.step", spec["device.step"])
                armed["device.step"] = spec["device.step"]
            skipped = sorted(k for k in spec if k != "device.step")
            if skipped:
                res.notes.append(
                    "not re-armed (IO-cadence, value-neutral): "
                    + ",".join(skipped))
        res.failpoints_armed = armed

        itr = _build_iterator(plan, gcfg)
        if hasattr(itr, "set_epoch"):
            itr.set_epoch(plan.rounds[0] if plan.rounds
                          else plan.start_round + 1)
        chain = 0
        for k, v in gcfg:
            if k == "train_chain":
                chain = int(v) if int(v) > 1 else 0

        cap = int(max_steps) if max_steps else 0
        stop = False
        first_mismatch: Optional[int] = None

        def record(loss: float) -> bool:
            """Book one replayed step; True = keep going."""
            s = tr.step_count if chain == 0 else record.step
            res.per_step.append((s, loss))
            res.steps_executed += 1
            if not math.isfinite(loss):
                res.nan_step = s
                if tr.health_on:
                    from ..telemetry.modelhealth import \
                        diagnose_nonfinite
                    try:
                        res.provenance_replayed = diagnose_nonfinite(tr)
                    except Exception as e:
                        res.provenance_replayed = \
                            f"diagnosis-failed:{type(e).__name__}"
                return False
            if cap and res.steps_executed >= cap:
                res.notes.append(f"stopped at replay_steps cap ({cap})")
                return False
            return True

        for r in plan.rounds:
            if stop:
                break
            tr.start_round(r)
            batch_count = 0
            last_loss = float("nan")
            completed = True
            pending: List[Any] = []
            for batch in itr:
                if chain:
                    # replicate the recorded run's fused dispatch
                    # grouping exactly (main's train_chain path): same
                    # host copies, same chain boundaries
                    import numpy as np

                    from ..io.data import DataBatch
                    pending.append(DataBatch(
                        data=np.array(batch.data),
                        label=np.array(batch.label),
                        num_batch_padd=batch.num_batch_padd,
                        extra_data=[np.array(e)
                                    for e in batch.extra_data],
                        norm=batch.norm))
                    if len(pending) < chain:
                        continue
                    losses = tr.update_chain_batches(pending)
                    base = tr.step_count - len(pending) + 1
                    batch_count += len(pending)
                    pending = []
                    go = True
                    for i, lv in enumerate(
                            [float(x) for x in losses]):
                        record.step = base + i
                        last_loss = lv
                        if not record(lv):
                            go = False
                            break
                    if not go:
                        completed = False
                        stop = True
                        break
                else:
                    tr.update(batch)
                    last_loss = float(tr.last_loss)
                    batch_count += 1
                    if not record(last_loss):
                        completed = False
                        stop = True
                        break
            if not stop:
                for b in pending:    # epoch tail shorter than the chain
                    tr.update(b)
                    last_loss = float(tr.last_loss)
                    batch_count += 1
                    record.step = tr.step_count
                    if not record(last_loss):
                        completed = False
                        stop = True
                        break
            res.rounds_executed += 1
            if not completed:
                break
            # the incident round's round_end describes POST-recovery
            # state for sentinel incidents — never compare it
            if sentinel_incident and r == plan.rounds[-1]:
                continue
            rec_batches = plan.round_batches.get(r)
            if rec_batches is not None and rec_batches != batch_count:
                return _finish(res, led, plan, verdict=(
                    "unreproducible:batch-count-mismatch"),
                    detail=f"round {r}: recorded {rec_batches} "
                           f"batches, replayed {batch_count} (data "
                           "addressing diverged)")
            rec = plan.round_losses.get(r)
            if rec is not None:
                ok = _losses_equal(rec, last_loss)
                res.compared_rounds[r] = (rec, last_loss, ok)
                if not ok and first_mismatch is None:
                    first_mismatch = tr.step_count
                    stop = True

        if first_mismatch is not None:
            return _finish(res, led, plan, verdict="diverged_at_step",
                           step=first_mismatch,
                           detail="round-end loss mismatch (see "
                                  "compared rounds)")

        # incident-specific assertions
        if sentinel_incident and failpoints_on and armed:
            verdict, step, detail = _check_trip(plan, res)
            return _finish(res, led, plan, verdict=verdict, step=step,
                           detail=detail)
        if sentinel_incident and not failpoints_on:
            if res.nan_step is not None:
                return _finish(
                    res, led, plan, verdict="diverged_at_step",
                    step=res.nan_step,
                    detail="non-finite loss WITHOUT the recorded "
                           "fault armed — the incident reproduces "
                           "from data/state alone")
            res.detail = ("clean counterfactual: window re-executed "
                          "without the recorded fault; round-end "
                          "losses match" if res.compared_rounds else
                          "clean counterfactual (no comparable "
                          "round_end in window)")
        return _finish(res, led, plan, verdict=res.verdict,
                       detail=res.detail)
    finally:
        LEDGER._target = led_saved
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags_saved
        failpoints.clear("device.step")
        for k, v in env_saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        if itr is not None:
            close_chain(itr)


def _check_trip(plan: ReplayPlan, res: ReplayResult
                ) -> Tuple[str, Optional[int], str]:
    """Sentinel-trip assertions under re-armed failpoints: fault fired,
    landed by the recorded trip step, provenance string identical, and
    the trip's recorded loss vector matches positionally."""
    if res.nan_step is None:
        return ("diverged_at_step", plan.target_step,
                "recorded fault re-armed but no non-finite loss "
                "appeared in the window")
    if plan.target_step is not None and res.nan_step > plan.target_step:
        return ("diverged_at_step", res.nan_step,
                f"non-finite loss at step {res.nan_step}, after the "
                f"recorded trip step {plan.target_step}")
    if plan.provenance and res.provenance_replayed != plan.provenance:
        return ("diverged_at_step", res.nan_step,
                "NaN provenance mismatch: recorded "
                f"{plan.provenance!r}, replayed "
                f"{res.provenance_replayed!r}")
    if plan.trip_losses and plan.target_step is not None:
        by_step = dict(res.per_step)
        base = plan.target_step - len(plan.trip_losses) + 1
        for i, rec in enumerate(plan.trip_losses):
            s = base + i
            if s <= plan.start_step:
                continue
            rep = by_step.get(s)
            if rep is None:
                continue      # detection stopped replay before s
            if not _losses_equal(rec, rep):
                return ("diverged_at_step", s,
                        f"trip loss vector slot {i}: recorded "
                        f"{rec!r}, replayed {rep!r}")
    return ("bit_exact", None,
            "fault re-fired at the recorded step with identical "
            "provenance")


def _finish(res: ReplayResult, led: Optional[RunLedger],
            plan: ReplayPlan, verdict: str,
            step: Optional[int] = None, detail: str = "") -> ReplayResult:
    res.verdict = verdict
    res.step = step
    if detail:
        res.detail = detail
    if led is not None:
        led.event(
            "replay_verdict", verdict=verdict, step=step,
            detail=detail or res.detail,
            incident=plan.incident_index,
            incident_event=plan.incident.get("event"),
            source_run_id=plan.run_id,
            steps_executed=res.steps_executed,
            rounds_executed=res.rounds_executed,
            nan_step=res.nan_step,
            provenance_recorded=res.provenance_recorded,
            provenance_replayed=res.provenance_replayed,
            compared_rounds={str(k): list(v) for k, v in
                             res.compared_rounds.items()})
    return res
