"""Promotion evidence gates of the deployment controller (the port of
``cxxnet_tpu/deploy/gates.py``).

A round is promoted on evidence, never on time alone. Before any
replica is touched the **offline gate** runs the ckpt_health verdict
(``telemetry/modelhealth.py`` :func:`reload_verdict`) over the
candidate against the incumbent: RELOAD-UNSAFE blocks and names the
poisoned layers; RELOAD-SUSPECT does not block, it buys a longer canary
window. During the window the **online gates** read what the fleet
already keeps, in veto order:

* ``burn``: the worst canary replica's SLO burn rate stays below
  ``deploy_burn_max``;
* ``breaker``: no circuit-breaker trip on a canary replica since the
  canary started;
* ``parity``: a seeded probe batch goes to the canary and to the
  incumbent version through the router's version pin, and the fraction
  of predictions that disagree stays within ``deploy_parity_tol``.

Where the port differs from the JAX package:

* a quantized incumbent is dequantized too before the offline
  comparison. The JAX gate dequantizes only the candidate, so on an
  int8 fleet every candidate reads RELOAD-UNSAFE by structure against
  its int8 incumbent (``wmat_scale`` and ``act_scale`` only in A);
* a replica without a breaker (``serve_breaker_threshold = 0``) counts
  no trips, as the burn gate reads 0 without an SLO tracker. The JAX
  controller reads ``breaker.opens`` and raises there.

A failing result carries the trace ids of the requests behind it
(``ReplicaPool.failed_traces``; sampled traces under distributed
tracing). Each version's shadow probe is the ``deploy.probe`` span,
whose trace id a failing parity gate keeps.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np

from ..telemetry.modelhealth import reload_verdict
from ..telemetry.disttrace import DISTTRACE
from .policy import DeployConfig


@dataclasses.dataclass
class GateResult:
    """One gate's verdict: passed or not, why, and the evidence an
    incident keeps (trace ids, poisoned layers, provenance)."""
    gate: str
    passed: bool
    reason: str
    details: Dict[str, Any] = dataclasses.field(default_factory=dict)
    trace_ids: List[str] = dataclasses.field(default_factory=list)
    layers: List[str] = dataclasses.field(default_factory=list)
    provenance: str = ""


# -- offline gate --------------------------------------------------------------

def offline_gate(candidate_blob, incumbent_blob, cfg: DeployConfig,
                 digest_c: str = "", digest_i: str = "",
                 quant_cfg=None) -> GateResult:
    """The ckpt_health verdict over candidate against incumbent (the
    candidate alone when there is no incumbent round). UNSAFE fails the
    gate; SUSPECT passes with ``details["suspect"] = True``.

    A quantized candidate (``__quant_meta__`` in its meta) also runs
    the PTQ drift verdict (``quant/ptq.py`` :func:`drift_verdict`): a
    drift-unsafe round never reaches a canary. The comparison runs on
    dequantized weights, the candidate's and a quantized incumbent's."""
    from .. import checkpoint as ckpt
    from ..config import QuantConfig
    from ..quant import dequantize_blob, drift_verdict
    qm = ckpt.quant_meta(candidate_blob["meta"]) \
        if isinstance(candidate_blob, dict) else None
    drift = None
    if qm is not None:
        qc = quant_cfg or QuantConfig()
        drift = drift_verdict(qm, qc.max_rel_err, qc.max_sat_frac)
        candidate_blob = dequantize_blob(candidate_blob)
    if incumbent_blob is not None \
            and ckpt.is_quantized(incumbent_blob["meta"]):
        incumbent_blob = dequantize_blob(incumbent_blob)
    res = reload_verdict(incumbent_blob, candidate_blob,
                         max_ratio=cfg.max_ratio,
                         digest_a=digest_i, digest_b=digest_c) \
        if incumbent_blob is not None else \
        reload_verdict(candidate_blob, max_ratio=cfg.max_ratio,
                       digest_a=digest_c)
    passed = res["exit_code"] != 2
    reason = res["line"]
    details = {"verdict": res["verdict"],
               "suspect": res["exit_code"] == 1,
               "worst": res["worst"]}
    layers = list(res["layers"])
    if drift is not None:
        details["quant_drift"] = {
            "verdict": drift["verdict"],
            "worst_rel_err": drift["worst_rel_err"],
            "worst_sat_frac": drift["worst_sat_frac"],
            "source_round": drift["source_round"],
            "source_digest": drift["source_digest"]}
        reason += "; " + drift["line"]
        if not drift["ok"]:
            passed = False
            layers += [r["layer"] for r in drift["layers"]
                       if not r["ok"]]
    return GateResult(
        gate="offline", passed=passed, reason=reason,
        details=details, layers=layers, provenance=res["provenance"])


# -- online gates --------------------------------------------------------------

def breaker_opens(pool, idx: int) -> int:
    """How often replica ``idx``'s breaker opened (0 without one)."""
    br = pool.replicas[idx].breaker
    return br.opens if br is not None else 0


def burn_gate(pool, canary_idxs: List[int], canary_version: str,
              cfg: DeployConfig) -> GateResult:
    """The worst canary replica's SLO burn rate below
    ``deploy_burn_max``. With SLO tracking off (``serve_slo_ms = 0``)
    every burn reads 0.0 and the gate passes; the breaker and parity
    gates still stand."""
    burns = {i: pool.replicas[i].burn_rate() for i in canary_idxs}
    worst = max(burns.values()) if burns else 0.0
    ok = worst < cfg.burn_max
    return GateResult(
        gate="burn", passed=ok,
        reason=("canary burn %.3g within deploy_burn_max %.3g"
                % (worst, cfg.burn_max)) if ok else
               ("canary SLO burn %.3g >= deploy_burn_max %.3g"
                % (worst, cfg.burn_max)),
        details={"burns": burns, "burn_max": cfg.burn_max},
        trace_ids=[] if ok else pool.failed_traces(canary_version))


def breaker_gate(pool, canary_idxs: List[int], canary_version: str,
                 baseline_opens: Dict[int, int]) -> GateResult:
    """No circuit-breaker trip on a canary replica since the window
    opened (``baseline_opens``: each replica's :func:`breaker_opens`
    when the canary started)."""
    trips = {i: breaker_opens(pool, i) - baseline_opens.get(i, 0)
             for i in canary_idxs}
    total = sum(trips.values())
    return GateResult(
        gate="breaker", passed=total == 0,
        reason="zero canary breaker trips" if total == 0 else
               "%d canary breaker trip(s): %s" % (total, trips),
        details={"trips": trips},
        trace_ids=[] if total == 0 else
        pool.failed_traces(canary_version))


def probe_batch(rows: int, width: int, seed: int) -> np.ndarray:
    """The probe set: the same seed gives the same rows, so canary and
    incumbent answer the same questions every window."""
    return np.random.RandomState(seed).randn(rows, width) \
        .astype(np.float32)


def parity_gate(pool, canary_version: str, incumbent_version: str,
                cfg: DeployConfig, width: Optional[int] = None,
                timeout_s: float = 60.0) -> GateResult:
    """Output parity against the incumbent: one probe batch submitted
    to each version through the router's version pin, predictions
    compared row by row; the fraction that disagrees must stay within
    ``deploy_parity_tol``."""
    eng = pool.replicas[0].engine
    if width is None:
        c, y, x = eng.input_shape
        width = c * y * x
    probes = probe_batch(cfg.probe_rows, width, cfg.probe_seed)
    # chunks of the batcher's per-request cap: the probe set's size is
    # a policy knob, the admission limit the operator's
    chunk = max(1, eng.max_batch)
    outs: Dict[str, np.ndarray] = {}
    tids: List[str] = []
    for ver in (canary_version, incumbent_version):
        with DISTTRACE.span("deploy.probe", cat="deploy",
                            args={"version": ver,
                                  "rows": cfg.probe_rows}) as sp:
            ctx = getattr(sp, "ctx", None)
            if ctx is not None and ctx.sampled:
                tids.append(ctx.trace_id)
            futs = [pool.submit(probes[off:off + chunk], kind="predict",
                                version=ver)
                    for off in range(0, cfg.probe_rows, chunk)]
        outs[ver] = np.concatenate(
            [np.asarray(f.result(timeout=timeout_s)) for f in futs])
    disagree = outs[canary_version] != outs[incumbent_version]
    frac = float(np.mean(disagree))
    ok = frac <= cfg.parity_tol
    return GateResult(
        gate="parity", passed=ok,
        reason=("probe parity %.3g within deploy_parity_tol %.3g"
                % (frac, cfg.parity_tol)) if ok else
               ("%d/%d probe predictions disagree with incumbent "
                "(%.3g > deploy_parity_tol %.3g)"
                % (int(disagree.sum()), cfg.probe_rows, frac,
                   cfg.parity_tol)),
        details={"disagree_frac": frac, "rows": cfg.probe_rows,
                 "canary": canary_version,
                 "incumbent": incumbent_version},
        trace_ids=[] if ok else tids)


def online_gates(pool, canary_idxs: List[int], canary_version: str,
                 incumbent_version: str, cfg: DeployConfig,
                 baseline_opens: Dict[int, int]) -> List[GateResult]:
    """The window's gates in veto order, cheap statistics first and the
    probe traffic last (a burn or breaker veto sends no probes to a
    canary already condemned). Returns the results up to and including
    the first failure."""
    out = [burn_gate(pool, canary_idxs, canary_version, cfg)]
    if not out[-1].passed:
        return out
    out.append(breaker_gate(pool, canary_idxs, canary_version,
                            baseline_opens))
    if not out[-1].passed:
        return out
    out.append(parity_gate(pool, canary_version, incumbent_version,
                           cfg))
    return out
