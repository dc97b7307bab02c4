"""Incident reconstruction: ledger + checkpoint store -> replay plan (the
port of ``cxxnet_tpu/replay/reconstruct.py``: the same incidents, plan,
config drift check and failpoint step compensation, so both packages
build the same plan from one ledger).

Time-travel debugging's first half:
given a run ledger and one incident event in it (a ``sentinel_trip``,
``rollback``, ``deploy_incident``, ``dataservice_degrade``, or a
``straggler`` round), rebuild everything needed to re-execute the
offending steps in ONE local process:

* the **resolved config** — the post-parse, post-CLI-override snapshot
  ``run_start`` records (inline ``config`` pairs, or reassembled from
  ``config_chunk`` events), cross-checked against the recorded
  ``config_hash`` so a truncated snapshot fails loudly instead of
  replaying the wrong config, and optionally diffed against a live
  config tree (:func:`diff_config` — loud :class:`ConfigDriftError`);
* the **checkpoint round** — for a rollback, the exact ``to_round``
  checkpoint the incident restored; otherwise the newest round on disk
  ≤ the incident's round - 1 that PASSES verification (walking
  backward exactly like the resume scan);
* the **data-address window** — the rounds ``(r0, incident_round]``;
  batches are a pure function of ``(config, data_service_seed, epoch,
  shard, batch_idx)``, so the window plus the recorded seed IS the
  address set (``executor.py`` feeds it through ``data_service=local``,
  the digest-equal control stream);
* the **failpoint spec** — the armed sites ``run_start`` recorded,
  step-compensated (:func:`compensate_failpoints`) so a fault that
  fired at absolute step S in the original process fires at the same
  absolute step in a replay whose counters restart at the checkpoint.

Everything here is pure bookkeeping over the ledger record — no
devices; ``executor.py`` owns the re-execution.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Tuple

from ..telemetry.ledger import config_hash, read_ledger

#: the replayable incident event types, in the order ``--list`` indexes
#: them (the JAX package's tools/report.py and tools/replay.py too)
INCIDENT_EVENTS = ("sentinel_trip", "rollback", "deploy_incident",
                   "dataservice_degrade", "straggler")


class ReconstructError(RuntimeError):
    """The incident cannot be reconstructed; ``reason`` is the short
    machine slug the ``replay_verdict`` event carries as
    ``unreproducible:<reason>``."""

    def __init__(self, reason: str, detail: str = ""):
        self.reason = reason
        super().__init__(f"unreproducible:{reason}"
                         + (f" — {detail}" if detail else ""))


class ConfigDriftError(ReconstructError):
    """The recorded config snapshot disagrees with the live tree —
    replaying would silently debug a DIFFERENT program, so this is
    loud by default (``replay_strict=0`` downgrades it)."""

    def __init__(self, diffs: List[Tuple[str, Optional[str],
                                         Optional[str]]]):
        self.diffs = diffs
        lines = "; ".join(
            f"{k}: recorded={a!r} live={b!r}" for k, a, b in diffs[:8])
        more = f" (+{len(diffs) - 8} more)" if len(diffs) > 8 else ""
        super().__init__("config-drift", lines + more)


# -- the plan -----------------------------------------------------------------

@dataclasses.dataclass
class ReplayPlan:
    """Everything executor.py needs, all plain data (JSON-able except
    nothing — kept that way so tests can synthesize plans directly)."""
    ledger_path: str
    incident: Dict[str, Any]          # the raw incident event
    incident_index: int               # index among INCIDENT_EVENTS rows
    run_id: str
    host: int
    config_pairs: List[Tuple[str, str]]   # the resolved snapshot
    config_hash: str
    model_dir: str
    start_round: int                  # checkpoint round restored (r0)
    ckpt_path: str
    start_step: int                   # step_count at that checkpoint
    rounds: List[int]                 # window: r0+1 .. incident round
    target_step: Optional[int]        # sentinel trip's absolute step
    round_losses: Dict[int, float]    # recorded round_end losses
    round_batches: Dict[int, int]     # recorded round_end batch counts
    trip_losses: Optional[List[Optional[float]]]  # trip's loss vector
    provenance: Optional[str]         # recorded layer=/kind= string
    failpoints: Dict[str, str]        # armed spec as recorded
    failpoint_seed: int
    nan_layer: str
    data_service_seed: int
    data_service_shards: int
    notes: List[str] = dataclasses.field(default_factory=list)

    @property
    def replay_failpoints(self) -> Dict[str, str]:
        """The recorded spec, step-compensated to this plan's window."""
        spec, notes = compensate_failpoints(self.failpoints,
                                            self.start_step)
        return spec


def list_incidents(events: List[Dict[str, Any]]
                   ) -> List[Dict[str, Any]]:
    """The replayable incidents of a ledger, in file order — the index
    into this list is the ``--incident N`` / ``replay_incident``
    address (and what report.py prints next to each timeline row)."""
    return [e for e in events if e.get("event") in INCIDENT_EVENTS]


def diff_config(recorded: List[Tuple[str, str]],
                live: List[Tuple[str, str]]
                ) -> List[Tuple[str, Optional[str], Optional[str]]]:
    """Order-sensitive diff of two config pair lists. This dialect is
    positional (layer params attach to the preceding layer line), so
    the diff walks both sequences in lockstep and reports the first
    class of mismatch per position plus any length overhang; a
    reordering IS drift even when the multisets agree."""
    out: List[Tuple[str, Optional[str], Optional[str]]] = []
    rec = [(str(k), str(v)) for k, v in recorded]
    liv = [(str(k), str(v)) for k, v in live]
    for i in range(max(len(rec), len(liv))):
        a = rec[i] if i < len(rec) else None
        b = liv[i] if i < len(liv) else None
        if a == b:
            continue
        key = (a or b)[0] if (a is None or b is None or a[0] == b[0]) \
            else f"{a[0]} vs {b[0]}"
        out.append((f"[{i}] {key}",
                    None if a is None else f"{a[0]} = {a[1]}",
                    None if b is None else f"{b[0]} = {b[1]}"))
    return out


def compensate_failpoints(spec: Dict[str, str], start_step: int
                          ) -> Tuple[Dict[str, str], List[str]]:
    """Shift the recorded fault schedule to a replay that starts at
    ``start_step``. ``device.step`` is checked exactly once per trainer
    update, so its check counter equals the post-update step count —
    the original run's check k is the replay's check k - start_step:

    * ``every:N``   -> ``every:N@(start_step % N)`` (fires at the same
      absolute steps);
    * ``prob:p``    -> ``prob:p@start_step`` (the per-site RNG stream
      advanced past the draws the original already made);
    * ``once``      -> kept only when ``start_step == 0`` (it fired at
      the original's first check, before this window).

    Sites whose check cadence is NOT step-aligned (io/ckpt/serve/data
    sites fire per IO op, not per step) pass through unchanged with a
    note — their faults never alter the loss stream (retries and
    tolerated write failures are value-neutral), only its timing."""
    out: Dict[str, str] = {}
    notes: List[str] = []
    for name, mode in (spec or {}).items():
        if name != "device.step" or start_step == 0:
            if name != "device.step":
                notes.append(
                    f"failpoint {name}={mode} re-armed uncompensated "
                    "(not step-aligned; value-neutral)")
            out[name] = mode
            continue
        if mode == "once":
            notes.append("failpoint device.step=once fired before the "
                         "window; not re-armed")
            continue
        if mode.startswith("every:"):
            body = mode[6:].split("@", 1)
            n = int(body[0])
            phase = int(body[1]) if len(body) > 1 else 0
            out[name] = f"every:{n}@{(phase + start_step) % n}"
        elif mode.startswith("prob:"):
            body = mode[5:].split("@", 1)
            skip = int(body[1]) if len(body) > 1 else 0
            out[name] = f"prob:{body[0]}@{skip + start_step}"
        else:   # bare-float prob shorthand
            out[name] = f"prob:{mode}@{start_step}"
    return out, notes


# -- reconstruction -----------------------------------------------------------

def _run_start_for(events: List[Dict[str, Any]], incident: Dict[str, Any]
                   ) -> Dict[str, Any]:
    """The run_start that governs an incident: same run_id, preferring
    the incident's own host (multi-host ledgers carry one run_start per
    rank; the config snapshot agrees across ranks of one run)."""
    rid = incident.get("run_id")
    host = incident.get("host")
    candidates = [e for e in events if e.get("event") == "run_start"
                  and e.get("run_id") == rid]
    if not candidates:
        raise ReconstructError(
            "no-run-start",
            f"ledger has no run_start for run_id={rid!r}")
    for e in candidates:
        if e.get("host") == host:
            return e
    return candidates[0]


def _assemble_config(events: List[Dict[str, Any]],
                     rs: Dict[str, Any]) -> List[Tuple[str, str]]:
    """The resolved config snapshot: inline, or reassembled from this
    run_start's config_chunk events; hash-checked either way."""
    if rs.get("config") is not None:
        pairs = [(str(k), str(v)) for k, v in rs["config"]]
    elif rs.get("config_chunks"):
        total = int(rs["config_chunks"])
        chunks = [e for e in events if e.get("event") == "config_chunk"
                  and e.get("run_id") == rs.get("run_id")
                  and e.get("host") == rs.get("host")]
        by_seq = {int(e.get("seq", -1)): e for e in chunks}
        missing = [i for i in range(total) if i not in by_seq]
        if missing:
            raise ReconstructError(
                "config-chunks-missing",
                f"config_chunk seq {missing} of {total} absent "
                "(torn ledger tail?)")
        pairs = [(str(k), str(v)) for i in range(total)
                 for k, v in by_seq[i].get("pairs", [])]
    else:
        raise ReconstructError(
            "no-config-snapshot",
            "run_start carries neither config nor config_chunks — the "
            "ledger predates replay recording (re-run with a current "
            "build to make incidents replayable)")
    want = rs.get("config_hash")
    if want and config_hash(pairs) != want:
        raise ReconstructError(
            "config-snapshot-corrupt",
            f"reassembled snapshot hashes to {config_hash(pairs)}, "
            f"run_start recorded {want} (truncated snapshot?)")
    return pairs


def _incident_round(incident: Dict[str, Any],
                    events: List[Dict[str, Any]]) -> int:
    """The round an incident belongs to: its own ``round`` field when
    present, else inferred from the surrounding round_end timeline."""
    if incident.get("round") is not None:
        return int(incident["round"])
    ts = incident.get("ts", 0)
    host = incident.get("host")
    rid = incident.get("run_id")
    rounds = [e for e in events if e.get("event") == "round_end"
              and e.get("run_id") == rid and e.get("host") == host
              and e.get("round") is not None]
    after = [e for e in rounds if e.get("ts", 0) >= ts]
    if after:
        return int(after[0]["round"])
    if rounds:
        return int(rounds[-1]["round"]) + 1
    raise ReconstructError(
        "no-round", "incident carries no round and the ledger has no "
        "round_end events to infer one from")


def _newest_valid_at_or_before(model_dir: str, round_limit: int,
                               prefer_path: str = ""):
    """Resume-scan semantics bounded above: newest (round, path) with
    round <= round_limit that passes full verification. A rollback
    incident's recorded ``path`` is tried first — replay should restore
    the exact checkpoint the incident did."""
    from .. import checkpoint as ckpt
    from ..io import stream
    if prefer_path and (stream.exists(prefer_path)
                        or stream.isdir(prefer_path)):
        try:
            meta = ckpt.verify_model(prefer_path)
            if int(meta.get("round", -1)) <= round_limit:
                return int(meta["round"]), prefer_path, meta
        except Exception:
            pass     # rotated/corrupt since: fall through to the scan
    for r, path in ckpt._scan_rounds(model_dir):
        if r > round_limit:
            continue
        try:
            meta = ckpt.verify_model(path)
            return r, path, meta
        except Exception:
            continue
    return None


def _paired_trip(events: List[Dict[str, Any]], rollback: Dict[str, Any]
                 ) -> Dict[str, Any]:
    """The ``sentinel_trip`` a ``rollback`` answers: the last one before
    it of the same run, host and round (the rollback itself when the
    ledger has none)."""
    trip = rollback
    for e in events:
        if e is rollback:
            break
        if e.get("event") == "sentinel_trip" and all(
                e.get(k) == rollback.get(k)
                for k in ("run_id", "host", "round")):
            trip = e
    return trip


def reconstruct(ledger_path: str,
                incident: Optional[int] = None,
                model_dir: str = "",
                live_config: Optional[List[Tuple[str, str]]] = None,
                strict: bool = True,
                max_steps: int = 0) -> ReplayPlan:
    """Build the replay plan for one ledger incident.

    ``incident`` indexes :func:`list_incidents` (None or -1 = last).
    ``model_dir`` overrides the recorded config's checkpoint store
    (the store may have been copied off the fleet for local debugging).
    ``live_config`` (parsed pairs of the current config tree) is
    diffed against the recorded snapshot — any drift raises
    :class:`ConfigDriftError` under ``strict`` (the default), else
    prints a warning and trusts the RECORDED snapshot."""
    if not os.path.exists(ledger_path):
        raise ReconstructError("no-ledger", f"{ledger_path} not found")
    events = read_ledger(ledger_path)
    incidents = list_incidents(events)
    if not incidents:
        raise ReconstructError("no-incidents",
                               f"{ledger_path} records no "
                               f"{'/'.join(INCIDENT_EVENTS)} events")
    idx = len(incidents) - 1 if incident is None or incident < 0 \
        else int(incident)
    if not 0 <= idx < len(incidents):
        raise ReconstructError(
            "bad-incident-index",
            f"--incident {idx} outside 0..{len(incidents) - 1}")
    inc = incidents[idx]
    rs = _run_start_for(events, inc)
    pairs = _assemble_config(events, rs)
    if live_config is not None:
        diffs = diff_config(pairs, live_config)
        if diffs:
            err = ConfigDriftError(diffs)
            if strict:
                raise err
            print(f"WARNING: {err} — replaying the RECORDED config",
                  flush=True)

    gp = {k: v for k, v in pairs}    # last occurrence wins, like main
    model_dir = model_dir or gp.get("model_dir", "./models")
    inc_round = _incident_round(inc, events)
    prefer = inc.get("path", "") if inc.get("event") == "rollback" \
        else ""
    limit = int(inc["to_round"]) if inc.get("event") == "rollback" \
        and inc.get("to_round") is not None else inc_round - 1
    found = _newest_valid_at_or_before(model_dir, limit,
                                       prefer_path=prefer)
    if found is None:
        raise ReconstructError(
            "no-valid-checkpoint",
            f"no verifiable checkpoint <= round {limit} in "
            f"{model_dir} (rotated away? keep_incident_rounds pins "
            "incident rounds on current builds)")
    r0, ckpt_path, meta = found
    sc = meta.get("step_count")
    rounds = list(range(r0 + 1, inc_round + 1))
    rl: Dict[int, float] = {}
    rb: Dict[int, int] = {}
    cum_steps: Dict[int, int] = {}
    for e in events:
        if e.get("event") == "round_end" \
                and e.get("run_id") == inc.get("run_id") \
                and e.get("host") == inc.get("host") \
                and e.get("round") in rounds:
            r = int(e["round"])
            if e.get("loss") is not None:
                rl[r] = float(e["loss"])
            if e.get("batches") is not None:
                rb[r] = int(e["batches"])
            if e.get("step_count") is not None:
                cum_steps[r] = int(e["step_count"])
    if sc is None:
        # pre-step_count checkpoint meta: derive from the recorded
        # round_end cumulative counters when they cover round r0
        sc = cum_steps.get(r0)
        if sc is None:
            raise ReconstructError(
                "no-step-count",
                f"checkpoint {ckpt_path} predates step_count metas and "
                "the ledger round_end events don't cover its round")
    notes: List[str] = []
    # an EARLIER incident inside the window means the original stream
    # in these rounds was not fault-free relative to this checkpoint —
    # its rollback rewound state mid-window and round_end losses after
    # it describe the post-rollback trajectory
    for j, other in enumerate(incidents):
        if j == idx or other is inc:
            continue
        if other.get("run_id") != inc.get("run_id"):
            continue
        orr = other.get("round")
        if orr is not None and r0 < int(orr) < inc_round:
            raise ReconstructError(
                "prior-incident-in-window",
                f"incident {j} ({other.get('event')}) at round {orr} "
                f"falls inside the window ({r0}, {inc_round}) — replay "
                f"that incident first (--incident {j})")
    spec = dict(rs.get("failpoints") or {})
    _, comp_notes = compensate_failpoints(spec, int(sc))
    notes.extend(comp_notes)
    # a rollback records the restored step count: the step and the
    # losses of the trip it answers are in its sentinel_trip
    trip = _paired_trip(events, inc) if inc.get("event") == "rollback" \
        else inc
    return ReplayPlan(
        ledger_path=os.path.abspath(ledger_path),
        incident=inc, incident_index=idx,
        run_id=str(inc.get("run_id", "")), host=int(inc.get("host", 0)),
        config_pairs=pairs,
        config_hash=str(rs.get("config_hash", "")),
        model_dir=model_dir,
        start_round=r0, ckpt_path=ckpt_path, start_step=int(sc),
        rounds=rounds,
        target_step=(int(trip["step"]) if trip.get("step") is not None
                     else None),
        round_losses=rl, round_batches=rb,
        trip_losses=trip.get("losses"),
        provenance=inc.get("provenance"),
        failpoints=spec,
        failpoint_seed=int(rs.get("failpoint_seed", 0) or 0),
        nan_layer=str(rs.get("nan_layer", "") or ""),
        data_service_seed=int(rs.get("data_service_seed", 0) or 0),
        data_service_shards=int(rs.get("data_service_shards", 0) or 0),
        notes=notes)
