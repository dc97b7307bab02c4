"""The closed-loop deployment controller: canary, gate, then promote or
roll back, with no human in the promotion path (the port of
``cxxnet_tpu/deploy/controller.py``).

It rides the :class:`~cxxnet_tpu_torch.serve.reload.ReloadWatcher`
round scan (the cheap ``find_latest`` listing gates the verified
``find_latest_valid`` read) and its drained, one-replica-at-a-time
swaps. For each new valid round:

1. **offline gate** (``gates.offline_gate``): RELOAD-UNSAFE blocks the
   round before any replica is touched, and the incident names the
   poisoned layers; RELOAD-SUSPECT stretches the canary window by
   ``deploy_suspect_factor``;
2. **canary**: host copies of the canary replicas' weights are taken
   (the rollback must not depend on the incumbent round still being on
   disk), then the first ``deploy_canary_replicas`` replicas reload the
   round through the watcher's A/B path;
3. **window**: live traffic accumulates evidence until the window,
   read on the injected ``clock``, closes;
4. **verdict**: the online gates (burn, breaker, parity) run. All
   clean: the rest of the fleet rolls onto the exact round that was
   gated, never a newer one that no gate saw. Any veto: the canaries
   are restored from their copies, the incident is kept, and the
   backoff keeps the same round from being canaried again.

``poll_s <= 0`` starts no thread: tests and ``chip_smoke.py`` tick
:meth:`DeployController.check_once` by hand. The controller has the
watcher's server-facing surface (``start``, ``stop``, ``snapshot``,
``interval_s``), so ``task = serve`` hands it to ``ServeServer`` as its
``reload_watcher``.

Where the port differs from the JAX package:

* the canary is keyed on the version its replicas serve. An int8
  replica serves round r as ``rNNNN-int8``; the JAX controller keys the
  canary on ``rNNNN``, so on an int8 fleet its parity gate pins a
  version that no replica serves and every evaluation raises
  ``UnknownVersion``;
* a round the fleet cannot serve (a plain round into an int8 fleet, a
  structure that is not the net's) is refused by the watcher before any
  replica drains, and the controller rejects it as ``blocked`` by the
  ``offline`` gate, with the backoff;

A promotion, a rollback (and each canary's ``weights_reload`` back to
its copy) and an incident are ledger events (``deploy_promote``,
``deploy_rollback``, ``deploy_incident``), as in the JAX package; the
fields of the last incident are kept in ``last_incident`` too.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

from .. import checkpoint as ckpt
from ..convert import params_to_jax
from ..serve.engine import version_name
from ..serve.fleet import ReplicaPool
from ..serve.reload import ReloadWatcher
from ..telemetry.ledger import LEDGER
from . import gates
from .gates import GateResult
from .policy import DeployConfig


class DeployController:
    """Health-gated canary deployment over a live replica pool."""

    def __init__(self, pool: ReplicaPool, model_dir: str,
                 cfg: DeployConfig, drain_timeout_s: float = 30.0,
                 clock=time.monotonic, verbose: bool = False):
        if len(pool.replicas) < 2:
            raise ValueError(
                "deploy controller needs at least 2 replicas: one "
                "canary and one incumbent to compare it against")
        self.pool = pool
        self.model_dir = model_dir
        self.cfg = cfg
        self.verbose = verbose
        self._clock = clock
        # the A/B reload machinery does the drains and swaps; interval
        # 0: the controller owns the poll cadence
        self.watcher = ReloadWatcher(
            pool, model_dir, interval_s=0,
            ab_replicas=min(cfg.canary_replicas,
                            len(pool.replicas) - 1),
            drain_timeout_s=drain_timeout_s, verbose=verbose)
        self.interval_s = cfg.poll_s    # ServeServer's watcher surface
        self.promotions = 0
        self.rollbacks = 0
        self.incidents = 0
        self.last_error: str = ""
        # the fields of the last deploy_incident (round, digest, gate,
        # reason, layers, provenance, trace_ids, rolled_back, backoff_s)
        self.last_incident: Optional[Dict[str, Any]] = None
        # the live canary (None when idle): round, digest, path, blob,
        # version, window deadline, suspect flag, the canaries' copies
        # and their breakers' opens at the start
        self._canary: Optional[Dict[str, Any]] = None
        # rejected rounds and digests are never canaried again; nothing
        # new is canaried before _hold_until
        self._rejected_rounds: set = set()
        self._rejected_digests: set = set()
        self._hold_until = 0.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()   # one check_once at a time

    # -- lifecycle (the watcher's) ---------------------------------------
    def start(self) -> "DeployController":
        if self.interval_s > 0 and self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="deploy-control")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self.watcher._stop.set()      # ends a sweep in progress too
        if self._thread is not None:
            # at most one poll and one drain
            self._thread.join(timeout=self.interval_s
                              + self.watcher.drain_timeout_s + 30)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.check_once()
            except Exception as e:   # noqa: BLE001 — the loop lives on
                # a bad poll (transient IO, a mid-write race) must not
                # end the control loop; the next tick retries
                self.last_error = f"{type(e).__name__}: {e}"
                if self.verbose:
                    print(f"deploy: poll failed: {self.last_error}",
                          flush=True)

    # -- the control loop ------------------------------------------------
    def check_once(self) -> str:
        """One tick. Returns the action taken: ``""`` (nothing to do, or
        the window is still open), ``"canary"``, ``"blocked"`` (refused
        before any replica was touched), ``"promote"`` or
        ``"rollback"``."""
        with self._lock:
            if self._canary is not None:
                return self._evaluate()
            return self._scan()

    def _scan(self) -> str:
        now = self._clock()
        if now < self._hold_until:
            return ""
        latest = ckpt.find_latest(self.model_dir)
        if latest is None or latest[0] <= self.pool.newest_round() \
                or latest[0] in self._rejected_rounds:
            return ""
        valid = ckpt.find_latest_valid(self.model_dir, want_blob=True,
                                       verbose=self.verbose)
        if valid is None:
            return ""
        r, path, blob = valid
        if r <= self.pool.newest_round() or r in self._rejected_rounds:
            return ""
        digest = ckpt.blob_digest(blob["meta"])
        if digest in self._rejected_digests:
            return ""
        # the offline gate, before any replica is touched
        inc_round = self.pool.newest_round()
        inc_blob = inc_digest = None
        if inc_round >= 0:
            try:
                inc_blob = ckpt.load_for_inference(
                    ckpt.model_path(self.model_dir, inc_round))
                inc_digest = ckpt.blob_digest(inc_blob["meta"])
            except Exception:   # noqa: BLE001 — the incumbent may be gone
                # pruned or corrupt: the gate falls back to the
                # candidate's finiteness check
                inc_blob = None
        g = gates.offline_gate(blob, inc_blob, self.cfg,
                               digest_c=digest,
                               digest_i=inc_digest or "")
        if not g.passed:
            self._reject(r, digest, g, rolled_back=False)
            return "blocked"
        suspect = bool(g.details.get("suspect"))
        window = self.cfg.window_s * (self.cfg.suspect_factor
                                      if suspect else 1.0)
        snapshots = self._snapshot_canaries()
        try:
            moved = self.watcher.reload_from_blob(blob, path=path)
        except ValueError as e:
            # refused before any replica drained: the fleet cannot serve
            # this round (its dtype or structure)
            self._reject(r, digest, GateResult(
                gate="offline", passed=False,
                reason=f"{version_name(r)} refused by the fleet: {e}"),
                rolled_back=False)
            return "blocked"
        if moved == 0:
            return ""
        idxs = list(range(self.watcher.ab_replicas))
        self._canary = {
            "round": r, "digest": digest, "path": path, "blob": blob,
            # the version the canaries serve (rNNNN-int8 on int8)
            "version": self.watcher._want(self.pool.replicas[idxs[0]], r),
            "incumbent_round": inc_round,
            "suspect": suspect,
            "deadline": self._clock() + window,
            "window_s": window,
            "idxs": idxs,
            "snapshots": snapshots,
            "baseline_opens": {i: gates.breaker_opens(self.pool, i)
                               for i in idxs},
        }
        if self.verbose:
            print(f"deploy: canary {self._canary['version']} on replicas "
                  f"{idxs}, window {window:.3g}s"
                  + (" (SUSPECT-extended)" if suspect else ""),
                  flush=True)
        return "canary"

    def _evaluate(self) -> str:
        c = self._canary
        if self._clock() < c["deadline"]:
            return ""
        results = gates.online_gates(
            self.pool, c["idxs"], c["version"],
            self._incumbent_version(c), self.cfg, c["baseline_opens"])
        failing = next((g for g in results if not g.passed), None)
        if failing is None:
            return self._promote(c, results)
        return self._rollback(c, failing)

    def _incumbent_version(self, c: Dict[str, Any]) -> str:
        """The version the replicas outside the canary serve (parity's
        other arm), read from the pool."""
        for rep in self.pool.replicas:
            if rep.idx not in c["idxs"]:
                return rep.version
        return version_name(c["incumbent_round"])

    # -- verdicts --------------------------------------------------------
    def _promote(self, c: Dict[str, Any],
                 results: List[GateResult]) -> str:
        # the exact gated round onto every replica not on it yet (not
        # watcher.promote(), which takes the newest round on disk)
        behind = [rep.idx for rep in self.pool.replicas
                  if rep.version != c["version"]]
        if behind:
            self.watcher.reload_from_blob(c["blob"], path=c["path"],
                                          targets=behind)
        vs = self.pool.version_stats().get(c["version"], {})
        LEDGER.event("deploy_promote", round=c["round"],
                     digest=c["digest"], version=c["version"],
                     window_s=round(c["window_s"], 3),
                     suspect=c["suspect"],
                     canary_replicas=len(c["idxs"]),
                     canary_requests=vs.get("requests", 0),
                     canary_failed=vs.get("failed", 0),
                     gates=[g.gate for g in results])
        self.promotions += 1
        self._canary = None
        if self.verbose:
            print(f"deploy: promoted {c['version']} "
                  f"({c['digest']})", flush=True)
        return "promote"

    def _rollback(self, c: Dict[str, Any], failing: GateResult) -> str:
        # each canary back to its copy, drained and swapped on the same
        # zero-drop path the canary took
        for snap in c["snapshots"]:
            idx = snap["idx"]
            old_round = self.pool.reload_replica(
                idx, snap["params"], snap["state"], snap["round"],
                digest=snap["digest"],
                drain_timeout_s=self.watcher.drain_timeout_s)
            eng = self.pool.replicas[idx].engine
            if snap["version"] == "init":
                # weights that never came from a round answer to "init"
                # again, not to a round-shaped pin
                with eng.net.weights_lock:
                    eng.weights_version = "init"
                    eng.weights_digest = ""
            LEDGER.event("weights_reload", replica=idx,
                         old_round=old_round, new_round=snap["round"],
                         digest=snap["digest"], path="",
                         canary=True, rollback=True)
        LEDGER.event("deploy_rollback", round=c["round"],
                     digest=c["digest"], version=c["version"],
                     incumbent_round=c["incumbent_round"],
                     replicas=list(c["idxs"]), gate=failing.gate)
        self.rollbacks += 1
        self._reject(c["round"], c["digest"], failing, rolled_back=True)
        self._canary = None
        if self.verbose:
            print(f"deploy: rolled back {c['version']} — "
                  f"{failing.gate} gate: {failing.reason}", flush=True)
        return "rollback"

    def _reject(self, r: int, digest: str, g: GateResult,
                rolled_back: bool) -> None:
        now = self._clock()
        self._rejected_rounds.add(r)
        self._rejected_digests.add(digest)
        self._hold_until = now + self.cfg.backoff_s
        self.last_incident = {
            "round": r, "digest": digest, "gate": g.gate,
            "reason": g.reason, "layers": list(g.layers),
            "provenance": g.provenance, "trace_ids": list(g.trace_ids),
            "rolled_back": rolled_back, "backoff_s": self.cfg.backoff_s}
        LEDGER.event("deploy_incident", **self.last_incident)
        self.incidents += 1

    # -- helpers ---------------------------------------------------------
    def _snapshot_canaries(self) -> List[Dict[str, Any]]:
        """Host copies of the canaries' params and BN state (JAX layout,
        as a round holds them) and their version labels: the rollback
        target. Taken under the network's ``weights_lock``, the lock a
        swap installs under, so a copy is one round's, never torn."""
        out = []
        for i in range(self.watcher.ab_replicas):
            eng = self.pool.replicas[i].engine
            with eng.net.weights_lock:
                params, state = params_to_jax(eng.net.params,
                                              eng.net.state)
                out.append({
                    "idx": i, "params": params, "state": state,
                    "round": eng.weights_round,
                    "digest": eng.weights_digest,
                    "version": eng.weights_version,
                })
        return out

    def snapshot(self) -> Dict[str, Any]:
        """The ``/statz`` ``reload`` payload, the JAX package's shape."""
        c = self._canary
        return {
            "model_dir": self.model_dir,
            "interval_s": self.interval_s,
            "state": "canary" if c is not None else "idle",
            "canary": None if c is None else {
                "round": c["round"], "version": c["version"],
                "digest": c["digest"], "suspect": c["suspect"],
                "window_s": c["window_s"], "replicas": c["idxs"]},
            "promotions": self.promotions,
            "rollbacks": self.rollbacks,
            "incidents": self.incidents,
            "rejected_rounds": sorted(self._rejected_rounds),
            "last_error": self.last_error,
            "watcher": self.watcher.snapshot(),
            "running": self._thread is not None
            and self._thread.is_alive(),
        }
