"""Hot weight reload for the serving fleet (the port of
``cxxnet_tpu/serve/reload.py``).

A trainer writes ``%04d.model`` rounds into ``model_dir`` while this
watcher polls the directory and rolls each new round into the replica
pool, one replica at a time, each drained before its weights swap: no
request is dropped and none sees a half-loaded model. Safety comes from
the checkpoint scans: the cheap :func:`checkpoint.find_latest` listing
gates the expensive :func:`checkpoint.find_latest_valid` read, which
verifies digests and falls back past torn rounds.

A/B pins ride the same path: with ``ab_replicas = k`` a reload updates
only the first k replicas, the rest keep the old version (per-version
stats in /statz, ``version`` / ``X-Model-Version`` routing) until
:meth:`ReloadWatcher.promote` rolls them forward.

Where the port differs from the JAX package: a replica is stale when
its version is not the one it would serve at the new round, the round's
version name with its engine's ``-int8`` suffix. The JAX watcher
compares the bare round name, so an int8 fleet looks stale on every
poll and re-reads, drains and swaps the same round each tick. A round
the fleet cannot serve (a plain round into an int8 fleet, a structure
that is not the net's) is refused before any replica drains, once per
round file, with ``last_error`` naming the cause; the replicas stay UP
on their weights. An fp fleet dequantizes a quantized round, as its
build does (``negotiate_blob``). Each replica's drain and swap is the
``serve.reload`` span and a ``weights_reload`` ledger event.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, List, Optional, Tuple

from .. import checkpoint as ckpt
from ..telemetry.ledger import LEDGER
from ..telemetry.disttrace import DISTTRACE
from .engine import negotiate_blob
from .fleet import Replica, ReplicaPool, version_name


class ReloadWatcher:
    """Poll ``model_dir`` and roll new rounds into ``pool``.

    ``interval_s <= 0`` starts no thread: the watcher is then driven by
    hand (:meth:`check_once`), as the tests and ``chip_smoke.py`` do."""

    def __init__(self, pool: ReplicaPool, model_dir: str,
                 interval_s: float = 30.0,
                 ab_replicas: int = 0,
                 drain_timeout_s: float = 30.0,
                 verbose: bool = False):
        self.pool = pool
        self.model_dir = model_dir
        self.interval_s = float(interval_s)
        # the canary subset: 0 reloads the whole pool; k >= 1 only the
        # first k replicas, clamped so one keeps the old version
        self.ab_replicas = max(0, min(int(ab_replicas),
                                      len(pool.replicas) - 1))
        self.drain_timeout_s = float(drain_timeout_s)
        self.verbose = verbose
        self.reloads = 0               # completed sweeps
        self.refusals = 0              # rounds refused before a drain
        self.last_error: str = ""
        self._refused: Optional[Tuple] = None   # the round file refused
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()  # one sweep at a time

    # -- lifecycle -------------------------------------------------------
    def start(self) -> "ReloadWatcher":
        if self.interval_s > 0 and self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="serve-reload")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            # a sweep checks the stop event between replicas: the wait
            # is one poll plus one drain at most
            self._thread.join(timeout=self.interval_s
                              + self.drain_timeout_s + 30)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.check_once()
            except Exception as e:    # noqa: BLE001 — the watcher lives on
                # a bad poll (transient IO, a mid-write race) must not
                # end the watcher; the next tick retries
                self.last_error = f"{type(e).__name__}: {e}"
                if self.verbose:
                    print(f"serve-reload: poll failed: {self.last_error}",
                          flush=True)

    # -- polling ---------------------------------------------------------
    @staticmethod
    def _want(rep: Replica, target_round: int) -> str:
        """The version ``rep`` serves once at ``target_round``."""
        return version_name(target_round) \
            + ("-int8" if rep.engine.serve_int8 else "")

    def _stale(self, target_round: int) -> List[int]:
        """Replicas of the reload scope (the canaries in A/B mode, else
        every one) not serving ``target_round``. Keyed on each replica's
        version, so a sweep that failed partway retries the stragglers
        on the next tick instead of leaving a mixed pool."""
        scope = range(self.ab_replicas or len(self.pool.replicas))
        return [i for i in scope if self.pool.replicas[i].version
                != self._want(self.pool.replicas[i], target_round)]

    @staticmethod
    def _file_key(r: int, path: str) -> Tuple:
        """A round file's identity: a refused round is not read again
        until it is rewritten."""
        try:
            st = os.stat(path)
            return (r, path, st.st_mtime_ns, st.st_size)
        except OSError:
            return (r, path)

    def check_once(self) -> bool:
        """One poll; True when replicas swapped. The cheap listing gates
        the verified read, so a steady state costs one listdir a tick."""
        latest = ckpt.find_latest(self.model_dir)
        if latest is None or not self._stale(latest[0]) \
                or self._file_key(*latest) == self._refused:
            return False
        valid = ckpt.find_latest_valid(self.model_dir, want_blob=True,
                                       verbose=self.verbose)
        if valid is None:
            return False
        r, path, blob = valid
        stale = self._stale(r)       # the newest file may not verify:
        if not stale or self._file_key(r, path) == self._refused:
            return False             # re-check at the round that did
        try:
            return self.reload_from_blob(blob, path=path,
                                         targets=stale) > 0
        except ValueError as e:      # refused before any replica drained
            self._refused = self._file_key(r, path)
            self.refusals += 1
            self.last_error = (f"{version_name(r)} refused ({path}): {e}; "
                               f"serving {sorted(self.pool.versions())}")
            if self.verbose:
                print(f"serve-reload: {self.last_error}", flush=True)
            return False

    def _accept(self, blob: Dict[str, Any], idx: int) -> Dict[str, Any]:
        """The blob as the fleet serves it, or ValueError: its structure
        checked against replica ``idx``'s graph (every replica shares the
        net config), its dtype negotiated for the fleet's engines."""
        first = self.pool.replicas[idx].engine
        ckpt.check_structure(blob["meta"],
                             first.net.graph.structure_signature())
        return negotiate_blob(blob, "int8" if first.serve_int8 else None)

    def reload_from_blob(self, blob: Dict[str, Any], path: str = "",
                         targets: Optional[List[int]] = None) -> int:
        """Roll a verified round into the target replicas one at a time,
        each drained first; returns how many swapped. Raises ValueError,
        before any replica is touched, for a round the fleet cannot
        serve. The stop event is checked between replicas, so teardown
        never waits out a whole rolling drain: the stragglers of an
        aborted sweep are retried by the stale gate next tick, and only
        a sweep that finished every target counts in ``reloads``. The
        log line calls it a canary sweep when every target lies in the
        canary subset."""
        new_round = int(blob["meta"]["round"])
        digest = ckpt.blob_digest(blob["meta"])
        targets = (self._stale(new_round) if targets is None
                   else list(targets))
        if not targets:
            return 0
        done = 0
        canary = max(targets) < self.ab_replicas
        with self._lock:
            blob = self._accept(blob, targets[0])
            for idx in targets:
                if self._stop.is_set():
                    break
                # each replica's drain and swap under a distributed
                # span: its replica_state transitions and weights_reload
                # carry the sweep's trace
                with DISTTRACE.span("serve.reload", cat="serve",
                                    args={"replica": idx,
                                          "round": new_round,
                                          "digest": digest,
                                          "canary": canary}):
                    old_round = self.pool.reload_replica(
                        idx, blob["params"], blob["state"], new_round,
                        digest=digest, drain_timeout_s=self.drain_timeout_s)
                    tp = DISTTRACE.current_traceparent()
                    LEDGER.event(
                        "weights_reload", replica=idx, old_round=old_round,
                        new_round=new_round, digest=digest, path=path,
                        canary=canary,
                        **({"traceparent": tp} if tp else {}))
                done += 1
            if done == len(targets):
                self.reloads += 1
        if self.verbose and done:
            mode = f"canary x{done}" if canary else f"all x{done}"
            tail = "" if done == len(targets) \
                else f" (aborted; {len(targets) - done} left stale)"
            print(f"serve-reload: {version_name(new_round)} "
                  f"({digest or 'no digest'}) -> {mode} replicas{tail}",
                  flush=True)
        return done

    def promote(self) -> bool:
        """A/B promotion: roll every replica not at the newest valid
        round forward to it (a canary that fell behind a newer round
        moves too, so promotion cannot lose a race with a trainer still
        writing rounds). True when anything moved."""
        valid = ckpt.find_latest_valid(self.model_dir, want_blob=True,
                                       verbose=self.verbose)
        if valid is None:
            return False
        r, path, blob = valid
        behind = [rep.idx for rep in self.pool.replicas
                  if rep.version != self._want(rep, r)]
        if not behind:
            return False
        return self.reload_from_blob(blob, path=path, targets=behind) > 0

    def snapshot(self) -> Dict[str, Any]:
        return {
            "model_dir": self.model_dir,
            "interval_s": self.interval_s,
            "ab_replicas": self.ab_replicas,
            "reloads": self.reloads,
            "last_error": self.last_error,
            "running": self._thread is not None
            and self._thread.is_alive(),
        }
