"""Named fault-injection sites (failpoints) for deterministic chaos tests
(the port's copy of ``cxxnet_tpu/resilience/failpoints.py``).

Every failure path the port claims to survive (a checkpoint write dying,
a flaky read, a corrupt record, a NaN device step, a failing serve
dispatch) is guarded by a named site in the code
(``failpoints.fire("ckpt.write")``). An armed site makes the failure
happen on demand; a disarmed one costs one dict lookup under a lock.
Armed from the environment or the config, as in the JAX package:

    CXXNET_FAILPOINTS="ckpt.write=once,io.read=0.01,device.step=every:25"

or ``failpoints = "..."`` in the config (``main.py`` installs both; env
entries override config entries of the same site).

Modes per site:

* ``once``: fire on the next check, then disarm;
* ``every:N``: fire on every Nth check (``every:N@P`` offsets the count
  by P);
* ``prob:p``: fire with probability p a check, from a per-site RNG
  seeded by ``CXXNET_FAILPOINT_SEED`` and the site's name, so a run is
  reproducible (a bare float ``0.01`` means ``prob:0.01``; ``prob:p@K``
  discards the first K draws);
* ``off``: an explicit no-op (overrides an env entry).

Sites in the port:

====================  =====================================================
``ckpt.write``        checkpoint.save_model, before anything is written
``io.open``           io.stream: every open (sopen, read_bytes, a remote
                      write)
``io.read``           io.stream: the read of a whole object (read_bytes)
                      and every read() of a file sopen hands out while
                      the site is armed
``io.write``          io.stream.write_bytes_atomic: after the temp file is
                      written and before the rename (leaves a ``.tmp``
                      orphan, which the resume scan sweeps); remote:
                      before the put
``record.decode``     io.recordio.RecordReader, each record (a corrupt
                      record: skipped and counted as recordio.skipped)
``device.step``       trainer.Trainer.update, after the step (poisons
                      params and loss with NaN: the divergence the
                      sentinel must catch and roll back)
``serve.infer``       serve.engine.InferenceEngine.run_padded (a failing
                      dispatch, what trips the serve breaker)
``data.fetch``        data_service.client, each fetch attempt (retried,
                      then failed over like a dead reader)
``data.serve``        data_service.reader, each fetch request (answered
                      with an error frame)
====================  =====================================================

While any ``io.*`` site is armed, local stream operations take the
retry path of remote ones (``io.retries``), as in the JAX package.
"""

from __future__ import annotations

import hashlib
import os
import random
import threading
from typing import Dict, List, Optional, Tuple

ENV_VAR = "CXXNET_FAILPOINTS"
SEED_ENV_VAR = "CXXNET_FAILPOINT_SEED"


class InjectedFault(RuntimeError):
    """The default exception an armed failpoint raises via check()."""


class FailpointSpecError(ValueError):
    """Malformed failpoint spec string."""


class _Site:
    __slots__ = ("name", "mode", "n", "p", "rng", "checks", "fires",
                 "phase", "skip")

    def __init__(self, name: str, mode: str, n: int = 0, p: float = 0.0,
                 seed: int = 0, phase: int = 0, skip: int = 0):
        self.name = name
        self.mode = mode          # "once" | "every" | "prob"
        self.n = n
        self.p = p
        self.phase = phase        # every:N@P — replayed-counter offset
        self.skip = skip          # prob:p@K — draws already consumed
        # per-site seeded RNG: prob-mode fire sequences are reproducible
        # run-to-run (chaos tests must never be flaky). The python
        # string hash is salted per process (PYTHONHASHSEED), which
        # would make "reproducible" a lie across processes — and replay
        # runs in a DIFFERENT process than the run it reproduces — so
        # derive the per-site salt from a stable digest instead.
        site_salt = int.from_bytes(
            hashlib.sha256(name.encode("utf-8")).digest()[:4], "big")
        self.rng = random.Random(site_salt ^ seed)
        for _ in range(skip):
            self.rng.random()
        self.checks = 0
        self.fires = 0

    def should_fire(self) -> bool:
        self.checks += 1
        if self.mode == "once":
            return self.checks == 1
        if self.mode == "every":
            return (self.checks + self.phase) % self.n == 0
        return self.rng.random() < self.p     # "prob"


def _parse_mode(name: str, mode: str, seed: int) -> Optional[_Site]:
    mode = mode.strip()
    if mode in ("off", "0", ""):
        return None
    if mode == "once":
        return _Site(name, "once", seed=seed)
    if mode.startswith("every:"):
        body, _, ph = mode[6:].partition("@")
        try:
            n = int(body)
            phase = int(ph) if ph else 0
        except ValueError:
            raise FailpointSpecError(
                f"failpoint {name}: bad every:N[@P] spec {mode[6:]!r}")
        if n < 1:
            raise FailpointSpecError(
                f"failpoint {name}: every:N needs N >= 1, got {n}")
        if phase < 0:
            raise FailpointSpecError(
                f"failpoint {name}: every:N@P needs P >= 0, got {phase}")
        return _Site(name, "every", n=n, seed=seed, phase=phase % n)
    skip = 0
    if mode.startswith("prob:"):
        mode, _, sk = mode[5:].partition("@")
        if sk:
            try:
                skip = int(sk)
            except ValueError:
                raise FailpointSpecError(
                    f"failpoint {name}: bad prob:p@K skip {sk!r}")
            if skip < 0:
                raise FailpointSpecError(
                    f"failpoint {name}: prob:p@K needs K >= 0, got {skip}")
    try:
        p = float(mode)
    except ValueError:
        raise FailpointSpecError(
            f"failpoint {name}: unknown mode {mode!r} "
            "(want once | every:N | prob:p | off)")
    if not 0.0 <= p <= 1.0:
        raise FailpointSpecError(
            f"failpoint {name}: probability {p} outside [0, 1]")
    return _Site(name, "prob", p=p, seed=seed, skip=skip)


class Failpoints:
    """A registry of named sites. One process-global instance lives at
    module level; tests may build private ones."""

    def __init__(self):
        self._lock = threading.Lock()
        self._sites: Dict[str, _Site] = {}
        # fire history survives disarm (a fired ``once`` site stays
        # visible to assertions after it is gone)
        self._fired: Dict[str, int] = {}

    # -- configuration ---------------------------------------------------
    def parse(self, spec: str) -> List[Tuple[str, str]]:
        """``"a=once,b=every:3"`` -> [("a", "once"), ("b", "every:3")]."""
        out: List[Tuple[str, str]] = []
        for item in (spec or "").replace(";", ",").split(","):
            item = item.strip()
            if not item:
                continue
            if "=" not in item:
                raise FailpointSpecError(
                    f"failpoint entry {item!r}: expected site=mode")
            name, mode = item.split("=", 1)
            out.append((name.strip(), mode.strip()))
        return out

    def set(self, name: str, mode: str) -> None:
        """Arm (or with ``off`` disarm) one site."""
        if not name:
            raise FailpointSpecError("empty failpoint site name")
        seed = int(os.environ.get(SEED_ENV_VAR, "0"))
        site = _parse_mode(name, mode, seed)
        with self._lock:
            if site is None:
                self._sites.pop(name, None)
            else:
                self._sites[name] = site

    def configure(self, spec: str) -> None:
        """Arm every ``site=mode`` entry in a comma-separated spec."""
        for name, mode in self.parse(spec):
            self.set(name, mode)

    def install(self, config_spec: str = "", env: bool = True) -> None:
        """Install from a config value plus (by default) the
        CXXNET_FAILPOINTS env var; env entries win on name clashes."""
        if config_spec:
            self.configure(config_spec)
        if env:
            self.configure(os.environ.get(ENV_VAR, ""))

    def clear(self, name: Optional[str] = None) -> None:
        """Disarm one site, or everything (history included) when
        ``name`` is None."""
        with self._lock:
            if name is None:
                self._sites.clear()
                self._fired.clear()
            else:
                self._sites.pop(name, None)

    # -- interrogation ---------------------------------------------------
    def armed(self, name: str) -> bool:
        with self._lock:
            return name in self._sites

    def armed_prefix(self, prefix: str) -> bool:
        """Any site under a dotted namespace armed? (``"io."``) — lets
        hot paths skip wrapper objects entirely when chaos is off."""
        with self._lock:
            return any(k.startswith(prefix) for k in self._sites)

    def fired(self, name: str) -> int:
        """How many times a site has fired (fired ``once`` sites stay
        counted after auto-disarm)."""
        with self._lock:
            return self._fired.get(name, 0)

    def active(self) -> Dict[str, str]:
        """The armed spec, one re-parseable ``mode`` string per site —
        what the run ledger records on ``run_start`` so incident replay
        can re-arm the exact fault schedule."""
        with self._lock:
            out = {}
            for name, s in self._sites.items():
                if s.mode == "once":
                    out[name] = "once"
                elif s.mode == "every":
                    out[name] = (f"every:{s.n}@{s.phase}" if s.phase
                                 else f"every:{s.n}")
                else:
                    out[name] = (f"prob:{s.p}@{s.skip}" if s.skip
                                 else f"prob:{s.p}")
            return out

    # -- the hot call ----------------------------------------------------
    def fire(self, name: str) -> bool:
        """True when the named site is armed and triggers this check.
        A fired ``once`` site disarms itself."""
        with self._lock:
            site = self._sites.get(name)
            if site is None:
                return False
            hit = site.should_fire()
            if hit:
                site.fires += 1
                self._fired[name] = self._fired.get(name, 0) + 1
                if site.mode == "once":
                    del self._sites[name]
            return hit

    def check(self, name: str, exc=InjectedFault) -> None:
        """Raise ``exc`` when the site fires (the one-liner production
        code embeds)."""
        if self.fire(name):
            raise exc(f"injected fault at failpoint {name!r}")


# the process-global registry production sites consult
_GLOBAL = Failpoints()

parse = _GLOBAL.parse
set = set_site = _GLOBAL.set            # noqa: A001 — module-level verb
configure = _GLOBAL.configure
install = _GLOBAL.install
clear = _GLOBAL.clear
armed = _GLOBAL.armed
armed_prefix = _GLOBAL.armed_prefix
fired = _GLOBAL.fired
active = _GLOBAL.active
fire = _GLOBAL.fire
check = _GLOBAL.check
