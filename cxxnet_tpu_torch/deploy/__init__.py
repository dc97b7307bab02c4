"""Closed-loop deployment: a health-gated canary controller that
promotes or rolls back rounds on evidence (the port of
``cxxnet_tpu/deploy/``).

* :mod:`.policy`: the ``deploy_*`` config namespace (window, burn and
  parity thresholds, canary count, the backoff after a rejection);
* :mod:`.gates`: the evidence, the offline ckpt_health gate and the
  window's online gates (SLO burn, breaker trips, probe parity against
  the incumbent);
* :mod:`.controller`: the state machine over the A/B reload machinery:
  new valid round, offline gate, canary, window, then promote on clean
  evidence or roll back and keep the incident (the failing gate, its
  reason and the poisoned layers).
"""

from .policy import DeployConfig, parse_deploy_config
from .gates import GateResult
from .controller import DeployController

__all__ = ["DeployConfig", "parse_deploy_config", "GateResult",
           "DeployController"]
