"""Deterministic incident replay (the port of ``cxxnet_tpu/replay/`` and
``tools/replay.py``).

``reconstruct`` turns a ledger incident into a ReplayPlan (the resolved
config, checkpoint round, data-address window and failpoint spec);
``execute`` re-runs the window in this process and verdicts
``bit_exact`` / ``diverged_at_step`` / ``unreproducible:<reason>``.
CLI: ``python -m cxxnet_tpu_torch.replay <ledger> [--incident N|--last]``.
"""

from .executor import ReplayResult, execute
from .reconstruct import (INCIDENT_EVENTS, ConfigDriftError,
                          ReconstructError, ReplayPlan,
                          compensate_failpoints, diff_config,
                          list_incidents, reconstruct)

__all__ = [
    "INCIDENT_EVENTS", "ConfigDriftError", "ReconstructError",
    "ReplayPlan", "ReplayResult", "compensate_failpoints", "diff_config",
    "execute", "list_incidents", "reconstruct",
]
