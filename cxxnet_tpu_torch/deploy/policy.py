"""The ``deploy_*`` config namespace: the closed-loop deployment
controller's knobs (the port of ``cxxnet_tpu/deploy/policy.py``, with
its keys, defaults and messages).

As in every namespace of ``config.py``, a key of the namespace that is
not known raises at parse time: a promotion gate that quietly fell
back to a default threshold is not a gate. The knobs mean something
only beside the gates they parameterize (``gates.py``) and the state
machine that holds them (``controller.py``), so they live here.
"""

from __future__ import annotations

import dataclasses

from ..config import ConfigError, ConfigPairs


@dataclasses.dataclass(frozen=True)
class DeployConfig:
    """The ``deploy_*`` knob set: evidence thresholds and window
    accounting of the health-gated canary controller."""
    enable: int = 0                # deploy_enable: attach the controller
    poll_s: float = 10.0           # deploy_poll_s: round scan (0 = manual)
    window_s: float = 60.0         # deploy_window_s: canary hold window
    # a RELOAD-SUSPECT offline verdict does not block, it buys a
    # longer look: the window is multiplied by this factor
    suspect_factor: float = 2.0    # deploy_suspect_factor
    burn_max: float = 1.0          # deploy_burn_max: canary SLO burn cap
    # parity = fraction of shadow-probe predictions allowed to disagree
    # with the incumbent (0 = bit-exact agreement required)
    parity_tol: float = 0.25       # deploy_parity_tol
    canary_replicas: int = 1       # deploy_canary_replicas
    probe_rows: int = 16           # deploy_probe_rows: shadow batch size
    probe_seed: int = 0            # deploy_probe_seed: deterministic set
    # hold after a rejection: no new canary for this long, and the
    # rejected round or digest is never canaried again, so a trainer
    # that keeps publishing cannot grind the fleet through one bad
    # round
    backoff_s: float = 300.0       # deploy_backoff_s
    max_ratio: float = 0.5         # deploy_max_ratio: offline SUSPECT bar


def parse_deploy_config(cfg: ConfigPairs) -> DeployConfig:
    """Collect and validate the ``deploy_*`` keys (last occurrence
    wins; an unknown key of the namespace raises)."""
    known = {
        "deploy_enable": ("enable", int),
        "deploy_poll_s": ("poll_s", float),
        "deploy_window_s": ("window_s", float),
        "deploy_suspect_factor": ("suspect_factor", float),
        "deploy_burn_max": ("burn_max", float),
        "deploy_parity_tol": ("parity_tol", float),
        "deploy_canary_replicas": ("canary_replicas", int),
        "deploy_probe_rows": ("probe_rows", int),
        "deploy_probe_seed": ("probe_seed", int),
        "deploy_backoff_s": ("backoff_s", float),
        "deploy_max_ratio": ("max_ratio", float),
    }
    vals = {}
    for name, val in cfg:
        if name.startswith("deploy_"):
            if name not in known:
                raise ConfigError(
                    f"unknown deploy setting {name!r}; valid keys: "
                    + ", ".join(sorted(known)))
            field, conv = known[name]
            try:
                vals[field] = conv(val)
            except ValueError as e:
                raise ConfigError(f"bad {name} value {val!r}: {e}")
    dc = DeployConfig(**vals)
    if dc.enable not in (0, 1):
        raise ConfigError(f"deploy_enable must be 0 or 1, got {dc.enable}")
    if dc.window_s <= 0:
        raise ConfigError(
            f"deploy_window_s must be > 0, got {dc.window_s}")
    if dc.suspect_factor < 1.0:
        raise ConfigError(
            "deploy_suspect_factor must be >= 1 (SUSPECT extends the "
            f"window, never shortens it), got {dc.suspect_factor}")
    if dc.burn_max <= 0:
        raise ConfigError(
            f"deploy_burn_max must be > 0, got {dc.burn_max}")
    if not 0.0 <= dc.parity_tol <= 1.0:
        raise ConfigError(
            "deploy_parity_tol is a disagreement fraction in [0, 1], "
            f"got {dc.parity_tol}")
    if dc.canary_replicas < 1:
        raise ConfigError(
            f"deploy_canary_replicas must be >= 1, got "
            f"{dc.canary_replicas}")
    if dc.probe_rows < 1:
        raise ConfigError(
            f"deploy_probe_rows must be >= 1, got {dc.probe_rows}")
    if dc.backoff_s < 0:
        raise ConfigError(
            f"deploy_backoff_s must be >= 0, got {dc.backoff_s}")
    if dc.max_ratio <= 0:
        raise ConfigError(
            f"deploy_max_ratio must be > 0, got {dc.max_ratio}")
    if dc.poll_s < 0:
        raise ConfigError(
            f"deploy_poll_s must be >= 0, got {dc.poll_s}")
    return dc
