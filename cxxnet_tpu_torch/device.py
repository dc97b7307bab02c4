"""The ``dev`` config key -> one torch device.

Grammar as in the JAX package (``parallel/mesh.py``): ``cpu`` / ``gpu``
/ ``tpu`` / ``cuda``, optionally with ``:i``, ``:a-b`` (inclusive) or
``:i,j,k`` device indices. ``tpu``, ``gpu`` and ``cuda`` all name the
accelerator, which in the port is a CUDA card; an empty ``dev`` names it
too. ``cpu`` is the only way onto the CPU: with no CUDA device visible,
any other value raises instead of quietly running on the CPU.

One engine runs on one card (:func:`resolve_device`); a multi-card list
is for data-parallel training, one rank per card, and for a serving
fleet, one replica per card (:func:`resolve_devices`).
"""

from __future__ import annotations

import re
from typing import List, Optional

import torch

from .config import ConfigError

_ACCEL = ("tpu", "gpu", "cuda")


def parse_device_spec(spec: str) -> Optional[List[int]]:
    """Device-index list of a ``dev`` value (None = the default device).
    ``gpu:0-3`` is the inclusive range [0, 3], ``gpu:0,2`` a list."""
    spec = spec.strip()
    if re.match(r"^[a-z]*$", spec):
        return None
    m = re.match(r"^[a-z]+:(\d+)-(\d+)$", spec)
    if m:
        return list(range(int(m.group(1)), int(m.group(2)) + 1))
    m = re.match(r"^[a-z]+:([\d,]+)$", spec)
    if m:
        return [int(x) for x in m.group(1).split(",")]
    raise ConfigError(f"cannot parse device spec {spec!r}")


def resolve_devices(spec: str) -> List[torch.device]:
    """Every torch device a ``dev`` value names (see module docstring):
    one for ``cpu`` and a single card, one per listed card otherwise."""
    spec = (spec or "").strip().lower()
    kind = spec.split(":", 1)[0]
    ids = parse_device_spec(spec)
    if kind == "cpu":
        return [torch.device("cpu")]
    if kind not in _ACCEL + ("",):
        raise ConfigError(
            f"dev = {spec!r}: expected cpu, gpu, cuda or tpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"dev = {spec or '(default)'!r} names the accelerator, but no "
            "CUDA device is visible; set dev = cpu to run on the CPU")
    if ids is not None and len(set(ids)) != len(ids):
        raise ConfigError(f"dev = {spec!r}: a card is listed twice")
    return [torch.device("cuda", i) for i in
            (ids or [torch.cuda.current_device()])]


def resolve_device(spec: str) -> torch.device:
    """The one torch device of a ``dev`` value (see module docstring). A
    list of several cards raises: training spreads over them, and a
    serving fleet puts one replica on each."""
    devs = resolve_devices(spec)
    if len(devs) > 1:
        raise ConfigError(
            f"dev = {spec!r}: one engine runs on one card; task = train "
            "spreads over several (data parallelism), and task = serve "
            "with serve_replicas = one per card puts a replica on each; "
            "an engine over several cards waits for ROADMAP Queue A 4: "
            "replicas over several cards")
    return devs[0]
