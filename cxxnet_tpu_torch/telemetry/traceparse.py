"""Per-phase attribution of a ``torch.profiler`` bracket (the port of
``cxxnet_tpu/telemetry/traceparse.py``).

The JAX module parses XLA's xplane dumps; the port reads the
``trace.json`` its own :class:`~.profiler.ProfileBracket` writes. Every
device event (a kernel, a copy, a fill) is aggregated by name and
classified into the phases of the Inception-BN step with the JAX
package's phase names and order (:data:`PHASE_ORDER`):

* ``conv``: cuDNN's kernels (its xmma ``fprop`` / ``dgrad`` / ``wgrad``
  implicit gemms and every kernel whose name says ``cudnn``);
* ``bn_act``: the hand kernels of batch norm (``bn_fwd``, ``bn_bwd``,
  ``bn_sync``), of the bias epilogues and of the stem;
* ``pool``: the pool kernels, the port's and PyTorch's;
* ``lrn``: the LRN kernels;
* ``matmul``: cuBLAS (``nvjet_*``) / cutlass gemms and ``q_mm``;
* ``optim``: ``sgd_apply`` and ``adam_apply``;
* ``h2d``: ``Memcpy HtoD``;
* ``other``: everything else, listed by its top names.

:func:`attribute_profile` returns the JAX function's dict, and
:func:`attribution_fragment` its round-log line, character for
character.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

#: ordered (phase, lower-case name substrings): the first match wins.
#: Pool and conv before matmul (cuDNN's implicit gemms say "gemm"), all
#: before bn_act (cutlass template arguments say "epilogue"). cuDNN's
#: own kernels all carry "cudnn" (its cutlass and cask builds, its
#: padding and layout kernels); cuBLAS's Hopper gemms are "nvjet_*"
PHASE_RULES: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("h2d", ("memcpy htod",)),
    ("optim", ("sgd_apply", "adam_apply")),
    ("lrn", ("lrn_fwd", "lrn_bwd")),
    ("pool", ("pool_fwd", "pool_bwd", "max_pool", "avg_pool", "pooling")),
    ("conv", ("xmma_fprop", "xmma_dgrad", "xmma_wgrad", "cudnn",
              "convolve", "conv2d")),
    ("matmul", ("gemm", "gemv", "nvjet", "q_mm", "cutlass", "cublas",
                "matmul")),
    ("bn_act", ("momentsvec", "sqdevvec", "bn_fwd", "bwdsumsvec", "bn_dx",
                "bn_norm", "bn_sync", "bn_sums", "mask_copy_vec",
                "epibwdvec", "epilogue", "stem_kernel")),
)

#: the table order of the JAX package (h2d last, other at the end)
PHASE_ORDER = ("conv", "bn_act", "pool", "lrn", "matmul", "optim",
               "h2d", "other")

#: the Chrome-trace categories of work on the card
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def classify_op(name: str, category: str = "") -> str:
    """The step phase of one device event, by its kernel name
    (``category`` is the JAX signature's; the port's trace has none)."""
    low = (name or "").lower()
    for phase, pats in PHASE_RULES:
        for p in pats:
            if p in low:
                return phase
    return "other"


def device_events(trace_path: str) -> Dict[str, Dict[str, float]]:
    """{name: {"count", "us"}} of the device events of a ``trace.json``."""
    with open(trace_path, encoding="utf-8") as f:
        events = json.load(f).get("traceEvents", [])
    out: Dict[str, Dict[str, float]] = {}
    for ev in events:
        if ev.get("ph") != "X" or ev.get("cat") not in _DEVICE_CATS:
            continue
        k = out.setdefault(ev["name"], {"count": 0, "us": 0.0})
        k["count"] += 1
        k["us"] += float(ev.get("dur", 0.0))
    return out


def attribute_profile(dump_dir: str, steps: int = 1) -> dict:
    """Attribute the device time of ``<dump_dir>/trace.json`` to step
    phases. Returns the JAX package's dict::

        {"phases": {phase: {"ms": per-step, "pct": share of device time,
                            "count": events}},
         "total_op_ms": per-step device time,
         "measured_bytes_per_step": None, "measured_flops_per_step": None,
         "top_other": [(name, ms), ...],     # unclassified heavies
         "steps": steps, "source": "trace_json", "device": "cuda"}

    (a torch.profiler trace records no bytes or flops a kernel). Raises
    ``FileNotFoundError`` when the dump has no trace."""
    path = os.path.join(dump_dir, "trace.json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no profile trace under {dump_dir!r}")
    steps = max(1, int(steps))
    phases: Dict[str, Dict[str, float]] = {}
    other: List[Tuple[str, float]] = []
    total_ms = 0.0
    for name, ev in device_events(path).items():
        phase = classify_op(name)
        ms = ev["us"] / 1e3
        total_ms += ms
        d = phases.setdefault(phase, {"ms": 0.0, "pct": 0.0, "count": 0})
        d["ms"] += ms
        d["count"] += ev["count"]
        if phase == "other":
            other.append((name, ms))
    for d in phases.values():
        d["pct"] = 100.0 * d["ms"] / total_ms if total_ms else 0.0
        d["ms"] = d["ms"] / steps
    other.sort(key=lambda kv: -kv[1])
    return {
        "phases": phases,
        "total_op_ms": total_ms / steps,
        "measured_bytes_per_step": None,
        "measured_flops_per_step": None,
        "top_other": [(n, ms / steps) for n, ms in other[:8]],
        "steps": steps,
        "source": "trace_json",
        "device": "cuda",
    }


def attribution_fragment(att: dict) -> str:
    """One-line round-log rendering of an attribution (main.py prints it
    after a telemetry_profile_steps bracket closes)."""
    parts = []
    for phase in PHASE_ORDER:
        d = att["phases"].get(phase)
        if d:
            parts.append(f"{phase}:{d['ms']:.2f}ms({d['pct']:.0f}%)")
    extra = ""
    if att.get("measured_bytes_per_step"):
        extra = f" hbm={att['measured_bytes_per_step'] / 1e9:.2f}GB/step"
    return ("profile[" + " ".join(parts) + "]" + extra) if parts else ""
