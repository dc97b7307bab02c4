"""Offline model health: per-leaf checkpoint reports and the serve-reload
verdict (the port of the offline half of
``cxxnet_tpu/telemetry/modelhealth.py``).

A round's params and BN state are nested dicts of numpy arrays in the
JAX package's layout (what :func:`checkpoint.load_for_inference` yields
in either package). Each leaf is named ``layer/sub/leaf``, the keys from
the layer down joined by ``/``, and the leaves are walked in the JAX
package's order: dict keys sorted at every level (``None`` is an empty
subtree, a list's items read ``[i]``), so the report rows, the
``layers`` and ``provenance`` of a verdict, the six names of its
UNSAFE line and its ``worst`` row are the JAX package's on the same
pair of rounds.

:func:`reload_verdict` is the library ckpt_health call the deployment
controller's offline gate runs (``deploy/gates.py``): RELOAD-UNSAFE
(non-finite values or structure mismatch), RELOAD-SUSPECT (some leaf
moved more than ``max_ratio`` of its RMS), RELOAD-SANE, IDENTICAL or,
for one round alone, SANE.

The in-trace statistics, the trainer's ``HealthProbe`` and the
non-finite walk ``diagnose_nonfinite`` wait for ROADMAP Queue A 12
(``health = 1`` is refused by the trainer's config check).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


def _leaf_pairs(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """``(layer/sub/leaf, leaf)`` pairs of a nested tree in the JAX
    package's flatten order (``tree_flatten_with_path``)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _leaf_pairs(tree[k], prefix + (str(k),))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _leaf_pairs(v, prefix + (f"[{i}]",))
        return out
    return [("/".join(prefix), tree)]


# -- offline layer report ------------------------------------------------------

def layer_report(params, state=None) -> List[Dict[str, Any]]:
    """Per-leaf health rows of a round's param (and optionally state)
    trees: RMS, abs-max and finite fraction in float64."""
    rows: List[Dict[str, Any]] = []

    def walk(tree, kind):
        for key, leaf in _leaf_pairs(tree):
            a = np.asarray(leaf, dtype=np.float64)
            n = a.size or 1
            rows.append({
                "leaf": key, "kind": kind,
                "shape": tuple(np.asarray(leaf).shape),
                "rms": float(np.sqrt(np.mean(np.square(a)))),
                "absmax": float(np.max(np.abs(a))) if a.size else 0.0,
                "finite_frac": float(np.isfinite(a).sum() / n),
            })
    walk(params, "param")
    if state:
        walk(state, "state")
    return rows


# -- offline reload verdict ----------------------------------------------------

def delta_map(blob_a, blob_b) -> Dict[Tuple[str, str], float]:
    """Per-leaf ``rms(b - a)`` from the tensors, keyed like the
    :func:`layer_report` rows: value-level changes that keep a leaf's
    RMS (sign flips, permutations) still register."""
    out: Dict[Tuple[str, str], float] = {}

    def walk(ta, tb, kind):
        fa = dict(_leaf_pairs(ta))
        fb = dict(_leaf_pairs(tb))
        for k in set(fa) & set(fb):
            a = np.asarray(fa[k], dtype=np.float64)
            b = np.asarray(fb[k], dtype=np.float64)
            if a.shape != b.shape or not a.size:
                continue
            out[(kind, k)] = float(np.sqrt(np.mean(np.square(b - a))))

    walk(blob_a["params"], blob_b["params"], "param")
    if blob_a.get("state") and blob_b.get("state"):
        walk(blob_a["state"], blob_b["state"], "state")
    return out


def diff_rows(rows_a: List[Dict[str, Any]], rows_b: List[Dict[str, Any]],
              deltas: Optional[Dict[Tuple[str, str], float]] = None
              ) -> Tuple[List[Dict[str, Any]], List[str]]:
    """Per-leaf relative-change rows and structural mismatch notes.
    ``rel_change`` is ``rms(b - a) / rms(a)`` with ``deltas``
    (:func:`delta_map`), else ``|rms(b) - rms(a)| / rms(a)``."""
    a = {(r["kind"], r["leaf"]): r for r in rows_a}
    b = {(r["kind"], r["leaf"]): r for r in rows_b}
    notes = []
    for k in sorted(set(a) - set(b)):
        notes.append("only in A: %s %s" % k)
    for k in sorted(set(b) - set(a)):
        notes.append("only in B: %s %s" % k)
    out = []
    for k in sorted(set(a) & set(b)):
        ra, rb = a[k], b[k]
        if ra["shape"] != rb["shape"]:
            notes.append("shape mismatch at %s %s: %s vs %s"
                         % (k[0], k[1], ra["shape"], rb["shape"]))
            continue
        denom = ra["rms"] or 1e-12
        change = (deltas[k] if deltas is not None and k in deltas
                  else abs(rb["rms"] - ra["rms"]))
        out.append({"kind": k[0], "leaf": k[1],
                    "rms_a": ra["rms"], "rms_b": rb["rms"],
                    "rel_change": change / denom})
    return out, notes


def nonfinite_rows(rows: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Rows with any non-finite element, or a non-finite summary (an
    all-Inf leaf has finite_frac 0 and rms inf)."""
    return [r for r in rows if r["finite_frac"] < 1.0
            or not math.isfinite(r["rms"])]


def _row_provenance(row: Dict[str, Any]) -> str:
    """One report row as ``layer=<name> kind=<kind> leaf=<leaf>``, the
    JAX package's provenance string for the same poison."""
    leaf = row["leaf"]
    layer, _, rest = leaf.partition("/")
    return "layer=%s kind=%s leaf=%s" % (layer, row["kind"],
                                         rest or leaf)


def reload_verdict(blob_a, blob_b=None, max_ratio: float = 0.5,
                   digest_a: str = "", digest_b: str = ""
                   ) -> Dict[str, Any]:
    """The serve-reload verdict over one or two loaded rounds, the JAX
    package's dict: ``verdict``, ``exit_code`` (2 unsafe, 1 suspect, 0
    sane), ``line``, ``nonfinite`` (B's rows first, each with its
    ``layer``), ``layers`` (distinct poisoned layers, candidate first),
    ``provenance`` (of the first poisoned row), ``worst`` (the largest
    ``rel_change`` row), ``diff``, ``structure_notes``, ``a_leaves``,
    ``b_leaves``, ``max_ratio``, ``digest_a`` and ``digest_b``."""
    rows_a = layer_report(blob_a["params"], blob_a.get("state"))
    rows_b = (layer_report(blob_b["params"], blob_b.get("state"))
              if blob_b is not None else None)
    res: Dict[str, Any] = {
        "max_ratio": float(max_ratio),
        "digest_a": digest_a, "digest_b": digest_b,
        "a_leaves": rows_a, "b_leaves": rows_b,
        "nonfinite": [], "layers": [], "provenance": "",
        "worst": None, "diff": [], "structure_notes": [],
    }

    def done(verdict: str, line: str, code: int) -> Dict[str, Any]:
        res.update(verdict=verdict, line=line, exit_code=code)
        return res

    bad = (nonfinite_rows(rows_b) if rows_b else []) \
        + nonfinite_rows(rows_a)
    if bad:
        seen: List[str] = []
        for r in bad:
            r = dict(r)
            r["layer"] = r["leaf"].partition("/")[0]
            res["nonfinite"].append(r)
            if r["layer"] not in seen:
                seen.append(r["layer"])
        res["layers"] = seen
        res["provenance"] = _row_provenance(bad[0])
        return done("RELOAD-UNSAFE",
                    "RELOAD-UNSAFE: non-finite values in %s"
                    % ", ".join(sorted({r["leaf"] for r in bad})[:6]), 2)
    if rows_b is None:
        return done("SANE", "SANE: all leaves finite (digest %s)"
                    % (digest_a or "-"), 0)
    deltas = delta_map(blob_a, blob_b)
    diffs, notes = diff_rows(rows_a, rows_b, deltas)
    res["diff"], res["structure_notes"] = diffs, notes
    if notes:
        return done("RELOAD-UNSAFE",
                    "RELOAD-UNSAFE: structure mismatch — "
                    + "; ".join(notes[:6]), 2)
    if digest_b and digest_a and digest_a == digest_b:
        return done("IDENTICAL", "IDENTICAL (digest %s)" % digest_a, 0)
    worst = max(diffs, key=lambda d: d["rel_change"], default=None)
    res["worst"] = worst
    if worst is not None and worst["rel_change"] > max_ratio:
        return done("RELOAD-SUSPECT",
                    "RELOAD-SUSPECT: %s %s moved %.3gx its RMS "
                    "(> --max-ratio %g)"
                    % (worst["kind"], worst["leaf"],
                       worst["rel_change"], max_ratio), 1)
    return done("RELOAD-SANE",
                "RELOAD-SANE: max relative change %.3g (%s)"
                % ((worst["rel_change"], worst["leaf"]) if worst
                   else (0.0, "-")), 0)
