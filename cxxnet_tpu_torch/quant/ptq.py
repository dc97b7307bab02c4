"""Post-training int8 quantization (PTQ) of a verified round (the port of
``cxxnet_tpu/quant/ptq.py``).

Per-channel symmetric weight quantization of the layer types whose
``wmat`` keeps its output channels on the last axis in the JAX layout
(fullc (in, out), conv HWIO, seqfc (e, k)), with one activation scale
per layer calibrated over a few batches (abs-max, or a percentile).

A quantized layer's parameters hold what the int8 path
(``ops/fused_quant.py``) needs, inside the ordinary tree:

    {"wmat":       int8, the shape of the source weight,
     "wmat_scale": f32 per output channel,
     "act_scale":  f32 scalar (the calibrated activation clip),
     "bias":       untouched f32}

The derived round carries ``__quant_meta__`` in its meta JSON
(``checkpoint.quant_meta``): the source round and its digest, the
calibration settings and per-layer drift. The weight arithmetic is the
JAX package's numpy, so both packages quantize a weight to the same
bytes. The activation scales come from the port's own forward
(:func:`calibrate_act_scales`), abs-max taken on the device, a
percentile in numpy on a host copy, as the JAX package takes it.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Tuple

import numpy as np
import torch

from .. import checkpoint as ckpt
from ..config import QuantConfig
from ..convert import params_from_jax

#: layer types eligible for weight quantization: their ``wmat`` keeps the
#: output channels on the last axis of the JAX layout
QUANT_LAYER_TYPES = ("fullc", "conv", "seqfc")

_TINY = 1e-12


def quantizable_layers(net) -> Dict[str, str]:
    """Quantizable layer name -> its input node's name (whose values
    calibrate ``act_scale``). Shared layers reuse the primary's
    parameters, so each name appears once."""
    g = net.graph
    out: Dict[str, str] = {}
    for spec in g.layers:
        if spec.type in QUANT_LAYER_TYPES and not spec.is_shared \
                and spec.name not in out:
            out[spec.name] = g.node_names[spec.nindex_in[0]]
    return out


def _rms(a: np.ndarray) -> float:
    return float(np.sqrt(np.mean(np.square(a, dtype=np.float64))))


def quantize_weight(w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-output-channel symmetric int8: scale[c] = max|w[..., c]| / 127
    (an all-zero channel gets scale 1, so dequantization stays exact)."""
    w = np.asarray(w, np.float32)
    absmax = np.max(np.abs(w), axis=tuple(range(w.ndim - 1)))
    scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.rint(w / scale), -127, 127).astype(np.int8)
    return q, scale


def weight_drift(w: np.ndarray, q: np.ndarray,
                 scale: np.ndarray) -> Dict[str, float]:
    """Round-trip drift of one quantized leaf: the relative RMS error of
    the dequantized weight, and the fraction of codes at |127| (a high
    fraction means an outlier channel clipped real mass)."""
    w = np.asarray(w, np.float32)
    deq = q.astype(np.float32) * scale
    return {
        "rel_err": _rms(deq - w) / max(_rms(w), _TINY),
        "sat_frac": float(np.mean(np.abs(q.astype(np.int32)) == 127)),
    }


def calibrate_act_scales(net, batches: Iterable[Any],
                         percentile: float = 100.0) -> Dict[str, float]:
    """Run ``net`` (weights loaded, its policy's compute dtype) over the
    calibration batches (NHWC arrays) with node capture and record, per
    quantizable layer, the max over batches of its input's abs-max (or
    of each batch's ``percentile`` of |input|). Each node is reduced on
    the device batch by batch; only a percentile copies it to the host.
    A layer whose input never fired calibrates to 1.0."""
    targets = quantizable_layers(net)
    best: Dict[str, Any] = {}
    n_batches = 0
    for batch in batches:
        data = torch.as_tensor(np.asarray(batch, np.float32)).to(net.device)
        nodes = net.forward(data, capture_nodes=True).nodes
        n_batches += 1
        for lname, node in targets.items():
            v = nodes.get(node)
            if v is None:
                continue
            if percentile >= 100.0:
                s = v.abs().max().float()
                best[lname] = s if lname not in best \
                    else torch.maximum(best[lname], s)
            else:
                a = np.abs(v.float().cpu().numpy())
                s = float(np.percentile(a, percentile))
                best[lname] = max(float(best.get(lname, 0.0)), s)
        del nodes
    if not n_batches:
        raise ValueError("quantize: calibration stream yielded no batches")
    scales = {k: float(v) for k, v in best.items()}
    return {ln: (scales.get(ln) or 1.0) for ln in targets}


def quantize_params(params: Dict[str, Any],
                    act_scales: Dict[str, float]
                    ) -> Tuple[Dict[str, Any], Dict[str, Dict[str, float]]]:
    """The quantized tree (JAX layout, numpy; the source is untouched)
    and per-layer drift. Only layers named in ``act_scales`` that have a
    ``wmat`` quantize; the rest pass through by reference."""
    out: Dict[str, Any] = {}
    drift: Dict[str, Dict[str, float]] = {}
    for lname, lp in params.items():
        if lname in act_scales and isinstance(lp, dict) and "wmat" in lp:
            w = np.asarray(lp["wmat"])
            q, scale = quantize_weight(w)
            qp = dict(lp)
            qp["wmat"] = q
            qp["wmat_scale"] = scale
            qp["act_scale"] = np.float32(act_scales[lname])
            out[lname] = qp
            drift[lname] = weight_drift(w, q, scale)
        else:
            out[lname] = lp
    return out, drift


def dequantize_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """Fold the scales back in: int8 ``wmat`` -> f32 ``wmat * scale``,
    the scale leaves dropped; the source round's structure (what an fp
    engine serving a quantized round loads)."""
    out: Dict[str, Any] = {}
    for lname, lp in params.items():
        if isinstance(lp, dict) and "wmat_scale" in lp:
            qp = dict(lp)
            scale = np.asarray(qp.pop("wmat_scale"), np.float32)
            qp.pop("act_scale", None)
            qp["wmat"] = np.asarray(qp["wmat"], np.float32) * scale
            out[lname] = qp
        else:
            out[lname] = lp
    return out


def is_quantized_params(params: Dict[str, Any]) -> bool:
    """Whether any layer of the tree carries the int8 form."""
    return any(isinstance(lp, dict) and "wmat_scale" in lp
               for lp in params.values())


def dequantize_blob(blob: Dict[str, Any]) -> Dict[str, Any]:
    """:func:`dequantize_params` over a loaded round (meta and state pass
    through; the meta keeps ``__quant_meta__``)."""
    out = dict(blob)
    out["params"] = dequantize_params(blob["params"])
    return out


def drift_verdict(qm: Dict[str, Any], max_rel_err: float,
                  max_sat_frac: float) -> Dict[str, Any]:
    """SAFE when every quantized layer's relative RMS error and
    saturation fraction in a ``__quant_meta__`` block clear the
    thresholds; the JAX package's verdict, line and rows."""
    rows: List[Dict[str, Any]] = []
    worst_err = worst_sat = 0.0
    offenders = []
    for lname in sorted(qm.get("drift", {})):
        d = qm["drift"][lname]
        ok = (d["rel_err"] <= max_rel_err
              and d["sat_frac"] <= max_sat_frac)
        if not ok:
            offenders.append(lname)
        worst_err = max(worst_err, d["rel_err"])
        worst_sat = max(worst_sat, d["sat_frac"])
        rows.append({"layer": lname, "rel_err": d["rel_err"],
                     "sat_frac": d["sat_frac"], "ok": ok})
    ok = not offenders and bool(rows)
    verdict = "SAFE" if ok else "UNSAFE"
    line = (f"quant drift {verdict}: {len(rows)} quantized layers, "
            f"worst rel_err {worst_err:.4f} (max {max_rel_err}), "
            f"worst sat_frac {worst_sat:.4f} (max {max_sat_frac})"
            + (f"; offenders: {', '.join(offenders)}" if offenders
               else ""))
    return {"ok": ok, "verdict": verdict, "line": line, "layers": rows,
            "worst_rel_err": worst_err, "worst_sat_frac": worst_sat,
            "source_round": qm.get("source_round"),
            "source_digest": qm.get("source_digest")}


def quantize_blob(net, blob: Dict[str, Any], batches: Iterable[Any],
                  qc: QuantConfig) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The PTQ pass over a loaded round (JAX-layout numpy trees, as
    ``checkpoint.load_for_inference`` gives them): load it into ``net``,
    calibrate the activation scales, quantize the weights and assemble
    the ``__quant_meta__`` block. Returns ``(qblob, quant_meta)``."""
    src_digest = ckpt.blob_digest(blob["meta"])
    net.load_weights(*params_from_jax(blob["params"], blob["state"]))
    act_scales = calibrate_act_scales(net, batches,
                                      percentile=qc.calib_percentile)
    qparams, drift = quantize_params(blob["params"], act_scales)
    if not drift:
        raise ValueError(
            "quantize: model has no quantizable layers "
            f"(looked for {', '.join(QUANT_LAYER_TYPES)})")
    qm = {
        "quant_dtype": "int8",
        "source_round": int(blob["meta"]["round"]),
        "source_digest": src_digest,
        "calib": {"batches": int(qc.calib_batches),
                  "percentile": float(qc.calib_percentile)},
        "act_scales": {k: float(v) for k, v in act_scales.items()},
        "quantized_layers": sorted(drift),
        "drift": {k: {"rel_err": float(v["rel_err"]),
                      "sat_frac": float(v["sat_frac"])}
                  for k, v in drift.items()},
    }
    qblob = dict(blob)
    qblob["params"] = qparams
    return qblob, qm


def write_quantized_round(path: str, structure_sig: tuple,
                          qblob: Dict[str, Any],
                          qm: Dict[str, Any]) -> None:
    """Write the derived round: the source's structure signature, round,
    epoch and step, ``__quant_meta__`` in the meta JSON, and digests of
    its own (so its ``blob_digest`` is a distinct content identity)."""
    meta = qblob["meta"]
    ckpt.save_model(
        path, structure_sig=structure_sig,
        round_counter=int(meta["round"]),
        epoch_counter=int(meta["epoch"]),
        params=qblob["params"], net_state=qblob["state"],
        opt_state=None,
        step_count=int(meta.get("step_count", 0)),
        lr_scale=float(meta.get("lr_scale", 1.0)),
        extra_meta={"__quant_meta__": qm})
