"""The port's offline model health (``telemetry/modelhealth.py``) against
the JAX package's ``reload_verdict`` on the same pairs of rounds, on the
CPU.

Two nets: the two-``fullc`` net of ``tests/test_deploy.py`` (no state)
and the narrow Inception-BN of ``torch_ibn_fixture`` (every layer type
of the flagship, 69 batch norms with their running statistics), whose
leaf names and order the port's walk must give as
``jax.tree_util.tree_flatten_with_path`` does. Rounds are drawn with
numpy in the JAX layout. For each pair (RELOAD-SANE, IDENTICAL,
RELOAD-SUSPECT with one leaf scaled, RELOAD-UNSAFE by a NaN in one layer
and by structure, and one round alone) the verdict, exit code, line,
``layers``, ``provenance``, the row order, and the ``worst`` row's leaf
and ``rel_change`` (within 1e-12) are the JAX package's.
"""

import functools

import numpy as np
import pytest
import torch

from cxxnet_tpu.telemetry.modelhealth import (
    layer_report as jax_layer_report, reload_verdict as jax_reload_verdict)
from cxxnet_tpu_torch.config import parse_config_string
from cxxnet_tpu_torch.convert import params_to_jax
from cxxnet_tpu_torch.graph import build_graph
from cxxnet_tpu_torch.model import Network
from cxxnet_tpu_torch.telemetry import layer_report, reload_verdict

from torch_fleet_fixture import PORT_CFG
from torch_ibn_fixture import IBN_TEXT

#: a poisoned layer of each net: fc2 of the fullc net, a conv deep in
#: the Inception-BN
POISON = {"fullc": "fc2", "ibn": "cv_4b_3x3r"}


@functools.lru_cache(maxsize=None)
def _round(net: str, seed: int):
    """(params, state) numpy trees of ``net`` in the JAX layout: the
    port's init from ``seed``, BN running statistics drawn positive."""
    text = PORT_CFG if net == "fullc" else IBN_TEXT + "\ndev = cpu\n"
    cfg = parse_config_string(text)
    n = Network(build_graph(cfg), cfg)
    params, state = params_to_jax(
        *n.init(torch.Generator().manual_seed(seed)))
    rs = np.random.RandomState(seed)
    for lp in state.values():
        for k in lp:
            lp[k] = (rs.rand(*lp[k].shape) + 0.5).astype(np.float32)
    return params, state


def blob(net: str, seed: int):
    params, state = _round(net, seed)
    copy = lambda t: {k: copy(v) if isinstance(v, dict) else np.array(v)
                      for k, v in t.items()}
    return {"params": copy(params), "state": copy(state),
            "meta": {"round": seed, "epoch": 0}}


def pair(net: str, case: str):
    """(blob_a, blob_b or None, digest_a, digest_b) of each case."""
    a = blob(net, 1)
    b = blob(net, 1)
    layer = POISON[net]
    if case == "sane":
        rs = np.random.RandomState(3)
        for lp in b["params"].values():
            for k, v in lp.items():
                lp[k] = (v * (1 + 1e-3 * rs.randn(*v.shape))).astype(
                    np.float32)
        return a, b, "aaa", "bbb"
    if case == "identical":
        return a, b, "abc", "abc"
    if case == "suspect":
        b["params"][layer]["wmat"] *= 3.0
        return a, b, "aaa", "bbb"
    if case == "unsafe_nan":
        b["params"][layer]["wmat"][0] = np.nan
        return a, b, "aaa", "bbb"
    if case == "unsafe_structure":
        del b["params"][layer]["wmat"]
        b["params"]["fc1"]["bias"] = np.zeros(3, np.float32)
        return a, b, "aaa", "bbb"
    if case == "single":
        return a, None, "aaa", ""
    assert case == "single_nan"
    a["params"][layer]["wmat"][..., 1] = np.inf
    return a, None, "aaa", ""


CASES = ["sane", "identical", "suspect", "unsafe_nan", "unsafe_structure",
         "single", "single_nan"]
WANT = {"sane": "RELOAD-SANE", "identical": "IDENTICAL",
        "suspect": "RELOAD-SUSPECT", "unsafe_nan": "RELOAD-UNSAFE",
        "unsafe_structure": "RELOAD-UNSAFE", "single": "SANE",
        "single_nan": "RELOAD-UNSAFE"}


@pytest.mark.parametrize("net", ["fullc", "ibn"])
@pytest.mark.parametrize("case", CASES)
def test_reload_verdict_matches_the_jax_package(net, case):
    a, b, da, db = pair(net, case)
    got = reload_verdict(a, b, max_ratio=0.5, digest_a=da, digest_b=db)
    want = jax_reload_verdict(a, b, max_ratio=0.5, digest_a=da,
                              digest_b=db)
    assert got["verdict"] == want["verdict"] == WANT[case]
    for k in ("exit_code", "line", "layers", "provenance",
              "structure_notes", "max_ratio", "digest_a", "digest_b"):
        assert got[k] == want[k], k
    leaves = lambda rows: [(r["kind"], r["leaf"], r["shape"])
                           for r in rows or ()]
    assert leaves(got["a_leaves"]) == leaves(want["a_leaves"])
    assert leaves(got["b_leaves"]) == leaves(want["b_leaves"])
    assert [(r["layer"], r["leaf"]) for r in got["nonfinite"]] \
        == [(r["layer"], r["leaf"]) for r in want["nonfinite"]]
    assert [(r["kind"], r["leaf"]) for r in got["diff"]] \
        == [(r["kind"], r["leaf"]) for r in want["diff"]]
    for g, w in zip(got["diff"], want["diff"]):
        assert abs(g["rel_change"] - w["rel_change"]) <= 1e-12
    if want["worst"] is None:
        assert got["worst"] is None
    else:
        assert got["worst"]["leaf"] == want["worst"]["leaf"]
        assert got["worst"]["kind"] == want["worst"]["kind"]
        assert abs(got["worst"]["rel_change"]
                   - want["worst"]["rel_change"]) <= 1e-12
    if case in ("unsafe_nan", "single_nan"):
        assert got["layers"] == [POISON[net]]
        assert got["provenance"] == (f"layer={POISON[net]} kind=param "
                                     "leaf=wmat")


@pytest.mark.parametrize("net", ["fullc", "ibn"])
def test_layer_report_rows_match_the_jax_package(net):
    params, state = _round(net, 2)
    got = layer_report(params, state)
    want = jax_layer_report(params, state)
    assert [(r["kind"], r["leaf"], r["shape"]) for r in got] \
        == [(r["kind"], r["leaf"], r["shape"]) for r in want]
    for g, w in zip(got, want):
        for k in ("rms", "absmax", "finite_frac"):
            assert g[k] == w[k]
    if net == "ibn":
        assert any(r["kind"] == "state" for r in got)
