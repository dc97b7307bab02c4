"""Config-file parser for the cxxnet key=value dialect (PyTorch port).

The port's own copy of the parts of ``cxxnet_tpu/config.py`` that the
serving and training paths need: the tokenizer and
``parse_config_string``, the mixed-precision :class:`Policy` (mapped to
torch dtypes), the ``fused_kernels`` grammar, the ``serve_*`` and ``quant_*``
namespaces, the training keys the port does not run yet, and the split of iterator
sections (``data = train`` .. ``iter = end``) from the global settings. Grammar: whitespace-separated tokens, ``=`` as its own token,
``#`` line comments, ``"..."`` single-line and ``'...'`` multi-line
quoted strings with backslash escapes. Order of pairs is preserved,
because the net-config grammar is order-sensitive.

Keys whose feature the port does not serve or train yet raise
:class:`ConfigError` naming the ROADMAP item that brings it, instead of
being accepted and ignored.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Tuple

import torch

ConfigPairs = List[Tuple[str, str]]


class ConfigError(ValueError):
    """Raised on malformed or unsupported config input."""


# -- mixed-precision compute policy ------------------------------------------

# accepted spellings of the ``compute_dtype`` config value
_DTYPE_NAMES = {
    "float32": "float32", "fp32": "float32", "f32": "float32",
    "bfloat16": "bfloat16", "bf16": "bfloat16",
    "float16": "float16", "fp16": "float16", "f16": "float16",
}
_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class Policy:
    """Mixed-precision policy: fp32 master parameters, activations in
    ``compute_dtype``, fp32 outputs (serve responses). Batch-norm
    statistics and softmax stay fp32 whatever the policy."""
    param_dtype: torch.dtype
    compute_dtype: torch.dtype
    output_dtype: torch.dtype


def parse_policy(name: str) -> Policy:
    """``compute_dtype`` config value -> :class:`Policy`."""
    canon = _DTYPE_NAMES.get(name.strip().lower())
    if canon is None:
        raise ConfigError(
            f"compute_dtype must be one of float32|bfloat16|float16 "
            f"(got {name!r})")
    return Policy(param_dtype=torch.float32,
                  compute_dtype=_TORCH_DTYPES[canon],
                  output_dtype=torch.float32)


# -- fused kernel selection ---------------------------------------------------

_FUSED_MODES = {
    "auto": "auto", "": "auto",
    "1": "on", "on": "on", "true": "on", "yes": "on",
    "0": "off", "off": "off", "false": "off", "no": "off",
}


def parse_fused_mode(val: str) -> str:
    """Canonicalize the ``fused_kernels`` knob to auto|on|off. In the
    port ``auto`` and ``on`` both mean "the hand-written kernel on a
    CUDA tensor"; ``off`` selects the plain PyTorch versions. The
    ``CXXNET_FUSED_KERNELS`` env override takes the same values."""
    canon = _FUSED_MODES.get(str(val).strip().lower())
    if canon is None:
        raise ConfigError(
            f"fused_kernels must be one of auto|1|0 (got {val!r})")
    return canon


# -- serving ------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """The ``serve_*`` knob set of the single-engine server."""
    port: int = 8080              # serve_port
    host: str = "127.0.0.1"       # serve_host
    buckets: str = ""             # serve_buckets: comma ladder ('' = auto)
    max_batch: int = 64           # serve_max_batch
    cache_size: int = 16          # serve_cache_size
    dtype: str = ""               # serve_dtype: compute-dtype override,
    #   or int8: serve a PTQ-derived round through the int8 path
    max_latency_ms: float = 5.0   # serve_max_latency_ms
    queue_rows: int = 1024        # serve_queue_rows
    timeout_ms: float = 0.0       # serve_timeout_ms (0 = none)
    log_interval_s: float = 30.0  # serve_log_interval
    breaker_threshold: int = 5    # serve_breaker_threshold (0 = off)
    breaker_reset_s: float = 10.0  # serve_breaker_reset_s
    degraded_queue_frac: float = 0.8  # serve_degraded_queue_frac


#: keys of the JAX package's serve namespace that belong to features the
#: port does not serve yet -> (value that means "off", ROADMAP item)
_NOT_YET = {
    "serve_replicas": ("1", "Queue A 4 (fleet serving)"),
    "serve_reload_s": ("0", "Queue A 4 (fleet serving, hot reload)"),
    "serve_ab": ("0", "Queue A 4 (fleet serving, A/B pinning)"),
    "serve_ab_replicas": ("1", "Queue A 4 (fleet serving, A/B pinning)"),
    "serve_admission": ("1", "Queue A 4 (fleet serving, admission)"),
    "serve_drain_timeout_s": ("30", "Queue A 4 (fleet serving, reload)"),
    "serve_slo_ms": ("0", "Queue A 12 (telemetry: SLO burn rate)"),
    "serve_slo_target": ("0.99", "Queue A 12 (telemetry: SLO burn rate)"),
    "serve_slo_window_s": ("60", "Queue A 12 (telemetry: SLO burn rate)"),
    "serve_slo_burn_degraded": ("2", "Queue A 12 (telemetry: SLO burn rate)"),
}

#: config-key prefixes of features the port does not serve yet
_NOT_YET_PREFIXES = {
    "cascade_": "Queue A 4 (int8 cascade serving)",
    "deploy_": "Queue A 4 (closed-loop deployment)",
}


def _same_value(a: str, b: str) -> bool:
    try:
        return float(a) == float(b)
    except ValueError:
        return a.strip() == b.strip()


def parse_serve_config(cfg: ConfigPairs) -> ServeConfig:
    """Collect and validate the ``serve_*`` keys (last occurrence wins;
    unknown keys raise). Keys of features the port does not serve yet
    raise unless they hold their "off" value."""
    known = {
        "serve_port": ("port", int),
        "serve_host": ("host", str),
        "serve_buckets": ("buckets", str),
        "serve_max_batch": ("max_batch", int),
        "serve_cache_size": ("cache_size", int),
        "serve_dtype": ("dtype", str),
        "serve_max_latency_ms": ("max_latency_ms", float),
        "serve_queue_rows": ("queue_rows", int),
        "serve_timeout_ms": ("timeout_ms", float),
        "serve_log_interval": ("log_interval_s", float),
        "serve_breaker_threshold": ("breaker_threshold", int),
        "serve_breaker_reset_s": ("breaker_reset_s", float),
        "serve_degraded_queue_frac": ("degraded_queue_frac", float),
    }
    vals = {}
    for name, val in cfg:
        for prefix, item in _NOT_YET_PREFIXES.items():
            if name.startswith(prefix) and not (
                    name.endswith("_enable") and _same_value(val, "0")):
                raise ConfigError(
                    f"{name}: not served by the PyTorch port yet "
                    f"(ROADMAP {item})")
        if not name.startswith("serve_"):
            continue
        if name in _NOT_YET:
            off, item = _NOT_YET[name]
            if not _same_value(val, off):
                raise ConfigError(
                    f"{name} = {val}: not served by the PyTorch port yet "
                    f"(ROADMAP {item})")
            continue
        if name not in known:
            raise ConfigError(
                f"unknown serve setting {name!r}; valid keys: "
                + ", ".join(sorted(known)))
        field, conv = known[name]
        try:
            vals[field] = conv(val)
        except ValueError as e:
            raise ConfigError(f"bad {name} value {val!r}: {e}")
    sc = ServeConfig(**vals)
    if sc.dtype and sc.dtype.strip().lower() != "int8":
        parse_policy(sc.dtype)
    if sc.max_batch < 1 or sc.queue_rows < 1 or sc.cache_size < 1:
        raise ConfigError(
            "serve_max_batch, serve_queue_rows and serve_cache_size "
            f"must be >= 1, got {sc.max_batch}/{sc.queue_rows}/"
            f"{sc.cache_size}")
    if sc.breaker_threshold < 0:
        raise ConfigError(
            f"serve_breaker_threshold must be >= 0, got "
            f"{sc.breaker_threshold}")
    return sc


# -- post-training quantization -----------------------------------------------

@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """The ``quant_*`` / ``cascade_*`` knob set: the PTQ pass's
    calibration and the drift-verdict thresholds, with the JAX package's
    keys, defaults and validation (a typo'd key raises). The cascade
    keys are parsed and validated too, but ``cascade_enable = 1`` raises:
    the two-tier cascade is not served by the port yet."""
    calib_batches: int = 4        # quant_calib_batches: activation calib
    calib_percentile: float = 100.0  # quant_calib_percentile (100=absmax)
    max_rel_err: float = 0.05     # quant_max_rel_err: drift gate (RMS)
    max_sat_frac: float = 0.05    # quant_max_sat_frac: |q|==127 fraction
    parity_tol: float = 0.02      # quant_parity_tol: int8-vs-fp accuracy
    cascade_enable: int = 0       # cascade_enable: 1 = route via cascade
    cascade_threshold: float = 0.5  # cascade_threshold: escalate below
    cascade_metric: str = "margin"  # cascade_metric: margin|entropy
    cascade_model: str = ""       # cascade_model: fast-tier checkpoint
    cascade_replicas: int = 1     # cascade_replicas: fast-tier size


def parse_quant_config(cfg: ConfigPairs) -> QuantConfig:
    """Collect and validate the ``quant_*`` / ``cascade_*`` keys (last
    occurrence wins; unknown keys in either namespace raise)."""
    known = {
        "quant_calib_batches": ("calib_batches", int),
        "quant_calib_percentile": ("calib_percentile", float),
        "quant_max_rel_err": ("max_rel_err", float),
        "quant_max_sat_frac": ("max_sat_frac", float),
        "quant_parity_tol": ("parity_tol", float),
        "cascade_enable": ("cascade_enable", int),
        "cascade_threshold": ("cascade_threshold", float),
        "cascade_metric": ("cascade_metric", str),
        "cascade_model": ("cascade_model", str),
        "cascade_replicas": ("cascade_replicas", int),
    }
    vals = {}
    for name, val in cfg:
        if name.startswith("quant_") or name.startswith("cascade_"):
            if name not in known:
                raise ConfigError(
                    f"unknown quant/cascade setting {name!r}; valid "
                    "keys: " + ", ".join(sorted(known)))
            field, conv = known[name]
            try:
                vals[field] = conv(val)
            except ValueError as e:
                raise ConfigError(f"bad {name} value {val!r}: {e}")
    qc = QuantConfig(**vals)
    if qc.calib_batches < 1:
        raise ConfigError(
            f"quant_calib_batches must be >= 1, got {qc.calib_batches}")
    if not 0.0 < qc.calib_percentile <= 100.0:
        raise ConfigError(
            "quant_calib_percentile must be in (0, 100], got "
            f"{qc.calib_percentile}")
    if qc.max_rel_err <= 0 or qc.max_sat_frac < 0:
        raise ConfigError(
            "quant_max_rel_err must be > 0 and quant_max_sat_frac "
            f">= 0, got {qc.max_rel_err}/{qc.max_sat_frac}")
    if qc.parity_tol <= 0:
        raise ConfigError(
            f"quant_parity_tol must be > 0, got {qc.parity_tol}")
    if qc.cascade_enable not in (0, 1):
        raise ConfigError(
            f"cascade_enable must be 0 or 1, got {qc.cascade_enable}")
    if not 0.0 < qc.cascade_threshold < 1.0:
        raise ConfigError(
            "cascade_threshold must be in (0, 1), got "
            f"{qc.cascade_threshold}")
    if qc.cascade_metric not in ("margin", "entropy"):
        raise ConfigError(
            f"cascade_metric must be margin|entropy, got "
            f"{qc.cascade_metric!r}")
    if qc.cascade_replicas < 1:
        raise ConfigError(
            f"cascade_replicas must be >= 1, got {qc.cascade_replicas}")
    if qc.cascade_enable:
        raise ConfigError(
            "cascade_enable = 1: not served by the PyTorch port yet "
            f"(ROADMAP {_NOT_YET_PREFIXES['cascade_']})")
    return qc


# -- training -----------------------------------------------------------------

_A3 = "Queue A 3, still queued: "

#: training keys of features the port does not train with yet ->
#: (predicate "holds its off value", ROADMAP item)
TRAIN_NOT_YET = {
    "continue": (lambda v: _same_value(v, "0"),
                 _A3 + "continue = 1 and finetune"),
    "model_in": (lambda v: v.strip() == "NULL",
                 _A3 + "continue = 1 and finetune (start from a round)"),
    "compute_dtype": (lambda v: _DTYPE_NAMES.get(v.strip().lower())
                      != "float16", _A3 + "the fp16 loss scaler"),
    "update_period": (lambda v: _same_value(v, "1"), _A3 + "update_period"),
    "train_chain": (lambda v: int(v) <= 1, _A3 + "train_chain"),
    "health": (lambda v: _same_value(v, "0"), "Queue A 12 (model health)"),
    "sentinel": (lambda v: _same_value(v, "0"),
                 "Queue A 12 (the loss sentinel)"),
    "failpoints": (lambda v: not v.strip(),
                   "Queue A 12 (fault injection)"),
    "profile_dir": (lambda v: not v.strip(),
                    "Queue A 12 (profile_dir -> torch.profiler)"),
    "shard_ckpt": (lambda v: _same_value(v, "0"),
                   "Queue A 11 (sharded checkpoints)"),
    "save_async": (lambda v: _same_value(v, "0"),
                   "Queue A 11 (async save)"),
    "keep_last_n": (lambda v: _same_value(v, "0"),
                    "Queue A 11 (checkpoint rotation)"),
    "data_service": (lambda v: not v.strip(),
                     "Queue A 2 (the input data service)"),
    "test_io": (lambda v: _same_value(v, "0"),
                "Queue A 2 (input pipeline benchmarking)"),
    "model_parallel": (lambda v: _same_value(v, "1"),
                       "Queue A 9 (model parallelism)"),
    "seq_parallel": (lambda v: _same_value(v, "1"),
                     "Queue A 9 (model parallelism)"),
    "pipeline_parallel": (lambda v: _same_value(v, "1"),
                          "Queue A 9 (model parallelism)"),
    "dist_coordinator": (lambda v: not v.strip(),
                         "Queue A 5, still queued: multi-host launch"),
    "dist_num_proc": (lambda v: _same_value(v, "1"),
                      "Queue A 5, still queued: multi-host launch"),
    "dist_rank": (lambda v: _same_value(v, "0"),
                  "Queue A 5, still queued: multi-host launch"),
}

#: key prefixes of training features the port does not run yet
TRAIN_NOT_YET_PREFIXES = {
    "elastic_": "Queue A 12 (elastic training)",
    "telemetry_": "Queue A 12 (telemetry)",
}


def check_train_config(cfg: ConfigPairs) -> None:
    """Raise :class:`ConfigError` naming the ROADMAP item for the first
    training key whose feature the port does not run yet, unless it
    holds its off value (the last occurrence of a key decides)."""
    last = {}
    for name, val in cfg:
        last[name] = val
    for name, val in last.items():
        item = None
        if name in TRAIN_NOT_YET:
            off, item = TRAIN_NOT_YET[name]
            try:
                if off(val):
                    continue
            except ValueError:
                pass
        else:
            item = next((it for pre, it in TRAIN_NOT_YET_PREFIXES.items()
                         if name.startswith(pre)), None)
            if item is None or not val.strip() or _same_value(val, "0"):
                continue
        raise ConfigError(f"{name} = {val}: not trained by the PyTorch "
                          f"port yet (ROADMAP {item})")


# -- iterator sections --------------------------------------------------------

_SECTION_KEYS = ("data", "eval", "pred")


def split_sections(cfg: ConfigPairs):
    """Separate iterator sections (``data = train`` .. ``iter = end``)
    from the global settings. Returns ``(global_cfg, sections)`` with
    sections as ``(kind, name, pairs)``; nothing here opens a file."""
    global_cfg: ConfigPairs = []
    sections: List[Tuple[str, str, ConfigPairs]] = []
    cur: Optional[List] = None
    for name, val in cfg:
        if name in _SECTION_KEYS:
            cur = []
            sections.append((name, val, cur))
            continue
        if name == "iter":
            if cur is None:
                continue
            if val == "end":
                cur = None
            else:
                cur.append((name, val))
            continue
        if cur is not None:
            cur.append((name, val))
        else:
            global_cfg.append((name, val))
    return global_cfg, sections


# -- tokenizer ----------------------------------------------------------------

class _Tokenizer:
    def __init__(self, text: str):
        self._text = text
        self._pos = 0
        self._line = 1

    def _getc(self) -> str:
        if self._pos >= len(self._text):
            return ""
        ch = self._text[self._pos]
        self._pos += 1
        if ch == "\n":
            self._line += 1
        return ch

    def tokens(self) -> Iterator[str]:
        """Yield raw tokens; ``=`` is always its own token."""
        ch = self._getc()
        tok: List[str] = []
        while ch:
            if ch == "#":
                while ch and ch not in "\r\n":
                    ch = self._getc()
                continue
            if ch in ('"', "'"):
                if tok:
                    raise ConfigError(
                        f"line {self._line}: token followed directly by string")
                quote = ch
                buf: List[str] = []
                ch = self._getc()
                while True:
                    if not ch:
                        raise ConfigError(f"line {self._line}: unterminated string")
                    if ch == "\\":
                        buf.append(self._getc())
                    elif ch == quote:
                        break
                    elif ch in "\r\n" and quote == '"':
                        raise ConfigError(f"line {self._line}: unterminated string")
                    else:
                        buf.append(ch)
                    ch = self._getc()
                yield "".join(buf)
                ch = self._getc()
                continue
            if ch == "=":
                if tok:
                    yield "".join(tok)
                    tok = []
                yield "="
                ch = self._getc()
                continue
            if ch in " \t\r\n":
                if tok:
                    yield "".join(tok)
                    tok = []
                ch = self._getc()
                continue
            tok.append(ch)
            ch = self._getc()
        if tok:
            yield "".join(tok)


def parse_config_string(text: str) -> ConfigPairs:
    """Parse config text into an ordered list of (name, value) pairs."""
    out: ConfigPairs = []
    toks = list(_Tokenizer(text).tokens())
    i = 0
    while i < len(toks):
        name = toks[i]
        if name == "=":
            raise ConfigError("expected parameter name, got '='")
        if i + 1 >= len(toks):
            raise ConfigError(f"dangling token {name!r} at end of config")
        if toks[i + 1] != "=":
            raise ConfigError(f"expected '=' after {name!r}")
        if i + 2 >= len(toks) or toks[i + 2] == "=":
            raise ConfigError(f"expected value after '{name} ='")
        out.append((name, toks[i + 2]))
        i += 3
    return out


def parse_config_file(path: str) -> ConfigPairs:
    with open(path, "rb") as f:
        return parse_config_string(f.read().decode("utf-8"))


def parse_cli_overrides(argv: List[str]) -> ConfigPairs:
    """``key=value`` command-line overrides, appended after the file's
    pairs so they win for scalar settings."""
    out: ConfigPairs = []
    for arg in argv:
        if "=" not in arg:
            raise ConfigError(f"cannot parse CLI override {arg!r}; expected key=value")
        k, v = arg.split("=", 1)
        out.append((k.strip(), v.strip()))
    return out
