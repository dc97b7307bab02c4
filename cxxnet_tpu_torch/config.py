"""Config-file parser for the cxxnet key=value dialect (PyTorch port).

The port's own copy of the parts of ``cxxnet_tpu/config.py`` that the
serving and training paths need: the tokenizer and
``parse_config_string``, the mixed-precision :class:`Policy` (mapped to
torch dtypes), the ``fused_kernels`` grammar, the ``serve_*``,
``lm_serve_*`` / ``kv_*``, ``quant_*``, ``telemetry_*``,
``data_service*``, ``io_retry_*``, ``health*``, ``partition_rules`` /
``fsdp_*`` and ``shard_ckpt*`` / ``compile_cache_dir`` namespaces, the
training keys the port does not run yet, and the split of iterator
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


# -- telemetry ----------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """The ``telemetry_*`` knob set, with the JAX package's keys,
    defaults and validation. Every field's zero value means off, but the
    step-time probe's (``telemetry_steptime = 1``)."""
    trace_path: str = ""          # telemetry_trace: Chrome-trace JSON out
    trace_capacity: int = 65536   # telemetry_trace_capacity: span ring
    # -- distributed tracing (telemetry/disttrace.py) ------------------
    trace_sample: float = 1.0     # telemetry_trace_sample: root fraction
    trace_tail_pct: float = 0.0   # telemetry_trace_tail_pct: exemplars
    trace_tail_window: int = 128  # telemetry_trace_tail_window: history
    trace_anchor_s: float = 30.0  # telemetry_trace_anchor_s: clock pairs
    sync_interval: int = 8        # telemetry_sync_interval: probe cadence
    port: int = 0                 # telemetry_port: standalone /metrics
    log_path: str = ""            # telemetry_log: JSONL snapshots
    log_interval_s: float = 5.0   # telemetry_log_interval (seconds)
    log_max_kb: int = 1024        # telemetry_log_max_kb: rotate beyond
    profile_steps: str = ""       # telemetry_profile_steps: "a-b"
    profile_dir: str = ""         # telemetry_profile_dir: trace dump dir
    steptime: int = 1             # telemetry_steptime: 0 disables probe
    ledger_path: str = ""         # telemetry_ledger: run-ledger JSONL
    run_id: str = ""              # telemetry_run_id: share across procs
    # -- fleet observability (telemetry/aggregate.py, anomaly.py) ------
    fleet_dir: str = ""           # telemetry_fleet_dir: snapshot push dir
    push_interval_s: float = 10.0  # telemetry_push_interval (seconds)
    host: int = -1                # telemetry_host: -1 = the dp rank
    hang_s: float = 0.0           # telemetry_hang_s: 0 = watchdog off
    hang_dryrun: int = 0          # telemetry_hang_dryrun: 1 = one dump
    straggler_factor: float = 2.0  # telemetry_straggler_factor
    straggler_min_steps: int = 8  # telemetry_straggler_min_steps
    storm_window_s: float = 60.0  # telemetry_storm_window (seconds)
    storm_threshold: int = 8      # telemetry_storm_threshold


def parse_telemetry_config(cfg: ConfigPairs) -> TelemetryConfig:
    """Collect and validate the ``telemetry_*`` keys (last occurrence
    wins; an unknown key in the namespace raises, as in the JAX
    package)."""
    known = {
        "telemetry_trace": ("trace_path", str),
        "telemetry_trace_capacity": ("trace_capacity", int),
        "telemetry_trace_sample": ("trace_sample", float),
        "telemetry_trace_tail_pct": ("trace_tail_pct", float),
        "telemetry_trace_tail_window": ("trace_tail_window", int),
        "telemetry_trace_anchor_s": ("trace_anchor_s", float),
        "telemetry_sync_interval": ("sync_interval", int),
        "telemetry_port": ("port", int),
        "telemetry_log": ("log_path", str),
        "telemetry_log_interval": ("log_interval_s", float),
        "telemetry_log_max_kb": ("log_max_kb", int),
        "telemetry_profile_steps": ("profile_steps", str),
        "telemetry_profile_dir": ("profile_dir", str),
        "telemetry_steptime": ("steptime", int),
        "telemetry_ledger": ("ledger_path", str),
        "telemetry_run_id": ("run_id", str),
        "telemetry_fleet_dir": ("fleet_dir", str),
        "telemetry_push_interval": ("push_interval_s", float),
        "telemetry_host": ("host", int),
        "telemetry_hang_s": ("hang_s", float),
        "telemetry_hang_dryrun": ("hang_dryrun", int),
        "telemetry_straggler_factor": ("straggler_factor", float),
        "telemetry_straggler_min_steps": ("straggler_min_steps", int),
        "telemetry_storm_window": ("storm_window_s", float),
        "telemetry_storm_threshold": ("storm_threshold", int),
    }
    vals = {}
    for name, val in cfg:
        if name.startswith("telemetry_"):
            if name not in known:
                raise ConfigError(
                    f"unknown telemetry setting {name!r}; valid keys: "
                    + ", ".join(sorted(known)))
            field, conv = known[name]
            try:
                vals[field] = conv(val)
            except ValueError as e:
                raise ConfigError(f"bad {name} value {val!r}: {e}")
    tc = TelemetryConfig(**vals)
    if tc.trace_capacity < 1:
        raise ConfigError(
            f"telemetry_trace_capacity must be >= 1, got "
            f"{tc.trace_capacity}")
    if tc.sync_interval < 1:
        raise ConfigError(
            f"telemetry_sync_interval must be >= 1, got "
            f"{tc.sync_interval}")
    if not 0.0 <= tc.trace_sample <= 1.0:
        raise ConfigError(
            f"telemetry_trace_sample must be in [0, 1], got "
            f"{tc.trace_sample}")
    if not 0.0 <= tc.trace_tail_pct < 100.0:
        raise ConfigError(
            f"telemetry_trace_tail_pct must be in [0, 100) "
            f"(0 = keep every sampled trace), got {tc.trace_tail_pct}")
    if tc.trace_tail_window < 2:
        raise ConfigError(
            f"telemetry_trace_tail_window must be >= 2, got "
            f"{tc.trace_tail_window}")
    if tc.trace_anchor_s <= 0:
        raise ConfigError(
            f"telemetry_trace_anchor_s must be > 0, got "
            f"{tc.trace_anchor_s}")
    if tc.log_max_kb < 1:
        raise ConfigError(
            f"telemetry_log_max_kb must be >= 1, got {tc.log_max_kb}")
    if tc.log_interval_s <= 0:
        raise ConfigError(
            f"telemetry_log_interval must be > 0, got "
            f"{tc.log_interval_s}")
    if tc.push_interval_s <= 0:
        raise ConfigError(
            f"telemetry_push_interval must be > 0, got "
            f"{tc.push_interval_s}")
    if tc.hang_s < 0:
        raise ConfigError(
            f"telemetry_hang_s must be >= 0, got {tc.hang_s}")
    if tc.straggler_factor <= 1.0:
        raise ConfigError(
            f"telemetry_straggler_factor must be > 1, got "
            f"{tc.straggler_factor}")
    if tc.straggler_min_steps < 1:
        raise ConfigError(
            f"telemetry_straggler_min_steps must be >= 1, got "
            f"{tc.straggler_min_steps}")
    if tc.storm_window_s <= 0 or tc.storm_threshold < 1:
        raise ConfigError(
            "telemetry_storm_window must be > 0 and "
            "telemetry_storm_threshold >= 1, got "
            f"{tc.storm_window_s}/{tc.storm_threshold}")
    if tc.profile_steps:
        from .telemetry.profiler import parse_step_range
        try:
            parse_step_range(tc.profile_steps)
        except ValueError as e:
            raise ConfigError(str(e))
        if not tc.profile_dir:
            tc = dataclasses.replace(tc, profile_dir="./profile_dump")
    return tc


# -- serving ------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """The ``serve_*`` knob set: the engine, its batcher, breaker and
    latency SLO, and the fleet (replicas, hot reload, A/B pins,
    admission control)."""
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
    slo_ms: float = 0.0           # serve_slo_ms (0 = SLO tracking off)
    slo_target: float = 0.99      # serve_slo_target
    slo_window_s: float = 60.0    # serve_slo_window_s
    slo_burn_degraded: float = 2.0  # serve_slo_burn_degraded
    replicas: int = 1             # serve_replicas: engines in the pool
    reload_s: float = 0.0         # serve_reload_s: round poll (0 = off)
    ab: int = 0                   # serve_ab: 1 = reloads hit canaries only
    ab_replicas: int = 1          # serve_ab_replicas: canary subset size
    admission: int = 1            # serve_admission: 0 disables shedding
    drain_timeout_s: float = 30.0  # serve_drain_timeout_s: reload drain

    @property
    def fleet(self) -> bool:
        """Whether ``task = serve`` builds a replica pool (any fleet
        feature asked for) instead of the single engine."""
        return self.replicas > 1 or self.reload_s > 0 or self.ab > 0


def _same_value(a: str, b: str) -> bool:
    try:
        return float(a) == float(b)
    except ValueError:
        return a.strip() == b.strip()


def parse_serve_config(cfg: ConfigPairs) -> ServeConfig:
    """Collect and validate the ``serve_*`` keys (last occurrence wins;
    unknown keys raise). The ``cascade_*`` keys are
    :func:`parse_quant_config`'s, the ``deploy_*`` keys
    ``deploy.parse_deploy_config``'s."""
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
        "serve_slo_ms": ("slo_ms", float),
        "serve_slo_target": ("slo_target", float),
        "serve_slo_window_s": ("slo_window_s", float),
        "serve_slo_burn_degraded": ("slo_burn_degraded", float),
        "serve_replicas": ("replicas", int),
        "serve_reload_s": ("reload_s", float),
        "serve_ab": ("ab", int),
        "serve_ab_replicas": ("ab_replicas", int),
        "serve_admission": ("admission", int),
        "serve_drain_timeout_s": ("drain_timeout_s", float),
    }
    vals = {}
    for name, val in cfg:
        if not name.startswith("serve_"):
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
    if sc.replicas < 1:
        raise ConfigError(
            f"serve_replicas must be >= 1, got {sc.replicas}")
    if sc.max_batch < 1 or sc.queue_rows < 1 or sc.cache_size < 1:
        raise ConfigError(
            "serve_max_batch, serve_queue_rows and serve_cache_size "
            f"must be >= 1, got {sc.max_batch}/{sc.queue_rows}/"
            f"{sc.cache_size}")
    if sc.breaker_threshold < 0:
        raise ConfigError(
            f"serve_breaker_threshold must be >= 0, got "
            f"{sc.breaker_threshold}")
    if sc.reload_s < 0:
        raise ConfigError(
            f"serve_reload_s must be >= 0, got {sc.reload_s}")
    if sc.ab not in (0, 1):
        raise ConfigError(f"serve_ab must be 0 or 1, got {sc.ab}")
    if sc.ab_replicas < 1:
        raise ConfigError(
            f"serve_ab_replicas must be >= 1, got {sc.ab_replicas}")
    if sc.ab and sc.ab_replicas >= sc.replicas:
        raise ConfigError(
            f"serve_ab_replicas ({sc.ab_replicas}) must be < "
            f"serve_replicas ({sc.replicas}): A/B needs at least one "
            "replica left on the old version")
    if sc.slo_ms > 0 and not 0.0 < sc.slo_target < 1.0:
        raise ConfigError(
            f"serve_slo_target must be in (0, 1), got {sc.slo_target}")
    if sc.drain_timeout_s < 0:
        raise ConfigError(
            f"serve_drain_timeout_s must be >= 0, got "
            f"{sc.drain_timeout_s}")
    return sc


@dataclasses.dataclass(frozen=True)
class LMServeConfig:
    """The ``lm_serve_*`` / ``kv_*`` knob set of the LM plane
    (``serve/lm``): the paged KV-cache's geometry and the continuous-
    batching decode scheduler, with the JAX package's keys, defaults and
    validation (a typo'd key raises)."""
    kv_block_size: int = 16       # kv_block_size: tokens per cache block
    kv_pool_blocks: int = 64      # kv_pool_blocks: blocks in the pool
    kv_dtype: str = ""            # kv_dtype: cache dtype ('' = compute)
    max_seqs: int = 4             # lm_serve_max_seqs: decode batch rows
    max_context: int = 128        # lm_serve_max_context: prompt+gen cap
    max_new_tokens: int = 32      # lm_serve_max_new_tokens: default cap
    prefill_chunk: int = 16       # lm_serve_prefill_chunk: tokens/step
    max_queue: int = 32           # lm_serve_max_queue: waiting requests
    eos: int = -1                 # lm_serve_eos: stop token (-1 = none)
    role: str = "both"            # lm_serve_role: both|prefill|decode
    handoff_port: int = 0         # lm_serve_handoff_port (0 = ephemeral)
    deadline_ms: float = 0.0      # lm_serve_deadline_ms (0 = none)

    @property
    def max_blocks_per_seq(self) -> int:
        """Block-table width: blocks that hold ``max_context`` tokens
        (every step runs at this fixed T)."""
        return -(-self.max_context // self.kv_block_size)


def parse_lm_serve_config(cfg: ConfigPairs) -> LMServeConfig:
    """Collect and validate the ``lm_serve_*`` / ``kv_*`` keys (last
    occurrence wins; unknown keys in either namespace raise). The cache
    dtype is resolved by the engine, through :func:`parse_policy`."""
    known = {
        "kv_block_size": ("kv_block_size", int),
        "kv_pool_blocks": ("kv_pool_blocks", int),
        "kv_dtype": ("kv_dtype", str),
        "lm_serve_max_seqs": ("max_seqs", int),
        "lm_serve_max_context": ("max_context", int),
        "lm_serve_max_new_tokens": ("max_new_tokens", int),
        "lm_serve_prefill_chunk": ("prefill_chunk", int),
        "lm_serve_max_queue": ("max_queue", int),
        "lm_serve_eos": ("eos", int),
        "lm_serve_role": ("role", str),
        "lm_serve_handoff_port": ("handoff_port", int),
        "lm_serve_deadline_ms": ("deadline_ms", float),
    }
    vals = {}
    for name, val in cfg:
        if name.startswith("lm_serve_") or name.startswith("kv_"):
            if name not in known:
                raise ConfigError(
                    f"unknown lm-serve setting {name!r}; valid keys: "
                    + ", ".join(sorted(known)))
            field, conv = known[name]
            try:
                vals[field] = conv(val)
            except ValueError as e:
                raise ConfigError(f"bad {name} value {val!r}: {e}")
    lc = LMServeConfig(**vals)
    if lc.kv_block_size < 1 or lc.kv_pool_blocks < 2:
        raise ConfigError(
            "kv_block_size must be >= 1 and kv_pool_blocks >= 2 "
            "(block 0 is reserved scratch), got "
            f"{lc.kv_block_size}/{lc.kv_pool_blocks}")
    if lc.max_seqs < 1 or lc.max_queue < 1:
        raise ConfigError(
            "lm_serve_max_seqs and lm_serve_max_queue must be >= 1, "
            f"got {lc.max_seqs}/{lc.max_queue}")
    if lc.max_context < 1 or lc.max_new_tokens < 1:
        raise ConfigError(
            "lm_serve_max_context and lm_serve_max_new_tokens must be "
            f">= 1, got {lc.max_context}/{lc.max_new_tokens}")
    if lc.prefill_chunk < 1 or lc.prefill_chunk % lc.kv_block_size:
        raise ConfigError(
            f"lm_serve_prefill_chunk ({lc.prefill_chunk}) must be a "
            f"positive multiple of kv_block_size ({lc.kv_block_size}) "
            "so chunk boundaries align with cache blocks")
    if lc.role not in ("both", "prefill", "decode"):
        raise ConfigError(
            f"lm_serve_role must be both|prefill|decode, got {lc.role!r}")
    if lc.deadline_ms < 0:
        raise ConfigError(
            f"lm_serve_deadline_ms must be >= 0, got {lc.deadline_ms}")
    return lc


# -- post-training quantization -----------------------------------------------

@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """The ``quant_*`` / ``cascade_*`` knob set: the PTQ pass's
    calibration and the drift-verdict thresholds, with the JAX package's
    keys, defaults and validation (a typo'd key raises), and the
    two-tier cascade's (``serve/cascade.py``)."""
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
    return qc


# -- training -----------------------------------------------------------------

#: training keys of features the port does not train with yet ->
#: (predicate "holds its off value", ROADMAP item)
TRAIN_NOT_YET = {
    "shard_ckpt": (lambda v: _same_value(v, "0"),
                   "Queue A 11 (sharded checkpoints)"),
    "shard_ckpt_shards": (lambda v: _same_value(v, "0"),
                          "Queue A 11 (sharded checkpoints)"),
    "compile_cache_dir": (lambda v: not v.strip(),
                          "Queue A 11 (the compile cache)"),
    "save_async": (lambda v: _same_value(v, "0"),
                   "Queue A 11 (async save)"),
    "keep_last_n": (lambda v: _same_value(v, "0"),
                    "Queue A 11 (checkpoint rotation)"),
    "model_parallel": (lambda v: _same_value(v, "1"),
                       "Queue A 9 (model parallelism)"),
    "seq_parallel": (lambda v: _same_value(v, "1"),
                     "Queue A 9 (model parallelism)"),
    "pipeline_parallel": (lambda v: _same_value(v, "1"),
                          "Queue A 9 (model parallelism)"),
    "fsdp_axis": (lambda v: not v.strip(),
                  "Queue A 9 (model parallelism: FSDP)"),
    "fsdp_min_size": (lambda v: _same_value(v, "1024"),
                      "Queue A 9 (model parallelism: FSDP)"),
    "partition_rules": (lambda v: not v.strip(),
                        "Queue A 9 (model parallelism: partition rules)"),
    "dist_coordinator": (lambda v: not v.strip(),
                         "Queue A 5, still queued: multi-host launch"),
    "dist_num_proc": (lambda v: _same_value(v, "1"),
                      "Queue A 5, still queued: multi-host launch"),
    "dist_rank": (lambda v: _same_value(v, "0"),
                  "Queue A 5, still queued: multi-host launch"),
}

#: key prefixes of training features the port does not run yet
TRAIN_NOT_YET_PREFIXES = {
    "elastic_": "Queue A 12, still queued: elastic training",
}


# -- sharding, checkpoint format, model health: the JAX package's namespaces --

@dataclasses.dataclass(frozen=True)
class ShardingConfig:
    """The rule-driven sharding namespace (``partition_rules``,
    ``fsdp_*``), validated as the JAX package validates it; the port
    trains none of it yet (:data:`TRAIN_NOT_YET`)."""
    partition_rules: str = ""   # custom rules prepended to the model table
    fsdp_axis: str = ""         # mesh axis for at-rest param/opt sharding
    fsdp_min_size: int = 1024   # smallest leaf (elements) worth sharding


_FSDP_AXES = ("", "data", "model")


def _check_rule_string(text: str) -> None:
    """The syntax check of the JAX package's ``parse_rule_string``:
    ``pattern->axes;...``, each pattern a regex."""
    import re
    for entry in text.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        if "->" not in entry:
            raise ValueError(
                f"partition rule {entry!r} has no '->' "
                "(expected pattern->axis,axis,...)")
        pat = entry.split("->", 1)[0].strip()
        try:
            re.compile(pat)
        except re.error as e:
            raise ValueError(f"bad partition-rule regex {pat!r}: {e}")


def _parse_namespace(cfg: ConfigPairs, what: str, known, in_space):
    """The JAX package's namespace walk: the keys for which
    ``in_space(name)`` holds must be in ``known`` (name -> (field,
    conv)); last occurrence wins."""
    vals = {}
    for name, val in cfg:
        if in_space(name):
            if name not in known:
                raise ConfigError(
                    f"unknown {what} setting {name!r}; valid keys: "
                    + ", ".join(sorted(known)))
            field, conv = known[name]
            try:
                vals[field] = conv(val)
            except ValueError as e:
                raise ConfigError(f"bad {name} value {val!r}: {e}")
    return vals


def parse_sharding_config(cfg: ConfigPairs) -> ShardingConfig:
    """Collect and validate ``partition_rules`` / ``fsdp_*`` (the JAX
    package's ``parse_sharding_config``, messages included)."""
    sc = ShardingConfig(**_parse_namespace(cfg, "sharding", {
        "partition_rules": ("partition_rules", str),
        "fsdp_axis": ("fsdp_axis", str),
        "fsdp_min_size": ("fsdp_min_size", int),
    }, lambda n: n.startswith("fsdp_") or n.startswith("partition_rule")))
    if sc.fsdp_axis not in _FSDP_AXES:
        raise ConfigError(
            f"fsdp_axis must be one of {'|'.join(a for a in _FSDP_AXES if a)}"
            f" (or unset), got {sc.fsdp_axis!r}")
    if sc.fsdp_min_size < 0:
        raise ConfigError(
            f"fsdp_min_size must be >= 0, got {sc.fsdp_min_size}")
    if sc.partition_rules:
        try:
            _check_rule_string(sc.partition_rules)
        except ValueError as e:
            raise ConfigError(f"bad partition_rules value: {e}")
    return sc


@dataclasses.dataclass(frozen=True)
class CkptConfig:
    """The sharded-checkpoint / compile-cache namespace, validated as the
    JAX package validates it; the port runs none of it yet
    (:data:`TRAIN_NOT_YET`)."""
    shard_ckpt: int = 0          # shard_ckpt: 1 = rounds are shard sets
    shard_ckpt_shards: int = 0   # shard_ckpt_shards: files a set
    compile_cache_dir: str = ""  # compile_cache_dir ('' = off)


def parse_ckpt_config(cfg: ConfigPairs) -> CkptConfig:
    """Collect and validate ``shard_ckpt*`` / ``compile_cache_dir`` (the
    JAX package's ``parse_ckpt_config``, messages included)."""
    cc = CkptConfig(**_parse_namespace(cfg, "checkpoint", {
        "shard_ckpt": ("shard_ckpt", int),
        "shard_ckpt_shards": ("shard_ckpt_shards", int),
        "compile_cache_dir": ("compile_cache_dir", str),
    }, lambda n: n.startswith("shard_ckpt") or n.startswith("compile_cache")))
    if cc.shard_ckpt not in (0, 1):
        raise ConfigError(
            f"shard_ckpt must be 0 or 1, got {cc.shard_ckpt}")
    if cc.shard_ckpt_shards < 0:
        raise ConfigError(
            f"shard_ckpt_shards must be >= 0 (0 = one per process), "
            f"got {cc.shard_ckpt_shards}")
    return cc


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """The ``health`` / ``health_*`` knob set (the JAX package's): the
    in-step model-health probe (telemetry/modelhealth.py). ``health = 0``
    adds no tensor op and no host sync to the step."""
    enabled: int = 0        # health: 1 = in-step model-health probe
    interval: int = 0       # health_interval: sync cadence in steps
    #                         (0 = follow sentinel_interval, default 8)
    window: int = 3         # health_window: consecutive bad syncs
    #                         before a detector emits health_advice
    dead_frac: float = 0.9  # health_dead_frac: dead-ReLU threshold
    bn_var_floor: float = 1e-8  # health_bn_var_floor: BN collapse
    ratio_min: float = 1e-8     # health_ratio_min: update/weight band
    ratio_max: float = 0.1      # health_ratio_max: update/weight band


def parse_health_config(cfg: ConfigPairs) -> HealthConfig:
    """Collect and validate ``health`` / ``health_*`` (the JAX package's
    ``parse_health_config``, messages included)."""
    hc = HealthConfig(**_parse_namespace(cfg, "health", {
        "health": ("enabled", int),
        "health_interval": ("interval", int),
        "health_window": ("window", int),
        "health_dead_frac": ("dead_frac", float),
        "health_bn_var_floor": ("bn_var_floor", float),
        "health_ratio_min": ("ratio_min", float),
        "health_ratio_max": ("ratio_max", float),
    }, lambda n: n == "health" or n.startswith("health_")))
    if hc.enabled not in (0, 1):
        raise ConfigError(f"health must be 0 or 1, got {hc.enabled}")
    if hc.interval < 0:
        raise ConfigError(
            f"health_interval must be >= 0 (0 = sentinel_interval), "
            f"got {hc.interval}")
    if hc.window < 1:
        raise ConfigError(
            f"health_window must be >= 1, got {hc.window}")
    if not 0.0 < hc.dead_frac <= 1.0:
        raise ConfigError(
            f"health_dead_frac must be in (0, 1], got {hc.dead_frac}")
    if hc.bn_var_floor < 0:
        raise ConfigError(
            f"health_bn_var_floor must be >= 0, got {hc.bn_var_floor}")
    if not 0.0 <= hc.ratio_min < hc.ratio_max:
        raise ConfigError(
            "health_ratio_min must be >= 0 and < health_ratio_max, got "
            f"{hc.ratio_min}/{hc.ratio_max}")
    return hc


def check_train_config(cfg: ConfigPairs) -> None:
    """Validate the training namespaces as the JAX package does
    (``telemetry_*``, ``partition_rules`` / ``fsdp_*``, ``shard_ckpt*`` /
    ``compile_cache_dir``, ``health*``: an unknown key or a bad value
    raises its message), then raise :class:`ConfigError` naming the
    ROADMAP item for the first training key whose feature the port does
    not run yet, unless it holds its off value (the last occurrence of a
    key decides)."""
    parse_telemetry_config(cfg)
    parse_sharding_config(cfg)
    parse_ckpt_config(cfg)
    parse_health_config(cfg)
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


# -- input data service ---------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DataServiceConfig:
    """The ``data_service*`` keys, with the JAX package's names, defaults
    and validation. ``data_service`` set: the train data section is
    served by the reader fleet (``host:port[,host:port]``) or, with the
    value ``local``, by the same global-shuffle orchestration in this
    process (the deterministic control and the degrade stream); unset:
    every other key is inert."""
    endpoints: str = ""           # data_service: host:port[,...] | local
    shards: int = 0               # data_service_shards (0 = one a reader)
    seed: int = 0                 # data_service_seed: global shuffle seed
    cache_batches: int = 256      # data_service_cache: reader LRU frames
    readahead: int = 2            # data_service_readahead: decode-ahead
    timeout_ms: float = 5000.0    # data_service_timeout_ms: fetch timeout
    local_fallback: int = 1       # data_service_local_fallback: 0 = hard
    reader: int = -1              # data_service_reader: this reader's idx
    status_dir: str = ""          # data_service_status_dir: status files
    prefetch: int = 2             # data_service_prefetch: client batches
    #                               fetched ahead on a thread (0 = off)

    @property
    def enabled(self) -> bool:
        return bool(self.endpoints.strip())

    @property
    def local_only(self) -> bool:
        return self.endpoints.strip().lower() == "local"

    @property
    def endpoint_list(self) -> List[str]:
        if not self.enabled or self.local_only:
            return []
        return [e.strip() for e in self.endpoints.split(",") if e.strip()]

    @property
    def n_shards(self) -> int:
        return self.shards or max(1, len(self.endpoint_list))

    @staticmethod
    def split_endpoint(endpoint: str) -> Tuple[str, int]:
        host, _, port = endpoint.rpartition(":")
        return host, int(port)


def parse_data_service_config(cfg: ConfigPairs) -> DataServiceConfig:
    """Collect and validate the ``data_service*`` keys (the last
    occurrence wins; an unknown key of the namespace raises)."""
    known = {
        "data_service": ("endpoints", str),
        "data_service_shards": ("shards", int),
        "data_service_seed": ("seed", int),
        "data_service_cache": ("cache_batches", int),
        "data_service_readahead": ("readahead", int),
        "data_service_timeout_ms": ("timeout_ms", float),
        "data_service_local_fallback": ("local_fallback", int),
        "data_service_reader": ("reader", int),
        "data_service_status_dir": ("status_dir", str),
        "data_service_prefetch": ("prefetch", int),
    }
    vals = {}
    for name, val in cfg:
        if name.startswith("data_service"):
            if name not in known:
                raise ConfigError(
                    f"unknown data_service setting {name!r}; valid "
                    "keys: " + ", ".join(sorted(known)))
            field, conv = known[name]
            try:
                vals[field] = conv(val)
            except ValueError as e:
                raise ConfigError(f"bad {name} value {val!r}: {e}")
    dc = DataServiceConfig(**vals)
    if dc.enabled and not dc.local_only:
        for ep in dc.endpoint_list:
            host, _, port = ep.rpartition(":")
            if not host or not port.isdigit():
                raise ConfigError(
                    f"data_service endpoint {ep!r} is not host:port "
                    "(or the single value 'local')")
    if dc.shards < 0:
        raise ConfigError(
            f"data_service_shards must be >= 0 (0 = one per reader), "
            f"got {dc.shards}")
    if dc.cache_batches < 1:
        raise ConfigError(
            f"data_service_cache must be >= 1, got {dc.cache_batches}")
    if dc.readahead < 0:
        raise ConfigError(
            f"data_service_readahead must be >= 0, got {dc.readahead}")
    if dc.prefetch < 0:
        raise ConfigError(
            f"data_service_prefetch must be >= 0, got {dc.prefetch}")
    if dc.timeout_ms <= 0:
        raise ConfigError(
            f"data_service_timeout_ms must be > 0, got "
            f"{dc.timeout_ms}")
    if dc.local_fallback not in (0, 1):
        raise ConfigError(
            f"data_service_local_fallback must be 0 or 1, got "
            f"{dc.local_fallback}")
    if dc.reader < -1:
        raise ConfigError(
            f"data_service_reader must be >= 0 (or -1 = unset), got "
            f"{dc.reader}")
    if dc.enabled and dc.local_only and dc.shards < 1:
        raise ConfigError(
            "data_service = local needs an explicit "
            "data_service_shards >= 1 (there is no endpoint list to "
            "default the shard count from)")
    return dc


# -- IO retry policy ------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Backoff of transient IO failures (``resilience.retry_call``), which
    ``io/stream.py`` applies to every remote operation: 4 attempts, 50 ms
    to 2 s, full jitter by default."""
    attempts: int = 4
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    jitter: float = 1.0          # 0 = deterministic backoff, 1 = full jitter


def parse_retry_policy(cfg: ConfigPairs) -> RetryPolicy:
    """A :class:`RetryPolicy` from the ``io_retry_attempts``,
    ``io_retry_base_ms``, ``io_retry_max_ms`` and ``io_retry_jitter``
    keys (the last occurrence wins; an unknown ``io_retry_*`` key
    raises)."""
    known = {"io_retry_attempts", "io_retry_base_ms", "io_retry_max_ms",
             "io_retry_jitter"}
    vals = {}
    for name, val in cfg:
        if name.startswith("io_retry_"):
            if name not in known:
                raise ConfigError(
                    f"unknown retry setting {name!r}; valid keys: "
                    + ", ".join(sorted(known)))
            vals[name] = val
    try:
        pol = RetryPolicy(
            attempts=int(vals.get("io_retry_attempts", "4")),
            base_delay_s=float(vals.get("io_retry_base_ms", "50")) / 1e3,
            max_delay_s=float(vals.get("io_retry_max_ms", "2000")) / 1e3,
            jitter=float(vals.get("io_retry_jitter", "1.0")))
    except ValueError as e:
        raise ConfigError(f"bad io_retry_* value: {e}")
    if pol.attempts < 1:
        raise ConfigError(
            f"io_retry_attempts must be >= 1, got {pol.attempts}")
    if not 0.0 <= pol.jitter <= 1.0:
        raise ConfigError(
            f"io_retry_jitter must be in [0, 1], got {pol.jitter}")
    return pol


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
    """Parse a config file, local or remote (``io/stream.py``)."""
    from .io.stream import sopen
    with sopen(path, "rb") as f:
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
