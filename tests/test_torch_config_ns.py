"""The training namespaces the port validates as the JAX package does
(ROADMAP queue C, item 1): ``partition_rules`` / ``fsdp_*``,
``shard_ckpt*`` / ``compile_cache_dir`` and ``health*``.

* each key the JAX parsers reject (a typo, an unknown key, a bad value
  of each namespace) makes the port's ``check_train_config`` raise the
  JAX message, word for word;
* the values the JAX parsers accept parse to the same fields;
* a value of ``fsdp_axis``, ``fsdp_min_size``, ``partition_rules``,
  ``shard_ckpt_shards`` or ``compile_cache_dir`` other than the default
  names its ROADMAP item (A 9, A 11); ``health`` and the ``health_*``
  keys train.
"""

import dataclasses

import pytest

from cxxnet_tpu_torch.config import (ConfigError, check_train_config,
                                     parse_ckpt_config, parse_health_config,
                                     parse_sharding_config)

#: (pairs, the JAX parser that rejects them) for each namespace
REJECTED = [
    ([("fsdp_axs", "data")], "sharding"),
    ([("partition_rule", "x->data")], "sharding"),
    ([("fsdp_axis", "seq")], "sharding"),
    ([("fsdp_min_size", "-1")], "sharding"),
    ([("fsdp_min_size", "big")], "sharding"),
    ([("partition_rules", ".*:data")], "sharding"),
    ([("partition_rules", "(->data")], "sharding"),
    ([("shard_ckpt_typo", "1")], "ckpt"),
    ([("compile_cachedir", "/tmp/x")], "ckpt"),
    ([("shard_ckpt", "2")], "ckpt"),
    ([("shard_ckpt_shards", "-1")], "ckpt"),
    ([("shard_ckpt_shards", "two")], "ckpt"),
    ([("health_typo", "1")], "health"),
    ([("healthy", "1")], None),
    ([("health", "2")], "health"),
    ([("health_interval", "-1")], "health"),
    ([("health_window", "0")], "health"),
    ([("health_dead_frac", "0")], "health"),
    ([("health_bn_var_floor", "-1")], "health"),
    ([("health_ratio_min", "0.5"), ("health_ratio_max", "0.1")], "health"),
    ([("health_dead_frac", "most")], "health"),
]

#: a value other than the default of each key the port does not run
NOT_RUN = [
    ("fsdp_axis", "data", "Queue A 9"),
    ("fsdp_axis", "model", "Queue A 9"),
    ("fsdp_min_size", "4096", "Queue A 9"),
    ("partition_rules", "fc1/wmat->-,model", "Queue A 9"),
    ("shard_ckpt_shards", "4", "Queue A 11"),
    ("compile_cache_dir", "/tmp/cc", "Queue A 11"),
    ("shard_ckpt", "1", "Queue A 11"),
]

#: accepted values: the same fields in both packages
ACCEPTED = [
    [],
    [("fsdp_min_size", "1024"), ("fsdp_axis", ""), ("partition_rules", "")],
    [("shard_ckpt", "0"), ("shard_ckpt_shards", "0")],
    [("health", "1"), ("health_interval", "5"), ("health_window", "2"),
     ("health_dead_frac", "0.5"), ("health_bn_var_floor", "1e-6"),
     ("health_ratio_min", "0"), ("health_ratio_max", "0.3")],
]


def _jax_parser(kind):
    import cxxnet_tpu.config as jc
    return {"sharding": jc.parse_sharding_config,
            "ckpt": jc.parse_ckpt_config,
            "health": jc.parse_health_config}[kind]


@pytest.mark.parametrize("pairs,kind", REJECTED,
                         ids=[f"{p[0][0]}={p[0][1]}" for p, _ in REJECTED])
def test_rejected_keys_raise_the_jax_message(pairs, kind):
    if kind is None:
        # outside every namespace: both packages let it through
        check_train_config(pairs)
        return
    from cxxnet_tpu.config import ConfigError as JaxConfigError
    with pytest.raises(JaxConfigError) as want:
        _jax_parser(kind)(pairs)
    with pytest.raises(ConfigError) as got:
        check_train_config(pairs)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("key,val,item", NOT_RUN,
                         ids=[f"{k}={v}" for k, v, _ in NOT_RUN])
def test_values_the_port_does_not_run_name_their_item(key, val, item):
    kind = "ckpt" if key.startswith(("shard", "compile")) else "sharding"
    _jax_parser(kind)([(key, val)])          # valid in the JAX package
    with pytest.raises(ConfigError,
                       match=rf"{key} = {val}: not trained by the PyTorch "
                             rf"port yet \(ROADMAP {item}"):
        check_train_config([(key, val)])


@pytest.mark.parametrize("pairs", ACCEPTED,
                         ids=["empty", "sharding", "ckpt", "health"])
def test_accepted_values_parse_to_the_jax_fields(pairs):
    check_train_config(pairs)
    for kind, port in (("sharding", parse_sharding_config),
                       ("ckpt", parse_ckpt_config),
                       ("health", parse_health_config)):
        assert dataclasses.asdict(port(pairs)) == \
            dataclasses.asdict(_jax_parser(kind)(pairs))


def test_only_elastic_still_names_queue_a12():
    from cxxnet_tpu_torch.config import parse_telemetry_config
    for key, val in (("telemetry_fleet_dir", "/f"), ("telemetry_hang_s", "5"),
                     ("telemetry_trace_sample", "0.5"),
                     ("telemetry_straggler_factor", "3"),
                     ("telemetry_storm_threshold", "4"),
                     ("telemetry_trace_tail_pct", "5"), ("health", "1")):
        check_train_config([(key, val)])
    assert parse_telemetry_config([("telemetry_hang_s", "5")]).hang_s == 5.0
    with pytest.raises(ConfigError, match="Queue A 12, still queued: "
                                          "elastic"):
        check_train_config([("elastic_dir", "/e")])
