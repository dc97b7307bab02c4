"""The port's tag-scoped updater hyperparameters and schedules against
``cxxnet_tpu.optim``: the same config pairs give the same per-tag
hyperparameters, and the same (lr, momentum) at every update step from
0 to 50 for the four lr schedules and the momentum ramp (exact: both are
the same Python float arithmetic)."""

import dataclasses

import pytest

from cxxnet_tpu.config import parse_config_string as jax_parse
from cxxnet_tpu.optim import build_hypers as jax_build_hypers
from cxxnet_tpu.optim import tag_for_param as jax_tag_for_param
from cxxnet_tpu_torch.config import parse_config_string
from cxxnet_tpu_torch.optim import build_hypers, tag_for_param

SCHEDULES = {
    "constant": "eta = 0.1\nmomentum = 0.9\n",
    "expdecay": "eta = 0.1\nlr:schedule = expdecay\nlr:gamma = 0.7\n"
                "lr:step = 5\n",
    "polydecay": "eta = 0.2\nlr:schedule = polydecay\nlr:gamma = 0.3\n"
                 "lr:alpha = 0.75\nlr:step = 4\n",
    "factor": "eta = 0.1\nlr:schedule = factor\nlr:factor = 0.5\n"
              "lr:step = 10\nlr:minimum_lr = 0.004\n",
    "momentum_ramp": "eta = 0.1\nmomentum_schedule = 1\n"
                     "base_momentum = 0.5\nfinal_momentum = 0.95\n"
                     "saturation_epoch = 20\n",
    "start_epoch": "eta = 0.1\nlr:schedule = expdecay\nlr:gamma = 0.5\n"
                   "lr:start_epoch = 8\n",
    "tag_scoped": "eta = 0.1\nwd = 0.0005\nbias:eta = 0.2\nbias:wd = 0\n"
                  "wmat:lr:schedule = factor\nwmat:lr:step = 3\n"
                  "wmat:momentum = 0.8\nclip_gradient = 5\n",
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_hypers_and_schedules_match_the_jax_optimizer(name):
    text = SCHEDULES[name]
    ours = build_hypers(parse_config_string(text))
    ref = jax_build_hypers(jax_parse(text))
    assert sorted(ours) == sorted(ref) == ["bias", "wmat"]
    for tag in ours:
        o, r = dataclasses.asdict(ours[tag]), dataclasses.asdict(ref[tag])
        assert {k: o[k] for k in o} == {k: r[k] for k in o}
        for epoch in range(51):
            assert ours[tag].schedule(epoch) == ref[tag].schedule(epoch), \
                (tag, epoch)


@pytest.mark.parametrize("key", ["wmat", "bias", "gamma", "beta",
                                 "running_exp", "wmat_scale"])
def test_tag_for_param_matches(key):
    assert tag_for_param(key) == jax_tag_for_param(key)
