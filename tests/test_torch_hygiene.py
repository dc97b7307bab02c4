"""The PyTorch port stands alone and never runs quietly on the CPU.

* No module of ``cxxnet_tpu_torch`` and not ``chip_smoke.py`` imports
  ``jax`` or the JAX package ``cxxnet_tpu`` (compared by exact
  top-level name: ``cxxnet_tpu_torch`` starts with ``cxxnet_tpu``).
* With no CUDA device, every entry point that names the accelerator
  raises instead of falling back to the CPU, and ``chip_smoke.py``
  exits non-zero without printing a result.
"""

import ast
import glob
import os
import shutil
import subprocess
import sys

import pytest
import torch

from cxxnet_tpu_torch import main as port_main
from cxxnet_tpu_torch.config import parse_config_string
from cxxnet_tpu_torch.device import resolve_device
from cxxnet_tpu_torch.graph import build_graph
from cxxnet_tpu_torch.model import Network

from torch_ibn_fixture import IBN_TEXT, REPO

FORBIDDEN = {"jax", "jaxlib", "cxxnet_tpu"}
PORT_FILES = sorted(glob.glob(os.path.join(REPO, "cxxnet_tpu_torch", "**",
                                           "*.py"), recursive=True)) \
    + [os.path.join(REPO, "chip_smoke.py")]


def _top_level_imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_files_exist():
    names = {os.path.relpath(p, REPO) for p in PORT_FILES}
    assert "chip_smoke.py" in names
    assert {"cxxnet_tpu_torch/ops/fused_pool.py",
            "cxxnet_tpu_torch/ops/fused_norm.py",
            "cxxnet_tpu_torch/ops/fused_optim.py",
            "cxxnet_tpu_torch/io/__init__.py",
            "cxxnet_tpu_torch/io/data.py", "cxxnet_tpu_torch/io/proc.py",
            "cxxnet_tpu_torch/trainer.py", "cxxnet_tpu_torch/optim.py",
            "cxxnet_tpu_torch/metrics.py",
            "cxxnet_tpu_torch/ops/attention.py",
            "cxxnet_tpu_torch/layers/seq.py",
            "cxxnet_tpu_torch/ops/fused_lrn.py",
            "cxxnet_tpu_torch/io/iter_mnist.py",
            "cxxnet_tpu_torch/ops/fused_quant.py",
            "cxxnet_tpu_torch/quant/ptq.py",
            "cxxnet_tpu_torch/quant/__main__.py",
            "cxxnet_tpu_torch/parallel/__init__.py",
            "cxxnet_tpu_torch/parallel/dist.py",
            "cxxnet_tpu_torch/io/recordio.py",
            "cxxnet_tpu_torch/io/decode.py",
            "cxxnet_tpu_torch/io/augment.py",
            "cxxnet_tpu_torch/io/iter_imgrec.py",
            "cxxnet_tpu_torch/ops/fused_stem.py"} <= names
    csrc = {os.path.basename(p) for p in glob.glob(
        os.path.join(REPO, "cxxnet_tpu_torch", "csrc", "*.cu"))}
    assert {"lrn_fwd.cu", "lrn_bwd.cu", "pool_bwd_max.cu", "q_mm.cu",
            "bn_sync.cu", "stem.cu"} <= csrc
    assert len(names) > 30


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[os.path.relpath(p, REPO) for p in PORT_FILES])
def test_no_jax_or_reference_import(path):
    bad = sorted(set(_top_level_imports(path)) & FORBIDDEN)
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_import_check_compares_exact_names(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import cxxnet_tpu_torch.ops\nfrom cxxnet_tpu.graph import x\n"
                 "from . import y\nimport jax.numpy as jnp\n")
    assert set(_top_level_imports(str(p))) & FORBIDDEN == \
        {"cxxnet_tpu", "jax"}


@pytest.fixture()
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("dev", ["tpu", "gpu", "cuda:0", "", "tpu:0"])
def test_accelerator_device_without_cuda_raises(no_cuda, dev):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(dev)


def test_cpu_is_only_reached_by_name(no_cuda):
    assert resolve_device("cpu") == torch.device("cpu")
    cfg = parse_config_string(IBN_TEXT)          # says dev = tpu
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Network(build_graph(cfg), cfg)


def test_serve_entry_point_without_cuda_raises(no_cuda, tmp_path):
    conf = tmp_path / "ibn.conf"
    conf.write_text(IBN_TEXT)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main.main([str(conf), "task=serve", "serve_port=0"])


def test_train_entry_point_without_cuda_raises(no_cuda, tmp_path):
    conf = tmp_path / "ibn.conf"
    conf.write_text(IBN_TEXT)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main.main([str(conf), "task=train"])


@pytest.mark.parametrize("conf", ["alexnet.conf", "kaiming.conf"])
def test_convnet_train_entry_points_without_cuda_raise(no_cuda, conf):
    path = os.path.join(REPO, "examples", "ImageNet", conf)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main.main([path, "task=train"])


def test_quantize_entry_point_without_cuda_raises(no_cuda, tmp_path):
    from cxxnet_tpu_torch.quant.__main__ import main as quant_main
    conf = tmp_path / "ibn.conf"
    conf.write_text(IBN_TEXT)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quant_main([str(conf), "in.model", "out.model"])


def test_lm_train_entry_point_without_cuda_raises(no_cuda):
    conf = os.path.join(REPO, "examples", "LM", "long_context_lm.conf")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main.main([conf, "task=train"])


def test_other_tasks_and_fleet_keys_name_the_roadmap(tmp_path):
    conf = tmp_path / "ibn.conf"
    conf.write_text(IBN_TEXT)
    for args in (["task=pred"], ["task=serve", "serve_replicas=2"],
                 ["task=serve", "cascade_enable=1"],
                 ["task=serve", "deploy_enable=1"]):
        with pytest.raises(ValueError, match="ROADMAP"):
            port_main.main([str(conf), "dev=cpu", *args])


def _run_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_chip_smoke_fails_without_a_card():
    r = _run_smoke(REPO)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run_smoke(str(tmp_path))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
