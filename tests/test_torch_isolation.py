"""The PyTorch port stands alone: no module of ``ddw_tpu_torch``, and not
``chip_smoke.py``, imports JAX, flax, optax or the JAX package; every module
imports with those blocked; and entry points refuse to run quietly on the
CPU."""

import ast
import os
import pkgutil
import shutil
import subprocess
import sys

import pytest
import torch

import ddw_tpu_torch
from ddw_tpu_torch.utils.device import resolve_device, torch_dtype

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = ("jax", "jaxlib", "flax", "optax", "ddw_tpu")


def _port_sources():
    root = os.path.join(REPO, "ddw_tpu_torch")
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(REPO, "chip_smoke.py")


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_port_module_imports_jax_or_the_jax_package():
    sources = list(_port_sources())
    assert len(sources) > 15
    bad = [(os.path.relpath(p, REPO), root) for p in sources
           for root in _imported_roots(p) if root in BANNED]
    assert bad == []


def test_every_port_module_imports_with_jax_blocked():
    modules = [m.name for m in pkgutil.walk_packages(
        ddw_tpu_torch.__path__, "ddw_tpu_torch.")]
    assert "ddw_tpu_torch.serving.batch" in modules
    code = (
        "import sys\n"
        f"for name in {BANNED!r}:\n"
        "    sys.modules[name] = None  # any import of it raises\n"
        "import importlib\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "importlib.import_module('chip_smoke')\n"
        "print('imported', len(sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "imported" in proc.stdout


def _run_smoke(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_refuses_without_cuda():
    proc = _run_smoke(REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "cuda" in proc.stderr.lower()


def test_chip_smoke_refuses_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_entry_points_need_an_explicit_cpu_request(tmp_path, monkeypatch):
    from ddw_tpu_torch.models.convert import to_flax_variables
    from ddw_tpu_torch.models.mobilenet_v2 import init_weights
    from ddw_tpu_torch.models.registry import build_model
    from ddw_tpu_torch.serving.batch import BatchScorer
    from ddw_tpu_torch.serving.package import (PackagedModel,
                                               save_packaged_model)
    from ddw_tpu_torch.utils.config import ModelCfg

    cfg = ModelCfg(width_mult=0.35, dtype="float32")
    model = build_model(cfg)
    init_weights(model, torch.Generator().manual_seed(0))
    v = to_flax_variables(model)
    pkg = save_packaged_model(str(tmp_path / "pkg"), cfg, list("abcde"),
                              v["params"], v["batch_stats"], 32, 32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PackagedModel(pkg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchScorer(pkg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PackagedModel(pkg, device="cuda")
    assert PackagedModel(pkg, device="cpu").device.type == "cpu"


def test_device_and_dtype_helpers():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
    assert torch_dtype("bfloat16") is torch.bfloat16
    assert torch_dtype("float32") is torch.float32
    with pytest.raises(ValueError, match="unknown dtype"):
        torch_dtype("float16")
