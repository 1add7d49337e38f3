"""The PyTorch port stands alone: no module of ``ddw_tpu_torch`` (its
``native`` subpackage included), no ``tools/torch_*.py``, no
``examples_torch/*.py`` and not ``chip_smoke.py`` imports JAX, flax, optax
or the JAX package (not even ``ddw_tpu.native``, which imports no JAX);
every module and example
imports with those blocked; and entry points refuse to run quietly on the
CPU."""

import ast
import glob
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
    yield from sorted(glob.glob(os.path.join(REPO, "tools", "torch_*.py")))
    yield from _example_sources()
    yield os.path.join(REPO, "chip_smoke.py")


def _example_sources():
    return sorted(glob.glob(os.path.join(REPO, "examples_torch", "*.py")))


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
    assert len(sources) > 25
    bad = [(os.path.relpath(p, REPO), root) for p in sources
           for root in _imported_roots(p) if root in BANNED]
    assert bad == []
    tools = {os.path.basename(p) for p in sources if "tools" in p}
    assert {"torch_lm_profile.py", "torch_lm_train_profile.py",
            "torch_gang_drill.py"} <= tools
    examples = {os.path.basename(p) for p in _example_sources()}
    assert {"common.py", "01_data_prep.py", "02_train_single_node.py",
            "03_train_distributed.py", "04_hyperopt_parallel.py",
            "05_hyperopt_distributed.py",
            "06_packaged_inference.py",
            "08_pretrained_transfer.py", "09_lora_finetune.py",
            "07_lm_long_context.py", "10_fsdp_elastic.py",
            "11_lm_lifecycle.py", "13_supervised_gang.py",
            "14_online_serving.py", "15_http_gateway.py"} <= examples


def test_every_port_module_imports_with_jax_blocked():
    modules = [m.name for m in pkgutil.walk_packages(
        ddw_tpu_torch.__path__, "ddw_tpu_torch.")]
    for name in ("serving.batch", "train.trainer", "train.step",
                 "train.schedule", "train.callbacks", "data.prep",
                 "data.loader", "checkpoint.ckpt", "runtime.dist",
                 "tracking.tracker", "ops.flash_attention", "ops.rope",
                 "models.lm", "models.lora", "serve.bucketing",
                 "serving.lm_package", "train.lm_step",
                 "train.lm_trainer", "runtime.collectives", "runtime.mesh",
                 "ops.ring_reduce", "models.cnn", "train.transfer",
                 "tune.space", "tune.tpe", "tune.pruner",
                 "tracking.registry", "tracking.report",
                 "tracking.__main__", "native.build", "native.decode",
                 "native.codec", "models.resnet", "models.convnext",
                 "models.vit", "models.export", "ops.s2d_conv",
                 "models.layers", "models.spec_decode", "obs.telemetry",
                 "serve.admission", "serve.metrics", "serve.slots",
                 "serve.blocks", "serve.engine", "serve.adapters",
                 "serve.tenancy", "serve.lanes", "obs.trace", "obs.slo",
                 "utils.sysmon", "runtime.faults", "gateway.lifecycle",
                 "gateway.prefix_index", "gateway.replica",
                 "gateway.supervisor", "gateway.client", "gateway.http",
                 "deploy.journal", "deploy.canary", "deploy.controller",
                 "deploy.transport", "deploy._serve_worker",
                 "deploy.process_replica", "autoscale.policy",
                 "autoscale.controller", "parallel.ring_attention",
                 "parallel.pipeline", "parallel.zero", "parallel.sharding",
                 "parallel.comm", "models.moe", "checkpoint.sharded",
                 "dryrun", "runtime.elastic", "runtime.launcher",
                 "runtime._launch_worker", "runtime.supervisor",
                 "serve.tp"):
        assert f"ddw_tpu_torch.{name}" in modules
    modules += ["examples_torch." + os.path.basename(p)[:-3]
                for p in _example_sources()]
    code = (
        "import sys\n"
        f"for name in {BANNED!r}:\n"
        "    sys.modules[name] = None  # any import of it raises\n"
        "import importlib\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "importlib.import_module('chip_smoke')\n"
        "importlib.import_module('tools.torch_gang_drill')\n"
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
    from ddw_tpu_torch.models.layers import init_weights
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


def test_lm_entry_points_need_an_explicit_cpu_request(tmp_path,
                                                     monkeypatch):
    from ddw_tpu_torch.models.convert import init_lm_weights, \
        to_flax_variables
    from ddw_tpu_torch.models.lm import build_lm
    from ddw_tpu_torch.serving.batch import LMBatchScorer
    from ddw_tpu_torch.serving.lm_package import (LMPackagedModel,
                                                  save_lm_package)
    from ddw_tpu_torch.utils.config import LMCfg

    cfg = LMCfg(vocab_size=16, max_len=16, hidden=16, depth=1, num_heads=2,
                mlp_dim=32, dtype="float32")
    model = init_lm_weights(build_lm(cfg), torch.Generator().manual_seed(0))
    pkg = save_lm_package(str(tmp_path / "lm"), cfg,
                          to_flax_variables(model)["params"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LMPackagedModel(pkg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LMBatchScorer(pkg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LMPackagedModel(pkg, device="cuda")
    assert LMPackagedModel(pkg, device="cpu").device.type == "cpu"
    assert LMBatchScorer(pkg, device="cpu").model.device.type == "cpu"


def test_lm_trainer_needs_an_explicit_cpu_request(monkeypatch):
    from ddw_tpu_torch.train.lm_trainer import LMTrainer
    from ddw_tpu_torch.utils.config import LMCfg, TrainCfg

    cfg = LMCfg(vocab_size=16, max_len=16, hidden=16, depth=1, num_heads=2,
                mlp_dim=32, dtype="float32")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LMTrainer(cfg, TrainCfg())
    assert LMTrainer(cfg, TrainCfg(), device="cpu").device.type == "cpu"


def test_pallas_all_reduce_on_cpu_launches_nothing(monkeypatch):
    """A CPU tensor takes K6's plain version: the kernel's launch count does
    not move, in a world of one and in a faked world of two whose left
    neighbour echoes every row it is sent (so both rows end as their
    sum)."""
    from ddw_tpu_torch.ops import ring_reduce as rr
    from ddw_tpu_torch.runtime.collectives import all_reduce_sum

    before = rr.ring_all_reduce_cuda.launches
    x = torch.arange(300.0)
    assert all_reduce_sum(x, impl="pallas") is x
    monkeypatch.setattr(rr, "group_size_rank", lambda group=None: (2, 0))
    monkeypatch.setattr(rr, "ring_shift", lambda t, group=None: t.clone())
    out = all_reduce_sum({"x": x}, impl="pallas")["x"]
    rows = rr.ring_chunks(x, 2, lane=128)
    assert torch.equal(out, (rows[0] + rows[1]).repeat(2)[:300])
    assert rr.ring_all_reduce_cuda.launches == before


def test_unported_collectives_raise_naming_roadmap():
    """Every collective is ported now: host_all_reduce runs over the
    elastic gang's rendezvous and, outside one, is the identity in float64
    (as ddw_tpu's); the hybrid mesh is ported (a world of one is one
    slice)."""
    import numpy as np

    from ddw_tpu_torch.runtime import (HybridMeshSpec, host_all_reduce,
                                       make_hybrid_mesh)

    os.environ.pop("DDW_RENDEZVOUS_DIR", None)
    out = host_all_reduce("tag", np.float32(1.5))
    assert out == 1.5 and out.dtype == np.float64
    assert make_hybrid_mesh().shape == {"data": 1}
    assert HybridMeshSpec((("data", -1, -1),)).resolve(2, 4) == (
        ("data", 2, 4),)


def test_device_and_dtype_helpers():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
    assert torch_dtype("bfloat16") is torch.bfloat16
    assert torch_dtype("float32") is torch.float32
    with pytest.raises(ValueError, match="unknown dtype"):
        torch_dtype("float16")
