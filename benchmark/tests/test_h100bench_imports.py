"""Nothing a run loads is JAX or the JAX package, compared by whole
top-level names; the references load nothing of the program."""

import ast
import json
import os
import subprocess
import sys

import pytest

from benchmark.lib.manifest import forbidden_loaded
import tiny

REF_DIR = os.path.join(tiny.BENCH_DIR, "reference")


@pytest.mark.parametrize("name,bad", [
    ("ddw_tpu", True), ("ddw_tpu.ops.rope", True), ("jax", True),
    ("jax.numpy", True), ("jaxlib.xla_client", True), ("flax.linen", True),
    ("optax", True), ("ddw_tpu_torch", False), ("ddw_tpu_torch.ops", False),
    ("jaxtyping", False), ("flaxen", False), ("torch", False)])
def test_top_level_names_compared_whole(name, bad):
    assert forbidden_loaded([name]) == ([name] if bad else [])


_RUN = """
import json, sys, tempfile, time
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
import tiny
from benchmark.lib.harness import run_cell
from benchmark.lib.manifest import forbidden_loaded
root = tiny.make_root(tempfile.mkdtemp())
for cell in ("mnv2_finetune_b256", "sc2_serve_chat"):
    run_cell(root, cell, 1, 0.2, False, "cpu", time.perf_counter())
print(json.dumps(forbidden_loaded(sys.modules)))
"""


def test_a_run_loads_no_jax(tmp_path):
    code = _RUN.format(root=tiny.ROOT, tests=os.path.dirname(__file__))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module


@pytest.mark.parametrize("fname", sorted(
    f for f in os.listdir(REF_DIR) if f.endswith(".py")))
def test_reference_imports_only_torch(fname):
    for mod in _imports(os.path.join(REF_DIR, fname)):
        assert mod.split(".")[0] in ("torch", "math", "__future__") \
            or mod.startswith("benchmark.reference"), mod


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import benchmark.reference.decoder, "
            "benchmark.reference.mobilenet_v2; "
            "print([m for m in sys.modules "
            "if m.split('.')[0] in ('ddw_tpu_torch', 'ddw_tpu', 'jax')])"
            % tiny.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"
