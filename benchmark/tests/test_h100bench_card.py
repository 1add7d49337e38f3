"""Each cell as the driver runs it, on the card: a short window, a fresh
large seed, ``correct`` true and the last line the result."""

import json
import os
import subprocess
import sys

import pytest

import tiny

with open(os.path.join(tiny.ROOT, "BENCHMARK.json")) as f:
    CELLS = [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(card, cell):
    out = subprocess.run(
        [sys.executable, os.path.join(tiny.BENCH_DIR, "run.py"),
         "--workload", cell, "--seed", str(2**32 + 99), "--seconds", "3",
         "--trace", "0"], capture_output=True, text=True, timeout=900,
        cwd=tiny.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
