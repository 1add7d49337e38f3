"""The control: the plain reference put in the program's place, computed
one precision below the configuration's bfloat16 (fp8, ``reference/
precision.py``), comes out not correct under the cell's limits. CPU size,
with the tiny limits of ``tiny.LIMITS``; on the card at the
cells' own sizes ``calibrate.py --control 1`` reads the same numbers."""

import json
import os
import time

import pytest

from benchmark.lib.harness import judge, run_cell
import tiny

CONTROL_CELLS = ("mnv2_finetune_b256", "sc2_train_s4096", "sc2_serve_chat")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tiny.make_root(str(tmp_path_factory.mktemp("root")), tiny.LIMITS)
    # served answers of some hundreds of tokens, as the cell's check reads:
    # at this size fp8 moves an answer's first token only now and then
    mix = dict(tiny.TINY_MIXES["tiny_chat"], checked_requests=8,
               output_tokens={"median": 48, "sigma": 0.3, "min": 32,
                              "max": 64})
    with open(os.path.join(root, "benchmark", "traffic", "tiny_chat.json"),
              "w") as f:
        json.dump(mix, f)
    return root


@pytest.mark.parametrize("cell", CONTROL_CELLS)
def test_control_comes_out_not_correct(root, cell):
    r = run_cell(root, cell, 2**31 + 5, 1.0, False, "cpu",
                 time.perf_counter(), extra=("control",))
    numbers = {k: v["value"] for k, v in r["checks"].items()}
    numbers.update(r["details"]["_control"])
    ok, checks = judge(numbers, tiny.LIMITS[cell])
    assert not ok, checks
