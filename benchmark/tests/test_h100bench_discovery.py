"""A new configuration, model family, traffic mix, per-layer metric and cell
are files and manifest entries only: the harness finds them by name."""

import json
import os
import time

from benchmark.lib.harness import run_cell
from benchmark.lib.manifest import Bench
import tiny

NEW_METRIC = '''"""A throwaway reader: the window's steps."""


def read(run):
    return float(run.attempted) if run.attempted else None
'''

NEW_FAMILY = '''"""A throwaway family: the decoder LM's, under another name."""

from benchmark.families.transformer_lm import *  # noqa: F401,F403
'''


def test_real_manifest_keeps_the_rules():
    bench = Bench(tiny.ROOT)
    assert bench.problems() == []
    m = bench.manifest
    assert {e["name"] for e in m["end_to_end"]} == {
        "train_images_per_s", "train_tokens_per_s", "setup_s"}
    assert all(w["chips"] == 1 for w in m["workloads"])
    for w in m["workloads"]:
        cell = w["name"]
        e2e = bench.metrics_of(cell, "end_to_end")
        assert "setup_s" in {e["name"] for e in e2e} and len(e2e) >= 2
        moved = {e["name"] for e in e2e}
        per_layer = bench.metrics_of(cell, "per_layer")
        assert per_layer and all(p["moves"] in moved for p in per_layer)
        assert os.path.exists(os.path.join(bench.data, "limits",
                                           f"{cell}.json"))


def test_new_cell_mix_config_and_metric_as_files(tmp_path):
    root = tiny.make_root(str(tmp_path))
    data = os.path.join(root, "benchmark")
    with open(os.path.join(data, "families", "lm_copy.py"), "w") as f:
        f.write(NEW_FAMILY)
    cfg = dict(tiny.TINY_LM, num_hidden_layers=1, family="lm_copy")
    with open(os.path.join(data, "configs", "tiny_lm_1.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(data, "traffic", "tiny_lm_new.json"), "w") as f:
        json.dump(dict(tiny.TINY_MIXES["tiny_lm"], batch=1, seq=32), f)
    with open(os.path.join(data, "metrics", "steps.tiny_new.py"), "w") as f:
        f.write(NEW_METRIC)
    with open(os.path.join(data, "limits", "tiny_new.json"), "w") as f:
        json.dump({"checks": {"loss_gap": {"limit": 0.05}}}, f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        m = json.load(f)
    m["configs"].append({"name": "tiny_lm_1", "source": "test",
                         "file": "benchmark/configs/tiny_lm_1.json",
                         "reduced": [], "why": "test"})
    m["workloads"].append({"name": "tiny_new", "config": "tiny_lm_1",
                           "traffic": "tiny_lm_new", "chips": 1,
                           "why": "test"})
    m["end_to_end"][1]["workloads"].append("tiny_new")    # tokens/s
    m["per_layer"].append({"name": "steps.tiny_new", "unit": "steps",
                           "better": "higher", "source": "host_clock",
                           "layer": "test", "moves": "train_tokens_per_s",
                           "workloads": ["tiny_new"]})
    with open(path, "w") as f:
        json.dump(m, f)
    assert Bench(root).problems() == []
    r = run_cell(root, "tiny_new", 3, 0.2, False, "cpu", time.perf_counter())
    assert set(r["metrics"]) == {"train_tokens_per_s", "setup_s"}
    assert r["correct"] and list(r["checks"]) == ["loss_gap"]
    r = run_cell(root, "tiny_new", 3, 0.2, True, "cpu", time.perf_counter())
    assert r["metrics"]["steps.tiny_new"]["value"] == r["attempted"]
    assert "loader_wait_ms.train_tokens" not in r["metrics"]
