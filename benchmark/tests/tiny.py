"""A throwaway benchmark root at CPU size, for the tests: the real manifest's
metrics, and tiny configurations, mixes and limits of its cells written as
new files, so that the harness runs every kind of cell here without one
edit to its code."""

from __future__ import annotations

import copy
import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH_DIR)

TINY_MNV2 = {
    "family": "mobilenet_v2", "width_multiplier": 0.25, "image_size": 32,
    "channels": 3, "first_channels": 32, "last_channels": 1280,
    "inverted_residual_setting": [[1, 16, 1, 1], [6, 24, 2, 2], [6, 32, 3, 2],
                                  [6, 64, 4, 2], [6, 96, 3, 1],
                                  [6, 160, 3, 2], [6, 320, 1, 1]],
    "num_classes": 5, "dropout": 0.5, "batchnorm_epsilon": 0.001,
    "batchnorm_momentum": 0.9, "dtype": "bfloat16", "reduced": [],
    "port": {"dw_impl": "pallas", "stem_s2d": False}}

TINY_LM = {
    "family": "transformer_lm", "hidden_size": 64, "intermediate_size": 128,
    "num_attention_heads": 4, "num_key_value_heads": 2,
    "num_hidden_layers": 2, "vocab_size": 256, "norm_epsilon": 1e-06,
    "rope_theta": 10000.0, "max_position_embeddings": 256,
    "dtype": "bfloat16", "reduced": [],
    "port": {"pos_encoding": "rope", "remat": "none"}}

TINY_MIXES = {
    "tiny_finetune": {"kind": "image_train", "batch": 8, "images": 32,
                      "freeze_base": False, "learning_rate": 0.001,
                      "loader_workers": 1, "prefetch": 2, "checked_steps": 3,
                      "trace_after_steps": 1, "trace_steps": 1},
    "tiny_transfer": {"kind": "image_train", "batch": 8, "images": 32,
                      "freeze_base": True, "learning_rate": 0.001,
                      "loader_workers": 1, "prefetch": 2, "checked_steps": 3,
                      "trace_after_steps": 1, "trace_steps": 1},
    "tiny_lm": {"kind": "lm_train", "batch": 2, "seq": 64, "table_rows": 16,
                "learning_rate": 0.0003, "loader_workers": 1, "prefetch": 2,
                "checked_steps": 3, "trace_after_steps": 1, "trace_steps": 1},
    "tiny_chat": {"kind": "lm_serve", "clients": 4,
                  "requests": 256, "size_block": 8, "sizes_seed": 7,
                  "prompt_tokens": {"median": 24, "sigma": 0.5, "min": 8,
                                    "max": 64},
                  "output_tokens": {"median": 8, "sigma": 0.5, "min": 4,
                                    "max": 16},
                  "n_slots": 2,
                  "steps_per_tick": 4, "ramp_s": 0.2, "drain_s": 60.0,
                  "trace_after_s": 0.1, "trace_s": 0.2,
                  "checked_requests": 3},
}

TRAIN_LIMITS = {"loss_gap": {"limit": 0.05}, "grad_gap": {"limit": 0.02},
                "change_gap": {"limit": 0.3}, "rows_unmatched": {"limit": 0}}
# the tiny cells' limits; the fine-tuning cell compares the median leaf's
# gradient and the depthwise leaves' worst, as limits/mnv2_finetune_b256.json
LIMITS = {"mnv2_finetune_b256": {"grad_gap_median": {"limit": 0.01},
                                 "grad_gap_dw": {"limit": 0.05},
                                 "change_gap": {"limit": 0.3},
                                 "rows_unmatched": {"limit": 0}},
          "mnv2_transfer_b256": TRAIN_LIMITS,
          "sc2_train_s4096": TRAIN_LIMITS,
          "sc2_serve_chat": {"logit_gap": {"limit": 0.05},
                             "unanswered": {"limit": 0}}}

# the cells of the real manifest, and two that it leaves out (a transfer
# cell and a serving cell: their drivers and readers stay in the
# benchmark's directory), each on its tiny configuration and mix
TINY_CELLS = {
    "mnv2_finetune_b256": ("tiny_mnv2", "tiny_finetune"),
    "mnv2_transfer_b256": ("tiny_mnv2", "tiny_transfer"),
    "sc2_train_s4096": ("tiny_lm", "tiny_lm"),
    "sc2_serve_chat": ("tiny_lm", "tiny_chat"),
}


# manifest entries of the cells the real manifest leaves out
EXTRA_METRICS = {
    "end_to_end": [{"name": "serve_tokens_per_s", "unit": "tokens/s",
                    "better": "higher", "bound": 0.25, "source": "host_clock",
                    "workloads": ["sc2_serve_chat"]}],
    "per_layer": [{"name": name, "unit": unit, "better": better,
                   "source": source, "layer": layer,
                   "moves": "serve_tokens_per_s",
                   "workloads": ["sc2_serve_chat"]}
                  for name, unit, better, source, layer in (
                      ("tick_ms.serve", "ms", "lower", "program_counter",
                       "engine"),
                      ("queue_ms_p95.serve", "ms", "lower",
                       "program_counter", "engine"),
                      ("ttft_p95_ms.serve", "ms", "lower", "host_clock",
                       "engine"),
                      ("mfu.serve", "%", "higher", "host_clock", "engine"),
                      ("device_idle.serve", "%", "lower", "device_trace",
                       "the card"))],
}


def _write(path: str, obj) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def make_root(dst: str, limits: dict | None = None,
              configs: dict | None = None) -> str:
    """A copy of the benchmark's data under ``dst`` whose cells run the
    tiny configurations and mixes under ``limits`` (cell -> checks; by
    default ``LIMITS``); ``configs`` (name -> keys) changes keys of the tiny
    configurations, where given."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    data = os.path.join(dst, "benchmark")
    for sub in ("metrics", "kernels", "limits", "families"):
        shutil.copytree(os.path.join(BENCH_DIR, sub), os.path.join(data, sub))
    manifest = copy.deepcopy(manifest)
    manifest["configs"] = [
        {"name": "tiny_mnv2", "source": "test", "reduced": [], "why": "test",
         "file": "benchmark/configs/tiny_mnv2.json"},
        {"name": "tiny_lm", "source": "test", "reduced": [], "why": "test",
         "file": "benchmark/configs/tiny_lm.json"}]
    configs = configs or {}
    _write(os.path.join(data, "configs", "tiny_mnv2.json"),
           dict(TINY_MNV2, **configs.get("tiny_mnv2", {})))
    _write(os.path.join(data, "configs", "tiny_lm.json"),
           dict(TINY_LM, **configs.get("tiny_lm", {})))
    for name, mix in TINY_MIXES.items():
        _write(os.path.join(data, "traffic", f"{name}.json"), mix)
    manifest["workloads"] = [
        {"name": cell, "config": cfg, "traffic": mix, "chips": 1,
         "why": "test"} for cell, (cfg, mix) in TINY_CELLS.items()]
    for group, entries in EXTRA_METRICS.items():
        manifest[group] += copy.deepcopy(entries)
    for e in manifest["end_to_end"] + manifest["per_layer"]:
        if "mnv2_finetune_b256" in e.get("workloads", []):
            e["workloads"].append("mnv2_transfer_b256")
    for cell, checks in (limits or LIMITS).items():
        _write(os.path.join(data, "limits", f"{cell}.json"),
               {"checks": checks})
    _write(os.path.join(dst, "BENCHMARK.json"), manifest)
    return dst
