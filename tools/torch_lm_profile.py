#!/usr/bin/env python3
"""Where the time of one LM scoring batch goes, on the card, for the port's
LM serving path (ddw_tpu_torch).

    python3 tools/torch_lm_profile.py [--impl auto|xla]

Builds bench.py's ``lm_flash`` LM (vocab 8192, 2048 positions, hidden 512, 6
layers of 8 heads of 64, MLP 2048, bf16) from seeded random weights,
packages and loads it, warms it up, then scores one batch of 64 rows of
2,049 tokens (``LMPackagedModel.nll``, the call ``LMBatchScorer`` makes per
batch) under ``torch.profiler`` (CPU + CUDA activities). ``--impl xla``
raises the attention dispatch thresholds so attention runs on the ``xla``
tier instead of K3. Prints one JSON line: the wall time, the device time by
category (K3, GEMMs, the score-matrix softmax of the xla tier, other
elementwise and reductions, copies), the device's idle share of the wall
time, and the top kernels by device time. Needs a CUDA card; exits 2
without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CFG = dict(vocab_size=8192, max_len=2048, hidden=512, depth=6, num_heads=8,
           mlp_dim=2048, dtype="bfloat16")
BATCH = 64


def _category(name: str) -> str:
    n = name.lower()
    if "flash_fwd" in n:
        return "k3_flash_attention"
    if "memcpy" in n or "memset" in n:
        return "copies"
    if any(k in n for k in ("gemm", "nvjet", "sm90", "cutlass", "xmma",
                            "cublas")):
        return "gemm"
    if any(k in n for k in ("softmax", "logsoftmax")):
        return "softmax"
    if "reduce" in n:
        return "reductions"
    if any(k in n for k in ("elementwise", "vectorized", "copy_kernel",
                            "fill", "index", "gather", "embedding")):
        return "elementwise"
    return "other"


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--impl", default="auto", choices=("auto", "xla"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_lm_profile: needs a CUDA card", file=sys.stderr)
        return 2

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ddw_tpu_torch.models.convert import (init_lm_weights,
                                              to_flax_variables)
    from ddw_tpu_torch.models.lm import build_lm
    from ddw_tpu_torch.ops import flash_attention as fa
    from ddw_tpu_torch.serving.lm_package import (LMPackagedModel,
                                                  save_lm_package)
    from ddw_tpu_torch.utils.config import LMCfg

    if args.impl == "xla":
        fa._XLA_PLAIN_MAX = fa._XLA_CKPT_MAX = 1 << 62
    cfg = LMCfg(**CFG)
    params = to_flax_variables(init_lm_weights(
        build_lm(cfg), torch.Generator().manual_seed(0)))["params"]
    with tempfile.TemporaryDirectory(prefix="ddw_lm_profile_") as tmp:
        pm = LMPackagedModel(save_lm_package(os.path.join(tmp, "pkg"), cfg,
                                             params))
    toks = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (BATCH, cfg.max_len + 1)).astype(np.int32)
    pm.nll(toks)
    pm.nll(toks)
    torch.cuda.synchronize()
    launches = fa.flash_attention_cuda.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pm.nll(toks)                        # fetches the NLLs: work done
        wall_ms = (time.perf_counter() - t0) * 1e3
    launches = fa.flash_attention_cuda.launches - launches

    by_cat: dict[str, float] = {}
    kernels = []
    for evt in prof.key_averages():
        # device-side entries only (kernels, copies): a CPU op's own entry
        # repeats the device time of the kernels it launched
        if evt.device_type != DeviceType.CUDA or \
                evt.key.startswith("Activity Buffer"):
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = evt.self_cuda_time_total
        if dev_us <= 0:
            continue
        cat = _category(evt.key)
        by_cat[cat] = by_cat.get(cat, 0.0) + dev_us / 1e3
        kernels.append((dev_us / 1e3, evt.count, cat, evt.key[:90]))
    device_ms = sum(by_cat.values())
    if device_ms <= 0:
        print("torch_lm_profile: the profiler recorded no device time",
              file=sys.stderr)
        return 3
    kernels.sort(reverse=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    tokens = BATCH * cfg.max_len
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "impl": args.impl, "batch": BATCH, "seq": cfg.max_len,
        "k3_launches": launches, "wall_ms": wall_ms,
        "tokens_per_s": tokens / wall_ms * 1e3, "device_ms": device_ms,
        # one stream: kernels and copies do not overlap
        "device_idle_share": max(0.0, 1.0 - device_ms / wall_ms),
        "device_ms_by_category": by_cat,
        "top_kernels": [{"ms": ms, "calls": n, "category": c, "name": k}
                        for ms, n, c, k in kernels[:12]],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
